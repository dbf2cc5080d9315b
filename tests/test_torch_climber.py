"""Model-level parity of the port's Climber with the JAX package.

Both packages get the same weights: the JAX ``climber_init`` values pass
through ``params_from_jax``.  The algorithm is held in f32 (both packages
fed f32-cast weights) at 1e-4 on logits and K/V; the bf16 weights the
engines serve with are checked separately at a looser, stated bound.  JAX
calls are jit-wrapped (docs/ARCHITECTURE.md §7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import climber as JC
from repro.models import build_model
from repro.serving.kv_cache import quantize_kv_graph as j_quantize_kv_graph
from repro.types import ClimberConfig as JClimberConfig
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.serving.kv_cache import quantize_kv_graph
from repro_torch.types import ClimberConfig

torch.set_num_threads(1)
TOL = 1e-4
# bf16 weights: both sides round every projection / FFN output to bf16, at
# different places, over 2 blocks x 2 layers (measured up to ~8e-3 on
# logits of magnitude ~0.5-0.8)
BF16_TOL = 2e-2

SMALL = dict(vocab_size=5_000, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)


def _cfgs(layers=2):
    jc = dataclasses.replace(
        j_get_config("climber"), **SMALL,
        climber=JClimberConfig(num_blocks=2, layers_per_block=layers))
    tc = dataclasses.replace(
        get_config("climber"), **SMALL,
        climber=ClimberConfig(num_blocks=2, layers_per_block=layers))
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    jparams, _ = build_model(jc).init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = C.params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    return jc, tc, jparams, j32, t32


def _batch(n_hist=64, m=12, b=1, seed=0):
    r = np.random.default_rng(seed)
    return {"history": r.integers(0, 5000, (b, n_hist)).astype(np.int32),
            "candidates": r.integers(0, 5000, (b, m)).astype(np.int32),
            "side": r.normal(size=(b, 12)).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_params_from_jax_round_trip(setup):
    """Same names, layouts, dtypes and values (bf16 bitwise) as the JAX
    pytree, and the port's own initializer builds the same structure."""
    jc, tc, jparams, _, _ = setup
    tp = C.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jpaths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = tree.leaves(tp)
    assert len(jpaths) == len(tleaves)
    for (path, j), t in zip(jpaths, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32), str(path))
    own = C.climber_init(tc, torch.Generator().manual_seed(0), "cpu")
    assert tree.structure(own) == tree.structure(tp)
    assert [(tuple(a.shape), a.dtype) for a in tree.leaves(own)] == \
        [(tuple(a.shape), a.dtype) for a in tleaves]


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_climber_forward_f32(setup, impl):
    jc, tc, _, j32, t32 = setup
    batch = _batch()
    exp = jax.jit(lambda p, b: JC.climber_forward(p, b, jc, impl=impl))(
        j32, batch)
    got = C.climber_forward(t32, _tb(batch), tc, impl=impl)
    _close(got, exp)


@pytest.mark.parametrize("n_hist", [64, 512])
def test_encode_history_f32(setup, n_hist):
    """K/V per block and layer; at 512 the JAX fused impl runs its chunked
    jnp pass (257 positions per block) and the port its K2 plain version."""
    jc, tc, _, j32, t32 = setup
    batch = _batch(n_hist=n_hist)
    del batch["candidates"]
    exp = jax.jit(lambda p, b: JC.encode_history(p, b, jc, impl="fused"))(
        j32, batch)
    got = C.encode_history(t32, _tb(batch), tc, impl="fused")
    assert tree.structure(got) == tree.structure(
        jax.tree.map(lambda a: 0, exp))
    for blk in exp:
        for kk in ("k", "v"):
            _close(got[blk][kk], exp[blk][kk])
    specs = C.history_kv_specs(t32, tc, n_hist)
    assert [s.shape for s in tree.leaves(specs)] == \
        [tuple(a.shape) for a in tree.leaves(got)]


@pytest.mark.parametrize("pool", ["native", "int8", "bf16"])
def test_score_candidates_raw_views_f32(setup, pool):
    """score_candidates under the fused impl on the SAME stored operands
    (JAX's quantize_kv_graph output, handed to both) with a 1-D dedup
    row_index: the quantization error cancels, so the f32 tolerance
    holds."""
    jc, tc, _, j32, t32 = setup
    batch = _batch(b=2, seed=1)
    jkv = jax.jit(lambda p, b: JC.encode_history(p, b, jc, impl="fused"))(
        j32, batch)
    jraw = j_quantize_kv_graph(jkv, pool)
    cands = np.concatenate([batch["candidates"], batch["candidates"][::-1]])
    idx = np.array([1, 0, 1, 1], np.int32)
    exp = jax.jit(lambda p, kv, c, i: JC.score_candidates(
        p, kv, c, jc, impl="fused", row_index=i))(j32, jraw, cands, idx)

    def to_t(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))
    traw = tree.tree_map(to_t, jraw)
    got = C.score_candidates(t32, traw, torch.from_numpy(cands), tc,
                             impl="fused", row_index=torch.from_numpy(idx))
    _close(got, exp)


def test_split_surface_matches_prefill(setup):
    """prefill == sigmoid(score_candidates(encode_history)) in the port,
    for both impls, and the in-epilogue int8 quantization of the port's own
    encode tracks the JAX fused engine path within QTOL."""
    jc, tc, _, j32, t32 = setup
    batch = _tb(_batch(seed=2))
    bundle = C.build_climber(tc)
    full = bundle.prefill(t32, batch)
    for impl in ("reference", "fused"):
        kv = bundle.encode_history(t32, {"history": batch["history"],
                                         "side": batch["side"]}, impl=impl)
        got = bundle.score_candidates(t32, kv, batch["candidates"],
                                      impl=impl)
        torch.testing.assert_close(got, full, atol=1e-5, rtol=1e-5)
    raw = quantize_kv_graph(kv, "int8")
    got = bundle.score_candidates(t32, raw, batch["candidates"],
                                  impl="fused",
                                  row_index=torch.zeros(1, dtype=torch.int32))
    jb = {k: v.numpy() for k, v in batch.items()}
    jraw = j_quantize_kv_graph(jax.jit(
        lambda p, b: JC.encode_history(p, b, jc, impl="fused"))(j32, jb),
        "int8")
    exp = jax.nn.sigmoid(jax.jit(lambda p, kv, c: JC.score_candidates(
        p, kv, c, jc, impl="fused"))(j32, jraw, jb["candidates"]))
    _close(got, exp, 2e-2)


SUMI_ROUTES = [("cached", "reference"), ("cached", "fused"),
               ("extend", "reference"), ("extend", "fused"),
               ("extend_empty_prefix", "fused"), ("decode", "fused")]


@pytest.mark.parametrize("route,impl", SUMI_ROUTES,
                         ids=[f"{r}-{i}" for r, i in SUMI_ROUTES])
def test_sumi_routes_vs_jax(route, impl):
    """``core/sumi.py`` attention routes on int8 pool operands with a
    temperature and a 1-D dedup row_index, against the jit-wrapped JAX
    routes on the same numpy inputs (f32 compute)."""
    from repro.core import sumi as JS
    from repro.serving.kv_cache import quantize_leaf as j_quantize_leaf
    from repro_torch.core import sumi
    r = np.random.default_rng(7)
    b, m, h, hkv, d, u = 3, 10, 4, 2, 16, 2
    s = 0 if route == "extend_empty_prefix" else 21
    q, kc, vc = (r.normal(size=(b, m, n, d)).astype(np.float32)
                 for n in (h, hkv, hkv))
    if s:
        kq, vq = (j_quantize_leaf(jnp.asarray(
            r.normal(size=(u, 1, s, hkv, d)), jnp.float32), "int8")
            for _ in range(2))
        ops = dict(k_hist=kq.q[:, 0], v_hist=vq.q[:, 0],
                   k_scale=kq.scale[:, 0], v_scale=vq.scale[:, 0])
    else:           # no prefix to quantize: plain causal over the suffix
        ops = dict(k_hist=np.zeros((u, 0, hkv, d), np.float32),
                   v_hist=np.zeros((u, 0, hkv, d), np.float32),
                   k_scale=None, v_scale=None)
    idx = np.array([1, 0, 1], np.int32)
    lengths = np.array([0, 13], np.int32)
    tau = np.float32(1.3)
    jfn = {"cached": JS.cached_candidate_attention,
           "decode": JS.decode_candidate_attention}.get(
               route, JS.extend_attention)
    tfn = {"cached": sumi.cached_candidate_attention,
           "decode": sumi.decode_candidate_attention}.get(
               route, sumi.extend_attention)
    lead = (lengths,) if route == "decode" else ()

    def jcall(q, kh, vh, kc, vc, ks, vs, i, *lens):
        return jfn(q, kh, vh, kc, vc, *lens, impl=impl, temperature=tau,
                   k_scale=ks, v_scale=vs, row_index=i)
    exp = jax.jit(jcall)(q, ops["k_hist"], ops["v_hist"], kc, vc,
                         ops["k_scale"], ops["v_scale"], idx, *lead)
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in ops.items()}
    got = tfn(torch.from_numpy(q), t["k_hist"], t["v_hist"],
              torch.from_numpy(kc), torch.from_numpy(vc),
              *(torch.from_numpy(a) for a in lead), impl=impl,
              temperature=tau, k_scale=t["k_scale"], v_scale=t["v_scale"],
              row_index=torch.from_numpy(idx))
    assert got.shape == (b, m, h, d)
    _close(got, exp, 2e-5)


def test_bf16_weights_stated_bound(setup):
    """The bf16 weights the engine serves with: the port's fused forward
    and split path stay within BF16_TOL of the JAX fused forward."""
    jc, tc, jparams, _, _ = setup
    tp = C.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _batch(seed=3)
    exp = jax.jit(lambda p, b: JC.climber_forward(p, b, jc, impl="fused"))(
        jparams, batch)
    got = C.climber_forward(tp, _tb(batch), tc, impl="fused")
    assert got.dtype == torch.float32
    _close(got, exp, BF16_TOL)
    kv = C.encode_history(tp, _tb(batch), tc, impl="fused")
    assert kv["b0"]["k"].dtype == torch.bfloat16
    got = C.score_candidates(tp, kv, torch.from_numpy(batch["candidates"]),
                             tc, impl="fused")
    _close(got, exp, BF16_TOL)
