"""Per-op parity of the PyTorch port (``repro_torch``) with the JAX package.

Every input is made from a seed with numpy and handed to both packages;
JAX runs on the CPU, jit-wrapped (eager and compiled JAX round differently,
docs/ARCHITECTURE.md §7).  Tolerances: f32 ops 1e-5; masks, int8 codes and
scales bitwise (both sides divide, multiply by 127 and round half to even in
the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import ffn as JF
from repro.models import layers as JL
from repro.serving import kv_cache as JKV
from repro.types import ModelConfig as JModelConfig
from repro_torch import tree
from repro_torch.models import attention as TA
from repro_torch.models import ffn as TF
from repro_torch.models import layers as TL
from repro_torch.serving import kv_cache as TKV
from repro_torch.types import ModelConfig, TensorSpec

torch.set_num_threads(1)
TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _cfg(**kw):
    base = dict(name="t", family="climber", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=100,
                head_dim=8, norm="layernorm", activation="gelu")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 32)])
def test_norms(shape):
    r = _rng(0)
    xj, xt = _both(r.normal(size=shape).astype(np.float32) * 3 + 1)
    sj, st = _both(r.normal(size=shape[-1:]).astype(np.float32))
    bj, bt = _both(r.normal(size=shape[-1:]).astype(np.float32))
    _close(TL.rmsnorm(xt, st), jax.jit(JL.rmsnorm)(xj, sj))
    _close(TL.layernorm(xt, st, bt), jax.jit(JL.layernorm)(xj, sj, bj))
    for norm in ("rmsnorm", "layernorm"):
        jc, tc = _cfg(norm=norm)
        p = {"scale": st, "bias": bt}
        pj = {"scale": sj, "bias": bj}
        _close(TL.apply_norm(tc, p, xt),
               jax.jit(lambda p, x: JL.apply_norm(jc, p, x))(pj, xj))


def test_layernorm_population_variance_bf16():
    """bf16 in, f32 math, bf16 out: bitwise with JAX on a bf16 input."""
    r = _rng(1)
    x = r.normal(size=(4, 64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    s, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    got = TL.layernorm(xt, torch.from_numpy(s), torch.from_numpy(b))
    exp = jax.jit(JL.layernorm)(xj, jnp.asarray(s), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(exp, np.float32))


@pytest.mark.parametrize("d", [8, 16, 10])
@pytest.mark.parametrize("max_pos,tol", [(64, TOL), (600, 1e-4)])
def test_rope_half_split(d, max_pos, tol):
    """Half-split rotation in f32.  At positions in the hundreds the f32
    angle (position x an exp-derived frequency) carries ~1e-7 relative
    error into sin/cos, so the tolerance widens there; an interleaved or
    mis-split rotation would be off by O(1)."""
    r = _rng(2)
    x = r.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = r.integers(0, max_pos, size=(2, 7))
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    exp = jax.jit(lambda x, p: JL.rope(x, p, 1e6))(jnp.asarray(x),
                                                   jnp.asarray(pos))
    _close(got, exp, tol)
    assert TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 0.0) \
        .equal(torch.from_numpy(x))


@pytest.mark.parametrize("name", ["gelu", "relu", "silu"])
def test_activation(name):
    x = _rng(3).normal(size=(64,)).astype(np.float32) * 4
    _close(TL.activation_fn(name)(torch.from_numpy(x)),
           jax.jit(JL.activation_fn(name))(jnp.asarray(x)))


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_ffn_apply(activation):
    jc, tc = _cfg(activation=activation)
    r = _rng(4)
    p = {"w_up": r.normal(size=(32, 64)), "w_down": r.normal(size=(64, 32)),
         "w_gate": r.normal(size=(32, 64))}
    p = {k: (v / 8).astype(np.float32) for k, v in p.items()}
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    got = TF.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), tc)
    exp = jax.jit(lambda p, x: JF.ffn_apply(p, x, jc))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(got, exp, 1e-4)


def test_project_qkv_and_out():
    jc, tc = _cfg(qkv_bias=True)
    r = _rng(5)
    shapes = {"wq": (32, 4, 8), "wk": (32, 2, 8), "wv": (32, 2, 8),
              "wo": (4, 8, 32), "bq": (4, 8), "bk": (2, 8), "bv": (2, 8)}
    p = {k: (r.normal(size=s) / 5).astype(np.float32)
         for k, s in shapes.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    x = r.normal(size=(2, 6, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    got = TA.project_qkv(pt, torch.from_numpy(x), tc, torch.from_numpy(
        pos.copy()))
    exp = jax.jit(lambda p, x, s: JA.project_qkv(p, x, jc, s))(
        pj, jnp.asarray(x), jnp.asarray(pos))
    for g, e in zip(got, exp):
        _close(g, e)
    o = r.normal(size=(2, 6, 4, 8)).astype(np.float32)
    _close(TA.project_out(pt, torch.from_numpy(o)),
           jax.jit(JA.project_out)(pj, jnp.asarray(o)))


MASKS = [("full", {}), ("causal", {}), ("sliding", dict(window=3)),
         ("sumi", dict(n_history=5)), ("causal", dict(q_offset=4)),
         ("sumi", dict(n_history=6, q_offset=6))]


@pytest.mark.parametrize("mode,kw", MASKS)
def test_make_mask_bitwise(mode, kw):
    sk = 9 + kw.get("q_offset", 0)
    got = TA.make_mask(9, sk, mode, **kw).numpy()
    exp = np.asarray(JA.make_mask(9, sk, mode, **kw))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("mode,kw", MASKS)
def test_reference_attention(mode, kw):
    r = _rng(6)
    sk = 11 + kw.get("q_offset", 0)
    q = r.normal(size=(2, 11, 4, 8)).astype(np.float32)
    k = r.normal(size=(2, sk, 2, 8)).astype(np.float32)
    v = r.normal(size=(2, sk, 2, 8)).astype(np.float32)
    got = TA.reference_attention(*map(torch.from_numpy, (q, k, v)), mode,
                                 **kw)
    exp = jax.jit(lambda q, k, v: JA.reference_attention(q, k, v, mode, **kw))(
        *map(jnp.asarray, (q, k, v)))
    _close(got, exp)


@pytest.mark.parametrize("ndim", [5, 4, 2])
def test_int8_codes_and_scales_bitwise(ndim):
    """quantize_leaf / quantize_kv_graph: codes and scales bitwise equal to
    the JAX pool's on the same f32 input (incl. exact .5 ties and a zero
    block, where the 1e-8 floor applies)."""
    shape = {5: (2, 3, 9, 2, 8), 4: (3, 9, 2, 8), 2: (5, 7)}[ndim]
    a = (_rng(7).normal(size=shape) * 3).astype(np.float32)
    a.reshape(-1)[:4] = [127.0, -63.5, 0.5, -0.5]
    if ndim == 5:
        a[1, 2] = 0.0
    jl = JKV.quantize_leaf(jnp.asarray(a), "int8")
    tl = TKV.quantize_leaf(torch.from_numpy(a), "int8")
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    jg = jax.jit(lambda x: JKV.quantize_kv_graph({"k": x}, "int8"))(
        jnp.asarray(a))["k"]
    tg = TKV.quantize_kv_graph({"k": torch.from_numpy(a)}, "int8")["k"]
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
    np.testing.assert_array_equal(tg[1].numpy(), np.asarray(jg[1]))
    np.testing.assert_array_equal(
        TKV.dequantize_leaf(tl).numpy(),
        np.asarray(JKV.dequantize_leaf(jl)))


def test_bf16_pool_leaf_and_payload_bytes():
    a = _rng(8).normal(size=(1, 2, 5, 2, 4)).astype(np.float32)
    kv = {"b0": {"k": a, "v": a * 2}}
    for dtype in ("native", "bf16", "int8"):
        jp, jn = JKV.quantize_kv(jax.tree.map(jnp.asarray, kv), dtype)
        tp, tn = TKV.quantize_kv(tree.tree_map(torch.from_numpy, kv), dtype)
        assert tn == jn
        got = TKV.dequantize_kv(tp)["b0"]["v"]
        exp = JKV.dequantize_kv(jp)["b0"]["v"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(exp, np.float32))


@pytest.mark.parametrize("dtype", ["native", "bf16", "int8"])
def test_raw_views_flatten_in_jax_order(dtype):
    """The raw pool view flattens leaf for leaf in the JAX treedef order
    (per block, then k/v, then (values, scale)) — the executor argument
    order of both engines."""
    r = _rng(9)
    kv = {f"b{i}": {n: r.normal(size=(1, 2, 5, 2, 4)).astype(np.float32)
                    for n in ("k", "v")} for i in range(2)}
    jraw = JKV.raw_kv_view(JKV.quantize_kv(jax.tree.map(jnp.asarray, kv),
                                           dtype)[0])
    traw = TKV.raw_kv_view(TKV.quantize_kv(tree.tree_map(torch.from_numpy,
                                                         kv), dtype)[0])
    jl, tl = jax.tree.leaves(jraw), tree.leaves(traw)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    specs = TKV.raw_kv_specs(tree.tree_map(
        lambda a: TensorSpec(a.shape, torch.float32), kv), dtype)
    assert [s.shape for s in tree.leaves(specs)] == \
        [tuple(t.shape) for t in tl]
    assert [s.dtype for s in tree.leaves(specs)] == [t.dtype for t in tl]
    assert tree.unflatten(tree.structure(traw), tl)["b1"]["v"] is not None


def test_tree_unflatten_round_trip():
    t = {"b": (1, None, [2, 3]), "a": {"z": 4, "y": (5,)}}
    flat, struct = tree.leaves(t), tree.structure(t)
    assert flat == [5, 4, 1, 2, 3]
    assert tree.unflatten(struct, flat) == t
    with pytest.raises(ValueError):
        tree.unflatten(struct, flat + [6])
