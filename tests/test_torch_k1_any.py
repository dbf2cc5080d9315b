"""K1 (fused_score) past head dim 128, on the CPU, against the JAX package.

Past the tiled kernels' head dims (16 / 32 / 64 / 128, smaller ones
padded) the wrapper routes to the any-dims variant ``csrc/score_any.cu``
on the card; on CPU tensors it runs the variant's plain twin
(``fused_score_any_plain``: 64-key splits of the history, then in
``extend`` mode of the causal suffix, dealt to the four CTAs of the
kernel's cluster by split index, each CTA folding its splits into a
running softmax state in f32 with the kernel's operand roundings, the
states merged in rank order with the candidate's own key last).  The twin
and the CPU route are held here to JAX's K1 wrappers running the Pallas
kernel in interpret mode (which pads D to the 128 lanes and so takes any
D), within 1e-5 for f32 q and 5e-3 for bf16 q (the port's bf16 tolerance:
the two sides round q's scaling and the output to bf16 at other places);
a packed index against JAX's ``path="jnp"`` at any alignment and its
kernel under a declared alignment of 8; the wide-head Climber served by
the port's engine against JAX's engine (2e-2 on an int8 pool, the
``tests/test_fke.py`` QTOL), hit == miss bitwise; the twin's own bitwise
rules, the ones the card holds the kernel to.  Also: ``route()`` and
the batch chunks the tiled wrappers launch over when B * H passes the
grid's 65535.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.pda import RemoteFeatureStore as JStore
from repro.kernels.fused_score import ops as j_fs
from repro.models import build_model
from repro.serving import FlameEngine as JFlameEngine
from repro.serving.scheduler import run_workload_async as j_run_workload
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.kernels import _build
from repro_torch.kernels.fused_score import ops as fs
from repro_torch.serving import create_engine
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.types import ClimberConfig

torch.set_num_threads(1)
F32_TOL = 1e-5
BF16_TOL = 5e-3
QTOL = 2e-2
B, U, S, H, HKV = 3, 2, 20, 4, 2
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (None, torch.bfloat16, jnp.bfloat16)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``
    ("f32" / "bf16": both sides round f32 to nearest even)."""
    _, tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _history(rng, u, s, hkv, d, hist):
    """The pool's stored history on both sides: int8 codes with absmax
    scales [U,1,Hkv,1] (the pool's per-layer layout), or bf16 / f32 values
    without scales."""
    out = {}
    for name in ("k", "v"):
        x = _rand(rng, u, s, hkv, d)
        if hist == "int8":
            amax = np.maximum(np.abs(x).max(axis=(1, 3), keepdims=True),
                              1e-8).astype(np.float32)
            codes = np.clip(np.round(x / amax * 127), -127, 127) \
                .astype(np.int8)
            out[name] = (torch.from_numpy(codes), jnp.asarray(codes))
            out[name + "_scale"] = (torch.from_numpy(amax),
                                    jnp.asarray(amax))
        else:
            out[name] = _pair(x, hist)
            out[name + "_scale"] = (None, None)
    return out


def _close(got, want, qdt):
    tol = F32_TOL if qdt == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_route_picks_the_any_dims_variant_past_128():
    assert [fs.route(d) for d in (8, 24, 64, 100, 128)] == ["tiled"] * 5
    assert [fs.route(d) for d in (129, 160, 192, 256, 320, 4100)] \
        == ["any"] * 6
    assert fs.MAX_TILED_DIM == max(fs.HEAD_DIMS) == 128
    assert fs.compute_dtype(torch.bfloat16, torch.int8) == torch.bfloat16
    assert fs.compute_dtype(torch.bfloat16, torch.bfloat16) == torch.bfloat16
    assert fs.compute_dtype(torch.bfloat16, torch.float32) == torch.float32
    assert fs.compute_dtype(torch.float32, torch.int8) == torch.float32


@pytest.mark.parametrize("b,per_row,want", [
    (16385, 4, [(0, 16383), (16383, 16385)]),
    (4, 4, [(0, 4)]),
    (16383, 4, [(0, 16383)]),
    (65536, 1, [(0, 65535), (65535, 65536)]),
    (70000, 2, [(0, 32767), (32767, 65534), (65534, 70000)]),
    (3, 65535, [(0, 1), (1, 2), (2, 3)]),
])
def test_batch_chunks_keep_the_grid_under_its_limit(b, per_row, want):
    """The tiled kernels' grid y is B * H: their wrappers launch over batch
    chunks of at most 65535 // H rows, covering the batch in order."""
    got = _build.batch_chunks(b, per_row)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == b
    assert all(x[1] == y[0] for x, y in zip(got, got[1:]))
    assert all((b1 - b0) * per_row <= _build.MAX_GRID_Y for b0, b1 in got)


def test_row_ptr_is_the_address_of_the_row():
    """A chunk's operands are passed as the addresses of their batch rows,
    computed on the host: the address ``t[i]`` has, for contiguous,
    strided (a head slice of a fused projection) and offset tensors of
    every operand dtype; None stays None."""
    base = torch.zeros(6, 5, 7, 8)
    for t in (base, base[:, :, 2:4], base[1:], base.to(torch.bfloat16),
              base.to(torch.int8), torch.zeros(6, 4, dtype=torch.int32)):
        for i in (0, 1, t.shape[0] - 1):
            assert _build.row_ptr(t, i) == t[i].data_ptr()
    assert _build.row_ptr(None, 3) is None


def test_batch_chunks_refuse_a_row_wider_than_the_grid():
    with pytest.raises(ValueError, match="exceed"):
        _build.batch_chunks(2, 65536)


# (head dim, q dtype, history dtype, mode[, history length]): each head
# dim in each mode, every q / history pair at least twice; "decode" is
# cached mode with lengths (one pool row of length 0), "extend1" /
# "extend17" extend mode at M 1 / 17.  The history has S positions, one
# split of the variant; the cases with a length of 130 run three history
# splits, each with its own scales, and in decode mode lengths [0, 100]
# (the second row's ending inside its second split)
CASES = [
    (160, "bf16", "int8", "cached"), (160, "f32", "f32", "decode"),
    (160, "bf16", "bf16", "extend1"), (160, "f32", "int8", "extend17"),
    (192, "bf16", "int8", "decode"), (192, "f32", "bf16", "cached"),
    (192, "bf16", "f32", "extend17"), (192, "f32", "f32", "extend1"),
    (256, "bf16", "bf16", "decode"), (256, "f32", "int8", "cached"),
    (256, "bf16", "int8", "extend17"), (256, "f32", "bf16", "extend1"),
    (320, "bf16", "f32", "cached"), (320, "f32", "f32", "extend17"),
    (320, "bf16", "int8", "extend1"), (320, "f32", "bf16", "decode"),
    (192, "bf16", "int8", "cached", 130), (256, "bf16", "int8", "decode", 130),
    (160, "f32", "int8", "decode", 130),
]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                              for c in CASES])
def test_any_dims_twin_and_cpu_route_vs_jax_kernel(case):
    """The twin and the wrapper's CPU route (through the public entry
    points) against JAX's wrapper on its Pallas kernel in interpret mode,
    with the dedup index (3 batch rows on 2 pool rows) and scales."""
    d, qdt, hist, mode = case[:4]
    s = case[4] if len(case) > 4 else S
    rng = np.random.default_rng(d + len(mode) + (s if s != S else 0))
    m = {"extend1": 1, "extend17": 17}.get(mode, 7)
    q, kc, vc = (_pair(_rand(rng, B, m, n, d), qdt) for n in (H, HKV, HKV))
    hh = _history(rng, U, s, HKV, d, hist)
    idx = np.array([1, 0, 1], np.int32)
    lens = np.array([0, S - 3 if s == S else 100], np.int32)
    kw_t = dict(k_scale=hh["k_scale"][0], v_scale=hh["v_scale"][0],
                row_index=torch.from_numpy(idx))
    kw_j = dict(k_scale=hh["k_scale"][1], v_scale=hh["v_scale"][1],
                row_index=jnp.asarray(idx), path="kernel", interpret=True)
    args_t = (q[0], hh["k"][0], hh["v"][0], kc[0], vc[0])
    args_j = (q[1], hh["k"][1], hh["v"][1], kc[1], vc[1])
    if mode == "cached":
        want = j_fs.fused_cached_attention(*args_j, **kw_j)
        got = fs.fused_cached_attention(*args_t, **kw_t)
    elif mode == "decode":
        want = j_fs.fused_decode_attention(*args_j, jnp.asarray(lens),
                                           **kw_j)
        got = fs.fused_decode_attention(*args_t, torch.from_numpy(lens),
                                        **kw_t)
    else:
        want = j_fs.fused_extend_attention(*args_j, **kw_j)
        got = fs.fused_extend_attention(*args_t, **kw_t)
    assert got.dtype == q[0].dtype and got.shape == q[0].shape
    _close(got, want, qdt)
    # the twin called directly, its operands as the wrapper normalizes them
    twin = fs.fused_score_any_plain(
        *args_t, mode="cached" if mode in ("cached", "decode") else "extend",
        k_scale=fs._norm_scale(hh["k_scale"][0], U, HKV),
        v_scale=fs._norm_scale(hh["v_scale"][0], U, HKV),
        row_index=torch.from_numpy(idx),
        lengths=torch.from_numpy(lens) if mode == "decode" else None)
    assert torch.equal(twin, got)


def _packed_seg(b, m, u, align, seed):
    """Runs of one pool row starting on multiples of ``align`` (the
    packer's layout); the holes are dead slots on row 0."""
    r = np.random.default_rng(seed)
    seg = np.zeros((b, m), np.int32)
    live = np.zeros((b, m), bool)
    for row in range(b):
        off = 0
        while off < m:
            n = int(r.integers(1, 2 * align + 1))
            seg[row, off:off + n] = r.integers(0, u)
            live[row, off:off + n] = True
            off = -(-(off + n) // align) * align
    return seg, live


@pytest.mark.parametrize("qdt,hist,align,lengths", [
    ("bf16", "int8", 1, False), ("f32", "f32", 3, True),
    ("bf16", "bf16", 8, True), ("f32", "int8", 8, False)])
def test_any_dims_packed_vs_jax(qdt, hist, align, lengths):
    """A per-candidate (packed) row index at head dim 192: the CPU route
    against JAX's ``path="jnp"`` at any alignment and, on segments aligned
    to 8, against its kernel (interpret mode) under a declared alignment
    of 8; each live slot bitwise the twin's unpacked call of its pool
    row."""
    d, m, u = 192, 24, 3
    rng = np.random.default_rng(align + 11 * lengths)
    q, kc, vc = (_pair(_rand(rng, 2, m, n, d), qdt) for n in (H, HKV, HKV))
    hh = _history(rng, u, S, HKV, d, hist)
    seg, live = _packed_seg(2, m, u, align, seed=align)
    lens = np.array([S, 1, 0], np.int32)
    args_t = (q[0], hh["k"][0], hh["v"][0], kc[0], vc[0])
    args_j = (q[1], hh["k"][1], hh["v"][1], kc[1], vc[1])
    kw_t = dict(k_scale=hh["k_scale"][0], v_scale=hh["v_scale"][0],
                row_index=torch.from_numpy(seg))
    kw_j = dict(k_scale=hh["k_scale"][1], v_scale=hh["v_scale"][1],
                row_index=jnp.asarray(seg))
    if lengths:
        got = fs.fused_decode_attention(*args_t, torch.from_numpy(lens),
                                        **kw_t)
        call = lambda **kw: j_fs.fused_decode_attention(  # noqa: E731
            *args_j, jnp.asarray(lens), **kw_j, **kw)
    else:
        got = fs.fused_cached_attention(*args_t, **kw_t)
        call = lambda **kw: j_fs.fused_cached_attention(  # noqa: E731
            *args_j, **kw_j, **kw)
    pick = torch.from_numpy(live)
    _close(got[pick], np.asarray(call(path="jnp"))[live], qdt)
    if align % 8 == 0:
        prev = j_fs.set_packed_alignment(8)
        try:
            want = call(path="kernel", interpret=True)
        finally:
            j_fs.set_packed_alignment(prev)
        _close(got[pick], np.asarray(want)[live], qdt)
    norm = dict(k_scale=fs._norm_scale(hh["k_scale"][0], u, HKV),
                v_scale=fs._norm_scale(hh["v_scale"][0], u, HKV),
                lengths=torch.from_numpy(lens) if lengths else None)
    for row in range(u):
        one = fs.fused_score_any_plain(
            *args_t, mode="cached", row_index=torch.full((2,), row,
                                                         dtype=torch.int32),
            **norm)
        mine = torch.from_numpy(live & (seg == row))
        assert torch.equal(got[mine], one[mine])


# (mode, q dtype, history dtype): the twin's bitwise rules in both modes
# over every history dtype, each q dtype twice
RULES = [("cached", "bf16", "int8"), ("cached", "f32", "f32"),
         ("cached", "bf16", "bf16"), ("cached", "f32", "int8"),
         ("extend", "bf16", "int8"), ("extend", "f32", "bf16"),
         ("extend", "bf16", "bf16"), ("extend", "f32", "f32")]


@pytest.mark.parametrize("mode,qdt,hist", RULES,
                         ids=["-".join(c) for c in RULES])
def test_any_dims_twin_obeys_the_kernel_bitwise_rules(mode, qdt, hist):
    """The twin (the CPU route past head dim 128) holds the rules the card
    checks the kernel by, bitwise, at head dim 192 over 130 history
    positions (three splits, dealt to three of the cluster's ranks): the
    rows of an M = 5 call equal those of an M = 128 (extend: 129, the
    suffix's third split on rank 2) call; lengths == S equals no lengths;
    a history padded past lengths (a length inside each split) scores like
    the tight one, the padding 200 positions long, so that its splits 3-5
    fall to ranks 3, 0 and 1, which fold no such split on the tight
    history; two calls agree; in cached mode each live slot of a packed
    index equals its unpacked call."""
    d, b, u, s = 192, 2, 2, 130
    m = 128 if mode == "cached" else 129
    rng = np.random.default_rng(len(mode) + len(qdt) + len(hist))
    q, kc, vc = (_pair(_rand(rng, b, m, n, d), qdt)[0]
                 for n in (H, HKV, HKV))
    hh = _history(rng, u, s, HKV, d, hist)
    kh, vh = hh["k"][0], hh["v"][0]
    fill = torch.full((u, 200, HKV, d), 77 if hist == "int8" else 3.75,
                      dtype=kh.dtype)
    kw = dict(mode=mode, k_scale=fs._norm_scale(hh["k_scale"][0], u, HKV),
              v_scale=fs._norm_scale(hh["v_scale"][0], u, HKV),
              row_index=torch.tensor([1, 0], dtype=torch.int32))
    lens = torch.tensor([s - 1, 70], dtype=torch.int32)
    full = fs.fused_score(q, kh, vh, kc, vc, **kw)
    part = fs.fused_score(q, kh, vh, kc, vc, lengths=lens, **kw)
    few = fs.fused_score(q[:, :5].contiguous(), kh, vh,
                         kc[:, :5].contiguous(), vc[:, :5].contiguous(),
                         **kw)
    assert torch.equal(few, full[:, :5])
    assert torch.equal(fs.fused_score(
        q, kh, vh, kc, vc, lengths=torch.full_like(lens, s), **kw), full)
    assert torch.equal(fs.fused_score(
        q, torch.cat([kh, fill], 1), torch.cat([vh, fill], 1), kc, vc,
        lengths=lens, **kw), part)
    assert torch.equal(fs.fused_score(q, kh, vh, kc, vc, lengths=lens,
                                      **kw), part)
    assert not torch.equal(part, full)   # the lengths cut live keys
    if mode == "cached":
        seg, live = _packed_seg(b, m, u, 8, seed=3)
        seg, live = torch.from_numpy(seg), torch.from_numpy(live)
        kw.update(row_index=seg, lengths=lens)
        packed = fs.fused_score(q, kh, vh, kc, vc, **kw)
        for row in range(u):
            kw.update(row_index=torch.full((b,), row, dtype=torch.int32))
            one = fs.fused_score(q, kh, vh, kc, vc, **kw)
            pick = live & (seg == row)
            assert pick.any()
            assert torch.equal(packed[pick], one[pick])


def test_any_dims_twin_deals_splits_to_the_cluster_by_index():
    """The twin's dealing: a history of 9 splits folds into the cluster's
    CLUSTER ranks by split index, each rank's state a softmax over its own
    splits' keys alone; merged in rank order it is the softmax over all
    keys (within f32 rounding of one dense softmax)."""
    from repro_torch.kernels import _any
    rng = np.random.default_rng(0)
    r, d, n = 8, 64, 9 * _any.SPLIT - 5
    q = torch.from_numpy(_rand(rng, r, d))
    k, v = (torch.from_numpy(_rand(rng, n, d)) for _ in range(2))
    ok = torch.ones(1, n, dtype=torch.bool)
    got = _any.cluster_fold(q, [(k, v, ok, 0.125, None)],
                            dtype=torch.float32)
    want = torch.softmax((q.double() @ k.double().T) * 0.125, -1) \
        @ v.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert _any.CLUSTER == 4 and _any.SPLIT == 64


# ---------------------------------------------------------------------------
# the wide-head Climber through the engine
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=5_000, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=160)
ENGINE = dict(n_history=64, buckets=(16, 8), n_streams=2,
              feature_mode="sync", window_s=0.004, max_batch=2, n_workers=2)


def test_wide_head_climber_engine_matches_jax_engine():
    """The reduced Climber with heads of 160 (past K1's tiled dims) served
    by the port's ``FlameEngine(impl="fused")`` on an int8 pool, its
    ``cached`` dispatches through the any-dims route, against JAX's
    engine under ``fused`` on the same traffic and weights (within the
    int8 QTOL); a user's hit equals its miss bitwise."""
    jc = dataclasses.replace(
        j_get_config("climber"), **SMALL,
        climber=JClimberConfig(num_blocks=2, layers_per_block=2))
    tc = dataclasses.replace(
        get_config("climber"), **SMALL,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    assert fs.route(tc.head_dim) == "any"
    jbundle = build_model(jc)
    jparams, _ = jbundle.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = C.params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    kw = dict(candidate_counts=(8, 16, 24), distribution="jittered",
              n_requests=8, n_history=64, n_users=3, seed=5)
    reqs = generate_traffic(TrafficConfig(**kw), n_items=5000)
    jeng = JFlameEngine(jbundle, j32, **ENGINE, impl="fused",
                        history_cache=True, pool_dtype="int8",
                        store=JStore(latency_s=0.0, feature_dim=12))
    try:
        exp = j_run_workload(jeng, reqs)["outputs"]
    finally:
        jeng.shutdown()
    teng = create_engine("flame", C.build_climber(tc), t32, **ENGINE,
                         store=RemoteFeatureStore(latency_s=0.0,
                                                  feature_dim=12),
                         impl="fused", pool_dtype="int8", device="cpu")
    try:
        miss = run_workload_async(teng, reqs)["outputs"]
        hit = run_workload_async(teng, reqs)["outputs"]
        m = teng.metrics()
    finally:
        teng.shutdown()
    for got, want in zip(miss, exp):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=QTOL,
                                   rtol=QTOL)
    for a, b in zip(miss, hit):
        np.testing.assert_array_equal(a, b)
    assert m["pool_hits"] > 0 and m["pool_misses"] > 0
