"""The ``extend`` family and DSO segment packing in the port, held to the
JAX package and to the port's own invariants, on the CPU.

* ``extend_history`` against the jit-wrapped JAX ``extend_history`` from the
  same basis (1e-5 under ``reference``, 5e-3 under ``fused``, as stated in
  ROADMAP.md's numeric contract), and against a fresh encode of the new
  history; a raw int8 basis extends bitwise like the host-dequantized one.
  (JAX finds the extension bitwise a fresh encode; torch's CPU GEMMs and
  reductions follow the operands' shapes, so the port holds it at 1e-5.)
* ``StaleBasis`` / ``lookup(want_basis, raw_basis)``.
* ``SegmentPacker``: the JAX packer's placements for the same segments, and
  its invariants (``tests/test_dso_v2.py``).
* packed ``cached`` and ``decode`` == unpacked, bitwise, for every impl, and
  against the JAX packed routes.
* the engine: tail-append, partial-prefix, unrelated-history, crossover and
  refresh-cap cases (``tests/test_pda_v2.py``, ``tests/test_fke.py``), a
  failed extend leader's waiters, the packed engine's concurrent output ==
  its sequential output, packed == unpacked engines, packed generation.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import dso as JDSO
from repro.core import sumi as JS
from repro.models import build_model
from repro.serving.kv_cache import dequantize_kv as j_dequantize_kv
from repro.serving.kv_cache import quantize_kv as j_quantize_kv
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.core import dso as DSO
from repro_torch.core import sumi
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.serving import BeamConfig, TopKConfig, create_engine
from repro_torch.serving.kv_cache import (HistoryKVPool, StaleBasis,
                                          dequantize_kv, quantize_kv,
                                          raw_kv_view)
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.tree import leaves, structure, tree_map, unflatten
from repro_torch.types import ClimberConfig, TensorSpec

torch.set_num_threads(1)
TOL = 1e-5
KTOL = 5e-3
# engine scores against a fresh engine on the new history: the extended
# entry's rows differ from a fresh encode's in the last bits (and, under an
# int8 pool, by a re-quantization), as tests/test_pda_v2.py allows
ETOL = 2e-3
QTOL = 2e-2
N = 64
SMALL = dict(vocab_size=5_000, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)
ENGINE = dict(n_history=N, buckets=(16, 8), n_streams=2, feature_mode="sync",
              window_s=0.004, max_batch=2, n_workers=2, pool_slots=8)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(
        j_get_config("climber"), **SMALL,
        climber=JClimberConfig(num_blocks=2, layers_per_block=2))
    tc = dataclasses.replace(
        get_config("climber"), **SMALL,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    jbundle = build_model(jc)
    jparams, _ = jbundle.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = C.params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    return jc, jbundle, j32, C.build_climber(tc), t32


def _engine(bundle, params, **kw):
    base = dict(ENGINE, store=RemoteFeatureStore(latency_s=0.0,
                                                 feature_dim=12),
                impl="fused", device="cpu")
    base.update(kw)
    return create_engine("flame", bundle, params, **base)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# extend_history
# ---------------------------------------------------------------------------

def _histories(prefix_len, seed=3):
    r = np.random.default_rng(seed)
    h1 = r.integers(0, 5000, (2, N)).astype(np.int32)
    h2 = h1.copy()
    if prefix_len < N:
        h2[:, prefix_len:] = r.integers(0, 5000, (2, N - prefix_len))
    side = r.normal(size=(2, 12)).astype(np.float32)
    return ({"history": h1, "side": side},
            {"history": h2, "side": side + 0.5})     # the side always moves


@pytest.mark.parametrize("prefix_len", [N, 3 * N // 4, N // 2, 0])
@pytest.mark.parametrize("impl,tol", [("reference", TOL), ("fused", KTOL)],
                         ids=["reference", "fused"])
def test_extend_history_vs_jax(setup, impl, tol, prefix_len):
    """The port's extension == the JAX extension from the same basis (the
    JAX encode of the old history), and == a fresh encode of the new
    history within 1e-5."""
    jc, jbundle, j32, tb, t32 = setup
    b1, b2 = _histories(prefix_len)
    jb1 = {k: jnp.asarray(v) for k, v in b1.items()}
    jb2 = {k: jnp.asarray(v) for k, v in b2.items()}
    basis = jax.jit(lambda p, b: jbundle.encode_history(
        p, b, impl="reference"))(j32, jb1)
    want = jax.jit(lambda p, kv, b: jbundle.extend_history(
        p, kv, b, prefix_len=prefix_len, impl=impl))(j32, basis, jb2)
    tbasis = tree_map(_t, jax.tree.map(np.asarray, basis))
    tb2 = {k: _t(v) for k, v in b2.items()}
    got = tb.extend_history(t32, tbasis, tb2, prefix_len=prefix_len,
                            impl=impl)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)
    fresh = tb.encode_history(t32, tb2, impl=impl)
    for g, f in zip(leaves(got), leaves(fresh)):
        _close(g, f.numpy(), TOL)


@pytest.mark.parametrize("impl", ["reference", "fused", "pallas"])
def test_extend_history_raw_basis_bitwise(setup, impl):
    """A raw int8 basis ((values, scale) pool views) is dequantized inside
    the extension by the pool's own formula: the result is bitwise the
    extension of the host-dequantized basis (``tests/test_dso_v2.py``)."""
    _, _, _, tb, t32 = setup
    b1, b2 = _histories(N, seed=11)
    tb1 = {k: _t(v) for k, v in b1.items()}
    tb2 = {k: _t(v) for k, v in b2.items()}
    payload, _ = quantize_kv(tb.encode_history(t32, tb1, impl=impl), "int8")
    raw = tb.extend_history(t32, raw_kv_view(payload), tb2, prefix_len=N,
                            impl=impl)
    deq = tb.extend_history(t32, dequantize_kv(payload), tb2, prefix_len=N,
                            impl=impl)
    for a, b in zip(leaves(raw), leaves(deq)):
        assert torch.equal(a, b)


def test_extend_history_rejects_bad_prefix(setup):
    _, _, _, tb, t32 = setup
    b1, _ = _histories(N)
    tb1 = {k: _t(v) for k, v in b1.items()}
    kv = tb.encode_history(t32, tb1)
    with pytest.raises(ValueError, match="prefix_len"):
        tb.extend_history(t32, kv, tb1, prefix_len=N + 1)


def test_extend_attention_rejects_packed_index():
    """Suffix extension is causal: a per-candidate (2-D) index raises the
    JAX package's ValueError, under every impl."""
    k = torch.randn(1, 4, 2, 16)
    for impl in ("reference", "pallas", "fused"):
        with pytest.raises(ValueError, match="causal"):
            sumi.extend_attention(k, k, k, k, k, impl=impl,
                                  row_index=torch.zeros((1, 4),
                                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="causal"):
        JS.extend_attention(*(jnp.asarray(k.numpy()),) * 5, impl="chunked",
                            row_index=jnp.zeros((1, 4), jnp.int32))


# ---------------------------------------------------------------------------
# the pool's stale basis
# ---------------------------------------------------------------------------

def _kv(seed=0, s=5):
    g = torch.Generator().manual_seed(seed)
    return {"b0": {"k": torch.randn(1, 2, s, 2, 4, generator=g),
                   "v": torch.randn(1, 2, s, 2, 4, generator=g)}}


def test_pool_stale_basis():
    """A stale lookup drops the entry and, with ``want_basis``, hands it back
    as a StaleBasis: its K/V (dequantized, or raw with ``raw_basis``), the
    window it encoded and its extension count; the callbacks count."""
    pool = HistoryKVPool(4, dtype="int8", device="cpu")
    win = np.arange(5, dtype=np.int32)
    pool.put("u", "fp0", _kv(), hist_window=win, refreshes=2)
    kv, status, basis = pool.lookup("u", "fp1", want_basis=True,
                                    raw_basis=True)
    assert kv is None and status == "stale" and isinstance(basis, StaleBasis)
    assert basis.refreshes == 2 and np.array_equal(basis.hist_window, win)
    values, scale = basis.kv["b0"]["k"]
    assert values.dtype == torch.int8 and scale.dtype == torch.float32
    assert pool.lookup("u", "fp1", want_basis=True) == (None, "miss", None)
    pool.put("u", "fp0", _kv(), hist_window=win)
    _, status, basis = pool.lookup("u", "fp2", want_basis=True)
    assert status == "stale" and basis.refreshes == 0
    assert basis.kv["b0"]["k"].dtype == torch.float32      # dequantized
    pool.put("u", "fp0", _kv())
    assert pool.lookup("u", "fp3") == (None, "stale", None)
    pool.count_extension()
    pool.count_refresh_reencode()
    st = pool.stats()
    assert st["extensions"] == 1 and st["refresh_reencodes"] == 1
    assert st["stale"] == 3 and st["misses"] == 4


# ---------------------------------------------------------------------------
# the segment packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align", [1, 8])
@pytest.mark.parametrize("seed", range(4))
def test_packer_matches_jax_and_invariants(seed, align):
    """The port's packer places a random segment stream exactly as the JAX
    packer does, and its placements hold the invariants: rows within
    capacity, no segment across a row or past the bucket, starts aligned,
    one KV slot per identity, no overlaps, fills that add up."""
    r = np.random.default_rng(seed)
    bucket, max_rows, max_kv = 16, int(r.integers(1, 6)), int(r.integers(1, 6))
    segs = [(int(r.integers(1, bucket + 1)), int(r.integers(0, 6)))
            for _ in range(int(r.integers(1, 30)))]
    mine = DSO.SegmentPacker(bucket, max_rows, max_kv, align=align)
    ref = JDSO.SegmentPacker(bucket, max_rows, max_kv, align=align)
    placed = []
    for valid, ident in segs:
        p = mine.try_add(valid, ident)
        assert p == ref.try_add(valid, ident)
        if p is not None:
            placed.append((valid, ident, p))
    assert placed and mine.fills == ref.fills
    assert mine.is_full() == ref.is_full()
    rows = {}
    for valid, ident, (row, off, slot) in placed:
        assert 0 <= row < max_rows and off % align == 0
        assert 0 <= off and off + valid <= bucket
        assert slot == mine.slot_of[ident]
        rows.setdefault(row, []).append((off, off + valid))
    assert mine.n_slots <= max_kv and len(rows) == mine.n_rows <= max_rows
    for row, iv in rows.items():
        iv.sort()
        assert all(a1 <= b0 for (_, a1), (b0, _) in zip(iv, iv[1:]))
        assert mine.fills[row] == iv[-1][1]


def test_packer_rejects_oversized_and_fills():
    p = DSO.SegmentPacker(8, max_rows=2, max_kv=2)
    with pytest.raises(ValueError):
        p.try_add(9, "a")
    assert p.try_add(8, "a") == (0, 0, 0)
    assert p.try_add(5, "b") == (1, 0, 1)
    assert p.try_add(4, "a") is None        # no row has 4 slots left
    assert p.try_add(3, "c") is None        # KV capacity exhausted
    assert p.try_add(3, "b") == (1, 5, 1)   # existing ident still packs
    assert p.is_full()
    aligned = DSO.SegmentPacker(16, max_rows=1, max_kv=4, align=8)
    assert aligned.try_add(3, "a") == (0, 0, 0)
    assert aligned.try_add(3, "b") == (0, 8, 1)      # hole 3..7 is dead
    assert aligned.try_add(1, "c") is None and aligned.is_full()


def test_policy_packed_rows():
    pol = DSO.CoalescePolicy(max_batch=8, pack_rows=2, pack_align=8)
    assert (pol.batch, pol.rows) == (8, 2)
    assert DSO.CoalescePolicy(max_batch=4).rows == 4
    assert DSO.CoalescePolicy(enabled=False, pack_rows=3).rows == 1
    for bad in (dict(pack_rows=0), dict(pack_align=0)):
        with pytest.raises(ValueError):
            DSO.CoalescePolicy(**bad)


def test_orchestrator_packs_segments_of_several_requests():
    """Unpadded segments of different requests share one packed dispatch:
    the executor gets each identity's rows once, the [rows, bucket]
    seg-index and candidate planes (dead slots seg 0 / -1), and every
    segment gets exactly its slice back."""
    seen = []

    def build_fn(kind, bucket, batch):
        def fn(kv, seg, cand):
            seen.append((kv.clone(), seg.clone(), cand.clone()))
            return kv[seg.long()][..., 0] * 1000 + cand
        return DSO.Executor(fn, [TensorSpec((batch, 1), torch.int32),
                                 TensorSpec((2, bucket), torch.int32),
                                 TensorSpec((2, bucket), torch.int32)], "cpu")

    orch = DSO.CoalescingOrchestrator(
        build_fn, families={"cached": (8,)},
        pad_slice_fn=lambda req, c, kind: (
            req[0], req[1][:, c.start:c.start + c.valid]),
        gather_fn=lambda rows, cs, m, kind: np.concatenate(rows, axis=1),
        policy=DSO.CoalescePolicy(max_batch=4, window_s=0.2, pack_rows=2,
                                  pack_align=4),
        n_streams=1, packed_kinds={"cached": 1})
    try:
        reqs = [(np.array([[u]], np.int32),
                 np.arange(m, dtype=np.int32)[None] + 10 * u)
                for u, m in ((1, 3), (2, 5), (1, 2))]
        futs = [orch.submit(r, r[1].shape[1], kind="cached",
                            dedup_token=("u", int(r[0][0, 0])))
                for r in reqs]
        outs = [f.result() for f in futs]
    finally:
        orch.shutdown()
    for (kv, cand), out in zip(reqs, outs):
        np.testing.assert_array_equal(out, kv[0, 0] * 1000 + cand)
    assert len(seen) == 1                     # one dispatch carried all
    kv, seg, cand = seen[0]
    assert sorted(kv[:2, 0].tolist()) == [1, 2]
    live = cand >= 0
    assert int(live.sum()) == 10 and bool((seg[~live] == 0).all())
    assert torch.equal(kv[seg.long()][..., 0][live], cand[live] // 10)
    st = orch.stats()
    assert st["packed_segments"] == 3 and st["dedup_rows_saved"] == 1
    with pytest.raises(ValueError, match="subsumes"):
        DSO.CoalescingOrchestrator(
            build_fn, families={"cached": (8,)}, pad_slice_fn=None,
            gather_fn=None, dedup_kinds={"cached": 1},
            packed_kinds={"cached": 1})


# ---------------------------------------------------------------------------
# packed routes: bitwise the unpacked ones, and the JAX packed routes
# ---------------------------------------------------------------------------

RAGGED_LAYOUTS = [
    # (m_total, segments as (count, user)), incl. 1-candidate segments
    (1, ((1, 0),)),
    (7, ((3, 0), (4, 2))),
    (16, ((1, 1), (1, 0), (14, 2))),
    (16, ((5, 0), (11, 1))),
]


def _users(tb, t32, pool, n_users=3, seed=3):
    r = np.random.default_rng(seed)
    kvs = []
    for _ in range(n_users):
        kv = tb.encode_history(t32, {
            "history": _t(r.integers(0, 5000, (1, N)).astype(np.int32)),
            "side": _t(r.normal(size=(1, 12)).astype(np.float32))})
        if pool != "native":
            kv = raw_kv_view(quantize_kv(kv, pool)[0])
        kvs.append(kv)
    return kvs, _stack(kvs)


def _stack(kvs):
    return unflatten(structure(kvs[0]), [torch.cat(xs, 0) for xs in zip(
        *(leaves(kv) for kv in kvs))])


def _seg(segments, m_total):
    seg = np.zeros((1, m_total), np.int32)
    off = 0
    for count, user in segments:
        seg[0, off:off + count] = user
        off += count
    return torch.from_numpy(seg)


@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("impl", ["reference", "pallas", "fused"])
def test_packed_scoring_bitwise_vs_unpacked(setup, impl, pool):
    """score_candidates over a segment-packed row == the same candidates
    scored on each user's own rows, bitwise, under every impl."""
    _, _, _, tb, t32 = setup
    kvs, stack = _users(tb, t32, pool)
    r = np.random.default_rng(4)
    for m_total, segments in RAGGED_LAYOUTS:
        cand = _t(r.integers(0, 5000, (1, m_total)).astype(np.int32))
        packed = tb.score_candidates(t32, stack, cand, impl=impl,
                                     row_index=_seg(segments, m_total))
        off = 0
        for count, user in segments:
            alone = tb.score_candidates(t32, kvs[user], cand, impl=impl)
            assert torch.equal(packed[0, off:off + count],
                               alone[0, off:off + count]), (segments, off)
            off += count


@pytest.mark.parametrize("impl", ["reference", "pallas", "fused"])
def test_packed_decode_bitwise_vs_unpacked(setup, impl):
    """decode_logits over a packed row of beam caches at different lengths
    == each beam decoded on its own, bitwise, under every impl."""
    _, _, _, tb, t32 = setup
    kvs, _ = _users(tb, t32, "int8")
    pad = lambda a: a if a.shape[-1] == 1 else torch.nn.functional.pad(  # noqa: E731
        a, (0, 0, 0, 0, 0, 3))
    kvs = [tree_map(pad, kv) for kv in kvs]
    stack = _stack(kvs)
    s0 = N // 2 + 1
    lens = torch.tensor([s0, s0 - 5, s0 + 2], dtype=torch.int32)
    r = np.random.default_rng(6)
    for m_total, segments in RAGGED_LAYOUTS:
        cand = _t(r.integers(0, 5000, (1, m_total)).astype(np.int32))
        packed = tb.decode_logits(t32, stack, cand, lens, impl=impl,
                                  row_index=_seg(segments, m_total))
        off = 0
        for count, user in segments:
            alone = tb.decode_logits(t32, kvs[user], cand,
                                     lens[user:user + 1], impl=impl)
            assert torch.equal(packed[0, off:off + count],
                               alone[0, off:off + count]), (segments, off)
            off += count


@pytest.mark.parametrize("impl,tol", [("reference", TOL), ("fused", KTOL)],
                         ids=["reference", "fused"])
def test_packed_scoring_vs_jax(setup, impl, tol):
    """The port's packed scoring == the JAX packed scoring (its segment
    attention, or its fused route with the 2-D index) from the same stored
    int8 rows."""
    _, jbundle, j32, tb, t32 = setup
    r = np.random.default_rng(8)
    jkvs = []
    for _ in range(3):
        jkv = jax.jit(lambda p, b: jbundle.encode_history(
            p, b, impl="reference"))(j32, {
                "history": jnp.asarray(r.integers(0, 5000, (1, N)),
                                       jnp.int32),
                "side": jnp.asarray(r.normal(size=(1, 12)), jnp.float32)})
        jkvs.append(jax.tree.map(np.asarray, jkv))
    jstack = jax.tree.map(lambda *xs: np.concatenate(xs, 0), *jkvs)
    jpay, _ = j_quantize_kv(jstack, "int8")
    jdeq = jax.tree.map(np.asarray, j_dequantize_kv(jpay))
    tpay, _ = quantize_kv(tree_map(_t, jstack), "int8")
    cand = r.integers(0, 5000, (2, 16)).astype(np.int32)
    seg = np.asarray([[0] * 5 + [2] * 11, [1] * 9 + [0] * 7], np.int32)
    want = jax.jit(lambda p, kv, c, s: jbundle.score_candidates(
        p, kv, c, impl=impl, row_index=s))(j32, jdeq, cand, seg)
    got = tb.score_candidates(t32, dequantize_kv(tpay), _t(cand), impl=impl,
                              row_index=_t(seg))
    _close(got, want, tol)


# ---------------------------------------------------------------------------
# the engine: extension
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_engine_tail_append_uses_extension(setup, impl):
    """Same user, history grown past the model window: the stale hit is
    served by one ``extend`` dispatch (bucket n: one token per block), the
    scores match a fresh engine on the new history, and a repeat is a
    plain hit on the extended entry."""
    _, _, _, tb, t32 = setup
    eng = _engine(tb, t32, impl=impl, incremental_history=True)
    fresh = _engine(tb, t32, impl=impl)
    r = np.random.default_rng(0)
    h1 = r.integers(0, 5000, 80).astype(np.int32)
    h2 = np.concatenate([h1, r.integers(0, 5000, 8).astype(np.int32)])
    cand = r.integers(0, 5000, 12).astype(np.int32)
    try:
        assert eng.dso.families["extend"] == [N, 3 * N // 4, N // 2]
        eng.serve(h1, cand, user_id=1)                       # encode
        out = eng.serve(h2, cand, user_id=1)                 # stale -> extend
        m = eng.metrics()
        assert m["pool_extensions"] == 1 and m["pool_stale"] == 1
        assert m["dso_dispatches_extend"] == 1
        assert m["dso_dispatches_encode"] == 1
        ref = fresh.serve(h2, cand, user_id=9)
        np.testing.assert_allclose(out, ref, atol=ETOL, rtol=ETOL)
        np.testing.assert_array_equal(out, eng.serve(h2, cand, user_id=1))
    finally:
        eng.shutdown()
        fresh.shutdown()


def test_engine_partial_prefix_extension(setup):
    """A mid-window change extends from the largest bucket <= the shared
    prefix (48 of a shared 50), with scores matching a fresh engine."""
    _, _, _, tb, t32 = setup
    eng = _engine(tb, t32, pool_dtype="int8", incremental_history=True)
    fresh = _engine(tb, t32, pool_dtype="int8")
    r = np.random.default_rng(2)
    h1 = r.integers(0, 5000, N).astype(np.int32)
    h2 = h1.copy()
    h2[50:] = r.integers(0, 5000, N - 50)
    cand = r.integers(0, 5000, 8).astype(np.int32)
    try:
        eng.serve(h1, cand, user_id=3)
        out = eng.serve(h2, cand, user_id=3)
        m = eng.metrics()
        assert m["pool_extensions"] == 1
        assert m["dso_chunks_extend"] == 1
        np.testing.assert_allclose(out, fresh.serve(h2, cand, user_id=9),
                                   atol=QTOL, rtol=0)
    finally:
        eng.shutdown()
        fresh.shutdown()


@pytest.mark.parametrize("case", ["unrelated", "crossover"])
def test_engine_reencodes_without_a_usable_prefix(setup, case):
    """A stale hit with no shared prefix (unrelated history), or one that
    only fits a bucket below the re-encode-vs-extend crossover, re-encodes
    in full; the crossover drops such buckets at construction."""
    _, _, _, tb, t32 = setup
    buckets = (64, 32) if case == "unrelated" else (64, 16)
    eng = _engine(tb, t32, incremental_history=True, extend_buckets=buckets)
    r = np.random.default_rng(1)
    h1 = r.integers(0, 5000, N).astype(np.int32)
    h2 = r.integers(0, 5000, N).astype(np.int32) if case == "unrelated" \
        else np.concatenate([h1[:20], r.integers(0, 5000, N - 20)
                             .astype(np.int32)])
    cand = r.integers(0, 5000, 8).astype(np.int32)
    try:
        if case == "crossover":
            assert eng.dso.families["extend"] == [64]
        eng.serve(h1, cand, user_id=2)
        eng.serve(h2, cand, user_id=2)
        m = eng.metrics()
        assert m["pool_extensions"] == 0 and m["pool_stale"] == 1
        assert m["dso_dispatches_encode"] == 2
    finally:
        eng.shutdown()


def test_engine_refresh_limit_bounds_drift(setup):
    """Every request tail-appends (an extendable stale hit that re-quantizes
    the int8 basis); after K extensions of an entry the next stale hit
    re-encodes in full, and the drift against a fresh engine stays within
    the int8 bound."""
    _, _, _, tb, t32 = setup
    K = 3
    eng = _engine(tb, t32, pool_dtype="int8", incremental_history=True,
                  extend_refresh_limit=K)
    fresh = _engine(tb, t32, pool_dtype="int8")
    r = np.random.default_rng(7)
    hist = r.integers(0, 5000, 80).astype(np.int32)
    cand = r.integers(0, 5000, 8).astype(np.int32)
    try:
        eng.serve(hist, cand, user_id=1)
        drift = []
        for _ in range(2 * K + 2):
            hist = np.concatenate([hist, r.integers(0, 5000, 4)
                                   .astype(np.int32)])
            out = eng.serve(hist, cand, user_id=1)
            drift.append(float(np.abs(out - fresh.serve(hist, cand)).max()))
        m = eng.metrics()
        assert m["pool_refresh_reencodes"] == 2, m
        assert m["pool_extensions"] == 2 * K, m
        assert max(drift) < QTOL, drift
    finally:
        eng.shutdown()
        fresh.shutdown()


def test_engine_extend_options_validated(setup):
    _, _, _, tb, t32 = setup
    with pytest.raises(ValueError, match="crossover"):
        _engine(tb, t32, incremental_history=True, extend_buckets=(8, 16))
    with pytest.raises(ValueError, match="n_history"):
        _engine(tb, t32, incremental_history=True, extend_buckets=(128,))
    with pytest.raises(ValueError, match="pack_align"):
        _engine(tb, t32, pack_tails=True, pack_align=4)
    eng = _engine(tb, t32, incremental_history=True, extend_crossover=2.0)
    try:
        assert "extend" not in eng.dso.families     # every rung dropped
    finally:
        eng.shutdown()
    eng = _engine(tb, t32, pack_tails=True, impl="pallas", max_batch=8)
    try:
        pol = eng.dso.policy
        assert (pol.rows, pol.pack_align, pol.batch) == (2, 1, 8)
    finally:
        eng.shutdown()


def test_failed_extend_leader_releases_waiters(setup):
    """Two requests of one user whose history moved: the leader's extend
    dispatch fails; its own request fails, and the waiter re-enters once
    and is served by a full re-encode (``encode_recoveries``)."""
    _, _, _, tb, t32 = setup
    eng = _engine(tb, t32, incremental_history=True, n_workers=2)
    r = np.random.default_rng(9)
    h1 = r.integers(0, 5000, 80).astype(np.int32)
    h2 = np.concatenate([h1, r.integers(0, 5000, 4).astype(np.int32)])
    cand = r.integers(0, 5000, 8).astype(np.int32)
    score = eng.dso.score
    entered = threading.Event()

    def failing(request, m, kind, **kw):
        if kind == "extend":
            entered.set()
            time.sleep(0.3)             # the second request is waiting now
            raise RuntimeError("injected extend failure")
        return score(request, m, kind, **kw)

    try:
        eng.serve(h1, cand, user_id=4)
        eng.dso.score = failing
        f1 = eng.submit(_req(h2, cand, 4))
        assert entered.wait(10)
        f2 = eng.submit(_req(h2, cand, 4))
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(timeout=60)
        out = f2.result(timeout=60).output
        m = eng.metrics()
        assert m["encode_recoveries"] == 1 and m["pool_extensions"] == 0
        assert m["dso_dispatches_encode"] == 2 and out.shape == (8, 3)
        assert not eng._encode_inflight
    finally:
        eng.dso.score = score
        eng.shutdown()


def _req(hist, cand, user):
    from repro_torch.serving import ServeRequest
    return ServeRequest(history=hist, candidates=cand, user_id=user)


# ---------------------------------------------------------------------------
# the engine: packing
# ---------------------------------------------------------------------------

def _ragged(n, seed=5):
    tc = TrafficConfig(candidate_counts=(3, 7, 19, 33),
                       distribution="jittered", n_requests=n, n_history=N,
                       seed=seed, n_users=4)
    reqs = generate_traffic(tc, n_items=5000)
    r = np.random.default_rng(seed + 1)
    for u in range(2):            # M = 1 rides along (the hardest case)
        reqs.append(dict(reqs[u], candidates=r.integers(0, 5000, 1)
                         .astype(np.int32)))
    return reqs


@pytest.mark.parametrize("impl,tol", [("fused", 0.0), ("pallas", 1e-6),
                                      ("reference", 1e-6)],
                         ids=["fused", "pallas", "reference"])
def test_packed_engine_concurrent_equals_sequential(setup, impl, tol):
    """Concurrent packed serving (segments of many requests sharing rows at
    offsets set by who else is in flight) == the same engine serving the
    requests one at a time, on a warm pool.  Bitwise under fused, as in
    the JAX package: K1 reduces over the history and a candidate's own key
    alone.  The framework impls reduce their softmax over the row's S + M
    keys, with the candidate's own key at its offset in the row; torch's
    vectorized CPU sums round by position, so a segment placed elsewhere
    may differ in the last bit (the JAX package claims this bitwise for
    its fused and chunked impls only)."""
    _, _, _, tb, t32 = setup
    eng = _engine(tb, t32, impl=impl, pack_tails=True, pool_dtype="int8",
                  max_batch=4, window_s=0.01, buckets=(32, 16))
    reqs = _ragged(12)
    try:
        for q in reqs[:6]:
            eng.serve(q["history"], q["candidates"], user_id=q["user_id"])
        seq = [eng.serve(q["history"], q["candidates"], user_id=q["user_id"])
               for q in reqs]
        conc = run_workload_async(eng, reqs)["outputs"]
        for a, b in zip(seq, conc):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)
        assert eng.metrics()["dso_packed_segments"] > 0
    finally:
        eng.shutdown()


def test_packed_engine_matches_unpacked_and_reclaims_padding(setup):
    """Packed vs unpacked engines on the same ragged traffic: the same
    scores, and less candidate padding dispatched by the packed engine.
    The packed executors have ``pack_rows`` = 1 row where the unpacked ones
    have ``max_batch`` = 4, so the layers' CPU GEMMs differ in shape and
    may round a product in the last bit (the model-level packed == unpacked
    check above is bitwise)."""
    _, _, _, tb, t32 = setup
    reqs = _ragged(14)
    outs, m = {}, {}
    for pack in (False, True):
        eng = _engine(tb, t32, pack_tails=pack, pool_dtype="int8",
                      max_batch=4, window_s=0.01, buckets=(32, 16))
        try:
            for q in reqs[:6]:
                eng.serve(q["history"], q["candidates"],
                          user_id=q["user_id"])
            outs[pack] = run_workload_async(eng, reqs)["outputs"]
            m[pack] = eng.metrics()
        finally:
            eng.shutdown()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert m[True]["dso_packed_rows"] > 0
    assert m[True]["dso_padded_fraction"] < m[False]["dso_padded_fraction"]


@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_packed_generation_equals_unpacked(setup, impl):
    """Top-k and beam generation through the packed ``decode`` family
    (beams of several requests at different lengths in one row) give the
    unpacked engine's tokens."""
    _, _, _, tb, t32 = setup
    r = np.random.default_rng(12)
    reqs = []
    for i in range(4):
        reqs.append({"history": r.integers(0, 5000, N).astype(np.int32),
                     "candidates": r.integers(0, 5000, int(r.integers(3, 12)))
                     .astype(np.int32), "user_id": i,
                     "generate": TopKConfig(k=2, steps=3) if i % 2
                     else BeamConfig(width=3, steps=3)})
    outs = {}
    for pack in (False, True):
        eng = _engine(tb, t32, impl=impl, pack_tails=pack, generate=4,
                      gen_vocab=16, pool_dtype="int8", max_batch=4,
                      buckets=(8, 4))
        try:
            outs[pack] = run_workload_async(eng, reqs)["outputs"]
            if pack:
                assert eng.metrics()["dso_packed_segments"] > 0
        finally:
            eng.shutdown()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_packed_and_incremental_engine_vs_jax(setup):
    """``FlameEngine(incremental_history=True, pack_tails=True)``: the
    port and the JAX engine on the same traffic — first histories, then
    every history grown past the window (stale hits served by extension) —
    give the same scores (native pool, f32 weights)."""
    from repro.core.pda import RemoteFeatureStore as JStore
    from repro.serving import FlameEngine as JFlameEngine
    _, jbundle, j32, tb, t32 = setup
    kw = dict(n_history=N, buckets=(16, 8), n_streams=2, feature_mode="sync",
              window_s=0.004, max_batch=2, n_workers=2, pool_slots=8,
              impl="fused", incremental_history=True, pack_tails=True)
    r = np.random.default_rng(13)
    hists = [r.integers(0, 5000, 70).astype(np.int32) for _ in range(3)]
    cands = [r.integers(0, 5000, m).astype(np.int32) for m in (5, 11, 19)]
    grown = [np.concatenate([h, r.integers(0, 5000, 3).astype(np.int32)])
             for h in hists]
    jeng = JFlameEngine(jbundle, j32, history_cache=True,
                        store=JStore(latency_s=0.0, feature_dim=12), **kw)
    teng = create_engine("flame", tb, t32, device="cpu",
                         store=RemoteFeatureStore(latency_s=0.0,
                                                  feature_dim=12), **kw)
    try:
        for hs in (hists, grown):
            for u, (h, c) in enumerate(zip(hs, cands)):
                want = jeng.serve(h, c, user_id=u)
                got = teng.serve(h, c, user_id=u)
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert teng.metrics()["pool_extensions"] == 3
        assert jeng.metrics()["pool_extensions"] == 3
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_packed_pallas_decode_vs_jax_pallas_route():
    """The port's packed pallas decode (K4's self-slot form reading each
    candidate's cache row in place; its plain version here) against the JAX
    pallas route, which copies a cache row per candidate and runs its
    flash-decode kernel in interpret mode, from the same operands."""
    r = np.random.default_rng(21)
    b, m, u, s, h, hkv, d = 2, 6, 3, 11, 4, 2, 16
    q = r.standard_normal((b, m, h, d)).astype(np.float32)
    kh, vh = (r.standard_normal((u, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    kc, vc = (r.standard_normal((b, m, hkv, d)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([11, 4, 7], np.int32)
    seg = np.asarray([[2, 2, 0, 1, 1, 1], [0, 0, 1, 2, 2, 0]], np.int32)
    want = jax.jit(lambda *a: JS.decode_candidate_attention(
        *a[:6], impl="pallas", row_index=a[6]))(q, kh, vh, kc, vc, lengths,
                                                seg)
    got = sumi.decode_candidate_attention(
        *(_t(x) for x in (q, kh, vh, kc, vc)), _t(lengths), impl="pallas",
        row_index=_t(seg))
    _close(got, want, KTOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hist", ["int8", "bf16"])
def test_packed_index_kernels_bitwise_on_gpu(cuda, hist):
    """K1 (cached mode) and K4's self-slot form with a packed index at
    alignments 1, 8 and 16: within the card's bf16 gate of the plain
    version, and every slot bitwise the unpacked call of its pool row."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_score import ops as fs
    g = torch.Generator(device=cuda).manual_seed(13)
    b, m, u, s, h, hkv, d = 4, 32, 4, 70, 4, 4, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    q, kc, vc = (rnd(b, m, x, d).to(torch.bfloat16) for x in (h, hkv, hkv))
    kf, vf = rnd(u, s, hkv, d), rnd(u, s, hkv, d)
    kw = {}
    if hist == "int8":
        lk, lv = quantize_kv({"k": kf, "v": vf}, "int8")[0].values()
        kh, vh = lk.q, lv.q
        kw = dict(k_scale=lk.scale, v_scale=lv.scale)
    else:
        kh, vh = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    lens = torch.tensor([s, 1, 33, 0], dtype=torch.int32, device=cuda)
    for align in (1, 8, 16):
        r = np.random.default_rng(align)
        seg = np.zeros((b, m), np.int32)
        for row in range(b):
            off = 0
            while off < m:
                n = int(r.integers(1, 2 * align + 1))
                seg[row, off:off + n] = r.integers(0, u)
                off += n
        seg = torch.from_numpy(seg).to(cuda)
        packed = fs.fused_decode_attention(q, kh, vh, kc, vc, lens,
                                           row_index=seg, **kw)
        want = fs.fused_score_plain(
            q, kh, vh, kc, vc, mode="cached", row_index=seg, lengths=lens,
            k_scale=fs._norm_scale(kw.get("k_scale"), u, hkv),
            v_scale=fs._norm_scale(kw.get("v_scale"), u, hkv))
        torch.testing.assert_close(packed.float(), want.float(),
                                   atol=1e-3, rtol=1.6e-2)
        if hist == "bf16":
            k4 = fd.flash_decode_with_self(q, kh, vh, lens, kc, vc,
                                           row_index=seg)
        for row in range(u):
            idx = torch.full((b,), row, dtype=torch.int32, device=cuda)
            one = fs.fused_decode_attention(q, kh, vh, kc, vc, lens,
                                            row_index=idx, **kw)
            assert torch.equal(packed[seg == row], one[seg == row])
            if hist == "bf16":
                rep = lambda t: t[row:row + 1].repeat(  # noqa: E731
                    (b,) + (1,) * (t.dim() - 1))
                k4_one = fd.flash_decode_with_self(q, rep(kh), rep(vh),
                                                   rep(lens), kc, vc)
                assert torch.equal(k4[seg == row], k4_one[seg == row])
