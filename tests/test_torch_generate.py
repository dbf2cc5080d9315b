"""Generative decode in the port: ``decode_logits`` / ``append_token``,
the decode attention routes, the host-side beam search and the engine's
generation path, held to the JAX package and to the port's own invariants.

Both packages get the same f32 weights (``params_from_jax``) and the same
numpy inputs.  JAX calls are jit-wrapped (docs/ARCHITECTURE.md §7).
Tolerances: 1e-5 on f32 model outputs under ``impl="reference"`` (the
numeric contract of ROADMAP.md), 5e-3 where a kernel route is compared
(JAX's Pallas kernels in interpret mode, or a different kernel on one
side, as ``tests/test_decode_serving.py`` allows its Pallas route).
Inside the port the reference's bitwise invariants stay bitwise: root
decode == score, padded cache == tight cache, hit == miss, coalesced ==
sequential, an evicted beam replays to the same sequences.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import sumi as JS
from repro.core.pda import RemoteFeatureStore as JStore
from repro.kernels.flash_decode import ref as j_fd_ref
from repro.models import build_model
from repro.serving import FlameEngine as JFlameEngine
from repro.serving.api import BeamConfig as JBeamConfig
from repro.serving.api import TopKConfig as JTopKConfig
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.core import sumi
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.serving import (BeamConfig, HistoryKVPool, ServeRequest,
                                 TopKConfig, create_engine)
from repro_torch.serving import generate as G
from repro_torch.serving.kv_cache import quantize_kv_graph
from repro_torch.serving.scheduler import run_workload_async
from repro_torch.tree import leaves
from repro_torch.types import ClimberConfig
from tests._propcheck import given, settings, st

torch.set_num_threads(1)
TOL = 1e-5
KTOL = 5e-3
N_HIST = 16
VOCAB = 64
SMALL = dict(vocab_size=VOCAB, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)


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
    r = np.random.default_rng(0)
    batch = {"history": r.integers(0, VOCAB, (2, N_HIST)).astype(np.int32),
             "side": r.normal(size=(2, 12)).astype(np.float32)}
    return jbundle, j32, C.build_climber(tc), t32, batch


def _s0():
    return N_HIST // 2 + 1


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pad_t(kv, extra, fill=3.75):
    """Pad every [B,L,S,Hkv,D] leaf by ``extra`` slots with a NON-ZERO fill:
    equality through the padded cache proves the length mask."""
    return {b: {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra),
                                           value=fill)
                for n, t in e.items()} for b, e in kv.items()}


def _pad_j(kv, extra, fill=3.75):
    return jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)],
        constant_values=fill), kv)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# model surface vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,tol", [("reference", TOL), ("pallas", KTOL)])
def test_decode_and_append_match_jax(setup, impl, tol):
    """``decode_logits`` and ``append_token`` of the port against JAX on a
    padded cache with per-row lengths (JAX's pallas route runs its
    flash_decode / fused_ffn / flash_attention kernels in interpret
    mode)."""
    jb, j32, tb, t32, batch = setup
    jkv = _pad_j(jax.jit(lambda p, b: jb.encode_history(p, b, impl=impl))(
        j32, batch), 3)
    tkv = _pad_t(tb.encode_history(t32, _tb(batch), impl=impl), 3)
    for a, b in zip(leaves(tkv), jax.tree.leaves(jkv)):
        _close(a, b, tol)
    r = np.random.default_rng(1)
    cand = r.integers(0, VOCAB, (2, 8)).astype(np.int32)
    lens = np.array([_s0() + 2, _s0() - 3], np.int32)
    want = jax.jit(lambda p, kv, c, l: jb.decode_logits(
        p, kv, c, l, impl=impl))(j32, jkv, cand, lens)
    got = tb.decode_logits(t32, tkv, torch.from_numpy(cand),
                           torch.from_numpy(lens), impl=impl)
    _close(got, want, tol)
    tok = r.integers(0, VOCAB, (2, 1)).astype(np.int32)
    want = jax.jit(lambda p, kv, t, l: jb.append_token(
        p, kv, t, l, impl=impl))(j32, jkv, tok, lens)
    got = tb.append_token(t32, tkv, torch.from_numpy(tok),
                          torch.from_numpy(lens), impl=impl)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        _close(a, b, tol)


def test_append_raw_int8_keeps_root_codes_and_scales(setup):
    """On a raw int8 pool view the appended token quantizes against the
    entry's fixed scale: stored rows keep their codes, scales are the
    root's, and the new slot's codes match the JAX in-graph quantize."""
    jb, j32, tb, t32, batch = setup
    tkv = tb.encode_history(t32, _tb(batch))
    raw = quantize_kv_graph(_pad_t(tkv, 2, fill=0.0), "int8")
    lens = torch.tensor([_s0(), _s0() + 1], dtype=torch.int32)
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    out = tb.append_token(t32, raw, tok, lens)
    jraw = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: None if t is None else t.numpy(), raw))
    jout = jax.jit(lambda p, kv, t, l: jb.append_token(p, kv, t, l))(
        j32, jraw, tok.numpy(), lens.numpy())
    for (q0, s0), (q1, s1), (jq, js) in zip(
            [raw[b][n] for b in raw for n in raw[b]],
            [out[b][n] for b in out for n in out[b]],
            [jout[b][n] for b in jout for n in jout[b]]):
        assert q1.dtype == torch.int8 and s1 is s0
        for row, ln in enumerate(lens.tolist()):
            keep = torch.ones(q0.shape[2], dtype=torch.bool)
            keep[ln] = False
            assert torch.equal(q1[row][:, keep], q0[row][:, keep])
        # f32 rounding of K/V at .5 code boundaries may differ by one code
        assert (q1.int() - torch.from_numpy(np.array(jq)).int()
                ).abs().max() <= 1


def test_decode_attention_routes_vs_jax_oracle():
    """The reference and pallas routes of ``decode_candidate_attention``
    against the JAX f32 ground truth ``flash_decode/ref.decode_with_self``
    (and the ported oracle), padded rows included; a 1-D ``row_index``
    equals decoding the gathered rows; a 2-D one (segment-packed decode)
    steers each candidate to its own row and length, as the JAX route's
    [B, M] steer does."""
    rng = np.random.default_rng(3)
    b, m, s, h, hkv, d = 3, 5, 11, 4, 2, 8
    q = rng.standard_normal((b, m, h, d)).astype(np.float32)
    kh, vh = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    kc, vc = (rng.standard_normal((b, m, hkv, d)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([11, 7, 4], np.int32)
    want = np.asarray(jax.jit(j_fd_ref.decode_with_self)(
        q, kh, vh, lengths, kc, vc))
    t = [torch.from_numpy(x) for x in (q, kh, vh, kc, vc)]
    tl = torch.from_numpy(lengths)
    for impl in ("reference", "pallas"):
        got = sumi.decode_candidate_attention(*t, tl, impl=impl)
        _close(got, want, TOL)
    _close(fd_ref.decode_with_self(t[0], t[1], t[2], tl, t[3], t[4]), want,
           TOL)
    jgot = jax.jit(lambda *a: JS.decode_candidate_attention(
        *a, impl="reference"))(q, kh, vh, kc, vc, lengths)
    _close(sumi.decode_candidate_attention(*t, tl), jgot, TOL)
    # 1-D row_index: pool rows [U] with lengths [U], gathered per batch row
    idx = torch.tensor([2, 0, 2], dtype=torch.int32)
    for impl in ("reference", "pallas"):
        got = sumi.decode_candidate_attention(*t, tl, impl=impl,
                                              row_index=idx)
        exp = sumi.decode_candidate_attention(
            t[0], t[1][idx.long()], t[2][idx.long()], t[3], t[4],
            tl[idx.long()], impl=impl)
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
    seg = np.asarray([[2, 2, 0, 1, 1], [0, 0, 0, 0, 0], [1, 2, 2, 2, 0]],
                     np.int32)
    jseg = jax.jit(lambda *a: JS.decode_candidate_attention(
        *a[:6], impl="reference", row_index=a[6]))(q, kh, vh, kc, vc,
                                                   lengths, seg)
    for impl in ("reference", "pallas"):
        _close(sumi.decode_candidate_attention(
            *t, tl, impl=impl, row_index=torch.from_numpy(seg)), jseg, TOL)


@pytest.mark.parametrize("dtype,tol", [(np.float32, TOL),
                                       (jnp.bfloat16, KTOL)],
                         ids=["f32", "bf16"])
def test_pallas_decode_route_vs_jax_pallas_route(dtype, tol):
    """The port's pallas route (K4's self-slot form, no cache copies)
    against the JAX pallas route (per-candidate cache copies through the
    flash-decode kernel in interpret mode): the same function, GQA, a
    zero-length row, M of 1 and more."""
    rng = np.random.default_rng(4)
    for (b, m, s, h, hkv, d, lens) in [(3, 5, 11, 4, 2, 16, [11, 7, 0]),
                                       (2, 1, 9, 2, 2, 32, [9, 1])]:
        arrs = [rng.standard_normal(shape).astype(np.float32) for shape in (
            (b, m, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, m, hkv, d),
            (b, m, hkv, d))]
        lengths = np.asarray(lens, np.int32)
        want = jax.jit(lambda *a: JS.decode_candidate_attention(
            *a, impl="pallas"))(*(jnp.asarray(x, dtype) for x in arrs),
                                lengths)
        t = [torch.from_numpy(x) if dtype == np.float32
             else torch.from_numpy(x).to(torch.bfloat16) for x in arrs]
        got = sumi.decode_candidate_attention(*t, torch.from_numpy(lengths),
                                              impl="pallas")
        assert got.dtype == t[0].dtype
        _close(got, want, tol)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_root_decode_is_score(setup, impl):
    """At ``lengths == S`` with no padding one decode step IS
    ``score_candidates``: bitwise under the reference impl; under pallas
    decode runs K4 and scoring K2, so 5e-3 (the JAX suite's bound)."""
    _, _, tb, t32, batch = setup
    kv = tb.encode_history(t32, _tb(batch), impl=impl)
    cand = torch.from_numpy(np.random.default_rng(7).integers(
        0, VOCAB, (2, 8)).astype(np.int32))
    lens = torch.full((2,), _s0(), dtype=torch.int32)
    want = tb.score_candidates(t32, kv, cand, impl=impl)
    got = tb.decode_logits(t32, kv, cand, lens, impl=impl)
    if impl == "reference":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=KTOL, rtol=KTOL)
    assert torch.equal(got[0].sum(-1).argmax(), want[0].sum(-1).argmax())


def test_padded_cache_decodes_bitwise(setup):
    """Masked positions add exact zeros: a cache padded with a non-zero
    fill decodes bitwise like the tight cache (reference impl)."""
    _, _, tb, t32, batch = setup
    kv = tb.encode_history(t32, _tb(batch))
    cand = torch.from_numpy(np.random.default_rng(8).integers(
        0, VOCAB, (2, 6)).astype(np.int32))
    lens = torch.tensor([_s0(), _s0() - 4], dtype=torch.int32)
    want = tb.decode_logits(t32, kv, cand, lens)
    got = tb.decode_logits(t32, _pad_t(kv, 5), cand, lens)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# beam search bookkeeping
# ---------------------------------------------------------------------------

@given(st.integers(0, 10_000), st.integers(1, 5), st.integers(2, 6),
       st.integers(0, 1))
@settings(max_examples=40, deadline=None)
def test_beam_step_invariants(seed, width, vocab, use_eos):
    rng = np.random.default_rng(seed)
    width = min(width, vocab)
    universe = np.sort(rng.choice(50, size=vocab, replace=False))
    eos = int(universe[0]) if use_eos else None
    lp0 = G.log_softmax(rng.standard_normal(vocab))
    order = np.argsort(-lp0, kind="stable")[:width]
    cum = lp0[order]
    seqs = [(int(universe[o]),) for o in order]
    fin = np.asarray([eos is not None and t[0] == eos for t in seqs])
    for _ in range(3):
        step_lp = G.log_softmax(rng.standard_normal((len(cum), vocab)),
                                axis=-1)
        new_cum, new_seqs, new_fin, parents = G.beam_step(
            cum, seqs, fin, step_lp, width, eos, universe)
        assert new_cum.max() <= cum.max() + 1e-9          # log-probs <= 0
        assert (np.diff(new_cum) <= 1e-12).all(), "result not best-first"
        live = [new_seqs[i] for i in range(len(new_seqs)) if not new_fin[i]]
        assert len(live) == len(set(live))                # no duplicates
        for slot in range(len(new_cum)):
            p = int(parents[slot])
            if fin[p]:          # finished: passes through frozen
                assert new_seqs[slot] == seqs[p]
                assert new_cum[slot] == cum[p] and new_fin[slot]
            else:
                assert new_seqs[slot][:-1] == seqs[p]
                assert new_seqs[slot][-1] in universe
        cum, seqs, fin = new_cum, new_seqs, new_fin


# ---------------------------------------------------------------------------
# the engine's generation path
# ---------------------------------------------------------------------------

BASE = dict(n_history=N_HIST, buckets=(8, 4), n_streams=2,
            feature_mode="off", window_s=0.01, max_batch=4, n_workers=4,
            pool_slots=32, generate=6, gen_vocab=16)


def _engine(bundle, params, **kw):
    base = dict(BASE, store=RemoteFeatureStore(latency_s=0.0,
                                               feature_dim=12),
                impl="reference", device="cpu")
    base.update(kw)
    return create_engine("flame", bundle, params, **base)


@pytest.fixture(scope="module")
def engines(setup):
    _, _, tb, t32, _ = setup
    engs = {impl: _engine(tb, t32, impl=impl)
            for impl in ("reference", "pallas", "fused")}
    engs["fused8"] = _engine(tb, t32, impl="fused", pool_dtype="int8")
    yield engs
    for e in engs.values():
        e.shutdown()


def _requests(n, seed=0, steps=4):
    """Ragged generative traffic: universes of 3..11 ids, top-k and beam."""
    rng = np.random.default_rng(seed)
    return [{"history": rng.integers(0, VOCAB, N_HIST).astype(np.int32),
             "candidates": rng.integers(0, VOCAB, int(rng.integers(3, 12)))
             .astype(np.int32),
             "user_id": i,
             "gen": ("topk", 2, steps) if i % 2 else ("beam", 3, steps)}
            for i in range(n)]


def _cfg(gen, mod):
    kind, width, steps = gen
    return (mod[0](k=width, steps=steps) if kind == "topk"
            else mod[1](width=width, steps=steps))


def test_engine_sequences_match_jax_engine(setup, engines):
    """Native f32 pool: the port's engine under every impl emits the JAX
    engine's (``impl="chunked"``) sequences token for token on this seeded
    traffic (checked free of near-tie steps: the JAX suite's 6-request
    traffic has no ranking gap under 1e-4)."""
    jb, j32, _, _, _ = setup
    reqs = _requests(6, seed=2)
    jeng = JFlameEngine(jb, j32, impl="chunked", history_cache=True,
                        store=JStore(latency_s=0.0, feature_dim=12), **BASE)
    try:
        want = [jeng.serve(r["history"], candidates=r["candidates"],
                           user_id=r["user_id"],
                           generate=_cfg(r["gen"], (JTopKConfig,
                                                    JBeamConfig)))
                for r in reqs]
    finally:
        jeng.shutdown()
    for impl in ("reference", "pallas", "fused"):
        eng = engines[impl]
        for r, exp in zip(reqs, want):
            got = eng.serve(r["history"], candidates=r["candidates"],
                            user_id=1000 + r["user_id"],
                            generate=_cfg(r["gen"], (TopKConfig,
                                                     BeamConfig)))
            np.testing.assert_array_equal(got, np.asarray(exp),
                                          err_msg=impl)


def test_engine_beam_equals_exhaustive(setup, engines):
    """width >= V^(steps-1) keeps every prefix alive, so beam search returns
    exactly the global top-width of all V^steps sequences by cumulative
    log-probability, enumerated here through the model surface."""
    _, _, tb, t32, _ = setup
    eng = engines["reference"]
    universe = np.asarray([5, 11, 23, 42], np.int32)
    steps, width = 3, 16
    hist = np.random.default_rng(17).integers(0, VOCAB, N_HIST).astype(
        np.int32)
    out = eng.serve(hist, candidates=universe, user_id=777,
                    generate=BeamConfig(width=width, steps=steps))
    assert out.shape == (width, steps)
    side = torch.from_numpy(eng._side_features(hist))
    root = _pad_t(tb.encode_history(
        t32, {"history": torch.from_numpy(hist[None]), "side": side}),
        steps, fill=0.0)
    uni = torch.from_numpy(universe[None])
    level, table = {(): (0.0, root)}, {}
    for g in range(steps):
        nxt = {}
        lens = torch.tensor([_s0() + g], dtype=torch.int32)
        for prefix, (score, kv) in level.items():
            lp = G.log_softmax(tb.decode_logits(t32, kv, uni, lens)[0]
                               .numpy().sum(-1))
            for j, tok in enumerate(universe):
                seq = prefix + (int(tok),)
                if g < steps - 1:
                    nxt[seq] = (score + lp[j], tb.append_token(
                        t32, kv, torch.tensor([[int(tok)]],
                                              dtype=torch.int32), lens))
                else:
                    table[seq] = score + lp[j]
        level = nxt
    ranked = sorted(table.items(), key=lambda kv: -kv[1])
    want = np.asarray([list(seq) for seq, _ in ranked[:width]], np.int32)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("name", ["pallas", "fused8"])
def test_hit_equals_miss_and_concurrent_equals_sequential(engines, name):
    """Bitwise: a user's generation on a pool hit equals its generation on
    the miss (one stored representation, int8 included), and concurrent
    coalesced serving equals one request at a time."""
    eng = engines[name]
    reqs = _requests(6, seed=4)
    for r in reqs:
        r["user_id"] += 2000
        r["generate"] = _cfg(r.pop("gen"), (TopKConfig, BeamConfig))
    seq = [eng.serve(r["history"], candidates=r["candidates"],
                     user_id=r["user_id"], generate=r["generate"])
           for r in reqs]
    misses = eng.metrics()["pool_misses"]
    conc = run_workload_async(eng, reqs)["outputs"]
    assert eng.metrics()["pool_misses"] == misses        # all hits now
    for a, b in zip(seq, conc):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pool", ["native", "int8"])
def test_evicted_beam_replays_to_same_sequences(setup, pool):
    """With one pool slot every parked beam is evicted before its next
    round: it re-encodes its root and replays its appends — the same
    tokens (bitwise, an int8 pool included), counted by ``gen_replays``."""
    _, _, tb, t32, _ = setup
    rng = np.random.default_rng(23)
    hist = rng.integers(0, VOCAB, N_HIST).astype(np.int32)
    universe = rng.integers(0, VOCAB, 9).astype(np.int32)
    gen = BeamConfig(width=3, steps=5)
    outs, replays = [], []
    for slots in (32, 1):
        eng = _engine(tb, t32, pool_dtype=pool, pool_slots=slots)
        try:
            outs.append(eng.serve(hist, candidates=universe, user_id=901,
                                  generate=gen))
            replays.append(eng.metrics().get("gen_replays", 0))
        finally:
            eng.shutdown()
    np.testing.assert_array_equal(outs[1], outs[0])
    assert replays[0] == 0 and replays[1] > 0


def test_eos_early_exit_from_own_run(engines):
    """EOS taken from the port's own EOS-free run: the greedy path is
    unchanged up to the EOS, the row is -1-padded after it, and the skipped
    rounds count in ``gen_early_exits``."""
    eng = engines["reference"]
    rng = np.random.default_rng(11)
    hist = rng.integers(0, VOCAB, N_HIST).astype(np.int32)
    uni = rng.integers(0, VOCAB, 9).astype(np.int32)
    free = eng.serve(hist, candidates=uni, user_id=500,
                     generate=TopKConfig(k=1, steps=6))
    assert (free[0] >= 0).all()
    # a token whose FIRST occurrence is mid-sequence and not at the end
    p = next((i for i in range(1, 5)
              if int(free[0][i]) not in [int(x) for x in free[0][:i]]),
             None)
    if p is None:
        pytest.fail(f"the EOS-free run {free[0]} has no fresh mid-sequence "
                    f"token to use as EOS; change the seed")
    eos = int(free[0][p])
    before = eng.metrics().get("gen_early_exits", 0)
    out = eng.serve(hist, candidates=uni, user_id=500,
                    generate=TopKConfig(k=1, steps=6, eos=eos))
    np.testing.assert_array_equal(out[0][:p + 1], free[0][:p + 1])
    assert (out[0][p + 1:] == -1).all(), out
    assert eng.metrics()["gen_early_exits"] == before + 1
    bout = eng.serve(hist, candidates=uni, user_id=501,
                     generate=BeamConfig(width=2, steps=4, eos=eos))
    assert bout.shape == (2, 4) and (bout[:, 0] >= 0).all()


def test_generate_request_validation(setup, engines):
    _, _, tb, t32, _ = setup
    eng = engines["reference"]
    hist = np.arange(N_HIST, dtype=np.int32)
    with pytest.raises(ValueError, match="capacity"):
        eng.serve(hist, generate=TopKConfig(k=2, steps=99))
    with pytest.raises(ValueError, match="top-k"):
        eng.serve(hist, candidates=np.asarray([1, 2, 3], np.int32),
                  generate=TopKConfig(k=8, steps=2))
    with pytest.raises(ValueError, match="TopKConfig"):
        eng.serve(hist, generate=42)
    with pytest.raises(ValueError, match="1-D"):
        eng.serve(hist, candidates=np.zeros((2, 2), np.int32),
                  generate=TopKConfig(k=1, steps=2))
    with pytest.raises(ValueError, match=">= 0"):
        eng.serve(hist, candidates=np.asarray([1, -1], np.int32),
                  generate=TopKConfig(k=1, steps=2))
    # a universe-less request draws from range(gen_vocab)
    out = eng.serve(hist, user_id=3000, generate=BeamConfig(width=5,
                                                            steps=2))
    assert out.shape == (5, 2) and out.min() >= 0 and out.max() < 16
    plain = _engine(tb, t32, generate=0)
    try:
        with pytest.raises(ValueError, match="generative capacity"):
            plain.serve(hist, generate=TopKConfig(k=1, steps=1))
        assert ("decode", 8) not in plain.dso.executors
    finally:
        plain.shutdown()


def test_generate_metrics_surface(engines):
    eng = engines["reference"]
    eng.serve(np.arange(N_HIST, dtype=np.int32), user_id=4000,
              generate=TopKConfig(k=2, steps=3))
    m = eng.metrics()
    assert m["decode_steps"] > 0 and m["gen_tokens"] > 0
    assert m["gen_tokens_per_s"] > 0 and m["beams_in_flight"] == 0
    assert m["dso_dispatches_decode"] > 0 and m["dso_dispatches_append"] > 0
    assert m["dso_dispatch_ms_decode"] > 0


def test_pool_parks_and_returns_padded_beam_caches(setup):
    """Beam parking: a padded int8 beam cache (values grown by the
    generation budget, scales at the root's shape) goes into the pool
    prequantized and comes back raw as the very same tensors, dequantized
    with the pool's formula, and counts its padded bytes."""
    _, _, tb, t32, batch = setup
    kv = tb.encode_history(t32, {k: v[:1] for k, v in _tb(batch).items()})
    raw = quantize_kv_graph(_pad_t(kv, 6, fill=0.0), "int8")
    pool = HistoryKVPool(2, dtype="int8", device="cpu")
    assert pool.put(("g", 1, 0), ("fp", 7), raw, prequantized=True)
    got, status, _ = pool.lookup(("g", 1, 0), ("fp", 7), raw=True)
    assert status == "hit"
    for a, b in zip(leaves(got), leaves(raw)):
        assert a is b
    q, s = raw["b0"]["k"]
    assert q.shape[2] == _s0() + 6 and s.shape[2] == 1
    deq = pool.lookup(("g", 1, 0), ("fp", 7))[0]["b0"]["k"]
    assert torch.equal(deq, q.float() * (s / 127.0))
    assert pool.bytes_used == sum(t.numel() * t.element_size()
                                  for t in leaves(raw))
    assert pool.lookup(("g", 1, 0), ("fp", 8))[1] == "stale"


def test_serve_request_generate_field():
    req = ServeRequest(history=np.arange(4), generate=TopKConfig(k=2))
    assert req.m == 0 and req.generate.k == 2 and req.generate.steps == 8
    assert BeamConfig().width == 4 and BeamConfig(eos=3).eos == 3
