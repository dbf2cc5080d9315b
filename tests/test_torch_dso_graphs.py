"""The DSO's compiled executors (``repro_torch.core.dso.Executor``): on the
card each is a CUDA graph captured once at construction over static
buffers, on the CPU an eager call on the same static buffers whose outputs
are copied into static output buffers, as a replay writes them.  So the
CPU tests here exercise the staging and output handling a replay gets:

* a dispatch's outputs are never views of the static outputs, which the
  next call overwrites (on one executor, and through encode -> pool ->
  cached);
* rows written into the static buffers score as they do alone, whatever
  earlier calls left in the other rows (coalesced == sequential, bitwise);
* each family's executor equals its eager ``fn`` bitwise;
* an executor adds its per-call kernel launches on every call;
* PDA's packed transfer equals the JAX package's, offset for offset;
* the reference decode route's capture-safe form (no host sync; the mask
  covers the full padded S) matches the JAX reference route at 1e-5.

The ``cuda``-marked cases (skipped without a GPU) hold the captured
executors of every family and bucket under fused, pallas and reference to
their eager ``fn`` bitwise, check that a capture that cannot be taken
raises at construction, that replays count launches, and that the text
engine's captured decode step gives the eager loop's greedy tokens.
"""
import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import pda as JPDA
from repro.core import sumi as JS
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import climber as C
from repro_torch.core import dso as DSO
from repro_torch.core import pda as PDA
from repro_torch.core import sumi
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.kernels import _build
from repro_torch.kernels.fused_score import ops as fs
from repro_torch.models.model import build_model
from repro_torch.serving import ServeRequest, create_engine
from repro_torch.tree import leaves
from repro_torch.types import ClimberConfig, TensorSpec

torch.set_num_threads(1)
TOL = 1e-5
N_HIST = 16
VOCAB = 64
SMALL = dict(vocab_size=VOCAB, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)
ENGINE = dict(n_history=N_HIST, buckets=(8, 4), n_streams=2,
              feature_mode="off", window_s=0.01, max_batch=4, n_workers=2,
              pool_slots=32, generate=4, gen_vocab=16)


def _bundle(device):
    cfg = dataclasses.replace(
        get_config("climber"), **SMALL,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    params = C.climber_init(cfg, torch.Generator(device=device)
                            .manual_seed(0), device)
    if device == "cpu":
        params = C.params_to(params, "cpu")
    return C.build_climber(cfg), params


def _engine(bundle, params, device, **kw):
    base = dict(ENGINE, store=RemoteFeatureStore(latency_s=0.0,
                                                 feature_dim=12),
                impl="fused", device=device)
    base.update(kw)
    return create_engine("flame", bundle, params, **base)


@pytest.fixture(scope="module")
def small():
    return _bundle("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have "
                    "no CPU mode)")
    return "cuda"


def _family_inputs(eng, kind: str, bucket: int, seed: int):
    """Valid full-batch arguments of an executor of ``eng``: pool rows from
    an encode call, lengths within the padded caches, ids in the vocab."""
    rng = np.random.default_rng(seed)
    B = eng.dso.policy.batch
    hist = rng.integers(0, VOCAB, (B, N_HIST)).astype(np.int32)
    side = rng.normal(size=(B, 12)).astype(np.float32)
    if kind == "encode":
        return [hist, side]
    enc = eng.dso.executors[("encode", N_HIST)][0]
    raw = leaves(enc(hist, side))
    if kind == "extend":
        return raw + [hist, side]
    idx = rng.permutation(B).astype(np.int32)
    cands = rng.integers(0, VOCAB, (B, bucket)).astype(np.int32)
    steer = [idx, cands]
    if eng._pack_tails:      # [rows, bucket] seg-index and candidate planes
        rows = eng.dso.policy.rows
        steer = [rng.integers(0, B, (rows, bucket)).astype(np.int32),
                 rng.integers(0, VOCAB, (rows, bucket)).astype(np.int32)]
    if kind == "cached":
        # without KV-row dedup (kv_dedup=False, the default for the
        # framework impls on the CPU) the family takes no row index
        return raw + (steer if eng._kv_dedup or eng._pack_tails
                      else [cands])
    rows = list(eng._pad_beam_leaves(raw))
    lengths = rng.integers(1, eng._s0 + eng._generate, B).astype(np.int32)
    if kind == "decode":
        return rows + [lengths] + steer
    return rows + [lengths, cands[:, :1].copy()]


def _eager(ex, args):
    ts = [torch.from_numpy(a).to(ex.device) if isinstance(a, np.ndarray)
          else a for a in args]
    with torch.inference_mode():
        out = ex.fn(*ts)
    return [t.cpu() for t in leaves(out)]


def _leaves_cpu(out):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a.cpu()
            for a in leaves(out)]


def _every_executor(eng):
    return [(kind, b, ex) for (kind, b), exs in eng.dso.executors.items()
            for ex in exs]


def _replay_equals_eager(eng):
    """Every (kind, bucket, dispatcher) executor of ``eng``: its call
    (replay on the card) equals its eager ``fn`` on the same inputs
    bitwise, and its first outputs survive a second call on other
    inputs."""
    for kind, b, ex in _every_executor(eng):
        a1 = _family_inputs(eng, kind, b, seed=1)
        a2 = _family_inputs(eng, kind, b, seed=2)
        got = ex(*a1)
        kept = [t.clone() for t in _leaves_cpu(got)]
        for g, w in zip(_leaves_cpu(got), _eager(ex, a1)):
            assert torch.equal(g, w), (kind, b)
        again = ex(*a2)
        for g, k in zip(_leaves_cpu(got), kept):
            assert torch.equal(g, k), (kind, b, "overwritten")
        for g, w in zip(_leaves_cpu(again), _eager(ex, a2)):
            assert torch.equal(g, w), (kind, b)


# ---------------------------------------------------------------------------
# staging and output handling (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_output", [True, False], ids=["host", "device"])
def test_outputs_survive_the_next_call(host_output):
    """On one executor, the first call's outputs — whole, and split into
    rows — are unchanged after a second call on other inputs."""
    spec = TensorSpec((3, 5), torch.float32)
    ex = DSO.Executor(lambda x: {"y": x * 2, "z": (x + 1, x.sum(1))},
                      [spec], "cpu", host_output=host_output)
    x1 = np.arange(15, dtype=np.float32).reshape(3, 5)
    whole = ex(x1)
    rows = ex(x1, rows=2)
    ex(-x1)
    got = _leaves_cpu(whole)
    want = [torch.from_numpy(a) for a in (x1 * 2, x1 + 1, x1.sum(1))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(rows) == 2
    for r, row in enumerate(rows):
        for g, w in zip(_leaves_cpu(row), want):
            assert torch.equal(g, w[r:r + 1])
    assert ex.calls == 3


def test_encode_pool_cached_rows_survive_later_encodes(small):
    """encode -> pool -> cached on one encode executor (one dispatcher): a
    user's pooled rows are bitwise what its encode returned after other
    users' encodes ran on the same executor, and its hit equals its
    miss."""
    tb, params = small
    eng = _engine(tb, params, "cpu", n_streams=1, generate=0)
    try:
        rng = np.random.default_rng(0)
        hists = [rng.integers(0, VOCAB, N_HIST + 3).astype(np.int32)
                 for _ in range(3)]
        cands = rng.integers(0, VOCAB, 8).astype(np.int32)
        first = eng.submit(ServeRequest(history=hists[0], candidates=cands,
                                        user_id=0)).result(timeout=60)
        key, fp = ("u", 0), eng._fingerprint(hists[0])
        pooled = [t.clone() for t in
                  leaves(eng.history_pool.peek(key, fp, raw=True))]
        for u in (1, 2):
            eng.submit(ServeRequest(history=hists[u], candidates=cands,
                                    user_id=u)).result(timeout=60)
        assert len(eng.dso.executors[("encode", N_HIST)]) == 1
        after = leaves(eng.history_pool.peek(key, fp, raw=True))
        for a, p in zip(after, pooled):
            assert torch.equal(a, p)
        hit = eng.submit(ServeRequest(history=hists[0], candidates=cands,
                                      user_id=0)).result(timeout=60)
        assert hit.timings["pool_hit"] == 1.0
        np.testing.assert_array_equal(hit.output, first.output)
    finally:
        eng.shutdown()


def test_rows_score_as_alone_over_stale_rows(small):
    """Rows written into the static buffers score bitwise as they do alone,
    whatever an earlier call left in the rows past them (the dispatcher's
    padding): coalesced == sequential at the executor."""
    tb, params = small
    eng = _engine(tb, params, "cpu", n_streams=1)
    try:
        for kind in ("cached", "decode"):
            ex = eng.dso.executors[(kind, 8)][0]
            args = _family_inputs(eng, kind, 8, seed=3)
            lead = len(eng._cached_row_specs) + (kind == "decode")
            # unique lead rows [0, 1, 2] and an identity row index
            idx = np.zeros(4, np.int32)
            idx[:3] = np.arange(3)

            def blocks(sel):
                return [[a[i:i + 1] for i in sel] for a in args[:lead]] + \
                    [idx] + [[a[i:i + 1] for i in sel]
                             for a in args[lead + 1:]]
            together = ex(*blocks([0, 1, 2]), rows=3)
            for i in (2, 1, 0):
                alone = ex(*[[a[i:i + 1]] for a in args[:lead]]
                           + [np.zeros(4, np.int32)]
                           + [[a[i:i + 1]] for a in args[lead + 1:]],
                           rows=1)[0]
                np.testing.assert_array_equal(alone, together[i])
    finally:
        eng.shutdown()


@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_each_family_equals_its_eager_fn(small, impl):
    """Every family and bucket (encode, cached, decode, append) of a CPU
    engine: the executor's call equals its eager ``fn`` bitwise."""
    tb, params = small
    eng = _engine(tb, params, "cpu", impl=impl)
    try:
        _replay_equals_eager(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_extend_and_packed_families_equal_their_eager_fn(small, impl):
    """The ``extend`` family (one executor per trusted-prefix bucket, raw
    basis in, the pool's stored representation out) and the packed
    ``cached`` / ``decode`` families (seg-index planes): each executor's
    call equals its eager ``fn`` bitwise, and its outputs survive the next
    call."""
    tb, params = small
    eng = _engine(tb, params, "cpu", impl=impl, incremental_history=True,
                  pack_tails=True, pool_dtype="int8")
    try:
        assert eng.dso.families["extend"] == [16, 12, 8]
        assert eng.dso.executors[("cached", 8)][0].specs[-1].shape == (1, 8)
        assert not eng.dso.executors[("extend", 16)][0].host_output
        _replay_equals_eager(eng)
    finally:
        eng.shutdown()


def test_executor_rejects_bad_arguments():
    spec = TensorSpec((2, 3), torch.int32)
    ex = DSO.Executor(lambda x: x + 1, [spec], "cpu")
    with pytest.raises(ValueError, match="arg 0"):
        ex(np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="arg 0"):
        ex(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="3 rows for a batch of 2"):
        ex([np.zeros((1, 3), np.int32)] * 3)
    with pytest.raises(ValueError, match="takes 1 args"):
        ex()


def test_calls_add_their_launches():
    """N calls of an executor add N x its per-call launches to the
    kernels' counters, no more (on the CPU the function's wrappers count;
    on the card the replays add what the capture counted: the ``cuda``
    case below)."""
    per_call = 3

    def fn(x):
        with _build.COUNT_LOCK:
            fs.fused_score.launches += per_call
        return x * 2

    ex = DSO.Executor(fn, [TensorSpec((2, 2), torch.float32)], "cpu")
    before = _build.launch_counts()["fused_score"]
    n = 5
    for _ in range(n):
        ex(np.ones((2, 2), np.float32))
    assert _build.launch_counts()["fused_score"] - before == n * per_call


def test_launch_counters_under_threads():
    """Dispatcher threads add their replays' launches at once, the first of
    them while the counters' registry is still being filled: no update is
    lost and no reader sees a half-filled registry."""
    n_threads, n_adds = 16, 200
    errors = []
    start = threading.Barrier(n_threads)

    def work():
        try:
            start.wait(timeout=10)
            for _ in range(n_adds):
                _build.add_launches({"fused_score": 1})
                assert "rwkv6_scan" in _build.launch_counts()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = fs.fused_score.launches
        _build._counted.clear()
        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert fs.fused_score.launches - before == n_threads * n_adds


def test_coalesced_dispatch_equals_sequential_engine(small):
    """One 24-candidate request (three 8-chunks of one pool entry riding
    one dispatch over the static buffers) scores bitwise as its three
    8-candidate slices served one at a time."""
    tb, params = small
    rng = np.random.default_rng(4)
    hist = rng.integers(0, VOCAB, N_HIST).astype(np.int32)
    cands = rng.integers(0, VOCAB, 24).astype(np.int32)
    eng = _engine(tb, params, "cpu", generate=0, window_s=0.05)
    try:
        together = eng.serve(hist, cands, user_id=0)
        assert eng.metrics()["dso_avg_fill"] > 1.0
        alone = [eng.serve(hist, cands[i:i + 8], user_id=0)
                 for i in (16, 0, 8)]
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(together, np.concatenate(
        [alone[1], alone[2], alone[0]]))


# ---------------------------------------------------------------------------
# PDA packed transfer vs the JAX package
# ---------------------------------------------------------------------------

def test_packed_transfer_matches_jax():
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 8), (3,), (2, 5, 2), (1, 1), (7,))]
    buf, layout = PDA.pack_features(arrays)
    jbuf, jlayout = JPDA.pack_features(arrays)
    assert layout == jlayout
    assert buf.dtype == jbuf.dtype and np.array_equal(buf, jbuf)
    packed = PDA.packed_transfer(arrays, device="cpu")
    jpacked = JPDA.packed_transfer(arrays)
    unpacked = PDA.unpacked_transfer(arrays, device="cpu")
    jun = JPDA.unpacked_transfer(arrays)
    for a, p, jp, u, ju in zip(arrays, packed, jpacked, unpacked, jun):
        assert tuple(p.shape) == a.shape == tuple(u.shape)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(p.numpy(), a)
    # unpack_on_device gives views of the one buffer, one per array
    dev = torch.from_numpy(buf)
    views = PDA.unpack_on_device(dev, layout)
    assert all(v.untyped_storage().data_ptr()
               == dev.untyped_storage().data_ptr() for v in views)


# ---------------------------------------------------------------------------
# the capture-safe reference decode route
# ---------------------------------------------------------------------------

def test_capture_safe_reference_decode_matches_jax():
    """The form the executors run on the card (mask over the full padded
    S, no host read of the lengths) against the JAX reference route under
    ``jit`` (1e-5), padded rows and a zero-length row included; and
    against the CPU form that trims to the longest length (1e-5: the
    softmax sums over more exact zeros, in another order)."""
    rng = np.random.default_rng(9)
    b, m, s, h, hkv, d = 3, 5, 13, 4, 2, 8
    q = rng.standard_normal((b, m, h, d)).astype(np.float32)
    kh, vh = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
              for _ in range(2))
    kc, vc = (rng.standard_normal((b, m, hkv, d)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([9, 4, 0], np.int32)
    want = jax.jit(lambda *a: JS.decode_candidate_attention(
        *a, impl="reference"))(q, kh, vh, kc, vc, lengths)
    t = [torch.from_numpy(x) for x in (q, kh, vh, kc, vc)]
    tl = torch.from_numpy(lengths)
    full = sumi._reference_decode(*t, tl, trim=False)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    trimmed = sumi._reference_decode(*t, tl, trim=True)
    np.testing.assert_allclose(full.numpy(), trimmed.numpy(), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_captured_executors_equal_eager_on_gpu(cuda, impl):
    tb, params = _bundle(cuda)
    eng = _engine(tb, params, cuda, impl=impl)
    try:
        assert all(ex.graph is not None for _, _, ex in _every_executor(eng))
        assert eng.metrics()["dso_graph_capture_s"] > 0
        _replay_equals_eager(eng)
    finally:
        eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "pallas", "reference"])
def test_captured_extend_and_packed_families_on_gpu(cuda, impl):
    tb, params = _bundle(cuda)
    eng = _engine(tb, params, cuda, impl=impl, incremental_history=True,
                  pack_tails=True, pool_dtype="int8")
    try:
        assert all(ex.graph is not None for _, _, ex in _every_executor(eng))
        _replay_equals_eager(eng)
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_failed_capture_raises_at_construction(cuda):
    def fn(x):
        return x * float(x.sum().item())
    with pytest.raises(RuntimeError, match="capture"):
        DSO.Executor(fn, [TensorSpec((2, 2), torch.float32)], cuda)


@pytest.mark.cuda
def test_replays_add_their_launches_on_gpu(cuda):
    tb, params = _bundle(cuda)
    eng = _engine(tb, params, cuda, impl="fused")
    try:
        ex = eng.dso.executors[("cached", 8)][0]
        assert ex.launches == {"fused_score": 4}    # 2 blocks x 2 layers
        args = _family_inputs(eng, "cached", 8, seed=1)
        before = _build.launch_counts()["fused_score"]
        for _ in range(3):
            ex(*args)
        assert _build.launch_counts()["fused_score"] - before == 12
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_text_decode_graph_greedy_equals_eager_on_gpu(cuda):
    cfg = reduced_config("rwkv6-7b")
    tb = build_model(cfg)
    params = tb.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    eng = create_engine("text", tb, params, batch=2, max_len=64,
                        device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(2)]
    try:
        assert sorted(eng._graphs) == [1, 2]
        got = eng.generate(prompts, n_tokens=6)
        one = eng.submit(ServeRequest(history=prompts[0], n_tokens=6)) \
            .result(timeout=120).output
    finally:
        eng.shutdown()
    with torch.inference_mode():
        tok = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                              device=cuda)
        caches = tb.cache_init(2, 64, device=cuda)
        logits, caches = tb.prefill(params, {"tokens": tok}, caches=caches)
        last = torch.argmax(logits[:, -1], dim=-1)
        want = [last]
        for i in range(5):
            logits, caches = tb.decode_step(params, caches, {
                "tokens": last[:, None], "cur_index": 40 + i})
            last = torch.argmax(logits[:, -1], dim=-1)
            want.append(last)
    want = torch.stack(want, 1).cpu().numpy()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert one.shape == (6,)
