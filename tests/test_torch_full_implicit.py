"""The JAX engines' defaults and FLAME's three baselines in the port, held
to the JAX package on the CPU at reduced Climber (``configs.reduce``, f32
weights carried from JAX):

* ``chunked_attention`` against JAX's (four masks, ``q_offset``, ragged
  chunks; f32 within 1e-5), ``attention(impl="chunked")`` with a
  temperature against the port's reference (the JAX chunked route drops
  it), and ``impl="chunked"`` on every SUMI route against JAX's;
* ``FlameEngine(history_cache=False)`` — the pool-off ``full`` family —
  under every impl against JAX's ``FlameEngine(history_cache=False,
  impl="reference")``, against the pool within 1e-5, across bucket splits,
  and concurrent == sequential bitwise;
* the ``"implicit"`` engine and ``core/dso.py::ImplicitShapeEngine``
  against JAX's, compiles counted per novel M;
* the refusals: ``pack_tails`` or ``generate`` without the pool, and no
  GPU on ``device="cuda"``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import dso as JDSO
from repro.core import sumi as JS
from repro.core.pda import RemoteFeatureStore as JStore
from repro.models import attention as JA
from repro.models import build_model
from repro.serving import create_engine as j_create_engine
from repro.serving.scheduler import TrafficConfig as JTrafficConfig
from repro.serving.scheduler import generate_traffic as j_generate_traffic
from repro.serving.scheduler import run_workload_async as j_run_workload
from repro_torch.configs import reduced_config
from repro_torch.core import climber as C
from repro_torch.core import dso as DSO
from repro_torch.core import sumi
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.models import attention as A
from repro_torch.serving import (ServeRequest, available_engines,
                                 create_engine)
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)

torch.set_num_threads(1)
TOL = 1e-5
# engine scores against the JAX engine: tests/test_torch_engine.py's TOL
ETOL = 1e-4
N = 64
IMPLS = ("reference", "chunked", "fused", "pallas")
ENGINE = dict(n_history=N, buckets=(16, 8), n_streams=2, feature_mode="sync",
              window_s=0.004, max_batch=2, n_workers=2)


@pytest.fixture(scope="module")
def setup():
    jbundle = build_model(j_reduced_config("climber"))
    jparams, _ = jbundle.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = C.params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    return jbundle, j32, C.build_climber(reduced_config("climber")), t32


def _traffic(n=8, seed=0, counts=(8, 16, 24)):
    return generate_traffic(TrafficConfig(
        candidate_counts=counts, distribution="jittered", n_requests=n,
        n_history=N, seed=seed), n_items=1000)


def _store():
    return RemoteFeatureStore(latency_s=0.0, feature_dim=C.N_SIDE_FEATURES)


def _engine(bundle, params, name="flame", **kw):
    base = dict(ENGINE, store=_store(), history_cache=False, device="cpu")
    if name == "implicit":
        base = dict(n_history=N, store=_store(), n_workers=2, device="cpu")
    base.update(kw)
    return create_engine(name, bundle, params, **base)


def _serve(eng, reqs, concurrent=True):
    try:
        if concurrent:
            return run_workload_async(eng, reqs)["outputs"]
        return [eng.submit(ServeRequest(history=r["history"],
                                        candidates=r["candidates"]))
                .result(timeout=120).output for r in reqs]
    finally:
        eng.shutdown()


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,sq,sk,kw", [
    ("full", 40, 40, {}),
    ("causal", 40, 40, {}),
    ("sliding", 40, 40, dict(window=12)),
    ("sumi", 40, 40, dict(n_history=25)),
    ("sumi", 20, 70, dict(n_history=50, q_offset=50)),
    ("causal", 20, 50, dict(q_offset=30)),
])
def test_chunked_attention_matches_jax(mode, sq, sk, kw):
    """Several q and KV chunks with a ragged last one (16 / 32 over 40, 50,
    70 positions), GQA 4 over 2 heads."""
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, sq, 4, 16), _rand(rng, 2, sk, 2, 16), \
        _rand(rng, 2, sk, 2, 16)
    got = A.chunked_attention(*map(torch.from_numpy, (q, k, v)), mode,
                              q_chunk=16, k_chunk=32, **kw)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), mode,
                                q_chunk=16, k_chunk=32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("s", [40, 300])
def test_chunked_route_applies_temperature(s):
    """``attention(impl="chunked", temperature=1.5)`` equals the port's
    reference with the temperature on both of its routes (40 x 40 scores:
    the reference route; 300 x 300, past 256 x 256: chunked_attention).
    The JAX chunked route drops the temperature past 256 x 256, so there
    the JAX package's two routes differ."""
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 1, s, 4, 16), _rand(rng, 1, s, 2, 16), \
        _rand(rng, 1, s, 2, 16)
    kw = dict(n_history=s // 2, temperature=1.5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.attention(tq, tk, tv, "sumi", impl="chunked", **kw)
    want = A.reference_attention(tq, tk, tv, "sumi", **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    j_chunked = np.asarray(JA.attention(jq, jk, jv, "sumi", impl="chunked",
                                        **kw))
    np.testing.assert_allclose(want.numpy(), np.asarray(JA.attention(
        jq, jk, jv, "sumi", impl="reference", **kw)), atol=TOL, rtol=TOL)
    if s * s > 256 * 256:
        assert np.abs(j_chunked - want.numpy()).max() > 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), j_chunked, atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("m", [12, 200])
def test_chunked_sumi_routes_match_jax(m):
    """``impl="chunked"`` on every SUMI route against JAX's: cached
    candidates through the 1-D dedup index and a packed 2-D index, decode
    over padded caches, extension with a prefix, and the monolithic pass
    (m 200: 200 x 400 cached scores, past 256 x 256: chunked_attention)."""
    rng = np.random.default_rng(2)
    u, n, h, hkv, d = 3, 200, 4, 2, 16
    kh, vh = _rand(rng, u, n, hkv, d), _rand(rng, u, n, hkv, d)
    q = _rand(rng, 2, m, h, d)
    kc, vc = _rand(rng, 2, m, hkv, d), _rand(rng, 2, m, hkv, d)
    idx = np.array([2, 0], np.int32)
    seg = rng.integers(0, u, (2, m)).astype(np.int32)
    lengths = np.array([150, 200, 90], np.int32)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    cases = {
        "cached, 1-D index": (
            sumi.cached_candidate_attention(
                t(q), t(kh), t(vh), t(kc), t(vc), impl="chunked",
                temperature=1.5, row_index=t(idx)),
            JS.cached_candidate_attention(
                j(q), j(kh), j(vh), j(kc), j(vc), impl="chunked",
                temperature=1.5, row_index=j(idx))),
        "cached, packed index": (
            sumi.cached_candidate_attention(
                t(q), t(kh), t(vh), t(kc), t(vc), impl="chunked",
                row_index=t(seg)),
            JS.cached_candidate_attention(
                j(q), j(kh), j(vh), j(kc), j(vc), impl="chunked",
                row_index=j(seg))),
        "decode": (
            sumi.decode_candidate_attention(
                t(q), t(kh[idx]), t(vh[idx]), t(kc), t(vc),
                t(lengths[idx]), impl="chunked", temperature=1.5),
            JS.decode_candidate_attention(
                j(q), j(kh[idx]), j(vh[idx]), j(kc), j(vc),
                j(lengths[idx]), impl="chunked", temperature=1.5)),
        "extend": (
            sumi.extend_attention(t(q), t(kh[idx]), t(vh[idx]), t(kc),
                                  t(vc), impl="chunked", temperature=1.5),
            JS.extend_attention(j(q), j(kh[idx]), j(vh[idx]), j(kc), j(vc),
                                impl="chunked", temperature=1.5)),
    }
    s = n + m
    qs, ks, vs = _rand(rng, 1, s, h, d), _rand(rng, 1, s, hkv, d), \
        _rand(rng, 1, s, hkv, d)
    cases["monolithic"] = (
        sumi.sumi_attention(t(qs), t(ks), t(vs), n, impl="chunked",
                            temperature=1.5),
        JS.sumi_attention(j(qs), j(ks), j(vs), n, impl="chunked",
                          temperature=1.5))
    for what, (got, want) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the pool-off ``full`` family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_full(setup):
    """JAX ``FlameEngine(history_cache=False, impl="reference")`` on the
    traffic the ``full`` tests serve."""
    jbundle, j32, _, _ = setup
    reqs = _traffic()
    jreqs = j_generate_traffic(JTrafficConfig(
        candidate_counts=(8, 16, 24), distribution="jittered", n_requests=8,
        n_history=N, seed=0), n_items=1000)
    for a, b in zip(reqs, jreqs):       # the copied generator is identical
        np.testing.assert_array_equal(a["candidates"], b["candidates"])
    jeng = j_create_engine("flame", jbundle, j32, **ENGINE, impl="reference",
                           history_cache=False,
                           store=JStore(latency_s=0.0,
                                        feature_dim=C.N_SIDE_FEATURES))
    try:
        return reqs, [np.asarray(o) for o in j_run_workload(
            jeng, jreqs)["outputs"]]
    finally:
        jeng.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
def test_full_family_matches_jax_engine(setup, jax_full, impl):
    _, _, tbundle, t32 = setup
    reqs, want = jax_full
    eng = _engine(tbundle, t32, impl=impl)
    fams = dict(eng.dso.families)
    got = _serve(eng, reqs)
    assert fams == {"full": [16, 8]} and eng.history_pool is None
    m = eng.metrics()
    assert not any(k.startswith("pool_") for k in m)
    assert m["dso_chunks_full"] >= len(reqs) and m["padded_fraction"] > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ETOL, rtol=ETOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_full_family_equals_pool_and_bucket_split(setup, impl):
    """``prefill == score_candidates(encode_history)``: the ``full`` family
    scores as the pool (native) does, within 1e-5; a 48-candidate request
    split 32 + 16 scores as one bucket-128 pass."""
    _, _, tbundle, t32 = setup
    reqs = _traffic(n=4, seed=5)
    full = _serve(_engine(tbundle, t32, impl=impl), reqs)
    pool = _serve(_engine(tbundle, t32, impl=impl, history_cache=True),
                  reqs)
    for a, b in zip(full, pool):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    rng = np.random.default_rng(6)
    r = {"history": rng.integers(0, 1000, N).astype(np.int32),
         "candidates": rng.integers(0, 1000, 48).astype(np.int32)}
    split = _engine(tbundle, t32, impl=impl, buckets=(32, 16))
    whole = _engine(tbundle, t32, impl=impl, buckets=(128,))
    a, b = _serve(split, [r])[0], _serve(whole, [r])[0]
    assert a.shape == (48, 3)
    assert split.metrics()["dso_chunks_full"] == 2
    np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["fused", "chunked"])
def test_full_family_coalesced_equals_sequential(setup, impl):
    """Bitwise: jittered traffic served concurrently (chunks of different
    requests sharing dispatches) == the same requests one at a time, as in
    the JAX package's ``tests/test_serving_api.py``."""
    _, _, tbundle, t32 = setup
    reqs = _traffic(n=12, seed=7, counts=(8, 16, 24))
    eng = _engine(tbundle, t32, impl=impl, max_batch=4, n_workers=4)
    conc = _serve(eng, reqs)
    assert eng.metrics()["dso_avg_fill"] > 1.0
    seq = _serve(_engine(tbundle, t32, impl=impl, max_batch=4, n_workers=4),
                 reqs, concurrent=False)
    for a, b in zip(conc, seq):
        np.testing.assert_array_equal(a, b)


def test_pool_off_refusals_and_no_gpu(setup):
    _, _, tbundle, t32 = setup
    with pytest.raises(ValueError, match="pack_tails=True needs"):
        _engine(tbundle, t32, pack_tails=True)
    with pytest.raises(ValueError, match="generate>0 needs"):
        _engine(tbundle, t32, generate=4)
    # incremental_history without the pool is ignored, as in JAX
    eng = _engine(tbundle, t32, incremental_history=True)
    eng.shutdown()
    assert list(eng.dso.families) == ["full"]
    # impl="cp" outside a mesh is the chunked route, as in JAX
    qkv = (torch.randn(1, 4, 2, 16,
                       generator=torch.Generator().manual_seed(0)),) * 3
    assert torch.equal(A.attention(*qkv, "causal", impl="cp"),
                       A.attention(*qkv, "causal", impl="chunked"))
    if torch.cuda.is_available():
        return          # the no-GPU contract does not apply
    for name in ("flame", "implicit"):
        with pytest.raises(RuntimeError, match="cuda"):
            _engine(tbundle, t32, name=name, device="cuda")


# ---------------------------------------------------------------------------
# the implicit-shape baseline
# ---------------------------------------------------------------------------

def test_implicit_shape_engine_counts_novel_shapes():
    """As JAX's ``tests/test_dso.py``: 3 novel shapes over (3, 5, 3, 7),
    the same outputs; and 8 threads over two shapes compile each once."""
    got = DSO.ImplicitShapeEngine(lambda x: x + 1.0, "cpu")
    want = JDSO.ImplicitShapeEngine(lambda x: x + 1.0)
    for m in (3, 5, 3, 7):
        x = np.arange(m, dtype=np.float32)[None]
        out = got.score((x,), m)
        assert out.shape == (1, m)
        np.testing.assert_array_equal(out, np.asarray(want.score((x,), m)))
    assert got.compiles == want.compiles == 3
    eng = DSO.ImplicitShapeEngine(lambda x: x * 2.0, "cpu")
    bad = []

    def work(i):
        for r in range(5):
            m = 4 + 2 * ((i + r) % 2)
            x = np.full((1, m), float(i), np.float32)
            if not np.array_equal(eng.score((x,), m), x * 2.0):
                bad.append((i, r))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not bad and eng.compiles == 2


@pytest.mark.parametrize("impl", ["chunked", "fused"])
def test_implicit_engine_matches_jax(setup, impl):
    """Protocol, shapes and ``jit_compiles`` (8 and 12 are the novel M of
    (8, 12, 8)) as JAX's ``tests/test_serving_api.py``, and the outputs of
    JAX's ``"implicit"`` engine (its default impl, chunked) within 1e-5."""
    jbundle, j32, tbundle, t32 = setup
    assert list(available_engines()) == ["flame", "implicit", "text"]
    rng = np.random.default_rng(1)
    reqs = [{"history": rng.integers(0, 1000, N).astype(np.int32),
             "candidates": rng.integers(0, 1000, m).astype(np.int32)}
            for m in (8, 12, 8)]
    jeng = j_create_engine("implicit", jbundle, j32, n_history=N,
                           n_workers=2,
                           store=JStore(latency_s=0.0,
                                        feature_dim=C.N_SIDE_FEATURES))
    try:
        want = j_run_workload(jeng, reqs)["outputs"]
    finally:
        jeng.shutdown()
    eng = _engine(tbundle, t32, name="implicit", impl=impl)
    resp = eng.submit(ServeRequest(**reqs[0])).result(timeout=120)
    assert resp.output.shape == (8, 3)
    assert {"queue_s", "features_s", "execute_s"} <= set(resp.timings)
    got = _serve(eng, reqs)
    m = eng.metrics()
    assert [o.shape for o in got] == [(8, 3), (12, 3), (8, 3)]
    assert m["requests"] == 4 and m["jit_compiles"] == 2
    assert "pda_prefetches" in m and not any(k.startswith("dso_")
                                             for k in m)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have "
                    "no CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "chunked"])
def test_full_and_implicit_graphs_on_gpu(setup, cuda, impl):
    """Every ``full`` executor is a captured graph whose call equals its
    eager function bitwise; the implicit engine captures one graph per
    novel M in band and its replays equal the first call bitwise."""
    _, _, tbundle, t32 = setup
    params = C.params_to(t32, cuda)
    eng = _engine(tbundle, params, impl=impl, device=cuda)
    try:
        rng = np.random.default_rng(3)
        for (kind, b), exs in eng.dso.executors.items():
            args = [rng.integers(0, 1000, (2, N)).astype(np.int32),
                    rng.integers(0, 1000, (2, b)).astype(np.int32),
                    rng.normal(size=(2, C.N_SIDE_FEATURES)).astype(
                        np.float32)]
            for ex in exs:
                assert ex.graph is not None
                with torch.inference_mode():
                    want = ex.fn(*(torch.from_numpy(a).to(cuda)
                                   for a in args)).cpu().numpy()
                np.testing.assert_array_equal(ex(*args), want)
    finally:
        eng.shutdown()
    eng = _engine(tbundle, params, name="implicit", impl=impl, device=cuda)
    reqs = [{"history": rng.integers(0, 1000, N).astype(np.int32),
             "candidates": rng.integers(0, 1000, m).astype(np.int32)}
            for m in (8, 12, 8, 12)]
    first = _serve(eng, reqs, concurrent=False)
    assert eng.jit.compiles == 2 and all(
        ex.graph is not None for ex in eng.jit.executors.values())
    assert eng.jit.graph_bytes > 0
    eng = _engine(tbundle, params, name="implicit", impl=impl, device=cuda)
    again = _serve(eng, reqs + reqs)
    for a, b in zip(first + first, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_failed_in_band_capture_raises_on_gpu(cuda):
    def fn(x):
        return x * float(x.sum().item())       # a host sync: no capture
    eng = DSO.ImplicitShapeEngine(fn, cuda)
    with pytest.raises(RuntimeError, match="capture"):
        eng.score((np.ones((1, 4), np.float32),), 4)
    assert eng.compiles == 0 and not eng.executors
