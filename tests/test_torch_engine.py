"""Serving-level tests of the port: the PyTorch ``FlameEngine`` against the
JAX ``FlameEngine(impl="fused", history_cache=True)`` on the same
``TrafficConfig`` traffic (1e-4 on a native pool, the ``tests/test_fke.py``
QTOL 2e-2 on an int8 pool, where the two packages' encodes may round a code
differently), plus the port's own bitwise invariants (hit == miss,
coalesced == sequential) and its pool / DSO / admission units.  Everything
runs on the CPU (``device="cpu"``: the kernels' plain versions).
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
from repro.core.pda import RemoteFeatureStore as JStore
from repro.models import build_model
from repro.serving import FlameEngine as JFlameEngine
from repro.serving.scheduler import TrafficConfig as JTrafficConfig
from repro.serving.scheduler import generate_traffic as j_generate_traffic
from repro.serving.scheduler import run_workload_async as j_run_workload
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.core import dso as DSO
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.serving import ServeRequest, create_engine
from repro_torch.serving.engine import _AdmissionQueue, _AdmissionRecord
from repro_torch.serving.kv_cache import HistoryKVPool
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.types import ClimberConfig

torch.set_num_threads(1)
TOL = 1e-4
QTOL = 2e-2
SMALL = dict(vocab_size=5_000, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)
ENGINE = dict(n_history=64, buckets=(16, 8), n_streams=2,
              feature_mode="sync", window_s=0.004, max_batch=2, n_workers=2)


@pytest.fixture(scope="module")
def models():
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
    return jbundle, j32, C.build_climber(tc), t32


def _traffic(n=10, seed=0):
    kw = dict(candidate_counts=(8, 16, 24), distribution="jittered",
              n_requests=n, n_history=64, n_users=3, seed=seed)
    reqs = generate_traffic(TrafficConfig(**kw), n_items=5000)
    jreqs = j_generate_traffic(JTrafficConfig(**kw), n_items=5000)
    for a, b in zip(reqs, jreqs):       # the copied generator is identical
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    return reqs


def _engine(bundle, params, **kw):
    base = dict(ENGINE, store=RemoteFeatureStore(latency_s=0.0,
                                                 feature_dim=12),
                impl="fused", device="cpu")
    base.update(kw)
    return create_engine("flame", bundle, params, **base)


@pytest.mark.parametrize("pool,tol", [("native", TOL), ("int8", QTOL)])
def test_engine_matches_jax_engine(models, pool, tol):
    jbundle, j32, tbundle, t32 = models
    reqs = _traffic()
    jeng = JFlameEngine(jbundle, j32, **ENGINE, impl="fused",
                        history_cache=True, pool_dtype=pool,
                        store=JStore(latency_s=0.0, feature_dim=12))
    try:
        exp = j_run_workload(jeng, reqs)["outputs"]
    finally:
        jeng.shutdown()
    teng = _engine(tbundle, t32, pool_dtype=pool)
    try:
        res = run_workload_async(teng, reqs)
        m = teng.metrics()
    finally:
        teng.shutdown()
    for got, want in zip(res["outputs"], exp):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)
    assert m["pool_hits"] > 0 and m["pool_misses"] > 0
    # single-flight: one encode per user, however they were coalesced
    assert m["dso_chunks_encode"] == m["pool_entries"] <= 3


@pytest.mark.parametrize("impl", ["reference", "pallas", "chunked"])
def test_framework_impls_score_like_jax_engine(models, impl):
    """Scoring under the framework impls (dequantize + gather of the pool's
    stored rows in the executor; ``cached`` on K2 under pallas, the JAX
    framework impl's route under chunked) against the
    JAX engine's reference impl on a native pool, and hit == miss on an
    int8 pool."""
    jbundle, j32, tbundle, t32 = models
    reqs = _traffic(n=6, seed=3)
    jeng = JFlameEngine(jbundle, j32, **ENGINE, impl="reference",
                        history_cache=True,
                        store=JStore(latency_s=0.0, feature_dim=12))
    try:
        exp = j_run_workload(jeng, reqs)["outputs"]
    finally:
        jeng.shutdown()
    teng = _engine(tbundle, t32, impl=impl)
    try:
        got = run_workload_async(teng, reqs)["outputs"]
    finally:
        teng.shutdown()
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
    teng = _engine(tbundle, t32, impl=impl, pool_dtype="int8")
    try:
        miss = run_workload_async(teng, reqs)["outputs"]
        hit = run_workload_async(teng, reqs)["outputs"]
    finally:
        teng.shutdown()
    for a, b in zip(miss, hit):
        np.testing.assert_array_equal(a, b)


def test_hit_equals_miss_and_coalesced_equals_sequential(models):
    """Bitwise: a user's hit scores == its miss scores (one stored int8
    representation), and concurrent coalesced serving == one request at a
    time (fixed executor shapes, independent rows)."""
    _, _, tbundle, t32 = models
    reqs = _traffic(n=8, seed=1)
    eng = _engine(tbundle, t32, pool_dtype="int8")
    try:
        conc = run_workload_async(eng, reqs)["outputs"]
        hits = run_workload_async(eng, reqs)["outputs"]
        assert eng.metrics()["pool_misses"] == len({r["user_id"]
                                                    for r in reqs})
    finally:
        eng.shutdown()
    eng = _engine(tbundle, t32, pool_dtype="int8")
    try:
        seq = [eng.submit(ServeRequest(history=r["history"],
                                       candidates=r["candidates"],
                                       user_id=r["user_id"]))
               .result().output for r in reqs]
    finally:
        eng.shutdown()
    for a, b, c in zip(conc, hits, seq):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_dedup_stacks_one_entry_once(models):
    """A 32-candidate request splits into two 16-chunks of ONE pool entry
    riding one dispatch: its rows stack once and the kernel's row index
    resolves both."""
    _, _, tbundle, t32 = models
    r = _traffic(n=1, seed=2)[0]
    eng = _engine(tbundle, t32, pool_dtype="bf16", window_s=0.05)
    try:
        cand = np.concatenate([r["candidates"]] * 4)[:32]
        out = eng.serve(r["history"], cand, user_id=r["user_id"])
        m = eng.metrics()
        alone = eng.serve(r["history"], cand[:16], user_id=r["user_id"])
    finally:
        eng.shutdown()
    assert out.shape == (32, 3)
    assert m["dso_dedup_rows_saved"] >= 1
    np.testing.assert_array_equal(out[:16], alone)


def test_unported_options_raise(models):
    _, _, tbundle, t32 = models
    # every option of the JAX engine is served: a (1, 1) mesh is accepted
    # (tests/test_torch_mesh_serving.py serves over meshes of 4 ranks), and
    # impl="cp" outside a mesh runs chunked, as in the JAX engine
    from repro_torch.launch.mesh import make_serving_mesh
    r = _traffic(n=1, seed=4)[0]
    outs = {}
    for kw in (dict(mesh=make_serving_mesh("1,1")), dict(impl="cp"),
               dict(impl="chunked")):
        eng = _engine(tbundle, t32, **kw)
        try:
            outs[tuple(kw.values())[0] if "impl" in kw else "mesh"] = \
                eng.serve(r["history"], r["candidates"],
                          user_id=r["user_id"])
            assert eng.metrics().get("pool_shard_ways") == \
                (1 if "mesh" in kw else None)
        finally:
            eng.shutdown()
    np.testing.assert_array_equal(outs["cp"], outs["chunked"])
    assert np.isfinite(outs["mesh"]).all()
    with pytest.raises(ValueError, match="generate>0 under a mesh"):
        _engine(tbundle, t32, mesh=make_serving_mesh("1,1"), generate=2)
    with pytest.raises(ValueError, match="impl"):
        _engine(tbundle, t32, impl="no-such-impl")
    eng = _engine(tbundle, t32)
    try:
        with pytest.raises(ValueError):
            eng.serve(np.arange(10), np.arange(4))     # history too short
        with pytest.raises(ValueError):
            eng.serve(np.arange(64), np.array([3, -1]))
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# pool, DSO and admission units
# ---------------------------------------------------------------------------

def _kv(seed=0, s=5):
    g = torch.Generator().manual_seed(seed)
    return {"b0": {"k": torch.randn(1, 2, s, 2, 4, generator=g),
                   "v": torch.randn(1, 2, s, 2, 4, generator=g)}}


def test_pool_lru_budget_stale_and_reject():
    pool = HistoryKVPool(2, dtype="int8", device="cpu")
    for i in range(3):
        assert pool.put(("u", i), f"fp{i}", _kv(i))
    assert pool.keys() == [("u", 1), ("u", 2)] and pool.evictions == 1
    kv, status, _ = pool.lookup(("u", 1), "fp1", raw=True)
    assert status == "hit" and kv["b0"]["k"][0].dtype == torch.int8
    assert pool.keys() == [("u", 2), ("u", 1)]           # recency refreshed
    assert pool.lookup(("u", 2), "other")[1] == "stale"
    assert ("u", 2) not in pool.keys()
    assert pool.lookup(("u", 9), "x") == (None, "miss", None)
    assert pool.peek(("u", 1), "fp1") is not None and pool.hits == 1
    one = pool.bytes_used
    small = HistoryKVPool(None, budget_bytes=one, dtype="int8", device="cpu")
    assert small.put("a", 1, _kv()) and not small.put("b", 2, _kv(s=9))
    assert small.rejects == 1 and small.put("c", 3, _kv(1))
    assert small.keys() == ["c"] and small.bytes_used <= one
    assert small.drop("c") and not small.drop("c") and len(small) == 0
    st = pool.stats()
    assert st["hits"] == 1 and st["stale"] == 1 and st["misses"] == 2


def test_pool_prequantized_put_shares_tensors():
    pool = HistoryKVPool(4, dtype="int8", device="cpu")
    from repro_torch.serving.kv_cache import quantize_kv_graph
    raw = quantize_kv_graph(_kv(), "int8")
    pool.put("k", "fp", raw, prequantized=True)
    got, _, _ = pool.lookup("k", "fp", raw=True)
    assert got["b0"]["v"][0] is raw["b0"]["v"][0]
    deq = pool.lookup("k", "fp")[0]["b0"]["v"]
    assert deq.dtype == torch.float32
    torch.testing.assert_close(deq, _kv()["b0"]["v"], atol=0.05, rtol=0)


def test_split_request_and_padding():
    plan = DSO.split_request(45, (16, 8))
    assert [(c.bucket, c.start, c.valid) for c in plan] == \
        [(16, 0, 16), (16, 16, 16), (8, 32, 8), (8, 40, 5)]
    with pytest.raises(ValueError):
        DSO.split_request(0, (8,))


def test_orchestrator_coalesces_and_keeps_rows_independent():
    """Chunks from different submitters share one dispatch of the fixed
    batch shape; every chunk gets exactly its own row back."""
    calls = []

    def build(kind, bucket, batch):
        def fn(x):
            calls.append(tuple(x.shape))
            return x * 2
        return DSO.Executor(fn, [DSO.TensorSpec((batch, bucket),
                                                torch.float32)], "cpu")

    orch = DSO.CoalescingOrchestrator(
        build, pad_slice_fn=lambda req, c, kind: (req[:, c.start:c.start
                                                       + c.bucket],),
        gather_fn=lambda rows, cs, m, kind: np.concatenate(rows, 1),
        families={"x": (4,)}, policy=DSO.CoalescePolicy(max_batch=3,
                                                       window_s=0.2))
    try:
        reqs = [np.full((1, 4), i, np.float32) for i in range(3)]
        out = [None] * 3
        ths = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, orch.score(reqs[i], 4, kind="x"))) for i in range(3)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in ths)
    finally:
        orch.shutdown()
    for i in range(3):
        np.testing.assert_array_equal(out[i], reqs[i] * 2)
    assert all(c == (3, 4) for c in calls)
    assert orch.stats()["dispatches"] < 3


def test_admission_queue_edf_order_and_close():
    q = _AdmissionQueue(8, mode="edf")
    now = time.perf_counter()
    for dl, tier in ((now + 5, "bulk"), (None, "interactive"),
                     (now + 1, "standard"), (now + 1, "interactive")):
        q.put(_AdmissionRecord(q.key_for(dl, tier), None, now, tier, dl))
    order = [q.get().tier for _ in range(4)]
    assert order == ["interactive", "standard", "bulk", "interactive"]
    q.put(_AdmissionRecord(q.key_for(None, "bulk"), None, now, "bulk", None))
    q.close()
    assert q.get() is None and len(q.drain()) == 1
    with pytest.raises(RuntimeError):
        q.put(_AdmissionRecord(q.key_for(None, "bulk"), None, now, "bulk",
                               None))
