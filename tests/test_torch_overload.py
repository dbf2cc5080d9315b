"""Overload handling and fault tolerance in the port, against the JAX
package and against the port's own fault-free runs, on the CPU.

1. Against JAX, unit by unit: ``FaultInjector`` fire sequences (built and
   parsed, several specs, seeds and call orders), ``DegradationPolicy``
   level traces, the admission queue's EDF pop order and ``shed_victim``
   choices, and the pool's spill tier (stats, key order and tier contents
   after the same put / lookup / get / drop / peek trace as JAX's
   ``HistoryKVPool(placement="host", spill_bytes=...)``, and
   ``quantized_nbytes`` for every pool dtype).
2. The engine against ``JFlameEngine`` with the same options: spill tier,
   transient dispatch faults, ``kv_dedup=False`` and degradation levels 2
   and 3, scores within 1e-4 (native f32 pool, ``tests/test_torch_engine.py``'s
   TOL) and tokens equal; and each bitwise against the port's own
   fault-free, no-spill run.
3. The port of the 23 cases of ``tests/test_overload.py`` (the pipeline
   scaffolding with a model-free engine, then ``FlameEngine`` under
   faults), and the DSO's retry and window override.

Workers are gated on ``threading.Event``s and the policy gets explicit
``now`` values: no sleep is used as synchronisation.  Model-free
engines sleep only as a service time.
"""
import dataclasses
import random
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.pda import RemoteFeatureStore as JStore
from repro.models import build_model
from repro.serving import FlameEngine as JFlameEngine
from repro.serving.api import DegradationPolicy as JDegradationPolicy
from repro.serving.api import DegradedError as JDegradedError
from repro.serving.api import TopKConfig as JTopKConfig
from repro.serving.engine import _AdmissionQueue as JQueue
from repro.serving.engine import _AdmissionRecord as JRecord
from repro.serving.faults import FaultInjector as JFaultInjector
from repro.serving.kv_cache import HistoryKVPool as JPool
from repro.serving.kv_cache import quantized_nbytes as j_quantized_nbytes
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core import climber as C
from repro_torch.core import dso as DSO
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.serving import (DeadlineExceeded, DegradationPolicy,
                                 DegradedError, FaultInjected, FaultInjector,
                                 HistoryKVPool, RejectedError, ServeRequest,
                                 ShedError, TopKConfig, WatchdogTimeout,
                                 create_engine)
from repro_torch.serving.engine import (_AdmissionQueue, _AdmissionRecord,
                                        _PipelinedEngine)
from repro_torch.serving.kv_cache import quantized_nbytes
from repro_torch.serving.scheduler import run_workload_async
from repro_torch.types import ClimberConfig, TensorSpec

torch.set_num_threads(1)
TOL = 1e-4          # native f32 pool: tests/test_torch_engine.py's TOL
WAIT = 60           # seconds any future or thread may take


# ---------------------------------------------------------------------------
# 1. unit by unit against JAX
# ---------------------------------------------------------------------------

class _FakePool:
    """keys() / drop() of a pool, recording the storm's victims."""

    def __init__(self, n):
        self._keys = [("u", i) for i in range(n)]
        self.dropped = []

    def keys(self):
        return list(self._keys)

    def drop(self, k):
        self._keys.remove(k)
        self.dropped.append(k)
        return True


def _schedule(inj, order):
    """Drive the injector's hooks in ``order`` ('d', 's', 'e'); returns what
    each call did, the storm's victims and the stats."""
    pool = _FakePool(12)
    out = []
    for op in order:
        if op == "d":
            try:
                inj.dispatch("cached", 16)
                out.append("ok")
            except Exception as e:  # noqa: BLE001 — the fault is the result
                out.append(("fault", bool(e.transient), str(e)))
        elif op == "s":
            inj.worker_stall()
            out.append("stall")
        else:
            out.append(("storm", inj.pool_storm(pool)))
    return out, pool.dropped, inj.stats()


@pytest.mark.parametrize("spec", [
    "dispatch:0.4",
    "dispatch:0.3:5,stall:0.2:0.0,evict:0.25",
    "dispatch_fatal:0.5:3,evict:0.5:0.75",
    "stall:0.5:0,evict:1.0:0.3,dispatch:0.1",
])
def test_fault_schedules_match_jax(spec):
    """``parse(spec, seed)`` and the constructor give the JAX injector's
    fire sequence, storm victims and stats for the same call order."""
    for seed in (0, 7):
        order = random.Random(seed + 100).choices("dse", k=60)
        got = _schedule(FaultInjector.parse(spec, seed=seed), order)
        want = _schedule(JFaultInjector.parse(spec, seed=seed), order)
        assert got == want
    kw = dict(dispatch_p=0.35, dispatch_times=4, dispatch_transient=False,
              stall_p=0.25, stall_s=0.0, evict_p=0.3, evict_fraction=0.4,
              seed=5)
    order = random.Random(3).choices("dse", k=80)
    assert _schedule(FaultInjector(**kw), order) == \
        _schedule(JFaultInjector(**kw), order)
    with pytest.raises(ValueError, match="unknown fault arm"):
        FaultInjector.parse("nope:0.1")


@pytest.mark.parametrize("kw", [
    dict(threshold_s=0.05),
    dict(threshold_s=0.01, dwell_s=0.0, alpha=1.0),
    dict(threshold_s=0.02, recover_s=0.015, alpha=0.5, dwell_s=0.05,
         max_level=2),
])
def test_degradation_traces_match_jax(kw):
    rng = np.random.default_rng(1)
    delays = np.concatenate([rng.uniform(0.0, 0.2, 40),
                             rng.uniform(0.0, 0.005, 40)])
    nows = np.cumsum(rng.uniform(0.0, 0.1, len(delays))) + 1000.0
    pol, jpol = DegradationPolicy(**kw), JDegradationPolicy(**kw)
    got = [(pol.observe(float(d), now=float(t)), pol.ewma_s)
           for d, t in zip(delays, nows)]
    want = [(jpol.observe(float(d), now=float(t)), jpol.ewma_s)
            for d, t in zip(delays, nows)]
    assert got == want
    assert max(lv for lv, _ in got) > 0 and got[-1][0] < max(
        lv for lv, _ in got)              # climbed and came back down


@pytest.mark.parametrize("mode", ["edf", "fifo"])
def test_admission_queue_matches_jax(mode):
    """A seeded mix of puts (deadline or none, every tier), gets and
    shed probes gives the JAX queue's pop order and victims."""
    rng = random.Random(11)
    q, jq = _AdmissionQueue(64, mode=mode), JQueue(64, mode=mode)
    tiers = ("interactive", "standard", "bulk")
    got, want = [], []
    n = 0
    for _ in range(150):
        op = rng.choice("pppgs")
        if op == "p" and q.qsize() < 60:
            dl = None if rng.random() < 0.2 else round(rng.uniform(0, 10), 1)
            tier = rng.choice(tiers)
            q.put(_AdmissionRecord(q.key_for(dl, tier), n, 0.0, tier, dl))
            jq.put(JRecord(jq.key_for(dl, tier), n, 0.0, tier, dl))
            n += 1
        elif op == "g" and q.qsize():
            got.append(("get", q.get().fut))
            want.append(("get", jq.get().fut))
        elif op == "s":
            dl = round(rng.uniform(0, 10), 1)
            tier = rng.choice(tiers)
            v, jv = q.shed_victim(q.key_for(dl, tier)), \
                jq.shed_victim(jq.key_for(dl, tier))
            got.append(("shed", None if v is None else v.fut))
            want.append(("shed", None if jv is None else jv.fut))
        assert q.qsize() == jq.qsize()
    assert got == want
    # under fifo a probe is always the newest key: nothing ranks below it
    assert any(k == "shed" and v is not None for k, v in got) \
        == (mode == "edf")
    assert [r.fut for r in q.drain()] == [r.fut for r in jq.drain()]


def _kv_np(seed, s=5):
    r = np.random.default_rng(seed)
    return {"b0": {"k": r.standard_normal((1, 2, s, 2, 4)).astype(np.float32),
                   "v": r.standard_normal((1, 2, s, 2, 4)).astype(np.float32)}}


def _kv_t(seed, s=5):
    return {b: {n: torch.from_numpy(a) for n, a in kv.items()}
            for b, kv in _kv_np(seed, s).items()}


@pytest.mark.parametrize("dtype", ["native", "bf16", "int8"])
def test_spill_trace_matches_jax(dtype):
    """The same put / lookup / get / drop / peek / contains trace through
    the port's pool and JAX's ``HistoryKVPool(placement="host",
    spill_bytes=...)``: each call's result, the primary and spill tiers'
    key order and ``stats()`` after every call; lookups' values within
    1e-6."""
    for s in (5, 9):
        assert quantized_nbytes(_kv_t(0, s), dtype) == \
            j_quantized_nbytes(_kv_np(0, s), dtype)
    one = quantized_nbytes(_kv_t(0), dtype)
    kw = dict(slots=3, budget_bytes=int(2.5 * one), dtype=dtype,
              placement="host", spill_bytes=3 * one)
    pool, jpool = HistoryKVPool(**kw), JPool(**kw)
    rng = random.Random(5)
    for step in range(200):
        op = rng.choice(["put", "put", "lookup", "lookup", "get", "drop",
                         "peek", "contains"])
        key, fp = rng.randrange(8), rng.randrange(2)
        if op == "put":
            seed, s = rng.randrange(100), rng.choice([5, 5, 5, 9, 15])
            got = pool.put(key, fp, _kv_t(seed, s))
            want = jpool.put(key, fp, _kv_np(seed, s))
        elif op in ("lookup", "get", "peek"):
            if op == "lookup":
                kv, st, _ = pool.lookup(key, fp)
                jkv, jst, _ = jpool.lookup(key, fp)
            else:
                kv = getattr(pool, op)(key, fp)
                jkv = getattr(jpool, op)(key, fp)
                st = jst = None
            assert (kv is None) == (jkv is None), (step, op)
            if kv is not None:
                np.testing.assert_allclose(kv["b0"]["k"].numpy(),
                                           np.asarray(jkv["b0"]["k"]),
                                           rtol=1e-6, atol=1e-6)
            got, want = st, jst
        else:
            got = getattr(pool, op)(key, *([fp] if op == "contains" else []))
            want = getattr(jpool, op)(key,
                                      *([fp] if op == "contains" else []))
        assert got == want, (step, op)
        assert pool.keys() == jpool.keys(), step
        assert list(pool._spill) == list(jpool._spill), step
        assert pool.stats() == jpool.stats(), step
    st = pool.stats()
    assert st["spill_hits"] > 0 and st["evictions"] > 0 and st["rejects"] > 0


# ---------------------------------------------------------------------------
# 2. the engine against JFlameEngine, and against the port's own runs
# ---------------------------------------------------------------------------

N_HIST = 16
VOCAB = 64
SMALL = dict(vocab_size=VOCAB, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
             head_dim=32)
BASE = dict(n_history=N_HIST, buckets=(8, 4), n_streams=2,
            feature_mode="off", window_s=0.004, max_batch=2, n_workers=2,
            impl="fused", history_cache=True, generate=4, gen_vocab=16)


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


def _forced_policy():
    """A policy stepped by hand only: nothing the workers observe moves it
    (threshold far above any delay, recovery below zero delay)."""
    return dict(threshold_s=1e3, recover_s=0.0, dwell_s=0.0, alpha=1.0)


def _scoring(seed=0):
    rng = np.random.default_rng(seed)
    hists = [rng.integers(0, VOCAB, N_HIST).astype(np.int32)
             for _ in range(5)]
    return [dict(history=hists[u], user_id=u,
                 candidates=rng.integers(0, VOCAB, m).astype(np.int32))
            for u, m in zip(range(5), (8, 12, 5, 16, 3))]


def _drive(eng, reqs, gen, rd, req_cls, topk_cls, degraded_cls, pol, steps):
    """The shared script: scoring twice (misses, then hits of both tiers),
    level 2 and a bulk top-k 4 x 4, level 3 and a bulk hit and a bulk
    miss.  Returns (scoring rounds, tokens, level-3 hit, miss error)."""
    rounds = [[eng.submit(req_cls(**r)).result(WAIT).output for r in reqs]
              for _ in range(2)]
    for _ in range(2):
        pol.observe(1e4)
    assert pol.level == 2
    toks = eng.submit(req_cls(history=gen["history"],
                              candidates=gen["candidates"], user_id=50,
                              slo_tier="bulk",
                              generate=topk_cls(k=4, steps=steps))
                      ).result(WAIT).output
    pol.observe(1e4)
    assert pol.level == 3
    hit = eng.submit(req_cls(**reqs[0], slo_tier="bulk")).result(WAIT).output
    miss = eng.submit(req_cls(**dict(rd, slo_tier="bulk")))
    err = None
    try:
        miss.result(WAIT)
    except degraded_cls as e:
        err = e
    return rounds, toks, hit, err


def test_engine_overload_options_match_jax(models):
    """Spill tier (2 slots, 5 users), transient dispatch faults with
    retries, ``kv_dedup=False`` and a degradation policy driven to levels 2
    and 3, through ``JFlameEngine`` and the port's engine with the same
    options: scores within TOL, tokens equal, the level-3 bulk miss a
    DegradedError in both.  The port's run equals its own fault-free,
    no-spill, deduped engine bitwise (scores, the hit at level 3, and
    the shrunk generation against a plain top-k 2 x 2)."""
    jb, j32, tb, t32 = models
    reqs = _scoring()
    rng = np.random.default_rng(9)
    gen = dict(history=rng.integers(0, VOCAB, N_HIST).astype(np.int32),
               candidates=rng.integers(0, VOCAB, 10).astype(np.int32))
    rd = dict(history=rng.integers(0, VOCAB, N_HIST).astype(np.int32),
              candidates=np.arange(6, dtype=np.int32), user_id=99)
    opts = dict(pool_slots=2, pool_spill_bytes=1 << 24, kv_dedup=False,
                dispatch_retries=40)

    jpol = JDegradationPolicy(**_forced_policy())
    jeng = JFlameEngine(jb, j32, **BASE, **opts, degradation=jpol,
                        faults=JFaultInjector(dispatch_p=0.3, seed=3),
                        store=JStore(latency_s=0.0, feature_dim=12))
    try:
        from repro.serving.api import ServeRequest as JServeRequest
        want = _drive(jeng, reqs, gen, rd, JServeRequest, JTopKConfig,
                      JDegradedError, jpol, steps=4)
        jm = jeng.metrics()
    finally:
        jeng.shutdown()

    pol = DegradationPolicy(**_forced_policy())
    eng = create_engine("flame", tb, t32, **BASE, **opts, degradation=pol,
                        faults=FaultInjector(dispatch_p=0.3, seed=3),
                        store=RemoteFeatureStore(latency_s=0.0,
                                                 feature_dim=12),
                        device="cpu")
    try:
        got = _drive(eng, reqs, gen, rd, ServeRequest, TopKConfig,
                     DegradedError, pol, steps=4)
        m = eng.metrics()
    finally:
        eng.shutdown()
    plain = create_engine("flame", tb, t32, **BASE, pool_slots=64,
                          store=RemoteFeatureStore(latency_s=0.0,
                                                   feature_dim=12),
                          device="cpu")
    try:
        base = [plain.submit(ServeRequest(**r)).result(WAIT).output
                for r in reqs]
        base_toks = plain.serve(gen["history"], gen["candidates"],
                                user_id=50,
                                generate=TopKConfig(k=2, steps=2))
    finally:
        plain.shutdown()

    (rounds, toks, hit, err), (jrounds, jtoks, jhit, jerr) = got, want
    for rnd, jrnd in zip(rounds, jrounds):
        for a, b in zip(rnd, jrnd):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hit, np.asarray(jhit), rtol=TOL, atol=TOL)
    assert toks.shape == (2, 2)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert isinstance(err, DegradedError) and isinstance(jerr,
                                                         JDegradedError)
    # the port's own invariants, bitwise
    for rnd in rounds:
        for a, b in zip(rnd, base):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hit, base[0])
    np.testing.assert_array_equal(toks, base_toks)
    for k in ("pool_spill_hits", "degrade_shed", "degrade_gen_shrunk"):
        assert m[k] == jm[k] and m[k] > 0, k
    assert m["dso_dispatch_retries"] > 0 and m["dso_dispatch_failures"] == 0
    assert m["dso_dedup_rows_saved"] == 0


@pytest.mark.parametrize("impl", ["fused", "reference"])
def test_kv_dedup_off_is_bitwise(models, impl):
    """``kv_dedup=False`` stacks every rider's rows (no row index) and
    scores bitwise as the deduped engine on one co-batched round; the
    auto rule turns dedup on under fused and off under reference on the
    CPU."""
    _, _, tb, t32 = models
    r = _scoring(3)[1]
    cand = np.concatenate([r["candidates"]] * 2)
    outs = {}
    for dedup in (None, True, False):
        eng = create_engine("flame", tb, t32,
                            **dict(BASE, window_s=0.2, impl=impl),
                            kv_dedup=dedup, device="cpu",
                            store=RemoteFeatureStore(latency_s=0.0,
                                                     feature_dim=12))
        try:
            assert eng._kv_dedup == (impl == "fused" if dedup is None
                                     else dedup)
            eng.serve(r["history"], cand[:4], user_id=1)         # warm
            outs[dedup] = eng.serve(r["history"], cand, user_id=1)
            saved = eng.metrics()["dso_dedup_rows_saved"]
        finally:
            eng.shutdown()
        assert (saved > 0) == eng._kv_dedup
    np.testing.assert_array_equal(outs[True], outs[False])
    np.testing.assert_array_equal(outs[None], outs[False])


@pytest.mark.parametrize("kw", [
    dict(faults=FaultInjector()), dict(shed_policy="tiered"),
    dict(degradation=DegradationPolicy()), dict(watchdog_grace_s=1.0),
    dict(pool_spill_bytes=1 << 20), dict(kv_dedup=False),
    dict(dispatch_retries=0),
], ids=["faults", "shed_policy", "degradation", "watchdog_grace_s",
        "pool_spill_bytes", "kv_dedup", "dispatch_retries"])
def test_overload_options_are_accepted(models, kw):
    """The options ``test_torch_engine.py::test_unported_options_raise``
    checked for NotImplementedError until they were ported: each is now
    accepted and the engine serves."""
    _, _, tb, t32 = models
    eng = create_engine("flame", tb, t32, **BASE, **kw, device="cpu",
                        store=RemoteFeatureStore(latency_s=0.0,
                                                 feature_dim=12))
    try:
        r = _scoring()[0]
        assert eng.serve(r["history"], r["candidates"]).shape == (8, 3)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# 3a. the port of tests/test_overload.py, layer 1: no model
# ---------------------------------------------------------------------------

class _SleepEngine(_PipelinedEngine):
    """Model-free engine: optionally gated (``started`` set on entry, then
    waits for ``gate``), then sleeps a service time; records the order it
    served requests in."""

    def __init__(self, service_s=0.0, gate=None, started=None, **kw):
        self._service_s = service_s
        self._gate = gate
        self._started = started
        self.served = []
        super().__init__(**kw)

    def _execute(self, req):
        if self._started is not None:
            self._started.set()
        if self._gate is not None:
            assert self._gate.wait(WAIT)
        if self._service_s:
            time.sleep(self._service_s)
        self.served.append(req.request_id)
        return np.zeros((req.m, 3), np.float32), {"execute_s": 0.0}


def _req(m=4, tier="standard", deadline=None, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return ServeRequest(history=rng.integers(0, 100, 8).astype(np.int32),
                        candidates=rng.integers(0, 100, m).astype(np.int32),
                        slo_tier=tier, deadline_s=deadline, **kw)


def _rec(q, deadline_abs, tier):
    return _AdmissionRecord(q.key_for(deadline_abs, tier), Future(),
                            time.perf_counter(), tier, deadline_abs)


def test_edf_pops_by_deadline_then_tier():
    q = _AdmissionQueue(16, mode="edf")
    late = _rec(q, 10.0, "standard")
    early = _rec(q, 1.0, "bulk")         # earliest deadline wins over tier
    none = _rec(q, None, "interactive")  # deadline-less sorts last
    tie_bulk = _rec(q, 5.0, "bulk")
    tie_int = _rec(q, 5.0, "interactive")  # tier breaks deadline ties
    for r in (late, none, tie_bulk, early, tie_int):
        q.put(r)
    assert [q.get() for _ in range(5)] == [early, tie_int, tie_bulk, late,
                                           none]


def test_fifo_mode_pops_arrival_order():
    q = _AdmissionQueue(16, mode="fifo")
    recs = [_rec(q, 10.0 - i, "interactive" if i % 2 else "bulk")
            for i in range(4)]
    for r in recs:
        q.put(r)
    assert [q.get() for _ in range(4)] == recs


def test_shed_victim_takes_strictly_worse_only():
    q = _AdmissionQueue(16, mode="edf")
    best = _rec(q, 1.0, "interactive")
    mid = _rec(q, 5.0, "standard")
    worst = _rec(q, 50.0, "bulk")
    for r in (best, mid, worst):
        q.put(r)
    probe = _rec(q, 2.0, "interactive")
    assert q.shed_victim(probe.key) is worst
    assert q.qsize() == 2
    # nothing queued ranks below the worst remaining record: no victim
    assert q.shed_victim(mid.key) is None
    # shed records are skipped at the heap root, never served
    assert q.get() is best and q.get() is mid and q.qsize() == 0


def test_unknown_tier_rejected_at_submit():
    eng = _SleepEngine(n_workers=1, name="t")
    try:
        with pytest.raises(ValueError, match="unknown slo_tier"):
            eng.submit(_req(tier="turbo"))
    finally:
        eng.shutdown()


def test_tier_default_deadline_applies():
    """A request with no explicit deadline inherits its tier's default —
    proven by the admission-time shed of an already-blown budget (the
    request's arrival is set 10 ms in the past)."""
    eng = _SleepEngine(n_workers=1, name="t",
                       slo_tier_defaults={"interactive": 0.001})
    try:
        past = time.perf_counter() - 0.01
        with pytest.raises(DeadlineExceeded):
            eng.submit(_req(tier="interactive", arrival_t=past))
        assert eng.metrics()["deadline_shed"] == 1
        # standard tier has no default here: the same staleness admits
        eng.submit(_req(tier="standard", arrival_t=past)).result(WAIT)
    finally:
        eng.shutdown()


def test_tiered_shed_displaces_bulk_victim():
    """Queue at capacity with bulk work: an interactive arrival sheds the
    worst bulk victim (ShedError into ITS future) and is itself admitted."""
    eng = _SleepEngine(n_workers=0, name="t", max_pending=4,
                       shed_policy="tiered",
                       slo_tier_defaults={"interactive": 5.0, "bulk": 50.0})
    try:
        bulk_futs = [eng.submit(_req(tier="bulk")) for _ in range(4)]
        int_fut = eng.submit(_req(tier="interactive"))
        shed = [f for f in bulk_futs if f.done()]
        assert len(shed) == 1 and shed[0] is bulk_futs[-1]
        with pytest.raises(ShedError, match="displaced"):
            shed[0].result()
        assert not int_fut.done()
        m = eng.metrics()
        assert m["shed_bulk"] == 1 and m["shed_total"] == 1
    finally:
        eng.shutdown()


def test_tiered_shed_rejects_incoming_when_it_is_lowest():
    """Queue full of interactive work: a bulk arrival IS the lowest-value
    work in sight and is shed at admission instead of displacing anyone."""
    eng = _SleepEngine(n_workers=0, name="t", max_pending=4,
                       shed_policy="tiered",
                       slo_tier_defaults={"interactive": 5.0, "bulk": 50.0})
    try:
        int_futs = [eng.submit(_req(tier="interactive")) for _ in range(4)]
        with pytest.raises(ShedError, match="no lower-priority victim"):
            eng.submit(_req(tier="bulk"))
        assert not any(f.done() for f in int_futs)
        assert eng.metrics()["shed_bulk"] == 1
    finally:
        eng.shutdown()


def test_retry_after_hint_on_shed_and_queue_full():
    """Rejections price their own backoff: both shed flavours (displaced
    victim and at-admission) and a plain full queue carry a positive
    ``retry_after_s`` once one service time has been observed.  The one
    worker is held on a gate while the queue fills, so which request is
    shed does not depend on timing."""
    gate, started = threading.Event(), threading.Event()
    eng = _SleepEngine(n_workers=1, name="t", max_pending=2, gate=gate,
                       started=started, shed_policy="tiered",
                       slo_tier_defaults={"interactive": 5.0, "bulk": 50.0})
    try:
        gate.set()
        eng.submit(_req(tier="bulk")).result(WAIT)         # warm the EWMA
        gate.clear()
        started.clear()
        held = eng.submit(_req(tier="bulk"))
        assert started.wait(WAIT)                          # in service
        futs = [eng.submit(_req(tier="bulk")) for _ in range(2)]
        with pytest.raises(ShedError, match="at admission") as ei:
            eng.submit(_req(tier="bulk"))                  # incoming shed
        assert ei.value.retry_after_s > 0
        int_fut = eng.submit(_req(tier="interactive"))     # displaces one
        assert futs[1].done() and not futs[0].done()
        with pytest.raises(ShedError, match="displaced") as ei:
            futs[1].result()
        assert ei.value.retry_after_s > 0
        gate.set()
        for f in (held, futs[0], int_fut):
            f.result(WAIT)
    finally:
        gate.set()
        eng.shutdown()
    # shed_policy="none": the plain full-queue path prices the same hint
    gate, started = threading.Event(), threading.Event()
    eng = _SleepEngine(n_workers=1, name="t", max_pending=1, gate=gate,
                       started=started)
    try:
        gate.set()
        eng.submit(_req()).result(WAIT)
        gate.clear()
        started.clear()
        eng.submit(_req())
        assert started.wait(WAIT)
        eng.submit(_req())                                 # fills the queue
        with pytest.raises(RejectedError) as ei:
            eng.submit(_req(), timeout=0)
        assert ei.value.retry_after_s is not None
        assert ei.value.retry_after_s > 0
    finally:
        gate.set()
        eng.shutdown()


def test_run_workload_async_surfaces_retry_hints():
    """The workload runner aggregates backoff hints: an overloaded engine
    driven with ``tolerate_errors=True`` reports how many rejections were
    priced and their mean, instead of raising."""
    eng = _SleepEngine(service_s=0.05, n_workers=1, name="t", max_pending=2,
                       shed_policy="tiered",
                       slo_tier_defaults={"standard": 30.0})
    try:
        eng.submit(_req()).result(WAIT)                    # warm the EWMA
        reqs = [{"history": np.arange(8, dtype=np.int32),
                 "candidates": np.arange(4, dtype=np.int32)}
                for _ in range(12)]
        res = run_workload_async(eng, reqs, tolerate_errors=True)
        assert res["rejected"] + res["failed"] > 0 and res["hung"] == 0
        assert res["retry_after_hinted"] > 0
        assert res["retry_after_mean_ms"] > 0
    finally:
        eng.shutdown()


def test_edf_beats_fifo_on_interactive_goodput():
    """A burst of bulk work ahead of a few interactive requests, queued
    while the one worker is held: FIFO serves the bulk first and strands
    the interactive tail past its SLO; EDF serves it first."""
    slo = {"interactive": 0.5, "bulk": 30.0}

    def run(admission):
        gate, started = threading.Event(), threading.Event()
        eng = _SleepEngine(service_s=0.05, n_workers=1, name=admission,
                           max_pending=64, admission=admission,
                           slo_tier_defaults=slo, gate=gate,
                           started=started)
        try:
            futs = [eng.submit(_req(tier="bulk"))]
            assert started.wait(WAIT)
            futs += [eng.submit(_req(tier="bulk")) for _ in range(15)]
            ints = [eng.submit(_req(tier="interactive")) for _ in range(4)]
            gate.set()
            for f in futs + ints:
                f.result(WAIT)
            order = [eng.served.index(f.request.request_id) for f in ints]
            return order, eng.metrics().get("goodput_interactive", 0)
        finally:
            gate.set()
            eng.shutdown()

    (fifo_order, fifo), (edf_order, edf) = run("fifo"), run("edf")
    assert edf_order == [1, 2, 3, 4] and fifo_order == [16, 17, 18, 19]
    # FIFO serves 16 x 50 ms of bulk first: the 500 ms SLO is out of
    # reach; EDF's worst case is one bulk plus four interactive
    assert edf == 4 and fifo == 0


def test_watchdog_fails_stuck_future():
    """No worker ever serves (n_workers=0): the watchdog fails the future
    grace past its deadline — no request ever hangs.  A sweep at an
    explicit time fails exactly the futures past deadline + grace."""
    eng = _SleepEngine(n_workers=0, name="t", watchdog_grace_s=0.02,
                       slo_tier_defaults={"standard": 0.02})
    try:
        fut = eng.submit(_req())
        with pytest.raises(WatchdogTimeout, match="unresolved"):
            fut.result(WAIT)
        assert eng.metrics()["watchdog_timeouts"] == 1
        t0 = time.perf_counter()
        late = eng.submit(_req(arrival_t=t0, deadline=10.0))
        assert eng._watchdog_sweep(t0 + 10.01) == 0 and not late.done()
        assert eng._watchdog_sweep(t0 + 10.03) == 1
        with pytest.raises(WatchdogTimeout):
            late.result(0)
    finally:
        eng.shutdown()


def test_degradation_policy_ladder_reversible():
    pol = DegradationPolicy(threshold_s=0.01, dwell_s=0.0, alpha=1.0)
    assert pol.level == 0
    for want in (1, 2, 3):
        assert pol.observe(1.0) == want
    assert pol.observe(1.0) == 3          # clamped at max_level
    for want in (2, 1, 0):
        assert pol.observe(0.0) == want   # full recovery
    # hysteresis band: between recover (0.005) and threshold (0.01) holds
    pol.observe(1.0)
    assert pol.observe(0.008) == 1


def test_degradation_dwell_rate_limits_steps():
    pol = DegradationPolicy(threshold_s=0.01, dwell_s=10.0, alpha=1.0)
    assert pol.observe(1.0, now=100.0) == 1
    assert pol.observe(1.0, now=100.1) == 1    # inside dwell: no step
    assert pol.observe(1.0, now=111.0) == 2


def test_concurrent_submitters_never_hang():
    """N submitter threads push far past queue capacity against slow
    workers + shedding + watchdog.  Every submission terminates — a
    result, a RejectedError, or a WatchdogTimeout; nothing hangs."""
    eng = _SleepEngine(service_s=0.002, n_workers=2, name="stress",
                       max_pending=8, shed_policy="tiered",
                       watchdog_grace_s=1.0,
                       slo_tier_defaults={"interactive": 0.5,
                                          "standard": 2.0, "bulk": 5.0})
    outcomes = {"ok": 0, "rejected": 0, "failed": 0}
    lock = threading.Lock()
    tiers = ("interactive", "standard", "bulk")

    def submitter(i):
        for j in range(20):
            try:
                fut = eng.submit(_req(tier=tiers[(i + j) % 3]), timeout=10.0)
                fut.result(WAIT)
                k = "ok"
            except RejectedError:
                k = "rejected"
            except Exception:  # noqa: BLE001 — counted, not raised
                k = "failed"
            with lock:
                outcomes[k] += 1

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * WAIT)
        assert not any(t.is_alive() for t in threads), \
            f"submitters hung: {outcomes}"
        assert sum(outcomes.values()) == 6 * 20
        assert outcomes["ok"] > 0
    finally:
        eng.shutdown()


def test_shutdown_fails_queued_futures():
    eng = _SleepEngine(n_workers=0, name="t")
    futs = [eng.submit(_req()) for _ in range(3)]
    eng.shutdown()
    for f in futs:
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(5)


# ---------------------------------------------------------------------------
# 3b. the port of tests/test_overload.py, layers 2 and 3: FlameEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def climber_setup():
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=10_000, d_model=64, d_ff=128,
        n_heads=2, n_kv_heads=2, head_dim=32,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    params = C.climber_init(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, C.build_climber(cfg), params


def _flame(bundle, params, **kw):
    base = dict(n_history=64, buckets=(32, 16), n_streams=2,
                feature_mode="off",
                store=RemoteFeatureStore(latency_s=0.0, feature_dim=12),
                window_s=0.02, coalesce=True, max_batch=4, n_workers=4,
                device="cpu")
    base.update(kw)
    return create_engine("flame", bundle, params, **base)


def _traffic(n, seed=0, users=None, m=16):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = {"history": rng.integers(0, 1000, 64).astype(np.int32),
             "candidates": rng.integers(0, 1000, m).astype(np.int32)}
        if users:
            r["user_id"] = i % users
        out.append(r)
    return out


def test_fatal_dispatch_fault_fails_all_riders_with_traceback(climber_setup):
    """One poisoned dispatch fails every rider coalesced into that batch,
    each seeing the original exception with its traceback rooted in the
    fault hook; the engine serves normally afterwards.  The window is long
    enough that the four hits fill one dispatch (the fill target), and one
    dispatcher collects them all."""
    _, bundle, params = climber_setup
    eng = _flame(bundle, params, buckets=(16,), window_s=2.0, n_streams=1)
    try:
        reqs = _traffic(4, seed=1)
        run_workload_async(eng, reqs)      # warm: every user pooled
        inj = FaultInjector(dispatch_p=1.0, dispatch_times=1,
                            dispatch_transient=False, seed=0)
        eng._faults = inj
        eng.dso._fault_hook = inj.dispatch
        futs = [eng.submit(ServeRequest(history=r["history"],
                                        candidates=r["candidates"]))
                for r in reqs]
        errors = []
        for f in futs:
            try:
                f.result(WAIT)
            except FaultInjected as e:
                errors.append(e)
        assert len(errors) == 4, "the poisoned batch carried co-riders"
        for e in errors:
            assert "injected dispatch failure" in str(e)
            frames = []
            tb = e.__traceback__
            while tb is not None:
                frames.append(tb.tb_frame.f_code.co_filename)
                tb = tb.tb_next
            assert any(f.endswith("faults.py") for f in frames), \
                "rider lost the original traceback"
        assert run_workload_async(eng, reqs)["resolved"] == 4
        assert eng.metrics()["dso_dispatch_failures"] == 1
    finally:
        eng.shutdown()


def test_transient_dispatch_fault_retried_to_success(climber_setup):
    _, bundle, params = climber_setup
    inj = FaultInjector(dispatch_p=1.0, dispatch_times=2,
                        dispatch_transient=True, seed=0)
    eng = _flame(bundle, params, buckets=(16,), faults=inj,
                 dispatch_retries=3)
    try:
        out = run_workload_async(eng, _traffic(4, seed=2))
        assert out["resolved"] == 4
        m = eng.metrics()
        assert m["fault_dispatch_fired"] == 2
        assert m["dso_dispatch_retries"] >= 2
        assert m["dso_dispatch_failures"] == 0
    finally:
        eng.shutdown()


class _WatchedFuture(Future):
    """A Future that says when someone starts waiting on it."""

    def __init__(self):
        super().__init__()
        self.waiting = threading.Event()

    def result(self, timeout=None):
        self.waiting.set()
        return super().result(timeout)


def test_single_flight_encode_recovery(climber_setup):
    """A follower coalesced behind a dead encode leader recovers: it
    re-enters, becomes the new leader, and serves — counting
    ``encode_recoveries`` — instead of inheriting the leader's failure."""
    _, bundle, params = climber_setup
    eng = _flame(bundle, params, pool_slots=8)
    try:
        req = ServeRequest(history=np.arange(64).astype(np.int32),
                           candidates=np.arange(16).astype(np.int32),
                           user_id=7)
        key_fp = eng._pool_key(req)
        hist = np.asarray(req.history[None, :eng.n_history], np.int32)
        # play the doomed leader by hand: register an in-flight encode, let
        # a follower block on it, then die (deregister + fail)
        doomed = _WatchedFuture()
        with eng._encode_lock:
            eng._encode_inflight[key_fp] = doomed
        result = {}

        def follower():
            result["kv"], result["path"], _ = eng._lookup_or_encode(
                req, hist, key_fp, None)

        th = threading.Thread(target=follower)
        th.start()
        assert doomed.waiting.wait(WAIT)   # the follower is in result()
        with eng._encode_lock:
            eng._encode_inflight.pop(key_fp, None)
        doomed.set_exception(FaultInjected("injected encode death",
                                           transient=False))
        th.join(timeout=WAIT)
        assert not th.is_alive()
        assert result["path"] == "encode"  # re-entered as the new leader
        assert eng.metrics()["encode_recoveries"] == 1
        assert eng.submit(req).result(WAIT).output.shape == (16, 3)
    finally:
        eng.shutdown()


def test_eviction_storm_forces_reencode_not_failure(climber_setup):
    _, bundle, params = climber_setup
    eng = _flame(bundle, params, pool_slots=16)
    try:
        reqs = _traffic(6, seed=3, users=3)
        first = run_workload_async(eng, reqs)["outputs"]   # 3 user entries
        inj = FaultInjector(evict_p=1.0, evict_fraction=1.0, seed=0)
        assert inj.pool_storm(eng.history_pool) == 3
        misses0 = eng.metrics()["pool_misses"]
        out = run_workload_async(eng, reqs)
        assert out["resolved"] == 6       # storms cost re-encodes, not errors
        assert eng.metrics()["pool_misses"] > misses0
        for a, b in zip(first, out["outputs"]):
            np.testing.assert_array_equal(a, b)
    finally:
        eng.shutdown()


def test_degrade_level3_bulk_cached_hit_or_shed(climber_setup):
    _, bundle, params = climber_setup
    # recover_s=0.0: the forced level cannot decay while workers feed tiny
    # real queue delays into the policy mid-test
    pol = DegradationPolicy(threshold_s=0.001, recover_s=0.0, dwell_s=0.0,
                            alpha=1.0)
    eng = _flame(bundle, params, pool_slots=8, degradation=pol)

    def req(lo, uid, tier):
        return ServeRequest(
            history=np.arange(lo, lo + 64).astype(np.int32),
            candidates=np.arange(16).astype(np.int32),
            user_id=uid, slo_tier=tier)

    try:
        warm = eng.submit(req(0, 1, "bulk")).result(WAIT).output
        for _ in range(3):
            pol.observe(1.0)               # force level 3
        assert pol.level == 3
        # warm session: served from the pool, no encode dispatch
        encodes = eng.metrics()["dso_dispatches_encode"]
        resp = eng.submit(req(0, 1, "bulk")).result(WAIT)
        np.testing.assert_array_equal(resp.output, warm)
        assert eng.metrics()["dso_dispatches_encode"] == encodes
        # cold session: encode suppressed -> DegradedError, counted
        with pytest.raises(DegradedError, match="level-3"):
            eng.submit(req(100, 2, "bulk")).result(WAIT)
        assert eng.metrics()["degrade_shed"] == 1
        # interactive traffic is untouched at level 3
        resp = eng.submit(req(100, 3, "interactive")).result(WAIT)
        assert resp.output.shape == (16, 3)
        assert eng.metrics()["degrade_level"] == 3
        assert eng.dso._window_override == 0.0     # level >= 1 flushes
    finally:
        eng.shutdown()


def test_per_tier_and_per_family_deadline_miss_breakout(climber_setup):
    """A guaranteed miss lands in both breakout ledgers — per tier on the
    engine, per executor family on the DSO.  The miss is made certain by
    a 10 ms worker stall against a 2 ms budget, not by a timing guess."""
    _, bundle, params = climber_setup
    eng = _flame(bundle, params,
                 faults=FaultInjector(stall_p=1.0, stall_s=0.01, seed=0))
    try:
        run_workload_async(eng, _traffic(2, seed=4))   # warm (no deadlines)
        r = _traffic(1, seed=5)[0]
        eng.submit(ServeRequest(history=r["history"],
                                candidates=r["candidates"],
                                slo_tier="interactive",
                                deadline_s=0.002)).result(WAIT)
        m = eng.metrics()
        assert m["deadline_misses"] >= 1
        assert m["deadline_misses_interactive"] >= 1
        assert m["dso_deadline_miss_chunks"] >= 1
        assert any(k.startswith("dso_deadline_miss_chunks_") and v > 0
                   for k, v in m.items())
    finally:
        eng.shutdown()


def test_fault_injector_is_deterministic():
    spec = "dispatch:0.4,stall:0.3:0.001,evict:0.2"

    def schedule(seed):
        inj = FaultInjector.parse(spec, seed=seed)
        fired = []
        for _ in range(32):
            try:
                inj.dispatch("full", 16)
                fired.append(0)
            except FaultInjected:
                fired.append(1)
        return fired, inj.stats()

    a, sa = schedule(seed=9)
    b, sb = schedule(seed=9)
    assert a == b and sa == sb and sum(a) > 0
    c, _ = schedule(seed=10)
    assert a != c                      # the seed is the schedule


def test_chaos_mixed_arms_zero_hung_futures(climber_setup):
    """The liveness gate at test scale: dispatch faults + stalls + eviction
    storms + shedding + degradation + watchdog + the spill tier; every
    future resolves."""
    _, bundle, params = climber_setup
    inj = FaultInjector.parse("dispatch:0.2,stall:0.15:0.002,evict:0.15",
                              seed=5)
    eng = _flame(bundle, params, pool_slots=2, pool_spill_bytes=1 << 24,
                 max_pending=8, shed_policy="tiered", faults=inj,
                 degradation=DegradationPolicy(threshold_s=0.05),
                 watchdog_grace_s=2.0,
                 slo_tier_defaults={"interactive": 0.5, "standard": 2.0,
                                    "bulk": 10.0})
    try:
        reqs = _traffic(12, seed=6, users=4)
        tiers = ("interactive", "standard", "bulk")
        for i, r in enumerate(reqs):
            r["slo_tier"] = tiers[i % 3]
        total = {"resolved": 0, "rejected": 0, "failed": 0, "hung": 0}
        for _ in range(2):
            out = run_workload_async(eng, reqs, tolerate_errors=True,
                                     result_timeout_s=WAIT)
            for k in total:
                total[k] += out[k]
        assert total["hung"] == 0, f"liveness violated: {total}"
        assert total["resolved"] + total["rejected"] + total["failed"] \
            == 2 * len(reqs)
        assert total["resolved"] > 0
        m = eng.metrics()
        assert m["fault_dispatch_fired"] + m["fault_stall_fired"] \
            + m["fault_evict_fired"] > 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# 3c. the DSO's retry and window override
# ---------------------------------------------------------------------------

def _orch(hook=None, retries=2, window_s=0.0, max_batch=1):
    calls = []

    def build(kind, bucket, batch):
        def fn(x):
            calls.append(1)
            return x * 2
        return DSO.Executor(fn, [TensorSpec((batch, bucket), torch.float32)],
                            "cpu")

    orch = DSO.CoalescingOrchestrator(
        build, pad_slice_fn=lambda req, c, kind: (req,),
        gather_fn=lambda rows, cs, m, kind: rows[0],
        families={"x": (4,)}, n_streams=1, fault_hook=hook,
        dispatch_retries=retries, retry_backoff_s=0.0,
        policy=DSO.CoalescePolicy(max_batch=max_batch, window_s=window_s))
    return orch, calls


def test_dispatch_retry_replays_once_per_success():
    """Transient faults fire before the executor stages anything: a
    retried dispatch runs the executor once, with the batch's own rows;
    a fatal fault or an exhausted budget fails the rider with the
    original exception."""
    x = np.full((1, 4), 3, np.float32)
    inj = FaultInjector(dispatch_p=1.0, dispatch_times=2, seed=0)
    orch, calls = _orch(inj.dispatch, retries=2)
    try:
        np.testing.assert_array_equal(orch.score(x, 4, kind="x"), x * 2)
        st = orch.stats()
        assert st["dispatch_retries"] == 2 and len(calls) == 1
        assert orch.executors[("x", 4)][0].calls == 1
    finally:
        orch.shutdown()
    inj = FaultInjector(dispatch_p=1.0, dispatch_times=3, seed=0)
    orch, calls = _orch(inj.dispatch, retries=2)
    try:
        with pytest.raises(FaultInjected) as ei:
            orch.score(x, 4, kind="x")
        assert ei.value.transient and not calls
        assert orch.stats()["dispatch_failures"] == 1
        np.testing.assert_array_equal(orch.score(x, 4, kind="x"), x * 2)
    finally:
        orch.shutdown()
    inj = FaultInjector(dispatch_p=1.0, dispatch_times=1,
                        dispatch_transient=False, seed=0)
    orch, calls = _orch(inj.dispatch, retries=5)
    try:
        with pytest.raises(FaultInjected):
            orch.score(x, 4, kind="x")
        assert orch.stats()["dispatch_retries"] == 0 and not calls
    finally:
        orch.shutdown()


def test_window_override_caps_the_coalescing_window():
    """A lone chunk waits the policy's window for co-riders; under the
    degradation override (0.0) it flushes at once; ``None`` restores."""
    x = np.ones((1, 4), np.float32)
    orch, _ = _orch(window_s=30.0, max_batch=2)
    try:
        orch.set_window_override(0.0)
        t0 = time.perf_counter()
        orch.score(x, 4, kind="x")
        assert time.perf_counter() - t0 < 10.0
        orch.set_window_override(None)
        fut = orch.submit(x, 4, kind="x")
        done = threading.Event()
        th = threading.Thread(target=lambda: (fut.result(), done.set()))
        th.start()
        assert not done.wait(0.2)          # held by the 30 s window
        orch.submit(x, 4, kind="x").result()   # the co-rider fills it
        assert done.wait(WAIT)
        th.join(WAIT)
    finally:
        orch.shutdown()


def test_launcher_takes_the_overload_flags(capsys):
    """The JAX launcher's eight overload flags on the CPU: the run counts
    rejected and failed requests instead of raising, and hangs none."""
    from repro_torch.launch import serve as launcher
    launcher.main([
        "--device", "cpu", "--requests", "12", "--history", "16",
        "--d-model", "32", "--buckets", "8,4", "--counts", "4,8",
        "--users", "4", "--pool-slots", "2", "--pool-spill-mb", "1",
        "--fault-spec", "dispatch:0.3,evict:0.2", "--fault-seed", "3",
        "--shed-policy", "tiered", "--degrade", "5",
        "--slo-mix", "interactive=0.2,standard=0.5,bulk=0.3",
        "--slo-tier-defaults", "interactive=5000,standard=10000,bulk=20000",
        "--watchdog-grace-ms", "30000", "--concurrency", "2"])
    out = capsys.readouterr().out
    assert "spill tier 1 MB" in out and "hung=0" in out
    assert "fault_dispatch_fired=" in out and "pool_spill_hits=" in out
    with pytest.raises(SystemExit, match="bad --slo-mix"):
        launcher.main(["--device", "cpu", "--slo-mix", "bulk"])
