"""The serving engines behind the API v2 surface.  Port of
``repro/serving/engine.py``: ``FlameEngine`` with the history-KV pool on
(scoring and generation) or off (the monolithic ``full`` family), under
``impl="fused"``, ``"pallas"``, ``"chunked"`` or ``"reference"``;
``ImplicitShapeServingEngine`` (registered as ``"implicit"``), the
paper's Table 5 "Default" baseline; and ``TextServingEngine`` (registered
as ``"text"``), greedy generation for a text decoder (rwkv6-7b, kernel K5
on its prefill).

  submit() --> bounded EDF admission queue (backpressure)
           --> PDA feature prefetch (fire-and-forget cache warm)
           --> worker threads: pool lookup -> (miss: single-flight encode)
               -> coalesced candidate scoring -> ResponseFuture

Executor families (``CoalescingOrchestrator``, fixed shapes per
``(kind, bucket)``; on the card each dispatcher's executor is a CUDA graph
captured at construction, with a stream of its own).  Every family speaks
the pool's RAW stored
representation (int8/bf16 values + per-(layer, head) scales, or native
tensors): the ``encode`` epilogue quantizes to it, the pool keeps it as is,
and the other families read it — kernel K1 in-kernel under ``"fused"``, a
dequantize with the pool's own formula (bitwise the pool's dequantizing
lookup) under the framework impls.  One representation on every path is
what makes a user's hit bitwise its miss, and a replayed beam bitwise the
parked one, under a lossy pool too.

  ("full", M-bucket)     (``history_cache=False``) the monolithic SUMI pass
                         over history and candidates, no pool; attention
                         runs K2 under fused and pallas, the FFN K3 under
                         pallas
  ("encode", n_history)  history encode on a pool miss; attention runs
                         kernel K2 (``kernels/flash_attention``) under fused
                         and pallas, the FFN kernel K3 (``kernels/fused_ffn``)
                         under pallas
  ("cached", M-bucket)   candidate-only scoring against pooled rows plus the
                         dedup row index; attention runs K1 under fused, K2
                         under pallas (dequantize, gather, concatenate)
  ("extend", prefix)     (``incremental_history``) a stale hit's refresh:
                         window positions >= the trusted prefix plus the side
                         token re-encode against the dropped entry's rows
                         (raw leaves in, dequantized in the graph; the
                         pool's stored representation out); attention runs
                         K1's extend mode under fused (K2 where a block's
                         prefix is empty), K2 under pallas
  ("decode", M-bucket)   one generative step: a beam's token universe scored
                         against its padded beam cache, whose valid length
                         rides with the deduped rows; attention runs K1 with
                         its ``lengths`` bound under fused, kernel K4
                         (``kernels/flash_decode``) under pallas
  ("append", 1)          the chosen token's K/V written into a beam cache
                         (quantized against the root's fixed scales in an
                         int8 pool); the same layer chain as decode

With ``pack_tails`` the ``cached`` and ``decode`` families are segment-
packed (``core/dso.py::SegmentPacker``): the tail chunks of different
requests share ``pack_rows`` rows of a bucket, each candidate steered to
its own user's stacked rows by a ``[rows, bucket]`` index that K1 (fused),
K4's self-slot form (pallas ``decode``) and the framework routes take.

``impl="chunked"`` is the JAX package's framework impl, chosen by name:
plain PyTorch on every family (``models/attention.py::chunked_attention``
past 256 x 256 scores), no kernel on the card.  The one option of the JAX
engine not served, ``mesh``, raises ``NotImplementedError`` naming its
ROADMAP.md item.  Overload and faults (tiered shedding, the degradation
ladder, the watchdog, dispatch retry, the pool's spill tier, chaos
injection from ``serving/faults.py``) take the JAX engine's options and
meanings.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dso as DSO
from repro_torch.core import pda as PDA
from repro_torch.core.climber import N_SIDE_FEATURES
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import attention as A
from repro_torch.models.transformer import dense_ffn_layers
from repro_torch.serving import generate as G
from repro_torch.serving.api import (SLO_TIERS, TIER_RANK, AdmissionQueueFull,
                                     BeamConfig, DeadlineExceeded,
                                     DegradedError, ResponseFuture,
                                     ServeMetrics, ServeRequest,
                                     ServeResponse, ShedError, TopKConfig,
                                     WatchdogTimeout, register_engine)
from repro_torch.serving.kv_cache import (HistoryKVPool, KVCacheManager,
                                          quantize_kv_graph, raw_kv_specs)
from repro_torch.tree import leaves, structure, unflatten
from repro_torch.types import TensorSpec

#: per-tier flush-window multipliers handed to ``CoalescePolicy``
_TIER_WINDOW_SCALE = {"interactive": 0.25, "standard": 1.0, "bulk": 2.0}

#: service-time EWMA smoothing for admission-time wait prediction
_SERVICE_EWMA = 0.3

#: executor kinds whose outputs stay on the device: the pool keeps encode's
#: and extend's, parked beams append's (every other kind's go to the host)
_DEVICE_OUTPUT_KINDS = ("encode", "extend", "append")


def _check_params_device(params, device: torch.device, move_with: str):
    """Entry points never move weights: ``params`` must be on ``device``."""
    emb = params["embed"]["embedding"]
    if emb.device != device:
        raise ValueError(f"params are on {emb.device}, the engine on "
                         f"{device}: move them first ({move_with})")


def _try_fail(fut: ResponseFuture, exc: BaseException) -> bool:
    """Best-effort set_exception (the future may already be resolved)."""
    try:
        fut.set_exception(exc)
        return True
    except Exception:  # InvalidStateError — already resolved, fine
        return False


class _AdmissionRecord:
    """One queued submission: the priority key, the request's future, its
    submit timestamp, and the SLO / deadline facts shedding reads."""

    __slots__ = ("key", "fut", "t_submit", "tier", "deadline_abs", "shed")

    def __init__(self, key: tuple, fut: ResponseFuture, t_submit: float,
                 tier: str, deadline_abs: Optional[float]):
        self.key = key
        self.fut = fut
        self.t_submit = t_submit
        self.tier = tier
        self.deadline_abs = deadline_abs
        self.shed = False              # lazy-deletion marker (shed_victim)


class _AdmissionQueue:
    """Bounded deadline-ordered (EDF) admission queue with tiered shedding.
    Records pop in ``(absolute deadline | inf, tier rank, seq)`` order under
    ``edf`` or in arrival order under ``fifo``.  Shedding removes a queued
    victim lazily: ``shed_victim`` marks the worst strictly-lower-priority
    record and frees its capacity slot (``_live`` counts unshed records);
    ``get`` skips marked records when they surface at the heap root.
    ``close()`` is the stop signal: getters return ``None`` and blocked
    putters raise; ``drain()`` hands shutdown the leftovers to fail."""

    def __init__(self, maxsize: int, mode: str = "edf"):
        if mode not in ("edf", "fifo"):
            raise ValueError(f"admission mode must be edf|fifo, got {mode!r}")
        self.maxsize = maxsize
        self.mode = mode
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._heap: List[Tuple[tuple, _AdmissionRecord]] = []
        self._seq = itertools.count()
        self._live = 0                 # unshed records (capacity accounting)
        self._closed = False

    def key_for(self, deadline_abs: Optional[float], tier: str) -> tuple:
        if self.mode == "fifo":
            return (next(self._seq),)
        return (deadline_abs if deadline_abs is not None else math.inf,
                TIER_RANK.get(tier, 1), next(self._seq))

    def put(self, rec: _AdmissionRecord, timeout: Optional[float] = None):
        """Enqueue; blocks while at capacity (``timeout=0`` = non-blocking).
        Raises ``queue.Full`` past the timeout and ``RuntimeError`` when
        closed."""
        with self._not_full:
            end = None if timeout is None else time.perf_counter() + timeout
            while self._live >= self.maxsize and not self._closed:
                left = None if end is None else end - time.perf_counter()
                if left is not None and left <= 0:
                    raise queue.Full
                self._not_full.wait(timeout=left)
            if self._closed:
                raise RuntimeError("admission queue closed")
            heapq.heappush(self._heap, (rec.key, rec))
            self._live += 1
            self._not_empty.notify()

    def get(self) -> Optional[_AdmissionRecord]:
        """Pop the best live record (blocking); ``None`` once closed."""
        with self._not_empty:
            while True:
                while self._heap and self._heap[0][1].shed:
                    heapq.heappop(self._heap)      # lazily deleted victims
                if self._closed:
                    return None
                if self._heap:
                    _, rec = heapq.heappop(self._heap)
                    self._live -= 1
                    self._not_full.notify()
                    return rec
                self._not_empty.wait()

    def shed_victim(self, key: tuple) -> Optional[_AdmissionRecord]:
        """Mark and return the worst queued record strictly lower-priority
        than ``key`` (latest deadline, lowest tier), or ``None`` when
        everything queued outranks the caller.  O(n): the queue is bounded
        and shedding runs only under overload."""
        with self._lock:
            worst: Optional[_AdmissionRecord] = None
            for _, rec in self._heap:
                if not rec.shed and rec.key > key \
                        and (worst is None or rec.key > worst.key):
                    worst = rec
            if worst is None:
                return None
            worst.shed = True
            self._live -= 1
            self._not_full.notify()
            return worst

    def qsize(self) -> int:
        with self._lock:
            return self._live

    def close(self):
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def drain(self) -> List[_AdmissionRecord]:
        """Every remaining live record (shutdown fails them)."""
        with self._lock:
            out = [rec for _, rec in self._heap if not rec.shed]
            self._heap.clear()
            self._live = 0
            return out


class _PipelinedEngine:
    """API v2 pipeline scaffolding: ``submit`` admits into the bounded EDF
    queue (a timeout raises :class:`AdmissionQueueFull`); ``n_workers``
    threads drain it and run the engine-specific ``_execute``.  Subclasses
    finish their own setup before calling ``__init__`` here — workers start
    immediately.  ``slo_tier_defaults`` maps a tier to a default deadline
    budget (seconds) for requests that carry none.

    Overload discipline (all off by default):

    * ``shed_policy="tiered"``: when the queue is at depth or the
      EWMA-predicted wait blows the incoming request's budget, the worst
      strictly-lower-priority queued record is failed with
      :class:`ShedError` (or the incoming request itself when nothing
      queued ranks below it); both carry ``retry_after_s``.
    * ``watchdog_grace_s > 0`` starts a watchdog thread that fails any
      future still unresolved ``grace`` past its deadline with
      :class:`WatchdogTimeout` (``watchdog_timeouts``); a worker that
      finishes later finds the future resolved and drops its result.
    * ``degradation`` (a :class:`DegradationPolicy`) observes every
      request's queue delay from the workers; a level change sets the
      ``degrade_level`` gauge, counts ``degrade_steps`` and calls the
      ``_on_degrade`` hook.
    * ``faults`` (a :class:`FaultInjector`) arms the worker-stall hook
      here; subclasses wire its dispatch and pool arms."""

    def __init__(self, *, max_pending: int = 64, n_workers: int = 4,
                 name: str = "engine", admission: str = "edf",
                 shed_policy: str = "none",
                 slo_tier_defaults: Optional[Dict[str, float]] = None,
                 watchdog_grace_s: float = 0.0, degradation=None,
                 faults=None):
        self._deadline_s = getattr(self, "_deadline_s", 0.0)
        if shed_policy not in ("none", "tiered"):
            raise ValueError(
                f"shed_policy must be none|tiered, got {shed_policy!r}")
        if slo_tier_defaults is not None:
            bad = set(slo_tier_defaults) - set(SLO_TIERS)
            if bad:
                raise ValueError(f"unknown SLO tiers in defaults: {bad}")
        self._metrics = ServeMetrics()
        self._admission = _AdmissionQueue(max_pending, mode=admission)
        self._shed = shed_policy == "tiered"
        self._tier_defaults = dict(slo_tier_defaults) \
            if slo_tier_defaults else None
        self._degradation = degradation
        self._degrade_applied = 0
        self._faults = faults
        self._ewma_lock = threading.Lock()
        self._service_ewma_s: Optional[float] = None
        self._n_workers = max(int(n_workers), 1)
        self._open = True
        self._workers: List[threading.Thread] = []
        # n_workers=0 admits without serving (the shedding and watchdog
        # tests' stuck engine); predictions still divide by at least one
        for i in range(int(n_workers)):
            th = threading.Thread(target=self._worker_loop,
                                  name=f"{name}-worker-{i}", daemon=True)
            th.start()
            self._workers.append(th)
        self._watchdog_grace_s = float(watchdog_grace_s)
        self._watchdog_stop = threading.Event()
        self._watchdog_lock = threading.Lock()
        self._watchdog_futs: Dict[int, Tuple[ResponseFuture, float]] = {}
        self._watchdog_th: Optional[threading.Thread] = None
        if self._watchdog_grace_s > 0:
            self._watchdog_th = threading.Thread(
                target=self._watchdog_loop, name=f"{name}-watchdog",
                daemon=True)
            self._watchdog_th.start()

    # ---- engine-specific hooks ----
    def _execute(self, request: ServeRequest):
        raise NotImplementedError

    def _admit_hook(self, request: ServeRequest):
        """Called on the caller's thread at submit time."""

    def _extra_metrics(self) -> Dict[str, float]:
        return {}

    def _close(self):
        """Engine-specific teardown after the workers have stopped."""

    def _on_degrade(self, level: int):
        """Engine-specific degradation effects; called on a worker thread
        whenever the applied level changes."""

    # ---- ServingEngine protocol ----
    def _effective_deadline(self, req: ServeRequest) -> float:
        if req.deadline_s is not None:
            return req.deadline_s
        if self._tier_defaults is not None \
                and req.slo_tier in self._tier_defaults:
            return self._tier_defaults[req.slo_tier]
        return self._deadline_s

    def _predicted_wait_s(self, depth: int) -> float:
        with self._ewma_lock:
            s = self._service_ewma_s
        return 0.0 if s is None else depth * s / self._n_workers

    def _shed_for(self, rec: _AdmissionRecord):
        """Tiered admission-time shedding: under overload (queue at depth,
        or predicted wait past the incoming budget) drop the lowest-value
        work in sight — a strictly worse queued victim if one exists, else
        the incoming request itself (raises :class:`ShedError`)."""
        depth = self._admission.qsize()
        overloaded = depth >= self._admission.maxsize
        if not overloaded and rec.deadline_abs is not None:
            overloaded = time.perf_counter() + self._predicted_wait_s(depth) \
                > rec.deadline_abs
        if not overloaded:
            return
        # a shed caller should back off for about one drain interval: the
        # service-time EWMA that detected the overload prices the hint
        retry_after_s = self._predicted_wait_s(depth)
        victim = self._admission.shed_victim(rec.key)
        if victim is not None:
            err = ShedError(
                f"request {victim.fut.request.request_id} ({victim.tier}) "
                f"shed: displaced by a higher-priority arrival under "
                f"overload")
            err.retry_after_s = retry_after_s
            if _try_fail(victim.fut, err):
                self._metrics.incr(f"shed_{victim.tier}")
                self._metrics.incr("shed_total")
            return
        # nothing queued ranks below the incoming request: it is the
        # lowest-value work, shed before it takes a queue slot
        self._metrics.incr(f"shed_{rec.tier}")
        self._metrics.incr("shed_total")
        err = ShedError(
            f"request {rec.fut.request.request_id} ({rec.tier}) shed at "
            f"admission: queue overloaded and no lower-priority victim")
        err.retry_after_s = retry_after_s
        raise err

    def submit(self, request: ServeRequest, *,
               timeout: Optional[float] = None) -> ResponseFuture:
        if not self._open:
            raise RuntimeError("engine is shut down")
        tier = request.slo_tier
        if tier not in TIER_RANK:
            raise ValueError(
                f"request {request.request_id}: unknown slo_tier {tier!r}; "
                f"expected one of {SLO_TIERS}")
        dl = self._effective_deadline(request)
        if dl and time.perf_counter() > request.arrival_t + dl:
            # the latency budget is already blown: reject before the
            # prefetch hook or a queue slot
            self._metrics.incr("deadline_shed")
            raise DeadlineExceeded(
                f"request {request.request_id}: deadline budget "
                f"{dl * 1e3:.3g} ms already exhausted at admission")
        deadline_abs = (request.arrival_t + dl) if dl else None
        fut = ResponseFuture(request)
        self._admit_hook(request)
        rec = _AdmissionRecord(self._admission.key_for(deadline_abs, tier),
                               fut, time.perf_counter(), tier, deadline_abs)
        if self._shed:
            self._shed_for(rec)        # may raise ShedError for ``rec``
        try:
            self._admission.put(rec, timeout=timeout)
        except queue.Full:
            err = AdmissionQueueFull(
                f"admission queue full ({self._admission.maxsize} pending)")
            err.retry_after_s = self._predicted_wait_s(
                self._admission.qsize())
            raise err from None
        except RuntimeError:
            _try_fail(fut, RuntimeError("engine shut down during submit"))
            return fut
        self._watchdog_register(fut, deadline_abs)
        if not self._open:
            _try_fail(fut, RuntimeError("engine shut down during submit"))
        return fut

    def serve(self, history: np.ndarray,
              candidates: Optional[np.ndarray] = None, **kw) -> np.ndarray:
        """Blocking sugar around submit()."""
        req = ServeRequest(
            history=np.asarray(history),
            candidates=None if candidates is None else np.asarray(candidates),
            **kw)
        return self.submit(req).result().output

    def metrics(self) -> Dict[str, float]:
        extra = self._extra_metrics()
        out = self._metrics.summary()
        out["pending"] = self._admission.qsize()
        out.update(extra)
        return out

    def shutdown(self):
        if not self._open:
            return
        self._open = False
        self._admission.close()
        for th in self._workers:
            th.join(timeout=10.0)
        for rec in self._admission.drain():
            _try_fail(rec.fut, RuntimeError("engine shut down"))
        self._watchdog_stop.set()
        if self._watchdog_th is not None:
            self._watchdog_th.join(timeout=5.0)
        self._close()

    # ---- watchdog (liveness backstop under faults) ----
    def _watchdog_register(self, fut: ResponseFuture,
                           deadline_abs: Optional[float]):
        if self._watchdog_th is None or deadline_abs is None:
            return
        with self._watchdog_lock:
            self._watchdog_futs[id(fut)] = (
                fut, deadline_abs + self._watchdog_grace_s)
        fut.add_done_callback(self._watchdog_forget)

    def _watchdog_forget(self, fut):
        with self._watchdog_lock:
            self._watchdog_futs.pop(id(fut), None)

    def _watchdog_sweep(self, now: float) -> int:
        """Fail every registered future past its deadline plus the grace;
        returns how many this sweep failed (a worker may resolve one in the
        same window: only delivered timeouts count)."""
        with self._watchdog_lock:
            due = [fut for fut, t in self._watchdog_futs.values() if now > t]
        grace_ms = self._watchdog_grace_s * 1e3
        n = 0
        for fut in due:
            if _try_fail(fut, WatchdogTimeout(
                    f"request {fut.request.request_id} unresolved "
                    f"{grace_ms:.3g} ms past its deadline")):
                self._metrics.incr("watchdog_timeouts")
                n += 1
        return n

    def _watchdog_loop(self):
        interval = min(max(self._watchdog_grace_s / 2, 0.01), 0.25)
        while not self._watchdog_stop.wait(interval):
            self._watchdog_sweep(time.perf_counter())

    # ---- graceful degradation ----
    def _observe_pressure(self, queue_delay_s: float):
        level = self._degradation.observe(queue_delay_s)
        if level != self._degrade_applied:
            # benign race: concurrent workers converge on the same level
            self._degrade_applied = level
            self._metrics.set_gauge("degrade_level", float(level))
            self._metrics.incr("degrade_steps")
            self._on_degrade(level)

    # ---- worker side ----
    def _worker_loop(self):
        while True:
            rec = self._admission.get()
            if rec is None:            # queue closed: stop signal
                return
            fut, t_submit = rec.fut, rec.t_submit
            t_deq = time.perf_counter()
            req = fut.request
            try:
                if self._faults is not None:
                    self._faults.worker_stall()
                output, timings = self._execute(req)
                t_done = time.perf_counter()
                latency = t_done - t_submit
                timings = {"queue_s": t_deq - t_submit, **timings}
                self._metrics.record(req.m, latency)
                dl = self._effective_deadline(req)
                if dl:
                    if t_done > req.arrival_t + dl:
                        self._metrics.incr("deadline_misses")
                        self._metrics.incr(f"deadline_misses_{rec.tier}")
                    else:
                        self._metrics.incr("deadline_met")
                        self._metrics.incr(f"goodput_{rec.tier}")
                # a future the watchdog already failed raises
                # InvalidStateError here, which the handler below drops: the
                # late result is discarded
                fut.set_result(ServeResponse(req.request_id, output,
                                             latency, timings))
            except Exception as e:  # noqa: BLE001 — surface via the future
                _try_fail(fut, e)
            finally:
                dt = time.perf_counter() - t_deq
                with self._ewma_lock:
                    s = self._service_ewma_s
                    self._service_ewma_s = dt if s is None \
                        else _SERVICE_EWMA * dt + (1 - _SERVICE_EWMA) * s
                if self._degradation is not None:
                    self._observe_pressure(t_deq - t_submit)


class _SideFeatureMixin:
    """PDA in action: fetch item features for the history, aggregate into
    the request's side-feature vector (user-profile style)."""

    def _check_request(self, req: ServeRequest):
        """Reject malformed requests before their chunks reach the shared
        coalescing queue, where a bad shape would fail every co-rider."""
        generative = req.generate is not None
        if not generative and (req.candidates is None
                               or req.candidates.ndim != 1 or req.m < 1):
            raise ValueError(
                f"request {req.request_id}: candidates must be a non-empty "
                f"1-D id array, got "
                f"{None if req.candidates is None else req.candidates.shape}")
        if generative and req.candidates is not None \
                and (req.candidates.ndim != 1 or req.m < 1):
            raise ValueError(
                f"request {req.request_id}: a generative request's "
                f"candidates (its token universe) must be a non-empty 1-D "
                f"id array, got {req.candidates.shape}")
        if req.candidates is not None and int(np.min(req.candidates)) < 0:
            raise ValueError(
                f"request {req.request_id}: candidate ids must be >= 0 "
                f"(negative ids are reserved for chunk-padding sentinels)")
        if req.history.ndim != 1 or req.history.shape[0] < self.n_history:
            raise ValueError(
                f"request {req.request_id}: history must be a 1-D id array "
                f"with >= n_history={self.n_history} entries, got "
                f"{req.history.shape}")

    def _side_features(self, history: np.ndarray) -> np.ndarray:
        feats = self.features.query([int(i) for i in history])
        got = [v for v in feats.values() if v is not None]
        if not got:
            return np.zeros((1, N_SIDE_FEATURES), np.float32)
        return np.mean(got, axis=0, keepdims=True).astype(np.float32)

    def _admit_hook(self, request: ServeRequest):
        self.features.prefetch([int(i) for i in request.history])

    @staticmethod
    def _make_features(feature_mode: str, store, cache_capacity: int,
                       cache_ttl_s: float):
        store = store or PDA.RemoteFeatureStore(feature_dim=N_SIDE_FEATURES)
        cache = None if feature_mode == "off" else PDA.BucketedLRUCache(
            cache_capacity, cache_ttl_s)
        return store, PDA.FeatureQueryEngine(store, cache, mode=feature_mode)


class _Beam:
    """Host-side state of one in-flight hypothesis.  ``leaves`` holds the
    beam's padded cache locally only while the pool has rejected it; the
    steady state is ``leaves is None`` with the cache parked in the
    :class:`HistoryKVPool` under ``pool_key`` / ``pool_fp``."""

    __slots__ = ("tokens", "cum", "finished", "leaves", "pool_key",
                 "pool_fp")

    def __init__(self, tokens, cum, finished=False, leaves=None,
                 pool_key=None, pool_fp=None):
        self.tokens = tokens            # tuple of generated item ids
        self.cum = cum                  # cumulative log-probability
        self.finished = finished
        self.leaves = leaves
        self.pool_key = pool_key
        self.pool_fp = pool_fp


# options of the JAX engine that the port does not serve yet: name -> (the
# value that means "off", where the work stands in ROADMAP.md)
_UNPORTED = {
    "mesh": (None, "sharded serving, Queue 1 item 11"),
}


@register_engine("flame")
class FlameEngine(_SideFeatureMixin, _PipelinedEngine):
    """PDA -> coalescing DSO -> Climber with the history-KV pool, per the
    paper's Fig 1/Fig 4.

    Every request's history encode is keyed into a :class:`HistoryKVPool`
    (by ``request.user_id``, else a content hash of the history); scoring
    always runs the candidate-only ``cached`` executors against the pooled
    K/V.  A hit skips the encode; a miss runs one single-flighted ``encode``
    dispatch, whose epilogue quantizes to the pool's stored representation,
    pools it, and scores from the very same tensors — so a user's hit and
    miss scores are bitwise equal.  Co-batched chunks of one pool entry
    stack its rows once (KV-row dedup) and the executor resolves the row
    index (in K1's history reads under ``"fused"``, as a gather of the
    dequantized rows under the framework impls).

    ``generate`` > 0 adds generative decode (``ServeRequest.generate`` set
    to a :class:`TopKConfig` or :class:`BeamConfig`) with that many steps
    of capacity: a request's pooled history is padded by ``generate``
    slots into its root beam cache; every step scores each live beam's
    token universe (the request's candidates, else ``range(gen_vocab)``)
    in the ``decode`` family, ranks on the host (``serving/generate.py``),
    and grows the surviving beams' caches in the ``append`` family.  Grown
    caches are parked in the pool like user entries (LRU / byte budget);
    a beam whose cache was evicted replays its appends from a re-encoded
    root (``gen_replays``).

    ``incremental_history``: a stale hit (the user's history moved on)
    whose dropped entry encoded a window sharing a prefix with the new one
    re-encodes only the suffix and the side token against the entry's rows,
    in the ``extend`` family, one executor per trusted-prefix bucket
    (``extend_buckets``, default ``(n, 3n/4, n/2)``; buckets below
    ``extend_crossover * n`` are dropped, since such an extension redoes
    most of a re-encode).  Each extension re-quantizes under a lossy pool,
    so after ``extend_refresh_limit`` extensions of one entry (0: no cap)
    the next stale hit re-encodes in full.  Metrics
    ``pool_extensions`` / ``pool_refresh_reencodes``.

    ``pack_tails``: segment-packed ``cached`` and ``decode`` dispatch
    (DSO v2).  The partial tail chunks of different requests pack into
    ``pack_rows`` (default ``max_batch // 4``) shared rows of a bucket, at
    offsets rounded up to ``pack_align`` (default 8 under fused, else 1;
    1 or a multiple of 8), each candidate steered to its own user's KV row
    (``max_batch`` of them a dispatch).  Candidates never see each other
    under SUMI, so a packed request scores as an unpacked one; it reclaims
    the padding the bucket split leaves on ragged traffic
    (``dso_padded_fraction``, ``dso_packed_segments``).

    ``history_cache=False``: the pool-off ``full`` family, the PDA
    baseline.  Every request runs the monolithic SUMI pass over its history
    and candidates (``bundle.prefill``) in one executor per candidate
    bucket, coalesced like ``cached``; side features are prefetched for
    every request.  ``pack_tails`` and ``generate`` need the pool and raise
    without it; ``incremental_history`` is ignored, as in the JAX engine.

    ``kv_dedup``: ``None`` (default) follows the JAX engine's auto rule —
    on for the card and, under fused, on every backend; ``False`` stacks
    each rider's rows in the ``cached`` family with no row index.

    Overload and faults, with the JAX meanings: ``shed_policy="tiered"``,
    ``watchdog_grace_s`` and ``degradation`` (see :class:`_PipelinedEngine`;
    the ladder's effects here: level 1 collapses the DSO's coalescing
    window, level 2 halves bulk-tier generation's width and steps, level 3
    serves bulk-tier scoring from the pool only and fails a miss with
    :class:`DegradedError`); ``faults`` (a :class:`FaultInjector`): its
    ``dispatch`` arm is the DSO's fault hook, retried ``dispatch_retries``
    times when transient, its ``evict`` arm storms the pool at request
    start and between generation rounds (``fault_pool_evictions``), its
    ``stall`` arm stalls workers; ``pool_spill_bytes`` > 0 gives the pool
    its host spill tier (pinned on the card).

    Defaults differ from the JAX engine's (``impl="chunked",
    history_cache=False``): the port's are ``impl="fused",
    history_cache=True``, the configuration that runs its kernels; a
    default that ran no kernel on the card would hide the FKE.  Both of the
    JAX defaults are served when asked for.

    ``device`` (default ``"cuda"``) is where the executors run and, with
    ``pool_placement="device"``, where the pool lives; ``params`` must
    already be there.  With no GPU, ``device="cuda"`` raises.  On the card
    the kernels are built first (``kernel_build_s``), then every (kind,
    bucket, dispatcher) executor is captured as a CUDA graph
    (``dso_graph_capture_s``; ``dso_graph_bytes`` is the device memory
    their construction left reserved), and only then do the threads start;
    on the CPU the executors run eagerly.
    """

    def __init__(self, bundle, params, *, n_history: int,
                 buckets: Sequence[int] = (512, 256, 128),
                 n_streams: int = 2, feature_mode: str = "sync",
                 cache_capacity: int = 50_000, cache_ttl_s: float = 30.0,
                 store: Optional[PDA.RemoteFeatureStore] = None,
                 coalesce: bool = True, max_batch: int = 4,
                 window_s: float = 0.002, max_pending: int = 64,
                 n_workers: int = 4, impl: str = "fused",
                 history_cache: bool = True, pool_slots: int = 256,
                 pool_budget_bytes: Optional[int] = None,
                 pool_dtype: str = "native", pool_placement: str = "device",
                 pool_spill_bytes: int = 0,
                 incremental_history: bool = False,
                 extend_buckets: Optional[Sequence[int]] = None,
                 extend_refresh_limit: int = 0,
                 extend_crossover: float = 0.5, pack_tails: bool = False,
                 pack_rows: Optional[int] = None,
                 pack_align: Optional[int] = None,
                 deadline_s: float = 0.0, mesh=None, generate: int = 0,
                 gen_vocab: int = 256, admission: str = "edf",
                 shed_policy: str = "none",
                 slo_tier_defaults: Optional[Dict[str, float]] = None,
                 watchdog_grace_s: float = 0.0, degradation=None,
                 faults=None, kv_dedup: Optional[bool] = None,
                 dispatch_retries: int = 2, device="cuda"):
        given = dict(mesh=mesh)
        for name, (off, where) in _UNPORTED.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"FlameEngine({name}={given[name]!r}) is not ported yet: "
                    f"ROADMAP.md, {where}")
        A.check_impl(impl)
        if pack_tails and not history_cache:
            raise ValueError(
                "pack_tails=True needs history_cache=True: segment packing "
                "steers each candidate segment to its own user's POOLED "
                "history KV — the monolithic full-pass family has no "
                "per-user KV rows to steer to")
        if generate and not history_cache:
            raise ValueError(
                "generate>0 needs history_cache=True: in-flight beams live "
                "in the HistoryKVPool as growing entries and the decode "
                "step reads pooled history KV as its prompt")
        self.device = resolve_device(device)
        _check_params_device(params, self.device, "core.climber.params_to")
        # build the CUDA kernels now, as the JAX engine compiles its
        # executors at construction: set-up, not the first request, pays it
        self.kernel_build_s = _build.build() if self.device.type == "cuda" \
            else 0.0
        self.bundle = bundle
        self.params = params
        self.cfg = bundle.cfg
        self.n_history = n_history
        self.impl = impl
        self._deadline_s = float(deadline_s)
        self._pack_tails = bool(pack_tails)
        if pack_rows is None and pack_tails:
            # packed rows are dense: a quarter of the row capacity carries
            # the unpacked fill target's candidates on ragged traffic
            pack_rows = max(1, max_batch // 4)
        if pack_align is None:
            pack_align = 8 if (impl == "fused" and pack_tails) else 1
        pack_align = int(pack_align)
        if pack_align > 1 and pack_align % 8:
            raise ValueError(f"pack_align must be 1 (unaligned) or a "
                             f"multiple of 8, got {pack_align}")
        self._extend_buckets: tuple = ()
        self._extend_refresh_limit = int(extend_refresh_limit)
        if incremental_history and history_cache:
            explicit = extend_buckets is not None
            if extend_buckets is None:
                # the tail-append case extends from the full window, mid-
                # window edits from the nearest rung
                extend_buckets = (n_history, 3 * n_history // 4,
                                  n_history // 2)
            # the re-encode-vs-extend crossover: no executor for a rung the
            # routing would never pick
            min_prefix = int(extend_crossover * n_history)
            self._extend_buckets = tuple(sorted(
                {int(b) for b in extend_buckets if b >= max(min_prefix, 1)},
                reverse=True))
            if explicit and not self._extend_buckets:
                raise ValueError(
                    f"extend_buckets {tuple(extend_buckets)} all fall below "
                    f"the re-encode-vs-extend crossover ({min_prefix} = "
                    f"{extend_crossover:g} * n_history); raise the buckets "
                    f"or lower extend_crossover")
            if self._extend_buckets and self._extend_buckets[0] > n_history:
                raise ValueError(f"extend_buckets {self._extend_buckets} "
                                 f"exceed n_history={n_history}")
        self.store, self.features = self._make_features(
            feature_mode, store, cache_capacity, cache_ttl_s)

        self.history_pool: Optional[HistoryKVPool] = None
        self._encode_inflight: Dict[tuple, Future] = {}
        self._encode_lock = threading.Lock()
        self._key_memo: Dict[int, tuple] = {}   # request_id -> (key, fp)
        if history_cache:
            self.history_pool = HistoryKVPool(
                pool_slots, budget_bytes=pool_budget_bytes, dtype=pool_dtype,
                placement=pool_placement, spill_bytes=pool_spill_bytes,
                device=self.device)
            kv_specs = bundle.history_kv_specs(params, n_history, batch=1)
            # every family takes the pool's RAW representation
            cached_specs = raw_kv_specs(kv_specs, pool_dtype)
            self._cached_row_specs = leaves(cached_specs)
            self._cached_struct = structure(cached_specs)
            self._kv_compute_dtype = leaves(kv_specs)[0].dtype
            if kv_dedup is None:
                # the JAX auto rule: on for the card (each deduped row is a
                # staging copy saved), and under fused on every backend (K1
                # and its plain version fold the row index into their
                # history reads)
                kv_dedup = self.device.type == "cuda" or impl == "fused"
        self._kv_dedup = bool(kv_dedup)

        # generative decode: ``generate`` is the per-request capacity in
        # steps; beam caches are padded by that many sequence slots up
        # front, so every append is a fixed-shape write into one executor.
        # Scale leaves (trailing singleton) keep the root's shape: appended
        # tokens quantize against the root scales
        self._generate = int(generate)
        self._gen_vocab = int(gen_vocab)
        self._gen_lock = threading.Lock()
        self._gen_t0: Optional[float] = None
        self._gen_last = 0.0
        self._gen_tokens = 0
        self._beams_in_flight = 0
        if self._generate < 0 or self._gen_vocab < 1:
            raise ValueError(f"generate must be >= 0 and gen_vocab >= 1, "
                             f"got {generate}, {gen_vocab}")
        if self._generate:
            self._decode_row_specs = tuple(
                s if s.shape[-1] == 1 else TensorSpec(
                    s.shape[:2] + (s.shape[2] + self._generate,)
                    + s.shape[3:], s.dtype)
                for s in self._cached_row_specs)
            self._s0 = int(self._cached_row_specs[0].shape[2])

        def batched(specs, batch):
            return tuple(TensorSpec((batch,) + tuple(s.shape[1:]), s.dtype)
                         for s in specs)

        def steer(batch, bucket):
            """The row index and candidate specs: a [batch] dedup index and
            [batch, bucket] candidates, or under ``pack_tails`` the
            [rows, bucket] seg-index and candidate planes (``policy`` is
            bound by the time the orchestrator builds)."""
            if self._pack_tails:
                return (TensorSpec((policy.rows, bucket), torch.int32),) * 2
            return (TensorSpec((batch,), torch.int32),
                    TensorSpec((batch, bucket), torch.int32))

        hist_specs = lambda batch: (  # noqa: E731
            TensorSpec((batch, n_history), torch.int32),
            TensorSpec((batch, N_SIDE_FEATURES), torch.float32))

        def build_fn(kind: str, bucket: int, batch: int):
            if kind == "full":
                def fn(history, candidates, side):
                    # -1 chunk-padding sentinels -> a real (ignored) row
                    return bundle.prefill(
                        self.params, {"history": history,
                                      "candidates": candidates.clamp_min(0),
                                      "side": side}, impl=self.impl)
                history_spec, side_spec = hist_specs(batch)
                specs = (history_spec,
                         TensorSpec((batch, bucket), torch.int32), side_spec)
            elif kind == "encode":
                def fn(history, side):
                    kv = bundle.encode_history(
                        self.params, {"history": history, "side": side},
                        impl=self.impl)
                    # in-epilogue quantize: the output IS the pool's stored
                    # representation
                    return quantize_kv_graph(kv, self.history_pool.dtype)
                specs = hist_specs(batch)
            elif kind == "extend":
                # ``bucket`` is the trusted prefix length, a static shape,
                # so the suffix length is one too; the basis arrives raw
                # and is dequantized in the graph, and the output is
                # re-quantized in the epilogue, as encode's
                def fn(*args):
                    *kv_leaves, history, side = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    out = bundle.extend_history(
                        self.params, kv, {"history": history, "side": side},
                        prefix_len=bucket, impl=self.impl)
                    return quantize_kv_graph(out, self.history_pool.dtype)
                specs = batched(self._cached_row_specs, batch) \
                    + hist_specs(batch)
            elif kind == "cached" and not (self._kv_dedup
                                           or self._pack_tails):
                # no dedup: every rider's rows stacked, one per batch row
                def fn(*args):
                    *kv_leaves, candidates = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    return bundle.score_candidates(
                        self.params, kv, candidates.clamp_min(0),
                        impl=self.impl)
                specs = batched(self._cached_row_specs, batch) + (
                    TensorSpec((batch, bucket), torch.int32),)
            elif kind == "cached":
                # ``idx``: the [B] dedup index, or the packed [rows, bucket]
                # seg index
                def fn(*args):
                    *kv_leaves, idx, candidates = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    # -1 chunk-padding sentinels -> a real (ignored) row
                    return bundle.score_candidates(
                        self.params, kv, candidates.clamp_min(0),
                        impl=self.impl, row_index=idx)
                specs = batched(self._cached_row_specs, batch) \
                    + steer(batch, bucket)
            elif kind == "decode":
                # ``bucket`` next-token candidates per row against padded
                # beam caches; the deduped (or packed) lead args are the
                # cache leaves and their valid lengths, so ``lengths`` is
                # per unique row
                def fn(*args):
                    *kv_leaves, lengths, idx, candidates = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    return bundle.decode_logits(
                        self.params, kv, candidates.clamp_min(0), lengths,
                        impl=self.impl, row_index=idx)
                specs = batched(self._decode_row_specs, batch) + (
                    TensorSpec((batch,), torch.int32),) \
                    + steer(batch, bucket)
            elif kind == "append":
                # a fixed-shape write into the padded cache at ``lengths``
                def fn(*args):
                    *kv_leaves, lengths, tokens = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    return bundle.append_token(
                        self.params, kv, tokens.clamp_min(0), lengths,
                        impl=self.impl)
                specs = batched(self._decode_row_specs, batch) + (
                    TensorSpec((batch,), torch.int32),
                    TensorSpec((batch, 1), torch.int32))
            else:
                raise ValueError(kind)
            # on the card a CUDA graph captured here, once per dispatcher
            return DSO.Executor(
                fn, specs, self.device,
                host_output=kind not in _DEVICE_OUTPUT_KINDS)

        policy = DSO.CoalescePolicy(enabled=coalesce, max_batch=max_batch,
                                    window_s=window_s,
                                    tier_windows=dict(_TIER_WINDOW_SCALE),
                                    pack_rows=pack_rows,
                                    pack_align=pack_align)
        if history_cache:
            families = {"cached": tuple(buckets), "encode": (n_history,)}
            if self._extend_buckets:
                families["extend"] = self._extend_buckets
            n_rows = len(self._cached_row_specs)
            # packing subsumes KV-row dedup: same-user segments share a slot
            lead = {"cached": n_rows} \
                if self._kv_dedup or self._pack_tails else {}
            if self._generate:
                families.update(decode=tuple(buckets), append=(1,))
                lead["decode"] = n_rows + 1         # cache leaves + lengths
        else:
            families, lead = {"full": tuple(buckets)}, {}
        self.dso = DSO.CoalescingOrchestrator(
            build_fn, pad_slice_fn=self._pad_slice, gather_fn=self._gather,
            policy=policy, n_streams=n_streams, families=families,
            fault_hook=None if faults is None else faults.dispatch,
            dispatch_retries=dispatch_retries,
            **{"packed_kinds" if self._pack_tails else "dedup_kinds": lead})
        super().__init__(max_pending=max_pending, n_workers=n_workers,
                         name="flame", admission=admission,
                         shed_policy=shed_policy,
                         slo_tier_defaults=slo_tier_defaults,
                         watchdog_grace_s=watchdog_grace_s,
                         degradation=degradation, faults=faults)

    def _pool_key(self, request: ServeRequest):
        fp = self._fingerprint(np.asarray(request.history, np.int32))
        key = ("u", int(request.user_id)) \
            if request.user_id is not None else ("h", fp)
        return key, fp

    def _admit_hook(self, request: ServeRequest):
        if self.history_pool is not None and (
                request.candidates is not None
                or request.generate is not None):
            key, fp = self._pool_key(request)
            # stash for _execute so the O(n_history) hash runs once
            with self._encode_lock:
                self._key_memo[request.request_id] = (key, fp)
            if self.history_pool.contains(key, fp):
                return      # pool hit ahead: side features never consumed
        super()._admit_hook(request)

    # ---- chunk plumbing ----
    @staticmethod
    def _slice_candidates(candidates, chunk: DSO.Chunk):
        sl = candidates[:, chunk.start:chunk.start + chunk.valid]
        if chunk.valid < chunk.bucket:
            # -1 sentinel: padding is never a real item id (0 is)
            sl = np.pad(sl, ((0, 0), (0, chunk.bucket - chunk.valid)),
                        constant_values=-1)
        return sl

    def _candidate_chunk(self, candidates, chunk: DSO.Chunk):
        """A chunk's candidates: padded to its bucket, or under
        ``pack_tails`` the unpadded segment, which the packer places at a
        row offset and pads with the assembled row once."""
        if self._pack_tails:
            return candidates[:, chunk.start:chunk.start + chunk.valid]
        return self._slice_candidates(candidates, chunk)

    def _pad_slice(self, request, chunk: DSO.Chunk, kind: str):
        if kind == "encode":
            return request                       # (history, side)
        if kind == "full":
            history, candidates, side = request
            return history, self._slice_candidates(candidates, chunk), side
        if kind == "extend":
            kv_leaves, history, side = request
            return tuple(kv_leaves) + (history, side)
        if kind == "append":
            kv_leaves, lengths, tokens = request
            return tuple(kv_leaves) + (lengths, tokens)
        if kind == "decode":
            kv_leaves, lengths, candidates = request
            return tuple(kv_leaves) + (
                lengths, self._candidate_chunk(candidates, chunk))
        kv_leaves, candidates = request          # cached
        return tuple(kv_leaves) + (self._candidate_chunk(candidates, chunk),)

    def _gather(self, rows, chunks: List[DSO.Chunk], m: int, kind: str):
        if kind in ("encode", "extend", "append"):
            return rows[0]                      # one chunk: the KV pytree
        return np.concatenate([r[:, :c.valid] for r, c in zip(rows, chunks)],
                              axis=1)

    # ---- history-KV pool ----
    @staticmethod
    def _fingerprint(history: np.ndarray) -> str:
        """Content hash of the FULL history array (side features average
        over every entry, so a tail-only change must read as stale too)."""
        return hashlib.blake2b(np.ascontiguousarray(history).tobytes(),
                               digest_size=16).hexdigest()

    @staticmethod
    def _shared_prefix(cached: Optional[np.ndarray], new: np.ndarray) -> int:
        """Length of the common leading run of two history windows (-1 when
        no basis window is available)."""
        if cached is None or cached.shape != new.shape:
            return -1
        neq = np.nonzero(cached != new)[0]
        return int(neq[0]) if neq.size else int(new.shape[0])

    def _extend_bucket(self, basis, window: np.ndarray) -> Optional[int]:
        """The largest trusted-prefix bucket that a stale basis allows for
        the new history ``window``, or None: no basis, a shared prefix
        below every bucket, or the extension-drift cap reached (counted in
        ``refresh_reencodes``)."""
        if basis is None:
            return None
        shared = self._shared_prefix(basis.hist_window, window)
        bucket = max((b for b in self._extend_buckets if b <= shared),
                     default=None)
        if bucket is not None and self._extend_refresh_limit \
                and basis.refreshes >= self._extend_refresh_limit:
            self.history_pool.count_refresh_reencode()
            return None
        return bucket

    def _lookup_or_encode(self, req: ServeRequest, hist: np.ndarray,
                          memo: tuple, deadline: Optional[float],
                          _retry: bool = True) -> Tuple[tuple, str, float]:
        """Returns (raw kv leaves, path, features_s) with path ``hit`` /
        ``encode`` / ``extend`` / ``wait``.  Concurrent misses for one (key,
        fingerprint) are single-flighted: the first worker encodes (or, on
        an extendable stale hit, suffix-extends the dropped entry), the
        others wait on its future; a waiter whose leader failed re-enters
        once."""
        key, fp = memo
        kv, status, basis = self.history_pool.lookup(
            key, fp, want_basis=bool(self._extend_buckets), raw=True,
            raw_basis=True)
        if status == "hit":
            return tuple(leaves(kv)), "hit", 0.0
        with self._encode_lock:
            fut = self._encode_inflight.get((key, fp))
            leader = fut is None
            if leader:
                # a racing leader may have put + deregistered since our
                # counted miss: re-check (uncounted) before encoding
                kv = self.history_pool.peek(key, fp, raw=True)
                if kv is not None:
                    return tuple(leaves(kv)), "wait", 0.0
                fut = Future()
                self._encode_inflight[(key, fp)] = fut
        if not leader:
            try:
                return fut.result(), "wait", 0.0
            except Exception:
                # the leader we waited on failed on its own request: retry
                # once (becoming or joining a new leader)
                if not _retry:
                    raise
                self._metrics.incr("encode_recoveries")
                return self._lookup_or_encode(req, hist, memo, deadline,
                                              _retry=False)
        try:
            t0 = time.perf_counter()
            side = self._side_features(req.history)
            t1 = time.perf_counter()
            bucket = self._extend_bucket(basis, hist[0])
            if bucket is not None:
                # a stale hit sharing a window prefix with the dropped
                # entry: re-encode only the suffix + side token against its
                # rows (the basis keeps them referenced through the
                # dispatch, which returns once its stream has read them)
                kv_tree = self.dso.score((tuple(leaves(basis.kv)), hist,
                                          side), bucket, kind="extend",
                                         deadline=deadline,
                                         tier=req.slo_tier)
                path, refreshes = "extend", basis.refreshes + 1
                self.history_pool.count_extension()
            else:
                kv_tree = self.dso.score((hist, side), self.n_history,
                                         kind="encode", deadline=deadline,
                                         tier=req.slo_tier)
                path, refreshes = "encode", 0
            # the dispatch's own rows, cloned out of the executor's static
            # outputs; moved into the pool's memory (a host pool's) so hit
            # and miss rows stack together
            kv = tuple(t.to(self.history_pool.device)  # flamecheck: host-sync-ok(into the pool's memory: a no-op for a pool on the executors' card; a host-placement pool keeps its rows on the host by contract)
                       for t in leaves(kv_tree))
            self.history_pool.put(
                key, fp, unflatten(self._cached_struct, kv),
                hist_window=hist[0], refreshes=refreshes, prequantized=True,
                compute_dtype=self._kv_compute_dtype)
            self._metrics.set_gauge("pool_bytes_used",
                                    self.history_pool.bytes_used)
            fut.set_result(kv)
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with self._encode_lock:
                self._encode_inflight.pop((key, fp), None)
        return kv, path, t1 - t0

    def _degrade_level(self) -> int:
        return 0 if self._degradation is None else self._degradation.level

    def _storm(self):
        """The ``evict`` fault arm: a pressure-spike / cold-restart
        stand-in, counted in ``fault_pool_evictions``."""
        if self._faults is not None and self.history_pool is not None:
            dropped = self._faults.pool_storm(self.history_pool)
            if dropped:
                self._metrics.incr("fault_pool_evictions", dropped)

    def _execute(self, req: ServeRequest):
        with self._encode_lock:
            memo = self._key_memo.pop(req.request_id, None)
        self._storm()
        self._check_request(req)
        if req.generate is not None:
            return self._execute_generate(req, memo)
        t0 = time.perf_counter()
        dl = self._effective_deadline(req)
        deadline = (req.arrival_t + dl) if dl else None
        hist = np.asarray(req.history[None, :self.n_history], np.int32)
        cand = np.asarray(req.candidates[None], np.int32)
        if self.history_pool is None:
            side = self._side_features(req.history)
            t1 = time.perf_counter()
            out = self.dso.score((hist, cand, side), req.m, kind="full",
                                 deadline=deadline, tier=req.slo_tier)
            t2 = time.perf_counter()
            return out[0], {"features_s": t1 - t0, "execute_s": t2 - t1}
        key_fp = memo if memo is not None else self._pool_key(req)
        if req.slo_tier == "bulk" and self._degrade_level() >= 3:
            # level-3 degradation: bulk-tier encodes are suppressed; serve
            # from the pool only and shed the rest (cached-hit-or-shed)
            kv_raw = self.history_pool.peek(key_fp[0], key_fp[1], raw=True)
            if kv_raw is None:
                self._metrics.incr("degrade_shed")
                raise DegradedError(
                    f"request {req.request_id} (bulk) shed: level-3 "
                    f"degradation suppresses encodes and the pool has no "
                    f"entry for this session")
            kv, path, features_s = tuple(leaves(kv_raw)), "hit", 0.0
        else:
            kv, path, features_s = self._lookup_or_encode(req, hist, key_fp,
                                                          deadline)
        t1 = time.perf_counter()
        # every path reads the stored representation, so (key, fp) is a
        # stable content identity for the rows: co-batched chunks of one
        # entry stack it once
        token = ("kv",) + key_fp[0] + (key_fp[1],)
        out = self.dso.score((kv, cand), req.m, kind="cached",
                             dedup_token=token, deadline=deadline,
                             tier=req.slo_tier)
        t2 = time.perf_counter()
        build_s = (t1 - t0) - features_s
        return out[0], {"features_s": features_s,
                        "encode_s": build_s if path == "encode" else 0.0,
                        "extend_s": build_s if path == "extend" else 0.0,
                        "pool_hit": 1.0 if path == "hit" else 0.0,
                        "execute_s": t2 - t1}

    # ---- generative decode ----
    def _pad_beam_leaves(self, kv_leaves) -> tuple:
        """Pad root (s0-position) cache leaves to the decode executors'
        S_pad = s0 + generate slots, once per request root; scale leaves
        (trailing singleton) stay at their root shape."""
        return tuple(a if a.shape[-1] == 1 else
                     F.pad(a, (0, 0, 0, 0, 0, self._generate))
                     for a in kv_leaves)

    def _copy_kv_rows(self, kv_tree) -> tuple:
        """Flatten an append result (the dispatch's own rows, cloned out of
        the executor's static outputs) into the pool's memory."""
        return tuple(t.to(self.history_pool.device)  # flamecheck: host-sync-ok(into the pool's memory: a no-op for a pool on the executors' card; a host-placement pool keeps its rows on the host by contract)
                     for t in leaves(kv_tree))

    def _note_gen_tokens(self, n: int):
        now = time.perf_counter()
        with self._gen_lock:
            if self._gen_t0 is None:
                self._gen_t0 = now
            self._gen_last = now
            self._gen_tokens += n
        self._metrics.incr("gen_tokens", n)

    def _shift_beams_in_flight(self, delta: int):
        with self._gen_lock:
            self._beams_in_flight += delta
            n = self._beams_in_flight
        self._metrics.set_gauge("beams_in_flight", n)

    def _beam_leaves(self, req, hist, memo, beam: "_Beam", deadline) -> tuple:
        """The beam's padded cache: its local copy if the pool rejected it,
        else a pool lookup — and, when the entry was evicted
        mid-generation, a replay (re-encode the history root, re-append
        every generated token; counted in ``gen_replays``)."""
        if beam.leaves is not None:
            return beam.leaves
        kv, status, _ = self.history_pool.lookup(beam.pool_key, beam.pool_fp,
                                                 raw=True)
        if status == "hit":
            return tuple(leaves(kv))
        self._metrics.incr("gen_replays")
        base, _, _ = self._lookup_or_encode(req, hist, memo, deadline)
        kv_leaves = self._pad_beam_leaves(base)
        for i, tok in enumerate(beam.tokens):
            kv_tree = self.dso.score(
                (kv_leaves, np.full((1,), self._s0 + i, np.int32),
                 np.asarray([[tok]], np.int32)),
                1, kind="append", deadline=deadline, tier=req.slo_tier)
            kv_leaves = self._copy_kv_rows(kv_tree)
        return kv_leaves

    def _park_beam(self, req, slot: int, beam: "_Beam", kv_leaves: tuple,
                   hist_fp) -> None:
        """Hand a beam's cache to the pool (key ``("g", request id, beam
        slot)``; fingerprint = the token path, so a slot that a different
        hypothesis overwrites next step reads as a miss, not a wrong hit).
        The appended cache already is the stored representation, so it
        parks without a quantize pass.  On accept the local copy is
        dropped; on reject it stays local."""
        key = ("g", req.request_id, slot)
        fp = (hist_fp,) + beam.tokens
        accepted = self.history_pool.put(
            key, fp, unflatten(self._cached_struct, kv_leaves),
            prequantized=True, compute_dtype=self._kv_compute_dtype)
        if accepted:
            beam.pool_key, beam.pool_fp, beam.leaves = key, fp, None
        else:
            beam.leaves = kv_leaves

    def _execute_generate(self, req: ServeRequest, memo: Optional[tuple]):
        gen = req.generate
        if isinstance(gen, TopKConfig):
            width, steps, eos, beam_mode = int(gen.k), int(gen.steps), \
                gen.eos, False
        elif isinstance(gen, BeamConfig):
            width, steps, eos, beam_mode = int(gen.width), int(gen.steps), \
                gen.eos, True
        else:
            raise ValueError(
                f"request {req.request_id}: generate must be a TopKConfig "
                f"or BeamConfig, got {type(gen).__name__}")
        if not self._generate:
            raise ValueError(
                "this engine was built without generative capacity; "
                "construct it with generate=<max steps>")
        if not 1 <= steps <= self._generate:
            raise ValueError(
                f"request {req.request_id}: steps={steps} outside the "
                f"engine's generate capacity [1, {self._generate}]")
        if req.candidates is not None:
            # np.unique sorts AND dedups: duplicate ids would make two
            # "distinct" hypotheses identical
            universe = np.unique(np.asarray(req.candidates, np.int32))
        else:
            universe = np.arange(self._gen_vocab, dtype=np.int32)
        # top-k seeds k independent greedy beams from the k best first
        # tokens, so k is capped by the universe; beam search may run wider
        if width < 1 or (not beam_mode and width > len(universe)):
            raise ValueError(
                f"request {req.request_id}: width={width} must be in "
                f"[1, |universe|={len(universe)}] for top-k decode")
        if req.slo_tier == "bulk" and self._degrade_level() >= 2:
            # level-2 degradation: bulk generation at half the width and
            # half the steps — a shorter answer beats a shed one
            width = max(1, width // 2)
            steps = max(1, steps // 2)
            self._metrics.incr("degrade_gen_shrunk")
        t0 = time.perf_counter()
        dl = self._effective_deadline(req)
        deadline = (req.arrival_t + dl) if dl else None
        hist = np.asarray(req.history[None, :self.n_history], np.int32)
        key_fp = memo if memo is not None else self._pool_key(req)
        base, path, features_s = self._lookup_or_encode(req, hist, key_fp,
                                                        deadline)
        root_leaves = self._pad_beam_leaves(base)
        t1 = time.perf_counter()
        self._shift_beams_in_flight(width)
        try:
            beams = self._generate_loop(req, hist, key_fp, root_leaves,
                                        universe, width, steps, eos,
                                        beam_mode, deadline)
        finally:
            self._shift_beams_in_flight(-width)
        # best-first [width, steps] id matrix; -1 pads rows finished early
        order = np.argsort(-np.asarray([b.cum for b in beams]), kind="stable")
        out = np.full((width, steps), -1, np.int32)
        for r, o in enumerate(order):
            toks = beams[o].tokens
            out[r, :len(toks)] = toks
        t2 = time.perf_counter()
        return out, {"features_s": features_s,
                     "encode_s": (t1 - t0) - features_s
                     if path == "encode" else 0.0,
                     "pool_hit": 1.0 if path == "hit" else 0.0,
                     "execute_s": t2 - t1}

    def _generate_loop(self, req, hist, memo, root_leaves, universe, width,
                       steps, eos, beam_mode, deadline):
        """Run ``steps`` decode rounds; returns the final beam list.

        Each round: fetch every live beam's cache (local / pool / replay),
        submit all their universe-scoring chunks to the ``decode`` family
        at once, rank continuations on the host (greedy per beam for top-k,
        global ``beam_step`` for beam search), then submit the surviving
        children's appends as one coalesced ``append`` round and park the
        grown caches in the pool."""
        rid = req.request_id
        v = len(universe)
        # ---- step 0: one decode from the shared history root ----
        fut = self.dso.submit((root_leaves, np.full((1,), self._s0, np.int32),
                               universe[None]),
                              v, kind="decode", dedup_token=("g", rid, "root"),
                              deadline=deadline, tier=req.slo_tier)
        probs = np.asarray(fut.result(), np.float32)[0]
        self._metrics.incr("decode_steps")
        lp = G.log_softmax(probs.sum(-1))
        order = np.argsort(-lp, kind="stable")[:width]
        beams = [_Beam(tokens=(int(universe[o]),), cum=float(lp[o]),
                       finished=(eos is not None and int(universe[o]) == eos))
                 for o in order]
        self._note_gen_tokens(len(beams))
        parent_leaves = {i: root_leaves for i in range(len(beams))}
        parent_of = {i: i for i in range(len(beams))}
        for step in range(1, steps + 1):
            # ---- append round: grow every unfinished child's cache ----
            if step < steps:     # the final round's tokens are never scored
                afuts = []
                for i, b in enumerate(beams):
                    if b.finished:
                        continue
                    afuts.append((i, self.dso.submit(
                        (parent_leaves[parent_of[i]],
                         np.full((1,), self._s0 + len(b.tokens) - 1,
                                 np.int32),
                         np.asarray([[b.tokens[-1]]], np.int32)),
                        1, kind="append", deadline=deadline,
                        tier=req.slo_tier)))
                for i, f in afuts:
                    self._park_beam(req, i, beams[i],
                                    self._copy_kv_rows(f.result()), memo[1])
            if step == steps:
                break
            # mid-generation eviction pressure: a storm here lands between
            # a beam's park and its next-round lookup, the one place an
            # eviction forces a replay
            self._storm()
            # ---- decode round over the live hypotheses ----
            live = [i for i, b in enumerate(beams) if not b.finished]
            if not live:
                # EOS early exit: every hypothesis finished with budget left
                self._metrics.incr("gen_early_exits")
                break
            leaves_of = {}
            dfuts = []
            for i in live:
                leaves_of[i] = self._beam_leaves(req, hist, memo, beams[i],
                                                 deadline)
                dfuts.append((i, self.dso.submit(
                    (leaves_of[i],
                     np.full((1,), self._s0 + len(beams[i].tokens),
                             np.int32),
                     universe[None]),
                    v, kind="decode",
                    dedup_token=("g", rid, i, len(beams[i].tokens)),
                    deadline=deadline, tier=req.slo_tier)))
            self._metrics.incr("decode_steps")
            step_lp = np.zeros((len(beams), v))
            for i, f in dfuts:
                probs = np.asarray(f.result(), np.float32)[0]
                step_lp[i] = G.log_softmax(probs.sum(-1))
            if beam_mode:
                cum = np.asarray([b.cum for b in beams])
                seqs = [b.tokens for b in beams]
                fin = np.asarray([b.finished for b in beams])
                new_cum, new_seqs, new_fin, parents = G.beam_step(
                    cum, seqs, fin, step_lp, width, eos, universe)
                new_beams = []
                parent_of = {}
                grew_n = 0
                for slot in range(len(new_cum)):
                    p = int(parents[slot])
                    grew_n += len(new_seqs[slot]) > len(seqs[p])
                    parent_of[slot] = p
                    new_beams.append(_Beam(tokens=new_seqs[slot],
                                           cum=float(new_cum[slot]),
                                           finished=bool(new_fin[slot])))
                self._note_gen_tokens(grew_n)
                # the next append round reads each UNFINISHED child's
                # parent cache: keep those addressable here (decode already
                # fetched the live parents)
                parent_leaves = {}
                for slot, nb in enumerate(new_beams):
                    p = parent_of[slot]
                    if nb.finished or p in parent_leaves:
                        continue
                    plv = leaves_of.get(p)
                    if plv is None:
                        plv = self._beam_leaves(req, hist, memo, beams[p],
                                                deadline)
                    parent_leaves[p] = plv
                beams = new_beams
            else:
                # top-k: each hypothesis follows its own greedy path
                parent_of = {i: i for i in range(len(beams))}
                parent_leaves = leaves_of
                for i in live:
                    j = int(np.argmax(step_lp[i]))
                    tok = int(universe[j])
                    beams[i] = _Beam(
                        tokens=beams[i].tokens + (tok,),
                        cum=beams[i].cum + float(step_lp[i][j]),
                        finished=(eos is not None and tok == eos))
                self._note_gen_tokens(len(live))
        return beams

    def _extra_metrics(self):
        st = self.dso.stats()
        # the candidate-scoring kinds only: encode and extend run whole rows
        slots = sum(st.get(f"cand_slots_{k}", 0) for k in ("cached", "full"))
        valid = sum(st.get(f"cand_valid_{k}", 0) for k in ("cached", "full"))
        self._metrics.set_gauge(
            "padded_fraction", 1.0 - valid / slots if slots else 0.0)
        self._metrics.set_gauge("queue_delay_ms", st["queue_delay_ms"])
        if self._generate:
            with self._gen_lock:
                toks = self._gen_tokens
                dt = self._gen_last - self._gen_t0 \
                    if self._gen_t0 is not None else 0.0
            # first-to-last appended-token wall clock; one lone step
            # reports 0 rather than an infinite rate
            self._metrics.set_gauge(
                "gen_tokens_per_s", toks / dt if dt > 0 else 0.0)
        out = {f"dso_{k}": v for k, v in st.items()}
        out["dso_build_s"] = self.dso.build_time_s
        out["dso_graph_capture_s"] = self.dso.graph_capture_s
        out["dso_graph_bytes"] = self.dso.graph_bytes
        out.update({f"pda_{k}": v for k, v in
                    vars(self.features.stats).items()})
        if self.history_pool is not None:
            out.update({f"pool_{k}": v
                        for k, v in self.history_pool.stats().items()})
        if self._faults is not None:
            out.update(self._faults.stats())
        return out

    def _on_degrade(self, level: int):
        # level >= 1: stop waiting for co-riders, flush every coalescing
        # window at once; cleared when the pressure recedes
        self.dso.set_window_override(0.0 if level >= 1 else None)

    def _close(self):
        self.features.shutdown()
        self.dso.shutdown()
        if self.history_pool is not None:
            self.history_pool.release()


@register_engine("implicit")
class ImplicitShapeServingEngine(_SideFeatureMixin, _PipelinedEngine):
    """The paper's Table 5 "Default" row, the DSO's baseline: every request
    runs the full model (``bundle.prefill``) at batch 1 and its own
    candidate count M — no buckets, no padding, no coalescing — through a
    :class:`~repro_torch.core.dso.ImplicitShapeEngine`, which builds a
    fixed-shape executor for each novel M in band (on the card a CUDA graph
    captured by the first request of that M; ``jit_compiles`` counts them,
    as the JAX engine's ``jax.jit`` retraces per novel M).  Same pipeline
    and protocol as :class:`FlameEngine`, so the two are A/B-comparable.

    Defaults: ``feature_mode="off"`` as in the JAX engine; ``impl="fused"``
    as the port's :class:`FlameEngine` (the JAX engine's ``"chunked"`` is
    served when asked for).  ``device`` (default ``"cuda"``) is where the
    model runs and ``params`` must already be there; with no GPU,
    ``device="cuda"`` raises."""

    def __init__(self, bundle, params, *, n_history: int,
                 feature_mode: str = "off", cache_capacity: int = 50_000,
                 cache_ttl_s: float = 30.0,
                 store: Optional[PDA.RemoteFeatureStore] = None,
                 max_pending: int = 64, n_workers: int = 4,
                 impl: str = "fused", device="cuda"):
        A.check_impl(impl)
        self.device = resolve_device(device)
        _check_params_device(params, self.device, "core.climber.params_to")
        self.kernel_build_s = _build.build() if self.device.type == "cuda" \
            else 0.0
        self.bundle = bundle
        self.params = params
        self.n_history = n_history
        self.impl = impl
        self.store, self.features = self._make_features(
            feature_mode, store, cache_capacity, cache_ttl_s)
        self.jit = DSO.ImplicitShapeEngine(
            lambda h, c, s: bundle.prefill(
                params, {"history": h, "candidates": c, "side": s},
                impl=impl), self.device)
        super().__init__(max_pending=max_pending, n_workers=n_workers,
                         name="implicit")

    def _execute(self, req: ServeRequest):
        self._check_request(req)
        if req.generate is not None:
            raise ValueError(
                f"request {req.request_id}: the implicit-shape engine "
                f"scores candidates; generation needs "
                f"FlameEngine(generate=<max steps>)")
        t0 = time.perf_counter()
        side = self._side_features(req.history)
        t1 = time.perf_counter()
        hist = np.asarray(req.history[None, :self.n_history], np.int32)
        cand = np.asarray(req.candidates[None], np.int32)
        out = self.jit.score((hist, cand, side), req.m)
        t2 = time.perf_counter()
        return out[0], {"features_s": t1 - t0, "execute_s": t2 - t1}

    def _extra_metrics(self):
        out = {"jit_compiles": self.jit.compiles}
        out.update({f"pda_{k}": v for k, v in
                    vars(self.features.stats).items()})
        return out

    def _close(self):
        self.features.shutdown()


class _DecodeGraph:
    """The text engine's greedy decode step for ``rows`` prompt rows,
    captured once as a CUDA graph (the JAX engine jits its decode step,
    ``repro/serving/engine.py:1940``; ``jit`` keeps one executable per
    shape, the engine one graph per row count).  A replay steps static
    caches from a static ``[rows, 1]`` token buffer at the position in a
    static 0-d buffer, writes the greedy next token back into the token
    buffer and advances the position by one, so neither leaves the device
    between steps (a Python int would be frozen into the graph at capture).
    The decode step writes its state into the static caches in place (every
    layer kind).  ``launches``: the kernel launches of one replay, which the
    engine adds to the wrappers' counters (a replay runs no wrapper)."""

    def __init__(self, bundle, params, rows: int, max_len: int, device):
        self.bundle = bundle
        self.params = params
        t0 = time.perf_counter()
        with torch.inference_mode():
            self.caches = bundle.cache_init(
                rows, max_len, dtype=params["embed"]["embedding"].dtype,
                device=device)
            self.tokens = torch.zeros((rows, 1), dtype=torch.int64,
                                      device=device)
            self.cur = torch.zeros((), dtype=torch.int64, device=device)
        self.graph, _, _, self.launches = DSO.capture_graph(self._step,
                                                            device)
        self.capture_s = time.perf_counter() - t0

    def _step(self):
        logits, _ = self.bundle.decode_step(
            self.params, self.caches, {"tokens": self.tokens,
                                       "cur_index": self.cur},
            impl=TEXT_IMPL)
        self.tokens.copy_(torch.argmax(logits[:, -1], dim=-1)[:, None])
        self.cur.add_(1)

    def load(self, caches, last, pos: int):
        """Start from a prefill's caches, its greedy tokens ``last`` [rows]
        and the position ``pos`` of the first decoded token (copies and a
        fill on the current stream, where replays run too)."""
        for s, c in zip(leaves(self.caches), leaves(caches)):
            s.copy_(c)
        self.tokens.copy_(last[:, None])
        self.cur.fill_(pos)

    def replay(self):
        self.graph.replay()
        _build.add_launches(self.launches)


#: the impl the text engine runs its bundle under, prefill and decode, on
#: both devices (the JAX engine: the bundle's defaults, under which no
#: kernel runs; ROADMAP.md Queue 3, differences by design)
TEXT_IMPL = "pallas"


def _text_kernels(cfg) -> List[str]:
    """The kernel sources a text config's layers reach under
    ``impl="pallas"``: K5 for an ``rwkv`` layer; K2 and K4 for an ``attn``
    or ``swa`` layer; K3 for a dense FFN or a shared expert
    (``transformer.dense_ffn_layers``)."""
    kinds = set(cfg.layer_pattern)
    names = []
    if "rwkv" in kinds:
        names.append("rwkv6_scan")
    if kinds & {"attn", "swa"}:
        names += ["flash_attention", "flash_decode"]
    if dense_ffn_layers(cfg):
        names.append("fused_ffn")
    return names


@register_engine("text")
class TextServingEngine(_PipelinedEngine):
    """Continuous-batching-lite decode serving for text architectures.  Port
    of ``repro.serving.engine.TextServingEngine``.

    Through the API v2 surface, ``request.history`` is the prompt token-id
    array and ``request.n_tokens`` the generation budget; the batched
    ``generate`` entry point remains for direct callers.  Decoding is
    greedy.  The prefill is an eager call, as the JAX engine's is; the
    decode step, which the JAX engine jits, is on the card a CUDA graph
    captured at construction for ``batch`` rows and for 1 (``submit``), and
    at first use for another row count (``text_graph_capture_s``); on the
    CPU it runs eagerly.

    It serves every decoder family of the registry (dense, MoE, the Mamba
    + MoE hybrid, rwkv, the vision model on tokens alone); an
    encoder-decoder bundle is refused at construction.  The bundle runs
    under ``TEXT_IMPL`` (``"pallas"``) on both devices: on the card the
    attention kinds' prefill runs K2, every dense FFN and shared expert K3
    and an ``attn`` layer's decode K4's single-token form, the rwkv kind's
    prefill K5 (the routed experts and the Mamba scan are plain PyTorch, as
    in the JAX package); on the CPU the same wrappers run their plain
    versions.  The JAX
    engine calls the bundle with its defaults (``"chunked"`` prefill,
    ``"reference"`` decode), under which no kernel runs (ROADMAP.md Queue 3,
    differences by design).  The kernels the config reaches are built at
    construction.

    Two quirks of the reference are kept, not fixed: ``generate`` pads
    prompts of unequal length at the END with token 0 and reads the logits
    of the last position (an RWKV or Mamba state absorbs the pad tokens;
    an attention layer attends to them; they take MoE capacity), and the
    ``KVCacheManager`` holds
    caches that ``generate`` does not use (``quant=True`` passes through to
    them, as the JAX engine's ``**cache_kw`` does).

    ``device`` (default ``"cuda"``) is where the model runs; ``params`` must
    already be there.  With no GPU, ``device="cuda"`` raises.
    """

    def __init__(self, bundle, params, *, batch: int = 4, max_len: int = 256,
                 max_pending: int = 64, device="cuda", **cache_kw):
        if bundle.cfg.enc_dec:
            # the JAX engine takes the bundle and fails at its first
            # prefill (KeyError: 'frames'); ROADMAP.md Queue 3
            raise ValueError(
                f"{bundle.cfg.name} is an encoder-decoder (its prefill takes "
                f"frames and tokens): the text engine serves decoder "
                f"families")
        self.device = resolve_device(device)
        _check_params_device(params, self.device, "tree.params_to")
        # build the config's kernels now, as the JAX engine compiles at
        # construction
        self.kernel_build_s = _build.build(_text_kernels(bundle.cfg)) \
            if self.device.type == "cuda" else 0.0
        self.bundle = bundle
        self.params = params
        self.kv = KVCacheManager(bundle, batch, max_len, device=self.device,
                                 **cache_kw)
        self._gen_lock = threading.Lock()
        #: prompt rows -> the captured decode step (CUDA only)
        self._graphs: Dict[int, _DecodeGraph] = {}
        self.graph_capture_s = 0.0
        self.graph_bytes = 0
        if self.device.type == "cuda":
            for rows in sorted({batch, 1}):
                self._decode_graph(rows)
        # decode state is single-stream: exactly one pipeline worker
        super().__init__(max_pending=max_pending, n_workers=1, name="text")

    def _decode_graph(self, rows: int) -> _DecodeGraph:
        g = self._graphs.get(rows)
        if g is None:
            mem0 = DSO.reserved_bytes()
            g = _DecodeGraph(self.bundle, self.params, rows, self.kv.max_len,
                             self.device)
            self._graphs[rows] = g
            self.graph_capture_s += g.capture_s
            self.graph_bytes += DSO.reserved_bytes() - mem0
        return g

    def _extra_metrics(self):
        return {"text_graph_capture_s": self.graph_capture_s,
                "text_graph_bytes": self.graph_bytes}

    def _execute(self, req: ServeRequest):
        t0 = time.perf_counter()
        outs, timings = self._generate([np.asarray(req.history)],
                                       req.n_tokens)
        return outs[0], {"execute_s": time.perf_counter() - t0, **timings}

    def generate(self, prompts: List[np.ndarray],
                 n_tokens: int = 16) -> List[np.ndarray]:
        """Serve a batch of prompts (token id arrays) for n_tokens each."""
        return self._generate(prompts, n_tokens)[0]

    def _generate(self, prompts, n_tokens: int):
        """Greedy generation; returns (token arrays, timings): ``prefill_s``
        until the first tokens are on the host, ``decode_s`` for the other
        ``n_tokens - 1`` steps (on the card their tokens stay on the device
        until the last step has run, then come to the host at once)."""
        if len(prompts) > self.kv.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of "
                             f"{self.kv.batch}")
        with self._gen_lock, torch.inference_mode():
            t0 = time.perf_counter()
            plen = max(len(p) for p in prompts)
            padded = np.stack([np.pad(p, (0, plen - len(p)))
                               for p in prompts])
            batch = {"tokens": torch.as_tensor(padded, dtype=torch.int64,  # flamecheck: host-sync-ok(request boundary: the prompts arrive as host token arrays and are staged once)
                                               device=self.device)}
            # prefill all at once (batch-padded)
            caches = self.bundle.cache_init(len(prompts), self.kv.max_len,
                                            device=self.device)
            logits, caches = self.bundle.prefill(self.params, batch,
                                                 impl=TEXT_IMPL,
                                                 caches=caches)
            last = torch.argmax(logits[:, -1], dim=-1)
            del logits       # [B, S, vocab]: 1 GB at gemma3's 4 x 500
            outs = [[int(t)] for t in last.tolist()]  # flamecheck: host-sync-ok(the first tokens go to the host once, at the end of the prefill: prefill_s is timed to here)
            t1 = time.perf_counter()
            if self.device.type == "cuda" and n_tokens > 1:
                g = self._decode_graph(len(prompts))
                g.load(caches, last, plen)
                del caches
                steps = torch.empty((len(prompts), n_tokens - 1),
                                    dtype=torch.int64, device=self.device)
                for i in range(n_tokens - 1):
                    g.replay()
                    steps[:, i].copy_(g.tokens[:, 0])
                for o, row in zip(outs, steps.tolist()):  # flamecheck: host-sync-ok(the decoded tokens come to the host once, after the last captured step)
                    o.extend(row)
            else:
                cur = plen
                for _ in range(n_tokens - 1):
                    step = {"tokens": last[:, None], "cur_index": cur}
                    logits, caches = self.bundle.decode_step(
                        self.params, caches, step, impl=TEXT_IMPL)
                    last = torch.argmax(logits[:, -1], dim=-1)
                    for i, t in enumerate(last.tolist()):  # flamecheck: host-sync-ok(the eager loop's per-step tokens: it runs only without a card, where there is no device to wait for)
                        outs[i].append(int(t))
                    cur += 1
            t2 = time.perf_counter()
        self._metrics.incr("text_prefills")
        self._metrics.incr("text_decode_steps", n_tokens - 1)
        return [np.array(o) for o in outs], {"prefill_s": t1 - t0,
                                             "decode_s": t2 - t1}
