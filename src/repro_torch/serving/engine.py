"""The FLAME serving engine behind the API v2 surface.  Port of
``repro/serving/engine.py``, restricted to the main path: ``FlameEngine``
with the history-KV pool on and ``impl="fused"``.

  submit() --> bounded EDF admission queue (backpressure)
           --> PDA feature prefetch (fire-and-forget cache warm)
           --> worker threads: pool lookup -> (miss: single-flight encode)
               -> coalesced candidate scoring -> ResponseFuture

Executor families (``CoalescingOrchestrator``, fixed shapes per
``(kind, bucket)``):

  ("encode", n_history)  history encode on a pool miss; under the fused impl
                         its epilogue quantizes to the pool's stored
                         representation (``quantize_kv_graph``), pooled as is
                         by ``put(prequantized=True)``; attention runs kernel
                         K2 (``kernels/flash_attention``) on the GPU
  ("cached", M-bucket)   candidate-only scoring against the pool's RAW stored
                         rows (int8/bf16 values + per-(layer, head) scales)
                         plus the dedup row index; attention runs kernel K1
                         (``kernels/fused_score``), which dequantizes and
                         gathers in-kernel

Options of the JAX engine outside this slice raise ``NotImplementedError``
naming their ROADMAP.md item.
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

from repro_torch.core import dso as DSO
from repro_torch.core import pda as PDA
from repro_torch.core.climber import N_SIDE_FEATURES
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.serving.api import (SLO_TIERS, TIER_RANK, AdmissionQueueFull,
                                     DeadlineExceeded, ResponseFuture,
                                     ServeMetrics, ServeRequest,
                                     ServeResponse, register_engine)
from repro_torch.serving.kv_cache import (HistoryKVPool, quantize_kv_graph,
                                          raw_kv_specs)
from repro_torch.tree import leaves, structure, unflatten
from repro_torch.types import TensorSpec

#: per-tier flush-window multipliers handed to ``CoalescePolicy``
_TIER_WINDOW_SCALE = {"interactive": 0.25, "standard": 1.0, "bulk": 2.0}

#: service-time EWMA smoothing for admission-time wait prediction
_SERVICE_EWMA = 0.3


def _try_fail(fut: ResponseFuture, exc: BaseException) -> bool:
    """Best-effort set_exception (the future may already be resolved)."""
    try:
        fut.set_exception(exc)
        return True
    except Exception:  # InvalidStateError — already resolved, fine
        return False


class _AdmissionRecord:
    __slots__ = ("key", "fut", "t_submit", "tier", "deadline_abs")

    def __init__(self, key: tuple, fut: ResponseFuture, t_submit: float,
                 tier: str, deadline_abs: Optional[float]):
        self.key = key
        self.fut = fut
        self.t_submit = t_submit
        self.tier = tier
        self.deadline_abs = deadline_abs


class _AdmissionQueue:
    """Bounded deadline-ordered (EDF) admission queue.  Records pop in
    ``(absolute deadline | inf, tier rank, seq)`` order under ``edf`` or in
    arrival order under ``fifo``.  ``close()`` is the stop signal: getters
    return ``None`` and blocked putters raise; ``drain()`` hands shutdown
    the leftovers to fail."""

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
            while len(self._heap) >= self.maxsize and not self._closed:
                left = None if end is None else end - time.perf_counter()
                if left is not None and left <= 0:
                    raise queue.Full
                self._not_full.wait(timeout=left)
            if self._closed:
                raise RuntimeError("admission queue closed")
            heapq.heappush(self._heap, (rec.key, rec))
            self._not_empty.notify()

    def get(self) -> Optional[_AdmissionRecord]:
        with self._not_empty:
            while True:
                if self._closed:
                    return None
                if self._heap:
                    _, rec = heapq.heappop(self._heap)
                    self._not_full.notify()
                    return rec
                self._not_empty.wait()

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    def close(self):
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def drain(self) -> List[_AdmissionRecord]:
        with self._lock:
            out = [rec for _, rec in self._heap]
            self._heap.clear()
            return out


class _PipelinedEngine:
    """API v2 pipeline scaffolding: ``submit`` admits into the bounded EDF
    queue (a timeout raises :class:`AdmissionQueueFull`); ``n_workers``
    threads drain it and run the engine-specific ``_execute``.  Subclasses
    finish their own setup before calling ``__init__`` here — workers start
    immediately.  ``slo_tier_defaults`` maps a tier to a default deadline
    budget (seconds) for requests that carry none."""

    def __init__(self, *, max_pending: int = 64, n_workers: int = 4,
                 name: str = "engine", admission: str = "edf",
                 slo_tier_defaults: Optional[Dict[str, float]] = None):
        self._deadline_s = getattr(self, "_deadline_s", 0.0)
        if slo_tier_defaults is not None:
            bad = set(slo_tier_defaults) - set(SLO_TIERS)
            if bad:
                raise ValueError(f"unknown SLO tiers in defaults: {bad}")
        self._metrics = ServeMetrics()
        self._admission = _AdmissionQueue(max_pending, mode=admission)
        self._tier_defaults = dict(slo_tier_defaults) \
            if slo_tier_defaults else None
        self._ewma_lock = threading.Lock()
        self._service_ewma_s: Optional[float] = None
        self._n_workers = max(int(n_workers), 1)
        self._open = True
        self._workers: List[threading.Thread] = []
        for i in range(self._n_workers):
            th = threading.Thread(target=self._worker_loop,
                                  name=f"{name}-worker-{i}", daemon=True)
            th.start()
            self._workers.append(th)

    # ---- engine-specific hooks ----
    def _execute(self, request: ServeRequest):
        raise NotImplementedError

    def _admit_hook(self, request: ServeRequest):
        """Called on the caller's thread at submit time."""

    def _extra_metrics(self) -> Dict[str, float]:
        return {}

    def _close(self):
        """Engine-specific teardown after the workers have stopped."""

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
        self._close()

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


class _SideFeatureMixin:
    """PDA in action: fetch item features for the history, aggregate into
    the request's side-feature vector (user-profile style)."""

    def _check_request(self, req: ServeRequest):
        """Reject malformed requests before their chunks reach the shared
        coalescing queue, where a bad shape would fail every co-rider."""
        if req.generate is not None:
            raise NotImplementedError(
                f"request {req.request_id}: generative decode is not ported "
                f"yet (ROADMAP.md Queue 1 item 7)")
        if req.candidates is None or req.candidates.ndim != 1 or req.m < 1:
            raise ValueError(
                f"request {req.request_id}: candidates must be a non-empty "
                f"1-D id array, got "
                f"{None if req.candidates is None else req.candidates.shape}")
        if int(np.min(req.candidates)) < 0:
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


# options of the JAX engine that this slice does not port: name -> (the
# value that means "off", where the work stands in ROADMAP.md)
_UNPORTED = {
    "history_cache": (True, "the pool-off 'full' family, Queue 1 item 6"),
    "incremental_history": (False, "the 'extend' family, Queue 1 item 6"),
    "generate": (0, "generation, Queue 1 item 7"),
    "pack_tails": (False, "SegmentPacker / pack_tails, Queue 1 item 5"),
    "mesh": (None, "sharded serving, Queue 1 item 11"),
    "faults": (None, "fault injection, Queue 1 item 6"),
    "shed_policy": ("none", "overload shedding, Queue 1 item 6"),
    "degradation": (None, "graceful degradation, Queue 1 item 6"),
    "watchdog_grace_s": (0.0, "the watchdog, Queue 1 item 6"),
    "pool_spill_bytes": (0, "the spill tier, Queue 1 item 4"),
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
    stack its rows once (KV-row dedup) and the fused kernel resolves the
    row index in its history reads.

    ``device`` (default ``"cuda"``) is where the executors run and, with
    ``pool_placement="device"``, where the pool lives; ``params`` must
    already be there.  With no GPU, ``device="cuda"`` raises.
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
                 incremental_history: bool = False, pack_tails: bool = False,
                 deadline_s: float = 0.0, mesh=None, generate: int = 0,
                 admission: str = "edf", shed_policy: str = "none",
                 slo_tier_defaults: Optional[Dict[str, float]] = None,
                 watchdog_grace_s: float = 0.0, degradation=None,
                 faults=None, device="cuda"):
        given = dict(history_cache=history_cache,
                     incremental_history=incremental_history,
                     generate=generate, pack_tails=pack_tails, mesh=mesh,
                     faults=faults, shed_policy=shed_policy,
                     degradation=degradation,
                     watchdog_grace_s=watchdog_grace_s,
                     pool_spill_bytes=pool_spill_bytes)
        for name, (off, where) in _UNPORTED.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"FlameEngine({name}={given[name]!r}) is not ported yet: "
                    f"ROADMAP.md, {where}")
        if impl != "fused":
            raise NotImplementedError(
                f"FlameEngine(impl={impl!r}): the port serves impl='fused' "
                f"(the framework impls' dequantizing pool path is ROADMAP.md "
                f"Queue 1 item 6)")
        self.device = resolve_device(device)
        emb = params["embed"]["embedding"]
        if emb.device != self.device:
            raise ValueError(f"params are on {emb.device}, the engine on "
                             f"{self.device}: move them first "
                             f"(core.climber.params_to)")
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
        self.store, self.features = self._make_features(
            feature_mode, store, cache_capacity, cache_ttl_s)

        self.history_pool = HistoryKVPool(
            pool_slots, budget_bytes=pool_budget_bytes, dtype=pool_dtype,
            placement=pool_placement, device=self.device)
        kv_specs = bundle.history_kv_specs(params, n_history, batch=1)
        # the cached executors take the pool's RAW representation
        cached_specs = raw_kv_specs(kv_specs, pool_dtype)
        self._cached_row_specs = leaves(cached_specs)
        self._cached_struct = structure(cached_specs)
        self._kv_compute_dtype = leaves(kv_specs)[0].dtype
        self._encode_inflight: Dict[tuple, Future] = {}
        self._encode_lock = threading.Lock()
        self._key_memo: Dict[int, tuple] = {}   # request_id -> (key, fp)

        def batched(specs, batch):
            return tuple(TensorSpec((batch,) + tuple(s.shape[1:]), s.dtype)
                         for s in specs)

        def build_fn(kind: str, bucket: int, batch: int):
            if kind == "encode":
                def fn(history, side):
                    kv = bundle.encode_history(
                        self.params, {"history": history, "side": side},
                        impl=self.impl)
                    # in-epilogue quantize: the output IS the pool's stored
                    # representation
                    return quantize_kv_graph(kv, self.history_pool.dtype)
                specs = (TensorSpec((batch, n_history), torch.int32),
                         TensorSpec((batch, N_SIDE_FEATURES), torch.float32))
            elif kind == "cached":
                def fn(*args):
                    *kv_leaves, idx, candidates = args
                    kv = unflatten(self._cached_struct, kv_leaves)
                    # -1 chunk-padding sentinels -> a real (ignored) row
                    return bundle.score_candidates(
                        self.params, kv, candidates.clamp_min(0),
                        impl=self.impl, row_index=idx)
                specs = batched(self._cached_row_specs, batch) + (
                    TensorSpec((batch,), torch.int32),
                    TensorSpec((batch, bucket), torch.int32))
            else:
                raise ValueError(kind)
            return DSO.Executor(fn, specs, self.device)

        policy = DSO.CoalescePolicy(enabled=coalesce, max_batch=max_batch,
                                    window_s=window_s,
                                    tier_windows=dict(_TIER_WINDOW_SCALE))
        self.dso = DSO.CoalescingOrchestrator(
            build_fn, pad_slice_fn=self._pad_slice, gather_fn=self._gather,
            policy=policy, n_streams=n_streams,
            families={"cached": tuple(buckets), "encode": (n_history,)},
            dedup_kinds={"cached": len(self._cached_row_specs)},
            device_output_kinds=("encode",))
        super().__init__(max_pending=max_pending, n_workers=n_workers,
                         name="flame", admission=admission,
                         slo_tier_defaults=slo_tier_defaults)

    @staticmethod
    def _make_features(feature_mode: str, store, cache_capacity: int,
                       cache_ttl_s: float):
        store = store or PDA.RemoteFeatureStore(feature_dim=N_SIDE_FEATURES)
        cache = None if feature_mode == "off" else PDA.BucketedLRUCache(
            cache_capacity, cache_ttl_s)
        return store, PDA.FeatureQueryEngine(store, cache, mode=feature_mode)

    def _pool_key(self, request: ServeRequest):
        fp = self._fingerprint(np.asarray(request.history, np.int32))
        key = ("u", int(request.user_id)) \
            if request.user_id is not None else ("h", fp)
        return key, fp

    def _admit_hook(self, request: ServeRequest):
        if request.candidates is not None:
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

    def _pad_slice(self, request, chunk: DSO.Chunk, kind: str):
        if kind == "encode":
            return request                       # (history, side)
        kv_leaves, candidates = request          # cached
        return tuple(kv_leaves) + (self._slice_candidates(candidates, chunk),)

    def _gather(self, rows, chunks: List[DSO.Chunk], m: int, kind: str):
        if kind == "encode":
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

    def _lookup_or_encode(self, req: ServeRequest, hist: np.ndarray,
                          memo: tuple, deadline: Optional[float],
                          _retry: bool = True) -> Tuple[tuple, str, float]:
        """Returns (raw kv leaves, path, features_s) with path ``hit`` /
        ``encode`` / ``wait``.  Concurrent misses for one (key, fingerprint)
        are single-flighted: the first worker encodes, the others wait on
        its future."""
        key, fp = memo
        kv, status = self.history_pool.lookup(key, fp, raw=True)
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
            kv_tree = self.dso.score((hist, side), self.n_history,
                                     kind="encode", deadline=deadline,
                                     tier=req.slo_tier)
            # row slices of the stacked dispatch output: copy them (into
            # the pool's memory, so hit and miss rows stack together) so a
            # pooled entry does not pin the padded (max_batch, ...) parent
            kv = tuple(t.to(self.history_pool.device, copy=True)
                       for t in leaves(kv_tree))
            self.history_pool.put(
                key, fp, unflatten(self._cached_struct, kv),
                hist_window=hist[0], prequantized=True,
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
        return kv, "encode", t1 - t0

    def _execute(self, req: ServeRequest):
        with self._encode_lock:
            memo = self._key_memo.pop(req.request_id, None)
        self._check_request(req)
        t0 = time.perf_counter()
        dl = self._effective_deadline(req)
        deadline = (req.arrival_t + dl) if dl else None
        hist = np.asarray(req.history[None, :self.n_history], np.int32)
        cand = np.asarray(req.candidates[None], np.int32)
        key_fp = memo if memo is not None else self._pool_key(req)
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
        return out[0], {"features_s": features_s,
                        "encode_s": (t1 - t0) - features_s
                        if path == "encode" else 0.0,
                        "pool_hit": 1.0 if path == "hit" else 0.0,
                        "execute_s": t2 - t1}

    def _extra_metrics(self):
        st = self.dso.stats()
        slots = st.get("cand_slots_cached", 0)
        valid = st.get("cand_valid_cached", 0)
        self._metrics.set_gauge(
            "padded_fraction", 1.0 - valid / slots if slots else 0.0)
        self._metrics.set_gauge("queue_delay_ms", st["queue_delay_ms"])
        out = {f"dso_{k}": v for k, v in st.items()}
        out["dso_build_s"] = self.dso.build_time_s
        out.update({f"pda_{k}": v for k, v in
                    vars(self.features.stats).items()})
        out.update({f"pool_{k}": v
                    for k, v in self.history_pool.stats().items()})
        return out

    def _close(self):
        self.features.shutdown()
        self.dso.shutdown()
        self.history_pool.release()
