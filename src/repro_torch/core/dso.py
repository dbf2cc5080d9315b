"""Dynamic Stream Orchestrator (DSO) — fixed-shape executors + coalescing.
Port of ``repro/core/dso.py`` (segment packing, fault hooks and serialized
dispatch wait: ROADMAP.md Queue 1 item 5).  The engine's four families
(``encode``, ``cached``, and for generation ``decode`` and ``append``) are
all fixed-shape executors of this one orchestrator.

Routing: an upstream request with M candidates is split greedily into bucket
chunks in descending bucket order; the final partial chunk is padded up to
the smallest covering bucket (the paper's "split by batch size in descending
order").

An executor is a fixed-shape ``(kind, bucket, max_batch)`` callable: every
dispatch stacks same-bucket chunks from different in-flight requests along a
batch axis padded to ``max_batch`` rows, so one executor always sees one set
of shapes.  Rows are computed independently, so a request's scores do not
depend on who it shared a dispatch with (coalesced == sequential, bitwise).
Each dispatch ends by waiting for the device (the JAX package's
``block_until_ready``), so a future only resolves on finished results.
Pending chunks pop earliest-deadline-first (ties: the owning request's
remaining work, then arrival), and the collect loop flushes as soon as
waiting longer would miss the earliest collected deadline under a
per-(kind, bucket) EWMA dispatch-cost model.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.devices import synchronize
from repro_torch.tree import leaves, tree_map
from repro_torch.types import TensorSpec


# ---------------------------------------------------------------------------
# bucket routing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Chunk:
    bucket: int       # executor shape this chunk runs on
    start: int        # offset into the request's candidate list
    valid: int        # number of real candidates (<= bucket; rest is padding)


def split_request(m: int, buckets: Sequence[int]) -> List[Chunk]:
    """Greedy descending-bucket split of M candidates."""
    bs = sorted(set(buckets), reverse=True)
    if m < 1 or not bs:
        raise ValueError(f"cannot split {m} candidates over buckets {buckets}")
    plan: List[Chunk] = []
    off, rem = 0, m
    for b in bs:
        while rem >= b:
            plan.append(Chunk(b, off, b))
            off += b
            rem -= b
    if rem > 0:
        cover = min(x for x in bs if x >= rem)  # smallest covering bucket
        plan.append(Chunk(cover, off, rem))
    return plan


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class Executor:
    """One fixed-shape executor: ``fn`` over arguments of exactly ``specs``
    (leading axis = the compiled batch).  Host arguments (numpy, or CPU
    tensors such as the rows of a ``pool_placement="host"`` pool) move to
    ``device`` once per dispatch; tensors on another accelerator raise.
    Runs under ``torch.inference_mode``."""

    def __init__(self, fn: Callable, specs: Sequence[TensorSpec], device):
        self.fn = fn
        self.specs = tuple(specs)
        self.device = torch.device(device)

    def _arg(self, a, spec: TensorSpec, i: int) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if tuple(a.shape) != tuple(spec.shape) or a.dtype != spec.dtype:
            raise ValueError(f"executor arg {i}: want {tuple(spec.shape)} "
                             f"{spec.dtype}, got {tuple(a.shape)} {a.dtype}")
        if a.device != self.device:
            if a.device.type != "cpu":
                raise ValueError(f"executor arg {i} is on {a.device}, the "
                                 f"executor on {self.device}")
            a = a.to(self.device)
        return a

    def __call__(self, *args):
        if len(args) != len(self.specs):
            raise ValueError(f"executor takes {len(self.specs)} args, got "
                             f"{len(args)}")
        ts = [self._arg(a, s, i) for i, (a, s) in
              enumerate(zip(args, self.specs))]
        with torch.inference_mode():
            return self.fn(*ts)


# ---------------------------------------------------------------------------
# cross-request chunk coalescing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """When/how same-bucket chunks from different requests share a dispatch.

    ``max_batch`` is both the fill target and the executors' batch axis;
    ``window_s`` bounds how long the first chunk of a batch waits for
    co-riders.  ``tier_windows`` maps an SLO tier to a multiplier on the
    window (the minimum over the collected chunks applies)."""

    enabled: bool = True
    max_batch: int = 4
    window_s: float = 0.002
    tier_windows: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {self.window_s}")

    @property
    def batch(self) -> int:
        """Executor batch axis: coalescing off degrades to (1, bucket)."""
        return self.max_batch if self.enabled else 1

    def tier_scale(self, tier: Optional[str]) -> float:
        if self.tier_windows is None or tier is None:
            return 1.0
        return self.tier_windows.get(tier, 1.0)


_SEQ = itertools.count()


@dataclasses.dataclass
class _PendingChunk:
    args: Tuple                       # per-chunk args, each with leading axis 1
    future: Future
    dedup_token: Optional[Hashable] = None   # stable identity of lead args
    valid: int = 0                    # real candidates in this chunk
    deadline: Optional[float] = None  # absolute perf_counter deadline
    remaining: int = 0                # request work left incl. this chunk
    tier: Optional[str] = None
    seq: int = dataclasses.field(default_factory=lambda: next(_SEQ))
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)

    def _key(self):
        return (self.deadline if self.deadline is not None else math.inf,
                self.remaining, self.seq)

    def __lt__(self, other: "_PendingChunk") -> bool:
        return self._key() < other._key()


class _Lazy:
    def __init__(self, fn):
        self._fn = fn

    def result(self):
        return self._fn()


class CoalescingOrchestrator:
    """DSO whose executors carry a real batch axis ``(B, bucket)`` and whose
    dispatcher merges same-bucket chunks *from different in-flight
    requests* into one executor call.

    ``families`` maps an executor kind to its buckets;
    ``build_fn(kind, bucket, batch)`` -> :class:`Executor`;
    ``pad_slice_fn(request, chunk, kind)`` -> one chunk's args (leading axis
    1, candidate axis padded to the bucket); ``gather_fn(rows, chunks, m,
    kind)`` -> the request's output.  Per (kind, bucket) there are
    ``n_streams`` worker threads, each owning one executor.

    * **Device-resident outputs** — kinds in ``device_output_kinds`` (the
      encode family) keep their outputs as device tensors, scattered back
      as row slices; other kinds come back as host numpy.
    * **KV-row dedup** — ``dedup_kinds`` maps a kind to its number of
      leading args deduped per dispatch: chunks carrying the same arg
      objects or the same ``dedup_token`` stack those args once, and the
      executor receives an extra ``[B] int32`` row index (inserted after the
      deduped args) that the fused kernel folds into its history reads."""

    def __init__(self, build_fn: Callable, *, pad_slice_fn: Callable,
                 gather_fn: Callable, families: Dict[str, Sequence[int]],
                 policy: CoalescePolicy = CoalescePolicy(),
                 n_streams: int = 2,
                 dedup_kinds: Optional[Dict[str, int]] = None,
                 device_output_kinds: Sequence[str] = ()):
        self.families: Dict[str, List[int]] = {
            kind: sorted(set(bs), reverse=True)
            for kind, bs in families.items()}
        self.policy = policy
        self.pad_slice = pad_slice_fn
        self.gather = gather_fn
        self._dedup: Dict[str, int] = dict(dedup_kinds or {})
        self._device_output = frozenset(device_output_kinds)
        self.chunk_count = 0
        self.dispatch_count = 0
        self.rows_dispatched = 0       # real (non-padding) rows
        self.dedup_rows_saved = 0      # restacks avoided by dedup
        self.dispatch_failure_count = 0
        self.queue_delay_total_s = 0.0
        self.queue_delay_count = 0
        self.kind_chunks: Dict[str, int] = {k: 0 for k in self.families}
        self.kind_dispatches: Dict[str, int] = {k: 0 for k in self.families}
        #: seconds spent in each kind's executor calls (until the device
        #: finished), for the per-dispatch breakdown
        self.kind_busy_s: Dict[str, float] = {k: 0.0 for k in self.families}
        self.deadline_miss_chunks: Dict[str, int] = {
            k: 0 for k in self.families}
        self.slot_count: Dict[Tuple[str, int], int] = {}
        self.valid_count: Dict[Tuple[str, int], int] = {}
        self._cost: Dict[Tuple[str, int], float] = {}   # EWMA dispatch cost
        self._stat_lock = threading.Lock()
        self._stop = False
        self._pending: Dict[Tuple[str, int], List[_PendingChunk]] = {}
        self._cond: Dict[Tuple[str, int], threading.Condition] = {}
        self._threads: List[threading.Thread] = []
        #: (kind, bucket) -> the executor all its streams share
        self.executors: Dict[Tuple[str, int], Executor] = {}

        t0 = time.perf_counter()
        for kind, bs in self.families.items():
            for b in bs:
                self._pending[(kind, b)] = []
                self._cond[(kind, b)] = threading.Condition()
                self.slot_count[(kind, b)] = 0
                self.valid_count[(kind, b)] = 0
                ex = build_fn(kind, b, policy.batch)
                self.executors[(kind, b)] = ex
                for s in range(n_streams):
                    self._threads.append(threading.Thread(
                        target=self._worker, args=(kind, b, ex),
                        name=f"dso-{kind}-b{b}-s{s}", daemon=True))
        self.build_time_s = time.perf_counter() - t0
        for th in self._threads:
            th.start()

    _COST_EWMA = 0.3          # per-(kind, bucket) dispatch-cost smoothing

    # ---- submission ----
    def submit(self, request, m: int, kind: str,
               dedup_token: Optional[Hashable] = None,
               deadline: Optional[float] = None,
               tier: Optional[str] = None):
        """Non-blocking: split into chunks and enqueue each onto its
        (kind, bucket) queue; returns a lazy future gathering the rows."""
        plan = split_request(m, self.families[kind])
        with self._stat_lock:
            self.chunk_count += len(plan)
            self.kind_chunks[kind] += len(plan)
        futs = []
        for c in plan:
            args = self.pad_slice(request, c, kind)
            f = Future()
            futs.append(f)
            cond = self._cond[(kind, c.bucket)]
            with cond:
                heapq.heappush(
                    self._pending[(kind, c.bucket)],
                    _PendingChunk(args, f, dedup_token, valid=c.valid,
                                  deadline=deadline, remaining=m - c.start,
                                  tier=tier))
                cond.notify()

        def resolve():
            return self.gather([f.result() for f in futs], plan, m, kind)

        return _Lazy(resolve)

    def score(self, request, m: int, kind: str,
              dedup_token: Optional[Hashable] = None,
              deadline: Optional[float] = None,
              tier: Optional[str] = None):
        return self.submit(request, m, kind, dedup_token, deadline,
                           tier).result()

    # ---- dispatcher ----
    @staticmethod
    def _ident(c: _PendingChunk, n_lead: int) -> Hashable:
        return c.dedup_token if c.dedup_token is not None \
            else tuple(id(a) for a in c.args[:n_lead])

    def _collect(self, kind: str, bucket: int, pending: List[_PendingChunk],
                 cond: threading.Condition, batch: List[_PendingChunk]):
        """Pop the first chunk and keep collecting co-riders into the
        caller-owned ``batch`` (caller holds ``cond``) until the dispatch is
        full, the window closes, or waiting longer would overrun the
        earliest collected deadline."""
        pol = self.policy
        batch.append(heapq.heappop(pending))
        if not pol.enabled or pol.max_batch <= 1:
            return
        t_open = time.perf_counter()
        while not self._stop and len(batch) < pol.max_batch:
            if pending:
                batch.append(heapq.heappop(pending))
                continue
            scale = min(pol.tier_scale(c.tier) for c in batch)
            target = t_open + pol.window_s * scale
            dls = [c.deadline for c in batch if c.deadline is not None]
            if dls:
                with self._stat_lock:
                    est = self._cost.get((kind, bucket), 0.0)
                target = min(target, min(dls) - est)
            left = target - time.perf_counter()
            if left <= 0:
                break
            cond.wait(timeout=left)
        now = time.perf_counter()
        with self._stat_lock:
            self.queue_delay_total_s += sum(now - c.enqueue_t for c in batch)
            self.queue_delay_count += len(batch)

    def _worker(self, kind: str, bucket: int, ex: Executor):
        cond, pending = self._cond[(kind, bucket)], \
            self._pending[(kind, bucket)]
        while True:
            batch: List[_PendingChunk] = []
            with cond:
                while not pending and not self._stop:
                    cond.wait()
                if not pending and self._stop:
                    return
                self._collect(kind, bucket, pending, cond, batch)
            self._dispatch(kind, bucket, ex, batch)

    @staticmethod
    def _stack_rows(rows: List, batch: int):
        """Stack per-chunk rows (leading axis 1) along the batch axis, padded
        with zero rows to the executor's batch.  Device tensors stack on
        their device; host numpy stays numpy (one transfer in the executor)."""
        if isinstance(rows[0], torch.Tensor):
            if len(rows) < batch:
                rows = list(rows) + [torch.zeros_like(rows[0])] \
                    * (batch - len(rows))
            return torch.cat(rows, dim=0)
        if len(rows) < batch:
            rows = list(rows) + [np.zeros_like(rows[0])] * (batch - len(rows))
        return np.concatenate(rows, axis=0)

    def _dispatch(self, kind: str, bucket: int, ex: Executor,
                  batch: List[_PendingChunk]):
        n = len(batch)
        try:
            B = self.policy.batch
            stacked = []
            n_lead = self._dedup.get(kind, 0)
            n_uniq = n
            rests = [c.args for c in batch]
            if n_lead:
                slot_of: Dict[Hashable, int] = {}
                uniq: List[tuple] = []
                idx = np.zeros(B, np.int32)
                for i, c in enumerate(batch):
                    ident = self._ident(c, n_lead)
                    slot = slot_of.get(ident)
                    if slot is None:
                        slot = len(uniq)
                        slot_of[ident] = slot
                        uniq.append(c.args[:n_lead])
                    idx[i] = slot
                n_uniq = len(uniq)
                for j in range(n_lead):
                    stacked.append(self._stack_rows([u[j] for u in uniq], B))
                stacked.append(idx)
                rests = [c.args[n_lead:] for c in batch]
            for j in range(len(rests[0])):
                stacked.append(self._stack_rows([r[j] for r in rests], B))
            t0 = time.perf_counter()
            out = ex(*stacked)
            synchronize(leaves(out))        # results are final before any
            dt = time.perf_counter() - t0   # future resolves
            if kind not in self._device_output:
                out = tree_map(lambda t: t.cpu().numpy(), out)
            now = time.perf_counter()
            with self._stat_lock:
                key = (kind, bucket)
                self.dispatch_count += 1
                self.kind_dispatches[kind] += 1
                self.kind_busy_s[kind] += dt
                self.rows_dispatched += n
                self.dedup_rows_saved += n - n_uniq
                self.slot_count[key] += n * bucket
                self.valid_count[key] += sum(c.valid for c in batch)
                self.deadline_miss_chunks[kind] += sum(
                    1 for c in batch
                    if c.deadline is not None and now > c.deadline)
                old = self._cost.get(key)
                self._cost[key] = dt if old is None else \
                    (1 - self._COST_EWMA) * old + self._COST_EWMA * dt
            for i, c in enumerate(batch):
                c.future.set_result(tree_map(lambda a: a[i:i + 1], out))
        except Exception as e:  # noqa: BLE001 — fail every rider
            with self._stat_lock:
                self.dispatch_failure_count += 1
            for c in batch:
                if not c.future.done():
                    c.future.set_exception(e)

    # ---- introspection / lifecycle ----
    def stats(self) -> Dict[str, float]:
        with self._stat_lock:
            d = max(self.dispatch_count, 1)
            slots = sum(self.slot_count.values())
            valid = sum(self.valid_count.values())
            out = {
                "chunks": self.chunk_count,
                "dispatches": self.dispatch_count,
                "rows_dispatched": self.rows_dispatched,
                "avg_fill": self.rows_dispatched / d,
                "batch_axis": self.policy.batch,
                "dedup_rows_saved": self.dedup_rows_saved,
                "cand_slots": slots,
                "cand_valid": valid,
                "padded_fraction": 1.0 - valid / slots if slots else 0.0,
                "queue_delay_ms": (1e3 * self.queue_delay_total_s
                                   / max(self.queue_delay_count, 1)),
                "dispatch_failures": self.dispatch_failure_count,
                "deadline_miss_chunks": sum(
                    self.deadline_miss_chunks.values()),
            }
            for kind in self.families:
                out[f"chunks_{kind}"] = self.kind_chunks[kind]
                out[f"dispatches_{kind}"] = self.kind_dispatches[kind]
                out[f"dispatch_ms_{kind}"] = (
                    1e3 * self.kind_busy_s[kind]
                    / max(self.kind_dispatches[kind], 1))
                out[f"cand_slots_{kind}"] = sum(
                    s for (k, _), s in self.slot_count.items() if k == kind)
                out[f"cand_valid_{kind}"] = sum(
                    v for (k, _), v in self.valid_count.items() if k == kind)
            for (kind, b), s in self.slot_count.items():
                if s:
                    out[f"fill_{kind}_b{b}"] = self.valid_count[(kind, b)] / s
            return out

    def shutdown(self):
        self._stop = True
        for cond in self._cond.values():
            with cond:
                cond.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)
