"""Dynamic Stream Orchestrator (DSO) — fixed-shape executors + coalescing.
Port of ``repro/core/dso.py`` (serialized dispatch for multi-device
executables waits for sharded serving: ROADMAP.md Queue 1 item 11).  The
paper's own design, a fixed pool of executors behind an index queue (Fig
10), is :class:`ExecutorPool` + :class:`DynamicStreamOrchestrator`.  The
engine's families (``encode``,
``cached``, ``extend``, for generation ``decode`` and ``append``, and
without the pool ``full``) are all fixed-shape executors of this one
orchestrator.  :class:`ImplicitShapeEngine` is the baseline without it.

Routing: an upstream request with M candidates is split greedily into bucket
chunks in descending bucket order; the final partial chunk is padded up to
the smallest covering bucket (the paper's "split by batch size in descending
order").

An executor is a fixed-shape ``(kind, bucket, max_batch)`` callable — on
CUDA a CUDA graph captured once at construction over static buffers, the
counterpart of the JAX package's AOT-compiled executable (the paper's
TensorRT fixed-shape profile) — and every dispatch writes same-bucket chunks
from different in-flight requests into the rows of its batch axis of
``max_batch`` rows, so one executor always sees one set of shapes.  Rows
are computed independently, so a request's scores do not depend on who it
shared a dispatch with (coalesced == sequential, bitwise).
Each dispatch ends by waiting for the device (the JAX package's
``block_until_ready``), so a future only resolves on finished results.
Pending chunks pop earliest-deadline-first (ties: the owning request's
remaining work, then arrival), and the collect loop flushes as soon as
waiting longer would miss the earliest collected deadline under a
per-(kind, bucket) EWMA dispatch-cost model.

DSO v2 segment packing (``packed_kinds``): the partial tail chunks of
different requests share executor rows as independent segments, placed by
a :class:`SegmentPacker`, each candidate steered to its own user's stacked
KV row through a ``[rows, bucket]`` seg-index plane.  A packed executor's
shapes are fixed too (``policy.rows`` rows of ``bucket`` slots over
``policy.batch`` stacked KV rows), so it captures like the others.

Fault tolerance: ``fault_hook(kind, bucket)`` runs before every executor
call, before it stages anything; an exception with a truthy
``.transient`` is retried up to ``dispatch_retries`` times with
exponential backoff, each retry staging the rows again and replaying the
same captured graph.  Anything else, or an exhausted budget, fails every
rider's future with the original exception.  A graceful-degradation
override (``set_window_override``) caps the coalescing window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import itertools
import math
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.tree import leaves, structure, tree_map, unflatten
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


def padded_fraction(m: int, buckets: Sequence[int]) -> float:
    """The share of the executor slots that M candidates' split pads."""
    plan = split_request(m, buckets)
    padded = sum(c.bucket for c in plan)
    return 1.0 - m / padded


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

#: eager runs of a function on its capture stream before the capture
_WARMUP = 2


_gc_lock = threading.Lock()
_gc_pauses = [0, False]     # captures in progress, gc enabled before them


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection while any graph captures (the
    collector is process-wide): collecting a dead cycle there (an old
    engine's graphs, a tensor with pending stream uses) calls into CUDA
    and invalidates the capture.  The garbage is collected after."""
    with _gc_lock:
        if _gc_pauses[0] == 0:
            _gc_pauses[1] = gc.isenabled()
            gc.disable()
        _gc_pauses[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pauses[0] -= 1
            if _gc_pauses[0] == 0 and _gc_pauses[1]:
                gc.enable()


def capture_graph(fn, device):
    """Capture one call of ``fn()`` as a CUDA graph on a stream of its own.

    ``fn`` is first run ``_WARMUP`` times on that stream (which loads the
    kernel libraries, initialises cuBLAS and its workspace for the stream),
    then captured once; the graph gets a memory pool of its own.  A wrapper
    that counts its kernel's launches counts during the capture, though the
    capture launches nothing: those counts are taken back and returned, to
    be added on every replay.  Returns ``(graph, stream, outputs, launches
    per replay)``; a capture that fails raises."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.inference_mode(), torch.cuda.stream(stream):
        for _ in range(_WARMUP):
            fn()
    stream.synchronize()
    before = _build.launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with _gc_paused(), torch.inference_mode(), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            out = fn()
    except Exception as e:
        raise RuntimeError(f"CUDA-graph capture failed: {e}") from e
    finally:
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        _build.add_launches({k: -n for k, n in launches.items()})
    return graph, stream, out, launches


def reserved_bytes() -> int:
    """The CUDA caching allocator's reserve on the current device after
    releasing its unused cached blocks, so that a difference of two
    readings counts what is held (0 without a GPU).  Called at
    construction, which pays set-up."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


class Executor:
    """One fixed-shape executor: ``fn`` over arguments of exactly ``specs``
    (leading axis = the batch), the counterpart of the JAX package's
    AOT-compiled executable (``repro/core/dso.py:120``).

    On CUDA it is a CUDA graph captured once at construction
    (:func:`capture_graph`) over static input buffers of ``specs``, with a
    stream of its own.  A call copies each argument into its static buffer
    on that stream — host arguments (numpy, or CPU tensors such as the rows
    of a ``pool_placement="host"`` pool) through a pinned buffer with one
    ``non_blocking`` copy, device arguments device to device, after the
    stream has waited for the default stream, where callers make device
    inputs — replays the graph, and adds the launches its capture counted
    to the kernels' counters.  On the CPU the call runs ``fn`` eagerly on
    the static buffers and copies its outputs into static output buffers,
    so the output handling is the one a replay gets.

    An argument is a whole array of its spec, or a list of row blocks
    (leading axis >= 1) written straight into the buffer's leading rows;
    rows past them keep what an earlier call left there (real rows of the
    same shape: rows are computed independently, so they leave the written
    rows bitwise unchanged).

    Outputs never alias the static outputs, which the next call
    overwrites: with ``host_output`` they come back as fresh numpy arrays
    (through a pinned output buffer on CUDA), else as device tensors cloned
    on the executor's stream.  ``rows=n`` returns the first ``n`` batch
    rows as ``n`` separate outputs (leading axis 1), each its own clone.
    The call returns once the device has finished.  A capture that fails
    raises at construction; a CUDA executor never runs eagerly."""

    def __init__(self, fn: Callable, specs: Sequence[TensorSpec], device, *,
                 host_output: bool = True, bucket: int = 0, eid: int = -1):
        self.fn = fn
        self.specs = tuple(specs)
        self.device = torch.device(device)
        self.host_output = host_output
        self.bucket = bucket    # the candidate bucket (ExecutorPool)
        self.eid = eid          # its index in an ExecutorPool
        self.calls = 0
        #: kernel launches of one replay, by counting wrapper (counted in
        #: the capture; on the CPU the wrappers count for themselves)
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.graph = None
        self.stream = None
        self._pinned: List[Optional[torch.Tensor]] = [None] * len(self.specs)
        self._pinned_out: Optional[List[torch.Tensor]] = None
        with torch.inference_mode():
            self.static_in = tuple(torch.zeros(s.shape, dtype=s.dtype,
                                               device=self.device)
                                   for s in self.specs)
        self.static_out = None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            self.graph, self.stream, self.static_out, self.launches = \
                capture_graph(lambda: self.fn(*self.static_in), self.device)
            if host_output:
                self._pinned_out = [torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
                                    for t in leaves(self.static_out)]
            self.capture_s = time.perf_counter() - t0

    def stream_scope(self):
        """Make the executor's stream current (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ---- staging ----
    def _blocks(self, a, spec: TensorSpec, i: int) -> List:
        full = not isinstance(a, list)
        n = 0
        out = []
        for blk in ([a] if full else a):
            if isinstance(blk, np.ndarray):
                blk = torch.from_numpy(np.ascontiguousarray(blk))
            if blk.dtype != spec.dtype or blk.dim() != len(spec.shape) \
                    or tuple(blk.shape[1:]) != tuple(spec.shape[1:]) \
                    or (full and blk.shape[0] != spec.shape[0]) \
                    or blk.shape[0] < 1:
                raise ValueError(
                    f"executor arg {i}: want {tuple(spec.shape)} "
                    f"{spec.dtype}{'' if full else ' rows'}, got "
                    f"{tuple(blk.shape)} {blk.dtype}")
            if blk.device != self.device and blk.device.type != "cpu":
                raise ValueError(f"executor arg {i} is on {blk.device}, the "
                                 f"executor on {self.device}")
            out.append((n, blk))
            n += blk.shape[0]
        if n > spec.shape[0]:
            raise ValueError(f"executor arg {i}: {n} rows for a batch of "
                             f"{spec.shape[0]}")
        return out

    def _pinned_for(self, i: int) -> torch.Tensor:
        if self._pinned[i] is None:
            s = self.specs[i]
            self._pinned[i] = torch.empty(s.shape, dtype=s.dtype,
                                          pin_memory=True)
        return self._pinned[i]

    def _stage(self, i: int, blocks: List) -> None:
        dst = self.static_in[i]
        n = sum(b.shape[0] for _, b in blocks)
        on_dev = [b.device == self.device for _, b in blocks]
        if all(on_dev):
            if len(blocks) == 1:
                dst[:n].copy_(blocks[0][1])
            else:
                torch.cat([b for _, b in blocks], dim=0, out=dst[:n])
            return
        # host rows through the pinned buffer (the previous call's copy out
        # of it finished before that call returned): one copy for them all
        # unless device rows sit between them
        pin = self._pinned_for(i)
        for (o, b), dev in zip(blocks, on_dev):
            rows = slice(o, o + b.shape[0])
            if dev:
                dst[rows].copy_(b)
                continue
            pin[rows].copy_(b)
            if any(on_dev):
                dst[rows].copy_(pin[rows], non_blocking=True)
        if not any(on_dev):
            dst[:n].copy_(pin[:n], non_blocking=True)

    # ---- call ----
    def __call__(self, *args, rows: Optional[int] = None):
        if len(args) != len(self.specs):
            raise ValueError(f"executor takes {len(self.specs)} args, got "
                             f"{len(args)}")
        blocks = [self._blocks(a, s, i) for i, (a, s) in
                  enumerate(zip(args, self.specs))]
        with torch.inference_mode(), self.stream_scope():
            if self.stream is not None:
                self.stream.wait_stream(
                    torch.cuda.default_stream(self.device))
            for i, b in enumerate(blocks):
                self._stage(i, b)
            if self.graph is not None:
                self.graph.replay()
                _build.add_launches(self.launches)
            else:
                out = self.fn(*self.static_in)
                if self.static_out is None:
                    self.static_out = tree_map(torch.empty_like, out)
                for s, o in zip(leaves(self.static_out), leaves(out)):
                    s.copy_(o)
            self.calls += 1
            return self._fetch(rows)

    def _fetch(self, rows: Optional[int]):
        out = self.static_out
        struct = structure(out)
        if self.host_output:
            if self._pinned_out is not None:
                for p, t in zip(self._pinned_out, leaves(out)):
                    p.copy_(t, non_blocking=True)
                self.stream.synchronize()  # flamecheck: host-sync-ok(dispatch boundary: host outputs are read from the pinned buffer once its copies have finished)
                src = self._pinned_out
            else:
                src = leaves(out)
            res = unflatten(struct, [t.numpy().copy() for t in src])  # flamecheck: host-sync-ok(host tensors: the pinned buffer after its stream sync, or an executor's own CPU outputs)
            if rows is None:
                return res
            return [tree_map(lambda a: a[r:r + 1], res) for r in range(rows)]
        if rows is None:
            res = tree_map(torch.clone, out)
        else:
            res = [tree_map(lambda t: t[r:r + 1].clone(), out)
                   for r in range(rows)]
        if self.stream is not None:
            self.stream.synchronize()  # flamecheck: host-sync-ok(dispatch boundary: an executor returns finished results, as the JAX package's block_until_ready)
        return res


# ---------------------------------------------------------------------------
# the fixed executor pool (paper Fig 10)
# ---------------------------------------------------------------------------

class ExecutorPool:
    """Per-bucket executor index queues (paper Fig 10).

    ``build_fn(bucket)`` returns ``(fn, specs)``: the function and the
    fixed argument shapes of that bucket's executor.  ``n_streams``
    executors are built per bucket, and that many chunks of one bucket run
    at once.  One difference from the JAX package is deliberate: there the
    ``n_streams`` executors of a bucket share one AOT-compiled executable
    (JAX's async dispatch overlaps them), while a CUDA graph and its static
    buffers serve one caller at a time.  So each executor here is its own
    :class:`Executor`: its own capture, on its own stream, over its own
    static buffers — the paper's index queue of executors, each with a
    stream.  On the CPU the executors run eagerly."""

    def __init__(self, build_fn: Callable[[int], Tuple[Callable, Sequence]],
                 buckets: Sequence[int], n_streams: int = 2, *,
                 device="cuda"):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.buckets = sorted(set(buckets), reverse=True)
        self.device = torch.device(device)
        self.queues: Dict[int, "queue.Queue[Executor]"] = {}
        self.executors: List[Executor] = []
        eid = 0
        t0 = time.perf_counter()
        for b in self.buckets:
            q: "queue.Queue[Executor]" = queue.Queue()
            fn, specs = build_fn(b)
            for _ in range(n_streams):
                ex = Executor(fn, specs, self.device, bucket=b, eid=eid)
                q.put(ex)
                self.executors.append(ex)
                eid += 1
            self.queues[b] = q
        self.build_time_s = time.perf_counter() - t0

    def acquire(self, bucket: int) -> Executor:
        """Check out an executor of ``bucket`` (waits for a free one)."""
        return self.queues[bucket].get()

    def release(self, ex: Executor):
        self.queues[ex.bucket].put(ex)


class DynamicStreamOrchestrator:
    """Routes requests with arbitrary candidate counts onto the executor
    pool: each request is split greedily over the buckets
    (:func:`split_request`) and each chunk runs on an executor checked out
    of its bucket's queue by a worker thread.

    ``pad_slice_fn(request, chunk)`` -> executor args for one chunk
    (padded to ``chunk.bucket``); ``gather_fn(results, chunks, m)`` -> the
    final output.  An executor returns once the device has finished, so a
    chunk needs no further wait."""

    def __init__(self, pool: ExecutorPool,
                 pad_slice_fn: Callable, gather_fn: Callable,
                 max_workers: int = 8):
        self.pool = pool
        self.pad_slice = pad_slice_fn
        self.gather = gather_fn
        self._tp = ThreadPoolExecutor(max_workers=max_workers)
        self.chunk_count = 0
        self._lock = threading.Lock()

    def _run_chunk(self, request, chunk: Chunk):
        ex = self.pool.acquire(chunk.bucket)
        try:
            return ex(*self.pad_slice(request, chunk))
        finally:
            self.pool.release(ex)

    def submit(self, request, m: int) -> "_Lazy":
        """Non-blocking: returns a handle whose ``result()`` is the gathered
        output."""
        plan = split_request(m, self.pool.buckets)
        with self._lock:
            self.chunk_count += len(plan)
        futs = [self._tp.submit(self._run_chunk, request, c) for c in plan]

        def resolve():
            results = [f.result() for f in futs]
            return self.gather(results, plan, m)

        return _Lazy(resolve)

    def score(self, request, m: int):
        """Blocking convenience wrapper."""
        return self.submit(request, m).result()

    def shutdown(self):
        self._tp.shutdown(wait=True)


# ---------------------------------------------------------------------------
# cross-request chunk coalescing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """When/how same-bucket chunks from different requests share a dispatch.

    ``max_batch`` is both the fill target and the executors' batch axis;
    ``window_s`` bounds how long the first chunk of a batch waits for
    co-riders.  ``tier_windows`` maps an SLO tier to a multiplier on the
    window (the minimum over the collected chunks applies).

    ``pack_rows`` sizes the PACKED executors' row axis apart from
    ``max_batch``, which still sizes their stacked unique-KV axis (how many
    distinct users one packed dispatch can steer to): packed rows are
    dense, so fewer rows carry the same candidates.  ``None`` means
    ``max_batch``.  ``pack_align`` rounds every packed segment's start up
    to a multiple of that many slots (the JAX kernel's q-block contract;
    alignment holes are dead slots, seg 0 / candidate -1)."""

    enabled: bool = True
    max_batch: int = 4
    window_s: float = 0.002
    tier_windows: Optional[Dict[str, float]] = None
    pack_rows: Optional[int] = None
    pack_align: int = 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {self.window_s}")
        if self.pack_rows is not None and self.pack_rows < 1:
            raise ValueError(f"pack_rows must be >= 1, got {self.pack_rows}")
        if self.pack_align < 1:
            raise ValueError(
                f"pack_align must be >= 1, got {self.pack_align}")

    @property
    def batch(self) -> int:
        """Executor batch axis: coalescing off degrades to (1, bucket)."""
        return self.max_batch if self.enabled else 1

    @property
    def rows(self) -> int:
        """Row axis of the PACKED executors."""
        if not self.enabled:
            return 1
        return self.pack_rows if self.pack_rows is not None \
            else self.max_batch

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


class SegmentPacker:
    """First-fit packer of tail-chunk segments into shared executor rows.

    One packer plans ONE packed dispatch: up to ``max_rows`` rows of
    ``bucket`` candidate slots, fed by at most ``max_kv`` distinct KV
    identities (the stacked unique-KV axis).  ``try_add(valid, ident)``
    places a segment of ``valid`` candidates of KV identity ``ident`` in the
    first row with room (a segment is one request's chunk and never splits
    across rows) and returns its ``(row, offset, kv_slot)``, or ``None``
    when it does not fit this dispatch.  ``align`` > 1 rounds every
    segment's start up to a multiple of ``align``; the holes are dead
    slots."""

    def __init__(self, bucket: int, max_rows: int, max_kv: int,
                 align: int = 1):
        if bucket < 1 or max_rows < 1 or max_kv < 1 or align < 1:
            raise ValueError(f"packer needs bucket, rows, kv and align >= 1, "
                             f"got {bucket}, {max_rows}, {max_kv}, {align}")
        self.bucket = bucket
        self.max_rows = max_rows
        self.max_kv = max_kv
        self.align = align
        self.fills: List[int] = []            # candidate slots used per row
        self.placements: List[Tuple[int, int, int]] = []  # (row, off, slot)
        self.slot_of: Dict[Hashable, int] = {}
        self.n_slots = 0

    def _aligned(self, fill: int) -> int:
        return -(-fill // self.align) * self.align

    def try_add(self, valid: int, ident: Hashable
                ) -> Optional[Tuple[int, int, int]]:
        if not 1 <= valid <= self.bucket:
            raise ValueError(f"segment of {valid} candidates does not fit a "
                             f"{self.bucket}-slot row")
        slot = self.slot_of.get(ident)
        if slot is None and self.n_slots >= self.max_kv:
            return None
        row = next((i for i, f in enumerate(self.fills)
                    if self._aligned(f) + valid <= self.bucket), None)
        if row is None:
            if len(self.fills) >= self.max_rows:
                return None
            row = len(self.fills)
            self.fills.append(0)
        if slot is None:
            slot = self.n_slots
            self.slot_of[ident] = slot
            self.n_slots += 1
        off = self._aligned(self.fills[row])
        self.fills[row] = off + valid
        place = (row, off, slot)
        self.placements.append(place)
        return place

    @property
    def n_rows(self) -> int:
        return len(self.fills)

    def is_full(self) -> bool:
        """No further segment (not even a 1-candidate one) fits."""
        return len(self.fills) == self.max_rows and all(
            self._aligned(f) >= self.bucket for f in self.fills)


class CoalescingOrchestrator:
    """DSO whose executors carry a real batch axis ``(B, bucket)`` and whose
    dispatcher merges same-bucket chunks *from different in-flight
    requests* into one executor call.

    ``families`` maps an executor kind to its buckets;
    ``build_fn(kind, bucket, batch)`` -> :class:`Executor`;
    ``pad_slice_fn(request, chunk, kind)`` -> one chunk's args (leading axis
    1, candidate axis padded to the bucket); ``gather_fn(rows, chunks, m,
    kind)`` -> the request's output.  Per (kind, bucket) there are
    ``n_streams`` dispatcher threads, each owning one executor of its own
    (``build_fn`` is called once per dispatcher): on CUDA its own graph,
    static buffers, graph memory pool and stream, which the thread enters
    once, so two dispatchers of one (kind, bucket) replay at the same time
    and a dispatch waits for its own stream alone.  Each chunk's arguments
    stay referenced until its dispatch has finished, so the caching
    allocator cannot hand their memory to another stream while this one
    reads it.

    * **Outputs** — each rider gets its own rows (leading axis 1), cloned
      out of the executor's static outputs: host numpy, or device tensors
      for executors built with ``host_output=False`` (the encode family).
    * **KV-row dedup** — ``dedup_kinds`` maps a kind to its number of
      leading args deduped per dispatch: chunks carrying the same arg
      objects or the same ``dedup_token`` stack those args once, and the
      executor receives an extra ``[B] int32`` row index (inserted after the
      deduped args) that the fused kernel folds into its history reads.
    * **Segment packing** — ``packed_kinds`` maps a kind to its number of
      leading KV args, like ``dedup_kinds``, but partial chunks of
      different requests also share rows: ``pad_slice_fn`` returns the
      chunk's candidates UNPADDED (``(1, valid)``, last arg), and the
      executor takes ``(*kv_rows [batch], seg_index [rows, bucket],
      candidates [rows, bucket])``, where ``seg_index`` maps every slot to
      its stacked KV row (dead slots: row 0, candidate -1).  Each chunk's
      future resolves to the ``[1, valid, ...]`` slice of its segment.
      Packing subsumes dedup (same-identity chunks share a KV slot; the
      saving counts into ``dedup_rows_saved``); a kind is in one map or
      the other."""

    def __init__(self, build_fn: Callable, *, pad_slice_fn: Callable,
                 gather_fn: Callable, families: Dict[str, Sequence[int]],
                 policy: CoalescePolicy = CoalescePolicy(),
                 n_streams: int = 2,
                 dedup_kinds: Optional[Dict[str, int]] = None,
                 packed_kinds: Optional[Dict[str, int]] = None,
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.001):
        self.families: Dict[str, List[int]] = {
            kind: sorted(set(bs), reverse=True)
            for kind, bs in families.items()}
        self.policy = policy
        self.pad_slice = pad_slice_fn
        self.gather = gather_fn
        self._dedup: Dict[str, int] = dict(dedup_kinds or {})
        self._packed: Dict[str, int] = dict(packed_kinds or {})
        overlap = set(self._dedup) & set(self._packed)
        if overlap:
            raise ValueError(f"kinds {sorted(overlap)} registered as both "
                             f"dedup and packed: packing subsumes dedup")
        self.chunk_count = 0
        self.dispatch_count = 0
        self.rows_dispatched = 0       # real (non-padding) rows
        self.dedup_rows_saved = 0      # restacks avoided by dedup/packing
        self.packed_rows = 0           # rows carrying >= 1 packed segment
        self.packed_segments = 0       # segments dispatched via packing
        self.dispatch_failure_count = 0    # batches failed into futures
        self._fault_hook = fault_hook
        self._dispatch_retries = max(0, int(dispatch_retries))
        self._retry_backoff_s = float(retry_backoff_s)
        self.dispatch_retry_count = 0      # transient failures retried
        # graceful degradation: a non-None override caps the coalescing
        # window (level >= 1 sets 0.0 — flush immediately)
        self._window_override: Optional[float] = None
        self.queue_delay_total_s = 0.0
        self.queue_delay_count = 0
        self.kind_chunks: Dict[str, int] = {k: 0 for k in self.families}
        self.kind_dispatches: Dict[str, int] = {k: 0 for k in self.families}
        #: seconds spent in each kind's executor calls (until the device
        #: finished), for the per-dispatch breakdown
        self.kind_busy_s: Dict[str, float] = {k: 0.0 for k in self.families}
        #: the longest of each kind's executor calls
        self.kind_max_s: Dict[str, float] = {k: 0.0 for k in self.families}
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
        #: (kind, bucket) -> one executor per dispatcher thread
        self.executors: Dict[Tuple[str, int], List[Executor]] = {}

        t0 = time.perf_counter()
        mem0 = reserved_bytes()
        for kind, bs in self.families.items():
            for b in bs:
                self._pending[(kind, b)] = []
                self._cond[(kind, b)] = threading.Condition()
                self.slot_count[(kind, b)] = 0
                self.valid_count[(kind, b)] = 0
                exs = [build_fn(kind, b, policy.batch)
                       for _ in range(n_streams)]
                self.executors[(kind, b)] = exs
                for s, ex in enumerate(exs):
                    self._threads.append(threading.Thread(
                        target=self._worker, args=(kind, b, ex),
                        name=f"dso-{kind}-b{b}-s{s}", daemon=True))
        #: construction of every executor, their CUDA-graph captures
        #: included; ``graph_capture_s`` is the captures' (warm-ups') share
        self.build_time_s = time.perf_counter() - t0
        self.graph_capture_s = sum(ex.capture_s for exs in
                                   self.executors.values() for ex in exs)
        #: device memory the executors hold after construction (static
        #: buffers and graph pools; the allocator's reserve before and after)
        self.graph_bytes = reserved_bytes() - mem0
        # the threads start only now: no capture overlaps other CUDA work
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

    def set_window_override(self, window_s: Optional[float]):
        """Degradation hook: cap the coalescing window at ``window_s`` (0.0
        flushes immediately); ``None`` restores the policy's window."""
        with self._stat_lock:
            self._window_override = window_s

    # ---- dispatcher ----
    @staticmethod
    def _ident(c: _PendingChunk, n_lead: int) -> Hashable:
        return c.dedup_token if c.dedup_token is not None \
            else tuple(id(a) for a in c.args[:n_lead])

    def _collect(self, kind: str, bucket: int, pending: List[_PendingChunk],
                 cond: threading.Condition, batch: List[_PendingChunk]
                 ) -> Optional[SegmentPacker]:
        """Pop the first chunk and keep collecting co-riders into the
        caller-owned ``batch`` (caller holds ``cond``) until the dispatch is
        full, the window closes, or waiting longer would overrun the
        earliest collected deadline.  A packed kind places every chunk with
        a :class:`SegmentPacker` (returned): it takes the earliest pending
        chunk that fits, skipping a head segment too large for the rows
        left, which leads the next dispatch instead."""
        pol = self.policy
        n_lead = self._packed.get(kind)
        packer = SegmentPacker(bucket, pol.rows, pol.batch,
                               align=pol.pack_align) \
            if n_lead is not None else None

        def take() -> bool:
            if packer is None:
                if len(batch) >= pol.batch or not pending:
                    return False
                batch.append(heapq.heappop(pending))
                return True
            skipped: List[_PendingChunk] = []
            got = False
            while pending:
                c = heapq.heappop(pending)
                if packer.try_add(c.valid, self._ident(c, n_lead)) \
                        is not None:
                    batch.append(c)
                    got = True
                    break
                skipped.append(c)
            for c in skipped:
                heapq.heappush(pending, c)
            return got

        take()      # the first chunk always fits an empty dispatch
        with self._stat_lock:
            override = self._window_override
        window = pol.window_s if override is None \
            else min(pol.window_s, override)
        t_open = time.perf_counter()
        while pol.enabled and not self._stop:
            if packer.is_full() if packer is not None \
                    else len(batch) >= pol.max_batch:
                break
            if pending:
                if take():
                    continue
                break           # nothing pending fits: flush what we have
            if packer is not None and len(batch) >= pol.max_batch:
                # the unpacked fill target's worth of chunks in fewer rows:
                # waiting for more would trade latency for slots the
                # in-flight load cannot fill (pending ones still pack)
                break
            scale = min(pol.tier_scale(c.tier) for c in batch)
            target = t_open + window * scale
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
        return packer

    def _worker(self, kind: str, bucket: int, ex: Executor):
        cond, pending = self._cond[(kind, bucket)], \
            self._pending[(kind, bucket)]  # flamecheck: unguarded-ok(dicts frozen after __init__; the heap is only touched under cond)
        with ex.stream_scope():
            while True:
                batch: List[_PendingChunk] = []
                with cond:
                    while not pending and not self._stop:
                        cond.wait()
                    if not pending and self._stop:
                        return
                    packer = self._collect(kind, bucket, pending, cond,
                                           batch)
                if packer is not None:
                    self._dispatch_packed(kind, bucket, ex, batch, packer)
                else:
                    self._dispatch(kind, bucket, ex, batch)

    def _dispatch(self, kind: str, bucket: int, ex: Executor,
                  batch: List[_PendingChunk]):
        n = len(batch)
        try:
            B = self.policy.batch
            stacked = []     # per executor arg: its row blocks, in order
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
                    stacked.append([u[j] for u in uniq])
                stacked.append(idx)
                rests = [c.args[n_lead:] for c in batch]
            for j in range(len(rests[0])):
                stacked.append([r[j] for r in rests])
            t0 = time.perf_counter()
            # stages the rows into the static buffers, replays, and returns
            # each rider's rows once the device has finished (results are
            # final before any future resolves)
            out = self._run_attempts(kind, bucket, ex, stacked, rows=n)
            self._note_dispatch(kind, bucket, batch, rows_used=n,
                                saved=n - n_uniq,
                                dt=time.perf_counter() - t0, packed=False)
            for c, rows in zip(batch, out):
                c.future.set_result(rows)
        except Exception as e:  # noqa: BLE001 — fail every rider
            self._fail(batch, e)

    def _dispatch_packed(self, kind: str, bucket: int, ex: Executor,
                         batch: List[_PendingChunk], packer: SegmentPacker):
        """One packed dispatch: stack each unique KV identity once (in slot
        order), build the ``[rows, bucket]`` seg-index and candidate planes
        from the packer's placements, run the executor, and hand each
        segment its ``[1, valid, ...]`` slice of the output."""
        try:
            n_lead = self._packed[kind]
            uniq: List[Optional[tuple]] = [None] * packer.n_slots
            for c in batch:
                slot = packer.slot_of[self._ident(c, n_lead)]
                if uniq[slot] is None:
                    uniq[slot] = c.args[:n_lead]
            stacked = [[u[j] for u in uniq] for j in range(n_lead)]
            rows = self.policy.rows
            seg = np.zeros((rows, bucket), np.int32)
            cands = np.full((rows, bucket), -1, np.int32)
            for c, (row, off, slot) in zip(batch, packer.placements):
                cands[row, off:off + c.valid] = np.asarray(c.args[n_lead])[0]
                seg[row, off:off + c.valid] = slot
            t0 = time.perf_counter()
            out = self._run_attempts(kind, bucket, ex, stacked + [seg, cands])
            self._note_dispatch(kind, bucket, batch, rows_used=packer.n_rows,
                                saved=len(batch) - packer.n_slots,
                                dt=time.perf_counter() - t0, packed=True)
            for c, (row, off, _) in zip(batch, packer.placements):
                c.future.set_result(tree_map(
                    lambda a: a[row:row + 1, off:off + c.valid], out))
        except Exception as e:  # noqa: BLE001 — fail every rider
            self._fail(batch, e)

    def _run_attempts(self, kind: str, bucket: int, ex: Executor, args,
                      **kw):
        """Fire the fault hook, then call the executor; an exception with a
        truthy ``.transient`` (the ``serving.faults.FaultInjected``
        contract) is retried with exponential backoff up to
        ``dispatch_retries`` times.  The hook fires before ``ex`` stages
        anything, and a call stages every argument afresh before its
        replay, so a retry replays the same captured graph over the batch's
        own rows and leaves no half-staged batch behind.  An error raised by
        CUDA carries no ``.transient``: after a device fault the context is
        not trusted, so it is never retried.  Anything not retried
        propagates, and the caller fails every rider with it."""
        attempt = 0
        while True:
            try:
                if self._fault_hook is not None:
                    self._fault_hook(kind, bucket)
                return ex(*args, **kw)
            except Exception as e:  # noqa: BLE001 — classified below
                if not getattr(e, "transient", False) \
                        or attempt >= self._dispatch_retries:
                    raise
                attempt += 1
                with self._stat_lock:
                    self.dispatch_retry_count += 1
                time.sleep(self._retry_backoff_s * (2 ** (attempt - 1)))

    def _note_dispatch(self, kind: str, bucket: int,
                       batch: List[_PendingChunk], *, rows_used: int,
                       saved: int, dt: float, packed: bool):
        now = time.perf_counter()
        key = (kind, bucket)
        with self._stat_lock:
            self.dispatch_count += 1
            self.kind_dispatches[kind] += 1
            self.kind_busy_s[kind] += dt
            self.kind_max_s[kind] = max(self.kind_max_s[kind], dt)
            self.rows_dispatched += len(batch)
            self.dedup_rows_saved += saved
            self.slot_count[key] += rows_used * bucket
            self.valid_count[key] += sum(c.valid for c in batch)
            self.deadline_miss_chunks[kind] += sum(
                1 for c in batch
                if c.deadline is not None and now > c.deadline)
            if packed:
                self.packed_rows += rows_used
                self.packed_segments += len(batch)
            old = self._cost.get(key)
            self._cost[key] = dt if old is None else \
                (1 - self._COST_EWMA) * old + self._COST_EWMA * dt

    def _fail(self, batch: List[_PendingChunk], e: Exception):
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
                "packed_rows": self.packed_rows,
                "packed_segments": self.packed_segments,
                "cand_slots": slots,
                "cand_valid": valid,
                "padded_fraction": 1.0 - valid / slots if slots else 0.0,
                "queue_delay_ms": (1e3 * self.queue_delay_total_s
                                   / max(self.queue_delay_count, 1)),
                "dispatch_retries": self.dispatch_retry_count,
                "dispatch_failures": self.dispatch_failure_count,
                "deadline_miss_chunks": sum(
                    self.deadline_miss_chunks.values()),
            }
            for kind in self.families:
                out[f"chunks_{kind}"] = self.kind_chunks[kind]
                out[f"dispatches_{kind}"] = self.kind_dispatches[kind]
                out[f"deadline_miss_chunks_{kind}"] = \
                    self.deadline_miss_chunks[kind]
                out[f"dispatch_ms_{kind}"] = (
                    1e3 * self.kind_busy_s[kind]
                    / max(self.kind_dispatches[kind], 1))
                out[f"dispatch_max_ms_{kind}"] = 1e3 * self.kind_max_s[kind]
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


# ---------------------------------------------------------------------------
# implicit-shape baseline (the paper's "Default" row in Table 5)
# ---------------------------------------------------------------------------

class ImplicitShapeEngine:
    """The counterpart of ``jax.jit`` over ``fn`` (``repro/core/dso.py:1021``):
    every novel candidate count ``m`` gets a fixed-shape :class:`Executor`
    of the request's own shapes at first use, in band, counted in
    ``compiles``; later calls with that ``m`` reuse it.  On CUDA the
    executor is a CUDA graph captured by that first call (warm-ups
    included; a capture that fails raises, nothing runs eagerly instead),
    on the CPU it runs eagerly.

    A graph's static buffers admit one call at a time: each ``m`` has a
    lock, held until the call's outputs have been copied to the host.
    Captures are serialized by one lock, and nothing else of this engine
    allocates device memory, so no other thread's work lands in a
    capture.  ``capture_s`` and ``graph_bytes`` (the allocator's reserve
    around each capture) grow with the set of ``m`` seen, as a jit cache
    does."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.compiles = 0
        self.capture_s = 0.0
        self.graph_bytes = 0
        self.executors: Dict[Hashable, Executor] = {}
        self._locks: Dict[Hashable, threading.Lock] = {}
        self._table_lock = threading.Lock()
        self._capture_lock = threading.Lock()

    def score(self, request: Sequence, m: int):
        """Run ``fn`` on ``request`` (host arrays or tensors whose shapes
        are fixed by ``m``); returns its outputs as numpy arrays."""
        with self._table_lock:
            lock = self._locks.setdefault(m, threading.Lock())
        with lock:
            ex = self.executors.get(m)
            if ex is None:
                specs = [TensorSpec(tuple(a.shape), torch.as_tensor(a).dtype)
                         for a in request]
                with self._capture_lock:
                    mem0 = reserved_bytes()
                    ex = Executor(self.fn, specs, self.device)
                    self.graph_bytes += reserved_bytes() - mem0
                    self.capture_s += ex.capture_s
                    self.compiles += 1
                self.executors[m] = ex
            return ex(*request)
