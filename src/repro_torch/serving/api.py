"""FLAME Serving API v2 — the request/response surface every engine speaks.

The serving system is addressed through four pieces (see DESIGN.md for the
full request lifecycle diagram):

  ServeRequest / ServeResponse   frozen value types crossing the API boundary
  ResponseFuture                 handle returned by ``submit``; resolves to a
                                 ServeResponse once the pipeline finishes
  ServingEngine                  the protocol all engines implement:
                                 ``submit`` (async), ``serve`` (blocking
                                 sugar), ``metrics``, ``shutdown``
  engine registry                name -> factory, so launchers/benchmarks
                                 select engines with ``--engine flame``

Engines register themselves with :func:`register_engine`; callers construct
them with :func:`create_engine` and never import concrete classes.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import (Any, Callable, Dict, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

_REQUEST_IDS = itertools.count()


# ---------------------------------------------------------------------------
# SLO tiers
# ---------------------------------------------------------------------------

#: Service tiers, best-first.  ``interactive`` is user-facing traffic with a
#: tight budget, ``standard`` is the default, ``bulk`` is background re-rank
#: work that tolerates queueing.  Under overload the engine sheds/degrades
#: bulk first and interactive last (see ``engine._AdmissionQueue``).
SLO_TIERS = ("interactive", "standard", "bulk")

#: Tier -> shed/EDF priority rank (lower = more protected).
TIER_RANK = {t: i for i, t in enumerate(SLO_TIERS)}

#: Tier -> default ``deadline_s`` applied by tier-aware engines when a
#: request carries no explicit deadline (engine-overridable via the
#: ``slo_tier_defaults`` knob / ``--slo-tier-defaults`` CLI flag).
DEFAULT_TIER_DEADLINES = {
    "interactive": 0.05,
    "standard": 0.25,
    "bulk": 2.0,
}


# ---------------------------------------------------------------------------
# value types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopKConfig:
    """Generative decode: grow ``k`` sequences greedily for ``steps`` steps
    (each step keeps the top-k single-token continuations of each sequence's
    own greedy path — k independent greedy beams seeded by the top-k first
    tokens).  ``eos`` (an item id) finishes a sequence early — a finished
    sequence stops decoding and, once every sequence has finished, the
    remaining steps are skipped (counted in ``gen_early_exits``)."""

    k: int = 4
    steps: int = 8
    eos: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Generative decode: beam search of ``width`` hypotheses for ``steps``
    steps, ranked by cumulative log-probability; ``eos`` (an item id)
    finishes a hypothesis early — finished beams keep their score and are
    never re-expanded."""

    width: int = 4
    steps: int = 8
    eos: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One upstream request.

    Recommendation engines read ``history`` (item ids) and ``candidates``
    (item ids to score); text engines read ``history`` as prompt token ids
    and generate ``n_tokens``.  ``user_id`` is an optional stable upstream
    identity: cache-aware engines key their history-KV pool by it (falling
    back to a content hash of the history when absent), so repeat-user and
    session-re-rank traffic reuses the cached history encode.

    ``deadline_s`` is an optional per-request latency budget (seconds,
    relative to ``arrival_t``).  Deadline-aware engines order their flush
    queues earliest-deadline-first against it and count overruns in the
    ``deadline_misses`` metric; ``None`` defers to the engine's default
    budget (which may be "no deadline").

    ``slo_tier`` (one of :data:`SLO_TIERS`) places the request on a service
    tier: tier-aware engines derive a default deadline from it (when
    ``deadline_s`` is None), order EDF admission ties by tier, shed
    lowest-tier work first under overload, and degrade bulk-tier service
    first under sustained pressure.
    """

    history: np.ndarray
    candidates: Optional[np.ndarray] = None
    n_tokens: int = 16
    # generative decode: a TopKConfig/BeamConfig here asks the engine to
    # GENERATE candidate sequences over the item vocabulary instead of
    # scoring a provided list; ``candidates``, when also given, restricts
    # the per-step token universe to those ids.  The response ``output`` is
    # then ``[width, steps]`` generated item ids, best-first (-1 pads a
    # sequence that finished early).
    generate: Optional[object] = None
    user_id: Optional[int] = None
    deadline_s: Optional[float] = None
    slo_tier: str = "standard"
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS))
    arrival_t: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def m(self) -> int:
        """Number of candidates (0 for text requests)."""
        return 0 if self.candidates is None else int(self.candidates.shape[0])


@dataclasses.dataclass(frozen=True)
class ServeResponse:
    """Pipeline output for one request.

    ``output`` is ``[M, num_tasks]`` scores for recommendation engines, or a
    ``[n_tokens]`` generated-id array for text engines.  ``timings`` breaks
    the latency into pipeline stages (queue / features / execute).
    """

    request_id: int
    output: np.ndarray
    latency_s: float
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


class ResponseFuture:
    """Handle for an in-flight request; resolves to a :class:`ServeResponse`."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self._f: "Future[ServeResponse]" = Future()

    # ---- consumer side ----
    def done(self) -> bool:
        return self._f.done()

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        return self._f.result(timeout)

    def scores(self, timeout: Optional[float] = None) -> np.ndarray:
        """Convenience: block and return just the output array."""
        return self.result(timeout).output

    def add_done_callback(self, fn: Callable[["ResponseFuture"], None]):
        self._f.add_done_callback(lambda _: fn(self))

    # ---- engine side ----
    def set_result(self, response: ServeResponse):
        self._f.set_result(response)

    def set_exception(self, exc: BaseException):
        self._f.set_exception(exc)


class RejectedError(RuntimeError):
    """Base of every admission-side rejection (overload discipline): the
    engine refused to spend compute on the request.  Callers that tolerate
    shedding catch this one type; the concrete subclasses say why.

    Shedding rejections may carry a ``retry_after_s`` attribute — the
    engine's queue-delay-EWMA estimate of how long the current backlog
    takes to drain — so a well-behaved caller backs off for about one
    drain interval instead of hammering an overloaded engine."""

    retry_after_s: Optional[float] = None


class AdmissionQueueFull(RejectedError):
    """Raised by ``submit`` when the bounded admission queue stays full past
    the caller's timeout (the backpressure signal)."""


class DeadlineExceeded(RejectedError):
    """Raised by ``submit`` when the request's deadline budget has already
    passed at admission time (counted in the ``deadline_shed`` metric):
    executing it would burn an executor slot on a guaranteed miss, so
    deadline-aware engines shed it instead."""


class ShedError(RejectedError):
    """The overloaded engine dropped this request to protect higher-tier /
    earlier-deadline work (counted per tier in ``shed_{tier}``).  Raised
    from ``submit`` when the incoming request itself is the lowest-priority
    work in sight, or delivered through a queued victim's
    :class:`ResponseFuture` when a higher-priority arrival displaced it."""


class DegradedError(RejectedError):
    """A degraded engine (level >= 3) refused the expensive path for a
    bulk-tier request — pool re-encode fell back to cached-hit-or-shed and
    the pool had no fresh entry.  Delivered through the request's future."""


class WatchdogTimeout(RuntimeError):
    """The engine watchdog failed this future ``grace`` seconds past its
    deadline without a response — the no-request-ever-hangs backstop for
    wedged workers / lost dispatches.  Not a :class:`RejectedError`: the
    request was admitted, then lost to a fault."""


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class ServeMetrics:
    """Thread-safe request/latency accounting shared by all engines.

    ``record`` is called from pipeline worker threads concurrently; every
    mutation happens under one lock (the unguarded ``requests += 1`` and
    first/last-timestamp updates used to race under ``run_workload``'s
    thread pool)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.items = 0
        self.first_t = 0.0
        self.last_t = 0.0
        self.latencies: list = []
        self.gauges: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}

    def record(self, n_items: int, latency_s: float):
        now = time.perf_counter()
        with self._lock:
            if self.requests == 0:
                self.first_t = now - latency_s
            self.last_t = now
            self.requests += 1
            self.items += n_items
            self.latencies.append(latency_s)

    def set_gauge(self, name: str, value: float):
        """Point-in-time engine gauge surfaced in ``summary()`` — e.g. the
        history-KV pool's byte accounting (``pool_bytes_used`` vs its
        configured budget), the DSO's cumulative ``padded_fraction``
        (candidate-slot padding dispatched vs reclaimed by segment
        packing) and ``queue_delay_ms`` (mean chunk enqueue-to-dispatch
        delay), updated by the engine as requests flow."""
        with self._lock:
            self.gauges[name] = float(value)

    def incr(self, name: str, by: int = 1):
        """Monotonic engine counter surfaced in ``summary()`` — e.g.
        ``deadline_misses`` (requests that resolved after their
        ``ServeRequest.deadline_s`` budget)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def summary(self) -> Dict[str, float]:
        with self._lock:
            lat = np.array(self.latencies) if self.latencies else np.zeros(1)
            wall = max(self.last_t - self.first_t, 1e-9)
            return {
                "requests": self.requests,
                "throughput_items_per_s": self.items / wall,
                "mean_latency_ms": float(lat.mean() * 1e3),
                "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
                **self.gauges,
                **self.counters,
            }


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------

class DegradationPolicy:
    """Steps service down under sustained pressure instead of failing.

    Pipeline workers feed every request's queue delay into ``observe``; the
    policy keeps an EWMA and walks a ladder of degradation levels with
    hysteresis (a dwell time between steps, and a lower recovery threshold
    so the level is reversible without flapping):

      level 0  full service
      level 1  flush immediately — coalescing windows collapse to zero,
               trading batch fill for latency
      level 2  + bulk-tier generation shrinks (beam width and gen steps
               halve), bounding worst-case work per bulk request
      level 3  + bulk-tier history encode falls back to cached-hit-or-shed
               (pool miss => DegradedError instead of an encode dispatch)

    Engines surface the current level as the ``degrade_level`` gauge and
    count transitions in ``degrade_steps``.  Thread-safe; ``observe`` is
    called from every worker."""

    MAX_LEVEL = 3

    def __init__(self, threshold_s: float = 0.05, *,
                 recover_s: Optional[float] = None, alpha: float = 0.3,
                 max_level: int = MAX_LEVEL, dwell_s: float = 0.25):
        if threshold_s <= 0:
            raise ValueError(f"threshold_s must be > 0, got {threshold_s}")
        self.threshold_s = float(threshold_s)
        self.recover_s = float(recover_s if recover_s is not None
                               else threshold_s * 0.5)
        self.alpha = float(alpha)
        self.max_level = int(max_level)
        self.dwell_s = float(dwell_s)
        self._lock = threading.Lock()
        self._ewma: Optional[float] = None
        self._level = 0
        self._last_step_t: Optional[float] = None

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def ewma_s(self) -> float:
        with self._lock:
            return self._ewma or 0.0

    def observe(self, delay_s: float, now: Optional[float] = None) -> int:
        """Fold one queue-delay sample in; returns the (possibly stepped)
        level.  Steps are rate-limited to one per ``dwell_s`` so a single
        burst doesn't slam the ladder to the floor."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            self._ewma = delay_s if self._ewma is None else \
                self.alpha * delay_s + (1.0 - self.alpha) * self._ewma
            dwelled = (self._last_step_t is None
                       or now - self._last_step_t >= self.dwell_s)
            if dwelled and self._ewma > self.threshold_s \
                    and self._level < self.max_level:
                self._level += 1
                self._last_step_t = now
            elif dwelled and self._ewma < self.recover_s and self._level > 0:
                self._level -= 1
                self._last_step_t = now
            return self._level


# ---------------------------------------------------------------------------
# engine protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class ServingEngine(Protocol):
    """What every serving engine exposes, regardless of model family."""

    def submit(self, request: ServeRequest, *,
               timeout: Optional[float] = None) -> ResponseFuture:
        """Admit a request into the pipeline; returns immediately with a
        future.  Blocks (up to ``timeout``) when the admission queue is
        full; raises :class:`AdmissionQueueFull` on timeout."""
        ...

    def serve(self, history: np.ndarray,
              candidates: Optional[np.ndarray] = None, **kw) -> np.ndarray:
        """Blocking sugar: submit one request and wait for its output."""
        ...

    def metrics(self) -> Dict[str, Any]:
        """Unified metrics snapshot (request stats + engine internals)."""
        ...

    def shutdown(self) -> None:
        ...


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

_ENGINES: Dict[str, Callable[..., ServingEngine]] = {}


def register_engine(name: str):
    """Class/factory decorator: ``@register_engine("flame")``."""
    def deco(factory):
        _ENGINES[name] = factory
        return factory
    return deco


def available_engines() -> Sequence[str]:
    return sorted(_ENGINES)


def create_engine(name: str, *args, **kwargs) -> ServingEngine:
    try:
        factory = _ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; "
                       f"available: {list(available_engines())}") from None
    return factory(*args, **kwargs)
