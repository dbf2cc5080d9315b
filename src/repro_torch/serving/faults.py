"""Chaos injection for the serving stack.  Port of
``repro/serving/faults.py``, line for line: the same arms, spec grammar and
one seeded ``random.Random``, so a ``(spec, seed)`` pair gives the same
fault schedule in both packages for the same call order.

A :class:`FaultInjector` is a deterministic, seedable source of the faults
a production replica sees, wired into the engine's hook points:

  ``dispatch(kind, bucket)``   raised in the DSO's dispatch attempt loop,
                               before the executor stages anything — a
                               transient :class:`FaultInjected` is retried
                               with backoff (a retry stages the rows again
                               and replays the same captured CUDA graph);
                               a fatal one fails every rider's
                               ResponseFuture (never strands a batch).
  ``worker_stall()``           sleeps a pipeline worker mid-request — the
                               watchdog (deadline + grace) is the backstop.
  ``pool_storm(pool)``         eviction storm: drops a fraction of the
                               HistoryKVPool's entries, forcing re-encodes
                               (a cold-restart / pressure-spike stand-in).

Every arm is an independent Bernoulli roll from one seeded PRNG, so a given
(spec, seed) pair replays the identical fault schedule — chaos tests are
regular deterministic tests.  All hooks are thread-safe.

Spec grammar (CLI ``--fault-spec``), comma-separated arms:

  ``dispatch:P[:TIMES]``        transient dispatch failure with prob P,
                                at most TIMES fires (default unlimited)
  ``dispatch_fatal:P[:TIMES]``  same, but non-transient (no retry)
  ``stall:P[:SECONDS]``         worker stall of SECONDS (default 0.01)
  ``evict:P[:FRACTION]``        pool eviction storm dropping FRACTION of
                                entries (default 0.5)

e.g. ``--fault-spec dispatch:0.2,stall:0.1:0.02,evict:0.1``.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional


class FaultInjected(RuntimeError):
    """An injected fault.  ``transient=True`` marks it retryable: the DSO's
    dispatch loop retries it with backoff; a non-transient instance (or an
    exhausted retry budget) propagates into the affected futures."""

    def __init__(self, message: str, *, transient: bool = True):
        super().__init__(message)
        self.transient = transient


class _Arm:
    """One fault arm: Bernoulli(p), optionally capped at ``times`` fires."""

    def __init__(self, p: float, times: Optional[int] = None,
                 arg: float = 0.0):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        self.p = float(p)
        self.times = times
        self.arg = float(arg)
        self.fired = 0

    def roll(self, rng: random.Random) -> bool:
        """Caller holds the injector lock."""
        if self.p <= 0.0 or (self.times is not None
                             and self.fired >= self.times):
            return False
        if rng.random() >= self.p:
            return False
        self.fired += 1
        return True


class FaultInjector:
    """Deterministic fault source; see the module docstring for semantics.

    Construct programmatically (tests) or via :meth:`parse` (CLI).  A zero
    probability disables an arm, so the default injector is inert."""

    def __init__(self, *, dispatch_p: float = 0.0,
                 dispatch_times: Optional[int] = None,
                 dispatch_transient: bool = True,
                 stall_p: float = 0.0, stall_s: float = 0.01,
                 evict_p: float = 0.0, evict_fraction: float = 0.5,
                 seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._dispatch = _Arm(dispatch_p, dispatch_times)
        self._dispatch_transient = bool(dispatch_transient)
        self._stall = _Arm(stall_p, arg=stall_s)
        self._evict = _Arm(evict_p, arg=evict_fraction)
        self.spec = (f"dispatch:{dispatch_p},stall:{stall_p}:{stall_s},"
                     f"evict:{evict_p}:{evict_fraction}")

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Build an injector from the CLI spec grammar (module docstring)."""
        kw: Dict[str, object] = {"seed": seed}
        for arm in filter(None, (a.strip() for a in spec.split(","))):
            parts = arm.split(":")
            name, p = parts[0], float(parts[1]) if len(parts) > 1 else 0.0
            arg = float(parts[2]) if len(parts) > 2 else None
            if name == "dispatch" or name == "dispatch_fatal":
                kw["dispatch_p"] = p
                kw["dispatch_transient"] = name == "dispatch"
                if arg is not None:
                    kw["dispatch_times"] = int(arg)
            elif name == "stall":
                kw["stall_p"] = p
                if arg is not None:
                    kw["stall_s"] = arg
            elif name == "evict":
                kw["evict_p"] = p
                if arg is not None:
                    kw["evict_fraction"] = arg
            else:
                raise ValueError(f"unknown fault arm {name!r} in {spec!r}")
        inj = cls(**kw)          # type: ignore[arg-type]
        inj.spec = spec
        return inj

    # ---- hook points (called from engine / DSO threads) ----
    def dispatch(self, kind: str, bucket: int) -> None:
        """DSO pre-executor hook: maybe raise a dispatch failure."""
        with self._lock:
            fire = self._dispatch.roll(self._rng)
            transient = self._dispatch_transient
        if fire:
            raise FaultInjected(
                f"injected dispatch failure ({kind}, b{bucket})",
                transient=transient)

    def worker_stall(self) -> None:
        """Pipeline-worker hook: maybe stall this worker."""
        with self._lock:
            fire = self._stall.roll(self._rng)
            dur = self._stall.arg
        if fire:
            time.sleep(dur)

    def pool_storm(self, pool) -> int:
        """Maybe drop a fraction of ``pool``'s primary-tier entries (via
        ``HistoryKVPool.drop``); returns the number evicted."""
        with self._lock:
            fire = self._evict.roll(self._rng)
            frac = self._evict.arg
            if fire:
                # draw victims under the same lock so the schedule stays
                # a pure function of (spec, seed, call order)
                keys = pool.keys()
                n = max(1, int(len(keys) * frac)) if keys else 0
                victims = self._rng.sample(keys, n) if n else []
        if not fire:
            return 0
        dropped = 0
        for k in victims:
            dropped += int(pool.drop(k))
        return dropped

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "fault_dispatch_fired": self._dispatch.fired,
                "fault_stall_fired": self._stall.fired,
                "fault_evict_fired": self._evict.fired,
            }
