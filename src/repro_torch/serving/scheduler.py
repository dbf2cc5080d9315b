"""Mixed-traffic workload generator and runner (paper §4.2.3 simulation).

Generates requests whose candidate counts follow the paper's non-uniform
upstream distribution (uniform over {128,256,512,1024} in Table 5, plus
zipf-skewed and heavy-tailed lognormal variants) and drives them through an
engine, concurrently, collecting the throughput / latency / P99 metrics of
Table 5.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.api import (SLO_TIERS, RejectedError, ServeRequest,
                               ServingEngine)


@dataclasses.dataclass
class TrafficConfig:
    candidate_counts: Sequence[int] = (128, 256, 512, 1024)
    # uniform | zipf | jittered | lognormal — ``zipf`` skews over the fixed
    # counts (most requests draw the smallest); ``lognormal`` is the
    # heavy-tailed continuous variant (median at the middle count, clipped
    # to [1, max]): almost every M is tiny and non-bucket-aligned, the
    # regime where tail-chunk padding dominates dispatch cost
    distribution: str = "uniform"
    n_requests: int = 64
    n_history: int = 1024
    concurrency: int = 4
    seed: int = 0
    # repeat-user / session-re-rank profile: > 0 draws each request's user
    # from a fixed population whose histories are stable across requests, so
    # the same user re-ranks fresh candidate slates against one history —
    # the regime where a history-KV pool converts full passes into
    # candidate-only passes.  0 keeps the legacy one-user-per-request shape.
    n_users: int = 0
    # SLO tier mix: weights over {interactive, standard, bulk} — each
    # request draws its ``slo_tier`` from this distribution (the overload
    # bench's tiered traffic).  None keeps every request tier-less
    # ("standard"), the pre-overload-discipline shape.
    tier_mix: Optional[Dict[str, float]] = None


def generate_traffic(tc: TrafficConfig, n_items: int = 100_000
                     ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(tc.seed)
    user_hist = {}
    tiers, tier_p = None, None
    if tc.tier_mix:
        bad = set(tc.tier_mix) - set(SLO_TIERS)
        if bad:
            raise ValueError(f"unknown SLO tiers in tier_mix: {bad}")
        tiers = sorted(tc.tier_mix)
        w = np.array([tc.tier_mix[t] for t in tiers], float)
        tier_p = w / w.sum()
    reqs = []
    for _ in range(tc.n_requests):
        if tc.distribution == "uniform":
            m = int(rng.choice(tc.candidate_counts))
        elif tc.distribution == "zipf":
            idx = min(len(tc.candidate_counts) - 1, rng.zipf(2.0) - 1)
            m = int(sorted(tc.candidate_counts)[idx])
        elif tc.distribution == "lognormal":
            counts = sorted(tc.candidate_counts)
            med = counts[len(counts) // 2]
            m = int(np.clip(rng.lognormal(np.log(med), 1.0), 1, counts[-1]))
        else:  # jittered: non-bucket-aligned counts (the hard case)
            base = int(rng.choice(tc.candidate_counts))
            m = max(1, base - int(rng.integers(0, base // 3)))
        req = {"candidates": rng.integers(0, n_items, m).astype(np.int32)}
        if tiers is not None:
            req["slo_tier"] = tiers[int(rng.choice(len(tiers), p=tier_p))]
        if tc.n_users > 0:
            uid = int(rng.integers(tc.n_users))
            if uid not in user_hist:
                user_hist[uid] = rng.integers(
                    0, n_items, tc.n_history).astype(np.int32)
            req["history"] = user_hist[uid]
            req["user_id"] = uid
        else:
            req["history"] = rng.integers(
                0, n_items, tc.n_history).astype(np.int32)
        reqs.append(req)
    return reqs


def run_workload(serve_fn: Callable, requests: List[Dict],
                 concurrency: int = 4) -> Dict[str, float]:
    """serve_fn(history, candidates) -> scores, called from
    ``concurrency`` threads over ``requests``.  Returns workload metrics
    (the JAX package's ``run_workload``)."""
    lat: List[float] = []
    items = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as tp:
        def one(r):
            t = time.perf_counter()
            serve_fn(r["history"], r["candidates"])
            return time.perf_counter() - t, len(r["candidates"])

        for dt, m in tp.map(one, requests):
            lat.append(dt)
            items += m
    total = time.perf_counter() - t0
    la = np.array(lat)
    return {
        "requests": len(requests),
        "total_s": total,
        "throughput_items_per_s": items / total,
        "mean_latency_ms": float(la.mean() * 1e3),
        "p50_latency_ms": float(np.percentile(la, 50) * 1e3),
        "p99_latency_ms": float(np.percentile(la, 99) * 1e3),
    }


def run_workload_async(engine: "ServingEngine", requests: List[Dict], *,
                       arrival_gap_s: float = 0.0, seed: int = 0,
                       tolerate_errors: bool = False,
                       result_timeout_s: float = 120.0
                       ) -> Dict[str, object]:
    """Drive an API v2 engine through ``submit`` — all requests in flight
    together, which is the condition under which the coalescing DSO can
    merge same-bucket chunks from different requests into one dispatch.

    ``arrival_gap_s`` > 0 sleeps a uniform random gap in [0, arrival_gap_s)
    between submits (open-loop jittered arrivals).  Returns throughput / latency
    metrics plus ``outputs`` (per-request score arrays, request order)
    so callers can compare result correctness across engine configs.

    ``tolerate_errors=True`` is the overload/chaos mode: admission-side
    :class:`RejectedError`\\ s and failed futures are COUNTED instead of
    raised (``rejected`` / ``failed`` in the result; latency metrics cover
    the ``resolved`` survivors), and any future still unresolved after
    ``result_timeout_s`` counts as ``hung`` — the liveness number the
    chaos gate asserts is zero.  Rejections carrying a ``retry_after_s``
    backoff hint aggregate into ``retry_after_hinted`` /
    ``retry_after_mean_ms``.  The default (False) keeps the strict v1
    contract: any rejection or failure raises."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    futs = []
    rejected = 0
    retry_hints = []       # retry_after_s backoff hints on rejections
    for r in requests:
        if arrival_gap_s > 0:
            time.sleep(float(rng.uniform(0, arrival_gap_s)))
        try:
            futs.append(engine.submit(ServeRequest(
                history=r["history"], candidates=r.get("candidates"),
                user_id=r.get("user_id"), deadline_s=r.get("deadline_s"),
                generate=r.get("generate"),
                slo_tier=r.get("slo_tier", "standard"))))
        except RejectedError as e:
            if not tolerate_errors:
                raise
            rejected += 1
            if getattr(e, "retry_after_s", None) is not None:
                retry_hints.append(float(e.retry_after_s))
            futs.append(None)
    resps, out_reqs, failed, hung = [], [], 0, 0
    for i, f in enumerate(futs):
        if f is None:
            continue
        try:
            resps.append(f.result(result_timeout_s if tolerate_errors
                                  else None))
            out_reqs.append(requests[i])
        except FuturesTimeout:
            if not tolerate_errors:
                raise
            hung += 1
        except RejectedError as e:
            # a queued victim displaced under overload: the ShedError is
            # delivered through its future and prices the same backoff
            if not tolerate_errors:
                raise
            failed += 1
            if getattr(e, "retry_after_s", None) is not None:
                retry_hints.append(float(e.retry_after_s))
        except BaseException:
            if not tolerate_errors:
                raise
            failed += 1
    total = time.perf_counter() - t0
    la = np.array([r.latency_s for r in resps]) if resps else np.zeros(1)
    # generative requests count generated tokens; scoring requests count
    # scored candidates
    items = sum(int((r.output >= 0).sum())
                if out_reqs[i].get("generate") is not None
                else len(out_reqs[i]["candidates"])
                for i, r in enumerate(resps))
    return {
        "requests": len(requests),
        "resolved": len(resps),
        "rejected": rejected,
        "failed": failed,
        "hung": hung,
        "retry_after_hinted": len(retry_hints),
        "retry_after_mean_ms": float(np.mean(retry_hints) * 1e3)
        if retry_hints else 0.0,
        "total_s": total,
        "throughput_items_per_s": items / total,
        "mean_latency_ms": float(la.mean() * 1e3),
        "p50_latency_ms": float(np.percentile(la, 50) * 1e3),
        "p99_latency_ms": float(np.percentile(la, 99) * 1e3),
        "outputs": [r.output for r in resps],
    }
