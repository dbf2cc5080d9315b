"""End-to-end example on the PyTorch port (the paper's kind: SERVING; the
port's twin of ``examples/serve_e2e.py``, at its sizes).

Train a small Climber on synthetic interaction data with planted
preferences, then stand up the FLAME pipeline — PDA feature cache -> DSO
bucket routing over fixed-shape executors (CUDA graphs on the card) ->
SUMI-masked model — and serve a mixed-traffic workload with batched
concurrent requests.  Reports throughput in user-item pairs/s, p50 / p99
latency and cache stats, and checks that the served scores track the
planted preferences and that a pooled history scores as the full pass.

    PYTHONPATH=src python examples/torch_serve_e2e.py               # card
    PYTHONPATH=src python examples/torch_serve_e2e.py --device cpu --small
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import GRInteractionDataset, make_batch_iterator
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.model import build_model
from repro_torch.serving import FlameEngine
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.types import ClimberConfig

#: cached (pooled history) against full-pass scores: two executor families
#: over the same weights, so a tight allclose on sigmoids, not bitwise
TOL = 2e-3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="a narrower model, fewer steps and requests "
                         "(quick CPU runs)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.small:
        n_items, history, steps, n_req, n_check = 4_000, 32, 40, 12, 20
        width = dict(d_model=32, d_ff=128, n_heads=2, n_kv_heads=2,
                     head_dim=16)
        buckets, counts = (32, 16, 8), (8, 16, 32)
    else:
        n_items, history, steps, n_req, n_check = 20_000, 64, 60, 24, 30
        width = dict(d_model=96, d_ff=384, n_heads=4, n_kv_heads=4,
                     head_dim=24)
        buckets, counts = (64, 32, 16), (16, 32, 64)
    m = buckets[-1]

    # ---- 1. train ----
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=n_items, **width,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    bundle = build_model(cfg)
    ds = GRInteractionDataset(n_items=n_items, n_users=2_000, seed=0)
    it = make_batch_iterator(ds, 16, n_history=history, n_candidates=8)
    print(f"[1/4] training climber on synthetic interactions ({device})...")
    params, _, _ = train(bundle, it, steps,
                         AdamWConfig(lr=3e-3, warmup_steps=5),
                         log_every=20, impl="reference", device=device,
                         callback=lambda e: print(
                             f"    step {e['step']:>3} loss {e['loss']:.4f}"))

    # ---- 2. serve through the full FLAME pipeline (API v2) ----
    print("[2/4] building FLAME engine (PDA + coalescing DSO + fixed-shape "
          "executors)...")
    common = dict(n_history=history, buckets=buckets, n_streams=2,
                  feature_mode="sync", coalesce=True, max_batch=4,
                  n_workers=4, device=device)
    # the full pass: the pool off (the port's engine defaults it on)
    eng = FlameEngine(bundle, params, history_cache=False, **common)
    print(f"    executor pool built in {eng.dso.build_time_s:.1f}s "
          f"(batch axis {eng.dso.policy.batch}, CUDA-graph captures "
          f"{eng.dso.graph_capture_s:.1f}s)")
    tc = TrafficConfig(candidate_counts=counts, distribution="jittered",
                       n_requests=n_req, n_history=history, seed=1)
    res = run_workload_async(eng, generate_traffic(tc, n_items=n_items))
    print(f"    {res['requests']} concurrent requests | "
          f"{res['throughput_items_per_s']:.0f} user-item pairs/s | "
          f"p50 {res['p50_latency_ms']:.1f} ms | "
          f"p99 {res['p99_latency_ms']:.1f} ms")
    met = eng.metrics()
    print(f"    PDA cache: {eng.features.stats}")
    print(f"    DSO: {met['dso_chunks']} chunks in {met['dso_dispatches']} "
          f"dispatches (avg fill {met['dso_avg_fill']:.1f})")

    # ---- 3. quality check: served scores track planted preferences ----
    print("[3/4] verifying served scores track planted preferences...")
    rng = np.random.default_rng(7)
    pos, neg = [], []
    for _ in range(n_check):
        r = ds.sample_request(rng, history, m)
        scores = eng.serve(r["history"], r["candidates"])
        lab = r["labels"][:, 0] > 0.5
        pos.extend(scores[lab, 0].tolist())
        neg.extend(scores[~lab, 0].tolist())
    track_ok = np.mean(pos) > np.mean(neg)
    print(f"    mean score on positives {np.mean(pos):.4f} vs "
          f"negatives {np.mean(neg):.4f} "
          f"({'OK' if track_ok else 'FAIL'})")

    # ---- 4. repeat-user re-rank through the history-KV pool ----
    print("[4/4] repeat-user re-rank: split forward + history-KV pool...")
    engc = FlameEngine(bundle, params, history_cache=True, pool_slots=64,
                       **common)
    r = ds.sample_request(rng, history, m)
    ref = eng.serve(r["history"], r["candidates"])
    for _ in range(4):      # re-ranks: same user, fresh slates
        engc.serve(r["history"],
                   rng.integers(0, n_items, m).astype(np.int32), user_id=1)
    first = engc.serve(r["history"], r["candidates"], user_id=1)
    mc = engc.metrics()
    err = float(np.abs(np.asarray(ref, np.float32)
                       - np.asarray(first, np.float32)).max())
    same = np.allclose(np.asarray(ref, np.float32),
                       np.asarray(first, np.float32), atol=TOL, rtol=TOL)
    print(f"    pool: {mc['pool_hits']} hits / {mc['pool_misses']} miss "
          f"({mc['pool_bytes']} bytes cached); cached scores == full pass "
          f"(max |diff| {err:.3g}, tol {TOL}): {'OK' if same else 'FAIL'}")
    engc.shutdown()
    eng.shutdown()
    print(f"launch counts: {_build.launch_counts()}")
    ok = track_ok and same
    print(f"serve_e2e checks: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch_serve_e2e checks FAILED")


if __name__ == "__main__":
    main()
