"""Serving launcher of the port: the flame engine under synthetic traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve --pool-dtype int8 \
        --users 8 --requests 64                      # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --history 16 --d-model 32 --buckets 8,4 --counts 4,8

Mirrors the ``--engine flame`` scoring flags of ``repro/launch/serve.py``
for this slice: the history-KV pool is always on and the impl is ``fused``
(kernels K1 and K2 on the GPU, their plain PyTorch versions on the CPU).
The model is the launcher's reduced Climber (2 blocks x 2 layers, vocab
50,000, ``--d-model`` wide) with random weights from ``--seed``.
Requests go through ``submit``, so cross-request coalescing is exercised.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.climber import build_climber, climber_init
from repro_torch.devices import resolve_device
from repro_torch.serving import create_engine
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.types import ClimberConfig


def _print_metrics(tag: str, m: dict):
    print(f"[serve] {tag}: " + ", ".join(
        f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(m.items())))


def serve(args) -> dict:
    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=50_000, d_model=args.d_model,
        d_ff=4 * args.d_model, n_heads=4, n_kv_heads=4,
        head_dim=args.d_model // 4,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    bundle = build_climber(cfg)
    params = climber_init(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    eng = create_engine(
        "flame", bundle, params, n_history=args.history,
        feature_mode=args.feature_mode, max_pending=args.max_pending,
        impl="fused", buckets=tuple(int(b) for b in args.buckets.split(",")),
        n_streams=args.streams, coalesce=not args.no_coalesce,
        max_batch=args.max_batch, window_s=args.window_ms * 1e-3,
        n_workers=args.concurrency, pool_slots=args.pool_slots,
        pool_budget_bytes=(int(args.pool_budget_mb * 2**20)
                           if args.pool_budget_mb else None),
        pool_dtype=args.pool_dtype, pool_placement=args.pool_placement,
        deadline_s=args.deadline_ms * 1e-3, admission=args.admission,
        device=device)
    try:
        fams = ", ".join(f"{k}:{v}" for k, v in eng.dso.families.items())
        print(f"[serve] kernels built in {eng.kernel_build_s:.1f}s, "
              f"executors in {eng.dso.build_time_s:.2f}s "
              f"(families {fams}, impl fused, device {device}, batch axis "
              f"{eng.dso.policy.batch}, coalesce="
              f"{'on' if eng.dso.policy.enabled else 'off'})")
        budget = (f"{args.pool_budget_mb:g} MB budget"
                  if args.pool_budget_mb else "no byte budget")
        print(f"[serve] history-KV pool: {args.pool_slots} slots, {budget}, "
              f"dtype {args.pool_dtype}, placement {args.pool_placement}")
        tc = TrafficConfig(
            candidate_counts=tuple(int(c) for c in args.counts.split(",")),
            distribution=args.distribution, n_requests=args.requests,
            n_history=args.history, seed=args.seed, n_users=args.users)
        reqs = generate_traffic(tc, n_items=cfg.vocab_size)
        res = run_workload_async(eng, reqs,
                                 arrival_gap_s=args.arrival_gap_ms * 1e-3)
        print(f"[serve] {res['requests']} requests | "
              f"{res['throughput_items_per_s']:.0f} items/s | "
              f"p50 {res['p50_latency_ms']:.1f} ms | "
              f"p99 {res['p99_latency_ms']:.1f} ms")
        _print_metrics("engine metrics", eng.metrics())
        return res
    finally:
        eng.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the traffic")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--history", type=int, default=128)
    ap.add_argument("--buckets", default="64,32,16")
    ap.add_argument("--counts", default="16,32,64")
    ap.add_argument("--distribution", default="uniform",
                    choices=["uniform", "zipf", "jittered", "lognormal"])
    ap.add_argument("--feature-mode", default="sync",
                    choices=["off", "sync", "async"])
    ap.add_argument("--pool-slots", type=int, default=256,
                    help="history-KV pool capacity (entries, LRU-evicted)")
    ap.add_argument("--pool-budget-mb", type=float, default=0.0,
                    help="history-KV pool byte budget in MB (0 = entry "
                         "bound only)")
    ap.add_argument("--pool-dtype", default="native",
                    choices=["native", "bf16", "int8"],
                    help="stored precision of pool entries (int8 uses "
                         "per-head scales)")
    ap.add_argument("--pool-placement", default="device",
                    choices=["device", "host"],
                    help="device keeps entries in the engine device's "
                         "memory; host keeps them in CPU memory")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-request deadline budget (0 = none)")
    ap.add_argument("--admission", default="edf", choices=["edf", "fifo"])
    ap.add_argument("--users", type=int, default=0,
                    help="repeat-user traffic: draw requests from this many "
                         "users with stable histories (0 = unique users)")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="pipeline worker threads")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable cross-request chunk coalescing")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="coalescing fill target / executor batch axis")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="coalescing time window")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="admission queue bound (backpressure)")
    ap.add_argument("--arrival-gap-ms", type=float, default=0.0,
                    help="max random gap between request arrivals")
    ap.add_argument("--d-model", type=int, default=128)
    serve(ap.parse_args(argv))


if __name__ == "__main__":
    main()
