#!/usr/bin/env python3
"""Where a train step of the port spends its time on the card.

    python3 scripts/train_profile.py            # climber h2o-danube-3-4b
    python3 scripts/train_profile.py climber

From the root of a checkout on one NVIDIA GPU: builds the model at full
width (seeded bf16 weights, as ``launch.train`` does) and its batches
(Climber: 16 users of 512 history items and 64 candidates under
``impl="reference"``; a text model: 8 x 512 tokens under ``"chunked"``,
remat), runs 4 warm-up steps of ``training.loop.train``'s step, then
profiles 3 steps with ``torch.profiler``: the wall time per step
(synchronized), the device's busy time per step (the sum of its kernels)
and idle share, the host's time in the forward, backward and AdamW
regions, and the device time by kernel class (GEMM, the embedding
backward, elementwise and reductions, the rest) and the top 10 kernels.
Prints the card's name and power limit first; exits non-zero without
CUDA.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
CLASSES = (("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma",
                     "cublas")),
           ("embedding backward", ("embedding", "sort", "radix",
                                   "segment")),
           ("elementwise and reductions", ("elementwise", "reduce",
                                           "vectorized", "unrolled")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def setup(arch: str, device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import (GRInteractionDataset, TokenDataset,
                                  make_batch_iterator)
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device)
    if cfg.family == "climber":
        it = make_batch_iterator(GRInteractionDataset(n_items=cfg.vocab_size),
                                 16, n_history=512, n_candidates=64)
        return bundle, params, it, "reference"
    it = make_batch_iterator(TokenDataset(vocab_size=cfg.vocab_size,
                                          branching=8), 8, seq_len=512)
    return bundle, params, it, "chunked"


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_profile.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.training.loop import grads_of, to_device
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                adamw_update)
    from repro_torch.tree import leaves
    from torch.profiler import ProfilerActivity, profile, record_function
    card = cs.card_line()
    print(f"[train_profile] card: {card}", flush=True)
    device = torch.device("cuda", 0)
    for arch in argv or ["climber", "h2o-danube-3-4b"]:
        bundle, params, it, impl = setup(arch, device)
        for p in leaves(params):
            p.requires_grad_(True)
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=5)
        state = adamw_init(params)

        def step():
            batch = to_device(next(it), device)
            with record_function("forward"):
                loss, _ = bundle.loss_fn(params, batch, impl=impl)
            with record_function("backward"):
                grads = grads_of(loss, params)
            with record_function("adamw"):
                adamw_update(opt_cfg, grads, state, params)
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / STEPS
        rows, host = {}, {}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                if getattr(e, "is_user_annotation", False) or e.name in (
                        "forward", "backward", "adamw"):
                    continue
                us = getattr(e, "device_time", None)
                if us is None:
                    us = getattr(e, "cuda_time", 0)
                n, t = rows.get(e.name, (0, 0.0))
                rows[e.name] = (n + 1, t + us / 1e3 / STEPS)
            elif e.name in ("forward", "backward", "adamw"):
                host[e.name] = host.get(e.name, 0.0) \
                    + e.cpu_time_total / 1e3 / STEPS
        busy = sum(t for _, t in rows.values())
        n_launch = sum(n for n, _ in rows.values()) / STEPS
        print(f"[train_profile] {arch}: step {wall:.2f} ms wall (profiled, "
              f"synchronized), device busy {busy:.2f} ms ({n_launch:.0f} "
              f"kernels a step), idle {100 * (1 - busy / wall):.1f}%; host "
              f"time in " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                      host.items()) + f" ({card})",
              flush=True)
        by_class = {}
        for name, (_, t) in rows.items():
            c = kernel_class(name)
            by_class[c] = by_class.get(c, 0.0) + t
        print(f"[train_profile] {arch}: device time by class: " + ", ".join(
            f"{c} {t:.2f} ms ({100 * t / busy:.0f}%)" for c, t in
            sorted(by_class.items(), key=lambda x: -x[1])), flush=True)
        for name, (n, t) in sorted(rows.items(), key=lambda x: -x[1][1])[:10]:
            print(f"[train_profile]   {t:8.3f} ms  x{n // STEPS:<5d} "
                  f"{name[:110]}", flush=True)
        del bundle, params, state, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
