"""Training launcher (port of ``repro/launch/train.py``).

On the CPU, at a reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --reduced --device cpu --steps 100 --batch 8 --seq 128

On the card (the default device), at full width, writing a checkpoint that
``repro_torch.launch.serve --ckpt`` restores for Climber:

    PYTHONPATH=src python -m repro_torch.launch.train --arch climber \\
        --batch 16 --seq 512 --steps 30 --ckpt /tmp/climber.msgpack

Climber trains on ``GRInteractionDataset`` (``--seq`` history items and
``max(4, seq // 8)`` candidates per user) under ``impl="reference"``,
every other model on ``TokenDataset`` (branching 8) under ``"chunked"``,
as the JAX launcher chooses.  ``--mesh`` takes ``host``, ``pod16x16`` and
``pod2x16x16`` and, as in the JAX launcher (which parses the flag and
never reads it), trains on the one device whichever it names; the
sharded train step (``training.loop.make_train_step`` inside
``sharding.mesh_rules``) runs in the dry run and the tests, not here.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import (GRInteractionDataset, TokenDataset,
                              make_batch_iterator)
from repro_torch.devices import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the log,
    write the checkpoint if asked, and return {"cfg", "bundle", "params",
    "history", "step_times", "impl", "peak_bytes"} (``peak_bytes`` the
    card's peak allocated memory, None on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None, help="checkpoint path to write")
    ap.add_argument("--mesh", default="host", choices=["host", "pod16x16",
                                                       "pod2x16x16"],
                    help="accepted as the JAX launcher accepts it, which "
                         "never reads it: every mesh trains on the one "
                         "device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    bundle = build_model(cfg)
    print(f"[train] arch={cfg.name} reduced={args.reduced} "
          f"params~{cfg.param_count()/1e6:.1f}M device={device}")

    if cfg.family == "climber":
        ds = GRInteractionDataset(n_items=cfg.vocab_size)
        it = make_batch_iterator(ds, args.batch, n_history=args.seq,
                                 n_candidates=max(4, args.seq // 8))
        impl = "reference"
    else:
        ds = TokenDataset(vocab_size=cfg.vocab_size, branching=8)
        it = make_batch_iterator(ds, args.batch, seq_len=args.seq)
        impl = "chunked"

    def log(m):
        print(f"[train] step={m['step']:<5d} loss={m['loss']:.4f} "
              f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
              f"wall={m['wall_s']:.1f}s")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_times: List[Dict[str, float]] = []
    params, _, hist = train(
        bundle, it, args.steps,
        AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 10)),
        log_every=max(1, args.steps // 20), impl=impl, callback=log,
        device=device, step_times=step_times)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    steady = step_times[3:] or step_times
    print(f"[train] median over steps {steady[0]['step']}-"
          f"{steady[-1]['step']}: step "
          f"{np.median([t['step_ms'] for t in steady]):.2f} ms, forward + "
          f"backward {np.median([t['fwd_bwd_ms'] for t in steady]):.2f} "
          f"ms, optimizer {np.median([t['opt_ms'] for t in steady]):.2f} "
          f"ms ({'CUDA events' if device.type == 'cuda' else 'host clock'})"
          + (f"; peak memory {peak / 2**30:.2f} GiB" if peak else ""))

    if args.ckpt:
        checkpoint.save(args.ckpt, params, step=args.steps)
        print(f"[train] checkpoint written to {args.ckpt}")
    print(f"[train] done: first loss {hist[0]['loss']:.4f} -> "
          f"final {hist[-1]['loss']:.4f}")
    return {"cfg": cfg, "bundle": bundle, "params": params, "history": hist,
            "step_times": step_times, "impl": impl, "peak_bytes": peak}


if __name__ == "__main__":
    main()
