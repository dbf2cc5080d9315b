"""Training example on the PyTorch port: Climber (~100M params) on the
synthetic GR interaction pipeline for a few hundred steps, with a
checkpoint (the port's twin of ``examples/train_climber.py``, at its
sizes).

The ~100M configuration keeps the paper's structure (2 blocks x 12 layers)
with the embedding table carrying most parameters, as in production recsys.
Use --small for a quick CPU run.  The checkpoint is the port's own msgpack
codec (``repro_torch.training.checkpoint``), byte-compatible with the JAX
package's.

    PYTHONPATH=src python examples/torch_train_climber.py --steps 300  # card
    PYTHONPATH=src python examples/torch_train_climber.py --device cpu \
        --small

Checks: the mean loss of the last three logged steps is under the first
step's, and the checkpoint restores bitwise.
"""
import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data import GRInteractionDataset, make_batch_iterator
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.tree import leaves
from repro_torch.types import ClimberConfig

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "torch_climber_ckpt.msgpack")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.small:
        cfg = dataclasses.replace(
            get_config("climber"), vocab_size=20_000, d_model=64, d_ff=256,
            n_heads=2, n_kv_heads=2, head_dim=32,
            climber=ClimberConfig(num_blocks=2, layers_per_block=2))
        steps, batch, n_hist, n_cand = min(args.steps, 60), 16, 32, 8
    else:
        # ~100M params: 512k-item catalog x 192d embedding (~98M) + 2x12
        # transformer layers
        cfg = dataclasses.replace(
            get_config("climber"), vocab_size=512_000, d_model=192,
            d_ff=768, n_heads=4, n_kv_heads=4, head_dim=48,
            climber=ClimberConfig(num_blocks=2, layers_per_block=12))
        steps, batch, n_hist, n_cand = args.steps, 8, 64, 16

    bundle = build_model(cfg)
    print(f"[train_climber] params ~{cfg.param_count()/1e6:.0f}M "
          f"({cfg.climber.num_blocks} blocks x "
          f"{cfg.climber.layers_per_block} layers, d={cfg.d_model}) on "
          f"{device}")

    ds = GRInteractionDataset(n_items=cfg.vocab_size, n_users=10_000, seed=0)
    it = make_batch_iterator(ds, batch, n_history=n_hist,
                             n_candidates=n_cand)
    params, _, hist = train(
        bundle, it, steps, AdamWConfig(lr=2e-3, warmup_steps=20),
        log_every=max(1, steps // 15), impl="reference", device=device,
        callback=lambda m: print(
            f"  step {m['step']:>4} loss {m['loss']:.4f} "
            f"({m['wall_s']:.0f}s)"))
    checkpoint.save(args.ckpt, params, step=steps)
    print(f"[train_climber] loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}; checkpoint at {args.ckpt}")

    like = bundle.init(torch.Generator(device=device).manual_seed(1),
                       device=device)
    restored, step = checkpoint.restore(args.ckpt, like)
    same = step == steps and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(leaves(restored), leaves(params)))
    fell = sum(h["loss"] for h in hist[-3:]) / len(hist[-3:]) \
        < hist[0]["loss"]
    print(f"launch counts: {_build.launch_counts()}")
    ok = same and fell
    print(f"train_climber checks: loss fell ({'yes' if fell else 'no'}), "
          f"checkpoint restores bitwise ({'yes' if same else 'no'}): "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch_train_climber checks FAILED")


if __name__ == "__main__":
    main()
