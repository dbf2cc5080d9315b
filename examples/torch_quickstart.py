"""Quickstart on the PyTorch port: build a Climber GR model and score
candidates through the SUMI mask in one forward pass (the port's twin of
``examples/quickstart.py``, at its sizes).

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --impl pallas  # K2, K3

Under an ``--impl`` other than ``reference`` the scores are also held
against the ``reference`` route's within ``TOL``.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.model import build_model
from repro_torch.types import ClimberConfig

#: pallas / fused against reference on the bf16 weights (both round every
#: projection to bf16, in other places)
TOL = 2e-2


def quickstart_config(small: bool = False):
    """A laptop-sized Climber (the paper's structure: 2 blocks, SUMI
    scoring, adaptive temperature, gating fusion, multi-task expert head);
    ``small``: a narrower one for quick CPU runs."""
    width = dict(d_model=32, d_ff=128, n_heads=2, n_kv_heads=2,
                 head_dim=16) if small else dict(
        d_model=128, d_ff=512, n_heads=4, n_kv_heads=4, head_dim=32)
    return dataclasses.replace(
        get_config("climber"), vocab_size=10_000, **width,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2, num_tasks=3))


def quickstart_batch(cfg):
    """The twin's inputs: one user, 128 history items, 32 candidates."""
    rng = np.random.default_rng(0)
    return {"history": rng.integers(0, cfg.vocab_size, (1, 128)),
            "candidates": rng.integers(0, cfg.vocab_size, (1, 32)),
            "side": rng.standard_normal((1, 12))}


def score(bundle, params, batch, device, impl: str = "reference"):
    """[1, candidates, tasks] scores of ``batch`` (numpy) in one pass."""
    tb = {k: torch.as_tensor(v, dtype=torch.float32 if k == "side"
                             else torch.int32, device=device)
          for k, v in batch.items()}
    with torch.inference_mode():
        return bundle.prefill(params, tb, impl=impl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--impl", default="reference",
                    choices=["reference", "chunked", "pallas", "fused"])
    ap.add_argument("--small", action="store_true",
                    help="a narrower model (quick CPU runs)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = quickstart_config(args.small)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device=device)
    batch = quickstart_batch(cfg)
    scores = score(bundle, params, batch, device, args.impl)
    print(f"scored {scores.shape[1]} candidates x {scores.shape[2]} tasks "
          f"in one SUMI pass (impl {args.impl}, device {device})")
    s = scores[0, :, 0].float().cpu().numpy()
    top5 = np.argsort(-s)[:5]
    print("top-5 candidates by task-0 score:", top5.tolist())
    print("their scores:", [round(float(v), 3) for v in s[top5]])

    ok = tuple(scores.shape) == (1, 32, cfg.climber.num_tasks) and bool(
        torch.isfinite(scores).all())
    msg = f"shape {tuple(scores.shape)}, finite"
    if args.impl != "reference":
        ref = score(bundle, params, batch, device)
        err = float((scores.float() - ref.float()).abs().max())
        ok = ok and err <= TOL
        msg += f"; max |{args.impl} - reference| {err:.3g} (tol {TOL})"
    print(f"launch counts: {_build.launch_counts()}")
    print(f"quickstart checks: {msg}: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch_quickstart checks FAILED")


if __name__ == "__main__":
    main()
