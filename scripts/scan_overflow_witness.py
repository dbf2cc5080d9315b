"""JAX's ``wkv_chunked`` and the port's plain scan on the inputs of a
train step's rwkv scan whose chunk decay passes 88.72, on the host.

    python3 scripts/train_grad_probe.py --parts steps     # on the card
    PYTHONPATH=src python3 scripts/scan_overflow_witness.py [PATH]

reads PATH (default ``build/train_grad_probe/scan_overflow.pt``, the
probe's save: r, k, v, w_log, u and the output gradient the card's step
gave that scan), and prints, for JAX's
``wkv_chunked`` (chunks of 64, as the model runs it) and for the port's
``rwkv6_scan_plain``: whether the forward and each input gradient are
finite, the number of non-finite entries of the gradient of ``w_log``,
and the largest forward difference relative to the output's scale.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
NAMES = ("r", "k", "v", "w_log", "u")


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.models.rwkv6 import wkv_chunked
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_plain
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "build", "train_grad_probe", "scan_overflow.pt")
    d = torch.load(path)
    ins, go = d["inputs"], d["grad_o"]
    wl = ins["w_log"].float()
    b, s, h, hd = wl.shape
    sums = (-wl).reshape(b, s // 64, 64, h, hd).sum(2)
    print(f"step {d['step']}, scan {d['scan']}: {tuple(wl.shape)}; chunk "
          f"decay sums past 88.72: {int((sums > 88.72).sum())} of "
          f"{sums.numel()}, the largest {float(sums.max()):.4f}")

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    (jo, jst), vjp = jax.vjp(wkv_chunked, *(to_jax(ins[n]) for n in NAMES))
    jg = vjp((to_jax(go), jnp.zeros_like(jst)))
    jo = np.asarray(jo.astype(jnp.float32))
    ts = [ins[n].clone().requires_grad_(True) for n in NAMES]
    to, _ = rwkv6_scan_plain(*ts)
    to.backward(go)
    rows = {"JAX wkv_chunked": (jo, [np.asarray(g.astype(jnp.float32))
                                      for g in jg]),
            "port rwkv6_scan_plain": (to.detach().float().numpy(),
                                      [t.grad.float().numpy() for t in ts])}
    for name, (o, gs) in rows.items():
        print(f"{name}: forward finite {bool(np.isfinite(o).all())}; "
              "gradients finite " + ", ".join(
                  f"{n} {bool(np.isfinite(g).all())}"
                  for n, g in zip(NAMES, gs))
              + f"; non-finite entries of d w_log "
              f"{int((~np.isfinite(gs[3])).sum())}")
    po = rows["port rwkv6_scan_plain"][0]
    print(f"forward: max |port - JAX| / max |JAX| "
          f"{float(np.abs(po - jo).max() / np.abs(jo).max()):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
