"""Dense feed-forward blocks (MLP / SwiGLU).  Port of ``repro/models/ffn.py``.

``impl="pallas"`` routes through ``kernels/fused_ffn`` (kernel K3: W1 (+gate)
+ activation + W2 in one kernel, the hidden never in device memory), as the
JAX package does; every other impl is plain ``torch.matmul``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def ffn_init(cfg, *, generator, device, d_ff=None, stacked: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": L.dense_init((d, f), generator=generator, device=device,
                              stacked=stacked),
         "w_down": L.dense_init((f, d), generator=generator, device=device,
                                stacked=stacked)}
    if cfg.activation == "swiglu":
        p["w_gate"] = L.dense_init((d, f), generator=generator,
                                   device=device, stacked=stacked)
    return p


def ffn_apply(params, x, cfg, impl: str = "xla"):
    if impl == "pallas":
        from repro_torch.kernels.fused_ffn import ops as ffn_ops
        return ffn_ops.fused_ffn(x, params, activation=cfg.activation)
    up = torch.matmul(x, params["w_up"])
    if cfg.activation == "swiglu":
        gate = torch.matmul(x, params["w_gate"])
        h = F.silu(gate.float()) * up.float()
    else:
        h = L.activation_fn(cfg.activation)(up.float())
    return torch.matmul(h.to(x.dtype), params["w_down"])
