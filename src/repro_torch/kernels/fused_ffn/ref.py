"""Plain PyTorch oracle for the fused norm + FFN kernel — port of
``repro/kernels/fused_ffn/ref.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + scale.float())


def reference(x, w_up, w_down, *, w_gate=None, norm_scale=None,
              activation: str = "swiglu"):
    """x [T,d] -> [T,d].  Norm (optional RMSNorm) + W1(+gate) + act + W2,
    all in f32; returns x.dtype."""
    h = rmsnorm(x, norm_scale) if norm_scale is not None else x.float()
    up = h @ w_up.float()
    if activation == "swiglu":
        a = F.silu(h @ w_gate.float()) * up
    elif activation == "gelu":
        a = F.gelu(up, approximate="tanh")
    else:
        a = F.relu(up)
    return (a @ w_down.float()).to(x.dtype)
