"""Dense feed-forward blocks (MLP / SwiGLU).  Port of ``repro/models/ffn.py``.

``impl="pallas"`` routes through ``kernels/fused_ffn`` (kernel K3: W1 (+gate)
+ activation + W2 in one kernel, the hidden never in device memory), as the
JAX package does; every other impl is plain ``torch.matmul``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models import layers as L


def ffn_init(cfg, *, generator, device, d_ff=None, stacked: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": L.dense_init((d, f), ("embed", "mlp"), generator=generator,
                              device=device, stacked=stacked),
         "w_down": L.dense_init((f, d), ("mlp", "embed"), generator=generator,
                                device=device, stacked=stacked)}
    if cfg.activation == "swiglu":
        p["w_gate"] = L.dense_init((d, f), ("embed", "mlp"),
                                   generator=generator,
                                   device=device, stacked=stacked)
    return p


def ffn_apply(params, x, cfg, impl: str = "xla", partial: bool = False):
    """``partial``: the rank holds some of the hidden (``mlp``) columns
    (tensor parallelism), and the down projection's partial sum comes back
    in float32 (kernel K3's, under pallas, in ``x``'s dtype)."""
    if impl == "pallas":
        from repro_torch.kernels.fused_ffn import ops as ffn_ops
        return ffn_ops.fused_ffn(x, params, activation=cfg.activation)
    up = torch.matmul(x, params["w_up"])
    if cfg.activation == "swiglu":
        gate = torch.matmul(x, params["w_gate"])
        h = F.silu(gate.float()) * up.float()
    else:
        h = L.activation_fn(cfg.activation)(up.float())
    h = h.to(x.dtype)
    if partial:
        return torch.matmul(h.float(), params["w_down"].float())
    return torch.matmul(h, params["w_down"])


def ffn_block(params, x, cfg, impl: str = "xla", d_ff=None):
    """:func:`ffn_apply` with tensor parallelism: where the rank holds a
    block of the ``d_ff`` (default ``cfg.d_ff``) hidden columns, its
    partial down projection is added over ``model`` in f32 and rounded
    once to x's dtype (``sharding.model_sum``), and ``x``'s gradient is
    summed over ``model`` (``sharding.psum_grad``)."""
    split = params["w_down"].shape[-2] != (d_ff or cfg.d_ff)
    if split:
        x = shd.psum_grad(x)
    out = ffn_apply(params, x, cfg, impl=impl, partial=split)
    return shd.model_sum(out, x.dtype) if split else out
