"""RWKV-6 (Finch) — attention-free, data-dependent-decay linear attention.
Port of ``repro/models/rwkv6.py``.

Per head h with key/value dim D (head_size):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T           (state [D, D])
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t     (bonus u for current token)

w_t in (0,1) is data-dependent: w_t = exp(-exp(w0 + lora_w(x_t))).  Prefill
runs the chunked formulation through kernel K5 (``kernels/rwkv6_scan``: the
CUDA kernel on the GPU, its plain PyTorch version on the CPU); decode is one
recurrence step on the [B,H,D,D] state, in plain PyTorch as in the JAX
package.  Under a mesh the rank holds a block of the heads (and of the
channel-mix's ``mlp`` columns) over ``model``: the group norm runs per
local head, ``wo`` / ``cv`` give partial sums added over ``model`` in
f32, and the mixed streams and the decay lora, computed whole on every
rank, have their gradients summed over ``model`` where they enter the
split products (``sharding.psum_grad``).  Every dtype cast sits where the JAX code has it: the loras and the
decay in f32, the mixed streams cast back to x's dtype, ``w_log`` clipped to
[-20, -1e-4] in f32, the scan's output in r's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_plain
from repro_torch.models import layers as L

LORA_RANK = 32
CHUNK = 64


def rwkv_init(cfg, *, generator, device, stacked: int = 0):
    d = cfg.d_model
    kw = dict(generator=generator, device=device, stacked=stacked)
    z = dict(device=device, stacked=stacked)   # the JAX zeros / ones inits
    return {
        # time-mix projections
        "wr": L.dense_init((d, d), ("embed", "heads"), **kw),
        "wk": L.dense_init((d, d), ("embed", "heads"), **kw),
        "wv": L.dense_init((d, d), ("embed", "heads"), **kw),
        "wg": L.dense_init((d, d), ("embed", "heads"), **kw),
        "wo": L.dense_init((d, d), ("heads", "embed"), **kw),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": L.full_init((d,), ("heads",), -1.0, **z),
        "wA": L.dense_init((d, LORA_RANK), ("embed", None), **kw),
        "wB": L.dense_init((LORA_RANK, d), (None, "heads"), **kw),
        # per-channel bonus
        "u": L.full_init((d,), ("heads",), 0.5, **z),
        # token-shift mix coefficients (one per r/k/v/w/g)
        "mu": L.full_init((5, d), (None, "embed"), 0.5, **z),
        # ddlerp low-rank adapter (shared)
        "muA": L.dense_init((d, LORA_RANK), ("embed", None), **kw),
        "muB": L.dense_init((LORA_RANK, 5, d), (None, None, "embed"),
                            fan_in_axes=(0,), **kw),
        # group-norm over heads
        "ln_x_scale": L.full_init((d,), ("heads",), 1.0, **z),
        "ln_x_bias": L.full_init((d,), ("heads",), 0.0, **z),
        # channel-mix
        "ck": L.dense_init((d, cfg.d_ff), ("embed", "mlp"), **kw),
        "cv": L.dense_init((cfg.d_ff, d), ("mlp", "embed"), **kw),
        "c_mu": L.full_init((d,), ("embed",), 0.5, **z),
    }


def _shifted(x, x_prev):
    """[x_prev, x_0, ..., x_{S-2}] along the sequence (dtype promoted as
    ``jnp.concatenate`` promotes)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params, x, x_prev):
    """Data-dependent token-shift: returns 5 mixed streams [5,B,S,d] and the
    last token of x."""
    diff = (_shifted(x, x_prev) - x).float()
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", diff,
                                   params["muA"].float()))
    dyn = torch.einsum("bsr,rfd->fbsd", lora, params["muB"].float())
    mixed = x.float()[None] + diff[None] * (
        params["mu"].float()[:, None, None] + dyn)
    return mixed.to(x.dtype), x[:, -1]


def wkv_chunked(r, k, v, w_log, u, state: Optional[torch.Tensor] = None,
                chunk: int = CHUNK, *, train: bool = False):
    """Chunked linear-attention scan — kernel K5.  r,k,v: [B,S,H,D]; w_log:
    [B,S,H,D] = log(w_t) (<= 0); u: [H,D].  Returns (o [B,S,H,D] in r's
    dtype, final state [B,H,D,D] f32).  On ``meta`` tensors (the dry run:
    shapes alone, nothing computed) and in a train step (``train``: the
    kernel has no backward, and JAX's model code trains through its plain
    chunked scan, not the Pallas kernel) the kernel's plain version, which
    the wrapper otherwise keeps to CPU tensors."""
    if train or r.device.type == "meta":
        return rwkv6_scan_plain(r, k, v, w_log, u, state, chunk=chunk)
    return rwkv6_scan(r, k, v, w_log, u, state, chunk=chunk)


def wkv_decode_step(r, k, v, w, u, state):
    """One-token recurrence.  r,k,v,w: [B,H,D]; state [B,H,D,D] (f32)."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = w.float()
    o = torch.einsum("bhd,bhde->bhe", rf, state) + torch.einsum(
        "bhd,bhd->bh", rf * u.float()[None], kf)[..., None] * vf
    state = wf[..., None] * state + torch.einsum("bhd,bhe->bhde", kf, vf)
    return o.to(r.dtype), state


def _group_norm(x, scale, bias, nh: int, eps: float = 64e-5):
    """Per-head group norm on [B,S,d] flattened heads (population
    variance, as ``jnp.var``)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, nh, d // nh)
    mu = xf.mean(-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(b, s, d) * scale.float() + bias.float()).to(x.dtype)


def time_mix(params, x, cfg, *, x_prev=None, state=None, decode=False,
             train=False):
    """RWKV-6 time-mix.  Prefill: x [B,S,d]. Decode: x [B,1,d] with carried
    (x_prev [B,d], state [B,H,D,D]).  ``train``: a train step's forward
    (the scan's plain version, :func:`wkv_chunked`).  Returns (out,
    (last x, state))."""
    b = x.shape[0]
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = params["wr"].shape[-1] // hs     # the rank's heads
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    mixed, last_x = _ddlerp(params, x, x_prev)
    xr, xk, xv, xw, xg = mixed
    lora = torch.tanh(torch.matmul(xw.float(), params["wA"].float()))
    if nh * hs != d:     # the rank's heads: the split products' inputs
        xr, xk, xv, xg = shd.psum_grad(xr, xk, xv, xg)
        lora = shd.psum_grad(lora)
    r = torch.matmul(xr, params["wr"])
    k = torch.matmul(xk, params["wk"])
    v = torch.matmul(xv, params["wv"])
    g = torch.matmul(xg, params["wg"])
    w_log = -torch.exp(params["w0"].float()
                       + torch.matmul(lora, params["wB"].float()))
    w_log = torch.clamp(w_log, -20.0, -1e-4)
    shp = (b, -1, nh, hs)
    r4, k4, v4 = (a.reshape(shp) for a in (r, k, v))
    u = params["u"].reshape(nh, hs)
    if decode:
        o, state = wkv_decode_step(r4[:, 0], k4[:, 0], v4[:, 0],
                                   torch.exp(w_log.reshape(shp)[:, 0]), u,
                                   state)
        o = o[:, None].reshape(b, 1, nh * hs)
    else:
        o, state = wkv_chunked(r4, k4, v4, w_log.reshape(shp), u, state,
                               train=train)
        o = o.reshape(b, -1, nh * hs)
    o = _group_norm(o, params["ln_x_scale"], params["ln_x_bias"], nh)
    o = o * F.silu(g.float()).to(o.dtype)
    return _rows_product(o, params["wo"], d), (last_x, state)


def _rows_product(h, w, full_rows: int):
    """``h @ w``; where the rank holds a block of ``w``'s rows (heads or
    ``mlp`` over ``model``), the partial product is added over ``model``
    in f32 and rounded once."""
    if w.shape[0] != full_rows:
        return shd.model_sum(torch.matmul(h.float(), w.float()), h.dtype)
    return torch.matmul(h, w)


def channel_mix(params, x, cfg, x_prev=None):
    """Squared-relu channel mix with token shift.  Returns (out, last x)."""
    b = x.shape[0]
    if x_prev is None:
        x_prev = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    xs = _shifted(x, x_prev)
    mu = params["c_mu"].float()
    xk = (x.float() * (1 - mu) + xs.float() * mu).to(x.dtype)
    if params["ck"].shape[-1] != cfg.d_ff:
        xk = shd.psum_grad(xk)
    k = torch.matmul(xk, params["ck"])
    h = torch.square(F.relu(k.float())).to(x.dtype)
    return _rows_product(h, params["cv"], cfg.d_ff), x[:, -1]
