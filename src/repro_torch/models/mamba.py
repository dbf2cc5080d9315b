"""Mamba (S6) block for the Jamba hybrid: the selective state-space scan.
Port of ``repro/models/mamba.py``.

Continuous params (A, B, C, dt) discretized per token:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (state [d_inner, N])
    y_t = C_t . h_t + D * x_t

Prefill runs the JAX package's chunked scan: sequential over chunks of
``MAMBA_CHUNK`` steps (the decay padded with 1, the increment with 0), and
within a chunk :func:`associative_scan`, a port of the recursive odd / even
algorithm of ``jax.lax.associative_scan``, so the f32 products and sums
happen in the same order.  Decode is the single-step recurrence on the
carried (conv_state, ssm_state).  The JAX package runs the block with no
Pallas kernel; here it is plain PyTorch on every device by that design.

The ssm state is f32 whatever the cache dtype.  With caches, a decode step
writes the new conv and ssm states into the caches handed in, in place (the
port's rule for every layer kind); a prefill returns new ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models import layers as L

DT_RANK_DIV = 16
MAMBA_CHUNK = 256


def mamba_init(cfg, *, generator, device, stacked: int = 0):
    """S4D-real ``a_log`` (f32), ``dt_bias`` -4.6, ``conv_w`` scaled by
    0.5, the projections fan-in scaled: the JAX ``mamba_init``."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = max(1, d // DT_RANK_DIV)
    kw = dict(generator=generator, device=device, stacked=stacked)
    z = dict(device=device, stacked=stacked)   # the JAX zeros / ones inits
    a_init = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                    device=device))
    a_shape = ((stacked,) if stacked else ()) + (di, n)
    a_log = L.logical_leaf(("ssm_inner", "ssm_state"), stacked)
    if a_log is None:
        a_log = L.abstract_leaf((di, n), torch.float32, stacked)
    if a_log is None:
        a_log = a_init.expand(a_shape).contiguous()
    return {
        "w_in": L.dense_init((d, 2 * di), ("embed", "ssm_inner"), **kw),
        "conv_w": L.dense_init((cfg.mamba_d_conv, di), (None, "ssm_inner"),
                               scale=0.5, **kw),
        "conv_b": L.full_init((di,), ("ssm_inner",), 0.0, **z),
        "w_x": L.dense_init((di, dtr + 2 * n), ("ssm_inner", None), **kw),
        "w_dt": L.dense_init((dtr, di), (None, "ssm_inner"), **kw),
        "dt_bias": L.full_init((di,), ("ssm_inner",), -4.6, **z),
        "a_log": a_log,
        "d_skip": L.full_init((di,), ("ssm_inner",), 1.0, **z),
        "w_out": L.dense_init((di, d), ("ssm_inner", "embed"), **kw),
    }


def _conv1d(x, w, b, conv_state=None):
    """Depthwise causal conv.  x [B,S,di]; w [K,di].  Returns (y,
    new_state); the taps summed from i = 0, as the JAX package."""
    ksz = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], ksz - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(ksz))
    new_state = xp[:, -(ksz - 1):] if ksz > 1 else conv_state
    return y + b, new_state


def _ssm_params(params, xc, cfg):
    """xc [B,S,di] -> dt [B,S,di], B, C [B,S,N] (f32).  With the rank's
    block of the inner channels, ``w_x`` contracts over them: its partial
    product is added over ``model`` first (f32, rounded once)."""
    n = cfg.mamba_d_state
    if params["w_x"].shape[0] != cfg.mamba_expand * cfg.d_model:
        # the sum feeds each rank's own channels: its gradient is summed
        xdbc = shd.psum_grad(shd.model_sum(
            torch.matmul(xc.float(), params["w_x"].float()),
            xc.dtype).float())
    else:
        xdbc = torch.matmul(xc, params["w_x"]).float()
    dtr = xdbc.shape[-1] - 2 * n
    dt_in, b_in, c_in = torch.split(xdbc, [dtr, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, params["w_dt"].float())
                    + params["dt_bias"].float())
    return dt, b_in, c_in


def _interleave(a, b):
    """[a0, b0, a1, b1, ...] along axis 1 (``len(a)`` is ``len(b)`` or one
    more)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def associative_scan(fn, elems):
    """Inclusive scan of the tuple ``elems`` of tensors along axis 1 under
    the associative ``fn(a, b)``: the recursion of
    ``jax.lax.associative_scan`` (combine adjacent pairs, scan the reduced
    half, fill in the even positions, interleave)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[:, 0:-1:2] for e in elems),
                 tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:, :-1] for e in odd),
                  tuple(e[:, 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[:, 2::2] for e in elems))
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def mamba_apply(params, x, cfg, *, state: Optional[Tuple] = None,
                decode: bool = False):
    """x [B,S,d] -> (y [B,S,d], (conv_state, ssm_state)).  ``state`` is
    (conv [B,K-1,di], ssm [B,di,N] f32) or None (zeros)."""
    b, s, d = x.shape
    di = params["conv_b"].shape[-1]        # the rank's inner channels
    n = cfg.mamba_d_state
    conv_state, ssm_state = state if state is not None else (None, None)
    if ssm_state is None:
        ssm_state = torch.zeros((b, di, n), dtype=torch.float32,
                                device=x.device)

    xi, z = _in_proj(params["w_in"], x, cfg, di)
    xc, conv_state = _conv1d(xi, params["conv_w"], params["conv_b"],
                             conv_state)
    xc = F.silu(xc.float()).to(x.dtype)

    dt, b_in, c_in = _ssm_params(params, xc, cfg)
    a = -torch.exp(params["a_log"].float())                   # [di,N] < 0
    decay = torch.exp(dt[..., None] * a)                      # [B,S,di,N]
    incr = (dt * xc.float())[..., None] * b_in[:, :, None, :]  # [B,S,di,N]

    if decode:
        h = decay[:, 0] * ssm_state + incr[:, 0]
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
        ssm_state = h
    else:
        # chunked selective scan: sequential over chunks, the associative
        # scan within each
        c = min(MAMBA_CHUNK, s)
        pad = (-s) % c
        if pad:
            decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
            incr = F.pad(incr, (0, 0, 0, 0, 0, pad))
        nch = (s + pad) // c
        dc = decay.reshape(b, nch, c, di, n)
        ic = incr.reshape(b, nch, c, di, n)
        hs = []
        for j in range(nch):
            ic0 = ic[:, j].clone()
            ic0[:, 0] += dc[:, j, 0] * ssm_state
            _, h = associative_scan(_combine, (dc[:, j], ic0))
            ssm_state = h[:, -1]
            hs.append(h)
        del decay, incr, dc, ic
        h = torch.cat(hs, dim=1)[:, :s] if nch > 1 else hs[0][:, :s]
        y = torch.einsum("bsdn,bsn->bsd", h, c_in)

    y = y + params["d_skip"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    if di != cfg.mamba_expand * d:      # rows of w_out: a partial sum
        out = shd.model_sum(torch.matmul(y.float(),
                                         params["w_out"].float()), x.dtype)
    else:
        out = torch.matmul(y, params["w_out"])
    return out, (conv_state, ssm_state)


def _in_proj(w_in, x, cfg, di: int):
    """x's two input streams (xi, z) [B,S,di] of the rank's ``di`` inner
    channels.  ``w_in`` [d, 2 * inner] splits its columns over ``model``
    as one axis, so a rank's block holds neither stream's channels of its
    own: the block's product is gathered over ``model`` and the rank's
    channels of both halves taken — or, when the tokens outnumber
    d_model, ``w_in`` is gathered and only those columns multiplied (one
    ``all_gather`` either way, the smaller).  Each rank uses its own
    channels of the gathered whole (the gather's backward reduce-scatters)
    and ``x``'s gradient is summed over ``model``."""
    inner = cfg.mamba_expand * cfg.d_model
    if di == inner:
        return torch.chunk(torch.matmul(x, w_in), 2, dim=-1)
    x = shd.psum_grad(x)
    lo = shd.axis_index("model") * di
    tokens = x.shape[0] * x.shape[1]
    if tokens > w_in.shape[0]:
        w = shd.all_gather(w_in, "model", dim=-1)
        return (torch.matmul(x, w[:, lo:lo + di]),
                torch.matmul(x, w[:, inner + lo:inner + lo + di]))
    xz = shd.all_gather(torch.matmul(x, w_in), "model", dim=-1)
    return xz[..., lo:lo + di], xz[..., inner + lo:inner + lo + di]
