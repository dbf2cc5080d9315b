"""GQA attention with the mask modes FLAME needs.  Port of
``repro/models/attention.py``.

Mask modes
----------
``causal``   standard autoregressive
``full``     bidirectional
``sliding``  causal within ``window``
``sumi``     FLAME's single-user-multi-items mask: the first ``n_history``
             positions are causal among themselves; the remaining candidate
             positions attend to all history and to themselves only.

Implementations
---------------
``reference``  materialized scores — the oracle, any device.
``pallas``     every mode and offset goes to ``kernels/flash_attention``
               (kernel K2), as the JAX package's ``impl="pallas"`` does.
``fused``      the serving path.  The cached-candidate SUMI case goes to
               ``kernels/fused_score`` (kernel K1); every other mode goes to
               ``kernels/flash_attention`` (kernel K2).  Each wrapper
               launches its CUDA kernel on a CUDA tensor and runs its plain
               PyTorch version on a CPU tensor.  (The JAX package sends
               these passes to chunked jnp under ``impl="fused"``; the port
               sends them to its port of the flash-attention TPU kernel and
               holds the result to the JAX output.)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def mask_value(q_pos, k_pos, mode: str, *, window: int = 0,
               n_history: int = 0):
    """Boolean mask (True = attend) broadcast over q_pos x k_pos tensors."""
    if mode == "full":
        return torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                          dtype=torch.bool, device=q_pos.device)
    if mode == "causal":
        return k_pos <= q_pos
    if mode == "sliding":
        return (k_pos <= q_pos) & (q_pos - k_pos < window)
    if mode == "sumi":
        hist_mask = k_pos <= q_pos
        cand_mask = (k_pos < n_history) | (k_pos == q_pos)
        return torch.where(q_pos < n_history, hist_mask, cand_mask)
    raise ValueError(mode)


def make_mask(s_q: int, s_k: int, mode: str, *, window: int = 0,
              n_history: int = 0, q_offset: int = 0, device=None):
    q = torch.arange(s_q, device=device)[:, None] + q_offset
    k = torch.arange(s_k, device=device)[None, :]
    return mask_value(q, k, mode, window=window, n_history=n_history)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def qkv_init(cfg, *, generator, device, stacked: int = 0,
             d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    hd = cfg.head_dim
    kw = dict(generator=generator, device=device, stacked=stacked)
    p = {
        "wq": L.dense_init((d, cfg.n_heads, hd), fan_in_axes=(0,), **kw),
        "wk": L.dense_init((d, cfg.n_kv_heads, hd), fan_in_axes=(0,), **kw),
        "wv": L.dense_init((d, cfg.n_kv_heads, hd), fan_in_axes=(0,), **kw),
        "wo": L.dense_init((cfg.n_heads, hd, d), fan_in_axes=(0, 1), **kw),
    }
    if cfg.qkv_bias:
        for name, h in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = L.full_init((h, hd), 0.0, device=device,
                                  stacked=stacked)
    return p


def _proj(x, w):
    """[B,S,d] x [d,H,D] -> [B,S,H,D] (one GEMM)."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(params, x, cfg, positions):
    """x [B,S,d] -> q [B,S,H,D], k/v [B,S,Hkv,D], RoPE applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_out(params, o):
    """o [B,S,H,D] -> [B,S,d]."""
    h, k, d = params["wo"].shape
    return torch.matmul(o.flatten(-2), params["wo"].reshape(h * k, d))


def scale_by_temperature(q, temperature):
    """q / temperature in q's dtype, as the JAX package divides (in bf16 on
    the engine path); ``None`` leaves q as it is."""
    if temperature is None:
        return q
    return q / torch.as_tensor(temperature, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# reference attention (materialized)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, mode: str, *, window: int = 0,
                        n_history: int = 0, q_offset: int = 0,
                        temperature=None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D].  GQA via head groups."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    if temperature is not None:
        scores = scores / temperature
    mask = make_mask(sq, k.shape[1], mode, window=window, n_history=n_history,
                     q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention(q, k, v, mode: str, *, impl: str = "fused", window: int = 0,
              n_history: int = 0, temperature=None, q_offset: int = 0):
    """Dispatch wrapper used by the Climber blocks (see module docstring)."""
    if impl == "reference":
        return reference_attention(q, k, v, mode, window=window,
                                   n_history=n_history,
                                   temperature=temperature,
                                   q_offset=q_offset)
    if impl not in ("fused", "pallas"):
        raise ValueError(f"impl must be reference|pallas|fused, got "
                         f"{impl!r}")
    if impl == "fused" and mode == "sumi" and q_offset \
            and q_offset == n_history \
            and k.shape[1] == n_history + q.shape[1]:
        from repro_torch.kernels.fused_score import ops as fs_ops
        return fs_ops.fused_cached_attention(
            q, k[:, :n_history], v[:, :n_history],
            k[:, n_history:], v[:, n_history:], temperature=temperature)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops.flash_attention(scale_by_temperature(q, temperature), k, v,
                                  mode, window=window,
                                  n_history=n_history, q_offset=q_offset)
