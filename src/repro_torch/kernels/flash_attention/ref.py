"""Plain PyTorch oracle for the mask-aware flash attention kernel — port of
``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch


def mask_array(s_q: int, s_k: int, mode: str, *, window: int = 0,
               n_history: int = 0, device=None) -> torch.Tensor:
    q = torch.arange(s_q, device=device)[:, None]
    k = torch.arange(s_k, device=device)[None, :]
    if mode == "full":
        return torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if mode == "causal":
        return k <= q
    if mode == "sliding":
        return (k <= q) & (q - k < window)
    if mode == "sumi":
        return torch.where(q < n_history, k <= q,
                           (k < n_history) | (k == q))
    raise ValueError(mode)


def reference(q, k, v, mode: str, *, window: int = 0, n_history: int = 0):
    """q [B,H,Sq,D]; k,v [B,Hkv,Sk,D] -> [B,H,Sq,D] (f32 math, input dtype
    out).  Fully masked rows give zeros."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    m = mask_array(sq, k.shape[2], mode, window=window, n_history=n_history,
                   device=q.device)
    s = torch.where(m, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    w = torch.where(m.any(-1)[:, None], w, torch.zeros_like(w))
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)
