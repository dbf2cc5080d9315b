"""Plain PyTorch oracle for the flash-decode kernel — port of
``repro/kernels/flash_decode/ref.py``."""
from __future__ import annotations

import math

import torch


def decode_with_self(q, k_cache, v_cache, lengths, k_self, v_self):
    """f32 ground truth for one generative-decode scoring step.

    ``q``/``k_self``/``v_self`` [B,M,H(kv),D] are M candidate next-token
    projections per row, each hypothetically extending the row's cache at
    position ``lengths[b]``; ``k_cache``/``v_cache`` [B,S,Hkv,D] hold the
    row's valid prefix in positions ``< lengths[b]``.  Every candidate
    attends to the valid prefix plus itself, never to the other
    candidates."""
    b, m, h, d = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, m, hkv, g, d)
    s_hist = torch.einsum("bmhgd,bkhd->bhgmk", qf,
                          k_cache.float()) / math.sqrt(d)
    s_self = torch.einsum("bmhgd,bmhd->bhgm", qf,
                          k_self.float())[..., None] / math.sqrt(d)
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, None]
    scores = torch.cat([torch.where(valid, s_hist,
                                    torch.full_like(s_hist, -1e30)),
                        s_self], dim=-1)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgmk,bkhd->bmhgd", w[..., :s], v_cache.float()) \
        + w[..., s:].permute(0, 3, 1, 2, 4) \
        * v_self.float().reshape(b, m, hkv, 1, d)
    return o.reshape(b, m, h, d).to(q.dtype)


def reference(q, k_cache, v_cache, lengths, *, window: int = 0):
    """q [B,H,D]; caches [B,S,Hkv,D]; lengths [B] (valid prefix per row).
    Returns [B,H,D].  ``window`` > 0 additionally masks positions older
    than ``lengths - window``.  (A row with ``lengths == 0`` is a softmax
    over nothing but masked scores: uniform weights, as in the JAX
    oracle.)"""
    b, h, d = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf,
                          k_cache.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid = valid & (pos >= lengths[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)
