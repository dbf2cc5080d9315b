"""Plain PyTorch f32 oracle for the fused candidate-scoring kernel — port of
``repro/kernels/fused_score/ref.py``.

The oracle spells out what the fused paths must compute as the composed
chain: (1) dequantize the pooled history K/V (``values * scale / 127`` cast
back to the compute dtype, as ``serving/kv_cache.py::dequantize_leaf``),
(2) gather each batch row's KV view through the dedup ``row_index``,
(3) concatenate history and candidate K/V, (4) run materialized-score
reference attention (SUMI with ``q_offset = n_history`` for cached scoring,
causal with ``q_offset = prefix_len`` for extension)."""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as A


def dequantize_values(values, scale, dtype):
    """``scale is None`` marks a plain cast (bf16 storage or a no-op for
    native); int8 values dequantize through the absmax scale."""
    if scale is None:
        return values.to(dtype)
    return (values.float() * (scale / 127.0)).to(dtype)


def _prep(k, v, k_scale, v_scale, row_index, dtype):
    """Steps 1-2: dequantize + gather the per-row KV views."""
    k = dequantize_values(k, k_scale, dtype)
    v = dequantize_values(v, v_scale, dtype)
    if row_index is not None:
        k = k.index_select(0, row_index.long())
        v = v.index_select(0, row_index.long())
    return k, v


def cached_reference(q, k_hist, v_hist, k_cand, v_cand, *, k_scale=None,
                     v_scale=None, row_index=None, kv_dtype=None,
                     temperature=None):
    """Cached-candidate SUMI oracle.  ``q``/``k_cand``/``v_cand``
    [B,M,H(kv),D]; ``k_hist``/``v_hist`` [U,S,Hkv,D] stored values with
    optional [U,1,Hkv,1] scales and a [B] ``row_index`` gather."""
    dtype = kv_dtype or q.dtype
    q = A.scale_by_temperature(q, temperature)
    kh, vh = _prep(k_hist, v_hist, k_scale, v_scale, row_index, dtype)
    n = kh.shape[1]
    k = torch.cat([kh, k_cand.to(dtype)], dim=1)
    v = torch.cat([vh, v_cand.to(dtype)], dim=1)
    return A.reference_attention(q, k, v, "sumi", n_history=n, q_offset=n)


def decode_reference(q, k_hist, v_hist, k_cand, v_cand, lengths, *,
                     k_scale=None, v_scale=None, row_index=None,
                     kv_dtype=None, temperature=None):
    """Generative-decode oracle: cached scoring over a PADDED history whose
    valid prefix per pool row is ``lengths[u]``; a row with ``lengths == 0``
    is a softmax over the self key alone."""
    dtype = kv_dtype or q.dtype
    q = A.scale_by_temperature(q, temperature)
    kh = dequantize_values(k_hist, k_scale, dtype)
    vh = dequantize_values(v_hist, v_scale, dtype)
    lens = lengths.int()
    if row_index is not None:
        idx = row_index.long()
        kh, vh, lens = kh[idx], vh[idx], lens[idx]
    b, m, h, d = q.shape
    hkv = k_cand.shape[2]
    g = h // hkv
    s = kh.shape[1]
    qf = q.float().reshape(b, m, hkv, g, d) / math.sqrt(d)
    s_hist = torch.einsum("bmhgd,bshd->bmhgs", qf, kh.float())
    s_self = torch.einsum("bmhgd,bmhd->bmhg", qf, k_cand.float())
    ok = torch.arange(s, device=q.device)[None, :] < lens[:, None]   # [b,S]
    s_hist = torch.where(ok[:, None, None, None], s_hist,
                         torch.full_like(s_hist, -1e30))
    p = torch.softmax(torch.cat([s_hist, s_self[..., None]], dim=-1), dim=-1)
    o = torch.einsum("bmhgs,bshd->bmhgd", p[..., :s], vh.float())
    o = o + p[..., s][..., None] * v_cand.float()[:, :, :, None, :]
    return o.reshape(b, m, h, d).to(q.dtype)


def extend_reference(q, k_prefix, v_prefix, k_suffix, v_suffix, *,
                     k_scale=None, v_scale=None, row_index=None,
                     kv_dtype=None, temperature=None):
    """Incremental-extension (causal) oracle: suffix queries at absolute
    position ``prefix_len + i`` over ``concat(prefix, suffix)`` KV."""
    dtype = kv_dtype or q.dtype
    q = A.scale_by_temperature(q, temperature)
    kp, vp = _prep(k_prefix, v_prefix, k_scale, v_scale, row_index, dtype)
    p0 = kp.shape[1]
    k = torch.cat([kp, k_suffix.to(dtype)], dim=1)
    v = torch.cat([vp, v_suffix.to(dtype)], dim=1)
    return A.reference_attention(q, k, v, "causal", q_offset=p0)
