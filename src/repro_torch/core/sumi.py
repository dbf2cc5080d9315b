"""SUMI — single user, multiple items: FLAME's request paradigm.  Port of
``repro/core/sumi.py``.

A GR ranking request carries one user history (length n) and M candidate
items.  All M candidates are scored in ONE forward pass by concatenating them
after the history and applying the SUMI mask (candidates attend to history
and themselves, never to each other).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.fused_score import ops as fs_ops
from repro_torch.kernels.fused_score.ref import _prep
from repro_torch.models import attention as A


def assemble(history_emb, cand_emb) -> Tuple[torch.Tensor, int]:
    """[B,n,d] + [B,M,d] -> ([B,n+M,d], n_history)."""
    return torch.cat([history_emb, cand_emb], dim=1), history_emb.shape[1]


def split_candidates(x, n_history: int):
    """[B,n+M,d] -> candidate outputs [B,M,d]."""
    return x[:, n_history:]


def sumi_attention(q, k, v, n_history: int, *, impl: str = "reference",
                   temperature=None):
    """Mask-aware attention under the SUMI mask.  q/k/v [B,S,H,D]."""
    return A.attention(A.scale_by_temperature(q, temperature), k, v, "sumi",
                       impl=impl, n_history=n_history)


def _dequant_gather(k, v, k_scale, v_scale, row_index, dtype):
    """Materialize pool-stored operands for the reference impl: the exact
    dequantize + per-row gather sequence the FKE oracle defines."""
    return _prep(k, v, k_scale, v_scale, row_index, dtype)


def _no_packed(row_index):
    if row_index is not None and row_index.dim() == 2:
        raise NotImplementedError(
            "a per-candidate (segment-packed, 2-D) row_index is not ported "
            "yet (ROADMAP.md Queue 1 item 5)")


def cached_candidate_attention(q, k_hist, v_hist, k_cand, v_cand, *,
                               impl: str = "reference", temperature=None,
                               k_scale=None, v_scale=None, row_index=None):
    """Candidate-only SUMI attention against cached per-layer history K/V.

    ``q``/``k_cand``/``v_cand`` [B,M,...] candidate projections; ``k_hist``/
    ``v_hist`` [U,n_history,...] in the pool's stored precision (int8/bf16/
    native) with optional per-(row, head) ``k_scale``/``v_scale`` and a [B]
    ``row_index`` (the DSO's KV-row dedup).  Query row i sits at absolute KV
    position ``n_history + i``.  ``impl="fused"`` consumes the stored
    operands in kernel K1; the reference impl dequantizes, gathers and
    concatenates first."""
    _no_packed(row_index)
    q = A.scale_by_temperature(q, temperature)
    if impl == "fused":
        return fs_ops.fused_cached_attention(
            q, k_hist, v_hist, k_cand, v_cand, k_scale=k_scale,
            v_scale=v_scale, row_index=row_index)
    if k_scale is not None or v_scale is not None or row_index is not None \
            or k_hist.dtype != q.dtype:
        k_hist, v_hist = _dequant_gather(k_hist, v_hist, k_scale, v_scale,
                                         row_index, q.dtype)
    n = k_hist.shape[1]
    k = torch.cat([k_hist, k_cand], dim=1)
    v = torch.cat([v_hist, v_cand], dim=1)
    return A.attention(q, k, v, "sumi", impl=impl, n_history=n, q_offset=n)


def decode_candidate_attention(q, k_hist, v_hist, k_cand, v_cand, lengths, *,
                               impl: str = "fused", temperature=None,
                               k_scale=None, v_scale=None, row_index=None):
    """Generative-decode SUMI attention against a padded, growing cache
    whose valid prefix per row is ``lengths``.  Only the fused route (K1
    with its ``lengths`` bound) is ported; the generation path that calls it
    is ROADMAP.md Queue 1 item 7."""
    if impl != "fused":
        raise NotImplementedError(
            "decode_candidate_attention is ported for impl='fused' only "
            "(ROADMAP.md Queue 1 item 7)")
    _no_packed(row_index)
    return fs_ops.fused_decode_attention(
        q, k_hist, v_hist, k_cand, v_cand, lengths, k_scale=k_scale,
        v_scale=v_scale, row_index=row_index, temperature=temperature)


def extend_attention(q, k_prefix, v_prefix, k_suffix, v_suffix, *,
                     impl: str = "reference", temperature=None,
                     k_scale=None, v_scale=None, row_index=None):
    """Causal suffix attention against cached prefix K/V: query row i sits
    at absolute position ``P + i``.  A zero-length prefix is plain causal
    attention."""
    _no_packed(row_index)
    q = A.scale_by_temperature(q, temperature)
    if impl == "fused" and k_prefix.shape[1] > 0:
        return fs_ops.fused_extend_attention(
            q, k_prefix, v_prefix, k_suffix, v_suffix, k_scale=k_scale,
            v_scale=v_scale, row_index=row_index)
    if k_scale is not None or v_scale is not None or row_index is not None \
            or k_prefix.dtype != q.dtype:
        k_prefix, v_prefix = _dequant_gather(k_prefix, v_prefix, k_scale,
                                             v_scale, row_index, q.dtype)
    p0 = k_prefix.shape[1]
    k = torch.cat([k_prefix, k_suffix], dim=1)
    v = torch.cat([v_prefix, v_suffix], dim=1)
    return A.attention(q, k, v, "causal", impl=impl, q_offset=p0)
