"""SUMI — single user, multiple items: FLAME's request paradigm.  Port of
``repro/core/sumi.py``.

A GR ranking request carries one user history (length n) and M candidate
items.  All M candidates are scored in ONE forward pass by concatenating them
after the history and applying the SUMI mask (candidates attend to history
and themselves, never to each other).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_decode.ops import flash_decode_with_self
from repro_torch.kernels.fused_score import ops as fs_ops
from repro_torch.kernels.fused_score.ops import per_pool_row
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


def _packed(row_index) -> bool:
    return row_index is not None and row_index.dim() == 2


def _segment_packed_attention(q, k_hist, v_hist, k_cand, v_cand, seg, *,
                              impl: str, k_scale=None, v_scale=None):
    """Cached-candidate SUMI attention for a segment-packed row under the
    framework impls (``impl="fused"`` takes the 2-D index in kernel K1):
    ``seg`` [B, M] maps every candidate to its user's pool row in
    ``k_hist``/``v_hist`` [U, S, Hkv, D].  The JAX package computes it in
    plain jnp with the history gathered per candidate; here each pool row
    goes once through the impl's unpacked route (:func:`per_pool_row`)."""
    return per_pool_row(lambda idx: cached_candidate_attention(
        q, k_hist, v_hist, k_cand, v_cand, impl=impl, k_scale=k_scale,
        v_scale=v_scale, row_index=idx), seg, k_hist.shape[0])


def cached_candidate_attention(q, k_hist, v_hist, k_cand, v_cand, *,
                               impl: str = "reference", temperature=None,
                               k_scale=None, v_scale=None, row_index=None):
    """Candidate-only SUMI attention against cached per-layer history K/V.

    ``q``/``k_cand``/``v_cand`` [B,M,...] candidate projections; ``k_hist``/
    ``v_hist`` [U,n_history,...] in the pool's stored precision (int8/bf16/
    native) with optional per-(row, head) ``k_scale``/``v_scale`` and a [B]
    ``row_index`` (the DSO's KV-row dedup).  Query row i sits at absolute KV
    position ``n_history + i``.  ``impl="fused"`` consumes the stored
    operands in kernel K1; the other impls dequantize, gather and
    concatenate first, then run reference attention, ``chunked`` (the
    reference at serving shapes, ``Sq * Sk <= 256 * 256``) or (pallas)
    kernel K2.

    DSO v2 segment packing: ``row_index`` may instead be [B, M], a pool row
    per candidate, so one batch row carries candidate segments of several
    users (candidates never see each other under SUMI, so packing is exact
    by construction).  K1 takes it in-kernel under ``"fused"``; the
    framework impls run :func:`_segment_packed_attention`."""
    q = A.scale_by_temperature(q, temperature)
    if impl == "fused":
        return fs_ops.fused_cached_attention(
            q, k_hist, v_hist, k_cand, v_cand, k_scale=k_scale,
            v_scale=v_scale, row_index=row_index)
    if _packed(row_index):
        return _segment_packed_attention(q, k_hist, v_hist, k_cand, v_cand,
                                         row_index, impl=impl,
                                         k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None or v_scale is not None or row_index is not None \
            or k_hist.dtype != q.dtype:
        k_hist, v_hist = _dequant_gather(k_hist, v_hist, k_scale, v_scale,
                                         row_index, q.dtype)
    n = k_hist.shape[1]
    k = torch.cat([k_hist, k_cand], dim=1)
    v = torch.cat([v_hist, v_cand], dim=1)
    return A.attention(q, k, v, "sumi", impl=impl, n_history=n, q_offset=n)


def _kernel_decode_attention(q, k_hist, v_hist, k_cand, v_cand, lengths):
    """Generative-decode scoring through kernel K4's self-slot form
    (``kernels/flash_decode``): each of the M candidates of a row attends
    to the row's valid cache prefix (``lengths`` [B]) and to its own K/V,
    which the kernel reads beside the cache.  ``k_hist``/``v_hist``
    [B,S,Hkv,D] are the dequantized, gathered rows, one per batch row.  The
    JAX package writes each candidate's K/V into a private copy of its
    cache row and decodes one more position; the function is the same
    (``flash_decode/ref.py::decode_with_self``), without the copies."""
    return flash_decode_with_self(q, k_hist, v_hist, lengths, k_cand, v_cand)


def decode_candidate_attention(q, k_hist, v_hist, k_cand, v_cand, lengths, *,
                               impl: str = "reference", temperature=None,
                               k_scale=None, v_scale=None, row_index=None):
    """Generative-decode SUMI attention against a padded, growing cache.

    Same contract as :func:`cached_candidate_attention` except the history
    operands are PRE-PADDED beam caches whose valid prefix per pool row is
    ``lengths`` [U] (int32): candidate m attends to cache positions ``<
    lengths`` plus itself, never to other candidates or cache padding.  A
    1-D ``row_index`` [B] maps batch rows onto pool rows (the DSO's KV-row
    dedup; ``lengths`` rides with the rows it describes).  Masked positions
    contribute exact softmax zeros, so a padded cache scores like the tight
    one, and at ``lengths == S`` with no padding the reference route is
    op-for-op :func:`cached_candidate_attention` (one greedy decode step IS
    ``score_candidates`` over the vocab).

    ``impl="fused"`` runs kernel K1 with its ``lengths`` bound on the stored
    operands; ``"pallas"`` dequantizes and gathers, then runs kernel K4's
    self-slot form (:func:`_kernel_decode_attention`);
    ``"reference"`` and ``"chunked"`` run the materialized-score
    formulation of the JAX package (its route for every impl but fused and
    pallas).

    ``row_index`` [B, M] is the DSO v2 packed-decode steer: every candidate
    reads its own beam's cache row and valid length (``lengths`` [U]).
    K1 (fused) and K4's self-slot form (pallas) take the 2-D index
    in-kernel, reading each candidate's row in place with no per-candidate
    cache copy; the reference route runs :func:`per_pool_row`."""
    A.check_impl(impl)
    if impl == "fused":
        return fs_ops.fused_decode_attention(
            q, k_hist, v_hist, k_cand, v_cand, lengths, k_scale=k_scale,
            v_scale=v_scale, row_index=row_index, temperature=temperature)
    q = A.scale_by_temperature(q, temperature)
    lengths = lengths.to(torch.int32)
    if _packed(row_index):
        k_hist, v_hist = _dequant_gather(k_hist, v_hist, k_scale, v_scale,
                                         None, q.dtype)
        if impl == "pallas":
            return flash_decode_with_self(q, k_hist, v_hist,
                                          lengths.contiguous(), k_cand,
                                          v_cand, row_index=row_index)
        return per_pool_row(lambda idx: _reference_decode(
            q, k_hist[idx.long()], v_hist[idx.long()], k_cand, v_cand,
            lengths[idx.long()], trim=not lengths.is_cuda), row_index,
            k_hist.shape[0])
    if k_scale is not None or v_scale is not None or row_index is not None \
            or k_hist.dtype != q.dtype:
        k_hist, v_hist = _dequant_gather(k_hist, v_hist, k_scale, v_scale,
                                         row_index, q.dtype)
    if row_index is not None:
        lengths = lengths[row_index.long()]
    if impl == "pallas":
        return _kernel_decode_attention(q, k_hist, v_hist, k_cand, v_cand,
                                        lengths.contiguous())
    return _reference_decode(q, k_hist, v_hist, k_cand, v_cand, lengths,
                             trim=not lengths.is_cuda)


def _reference_decode(q, k_hist, v_hist, k_cand, v_cand, lengths, *,
                      trim: bool):
    """The reference decode route on per-row (dequantized, gathered)
    caches: :func:`cached_candidate_attention`'s reference route (concat +
    reference_attention ops) with the valid-length mask folded into the
    SUMI mask — at lengths == S the fold is the identity.

    ``trim`` (on CPU tensors) first drops the positions past every row's
    length: they are masked for all rows, and without them the reductions
    (and their order) do not depend on how far the cache was padded, so a
    padded cache decodes bitwise like the tight one.  Reading the longest
    length is a host sync, which a CUDA-graph capture cannot take (nor
    freeze: it would bake one length into every replay), so on CUDA tensors
    — the executors' route — the mask covers the full padded S, as the JAX
    route does under ``jit``."""
    b, m, h, d = q.shape
    s = k_hist.shape[1]
    hkv = k_cand.shape[2]
    g = h // hkv
    if trim:
        s = min(s, int(lengths.max()))
    k_hist, v_hist = k_hist[:, :s], v_hist[:, :s]
    k = torch.cat([k_hist, k_cand], dim=1)
    v = torch.cat([v_hist, v_cand], dim=1)
    qf = q.float().reshape(b, m, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    base = A.make_mask(m, s + m, "sumi", n_history=s, q_offset=s,
                       device=q.device)
    ok = torch.cat([torch.arange(s, device=q.device)[None, :]
                    < lengths[:, None],
                    torch.ones((b, m), dtype=torch.bool, device=q.device)],
                   dim=-1)                                      # [B, S+M]
    mask = base[None, None, None] & ok[:, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, A.NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, m, h, d).to(q.dtype)


def extend_attention(q, k_prefix, v_prefix, k_suffix, v_suffix, *,
                     impl: str = "reference", temperature=None,
                     k_scale=None, v_scale=None, row_index=None):
    """Causal suffix attention against cached prefix K/V: query row i sits
    at absolute position ``P + i``.  A zero-length prefix is plain causal
    attention (kernel K2 under fused and pallas).  Suffix positions are
    causally ordered, so segment packing does not apply: a per-candidate
    (2-D) ``row_index`` raises, as in the JAX package.  ``chunked`` runs
    causal attention with ``q_offset`` on its framework route."""
    if _packed(row_index):
        raise ValueError("extend attention is causal within the suffix — "
                         "segment-packed (per-candidate) row_index only "
                         "applies to cached candidate scoring")
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


def flops_per_request(n_history: int, n_candidates: int, n_blocks: int,
                      layers_per_block: int, d_model: int, d_ff: int) -> float:
    """Analytic FLOPs of one SUMI forward (paper Table 2 reproduction; the
    JAX package's arithmetic, ``repro/core/sumi.py:314``)."""
    s_block = n_history // n_blocks + n_candidates
    per_tok_proj = 2 * (4 * d_model * d_model + 2 * d_model * d_ff)
    # attention scores+values; SUMI mask: candidates only see history+self
    n_hist_b = n_history // n_blocks
    attn_pairs = n_hist_b * (n_hist_b + 1) / 2 + n_candidates * (n_hist_b + 1)
    per_layer = s_block * per_tok_proj + 2 * 2 * attn_pairs * d_model
    return n_blocks * layers_per_block * per_layer


def cached_flops_per_request(n_history: int, n_candidates: int, n_blocks: int,
                             layers_per_block: int, d_model: int,
                             d_ff: int) -> float:
    """Analytic FLOPs of a candidate-only pass against cached history K/V:
    projections / FFN run over M tokens instead of n_history + M, and the
    attention pairs lose the causal history-history triangle
    (``repro/core/sumi.py:326``)."""
    per_tok_proj = 2 * (4 * d_model * d_model + 2 * d_model * d_ff)
    n_hist_b = n_history // n_blocks
    attn_pairs = n_candidates * (n_hist_b + 1)
    per_layer = n_candidates * per_tok_proj + 2 * 2 * attn_pairs * d_model
    return n_blocks * layers_per_block * per_layer
