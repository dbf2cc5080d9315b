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
``chunked``    the JAX package's framework impl (and its engines' default):
               the materialized reference when ``Sq * Sk <= 256 * 256``,
               else :func:`chunked_attention`, online softmax over KV
               chunks.  Plain PyTorch on every device: no kernel runs.
``pallas``     every mode and offset goes to ``kernels/flash_attention``
               (kernel K2), as the JAX package's ``impl="pallas"`` does.
``fused``      the serving path.  The cached-candidate SUMI case goes to
               ``kernels/fused_score`` (kernel K1); every other mode goes to
               ``kernels/flash_attention`` (kernel K2), the monolithic SUMI
               pass of the pool-off ``full`` family among them.  Each
               wrapper launches its CUDA kernel on a CUDA tensor and runs
               its plain PyTorch version on a CPU tensor.  (The JAX package
               sends these passes to ``chunked`` under ``impl="fused"``; the
               port sends them to its port of the flash-attention TPU kernel
               — the same function, on the kernel — and holds the result to
               the JAX output within the bf16 tolerance.)

``cp``         context parallelism (:func:`context_parallel_attention`)
               under an active mesh (``sharding.mesh_rules``) with a
               ``model`` axis, for ``sliding`` / ``causal`` / ``full``
               without a query offset; ``chunked`` otherwise, as the JAX
               package routes it.  Under the port's SPMD convention q / k /
               v are the rank's block of the sequence, so the JAX
               condition that the model ways divide S holds by
               construction.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models import layers as L

NEG_INF = -1e30

#: the attention impls of the port (the JAX package's)
IMPLS = ("fused", "pallas", "chunked", "reference", "cp")


def check_impl(impl: str) -> None:
    """Raise ``ValueError`` for an impl name the port does not know."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


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
        "wq": L.dense_init((d, cfg.n_heads, hd), ("embed", "heads", None),
                           fan_in_axes=(0,), **kw),
        "wk": L.dense_init((d, cfg.n_kv_heads, hd),
                           ("embed", "kv_heads", None), fan_in_axes=(0,),
                           **kw),
        "wv": L.dense_init((d, cfg.n_kv_heads, hd),
                           ("embed", "kv_heads", None), fan_in_axes=(0,),
                           **kw),
        "wo": L.dense_init((cfg.n_heads, hd, d), ("heads", None, "embed"),
                           fan_in_axes=(0, 1), **kw),
    }
    if cfg.qkv_bias:
        for name, h, ax in (("bq", cfg.n_heads, "heads"),
                            ("bk", cfg.n_kv_heads, "kv_heads"),
                            ("bv", cfg.n_kv_heads, "kv_heads")):
            p[name] = L.full_init((h, hd), (ax, None), 0.0, device=device,
                                  stacked=stacked)
    return p


def _proj(x, w):
    """[B,S,d] x [d,H,D] -> [B,S,H,D] (one GEMM)."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(params, x, cfg, positions):
    """x [B,S,d] -> q [B,S,H,D], k/v [B,S,Hkv,D], RoPE applied.  Under
    tensor parallelism (the rank's block of the query heads) ``x`` is the
    same on every model rank and enters work each rank does differently,
    so its gradient is summed over ``model`` (``sharding.psum_grad``);
    KV heads that do not divide the model ways are computed whole on
    every rank and each rank reads its own of them
    (:func:`local_kv_heads`): their gradients are summed instead."""
    split = params["wq"].shape[1] != cfg.n_heads
    kv_split = params["wk"].shape[1] != cfg.n_kv_heads
    xq = shd.psum_grad(x) if split else x
    xkv = xq if kv_split else x
    q = _proj(xq, params["wq"])
    k = _proj(xkv, params["wk"])
    v = _proj(xkv, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if split and not kv_split:
        k, v = shd.psum_grad(k, v)
    return q, k, v


def local_kv_heads(x, cfg, h_local: int):
    """The KV heads [..., Hkv, D] that a rank's ``h_local`` query heads
    read under tensor parallelism (the query heads split over ``model``):
    ``x`` as it is when the query heads are whole or the KV heads are
    the rank's own block (both split, the GQA ratio kept); else, the KV
    heads replicated (they do not divide the model ways), the heads its
    query block maps to: a contiguous run when the block holds whole
    groups or sits in one, one head per query head otherwise."""
    if h_local == cfg.n_heads or x.shape[-2] != cfg.n_kv_heads:
        return x
    g = cfg.n_heads // cfg.n_kv_heads
    first = shd.axis_index("model") * h_local
    if h_local % g == 0:
        return x.narrow(-2, first // g, h_local // g)
    if g % h_local == 0:
        return x.narrow(-2, first // g, 1)
    idx = (first + torch.arange(h_local, device=x.device)) // g
    return x.index_select(x.dim() - 2, idx)


def project_out(params, o, partial: bool = False):
    """o [B,S,H,D] -> [B,S,d].  ``partial``: the rank holds some of the
    heads (tensor parallelism), and its partial sum comes back in
    float32."""
    h, k, d = params["wo"].shape
    w = params["wo"].reshape(h * k, d)
    if partial:
        return torch.matmul(o.flatten(-2).float(), w.float())
    return torch.matmul(o.flatten(-2), w)


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


# ---------------------------------------------------------------------------
# chunked flash-style attention (plain PyTorch, no O(S^2) memory)
# ---------------------------------------------------------------------------

def _visible_kv_blocks(mode: str, qi: int, *, q_chunk: int, k_chunk: int,
                       nk: int, sk: int, n_history: int,
                       q_offset: int) -> List[int]:
    """KV chunk indices a q chunk can see under a static mask (exact block
    skip).  ``causal`` (and ``sumi`` with ``q_offset == 0``, whose candidate
    rows attend only at or below their own position): the chunks up to the
    one holding the q chunk's last diagonal element.  ``sumi`` with
    ``q_offset > 0`` (every query is a candidate): the history chunks plus
    the chunk(s) holding the queries' own keys."""
    hi = min(q_offset + (qi + 1) * q_chunk, sk)        # exclusive col bound
    n_vis = min(nk, max(1, -(-hi // k_chunk)))
    if mode == "sumi" and q_offset:
        nhb = min(nk, -(-min(n_history, sk) // k_chunk)) if n_history else 0
        d0 = min(nk - 1, (q_offset + qi * q_chunk) // k_chunk)
        return list(range(nhb)) + [j for j in range(d0, n_vis) if j >= nhb]
    return list(range(n_vis))


def chunked_attention(q, k, v, mode: str, *, window: int = 0,
                      n_history: int = 0, q_chunk: int = 1024,
                      k_chunk: int = 1024, q_offset: int = 0):
    """Online-softmax attention over KV chunks; shapes as in
    :func:`reference_attention`.  KV chunks that a q chunk cannot see under
    the static mask are skipped (``sliding``: only the in-window KV slice
    per q chunk; ``causal`` and ``sumi``: the chunks at or below the
    diagonal, with ``q_offset`` the history chunks and the self diagonal;
    ``full``: every chunk).  Skipped chunks would add exact zeros, so the
    output is that of the visit-everything formulation.

    ``q_offset`` shifts the queries against the keys (query row i sits at
    absolute position ``q_offset + i``): ``sumi`` (cached candidate
    scoring) and ``causal`` (history extension) only.

    There is no ``temperature``: the JAX package's ``attention`` drops it on
    this route, the port's :func:`attention` scales q by it first."""
    if q_offset and mode not in ("sumi", "causal"):
        raise NotImplementedError(
            f"q_offset is only supported for mode in ('sumi', 'causal'), "
            f"got {mode!r}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    nq = -(-sq // q_chunk)
    pad_q = nq * q_chunk - sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    scale = 1.0 / math.sqrt(d)
    if mode == "sliding" and window and window < sk:
        return _sliding_chunked(q, k, v, window, q_chunk, sq)
    nk = -(-sk // k_chunk)
    pad_k = nk * k_chunk - sk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    ks = k.reshape(b, nk, k_chunk, hkv, d).float()
    vs = v.reshape(b, nk, k_chunk, hkv, d).float()
    dev = q.device

    def q_block(qi: int, ids: List[int]):
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        qf = q[:, qi * q_chunk:(qi + 1) * q_chunk].float().reshape(
            b, q_chunk, hkv, g, d) * scale
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        for ki in ids:
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ks[:, ki])
            msk = mask_value(q_pos[:, None], k_pos[None, :], mode,
                             window=window, n_history=n_history)
            msk = msk & (k_pos[None, :] < sk)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vs[:, ki])
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        return o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d)

    every = list(range(nk))
    out = torch.cat([
        q_block(qi, _visible_kv_blocks(
            mode, qi, q_chunk=q_chunk, k_chunk=k_chunk, nk=nk, sk=sk,
            n_history=n_history, q_offset=q_offset)
            if mode in ("causal", "sumi") else every)
        for qi in range(nq)], dim=1)
    return out[:, :sq].to(q.dtype)


def _sliding_chunked(q, k, v, window: int, q_chunk: int, sq: int):
    """Sliding-window chunked attention: each q chunk (``q`` already padded
    to whole chunks) attends to the ``window + q_chunk`` keys ending at its
    last row, O(S * (W + C)) instead of O(S^2)."""
    b, sq_p, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    span = min(window + q_chunk, sk)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    outs = []
    for qi in range(sq_p // q_chunk):
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        start = min(max(qi * q_chunk + q_chunk - span, 0), max(sk - span, 0))
        k_pos = start + torch.arange(span, device=dev)
        qf = q[:, qi * q_chunk:(qi + 1) * q_chunk].float().reshape(
            b, q_chunk, hkv, g, d) * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                         k[:, start:start + span].float())
        msk = mask_value(q_pos[:, None], k_pos[None, :], "sliding",
                         window=window) & (k_pos[None, :] < sk)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", w,
                         v[:, start:start + span].float())
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# single-token decode attention (the text kinds' ring caches, and every
# non-ring cache outside ``impl="pallas"``)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, cur_len, *, window: int = 0):
    """q [B,1,H,D]; caches [B,Smax,Hkv,D]; ``cur_len`` = tokens valid in the
    cache (the new one included): a 0-d or [B] tensor.  A ``window`` masks
    positions older than ``cur_len - window``.  f32 scores, masked keys
    filled with -1e30 before the softmax, as the JAX package."""
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) / math.sqrt(d)
    pos = torch.arange(smax, device=q.device)[None, :]
    cur = cur_len.to(q.device).reshape(-1, 1)
    valid = pos < cur
    if window:
        valid = valid & (pos >= cur - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def _masked_attention_pos(q, k, v, q_pos, k_pos, mode: str, *,
                          window: int):
    """Attention with explicit absolute positions (context-parallel local
    shards).  q [B,Sq,H,D], k/v [B,Sk,Hkv,D]; q_pos [Sq], k_pos [Sk]; a
    key at a negative position is masked, and a query row that sees no
    key gives zeros."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    msk = mask_value(q_pos[:, None], k_pos[None, :], mode, window=window)
    msk = msk & (k_pos[None, :] >= 0)
    s = torch.where(msk, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = torch.where(msk.any(-1)[:, None], w, torch.zeros_like(w))
    o = torch.einsum("bhgqk,bkhd->bhgqd", w, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def context_parallel_attention(q, k, v, mode: str, *, window: int, mesh=None,
                               seq_axis: str = "model"):
    """Context parallelism over ``seq_axis`` of the active mesh (SPMD: run
    on every rank inside ``sharding.mesh_rules``; ``mesh``, when given,
    must be the active one).

    q/k/v [B, S_local, H, D] are this rank's blocks: the batch split over
    the other axes, the sequence over ``seq_axis`` (rank i holds positions
    ``i * S_local ...``).  Returns the rank's block of the output.
      sliding: a halo exchange — each rank sends its last ``window`` K/V
               to rank i + 1 (``sharding.ppermute_next``); attention is
               then local (exact for SWA).  Rank 0's halo wraps around
               from the last rank and is masked.
      causal/full: K/V all-gathered over the seq axis; Q stays local."""
    act = shd.active()
    if act is None or (mesh is not None and act[0] is not mesh):
        raise ValueError("context_parallel_attention runs inside "
                         "sharding.mesh_rules(mesh)")
    n = shd.axis_size(seq_axis)
    s_loc = q.shape[1]
    off = shd.axis_index(seq_axis) * s_loc
    dev = q.device
    q_pos = off + torch.arange(s_loc, device=dev)
    if mode == "sliding" and window and window <= s_loc:
        halo = shd.ppermute_next(torch.cat([k[:, -window:], v[:, -window:]],
                                           dim=-1), seq_axis)
        kk = torch.cat([halo[..., :k.shape[-1]], k], dim=1)
        vv = torch.cat([halo[..., k.shape[-1]:], v], dim=1)
        k_pos = off - window + torch.arange(window + s_loc, device=dev)
        return _masked_attention_pos(q, kk, vv, q_pos, k_pos, "sliding",
                                     window=window)
    kk = shd.all_gather(k, seq_axis, dim=1)
    vv = shd.all_gather(v, seq_axis, dim=1)
    k_pos = torch.arange(s_loc * n, device=dev)
    return _masked_attention_pos(q, kk, vv, q_pos, k_pos, mode,
                                 window=window)


#: the masks context parallelism takes (the JAX ``attention``'s)
CP_MODES = ("sliding", "causal", "full")


def cp_applies(s_q: int, s_k: int, mode: str) -> bool:
    """Whether a self-attention of ``s_q`` queries runs context-parallel
    under ``impl="cp"``: an active mesh with a ``model`` axis, a
    :data:`CP_MODES` mask, and the sequence divisible by the model ways
    (JAX's condition), over keys of the same sequence (a cross-attention,
    ``s_q != s_k``, runs ``chunked``)."""
    act = shd.active()
    return (act is not None and "model" in act[0].axis_names
            and mode in CP_MODES and s_q == s_k
            and s_q % shd.axis_size("model") == 0)


def heads_attention(q, k, v, cfg, mode: str, *, impl: str, window: int = 0):
    """Attention of the rank's query heads ``q`` [B,S,H_loc,D] over
    ``k`` / ``v`` [B,S,Hkv_loc,D] (its block of the KV heads, or every
    KV head, :func:`local_kv_heads`), the sharded text families' prefill
    and train route.  Under ``impl="cp"`` where :func:`cp_applies`, the
    heads move to sequence blocks (:func:`_cp_heads`) and
    :func:`context_parallel_attention` runs over ``model``, as JAX's
    ``attention`` runs it under a mesh; every other case and ``cp``
    elsewhere take ``impl`` (``cp``: ``chunked``)."""
    if impl == "cp":
        if cp_applies(q.shape[1], k.shape[1], mode):
            return _cp_heads(q, k, v, cfg, mode, window)
        impl = "chunked"
    h_loc = q.shape[2]
    return attention(q, local_kv_heads(k, cfg, h_loc),
                     local_kv_heads(v, cfg, h_loc), mode, impl=impl,
                     window=window)


def _heads_to_seq(x, m: int):
    """[B, S, Hc, D] (the rank's heads, every position) -> [B, S/m, m, Hc,
    D]: every rank's heads at the rank's block of the positions (one
    ``all_to_all`` over ``model``)."""
    b, s, hc, d = x.shape
    blocks = x.reshape(b, m, s // m, hc, d).movedim(1, 0)
    return shd.all_to_all(blocks, "model").movedim(0, 2)


def _seq_to_heads(o, m: int):
    """[B, S/m, H, D] (every head, the rank's positions) -> [B, S, H/m,
    D]: the rank's heads at every position (one ``all_to_all``)."""
    b, sl, h, d = o.shape
    blocks = o.reshape(b, sl, m, h // m, d).movedim(2, 0)
    return shd.all_to_all(blocks, "model").movedim(0, 1).reshape(
        b, m * sl, h // m, d)


def _cp_heads(q, k, v, cfg, mode: str, window: int):
    """:func:`heads_attention`'s context-parallel route.  The rank's head
    block of q / k / v becomes a sequence block over ``model`` (one
    ``all_to_all`` carries the three; KV heads that every rank holds
    whole are cut to the block instead), the sliding halo is exchanged or
    K / V all-gathered (:func:`context_parallel_attention`), and the
    output goes back to the rank's heads (one ``all_to_all``) for the
    out-projection's ``model_sum``.  With the query heads whole on every
    rank (they do not divide the model ways) each rank attends its
    sequence block and the blocks are gathered."""
    m = shd.axis_size("model")
    b, s, h_loc, d = q.shape
    sl = s // m
    off = shd.axis_index("model") * sl
    if h_loc == cfg.n_heads:
        q, k, v = shd.psum_grad(q, k, v)
        o = context_parallel_attention(q.narrow(1, off, sl),
                                       k.narrow(1, off, sl),
                                       v.narrow(1, off, sl), mode,
                                       window=window)
        return shd.all_gather(o, "model", dim=1, uses="same")
    if k.shape[2] != cfg.n_kv_heads:        # the KV heads split too
        hk = k.shape[2]
        got = _heads_to_seq(torch.cat([q, k, v], dim=2), m)
        qs, ks, vs = got.split([h_loc, hk, hk], dim=3)
        ks = ks.reshape(b, sl, m * hk, d)
        vs = vs.reshape(b, sl, m * hk, d)
    else:
        qs = _heads_to_seq(q, m)
        ks, vs = k.narrow(1, off, sl), v.narrow(1, off, sl)
    o = context_parallel_attention(qs.reshape(b, sl, m * h_loc, d), ks, vs,
                                   mode, window=window)
    return _seq_to_heads(o, m)


def attention(q, k, v, mode: str, *, impl: str = "fused", window: int = 0,
              n_history: int = 0, temperature=None, q_offset: int = 0):
    """Dispatch wrapper used by the Climber blocks (see module docstring).

    ``impl="chunked"`` routes as the JAX package does: the materialized
    reference when ``Sq * Sk <= 256 * 256``, :func:`chunked_attention`
    otherwise.  It applies ``temperature`` on both routes (q scaled first
    on the chunked one), where the JAX package's chunked route drops it: at
    a shape above 256 * 256 with a temperature other than 1 the two
    packages' chunked routes differ by design, and the port's equals its
    reference."""
    check_impl(impl)
    if impl == "cp":
        act = shd.active()
        if act is not None and "model" in act[0].axis_names \
                and mode in ("sliding", "causal", "full") and not q_offset:
            return context_parallel_attention(
                scale_by_temperature(q, temperature), k, v, mode,
                window=window)
        impl = "chunked"
    if impl == "reference" or (impl == "chunked"
                               and q.shape[1] * k.shape[1] <= 256 * 256):
        return reference_attention(q, k, v, mode, window=window,
                                   n_history=n_history,
                                   temperature=temperature,
                                   q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(scale_by_temperature(q, temperature), k, v,
                                 mode, window=window, n_history=n_history,
                                 q_offset=q_offset)
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
