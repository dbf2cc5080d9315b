"""Fused candidate-scoring attention (FKE) — kernel K1 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/fused_score/kernel.py::
fused_score_kernel`` (body ``_fused_kernel``) with the hand-written CUDA
kernel ``repro_torch/csrc/fused_score.cu`` (``fused_score_fwd``).  On the
serving path it runs the attention of every ``cached`` dispatch
(``core/sumi.py::cached_candidate_attention`` under ``impl="fused"``) and
of every fused ``extend`` dispatch (``extend_attention``), once per layer:
2 blocks x 12 layers = 24 launches per dispatch at the published Climber
width.  It reads the pool's STORED history — int8 codes with the
per-(row, kv head) scale / 127 folded in, bf16, or f32 — and the dedup
``row_index`` directly, so the dequantized, gathered and concatenated K/V
never reach device memory.

What bounds it on an H100: at the scoring shapes (q [4, 128, 4, 64] bf16, an
int8 history of 257 positions for up to 4 pool rows) the function moves about
1.6 MB and does about 0.14 GFLOP — half a microsecond of memory time.
Storing the history in int8 is what keeps those bytes low; at this size
what sets the time is latency, the chain of dependent work in one block.
For bf16 q in ``cached`` mode over an int8 or bf16 history (the serving
path) the kernel runs both products on the tensor cores (``mma.sync``): a
block of four warps owns 16 candidates, its warps split the history's key
tiles (each through its own two-slot ring of tiles staged as bf16 codes)
and combine their softmax states in warp order; the scales apply in f32
after each product, P enters the second as bf16 hi + lo, the self key is
folded in f32 last.  A row's output depends on its q row, its pool row,
its length and its own candidate alone, and two calls agree bitwise.  bf16
q in ``extend`` mode (every fused ``extend`` dispatch) runs its own
tensor-core kernel (``csrc/extend_score.cuh``): the same block of four
warps over 16 suffix rows, the causal suffix's key tiles continuing the
prefix's over the warps, masked keys selected to P = 0, so a row's output
depends on its q row, its pool row and length and the suffix rows up to it
alone.  At the ``extend`` family's shapes ([4, 1, 4, 64] over 256 prefix
rows, [4, 129, 4, 64] over 128) it moves ~1.1-1.6 MB, 0.3-0.5 us at 3.35
TB/s: latency bound as well.  f32 q and an f32 history run the scalar
kernel (one thread per query row).

A segment-packed dispatch (DSO v2) hands a per-candidate ``row_index``
[B, M] instead of [B]: one batch row carries candidate segments of several
users.  The JAX kernel samples the index once per q block of ``bq``
candidates, so its packer aligns segments to ``bq``; a block of this kernel
owns 16 candidates and loops over the distinct pool rows among them,
streaming each row's history tiles with the other rows' softmax states
left untouched, so every alignment works (:func:`set_packed_alignment` is
the packer's declaration, which nothing here needs) and a packed candidate
sees the tiles, in the warp order, of its unpacked dispatch: packed ==
unpacked bitwise.  ``packed_kernel_reroutes`` (the JAX module's count of
2-D calls rerouted off the kernel) therefore stays 0.

The kernels above are instantiated for head dims 16-128 (a dim between
them padded).  Past 128, where the TPU wrapper pads D to its lanes and runs
any D, :func:`route` picks the any-dims variant ``csrc/score_any.cu``
(``score_any_fwd``) in both modes, for every q and history dtype: one
launch a call, no workspace.  A thread-block cluster of four CTAs takes a
group of up to 64 rows; CTA r folds the 64-key splits of the history (and,
in ``extend`` mode, of the suffix keys before each row's own) whose index
is r modulo 4 into its rows' running softmax state, both products on the
tensor cores (bf16, or split TF32 where q or the history is f32), the
history staged as stored by ``cp.async``; the four states merge on chip in
rank order through distributed shared memory, the row's own key last (the
candidate's, or in ``extend`` the suffix key at the row's position)
(:func:`repro_torch.kernels._any.score_plan` reports the launch).  Its
launch is :func:`score_any`, which K4's self-slot form past head dim 128
runs too (K1's ``cached`` mode over an unscaled history in q's dtype); its
twin is :func:`fused_score_any_plain`.

Entry points (model layout [B,S,H,D]): :func:`fused_cached_attention`,
:func:`fused_extend_attention`, :func:`fused_decode_attention` (cached mode
with a per-pool-row valid ``lengths`` bound).  All three go through
:func:`fused_score`, the wrapper: the CUDA kernel on CUDA tensors (raising
if the launch fails — there is no fallback), its plain version on CPU
tensors.  ``fused_score.launches`` counts kernel launches; :func:`plan`
gives a launch's grid, block and shared memory.  The tiled kernels' grid y
is B * H: past 65535 the wrapper launches over batch chunks.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _any, _build
from repro_torch.kernels.padding import pad_last, padded_dim
from repro_torch.models.attention import scale_by_temperature

MODES = {"cached": 0, "extend": 1}
HEAD_DIMS = (16, 32, 64, 128)
#: the largest head dim the tiled kernels take (padded); past it the
#: any-dims variant runs
MAX_TILED_DIM = max(HEAD_DIMS)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HIST_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
_ANY_ARGTYPES = _ARGTYPES + [ctypes.c_void_p]
_count_lock = _build.COUNT_LOCK
NEG_INF = -1e30

#: 2-D (segment-packed) calls rerouted from the kernel to a plain version;
#: the JAX module's counter, which here stays 0: the kernel takes a packed
#: index at any alignment
packed_kernel_reroutes = 0

# the packer's alignment contract (core/dso.py ``SegmentPacker.align``),
# declared by the engine while it builds its executors
_packed_align = 0


def set_packed_alignment(n: int) -> int:
    """Declare the packed-segment alignment (0 clears), as the JAX module
    does for its kernel's q blocks; returns the previous value.  The CUDA
    kernel needs no alignment, so the declaration routes nothing."""
    global _packed_align
    n = int(n)
    if n and (n < 8 or n % 8):
        raise ValueError("packed alignment must be 0 or a multiple of 8, "
                         f"got {n}")
    with _count_lock:
        prev, _packed_align = _packed_align, n
    return prev


def packed_alignment() -> int:
    with _count_lock:
        return _packed_align


def per_pool_row(route, row_index, n_rows: int):
    """A segment-packed (2-D, ``[B, M]``) ``row_index`` resolved through the
    1-D route: ``route(idx)`` is the call with every batch row on pool row
    ``idx[b]``; it runs once per pool row ``u`` (``idx`` all ``u``) and each
    candidate keeps the result of its own row.  A candidate thus gets
    exactly the arithmetic of an unpacked dispatch of its user at the same
    shapes, whatever order a formulation over per-candidate gathered
    operands would reduce in (torch's CPU reductions follow the operands'
    shapes), so packed == unpacked bitwise.  Dead slots (seg 0) take row
    0's result, as in the JAX package.  The plain versions and the
    framework impls' packed routes use it; the kernels take the 2-D index
    themselves."""
    out = None
    for u in range(n_rows):
        o = route(torch.full_like(row_index[:, 0], u))
        pick = (row_index == u).reshape(row_index.shape
                                        + (1,) * (o.dim() - 2))
        out = o if out is None else torch.where(pick, o, out)
    return out


def _norm_scale(scale, u: int, hkv: int):
    """Pool scales arrive [U,1,Hkv,1] (per-layer slice of the per-(layer,
    head) absmax); normalize to contiguous [U,Hkv] f32 with the int8 /127
    folded in."""
    if scale is None:
        return None
    return (scale.float() / 127.0).reshape(u, hkv).contiguous()


# ---------------------------------------------------------------------------
# plain version (mirrors the JAX two-segment twin ops.py::_fused_jnp)
# ---------------------------------------------------------------------------

def fused_score_plain(q, k_hist, v_hist, k_cand, v_cand, *, mode: str,
                      k_scale=None, v_scale=None, row_index=None,
                      lengths=None, scale=None):
    """Two-segment attention with no concatenation and no dense mask.

    ``q``/``k_cand``/``v_cand`` [B,M,H(kv),D]; ``k_hist``/``v_hist``
    [U,S,Hkv,D] stored values; ``k_scale``/``v_scale`` [U,Hkv] f32
    multipliers (int8 /127 folded in) or None; ``row_index`` [B] or
    [B, M] (``cached`` mode: a pool row per candidate, :func:`per_pool_row`)
    or None; ``lengths`` [U] valid history prefix or None.  ``scale``:
    the softmax scale, 1 / sqrt(D) by default.  Masked history columns are
    -1e30 before the max and exact zeros after the exp."""
    if row_index is not None and row_index.dim() == 2:
        return per_pool_row(lambda idx: fused_score_plain(
            q, k_hist, v_hist, k_cand, v_cand, mode=mode, k_scale=k_scale,
            v_scale=v_scale, row_index=idx, lengths=lengths, scale=scale),
            row_index, k_hist.shape[0])
    b, m, h, d = q.shape
    hkv = k_cand.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, m, hkv, g, d)
    qf = qf / math.sqrt(d) if scale is None else qf * scale
    hist_ok = None
    if lengths is not None:
        lens = lengths.int()
        if row_index is not None:
            lens = lens[row_index.long()]
        pos = torch.arange(k_hist.shape[1], device=q.device)
        hist_ok = (pos[None, :] < lens[:, None])[:, None, None, None]
    if row_index is not None:
        idx = row_index.long()
        k_hist, v_hist = k_hist[idx], v_hist[idx]
        k_scale = None if k_scale is None else k_scale[idx]
        v_scale = None if v_scale is None else v_scale[idx]
    s_hist = torch.einsum("bmhgd,bshd->bhgms", qf, k_hist.float())
    if k_scale is not None:
        s_hist = s_hist * k_scale[:, :, None, None, None]
    if hist_ok is not None:
        s_hist = torch.where(hist_ok, s_hist, torch.full_like(s_hist, NEG_INF))

    def hist_out(p_hist):
        o = torch.einsum("bhgms,bshd->bmhgd", p_hist, v_hist.float())
        if v_scale is not None:
            o = o * v_scale[:, None, :, None, None]
        return o

    if mode == "cached":
        s_self = torch.einsum("bmhgd,bmhd->bhgm", qf, k_cand.float())
        m_all = torch.maximum(s_hist.amax(dim=-1), s_self)
        p_hist = torch.exp(s_hist - m_all[..., None])
        if hist_ok is not None:
            p_hist = torch.where(hist_ok, p_hist, torch.zeros_like(p_hist))
        p_self = torch.exp(s_self - m_all)
        l = p_hist.sum(dim=-1) + p_self
        o = hist_out(p_hist) + torch.einsum("bhgm,bmhd->bmhgd", p_self,
                                            v_cand.float())
    else:                                            # extend (causal suffix)
        s_suf = torch.einsum("bmhgd,bshd->bhgms", qf, k_cand.float())
        ar = torch.arange(m, device=q.device)
        causal = ar[None, :] <= ar[:, None]
        s_suf = torch.where(causal, s_suf, torch.full_like(s_suf, NEG_INF))
        m_all = torch.maximum(s_hist.amax(dim=-1), s_suf.amax(dim=-1))
        p_hist = torch.exp(s_hist - m_all[..., None])
        if hist_ok is not None:
            p_hist = torch.where(hist_ok, p_hist, torch.zeros_like(p_hist))
        p_suf = torch.exp(s_suf - m_all[..., None])
        p_suf = torch.where(causal, p_suf, torch.zeros_like(p_suf))
        l = p_hist.sum(dim=-1) + p_suf.sum(dim=-1)
        o = hist_out(p_hist) + torch.einsum("bhgms,bshd->bmhgd", p_suf,
                                            v_cand.float())
    l = l.clamp_min(1e-30).permute(0, 3, 1, 2)        # [b,m,hkv,g]
    return (o / l[..., None]).reshape(b, m, h, d).to(q.dtype)


def compute_dtype(q_dtype, hist_dtype):
    """The any-dims variant's operand type: bf16 for bf16 q over an int8
    or bf16 history (int8 codes are exact in bf16), f32 (split TF32)
    otherwise."""
    return (torch.bfloat16 if q_dtype == torch.bfloat16
            and hist_dtype != torch.float32 else torch.float32)


def fused_score_any_plain(q, k_hist, v_hist, k_cand, v_cand, *, mode: str,
                          k_scale=None, v_scale=None, row_index=None,
                          lengths=None):
    """The any-dims variant's plain twin (``csrc/score_any.cu``): each row's
    history keys (its pool row's, the positions past ``lengths`` masked) in
    splits of :data:`_any.SPLIT`, each split's scores multiplied in f32 by
    ``k_scale[row, kv head] / sqrt(D)``; in ``extend`` mode the suffix keys
    before each row's own as a second segment of splits; the splits dealt
    to the cluster's ranks by index, folded and merged in rank order, the
    accumulators of the history times ``v_scale[row, kv head]`` and the
    row's own key last (``cached``: the candidate's; ``extend``: the suffix
    key at the row's position) (:func:`_any.cluster_fold`), with the
    kernel's operand roundings
    (:func:`compute_dtype`).  Same arguments and result as
    :func:`fused_score_plain` (the softmax scale 1 / sqrt(D)); a packed
    index runs per pool row (:func:`per_pool_row`), as the kernel's passes
    do."""
    if row_index is not None and row_index.dim() == 2:
        return per_pool_row(lambda idx: fused_score_any_plain(
            q, k_hist, v_hist, k_cand, v_cand, mode=mode, k_scale=k_scale,
            v_scale=v_scale, row_index=idx, lengths=lengths),
            row_index, k_hist.shape[0])
    b, m, h, d = q.shape
    u, s, hkv, _ = k_hist.shape
    g = h // hkv
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    dt = compute_dtype(q.dtype, k_hist.dtype)
    idx = (torch.arange(b, device=dev) if row_index is None
           else row_index.long())

    def rows(t):            # [B, M, Hkv(, G), D] -> [B, Hkv, M * G, D]
        t = t.float().reshape(b, m, hkv, -1, d).permute(0, 2, 1, 3, 4)
        return t.expand(b, hkv, m, g, d).reshape(b, hkv, m * g, d)

    qf = rows(q)
    lens = (torch.full((b,), s, device=dev) if lengths is None
            else lengths.long()[idx].clamp(0, s))
    ok = (torch.arange(s, device=dev)[None, :]
          < lens[:, None])[:, None, None, :]
    ksc = (torch.ones((b, hkv), device=dev) if k_scale is None
           else k_scale.float()[idx])
    vsc = None if v_scale is None else v_scale.float()[idx][..., None, None]
    segments = [(k_hist[idx].transpose(1, 2), v_hist[idx].transpose(1, 2),
                 ok, (ksc * scale)[..., None, None], vsc)]
    if mode == "extend":
        at = torch.arange(m, device=dev)
        before = at[None, :] < at.repeat_interleave(g)[:, None]
        segments.append((k_cand.transpose(1, 2), v_cand.transpose(1, 2),
                         before, scale, None))
    s_self = (qf * rows(k_cand[:, :, :, None])).sum(dim=-1) * scale
    o = _any.cluster_fold(qf, segments, dtype=dt, s_self=s_self,
                          v_self=rows(v_cand[:, :, :, None]))
    o = o.reshape(b, hkv, m, g, d).permute(0, 2, 1, 3, 4)
    return o.reshape(b, m, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def route(d: int) -> str:
    """``"tiled"`` (the tensor-core / scalar kernels of ``fused_score.cu``,
    a head dim between their instantiations padded) up to head dim
    :data:`MAX_TILED_DIM`, ``"any"`` (the any-dims variant,
    ``score_any.cu``) past it, for either q dtype: from the dims alone, as
    K2's :func:`repro_torch.kernels.flash_attention.ops.route`."""
    return "tiled" if d <= MAX_TILED_DIM else "any"


def _check_operands(q, k_hist, v_hist, k_cand, v_cand, k_scale, v_scale,
                    row_index, lengths):
    """The launch's checks of dtype, device, layout and the auxiliary
    operands; returns whether the row index is packed (2-D)."""
    _build.forbid_grad("fused_score", q, k_hist, v_hist, k_cand, v_cand,
                       k_scale, v_scale)
    if q.dtype not in _Q_DTYPES or k_cand.dtype != q.dtype \
            or v_cand.dtype != q.dtype:
        raise TypeError(f"fused_score kernel takes f32 or bf16 q/k_cand/"
                        f"v_cand of one dtype, got {q.dtype}, "
                        f"{k_cand.dtype}, {v_cand.dtype}")
    if k_hist.dtype not in _HIST_DTYPES or v_hist.dtype != k_hist.dtype:
        raise TypeError(f"fused_score kernel takes f32, bf16 or int8 history "
                        f"of one dtype, got {k_hist.dtype}, {v_hist.dtype}")
    b, m = q.shape[:2]
    u, hkv = k_hist.shape[0], k_hist.shape[2]
    tensors = (q, k_hist, v_hist, k_cand, v_cand)
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_score operands must be on one device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the head axis must be contiguous (stride 1)")
    packed = row_index is not None and row_index.dim() == 2
    for name, t, n in (("k_scale", k_scale, (u, hkv)),
                       ("v_scale", v_scale, (u, hkv)),
                       ("row_index", row_index, (b, m) if packed else (b,)),
                       ("lengths", lengths, (u,))):
        if t is None:
            continue
        want = torch.float32 if name.endswith("scale") else torch.int32
        if t.dtype != want or tuple(t.shape) != n or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {want} tensor of "
                             f"shape {n} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return packed


def _launch(q, k_hist, v_hist, k_cand, v_cand, mode, k_scale, v_scale,
            row_index, lengths, *, scale: float):
    """The tiled kernel (grid y = B * H) over batch chunks of at most
    ``65535 // H`` rows (:func:`_build.batch_chunks`): a chunk's batch rows
    of q, the candidates, the row index and the output; without a row
    index (batch row b on pool row b) also the history's rows, its scales
    and lengths.  One launch a chunk."""
    b, m, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    packed = _check_operands(q, k_hist, v_hist, k_cand, v_cand, k_scale,
                             v_scale, row_index, lengths)
    o = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
    u, s, hkv, _ = k_hist.shape
    own = row_index is None         # pool row = batch row: cut with it
    strides = _build.strides(q, k_hist, v_hist, k_cand, v_cand, o)
    fn = _build.function("fused_score", "fused_score_fwd", _ARGTYPES)
    at = _build.row_ptr
    for b0, b1 in _build.batch_chunks(b, h):
        r0 = b0 if own else 0
        err = fn(at(q, b0), at(k_hist, r0), at(v_hist, r0), at(k_scale, r0),
                 at(v_scale, r0), at(k_cand, b0), at(v_cand, b0),
                 at(row_index, b0), at(lengths, r0), at(o, b0),
                 _Q_DTYPES[q.dtype], _HIST_DTYPES[k_hist.dtype], int(packed),
                 b1 - b0, m, h, hkv, b1 - b0 if own else u, s, d, strides,
                 MODES[mode], scale, _build.stream_handle(q.device))
        if err:
            raise RuntimeError(f"fused_score_fwd failed with CUDA error "
                               f"{err} (q {tuple(q.shape)}, history "
                               f"{tuple(k_hist.shape)} {k_hist.dtype})")
        with _count_lock:
            fused_score.launches += 1
    return o


def score_any(q, k_hist, v_hist, k_cand, v_cand, mode, k_scale=None,
              v_scale=None, row_index=None, lengths=None, *, counter):
    """The any-dims variant (``score_any_fwd``: one launch a call, nothing
    allocated but the output) at the true D, with the softmax scale 1 /
    sqrt(D).  Its launch counts under ``counter`` (:func:`fused_score`, or
    K4's self-slot wrapper, which runs this variant past head dim 128), as
    many as the library reports it launched."""
    b, m, h, d = q.shape
    u, s, hkv, _ = k_hist.shape
    if k_hist.shape[-1] != d or k_cand.shape[-1] != d:
        raise ValueError(f"q, the history and the candidates must share "
                         f"the head dim, got {d}, {k_hist.shape[-1]}, "
                         f"{k_cand.shape[-1]}")
    packed = _check_operands(q, k_hist, v_hist, k_cand, v_cand, k_scale,
                             v_scale, row_index, lengths)
    o = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
    launched = ctypes.c_int(0)
    fn = _build.function("score_any", "score_any_fwd", _ANY_ARGTYPES)
    at = _build.row_ptr
    err = fn(q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
             at(k_scale, 0), at(v_scale, 0), k_cand.data_ptr(),
             v_cand.data_ptr(), at(row_index, 0), at(lengths, 0),
             o.data_ptr(), _Q_DTYPES[q.dtype], _HIST_DTYPES[k_hist.dtype],
             int(packed), b, m, h, hkv, u, s, d,
             _build.strides(q, k_hist, v_hist, k_cand, v_cand, o),
             MODES[mode], 1.0 / math.sqrt(d), _build.stream_handle(q.device),
             ctypes.byref(launched))
    if err:
        raise RuntimeError(f"score_any_fwd failed with CUDA error {err} "
                           f"(q {tuple(q.shape)}, history "
                           f"{tuple(k_hist.shape)} {k_hist.dtype})")
    with _count_lock:
        counter.launches += launched.value
    return o


def fused_score_padded(q, k_hist, v_hist, k_cand, v_cand, *, mode: str,
                       k_scale=None, v_scale=None, row_index=None,
                       lengths=None, run=None):
    """``run`` (the kernel's launch; the plain version in the CPU tests) at
    the instantiated head dim that holds D, as the TPU wrapper pads D to
    its 128 lanes: q, the history (int8 codes too: a zero code is a zero)
    and the candidates padded with zeros along D, the softmax scale of the
    unpadded D, the output sliced back to D."""
    d = q.shape[-1]
    dp = padded_dim(d, HEAD_DIMS)
    run = run or _launch
    o = run(*(pad_last(t, dp) for t in (q, k_hist, v_hist, k_cand, v_cand)),
            mode, k_scale, v_scale, row_index, lengths,
            scale=1.0 / math.sqrt(d))
    return o if dp == d else o[..., :d]


def fused_score(q, k_hist, v_hist, k_cand, v_cand, *, mode: str,
                k_scale=None, v_scale=None, row_index=None, lengths=None):
    """The kernel's wrapper (operand conventions as
    :func:`fused_score_plain`).  :func:`route` picks the kernel from the
    head dim: the tiled kernel (a head dim between its instantiations
    padded, :func:`fused_score_padded`) or the any-dims variant past
    :data:`MAX_TILED_DIM`.  The CUDA kernel on CUDA tensors, its plain
    version (:func:`fused_score_plain`, :func:`fused_score_any_plain`) on
    CPU tensors; anything else raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be cached|extend, got {mode!r}")
    if mode == "extend" and row_index is not None and row_index.dim() == 2:
        raise ValueError("extend mode is causal within the suffix: a "
                         "per-candidate (2-D) row_index applies to cached "
                         "mode only")
    kw = dict(mode=mode, k_scale=k_scale, v_scale=v_scale,
              row_index=row_index, lengths=lengths)
    tiled = route(q.shape[-1]) == "tiled"
    if q.is_cuda:
        if tiled:
            return fused_score_padded(q, k_hist, v_hist, k_cand, v_cand,
                                      **kw)
        return score_any(q, k_hist, v_hist, k_cand, v_cand, mode, k_scale,
                         v_scale, row_index, lengths, counter=fused_score)
    ops = [t for t in (q, k_hist, v_hist, k_cand, v_cand, k_scale, v_scale,
                       row_index, lengths) if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        plain = fused_score_plain if tiled else fused_score_any_plain
        return plain(q, k_hist, v_hist, k_cand, v_cand, **kw)
    raise ValueError("fused_score runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in ops})))


fused_score.launches = 0


def plan(q, k_hist, *, mode: str = "cached") -> dict:
    """The kernel's launch for ``q`` [B,M,H,D] against a history like
    ``k_hist``, on the route :func:`route` picks: for the tiled kernel its
    grid, threads per block, shared bytes (dynamic for the tensor-core
    kernel, static for the scalar one), whether the tensor-core kernel runs
    and the launches a call (one a batch chunk); past
    :data:`MAX_TILED_DIM` the any-dims variant's
    (:func:`repro_torch.kernels._any.score_plan`).  Reads the library; the
    CPU tests never call it."""
    b, m, h, d = q.shape
    if route(d) == "any":
        return _any.score_plan(_Q_DTYPES[q.dtype], _HIST_DTYPES[k_hist.dtype],
                               MODES[mode], b, m, h, k_hist.shape[2],
                               k_hist.shape[1], d)
    d = padded_dim(d, HEAD_DIMS)
    out = (ctypes.c_int * 5)()
    fn = _build.function("fused_score", "fused_score_plan",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p])
    if fn(_Q_DTYPES[q.dtype], _HIST_DTYPES[k_hist.dtype], MODES[mode], b, m,
          h, d, out):
        raise ValueError(f"no launch plan for q {tuple(q.shape)}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3],
                tensor_cores=bool(out[4]),
                launches=len(_build.batch_chunks(b, h)))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _fused_attention(q, k_hist, v_hist, k_cand, v_cand, *, mode: str,
                     k_scale=None, v_scale=None, row_index=None,
                     lengths=None, temperature=None):
    q = scale_by_temperature(q, temperature)
    if k_hist.shape[1] == 0:
        raise ValueError("fused attention needs a non-empty history/prefix "
                         "segment (degenerate cases route to the framework "
                         "impls in core/sumi.py)")
    u, hkv = k_hist.shape[0], k_hist.shape[2]
    if row_index is not None:
        row_index = row_index.to(torch.int32).contiguous()
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    return fused_score(q, k_hist, v_hist, k_cand, v_cand, mode=mode,
                       k_scale=_norm_scale(k_scale, u, hkv),
                       v_scale=_norm_scale(v_scale, u, hkv),
                       row_index=row_index, lengths=lengths)


def fused_cached_attention(q, k_hist, v_hist, k_cand, v_cand, *,
                           k_scale=None, v_scale=None, row_index=None,
                           temperature=None):
    """Candidate-only SUMI attention against pooled history K/V.
    ``q``/``k_cand``/``v_cand`` [B,M,H(kv),D]; ``k_hist``/``v_hist``
    [U,S,Hkv,D] pool-stored values (int8/bf16/native) with optional
    [U,1,Hkv,1] scales and a [B] ``row_index`` (KV-row dedup) or a [B, M]
    one (segment packing)."""
    return _fused_attention(q, k_hist, v_hist, k_cand, v_cand, mode="cached",
                            k_scale=k_scale, v_scale=v_scale,
                            row_index=row_index, temperature=temperature)


def fused_decode_attention(q, k_hist, v_hist, k_cand, v_cand, lengths, *,
                           k_scale=None, v_scale=None, row_index=None,
                           temperature=None):
    """Generative-decode candidate scoring against PADDED history caches
    whose valid prefix per pool row is ``lengths`` [U]; at ``lengths == S``
    this is :func:`fused_cached_attention`.  A [B, M] ``row_index`` steers
    each candidate to its own beam's row and length."""
    return _fused_attention(q, k_hist, v_hist, k_cand, v_cand, mode="cached",
                            k_scale=k_scale, v_scale=v_scale,
                            row_index=row_index, lengths=lengths,
                            temperature=temperature)


def fused_extend_attention(q, k_prefix, v_prefix, k_suffix, v_suffix, *,
                           k_scale=None, v_scale=None, row_index=None,
                           temperature=None):
    """Causal suffix attention against pooled prefix K/V: query row i sits
    at absolute position ``P + i`` and sees the prefix plus suffix keys
    ``<= i``."""
    return _fused_attention(q, k_prefix, v_prefix, k_suffix, v_suffix,
                            mode="extend", k_scale=k_scale, v_scale=v_scale,
                            row_index=row_index, temperature=temperature)
