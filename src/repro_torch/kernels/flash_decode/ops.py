"""GQA decode attention — kernel K4 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode/kernel.py::
flash_decode_kernel`` (body ``_fd_kernel``) with the hand-written CUDA
kernel ``repro_torch/csrc/flash_decode.cu``, in two forms.

:func:`flash_decode_with_self` (``flash_decode_self_fwd``) is the form the
serving path runs: every generative ``decode`` and ``append`` dispatch
under ``impl="pallas"`` (``core/sumi.py::_kernel_decode_attention``), once
per layer: 2 blocks x 12 layers = 24 launches per dispatch at the published
Climber width.  The M candidates of a row attend to the row's valid cache
prefix plus themselves (``ref.decode_with_self``).  The TPU route writes
each candidate's K/V into a private copy of its cache row and decodes one
more position; this form reads each row's cache once and the candidates'
own K/V beside it, so no copy is made.  It is K1's ``cached`` mode on an
unscaled bf16 history and runs K1's kernel (``csrc/cached_score.cuh``):
both products on the tensor cores for bf16, the scalar kernel for f32.
A segment-packed ``decode`` dispatch passes a per-candidate ``row_index``
[B, M] into the stacked beam caches [U, S, ...] (lengths [U]): K1's kernel
reads each candidate's row in place, as it does for a packed ``cached``
dispatch, where the TPU route copies a cache row per candidate.
What bounds it on an H100: the unique bytes (each beam's valid cache, the
candidates' q / K / V, the output: ~1 MB at the decode shape) take under a
microsecond, so latency sets its time, as for K1.

:func:`flash_decode` (``flash_decode_fwd``) keeps the TPU kernel's
single-token signature (q [B,H,D]): the text engine's ``attn`` layers
decode through it under ``impl="pallas"`` (gemma3-12b, head dim 240).  It
is bytes-bound: each valid cache element is read once for 4 G FLOPs.  One
block per (row, KV head) streams the valid range ``[max(0, len - window),
len)`` in 32-key chunks through per-warp ``cp.async`` rings of bf16 (or
f32) K / V, every lane scoring one key, and combines its four warps'
softmax states in a fixed order; all G query heads share each read.  The
wrapper folds the softmax scale into q (in q's dtype, at the true head dim,
as the TPU wrapper does) and runs a head dim between the kernel's
instantiations (32, 64, 128; 256 for bf16) padded with zeros to the next
of them, as the TPU wrapper pads D to its 128 lanes
(:func:`flash_decode_padded`).

Every other dim runs an any-dims variant, a split-KV decode, which
:func:`route` / :func:`route_self` pick from the dims before the launch.
The single-token form past head dim 256 (f32: 128) or past G 16 or G * D
1024 runs ``csrc/decode_any.cu`` (``kernels/_any.py``): a block takes a KV
head's query heads against one split of 64 positions on the tensor cores,
a second kernel merges the splits in order: two launches a call.  The
self-slot form at a head dim outside SELF_HEAD_DIMS runs K1's any-dims
variant (``csrc/score_any.cu``, :func:`repro_torch.kernels.fused_score.ops.
score_any`) in ``cached`` mode over the unscaled cache, as its tiled
form runs K1's tiled kernel: a cluster of four CTAs for up to 64
candidates' rows, the splits merged on chip, each candidate's own key
last, one launch a call.  Each counts under the form's wrapper.  Their
plain twins are
:func:`flash_decode_any_plain` and
:func:`flash_decode_with_self_any_plain`.

With ``return_lse=True`` :func:`flash_decode` also returns each (row,
head)'s log-sum-exp [B, H] f32 (max + log sum of the scaled scores; -inf
for a row with no valid position), written by either kernel: a decode
over a cache whose positions are split across ranks runs K4 on each
rank's slice and merges the partial softmaxes with it
(``models/transformer.py::_split_cache_decode``).

Each wrapper launches its kernel on CUDA tensors (raising if the launch
fails — there is no fallback) and runs its plain PyTorch version
(:func:`flash_decode_with_self_plain`, :func:`flash_decode_plain`) on CPU
tensors.  ``flash_decode_with_self.launches`` and ``flash_decode.launches``
count kernel launches; :func:`plan` gives a launch's grid, block and shared
memory.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _any, _build
from repro_torch.kernels.fused_score.ops import (fused_score_any_plain,
                                                 per_pool_row, score_any)
from repro_torch.kernels.padding import pad_last, padded_dim

HEAD_DIMS = (32, 64, 128, 256)
F32_MAX_HEAD_DIM = 128
SELF_HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16          # query heads per KV head (and G * D <= 1024)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_SELF_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
_ANY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p])
_count_lock = _build.COUNT_LOCK
NEG_INF = -1e30


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2] \
            or q.shape[1] % k_cache.shape[2]:
        raise ValueError(f"want q [B,H,D], caches [B,S,Hkv,D] with H a "
                         f"multiple of Hkv; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be [B={q.shape[0]}], got "
                         f"{tuple(lengths.shape)}")


def _scaled(q):
    """Fold the softmax scale into q, in q's dtype (``ops.py:31-33`` of the
    TPU wrapper)."""
    return q * (1.0 / math.sqrt(q.shape[-1]))


def _softmax_parts(qf, k_cache, ok):
    """Masked scores of qf [B,Hkv,G,D] (scaled, f32) against k_cache
    [B,S,Hkv,D]: (weights exp(s - max), 0 where masked; log-sum-exp
    [B,Hkv,G], -inf for a row with no valid position)."""
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    mx = sc.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(sc - mx), torch.zeros_like(sc))
    return p, mx[..., 0] + torch.log(p.sum(dim=-1))


def flash_decode_plain(q, k_cache, v_cache, lengths, *, window: int = 0,
                       prescaled: bool = False, return_lse: bool = False):
    """The plain PyTorch version: the kernel's arithmetic on materialized
    scores.  q [B,H,D]; caches [B,S,Hkv,D]; lengths [B] -> [B,H,D] in q's
    dtype (and with ``return_lse`` the log-sum-exp [B,H] f32).  Masked
    positions add exact zeros after the exp; a row with ``lengths == 0``
    gives zeros, as the kernel's ``acc / max(l, 1e-30)``, and -inf.
    ``prescaled``: q already carries the softmax scale (as the kernel
    takes it)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = (q if prescaled else _scaled(q)).float().reshape(b, hkv, h // hkv,
                                                          d)
    ok = _decode_mask(lengths, s, window)[:, None, None, :]
    p, lse = _softmax_parts(qf, k_cache, ok)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = o.reshape(b, h, d).to(q.dtype)
    return (o, lse.reshape(b, h)) if return_lse else o


def route(d: int, g: int, dtype) -> str:
    """The single-token form's kernel for head dim ``d``, ``g`` query
    heads per KV head and ``dtype``: ``"tiled"`` (padded to an instantiated
    head dim) or ``"any"`` (the any-dims variant)."""
    limit = F32_MAX_HEAD_DIM if dtype == torch.float32 else max(HEAD_DIMS)
    if d > limit:
        return "any"
    dp = padded_dim(d, HEAD_DIMS)
    return "tiled" if g <= MAX_GROUP and g * dp <= 1024 else "any"


def route_self(d: int) -> str:
    """The self-slot form's kernel for head dim ``d``."""
    return "tiled" if d in SELF_HEAD_DIMS else "any"


def _decode_mask(lengths, s: int, window: int):
    lens = lengths.to(torch.int64)[:, None]
    pos = torch.arange(s, device=lengths.device)[None, :]
    ok = pos < lens
    if window:
        ok = ok & (pos >= lens - window)
    return ok


def flash_decode_any_plain(q, k_cache, v_cache, lengths, *, window: int = 0,
                           return_lse: bool = False):
    """The any-dims variant's plain twin for the single-token form: q
    scaled in its dtype as the wrapper does, then the variant's splits,
    per-split softmax (plain f32 products) and ordered merge in f32
    (:func:`repro_torch.kernels._any.split_parts`, :func:`repro_torch.
    kernels._any.merge_parts`).  Same arguments and result as
    :func:`flash_decode_plain` (the log-sum-exp from the whole row's
    scores)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = _scaled(q).float().reshape(b, hkv, h // hkv, d)
    ok = _decode_mask(lengths, s, window)[:, None, None, :]
    o = _any.merge_parts(_any.split_parts(qf, k_cache.transpose(1, 2),
                                          v_cache.transpose(1, 2), ok))
    o = o.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return o
    return o, _softmax_parts(qf, k_cache, ok)[1].reshape(b, h)


def flash_decode_padded(q, k_cache, v_cache, lengths, *, window: int = 0,
                        run=None, return_lse: bool = False):
    """``run`` (the kernel's launch; in the CPU tests the plain version on
    a pre-scaled q) at the instantiated head dim that holds D: q scaled at
    the unpadded D in q's dtype (the TPU wrapper's ``ops.py:31-33``), then
    q and the caches padded with zeros along D, the output sliced back
    (the zero columns add nothing to the scores, so the log-sum-exp is the
    unpadded one)."""
    d = q.shape[-1]
    dp = padded_dim(d, HEAD_DIMS)
    run = run or _launch
    kw = {"return_lse": True} if return_lse else {}
    o = run(pad_last(_scaled(q), dp), pad_last(k_cache, dp),
            pad_last(v_cache, dp), lengths, window=window, **kw)
    o, lse = o if return_lse else (o, None)
    o = o if dp == d else o[..., :d]
    return (o, lse) if return_lse else o


def _check_operands(q, k_cache, v_cache, lengths, window: int):
    _build.forbid_grad("flash_decode", q, k_cache, v_cache)
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes f32 or bf16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("flash_decode operands must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("the head axis must be contiguous (stride 1)")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 tensor, got "
                         f"{lengths.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k_cache, v_cache, lengths, *, window: int,
            return_lse: bool = False):
    """The kernel on a q that already carries the softmax scale."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype == torch.float32 and d > F32_MAX_HEAD_DIM:
        raise ValueError(f"f32 operands take head dims up to "
                         f"{F32_MAX_HEAD_DIM}, got {d}")
    if g > MAX_GROUP or g * d > 1024:
        raise ValueError(f"{g} query heads per KV head at head dim {d} "
                         f"exceed the kernel's block (G <= {MAX_GROUP}, "
                         f"G*D <= 1024)")
    _check_operands(q, k_cache, v_cache, lengths, window)
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(1))
    fn = _build.function("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], b,
             h, hkv, d, strides, int(window), _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_decode_fwd failed with CUDA error {err} "
                           f"(q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)})")
    with _count_lock:
        flash_decode.launches += 1
    return (o, lse) if return_lse else o


def _launch_any(q, k_cache, v_cache, lengths, *, window: int = 0,
                return_lse: bool = False):
    """The any-dims variant (``decode_any_fwd``: the split kernel and the
    merge) on q [B,H,D] that already carries the softmax scale."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    # the library sizes the workspace (and refuses one too small)
    floats = _any.decode_plan(_DTYPES[q.dtype], b, h, hkv, s,
                              d)["workspace_floats"]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if return_lse else None)
    ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    launched = ctypes.c_int(0)
    fn = _build.function("decode_any", "decode_any_fwd", _ANY_ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), ws.data_ptr(),
             ws.numel(), _DTYPES[q.dtype], b, h, hkv, s, d,
             _build.strides(q[:, None], k_cache, v_cache, o[:, None]),
             int(window), _build.stream_handle(q.device),
             ctypes.byref(launched))
    if err:
        raise RuntimeError(f"decode_any_fwd failed with CUDA error {err} "
                           f"(q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)})")
    with _count_lock:
        flash_decode.launches += launched.value
    return (o, lse) if return_lse else o


def flash_decode(q, k_cache, v_cache, lengths, *, window: int = 0,
                 return_lse: bool = False):
    """q [B,H,D] (one new token per row); caches [B,S,Hkv,D]; lengths [B]
    valid prefix per row.  Returns [B,H,D] (with ``return_lse`` and the
    log-sum-exp [B,H] f32).  :func:`route` picks the tiled kernel or the
    any-dims variant from the dims; the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors; anything else raises."""
    _check(q, k_cache, v_cache, lengths)
    tiled = route(q.shape[-1], q.shape[1] // k_cache.shape[2],
                  q.dtype) == "tiled"
    if q.is_cuda:
        if tiled:
            return flash_decode_padded(q, k_cache, v_cache, lengths,
                                       window=window, return_lse=return_lse)
        _check_operands(q, k_cache, v_cache, lengths, window)
        return _launch_any(_scaled(q), k_cache, v_cache, lengths,
                           window=window, return_lse=return_lse)
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        plain = flash_decode_plain if tiled else flash_decode_any_plain
        return plain(q, k_cache, v_cache, lengths, window=window,
                     return_lse=return_lse)
    raise ValueError("flash_decode runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in (
                         q, k_cache, v_cache, lengths)})))


flash_decode.launches = 0


# ---------------------------------------------------------------------------
# (a) the self-slot form: M candidates per row, each with its own key
# ---------------------------------------------------------------------------

def _check_self(q, k_cache, v_cache, lengths, k_self, v_self, row_index):
    rows = q.shape[0] if row_index is None else k_cache.shape[0]
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != rows \
            or k_cache.shape[3] != q.shape[3] \
            or q.shape[2] % k_cache.shape[2]:
        raise ValueError(f"want q [B,M,H,D], caches [B,S,Hkv,D] (or [U,...] "
                         f"with a [B,M] row_index) with H a multiple of "
                         f"Hkv; got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    want = (q.shape[0], q.shape[1], k_cache.shape[2], q.shape[3])
    if tuple(k_self.shape) != want or tuple(v_self.shape) != want:
        raise ValueError(f"k_self / v_self must be [B,M,Hkv,D] = {want}, got "
                         f"{tuple(k_self.shape)}, {tuple(v_self.shape)}")
    if tuple(lengths.shape) != (rows,):
        raise ValueError(f"lengths must be [{rows}], got "
                         f"{tuple(lengths.shape)}")
    if row_index is not None and tuple(row_index.shape) != tuple(q.shape[:2]):
        raise ValueError(f"row_index must be [B,M] = {tuple(q.shape[:2])}, "
                         f"got {tuple(row_index.shape)}")


def _self_attention(q, k_cache, v_cache, k_self, v_self, lengths=None):
    """K1's two-segment arithmetic in f32: the history (positions past
    ``lengths`` masked to exact zeros; all valid without it), then each
    candidate's own key."""
    b, m, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, m, hkv, h // hkv, d) / math.sqrt(d)
    s_hist = torch.einsum("bmhgd,bnhd->bhgmn", qf, k_cache.float())
    s_self = torch.einsum("bmhgd,bmhd->bhgm", qf, k_self.float())
    ok = None
    if lengths is not None:
        ok = (torch.arange(s, device=q.device)[None, :]
              < lengths.long()[:, None])[:, None, None, None]
        s_hist = torch.where(ok, s_hist, torch.full_like(s_hist, NEG_INF))
    mx = torch.maximum(s_hist.amax(dim=-1), s_self) if s else s_self
    p_hist = torch.exp(s_hist - mx[..., None])
    if ok is not None:
        p_hist = torch.where(ok, p_hist, torch.zeros_like(p_hist))
    p_self = torch.exp(s_self - mx)
    o = torch.einsum("bhgmn,bnhd->bmhgd", p_hist, v_cache.float()) \
        + p_self.permute(0, 3, 1, 2)[..., None] \
        * v_self.float()[:, :, :, None, :]
    l = (p_hist.sum(dim=-1) + p_self).permute(0, 3, 1, 2)      # [b,m,hkv,g]
    return (o / l[..., None]).reshape(b, m, h, d)


def flash_decode_with_self_any_plain(q, k_cache, v_cache, lengths, k_self,
                                     v_self, row_index=None):
    """The any-dims variant's plain twin for the self-slot form: K1's
    variant's twin in ``cached`` mode over the unscaled cache
    (:func:`repro_torch.kernels.fused_score.ops.fused_score_any_plain`:
    each candidate's row's valid prefix in splits, merged in order, then
    its own key).  Same arguments and result as
    :func:`flash_decode_with_self_plain`."""
    return fused_score_any_plain(q, k_cache, v_cache, k_self, v_self,
                                 mode="cached", row_index=row_index,
                                 lengths=lengths)


def flash_decode_with_self_plain(q, k_cache, v_cache, lengths, k_self,
                                 v_self, row_index=None):
    """The plain PyTorch version: K1's two-segment arithmetic (the history
    first, then each candidate's own key) in f32.  q/k_self/v_self
    [B,M,H(kv),D]; caches [B,S,Hkv,D]; lengths [B] -> [B,M,H,D] in q's
    dtype.  A row with ``lengths == 0`` sees its own key alone.  On CPU
    tensors each row is cut to its valid prefix, so that its output does
    not depend on how far the cache is padded; on CUDA tensors (the card's
    comparison and timing, where a host sync would break a CUDA-graph
    capture) the positions past it are masked instead.  With a [B, M]
    ``row_index`` the caches are [U,S,Hkv,D] with lengths [U], each
    candidate on its own row (:func:`per_pool_row`)."""
    if row_index is not None:
        return per_pool_row(lambda idx: flash_decode_with_self_plain(
            q, k_cache[idx.long()], v_cache[idx.long()],
            lengths[idx.long()], k_self, v_self), row_index,
            k_cache.shape[0])
    if q.is_cuda:
        out = _self_attention(q, k_cache, v_cache, k_self, v_self, lengths)
    else:
        s = k_cache.shape[1]
        out = torch.cat([_self_attention(
            q[i:i + 1], k_cache[i:i + 1, :min(max(n, 0), s)],
            v_cache[i:i + 1, :min(max(n, 0), s)], k_self[i:i + 1],
            v_self[i:i + 1]) for i, n in enumerate(lengths.tolist())])
    return out.to(q.dtype)


def _launch_self(q, k_cache, v_cache, lengths, k_self, v_self, row_index):
    _build.forbid_grad("flash_decode_with_self", q, k_cache, v_cache,
                       k_self, v_self)
    ops = (q, k_cache, v_cache, k_self, v_self)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"flash_decode_with_self takes f32 or bf16 operands "
                        f"of one dtype, got {[t.dtype for t in ops]}")
    b, m, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if any(t.device != q.device for t in ops + (lengths,)):
        raise ValueError("flash_decode_with_self operands must be on one "
                         "device")
    if any(t.stride(-1) != 1 for t in ops):
        raise ValueError("the head axis must be contiguous (stride 1)")
    for name, t in (("lengths", lengths), ("row_index", row_index)):
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if route_self(d) == "any":
        return score_any(q, k_cache, v_cache, k_self, v_self, "cached",
                         row_index=row_index, lengths=lengths,
                         counter=flash_decode_with_self)
    o = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
    strides = _build.strides(q, k_cache, v_cache, k_self, v_self, o)
    fn = _build.function("flash_decode", "flash_decode_self_fwd",
                         _SELF_ARGTYPES)
    # grid y = B * H: batch chunks of at most 65535 // H rows; without a
    # row index (batch row b on cache row b) the caches' rows and lengths
    # are cut with them
    own = row_index is None
    at = _build.row_ptr
    for b0, b1 in _build.batch_chunks(b, h):
        r0 = b0 if own else 0
        err = fn(at(q, b0), at(k_cache, r0), at(v_cache, r0),
                 at(lengths, r0), at(row_index, b0), at(k_self, b0),
                 at(v_self, b0), at(o, b0), _DTYPES[q.dtype], b1 - b0, m, h,
                 hkv, b1 - b0 if own else k_cache.shape[0], s, d, strides,
                 1.0 / math.sqrt(d), _build.stream_handle(q.device))
        if err:
            raise RuntimeError(f"flash_decode_self_fwd failed with CUDA "
                               f"error {err} (q {tuple(q.shape)}, cache "
                               f"{tuple(k_cache.shape)})")
        with _count_lock:
            flash_decode_with_self.launches += 1
    return o


def flash_decode_with_self(q, k_cache, v_cache, lengths, k_self, v_self, *,
                           row_index=None):
    """q/k_self/v_self [B,M,H(kv),D] (M candidates per row, each
    extending its row's cache at position ``lengths[b]``); caches
    [B,S,Hkv,D] with a valid prefix of ``lengths`` [B] per row.  Every
    candidate attends to that prefix plus itself.  Returns [B,M,H,D].
    ``row_index`` [B, M] (segment-packed decode): the caches are [U,...]
    with ``lengths`` [U], and candidate (b, m) extends row
    ``row_index[b, m]``.  :func:`route_self` picks the tiled kernel or the
    any-dims variant from D; the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors; anything else raises."""
    _check_self(q, k_cache, v_cache, lengths, k_self, v_self, row_index)
    ops = tuple(t for t in (q, k_cache, v_cache, lengths, k_self, v_self,
                            row_index) if t is not None)
    if q.is_cuda:
        return _launch_self(q, k_cache, v_cache, lengths, k_self, v_self,
                            row_index)
    if all(t.device.type == "cpu" for t in ops):
        plain = (flash_decode_with_self_plain if route_self(q.shape[-1])
                 == "tiled" else flash_decode_with_self_any_plain)
        return plain(q, k_cache, v_cache, lengths, k_self, v_self, row_index)
    raise ValueError("flash_decode_with_self runs on CUDA or CPU tensors, "
                     "got " + ", ".join(sorted({str(t.device) for t in ops})))


flash_decode_with_self.launches = 0


def plan(q, k_cache, *, self_slot: bool = True) -> dict:
    """The launch for ``q`` ([B,M,H,D] for the self-slot form, [B,H,D] for
    the single-token form) against a cache like ``k_cache``: grid, threads
    per block, shared bytes (dynamic, except the f32 self-slot form's static
    bytes), launches a call (the self-slot form one a batch chunk of at
    most 65535 // H rows); for the any-dims variants also rows a block,
    key splits, head-dim passes and the launches a call; the single-token
    form's merge grid and workspace bytes
    (:func:`repro_torch.kernels._any.decode_plan`), the self-slot form's
    cluster, CTAs and resident clusters (K1's variant,
    :func:`repro_torch.kernels._any.score_plan`).
    Reads the library; the CPU tests never call it."""
    b, s, hkv, d = q.shape[0], k_cache.shape[1], k_cache.shape[2], q.shape[-1]
    m, h = (q.shape[1], q.shape[2]) if self_slot else (1, q.shape[1])
    if self_slot and route_self(d) == "any":
        dt = _DTYPES[q.dtype]
        return _any.score_plan(dt, dt, 0, b, m, h, hkv, s, d)
    if not self_slot and route(d, h // hkv, q.dtype) == "any":
        return _any.decode_plan(_DTYPES[q.dtype], b, h, hkv, s, d)
    if not self_slot:
        d = padded_dim(d, HEAD_DIMS)
    out = (ctypes.c_int * 4)()
    fn = _build.function("flash_decode", "flash_decode_plan",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p])
    if fn(0 if self_slot else 1, _DTYPES[q.dtype], b, m, h, hkv, d, out):
        raise ValueError(f"no launch plan for q {tuple(q.shape)}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3],
                launches=len(_build.batch_chunks(b, h)) if self_slot else 1)
