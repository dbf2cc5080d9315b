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

Every other dim runs the any-dims variant (``csrc/attention_any.cu``,
``kernels/_any.py``), which :func:`route` / :func:`route_self` pick from the
dims before the launch: the single-token form past head dim 256 (f32: 128)
or past G 16 or G * D 1024, the self-slot form at a head dim outside
SELF_HEAD_DIMS.  Its launches count under the form's wrapper; its plain
twins are :func:`flash_decode_any_plain` and
:func:`flash_decode_with_self_any_plain`.

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
from repro_torch.kernels.fused_score.ops import per_pool_row
from repro_torch.kernels.padding import pad_last, padded_dim

HEAD_DIMS = (32, 64, 128, 256)
F32_MAX_HEAD_DIM = 128
SELF_HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16          # query heads per KV head (and G * D <= 1024)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_SELF_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
_ANY_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
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


def flash_decode_plain(q, k_cache, v_cache, lengths, *, window: int = 0,
                       prescaled: bool = False):
    """The plain PyTorch version: the kernel's arithmetic on materialized
    scores.  q [B,H,D]; caches [B,S,Hkv,D]; lengths [B] -> [B,H,D] in q's
    dtype.  Masked positions add exact zeros after the exp; a row with
    ``lengths == 0`` gives zeros, as the kernel's ``acc / max(l, 1e-30)``.
    ``prescaled``: q already carries the softmax scale (as the kernel
    takes it)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = (q if prescaled else _scaled(q)).float().reshape(b, hkv, h // hkv,
                                                          d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    ok = _decode_mask(lengths, s, window)[:, None, None, :]
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros_like(p))
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, d).to(q.dtype)


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


def flash_decode_any_plain(q, k_cache, v_cache, lengths, *, window: int = 0):
    """The any-dims variant's plain twin for the single-token form: q
    scaled in its dtype as the wrapper does, then the variant's key tiles
    and online softmax in f32 (:func:`repro_torch.kernels._any.
    attention_tiled`).  Same arguments and result as
    :func:`flash_decode_plain`."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = _scaled(q).float().reshape(b, hkv, h // hkv, d)
    ok = _decode_mask(lengths, s, window)[:, None, None, :]
    o = _any.attention_tiled(qf, k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), ok)
    return o.reshape(b, h, d).to(q.dtype)


def flash_decode_padded(q, k_cache, v_cache, lengths, *, window: int = 0,
                        run=None):
    """``run`` (the kernel's launch; in the CPU tests the plain version on
    a pre-scaled q) at the instantiated head dim that holds D: q scaled at
    the unpadded D in q's dtype (the TPU wrapper's ``ops.py:31-33``), then
    q and the caches padded with zeros along D, the output sliced back."""
    d = q.shape[-1]
    dp = padded_dim(d, HEAD_DIMS)
    run = run or _launch
    o = run(pad_last(_scaled(q), dp), pad_last(k_cache, dp),
            pad_last(v_cache, dp), lengths, window=window)
    return o if dp == d else o[..., :d]


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


def _launch(q, k_cache, v_cache, lengths, *, window: int):
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
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(1))
    fn = _build.function("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], b, h, hkv,
             d, strides, int(window), _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_decode_fwd failed with CUDA error {err} "
                           f"(q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)})")
    with _count_lock:
        flash_decode.launches += 1
    return o


def _launch_any(q, k_cache, v_cache, lengths, k_self=None, v_self=None,
                row_index=None, *, window: int = 0):
    """The any-dims variant (``attention_any_decode_fwd``): the
    single-token form on q [B,H,D] (already scaled: ``scale`` 1), or with
    ``k_self`` / ``v_self`` the self-slot form on q [B,M,H,D] (scaled by
    1 / sqrt(D) in f32, as the tiled self-slot kernel does)."""
    self_slot = k_self is not None
    if self_slot:
        b, m, h, d = q.shape
    else:
        (b, h, d), m = q.shape, 1
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    tiles, groups = -(-(h // hkv) // _any.ROWS), b * m * hkv
    if groups > 65535:
        raise ValueError(f"{groups} (row, KV head) pairs exceed the "
                         f"kernel's grid")
    ws = _any.workspace(tiles, groups, d, q.device)
    q4, o4 = (q, o) if self_slot else (q[:, None], o[:, None])
    ks4, vs4 = (k_self, v_self) if self_slot else (k_cache, v_cache)
    strides = (ctypes.c_longlong * 18)(*[
        st for t in (q4, k_cache, v_cache, ks4, vs4, o4)
        for st in (t.stride(0), t.stride(1), t.stride(2))])
    fn = _build.function("attention_any", "attention_any_decode_fwd",
                         _ANY_ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(),
             None if row_index is None else row_index.data_ptr(),
             k_self.data_ptr() if self_slot else None,
             v_self.data_ptr() if self_slot else None, o.data_ptr(),
             None if ws is None else ws.data_ptr(), _DTYPES[q.dtype], b, m,
             h, hkv, s, d, strides, int(window),
             1.0 / math.sqrt(d) if self_slot else 1.0,
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"attention_any_decode_fwd failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)})")
    counter = flash_decode_with_self if self_slot else flash_decode
    with _count_lock:
        counter.launches += 1
    return o


def flash_decode(q, k_cache, v_cache, lengths, *, window: int = 0):
    """q [B,H,D] (one new token per row); caches [B,S,Hkv,D]; lengths [B]
    valid prefix per row.  Returns [B,H,D].  :func:`route` picks the tiled
    kernel or the any-dims variant from the dims; the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors; anything else raises."""
    _check(q, k_cache, v_cache, lengths)
    tiled = route(q.shape[-1], q.shape[1] // k_cache.shape[2],
                  q.dtype) == "tiled"
    if q.is_cuda:
        if tiled:
            return flash_decode_padded(q, k_cache, v_cache, lengths,
                                       window=window)
        _check_operands(q, k_cache, v_cache, lengths, window)
        return _launch_any(_scaled(q), k_cache, v_cache, lengths,
                           window=window)
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        plain = flash_decode_plain if tiled else flash_decode_any_plain
        return plain(q, k_cache, v_cache, lengths, window=window)
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
    """The any-dims variant's plain twin for the self-slot form: each
    candidate's keys are its row's valid prefix then its own key, run
    through the variant's key tiles and online softmax in f32
    (:func:`repro_torch.kernels._any.attention_tiled`).  Same arguments
    and result as :func:`flash_decode_with_self_plain`."""
    b, m, h, d = q.shape
    hkv = k_cache.shape[2]
    rows = (torch.arange(b, device=q.device)[:, None].expand(b, m)
            if row_index is None else row_index.long())
    kc, vc = k_cache[rows], v_cache[rows]          # [b, m, s, hkv, d]
    k = torch.cat([kc, k_self[:, :, None]], 2).permute(0, 1, 3, 2, 4)
    v = torch.cat([vc, v_self[:, :, None]], 2).permute(0, 1, 3, 2, 4)
    s = k_cache.shape[1]
    ok = torch.cat([torch.arange(s, device=q.device)
                    < lengths.long()[rows][..., None],
                    torch.ones((b, m, 1), dtype=torch.bool,
                               device=q.device)], -1)   # [b, m, s + 1]
    qf = q.float().reshape(b, m, hkv, h // hkv, d) / math.sqrt(d)
    o = _any.attention_tiled(qf, k, v, ok[:, :, None, None])
    return o.reshape(b, m, h, d).to(q.dtype)


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
        return _launch_any(q, k_cache, v_cache, lengths, k_self, v_self,
                           row_index)
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    o = torch.empty((b, m, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 18)(*[
        st for t in (q, k_cache, v_cache, k_self, v_self, o)
        for st in (t.stride(0), t.stride(1), t.stride(2))])
    fn = _build.function("flash_decode", "flash_decode_self_fwd",
                         _SELF_ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), None if row_index is None
             else row_index.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
             o.data_ptr(), _DTYPES[q.dtype], b, m, h, hkv, k_cache.shape[0],
             s, d, strides, 1.0 / math.sqrt(d),
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_decode_self_fwd failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, cache "
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
    bytes).  Reads the library; the CPU tests never call it."""
    b, hkv, d = q.shape[0], k_cache.shape[2], q.shape[-1]
    m, h = (q.shape[1], q.shape[2]) if self_slot else (1, q.shape[1])
    if (route_self(d) if self_slot else route(d, h // hkv, q.dtype)) \
            == "any":
        return _any.plan(-(-(h // hkv) // _any.ROWS), b * m * hkv, d)
    if not self_slot:
        d = padded_dim(d, HEAD_DIMS)
    out = (ctypes.c_int * 4)()
    fn = _build.function("flash_decode", "flash_decode_plan",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p])
    if fn(0 if self_slot else 1, _DTYPES[q.dtype], b, m, h, hkv, d, out):
        raise ValueError(f"no launch plan for q {tuple(q.shape)}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3])
