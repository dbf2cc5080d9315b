"""Mask-aware GQA flash attention — kernel K2 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention_kernel`` (body ``_fa_kernel``) with the hand-written CUDA
kernel ``repro_torch/csrc/flash_attention.cu`` (``flash_attention_fwd``).
On the serving path it runs the causal history pass of every ``encode``
dispatch (``core/climber.py::_block_encode_kv``: SUMI with ``n_history ==
S``, which is causal), once per layer: 2 blocks x 12 layers = 24 launches
per dispatch at the published Climber width; under ``impl="pallas"`` also
every ``cached`` dispatch's attention (SUMI with ``q_offset``); and the
text engine's attention prefill (``models/transformer.py``, ``sliding`` on
a ``swa`` layer, ``causal`` on an ``attn`` layer), once per layer.

What bounds it on an H100: at the encode shapes (q/k/v [4, 257, 4, 64] bf16)
the function reads and writes about 1 MB and does about 0.27 GFLOP of
attention, well under a microsecond of memory or tensor-core time; what
sets the time is latency — the longest chain of dependent work in a block —
and the launch.  The bf16 kernel runs both products on the tensor cores
(``mma.sync``, one warp per 16 query rows, P as bf16 hi + lo so that rows
seeing few keys keep the bf16 tolerance), stages K and V as bf16 through a
two-stage ``cp.async`` ring, skips the mask's dead key ranges and masks
element-wise only in tiles on a mask edge, and lets 4 warps (64 query rows)
share each staged key tile.  Each row is finished by one warp in a
fixed key order, so two calls agree bitwise.  f32 operands take the scalar
kernel (one thread per row).

The kernel is instantiated for head dims 16, 32, 64, 128 and (bf16) 256;
:func:`flash_attention_padded` runs any other head dim up to 256 padded
with zeros to the next of them, with the softmax scale of the unpadded dim,
as the TPU wrapper pads D to its 128 lanes: the text models' 120
(h2o-danube-3-4b) runs at 128, 240 (gemma3-12b) at 256, whose kernel keeps
Q in shared memory.  Past 256 in bf16, and past 128 in f32, :func:`route`
picks the any-dims variant (``csrc/attention_any.cu``, ``kernels/_any.py``)
from the dims before the launch, so every head dim the JAX wrapper takes
runs; its plain twin is :func:`flash_attention_any_plain`.

:func:`flash_attention` is the wrapper.  On CUDA tensors it launches the
kernel (and raises if the launch fails — there is no fallback); on CPU
tensors it runs :func:`flash_attention_plain`, the plain PyTorch version of
the same computation.  ``flash_attention.launches`` counts kernel launches;
:func:`plan` gives the launch's grid, block and shared memory.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _any, _build
from repro_torch.kernels.padding import pad_last, padded_dim

MODES = {"full": 0, "causal": 1, "sliding": 2, "sumi": 3}
#: the kernel's instantiated head dims (256: bf16 only); any other D up to
#: 256 runs padded to the next of them (:func:`flash_attention_padded`)
HEAD_DIMS = (16, 32, 64, 128, 256)
F32_MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
_ANY_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])
_count_lock = _build.COUNT_LOCK
NEG_INF = -1e30


def _check(q, k, v, mode: str, q_offset: int):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if q_offset and mode not in ("sumi", "causal"):
        raise NotImplementedError(
            f"q_offset is only supported for mode in ('sumi', 'causal'), "
            f"got {mode!r}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"want q [B,Sq,H,D], k/v [B,Sk,Hkv,D] with H a "
                         f"multiple of Hkv; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_plain(q, k, v, mode: str = "causal", *, window: int = 0,
                          n_history: int = 0, q_offset: int = 0,
                          scale=None):
    """The plain PyTorch version: the kernel's arithmetic on materialized
    scores.  q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D] in q's dtype; f32
    math, masked keys add exact zeros after the exp, fully masked rows give
    zeros.  ``scale`` defaults to 1 / sqrt(D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.float().reshape(b, sq, hkv, g, d) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    ok = _visible(sq, sk, mode, window, n_history, q_offset, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros_like(p))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(dim=-1).clamp_min(1e-30).permute(0, 3, 1, 2)      # [b,q,h,g]
    return (o / l[..., None]).reshape(b, sq, h, d).to(q.dtype)


def route(d: int, dtype) -> str:
    """``"tiled"`` (the tensor-core / scalar kernel, padded to an
    instantiated head dim) or ``"any"`` (the any-dims variant), from the
    head dim and dtype alone."""
    limit = F32_MAX_HEAD_DIM if dtype == torch.float32 else max(HEAD_DIMS)
    return "tiled" if d <= limit else "any"


def _visible(sq: int, sk: int, mode: str, window: int, n_history: int,
             q_offset: int, device):
    a = torch.arange(sq, device=device)[:, None] + q_offset
    c = torch.arange(sk, device=device)[None, :]
    if mode == "full":
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    if mode == "causal":
        return c <= a
    if mode == "sliding":
        return (c <= a) & (a - c < window)
    return torch.where(a < n_history, c <= a, (c < n_history) | (c == a))


def flash_attention_any_plain(q, k, v, mode: str = "causal", *,
                              window: int = 0, n_history: int = 0,
                              q_offset: int = 0):
    """The any-dims variant's plain twin: its key tiles, online softmax
    and f32 accumulation (:func:`repro_torch.kernels._any.attention_tiled`)
    with q scaled by 1 / sqrt(D) in f32.  Same arguments and result as
    :func:`flash_attention_plain`."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        * (1.0 / math.sqrt(d))
    ok = _visible(sq, sk, mode, window, n_history, q_offset, q.device)
    o = _any.attention_tiled(qf, k.transpose(1, 2)[:, :, None],
                             v.transpose(1, 2)[:, :, None], ok)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_padded(q, k, v, mode: str = "causal", *,
                           window: int = 0, n_history: int = 0,
                           q_offset: int = 0, run=None):
    """``run`` (the kernel's launch; the plain version in the CPU tests) at
    the instantiated head dim that holds D: q, k and v padded with zeros
    along D, the softmax scale of the unpadded D (as the TPU wrapper
    pre-scales q before padding), the output sliced back to D."""
    d = q.shape[-1]
    dp = padded_dim(d, HEAD_DIMS)
    run = run or _launch
    o = run(pad_last(q, dp), pad_last(k, dp), pad_last(v, dp), mode,
            window=window, n_history=n_history, q_offset=q_offset,
            scale=1.0 / math.sqrt(d))
    return o if dp == d else o[..., :d]


def _checked_out(q, k, v):
    """The launch's checks of dtype, device and layout; the output."""
    _build.forbid_grad("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if min(t.stride(-1) for t in (q, k, v)) != 1 \
            or max(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("the head axis must be contiguous (stride 1)")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    return torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)


def _launch(q, k, v, mode: str, *, window: int, n_history: int,
            q_offset: int, scale: float):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype == torch.float32 and d > F32_MAX_HEAD_DIM:
        raise ValueError(f"f32 operands take head dims up to "
                         f"{F32_MAX_HEAD_DIM}, got {d}")
    o = _checked_out(q, k, v)
    if sq == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o)
        for s in (t.stride(0), t.stride(1), t.stride(2))])
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], b, h, hkv, sq, sk, d, strides, MODES[mode],
             int(window), int(n_history), int(q_offset), float(scale),
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention_fwd failed with CUDA error "
                           f"{err} (shapes q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    with _count_lock:
        flash_attention.launches += 1
    return o


def _launch_any(q, k, v, mode: str, *, window: int, n_history: int,
                q_offset: int):
    """The any-dims variant (``attention_any_k2_fwd``) at the true D."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = _checked_out(q, k, v)
    if sq == 0:
        return o
    tiles = -(-sq // _any.ROWS)
    ws = _any.workspace(tiles, b * h, d, q.device)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o)
        for s in (t.stride(0), t.stride(1), t.stride(2))])
    fn = _build.function("attention_any", "attention_any_k2_fwd",
                         _ANY_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if ws is None else ws.data_ptr(), _DTYPES[q.dtype], b, h,
             hkv, sq, sk, d, strides, MODES[mode], int(window),
             int(n_history), int(q_offset), 1.0 / math.sqrt(d),
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"attention_any_k2_fwd failed with CUDA error "
                           f"{err} (shapes q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    with _count_lock:
        flash_attention.launches += 1
    return o


def flash_attention(q, k, v, mode: str = "causal", *, window: int = 0,
                    n_history: int = 0, q_offset: int = 0):
    """Model-layout entry point: q [B,Sq,H,D]; k,v [B,Sk,Hkv,D] ->
    [B,Sq,H,D].  :func:`route` picks the kernel from D and the dtype: the
    tiled kernel (a head dim between the instantiated ones padded to the
    next of them) or the any-dims variant.  The CUDA kernel on CUDA
    tensors, its plain version on CPU tensors; anything else raises."""
    _check(q, k, v, mode, q_offset)
    kw = dict(window=window, n_history=n_history, q_offset=q_offset)
    tiled = route(q.shape[-1], q.dtype) == "tiled"
    if q.is_cuda:
        if tiled:
            return flash_attention_padded(q, k, v, mode, **kw)
        return _launch_any(q, k, v, mode, **kw)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        if tiled:
            return flash_attention_plain(q, k, v, mode, **kw)
        return flash_attention_any_plain(q, k, v, mode, **kw)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                     f"{q.device}, {k.device}, {v.device}")


flash_attention.launches = 0


def plan(q) -> dict:
    """The kernel's launch for a ``q`` [B,Sq,H,D] of this shape and dtype:
    grid, threads per block, static shared bytes (dynamic for the any-dims
    variant; reads the library; the CPU tests never call it)."""
    b, sq, h, d = q.shape
    if route(d, q.dtype) == "any":
        return _any.plan(-(-sq // _any.ROWS), b * h, d)
    d = padded_dim(d, HEAD_DIMS)
    out = (ctypes.c_int * 4)()
    fn = _build.function("flash_attention", "flash_attention_plan",
                         [ctypes.c_int] * 5 + [ctypes.c_void_p])
    if fn(_DTYPES[q.dtype], b, h, sq, d, out):
        raise ValueError(f"no launch plan for q {tuple(q.shape)}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3])


def flash_attention_bhsd(q, k, v, mode: str = "causal", **kw):
    """Kernel-layout entry point: q [B,H,Sq,D]; k,v [B,Hkv,Sk,D] (the JAX
    ``flash_attention_bhsd`` layout; transposed views, no copies)."""
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), mode, **kw).transpose(1, 2)
