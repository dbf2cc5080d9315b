"""Single-token GQA decode attention — kernel K4 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode/kernel.py::
flash_decode_kernel`` (body ``_fd_kernel``) with the hand-written CUDA
kernel ``repro_torch/csrc/flash_decode.cu`` (``flash_decode_fwd``).  On the
serving path it scores every generative ``decode`` and ``append`` dispatch
under ``impl="pallas"`` (``core/sumi.py::_kernel_decode_attention``), once
per layer: 2 blocks x 12 layers = 24 launches per dispatch at the published
Climber width.

What bounds it on an H100: decode attention reads each valid cache element
once and does two FLOPs per element and query head, so it is bytes-bound;
the least time is the valid K/V bytes over 3.35 TB/s.  The design follows
that: one block per (row, KV head) walks only the valid range ``[max(0, len
- window), len)`` and serves all G query heads of its KV head from one read
of each K/V tile, so traffic follows the valid prefix, not the cache
allocation.

:func:`flash_decode` is the wrapper: it folds the softmax scale into q (in
q's dtype, at the true head dim, as the TPU wrapper does; the TPU wrapper's
lane padding of D to 128 is not needed here — the kernel takes element
strides), then launches the kernel on CUDA tensors (raising if the launch
fails — there is no fallback) or runs :func:`flash_decode_plain`, the plain
PyTorch version, on CPU tensors.  ``flash_decode.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16          # query heads per KV head (and G * D <= 1024)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_count_lock = threading.Lock()
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


def flash_decode_plain(q, k_cache, v_cache, lengths, *, window: int = 0):
    """The plain PyTorch version: the kernel's arithmetic on materialized
    scores.  q [B,H,D]; caches [B,S,Hkv,D]; lengths [B] -> [B,H,D] in q's
    dtype.  Masked positions add exact zeros after the exp; a row with
    ``lengths == 0`` gives zeros, as the kernel's ``acc / max(l, 1e-30)``."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qf = _scaled(q).float().reshape(b, hkv, h // hkv, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    lens = lengths.to(torch.int64)[:, None]
    pos = torch.arange(s, device=q.device)[None, :]
    ok = pos < lens
    if window:
        ok = ok & (pos >= lens - window)
    ok = ok[:, None, None, :]
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros_like(p))
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, d).to(q.dtype)


def _launch(q, k_cache, v_cache, lengths, window: int):
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes f32 or bf16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if g > MAX_GROUP or g * d > 1024:
        raise ValueError(f"{g} query heads per KV head at head dim {d} "
                         f"exceed the kernel's block (G <= {MAX_GROUP}, "
                         f"G*D <= 1024)")
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("flash_decode operands must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("the head axis must be contiguous (stride 1)")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 tensor, got "
                         f"{lengths.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q = _scaled(q)
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


def flash_decode(q, k_cache, v_cache, lengths, *, window: int = 0):
    """q [B,H,D] (one new token per row); caches [B,S,Hkv,D]; lengths [B]
    valid prefix per row.  Returns [B,H,D].  The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors; anything else raises."""
    _check(q, k_cache, v_cache, lengths)
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, lengths, window)
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, lengths)):
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window)
    raise ValueError("flash_decode runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in (
                         q, k_cache, v_cache, lengths)})))


flash_decode.launches = 0
