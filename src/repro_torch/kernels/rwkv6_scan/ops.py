"""Chunked RWKV-6 wkv scan — kernel K5 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan/kernel.py::
rwkv6_scan_kernel`` (body ``_wkv_kernel``) with the hand-written CUDA
kernel ``repro_torch/csrc/rwkv6_scan.cu`` (``rwkv6_scan_fwd``).  On the
serving path it runs the time-mix of every prefill of the text engine
(``models/rwkv6.py::wkv_chunked``), once per layer: 32 launches per prefill
call at rwkv6-7b.

It computes, per (row, head), the data-dependent-decay linear attention

    S_t = diag(exp(w_log_t)) S_{t-1} + k_t v_t^T
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t

in chunks: the intra-chunk term from pairwise log-space decays
``exp(la_prev[t] - la[s])`` (each exponent <= 0), the inter-chunk term from
the [D, D] state carried from chunk to chunk.  The pairwise form is what
keeps it finite: ``w_log`` reaches -20 per step on the model's path, so a
chunk's cumulative decay reaches -1280, where the factored form
``(r e^{la_prev}) . (k e^{-la})`` is 0 x inf.

What bounds it on an H100: the c(c-1)/2 x D exponentials and the f32
products per chunk and head (no tensor cores), against reading r / k / v /
w_log once and writing o and the state once.  At the path's shapes
(``[4, 500, 64, 64]``, bf16 r / k / v, f32 w_log) the f32 operations
(~3.8 GFLOP over 67 TFLOP/s) outweigh the ~107 MB (over 3.35 TB/s);
``chip_smoke.py`` computes both from its inputs.  The design: one block
per (row, head) walks the chunks in order with the state in shared memory,
so the state never leaves the SM between chunks and every input is read
once; see the CUDA source.

:func:`rwkv6_scan` is the wrapper: on CUDA tensors it launches the kernel
(raising if the launch fails — there is no fallback), on CPU tensors it
runs :func:`rwkv6_scan_plain`, the chunked formulation of
``repro/models/rwkv6.py::wkv_chunked`` written in PyTorch.  The kernel
always uses chunks of 64 steps and masks the ragged last chunk; the plain
version uses ``min(chunk, S)`` and pads, as the JAX package does — the same
function up to rounding.  ``rwkv6_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

CHUNK = 64
HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_void_p])
_count_lock = threading.Lock()


def _check(r, k, v, w_log, u, state):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w_log)):
        raise ValueError(f"want r, k, v, w_log [B,S,H,D] of one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w_log)]}")
    b, s, h, d = r.shape
    if s == 0:
        raise ValueError("rwkv6_scan needs at least one step")
    if tuple(u.shape) != (h, d):
        raise ValueError(f"u must be [H={h}, D={d}], got {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"state must be [B,H,D,D] = {(b, h, d, d)}, got "
                         f"{tuple(state.shape)}")


def rwkv6_scan_plain(r, k, v, w_log, u, state=None, *, chunk: int = CHUNK):
    """The plain PyTorch version: ``wkv_chunked`` of the JAX model, chunk by
    chunk.  r,k,v,w_log [B,S,H,D]; u [H,D]; state [B,H,D,D] or None ->
    (o [B,S,H,D] in r's dtype, final state [B,H,D,D] f32)."""
    b, s, h, d = r.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:  # log w = 0 (no decay) and zero r / k / v on the padded steps
        r, k, v, w_log = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, w_log))
    rf, kf, vf, wl = (a.float().reshape(b, n, chunk, h, d)
                      for a in (r, k, v, w_log))
    uf = u.float()
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), -1)[None, :, :, None, None]
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rf[:, i], kf[:, i], vf[:, i], wl[:, i]
        la = torch.cumsum(wc, dim=1)       # inclusive cumulative log decay
        la_prev = la - wc                  # exclusive (through t-1)
        o_inter = torch.einsum("bthd,bhde->bthe", rc * torch.exp(la_prev), S)
        diff = la_prev[:, :, None] - la[:, None]           # [b,t,s,h,d]
        dec = torch.where(tri, torch.exp(diff),
                          torch.zeros((), device=r.device))
        scores = (rc[:, :, None] * kc[:, None] * dec).sum(-1)   # [b,t,s,h]
        o_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        o_bonus = (rc * uf * kc).sum(-1, keepdim=True) * vc
        la_c = la[:, -1:]
        k_dec = kc * torch.exp(la_c - la)
        S = torch.exp(la_c[:, 0])[..., None] * S + torch.einsum(
            "bshd,bshe->bhde", k_dec, vc)
        outs.append(o_inter + o_intra + o_bonus)
    o = torch.cat(outs, 1)[:, :s]
    return o.to(r.dtype), S


def _launch(r, k, v, w_log, u, state):
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan kernel takes f32 or bf16 r, k, v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in {HEAD_DIMS}")
    w_log = w_log.float()
    u = u.float().contiguous()
    if state is not None:
        state = state.float().contiguous()
    ops = (r, k, v, w_log, u) + ((state,) if state is not None else ())
    if any(t.device != r.device for t in ops):
        raise ValueError("rwkv6_scan operands must be on one device")
    if any(t.stride(-1) != 1 for t in (r, k, v, w_log)):
        raise ValueError("the head-size axis must be contiguous (stride 1)")
    o = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(*[
        st for t in (r, k, v, w_log, o) for st in t.stride()[:3]])
    fn = _build.function("rwkv6_scan", "rwkv6_scan_fwd", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
             u.data_ptr(), state.data_ptr() if state is not None else None,
             o.data_ptr(), sf.data_ptr(), _DTYPES[r.dtype], b, s, h, d,
             strides, _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"rwkv6_scan_fwd failed with CUDA error {err} "
                           f"(r {tuple(r.shape)} {r.dtype})")
    with _count_lock:
        rwkv6_scan.launches += 1
    return o, sf


def rwkv6_scan(r, k, v, w_log, u, state=None, *, chunk: int = CHUNK):
    """r,k,v,w_log [B,S,H,D] (w_log = log decay <= 0); u [H,D]; state
    [B,H,D,D] (None: zeros).  Returns (o [B,S,H,D] in r's dtype, final state
    [B,H,D,D] f32).  The CUDA kernel on CUDA tensors (chunks of 64), the
    plain version on CPU tensors (chunks of ``min(chunk, S)``); anything
    else raises."""
    _check(r, k, v, w_log, u, state)
    ops = (r, k, v, w_log, u) + ((state,) if state is not None else ())
    if r.is_cuda:
        return _launch(r, k, v, w_log, u, state)
    if all(t.device.type == "cpu" for t in ops):
        return rwkv6_scan_plain(r, k, v, w_log, u, state, chunk=chunk)
    raise ValueError("rwkv6_scan runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in ops})))


rwkv6_scan.launches = 0
