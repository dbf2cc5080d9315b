"""Fused (RMSNorm +) FFN — kernel K3 of the port.

Replaces the Pallas TPU kernel ``repro/kernels/fused_ffn/kernel.py::
fused_ffn_kernel`` (body ``_ffn_kernel``) with the hand-written CUDA kernel
``repro_torch/csrc/fused_ffn.cu`` (``fused_ffn_fwd``).  On the serving path
it computes the FFN of every layer of every executor family under
``impl="pallas"`` (``models/ffn.py::ffn_apply``): 2 blocks x 12 layers = 24
launches per dispatch at the published Climber width.  Climber normalizes
with LayerNorm before the call, so there it runs with ``has_norm`` off and
gelu, as in the JAX package.

What bounds it on an H100: at the Climber shapes (d 256, d_ff 1024) the
function does 4·T·d·d_ff FLOPs on about 1 MB of weights — at T = 1028 (an
``encode`` dispatch) 1.08 GFLOP on about 2 MB, so it is bound by
operations (about 1.1 µs at 989 TFLOP/s bf16).  The design keeps the
[T, d_ff] hidden out of device memory.  For bf16 it splits d_ff over the
CTAs of a thread-block cluster (up to 4, fixed by d_ff alone), so that each
CTA reads its slice of the weights once per m tile of 64 rows and small T
still spreads over several SMs; runs both products with ``wgmma`` (two
warpgroups; the f32 hidden as bf16 hi + lo) on weight tiles that TMA brings
into shared memory two slots deep; and sums the CTAs' f32 partial products
through distributed shared memory in rank order: no atomics, and a row's
output is bitwise the same whatever T and whichever rows share its tile.
f32 operands run scalar FMAs.

:func:`fused_ffn_2d` is the wrapper: the CUDA kernel on CUDA tensors
(raising if the launch fails — there is no fallback), :func:`fused_ffn_plain`
on CPU tensors.  ``fused_ffn_2d.launches`` counts kernel launches;
:func:`plan` gives the launch's grid, cluster, rows per CTA, shared
memory and weight slots.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

ACTIVATIONS = {"gelu": 0, "relu": 1, "swiglu": 2}
MODEL_DIMS = (64, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_count_lock = _build.COUNT_LOCK
EPS = 1e-6


def fused_ffn_plain(x, w_up, w_down, w_gate=None, norm_scale=None, *,
                    activation: str = "swiglu"):
    """The plain PyTorch version: the kernel's arithmetic in f32.  x [T,d];
    w_up / w_gate [d,f]; w_down [f,d]; norm_scale [d] or None -> [T,d] in
    x's dtype (rounded once)."""
    h = x.float()
    if norm_scale is not None:
        var = torch.mean(h * h, dim=-1, keepdim=True)
        h = h * torch.rsqrt(var + EPS) * (1.0 + norm_scale.float())
    up = h @ w_up.float()
    if activation == "swiglu":
        a = F.silu(h @ w_gate.float()) * up
    elif activation == "gelu":
        a = F.gelu(up, approximate="tanh")
    else:
        a = F.relu(up)
    return (a @ w_down.float()).to(x.dtype)


def _check(x, w_up, w_down, w_gate, norm_scale, activation: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be [T, d], got {tuple(x.shape)}")
    t, d = x.shape
    f = w_up.shape[1]
    if tuple(w_up.shape) != (d, f) or tuple(w_down.shape) != (f, d):
        raise ValueError(f"want w_up [d, f], w_down [f, d] for d={d}; got "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if (activation == "swiglu") != (w_gate is not None):
        raise ValueError("w_gate is required for swiglu and only for it")
    if w_gate is not None and tuple(w_gate.shape) != (d, f):
        raise ValueError(f"w_gate must be [d, f], got {tuple(w_gate.shape)}")
    if norm_scale is not None and tuple(norm_scale.shape) != (d,):
        raise ValueError(f"norm_scale must be [d], got "
                         f"{tuple(norm_scale.shape)}")


def _launch(x, w_up, w_down, w_gate, norm_scale, activation: str):
    ops = [t for t in (x, w_up, w_down, w_gate, norm_scale) if t is not None]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"fused_ffn kernel takes f32 or bf16 operands of one "
                        f"dtype, got {sorted({str(t.dtype) for t in ops})}")
    t, d = x.shape
    if d not in MODEL_DIMS:
        raise ValueError(f"model dim {d} not in {MODEL_DIMS}")
    if any(o.device != x.device for o in ops):
        raise ValueError("fused_ffn operands must be on one device")
    if not all(o.is_contiguous() for o in ops):
        raise ValueError("fused_ffn operands must be contiguous (row-major)")
    out = torch.empty_like(x)
    if t == 0:
        return out
    fn = _build.function("fused_ffn", "fused_ffn_fwd", _ARGTYPES)
    err = fn(x.data_ptr(),
             None if norm_scale is None else norm_scale.data_ptr(),
             w_up.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
             w_down.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], t, d,
             w_up.shape[1], ACTIVATIONS[activation],
             int(norm_scale is not None), _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"fused_ffn_fwd failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, d_ff {w_up.shape[1]})")
    with _count_lock:
        fused_ffn_2d.launches += 1
    return out


def fused_ffn_2d(x, w_up, w_down, w_gate=None, norm_scale=None, *,
                 activation: str = "swiglu"):
    """x [T,d] -> [T,d] fused (norm +) FFN.  The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors; anything else raises."""
    _check(x, w_up, w_down, w_gate, norm_scale, activation)
    if x.is_cuda:
        return _launch(x, w_up, w_down, w_gate, norm_scale, activation)
    ops = [t for t in (x, w_up, w_down, w_gate, norm_scale) if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        return fused_ffn_plain(x, w_up, w_down, w_gate, norm_scale,
                               activation=activation)
    raise ValueError("fused_ffn runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in ops})))


fused_ffn_2d.launches = 0


def plan(x, w_up, *, activation: str = "gelu",
         has_norm: bool = False) -> dict:
    """The kernel's launch for ``x`` [T,d] and ``w_up`` [d,f] shaped and
    typed like these: grid, CTAs per cluster, threads, rows per CTA,
    dynamic shared bytes and weight slots of the ring (reads the library;
    the CPU tests never call it)."""
    t, d = x.shape
    out = (ctypes.c_int * 6)()
    fn = _build.function("fused_ffn", "fused_ffn_plan",
                         [ctypes.c_int] * 6 + [ctypes.c_void_p])
    if fn(_DTYPES[x.dtype], t, d, w_up.shape[1], ACTIVATIONS[activation],
          int(has_norm), out):
        raise ValueError(f"no launch plan for x {tuple(x.shape)}")
    return dict(grid=out[0], cluster=out[1], threads=out[2], rows=out[3],
                smem_bytes=out[4], slots=out[5])


def fused_ffn(x, params, *, activation: str = "swiglu", norm_scale=None):
    """Model entry: x [...,d] with params {w_up, w_down[, w_gate]}."""
    shape = x.shape
    out = fused_ffn_2d(x.reshape(-1, shape[-1]), params["w_up"],
                       params["w_down"], params.get("w_gate"), norm_scale,
                       activation=activation)
    return out.reshape(shape)
