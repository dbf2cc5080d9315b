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

Other model widths (the text models' d 3840; any d and d_ff that are
multiples of 8) run the wide form, ``csrc/ffn_wide.cuh``
(``fused_ffn_wide_fwd``): d tiled on both products with ``mma.sync``, d_ff
cut into slices of at most 512 columns (:func:`wide_plan`) whose f32
partial products go to a workspace and are summed in slice order by a
second kernel.  Rows run WIDE_ROWS at a launch, so the workspace holds
at most ``ceil(d_ff / slice) x WIDE_ROWS x d`` floats whatever T (944 MB
at gemma3-12b's d 3840, d_ff 15360; 922 MB at T 2000).  The slices
follow T, so a row is bitwise reproducible at a given shape but not
across T — no invariant of the text engine asks for that (its gate is
greedy == repeated prefill).

:func:`fused_ffn_2d` is the wrapper: the CUDA kernel on CUDA tensors
(raising if the launch fails — there is no fallback), :func:`fused_ffn_plain`
on CPU tensors.  ``fused_ffn_2d.launches`` counts kernel launches: one a call
of the cluster kernel, two (the kernel and its reduction) for each launch of
at most WIDE_ROWS rows of the wide form (:func:`kernel_launches`);
:func:`plan` gives the launch's grid, cluster, rows per CTA, shared memory
and weight slots.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

ACTIVATIONS = {"gelu": 0, "relu": 1, "swiglu": 2}
#: the model dims of the cluster kernel (the only ones for f32 operands);
#: bf16 operands at any other d run the wide form
MODEL_DIMS = (64, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])
WIDE_SLICE = 128        # the wide form's d_ff slices are multiples of it
WIDE_MAX_SLICE = 512    # the hidden [64, 512] as bf16 hi + lo fills shared
WIDE_SMALL_T = 16       # up to this many rows: 16-row CTAs, 128-column slices
WIDE_ROWS = 2048        # rows a launch of the wide form
SMS = 132               # an H100 SXM's SMs
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


def wide_plan(t: int, f: int):
    """(rows per CTA, d_ff slice width) of the wide form for one launch of
    ``t`` rows (at most WIDE_ROWS) and d_ff = ``f``.

    At t <= 16: 16-row CTAs over slices of 128 columns, so that a layer's
    weights stream over about f / 128 CTAs.  Past that: 64-row CTAs over
    slices as wide as two waves of the SMS SMs allow (m tiles x slices
    near 2 x SMS), within 128 .. 512 columns; from 9 m tiles (t > 512) on
    that is 512, and the grid runs more waves (gemma3-12b's d_ff 15360 at
    t 2000: 32 m tiles x 30 slices, 960 CTAs)."""
    if t <= WIDE_SMALL_T:
        return 16, WIDE_SLICE
    want = -(-2 * SMS // -(-t // 64))  # slices for two waves of m tiles
    per = -(-f // want)                # d_ff columns a slice
    fs = -(-per // WIDE_SLICE) * WIDE_SLICE
    return 64, max(WIDE_SLICE, min(WIDE_MAX_SLICE, fs))


def kernel_launches(t: int, d: int) -> int:
    """Kernels one :func:`fused_ffn_2d` call of ``t`` rows at model dim
    ``d`` launches on the card (what it adds to ``fused_ffn_2d.launches``):
    one for the cluster kernel (d 64 / 256), two per WIDE_ROWS rows for the
    wide form."""
    if t == 0:
        return 0
    return 1 if d in MODEL_DIMS else 2 * -(-t // WIDE_ROWS)


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
    f = w_up.shape[1]
    wide = d not in MODEL_DIMS
    if wide and x.dtype != torch.bfloat16:
        raise ValueError(f"f32 operands take model dims {MODEL_DIMS}, got "
                         f"{d} (the wide form is bf16)")
    if wide and (d % 8 or f % 8):
        raise ValueError(f"the wide form takes d and d_ff that are "
                         f"multiples of 8 (16-byte rows), got {d}, {f}")
    if any(o.device != x.device for o in ops):
        raise ValueError("fused_ffn operands must be on one device")
    if not all(o.is_contiguous() for o in ops):
        raise ValueError("fused_ffn operands must be contiguous (row-major)")
    out = torch.empty_like(x)
    if t == 0:
        return out
    if wide:
        fn = _build.function("fused_ffn", "fused_ffn_wide_fwd",
                             _WIDE_ARGTYPES)
        chunks = [(r0, min(WIDE_ROWS, t - r0))
                  for r0 in range(0, t, WIDE_ROWS)]
        plans = [wide_plan(n, f) for _, n in chunks]
        # one workspace for every launch: a partial [n, d] per slice
        ws = torch.empty(max(-(-f // fs) * n for (_, n), (_, fs)
                             in zip(chunks, plans)) * d,
                         dtype=torch.float32, device=x.device)
        for (r0, n), (bm, fs) in zip(chunks, plans):
            err = fn(x[r0:].data_ptr(),
                     None if norm_scale is None else norm_scale.data_ptr(),
                     w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), out[r0:].data_ptr(), ws.data_ptr(),
                     n, d, f, ACTIVATIONS[activation],
                     int(norm_scale is not None), bm, fs,
                     _build.stream_handle(x.device))
            if err:
                raise RuntimeError(f"fused_ffn_wide_fwd failed with CUDA "
                                   f"error {err} (x {tuple(x.shape)}, rows "
                                   f"{r0}..{r0 + n}, d_ff {f})")
            with _count_lock:
                fused_ffn_2d.launches += 2
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
    dynamic shared bytes and weight slots of the ring; for the wide form
    (of its first launch, of at most WIDE_ROWS rows) the slice width and
    the workspace bytes, and the kernels a call launches (reads the
    library; the CPU tests never call it)."""
    t, d = x.shape
    if d not in MODEL_DIMS:
        rows = min(t, WIDE_ROWS)
        bm, fs = wide_plan(rows, w_up.shape[1])
        out = (ctypes.c_int * 4)()
        fn = _build.function("fused_ffn", "fused_ffn_wide_plan",
                             [ctypes.c_int] * 5 + [ctypes.c_void_p])
        if fn(rows, w_up.shape[1], ACTIVATIONS[activation], bm, fs, out):
            raise ValueError(f"no launch plan for x {tuple(x.shape)}")
        return dict(grid=(out[0], out[1]), cluster=1, threads=out[2],
                    rows=bm, smem_bytes=out[3], slice=fs,
                    launches=kernel_launches(t, d),
                    workspace_bytes=out[1] * rows * d * 4)
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
