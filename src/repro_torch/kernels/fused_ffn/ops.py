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
(``fused_ffn_wide_fwd``), on one of two paths that :func:`wide_plan`
picks from T alone (numbers: an H100 80GB HBM3 at 700 W, its published
3.35 TB/s and 989 TFLOP/s bf16; times from ``scripts/k3_wide_sweep.py``):

- up to WIDE_DECODE_T rows (decode), a weight stream, bound by the
  weights' bytes (236 MB a gemma3-12b layer: 0.070 ms): one CTA for each
  16-row m tile and each slice of WIDE_SLICE d_ff columns (240 CTAs at
  d_ff 15360, 160 at 10240, two to an SM), the weights through a TMA ring
  of 5-6 stages, the hidden in shared memory, each slice's f32 partial
  [T, d] to a workspace that a second kernel sums in a fixed order.  At
  T 4, 0.0925 ms gelu / 0.0948 swiglu, against the bf16 matmul chain's
  0.0862 / 0.0915;
- past it (prefill), two persistent ``wgmma`` GEMMs fed by TMA rings: the
  up (and gate) product and the activation writing the hidden [T, d_ff] to
  device memory as bf16 hi + lo planes, then the down product over the
  whole of d_ff in each output tile's k-loop, writing bf16 ``out``; bound
  by the products (0.477 ms at gemma3-12b's T 2000; 0.716 ms on the tensor
  cores with the hidden's lo term).  At T 2000, 1.1777 ms gelu / 1.0096
  swiglu against the chain's 0.7627 / 0.7850.  No slices and no partials:
  a row's output is bitwise the same whatever T (within the path).  With
  ``has_norm`` a pre-pass writes n(x) as hi + lo planes, a third kernel.

Rows run WIDE_ROWS at a launch; :func:`wide_workspace_bytes` is the
workspace a call allocates: at gemma3-12b's widths the hidden planes of
2048 rows, 126 MB, or the decode path's partials, 240 x T x d floats (15
MB at T 4, 118 MB at T 32).

Every other width runs the any-dims variant, ``csrc/ffn_any.cu``
(``ffn_any_fwd``): f32 operands at a model dim outside MODEL_DIMS, and bf16
operands whose d or d_ff is not a multiple of 8.  :func:`route` picks it
from the dims and dtype before the launch.  A CTA owns 16 rows and one
slice of d_ff (:func:`any_slice_cols` picks the slices from T, so that
small T still spreads over the SMs), streams d through shared memory in
64-wide pieces for the up (and gate) product, keeps the [16, 64] hidden in
shared memory and adds its down product to its slice's f32 partial; a
second kernel sums the slices in order.  f32 throughout (CUDA cores, not
tensor cores): it serves dims no registry config uses.  Its plain twin is
:func:`fused_ffn_any_plain`.

:func:`fused_ffn_2d` is the wrapper: the CUDA kernel on CUDA tensors
(raising if the launch fails — there is no fallback), :func:`fused_ffn_plain`
on CPU tensors.  ``fused_ffn_2d.launches`` counts kernel launches: one a call
of the cluster kernel, two (three with ``has_norm`` past WIDE_DECODE_T rows)
for each launch of at most WIDE_ROWS rows of the wide form
(:func:`kernel_launches`); :func:`plan` gives the launch's grid, cluster,
rows per CTA, shared memory and weight slots, and for the wide form each
kernel's grid, threads, shared memory and ring stages and the workspace.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

ACTIVATIONS = {"gelu": 0, "relu": 1, "swiglu": 2}
#: the model dims of the cluster kernel (the only ones for f32 operands);
#: bf16 operands at any other d run the wide form
MODEL_DIMS = (64, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
_ANY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
ANY_ROWS = 16           # any-dims variant: rows a CTA
ANY_COLS = 64           # ... d_ff columns a step (slices are multiples)
ANY_CTAS = 264          # ... CTAs it aims at: two for each of 132 SMs
_WIDE_PATHS = {"decode": 0, "prefill": 1}
#: the wide form's decode path up to this many rows, its prefill path past
#: it: where the two paths cross on an H100 80GB HBM3 at 700 W
#: (scripts/k3_wide_sweep.py; d 3840: gelu d_ff 15360 at T 32 / 40: decode
#: 0.1735 / 0.2106 ms, prefill 0.1888 / 0.1888; swiglu d_ff 10240 at T 24 /
#: 32: 0.1489 / 0.1581 against 0.1572 / 0.1535)
WIDE_DECODE_T = 32
WIDE_DECODE_ROWS = 16   # decode path: rows a CTA
WIDE_SLICE = 64         # decode path: d_ff columns a CTA
WIDE_TILE_ROWS = 128    # prefill path: rows a GEMM tile
WIDE_ROWS = 2048        # rows a launch of the wide form
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


def route(d: int, f: int, dtype) -> str:
    """The kernel for model dim ``d``, d_ff ``f`` and ``dtype``:
    ``"cluster"`` (d 64 / 256), ``"wide"`` (bf16, d and d_ff multiples of 8)
    or ``"any"`` (the any-dims variant)."""
    if d in MODEL_DIMS:
        return "cluster"
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "wide"
    return "any"


def any_slice_cols(t: int, f: int) -> int:
    """d_ff columns of one slice of the any-dims variant at ``t`` rows: as
    many slices as bring ceil(t / 16) row tiles near ANY_CTAS CTAs, at most
    one for each ANY_COLS columns."""
    tiles = -(-t // ANY_ROWS)
    slices = max(1, min(-(-ANY_CTAS // tiles), -(-f // ANY_COLS)))
    return -(-(-(-f // slices)) // ANY_COLS) * ANY_COLS


def fused_ffn_any_plain(x, w_up, w_down, w_gate=None, norm_scale=None, *,
                        activation: str = "swiglu"):
    """The any-dims variant's plain twin: f32 throughout, d_ff cut into
    the kernel's slices (:func:`any_slice_cols`), each slice's partial
    [T, d] formed apart and the partials summed in slice order, rounded to
    x's dtype once.  Same arguments and result as
    :func:`fused_ffn_plain`."""
    h = x.float()
    if norm_scale is not None:
        var = torch.mean(h * h, dim=-1, keepdim=True)
        h = h * torch.rsqrt(var + EPS) * (1.0 + norm_scale.float())
    f = w_up.shape[1]
    cols = any_slice_cols(x.shape[0], f)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for f0 in range(0, f, cols):
        sl = slice(f0, f0 + cols)
        up = h @ w_up[:, sl].float()
        if activation == "swiglu":
            a = F.silu(h @ w_gate[:, sl].float()) * up
        elif activation == "gelu":
            a = F.gelu(up, approximate="tanh")
        else:
            a = F.relu(up)
        out = out + a @ w_down[sl].float()
    return out.to(x.dtype)


def _wide_path(t: int) -> str:
    return "decode" if t <= WIDE_DECODE_T else "prefill"


class WidePlan(NamedTuple):
    path: str        # "decode" or "prefill"
    rows: int        # rows a CTA (decode) or a GEMM tile (prefill)
    tiles: int       # CTAs of the decode path; 128-row m tiles (prefill)


def wide_plan(t: int, f: int) -> WidePlan:
    """The wide form's path for one launch of ``t`` rows (at most
    WIDE_ROWS) at d_ff = ``f``, chosen by ``t`` alone.

    Up to WIDE_DECODE_T rows the decode path: ceil(t / 16) m tiles x
    ceil(f / WIDE_SLICE) slices of CTAs, so that every SM of an H100 (132)
    streams weights at the text models' d_ff (240 CTAs at 15360, 160 at
    10240).  Past it the prefill path, whose two GEMMs tile the rows by
    WIDE_TILE_ROWS (their column tiles and persistent grids: :func:`plan`)."""
    if _wide_path(t) == "decode":
        return WidePlan("decode", WIDE_DECODE_ROWS,
                        -(-t // WIDE_DECODE_ROWS) * -(-f // WIDE_SLICE))
    return WidePlan("prefill", WIDE_TILE_ROWS, -(-t // WIDE_TILE_ROWS))


def _wide_chunks(t: int):
    return [(r0, min(WIDE_ROWS, t - r0)) for r0 in range(0, t, WIDE_ROWS)]


def wide_workspace_bytes(t: int, d: int, f: int, norm: bool = False) -> int:
    """Bytes of the workspace one wide-form call of ``t`` rows allocates
    (one buffer for all its launches): per launch of n rows, the decode
    path's f32 partials, ceil(f / WIDE_SLICE) x n x d x 4, or the prefill
    path's hidden planes, n x f x 4 (and n(x)'s, n x d x 4, with
    ``norm``)."""
    def one(n):
        if _wide_path(n) == "decode":
            return -(-f // WIDE_SLICE) * n * d * 4
        return n * f * 4 + (n * d * 4 if norm else 0)
    return max((one(n) for _, n in _wide_chunks(t)), default=0)


def kernel_launches(t: int, d: int, norm: bool = False, *, f: int,
                    dtype) -> int:
    """Kernels one :func:`fused_ffn_2d` call of ``t`` rows at model dim
    ``d``, d_ff ``f`` and operands of ``dtype`` launches on the card (what
    it adds to ``fused_ffn_2d.launches``): one for the cluster kernel (d 64
    / 256); two for the any-dims variant; for the wide form two per launch
    of at most WIDE_ROWS rows, and a third (the norm pre-pass) on the
    prefill path with ``norm``."""
    if t == 0:
        return 0
    kind = route(d, f, dtype)
    if kind == "cluster":
        return 1
    if kind == "any":
        return 2
    return sum(2 + (norm and _wide_path(n) == "prefill")
               for _, n in _wide_chunks(t))


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
    _build.forbid_grad("fused_ffn", x, w_up, w_down, w_gate, norm_scale)
    ops = [t for t in (x, w_up, w_down, w_gate, norm_scale) if t is not None]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"fused_ffn kernel takes f32 or bf16 operands of one "
                        f"dtype, got {sorted({str(t.dtype) for t in ops})}")
    t, d = x.shape
    f = w_up.shape[1]
    kind = route(d, f, x.dtype)
    if any(o.device != x.device for o in ops):
        raise ValueError("fused_ffn operands must be on one device")
    if not all(o.is_contiguous() for o in ops):
        raise ValueError("fused_ffn operands must be contiguous (row-major)")
    out = torch.empty_like(x)
    if t == 0:
        return out
    if kind == "any":
        cols = any_slice_cols(t, f)
        part = torch.empty((-(-f // cols), t, d), dtype=torch.float32,
                           device=x.device)
        fn = _build.function("ffn_any", "ffn_any_fwd", _ANY_ARGTYPES)
        err = fn(x.data_ptr(),
                 None if norm_scale is None else norm_scale.data_ptr(),
                 w_up.data_ptr(),
                 None if w_gate is None else w_gate.data_ptr(),
                 w_down.data_ptr(), out.data_ptr(), part.data_ptr(),
                 _DTYPES[x.dtype], t, d, f, ACTIVATIONS[activation], cols,
                 _build.stream_handle(x.device))
        if err:
            raise RuntimeError(f"ffn_any_fwd failed with CUDA error {err} "
                               f"(x {tuple(x.shape)} {x.dtype}, d_ff {f})")
        with _count_lock:
            fused_ffn_2d.launches += kernel_launches(t, d, f=f,
                                                     dtype=x.dtype)
        return out
    if kind == "wide":
        fn = _build.function("fused_ffn", "fused_ffn_wide_fwd",
                             _WIDE_ARGTYPES)
        norm = norm_scale is not None
        # one workspace for every launch (hidden planes or partials)
        ws = torch.empty(wide_workspace_bytes(t, d, f, norm),
                         dtype=torch.uint8, device=x.device)
        for r0, n in _wide_chunks(t):
            err = fn(x[r0:].data_ptr(),
                     None if norm_scale is None else norm_scale.data_ptr(),
                     w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), out[r0:].data_ptr(), ws.data_ptr(),
                     n, d, f, ACTIVATIONS[activation], int(norm),
                     _WIDE_PATHS[wide_plan(n, f).path],
                     _build.stream_handle(x.device))
            if err:
                raise RuntimeError(f"fused_ffn_wide_fwd failed with CUDA "
                                   f"error {err} (x {tuple(x.shape)}, rows "
                                   f"{r0}..{r0 + n}, d_ff {f})")
            with _count_lock:
                fused_ffn_2d.launches += kernel_launches(
                    n, d, norm, f=f, dtype=x.dtype)
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
    """x [T,d] -> [T,d] fused (norm +) FFN.  :func:`route` picks the
    kernel from the dims and dtype; the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors; anything else raises."""
    _check(x, w_up, w_down, w_gate, norm_scale, activation)
    if x.is_cuda:
        return _launch(x, w_up, w_down, w_gate, norm_scale, activation)
    ops = [t for t in (x, w_up, w_down, w_gate, norm_scale) if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        plain = (fused_ffn_any_plain if route(x.shape[1], w_up.shape[1],
                                              x.dtype) == "any"
                 else fused_ffn_plain)
        return plain(x, w_up, w_down, w_gate, norm_scale,
                     activation=activation)
    raise ValueError("fused_ffn runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in ops})))


fused_ffn_2d.launches = 0


def plan(x, w_up, *, activation: str = "gelu",
         has_norm: bool = False) -> dict:
    """The kernel's launch for ``x`` [T,d] and ``w_up`` [d,f] shaped and
    typed like these: grid, CTAs per cluster, threads, rows per CTA,
    dynamic shared bytes and weight slots of the ring.  For the wide form
    (its first launch, of at most WIDE_ROWS rows), as the library reckons
    it: the path, the kernels a launch runs, and for its two main kernels
    (stream + reduce, or up + down GEMM) grid, threads, dynamic shared
    bytes and ring stages, tile (rows, columns; none for the reduction)
    and tiles; the workspace bytes; and the kernels the whole call
    launches.  For the any-dims variant: its grid (row tiles, d_ff
    slices), threads, slice columns, workspace and launches.  Reads the
    library for the other kernels; the CPU tests never call it."""
    t, d = x.shape
    f = w_up.shape[1]
    kind = route(d, f, x.dtype)
    if kind == "any":
        cols = any_slice_cols(t, f)
        return dict(path="any", grid=(-(-t // ANY_ROWS), -(-f // cols)),
                    threads=256, slice_cols=cols,
                    workspace_bytes=-(-f // cols) * t * d * 4,
                    launches=kernel_launches(t, d, has_norm, f=f,
                                             dtype=x.dtype))
    if kind == "wide":
        rows = min(t, WIDE_ROWS)
        path = wide_plan(rows, f).path
        out = (ctypes.c_longlong * 17)()
        fn = _build.function("fused_ffn", "fused_ffn_wide_plan",
                             [ctypes.c_int] * 6 + [ctypes.c_void_p])
        if fn(rows, d, f, ACTIVATIONS[activation], int(has_norm),
              _WIDE_PATHS[path], out):
            raise ValueError(f"no launch plan for x {tuple(x.shape)}")
        o = list(out)
        return dict(path=path, kernels=o[1], grid=(o[2], o[6]),
                    threads=(o[3], o[7]), smem_bytes=(o[4], o[8]),
                    stages=(o[5], o[9]), workspace_bytes=o[10],
                    tile=((o[11], o[12]), (o[15], o[16])),
                    tiles=(o[13], o[14]),
                    launches=kernel_launches(t, d, has_norm, f=f,
                                             dtype=x.dtype))
    out = (ctypes.c_int * 6)()
    fn = _build.function("fused_ffn", "fused_ffn_plan",
                         [ctypes.c_int] * 6 + [ctypes.c_void_p])
    if fn(_DTYPES[x.dtype], t, d, f, ACTIVATIONS[activation],
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
