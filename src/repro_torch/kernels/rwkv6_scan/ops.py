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

in chunks: the intra-chunk term from log-space decays
``exp(la_prev[t] - la[s])``, the inter-chunk term from the [D, D] state
carried from chunk to chunk.  ``w_log`` reaches -20 per step on the
model's path, so a chunk's cumulative decay reaches -1280, where the
factored form ``(r e^{la_prev}) . (k e^{-la})`` is 0 x inf.  The kernel
factors the decays through sub-chunk boundaries instead (every exponent
<= 0), keeping the pairwise exponentials only inside the diagonal 16 x 16
blocks, and runs every product of a chunk on the tensor cores (TF32,
operands as hi + lo); :func:`rwkv6_scan_subchunk` is that computation in
PyTorch, with the kernel's operand rounding, which the tests hold to the
JAX kernel, the token-by-token oracle and the plain version.

What bounds it on an H100: the bytes (reading r / k / v / w_log once,
writing o and the state once); its TF32 products, f32 work and
exponentials take less (``chip_smoke.py`` prints each term).  See the
CUDA source for the design.

:func:`rwkv6_scan` is the wrapper: on CUDA tensors it launches the kernel
(raising if the launch fails — there is no fallback), on CPU tensors it
runs :func:`rwkv6_scan_plain`, the chunked formulation of
``repro/models/rwkv6.py::wkv_chunked`` written in PyTorch.  The kernel
always uses chunks of 64 steps and masks the ragged last chunk; the plain
version uses ``min(chunk, S)`` and pads, as the JAX package does — the same
function up to rounding.  The kernel takes head sizes 32 and 64; a smaller
one runs padded (:func:`rwkv6_scan_padded`).  A larger one runs the
any-head-size variant (``csrc/rwkv6_scan_any.cu``, ``rwkv6_scan_any_fwd``),
which :func:`route` picks from the head size before the launch: the same
chunked function in f32, chunks of ANY_CHUNK steps, the [D, D] state's
columns split over blocks and held in shared memory up to head size 128
and in a device-memory workspace past it.  Its plain twin is
:func:`rwkv6_scan_any_plain`.  ``rwkv6_scan.launches`` counts kernel
launches of both.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.padding import pad_last, padded_dim

CHUNK = 64
#: the kernel's head sizes; a smaller one runs padded to the next of them
#: (:func:`rwkv6_scan_padded`)
HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_void_p])
_ANY_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_void_p])
#: the any-head-size variant: its chunk (steps), state columns a block,
#: and the head size up to which its work area is in shared memory
ANY_CHUNK = 32
ANY_COLS = 64
ANY_SMEM_MAX_D = 128
_count_lock = _build.COUNT_LOCK


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


def route(d: int) -> str:
    """``"tiled"`` (the tensor-core kernel, padded to 32 or 64) or
    ``"any"`` (the any-head-size variant), from the head size alone."""
    return "tiled" if d <= max(HEAD_DIMS) else "any"


def rwkv6_scan_any_plain(r, k, v, w_log, u, state=None):
    """The any-head-size variant's plain twin: :func:`rwkv6_scan_plain` in
    the variant's chunks of ANY_CHUNK steps (its pairwise decays, f32
    throughout).  Same arguments and results."""
    return rwkv6_scan_plain(r, k, v, w_log, u, state, chunk=ANY_CHUNK)


SUBCHUNK = 16     # the kernel's sub-chunk: the diagonal blocks of the scores


def _tf32(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    10-bit mantissa, ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """``x`` as the tensor core reads an f32 register as TF32: the low 13
    mantissa bits ignored (truncated toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's hi + lo: hi rounded to TF32, lo the remainder as the
    tensor core reads it."""
    hi = _tf32(x)
    return hi, _tf32_trunc(x - hi)


def _mm_split(a, b, *, b_exact: bool = False):
    """``a @ b`` as the kernel's mma.sync takes it: each operand as TF32 hi
    + lo, products lo*hi + hi*lo + hi*hi (lo*lo dropped); a ``b`` that is
    exact in TF32 (bf16 values) takes two products."""
    ah, al = _split(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def rwkv6_scan_subchunk(r, k, v, w_log, u, state=None):
    """The kernel's computation in PyTorch: chunks of 64 steps (the ragged
    tail padded with w_log 0 and zero r / k / v), the decays factored
    through sub-chunks of 16 steps, the products with the kernel's TF32 hi +
    lo operand rounding.  With B_j = la at the last step of sub-chunk j and
    A_i = B_{i-1} (A_0 = 0): Q = r e^{la_prev - A_i}, K = k e^{B_j - la};
    the scores' off-diagonal blocks are (Q e^{A_i - B_j}) K^T, the diagonal
    blocks stay pairwise; r e^{la_prev} = Q e^{A_i} and k e^{la_c - la} =
    K e^{la_c - B_j}.  Every exponent is <= 0.  la is ``torch.cumsum`` as in
    the plain version (on the card: the kernel's order, step by step in
    f32).  Same arguments and results as :func:`rwkv6_scan_plain`; the
    tests use it to check the kernel's algorithm on the CPU, the serving
    path never calls it."""
    _check(r, k, v, w_log, u, state)
    b, s, h, d = r.shape
    c, sub = CHUNK, SUBCHUNK
    ns = c // sub
    n = -(-s // c)
    pad = n * c - s

    def chunks(a):  # [b, s, h, d] -> [b, n, h, c, d] f32
        a = F.pad(a.float(), (0, 0, 0, 0, 0, pad))
        return a.reshape(b, n, c, h, d).transpose(2, 3)

    rf, kf, vf, wl = (chunks(a) for a in (r, k, v, w_log))
    v_exact = r.dtype == torch.bfloat16   # bf16 values are exact in TF32
    uf = u.float()[None, :, None]          # [1, h, 1, d]
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    tri = torch.tril(torch.ones(sub, sub, dtype=torch.bool,
                                device=r.device), -1)[..., None]
    outs = []
    for ci in range(n):
        rc, kc, vc, wc = rf[:, ci], kf[:, ci], vf[:, ci], wl[:, ci]
        la = torch.cumsum(wc, dim=2)
        lap = la - wc
        B = la[:, :, sub - 1::sub]                          # [b, h, ns, d]
        A = torch.cat([torch.zeros_like(B[:, :, :1]), B[:, :, :-1]], 2)
        Q = rc * torch.exp(lap - A.repeat_interleave(sub, 2))
        K = kc * torch.exp(B.repeat_interleave(sub, 2) - la)
        sc = torch.zeros((b, h, c, c), dtype=torch.float32, device=r.device)
        for i in range(ns):
            ti = slice(i * sub, (i + 1) * sub)
            for j in range(i):
                sj = slice(j * sub, (j + 1) * sub)
                q_i = Q[:, :, ti]
                if j < i - 1:   # e^{A_i - B_j}; 1 where A_i = B_{i-1}
                    q_i = q_i * torch.exp(A[:, :, i] - B[:, :, j])[:, :, None]
                sc[:, :, ti, sj] = _mm_split(q_i,
                                             K[:, :, sj].transpose(-1, -2))
            dec = torch.exp(lap[:, :, ti, None] - la[:, :, None, ti])
            pw = (rc[:, :, ti, None] * kc[:, :, None, ti] * dec)
            pw = torch.where(tri, pw, torch.zeros((), device=r.device)).sum(-1)
            bonus = (rc[:, :, ti] * uf * kc[:, :, ti]).sum(-1)
            sc[:, :, ti, ti] = pw + torch.diag_embed(bonus)
        r_dec = Q * torch.exp(A).repeat_interleave(sub, 2)
        o = _mm_split(r_dec, S) + _mm_split(sc, vc, b_exact=v_exact)
        la_c = B[:, :, -1]
        k_dec = K * torch.exp(la_c[:, :, None] - B).repeat_interleave(sub, 2)
        S = torch.exp(la_c)[..., None] * S + _mm_split(
            k_dec.transpose(-1, -2), vc, b_exact=v_exact)
        outs.append(o)
    o = torch.cat(outs, 2)[:, :, :s].transpose(1, 2)
    return o.to(r.dtype), S


def _aligned(t) -> bool:
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * es % 16 == 0 for st in t.stride()[:3])


def rwkv6_scan_padded(r, k, v, w_log, u, state=None, *, run=None):
    """``run`` (the kernel's launch; the plain version in the CPU tests) at
    the instantiated head size that holds D: r, k, v and u padded with
    zeros, ``w_log`` with 0 (decay 1, as the TPU wrapper pads its steps)
    and the state with zero rows and columns; the output and the final
    state sliced back.  The padded rows and columns of the state stay
    exactly zero: a padded key or value is 0, so every update adds 0 there,
    and a padded r reads nothing."""
    d = r.shape[-1]
    dp = padded_dim(d, HEAD_DIMS, "head size")
    run = run or _launch
    if dp == d:
        return run(r, k, v, w_log, u, state)
    if state is not None:
        state = F.pad(state, (0, dp - d, 0, dp - d))
    o, sf = run(*(pad_last(t, dp) for t in (r, k, v, w_log, u)), state)
    return o[..., :d], sf[..., :d, :d]


def _prepare(r, k, v, w_log, u, state):
    """A launch's checks of dtype, device and layout; w_log, u and the
    state as the kernels take them (f32, u and the state contiguous)."""
    _build.forbid_grad("rwkv6_scan", r, k, v, w_log, u, state)
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan kernel takes f32 or bf16 r, k, v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    w_log = w_log.float()
    u = u.float().contiguous()
    if state is not None:
        state = state.float().contiguous()
    ops = (r, k, v, w_log, u) + ((state,) if state is not None else ())
    if any(t.device != r.device for t in ops):
        raise ValueError("rwkv6_scan operands must be on one device")
    if any(t.stride(-1) != 1 for t in (r, k, v, w_log)):
        raise ValueError("the head-size axis must be contiguous (stride 1)")
    return w_log, u, state


def _launch(r, k, v, w_log, u, state):
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in {HEAD_DIMS}")
    w_log, u, state = _prepare(r, k, v, w_log, u, state)
    # cp.async stages 16-byte pieces: a misaligned operand is copied once
    r, k, v, w_log = (t if _aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (r, k, v, w_log))
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


def _launch_any(r, k, v, w_log, u, state):
    """The any-head-size variant (``rwkv6_scan_any_fwd``)."""
    b, s, h, d = r.shape
    w_log, u, state = _prepare(r, k, v, w_log, u, state)
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    o = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    sf = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ws = None
    if d > ANY_SMEM_MAX_D:
        ws = torch.empty(-(-d // ANY_COLS) * b * h
                         * (d * ANY_COLS + 3 * ANY_CHUNK * (d + 1)),
                         dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(*[
        st for t in (r, k, v, w_log, o) for st in t.stride()[:3]])
    fn = _build.function("rwkv6_scan_any", "rwkv6_scan_any_fwd",
                         _ANY_ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
             u.data_ptr(), state.data_ptr() if state is not None else None,
             o.data_ptr(), sf.data_ptr(),
             None if ws is None else ws.data_ptr(), _DTYPES[r.dtype], b, s,
             h, d, strides, _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"rwkv6_scan_any_fwd failed with CUDA error {err} "
                           f"(r {tuple(r.shape)} {r.dtype})")
    with _count_lock:
        rwkv6_scan.launches += 1
    return o, sf


def rwkv6_scan(r, k, v, w_log, u, state=None, *, chunk: int = CHUNK):
    """r,k,v,w_log [B,S,H,D] (w_log = log decay <= 0); u [H,D]; state
    [B,H,D,D] (None: zeros).  Returns (o [B,S,H,D] in r's dtype, final state
    [B,H,D,D] f32).  :func:`route` picks the kernel from the head size:
    the CUDA kernel on CUDA tensors (chunks of 64, or ANY_CHUNK past head
    size 64), the plain version on CPU tensors (chunks of ``min(chunk,
    S)``; past head size 64 the variant's twin); anything else raises."""
    _check(r, k, v, w_log, u, state)
    ops = (r, k, v, w_log, u) + ((state,) if state is not None else ())
    tiled = route(r.shape[-1]) == "tiled"
    if r.is_cuda:
        if tiled:
            return rwkv6_scan_padded(r, k, v, w_log, u, state)
        return _launch_any(r, k, v, w_log, u, state)
    if all(t.device.type == "cpu" for t in ops):
        if tiled:
            return rwkv6_scan_plain(r, k, v, w_log, u, state, chunk=chunk)
        return rwkv6_scan_any_plain(r, k, v, w_log, u, state)
    raise ValueError("rwkv6_scan runs on CUDA or CPU tensors, got "
                     + ", ".join(sorted({str(t.device) for t in ops})))


def plan(r) -> dict:
    """The launch for r / k / v like ``r`` ([B,S,H,D], f32 or bf16): grid,
    threads per block, dynamic shared bytes, column split (blocks per row
    and head) and resident blocks per SM; for the any-head-size variant its
    grid, threads, dynamic shared bytes and workspace floats.  Reads the
    library; the CPU tests never call it."""
    b, _, h, d = r.shape
    if route(d) == "any":
        out = (ctypes.c_longlong * 5)()
        fn = _build.function("rwkv6_scan_any", "rwkv6_scan_any_plan",
                             [ctypes.c_int] * 3 + [ctypes.c_void_p])
        if fn(b, h, d, out):
            raise ValueError(f"no launch plan for r {tuple(r.shape)}")
        return dict(grid=(out[0], out[1]), threads=out[2],
                    smem_bytes=out[3], workspace_floats=out[4])
    d = padded_dim(d, HEAD_DIMS, "head size")
    out = (ctypes.c_int * 5)()
    fn = _build.function("rwkv6_scan", "rwkv6_scan_plan",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    if fn(_DTYPES[r.dtype], b, h, d, out):
        raise ValueError(f"no launch plan for r {tuple(r.shape)} {r.dtype}")
    return dict(grid=out[0], threads=out[1], smem_bytes=out[2],
                col_split=out[3], blocks_per_sm=out[4])


rwkv6_scan.launches = 0
