"""The any-dims attention variants: K2's (``csrc/attention_any.cu``) and
K4's split decode (``csrc/decode_any.cu``), their launch plans and their
plain PyTorch twins.

The tiled kernels are instantiated for a few head dims (K2: up to 256 in
bf16, 128 in f32; K4: 256 / 128, G <= 16 and G * D <= 1024; K4's self-slot
form: 128).  At any other dim the wrappers launch these variants instead,
chosen from the dims before the launch, as the JAX wrappers pad D to the
128 lanes and so take any dim.

K2's variant: a block owns ``ROWS`` query rows of one head, walks its keys
in tiles of ``KEYS`` with an online softmax in f32, and streams D through
shared memory in slices of 128 for the scores; the rows' f32 accumulators
sit in shared memory up to head dim ``SMEM_MAX_D`` and past it in a
device-memory workspace of one [ROWS, D] slab a block.  Its twin is
:func:`attention_tiled`.

K4's variant splits the key range (flash-decoding): a block owns the rows
that read one cache row's keys (the query heads of a KV head, and in the
self-slot form the heads of up to 64 candidates) and one split of
``SPLIT`` positions, scores every row against each staged K tile on the
tensor cores, and writes the split's max, sum and f32 accumulator to a
workspace; a second kernel merges the splits in order (and the
candidate's own key last).  Its grid, a function of the shapes alone, and
its workspace are decided in the library alone (:func:`decode_plan`);
:func:`attention_split` is its twin, which needs only SPLIT."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROWS = 16
KEYS = 32
SMEM_MAX_D = 2048
NEG_INF = -1e30
#: K4's split decode: positions a split (``decode_any.cu``'s kSplit)
SPLIT = 64


def workspace(row_tiles: int, groups: int, d: int, device):
    """K2's accumulators' workspace of a launch (None up to SMEM_MAX_D)."""
    if d <= SMEM_MAX_D:
        return None
    return torch.empty(row_tiles * groups * ROWS * d, dtype=torch.float32,
                       device=device)


def plan(row_tiles: int, groups: int, d: int) -> dict:
    """K2's launch: grid, threads, dynamic shared bytes and launches a call
    (1) (reads the library; the CPU tests never call it)."""
    out = (ctypes.c_int * 4)()
    fn = _build.function("attention_any", "attention_any_plan",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    if fn(row_tiles, groups, d, out):
        raise ValueError(f"no any-dims launch plan for {row_tiles} x "
                         f"{groups} blocks at head dim {d}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3],
                launches=1)


def attention_tiled(q, k, v, ok):
    """K2's variant's arithmetic: q [..., R, D] (already scaled), k / v
    [..., S, D], ok [..., R, S] (broadcastable) -> [..., R, D] f32.  Keys in
    tiles of KEYS, the running max and sum per row in f32, a masked key's
    weight an exact 0, acc = acc * alpha + P V; a row that sees no key
    gives zeros."""
    qf, kf, vf = q.float(), k.float(), v.float()
    shape = qf.shape[:-1]
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for t0 in range(0, kf.shape[-2], KEYS):
        kt, vt = kf[..., t0:t0 + KEYS, :], vf[..., t0:t0 + KEYS, :]
        okt = ok[..., t0:t0 + KEYS]
        s = torch.where(okt, qf @ kt.transpose(-1, -2),
                        torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(okt, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vt
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def decode_plan(dtype: int, b: int, m: int, h: int, hkv: int, s: int,
                d: int) -> dict:
    """K4's split-decode launch as the library decides it, for q [B, M, H,
    D] (M = 1: the single-token form) over caches of S positions and Hkv
    KV heads: the split kernel's grid, threads and dynamic shared bytes,
    rows a block, splits, head-dim passes, the combine's grid and threads,
    the workspace (floats and bytes) and the kernels a call launches
    (reads the library; the CPU tests never call it)."""
    out = (ctypes.c_int * 11)()
    out64 = (ctypes.c_longlong * 1)()
    fn = _build.function("decode_any", "decode_any_plan",
                         [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    if fn(dtype, b, m, h, hkv, s, d, out, out64):
        raise ValueError(f"no split-decode plan for q [{b}, {m}, {h}, {d}] "
                         f"over {s} positions, {hkv} KV heads")
    return dict(grid=(out[0], out[1], out[2]), threads=out[3],
                smem_bytes=out[4], rows=out[5], splits=out[6],
                passes=out[7], combine_grid=out[8],
                combine_threads=out[9], workspace_floats=out64[0],
                workspace_bytes=4 * out64[0], launches=out[10])


def attention_split(q, k, v, ok, *, scale: float = 1.0, k_self=None,
                    v_self=None):
    """K4's split decode's arithmetic: q [..., R, D], k / v [..., S, D],
    ok [..., R, S] (broadcastable) -> [..., R, D] f32.  The keys in splits
    of SPLIT positions (the last padded with masked zero keys); in each,
    the scores (q k^T) * scale in f32, a masked key's weight an exact 0,
    the split's max m_i, sum l_i and accumulator P V; then the splits
    merged in order with weights exp(m_i - max), a split with l_i = 0
    skipped; with ``k_self`` / ``v_self`` [..., R, D] (broadcastable) the
    rows' own key merged last.  A row that sees no key gives zeros.  Keys
    that no row sees are zeroed first, as the kernel never reads them."""
    qf = q.float()
    s = k.shape[-2]
    n = -(-s // SPLIT) if s > 0 else 1
    pad = n * SPLIT - s
    seen = ok.any(dim=-2)[..., None]
    zero = torch.zeros((), device=q.device)
    kf = torch.where(seen, k.float(), zero)
    vf = torch.where(seen, v.float(), zero)
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
        ok = torch.nn.functional.pad(ok, (0, pad), value=False)
    neg = torch.full((), NEG_INF, device=q.device)
    parts = []
    for i in range(n):
        sl = slice(i * SPLIT, (i + 1) * SPLIT)
        oki = ok[..., sl]
        sc = torch.where(oki, (qf @ kf[..., sl, :].transpose(-1, -2))
                         * scale, neg)
        mi = sc.amax(dim=-1)
        p = torch.where(oki, torch.exp(sc - mi[..., None]), zero)
        parts.append((mi, p.sum(dim=-1), p @ vf[..., sl, :]))
    mx = torch.full(parts[0][0].shape, NEG_INF, device=q.device)
    if k_self is not None:
        s_self = (qf * k_self.float()).sum(dim=-1) * scale
        mx = torch.maximum(mx, s_self)
    for mi, li, _ in parts:
        mx = torch.where(li > 0, torch.maximum(mx, mi), mx)
    den = torch.zeros_like(mx)
    acc = torch.zeros(parts[0][2].shape, device=q.device)
    for mi, li, ai in parts:
        w = torch.where(li > 0, torch.exp(mi - mx), zero)
        den = den + w * li
        acc = acc + w[..., None] * ai
    if k_self is not None:
        es = torch.exp(s_self - mx)
        den = den + es
        acc = acc + es[..., None] * v_self.float()
    return acc / den.clamp_min(1e-30)[..., None]
