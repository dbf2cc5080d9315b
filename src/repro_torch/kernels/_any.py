"""The any-dims attention variants: K2's (``csrc/attention_any.cu``),
K4's split decode (``csrc/decode_any.cu``) and K1's split-KV scoring
(``csrc/score_any.cu``, whose wrapper and twin are in
``kernels/fused_score/ops.py``), their launch plans and their plain
PyTorch twins.

The tiled kernels are instantiated for a few head dims (K2: up to 256 in
bf16, 128 in f32; K4: 256 / 128, G <= 16 and G * D <= 1024; K4's self-slot
form and K1: 128).  At any other dim the wrappers launch these variants
instead, chosen from the dims before the launch, as the JAX wrappers pad D
to the 128 lanes and so take any dim.

K2's variant: a block of 4 warps owns 64 query rows of one head (16 a
warp) and walks its keys in tiles of ``KEYS``, both products on the tensor
cores (bf16 ``mma.sync``, P as bf16 hi + lo; f32 as split TF32), with an
online softmax in f32; the output columns split into head-dim passes of at
most 256 columns on the grid, each of which recomputes the scores.  Its
grid is decided in the library alone (:func:`plan`); its twin is
:func:`attention_tiled`.

K4's single-token variant splits the key range (flash-decoding): a block
owns the query heads of one KV head and one split of ``SPLIT`` positions,
scores every row against each staged K tile on the tensor cores, and
writes the split's max, sum and f32 accumulator to a workspace; a second
kernel merges the splits in order.  Its grid, a function of the shapes
alone, and its workspace are decided in the library alone
(:func:`decode_plan`); its twin (:func:`split_parts` with plain f32
products, :func:`merge_parts`) needs only SPLIT.

K1's variant (``score_any.cu``) is one launch a call, with no workspace:
a thread-block cluster of ``CLUSTER`` CTAs for each group of up to 64 rows
(candidates' heads of one batch row and KV head).  CTA r folds the splits
of SPLIT keys whose index is r modulo CLUSTER -- the pool's stored history
(its scales, its rows, its lengths) in index order, then in ``extend``
mode the splits of the suffix keys before each row's own, numbered from 0
in their own segment -- into its rows' running softmax state; the CLUSTER
states are merged on chip in rank order through distributed shared
memory, the row's own key last (``cached``: the candidate's; ``extend``:
the suffix key at the row's position).  K4's self-slot form past head dim 128 is K1's
``cached`` mode over an unscaled history and runs it too.  Its plan is
:func:`score_plan`; its twin is :func:`cluster_fold`, the same dealing,
fold and merge with the kernel's operand roundings."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ffn.ops import _mm_any

#: K2's variant: keys a tile (``attention_any.cu``'s kKeys)
KEYS = 64
NEG_INF = -1e30
#: K4's split decode and K1's variant: positions a split (``decode_any.cu``'s
#: and ``score_any.cu``'s kSplit)
SPLIT = 64
#: K1's variant: CTAs a cluster (``score_any.cu``'s kCluster); CTA r takes
#: the splits whose index is r modulo CLUSTER
CLUSTER = 4


def plan(dtype: int, b: int, h: int, sq: int, d: int) -> dict:
    """K2's launch for q [B, Sq, H, D] as the library decides it: grid,
    threads, dynamic shared bytes, head-dim passes, columns a pass, keys a
    tile, whether the block's Q rows stay in shared memory, ring slots and
    launches a call (1) (reads the library; the CPU tests never call
    it)."""
    out = (ctypes.c_int * 10)()
    fn = _build.function("attention_any", "attention_any_plan",
                         [ctypes.c_int] * 5 + [ctypes.c_void_p])
    if fn(dtype, b, h, sq, d, out):
        raise ValueError(f"no any-dims launch plan for q [{b}, {sq}, {h}, "
                         f"{d}]")
    return dict(grid=(out[0], out[1], out[2]), threads=out[3],
                smem_bytes=out[4], passes=out[5], width=out[6],
                keys=out[7], q_resident=bool(out[8]), slots=out[9],
                launches=1)


def attention_tiled(q, k, v, ok, *, scale: float, dtype):
    """K2's variant's arithmetic: q [..., R, D], k / v [..., S, D], ok [...,
    R, S] (broadcastable) -> [..., R, D] f32; ``dtype`` the operands' type
    (the kernel's rounding follows it).  Keys in tiles of KEYS; the scores
    q k^T as the tensor cores take them (:func:`repro_torch.kernels.
    fused_ffn.ops._mm_any`: bf16 operands exact, f32 ones as split TF32),
    scaled by ``scale`` in f32; the running max and sum per row in f32, a
    masked key's weight an exact 0; acc = acc * alpha + P V with P as the
    kernel enters it (bf16: hi + lo, each rounded to bf16; f32: split
    TF32, V too).  A row that sees no key gives zeros.  The kernel's tiles
    start at its block's first visible key and its exponentials are the
    special-function unit's 2^x: rounding alone differs (within 1e-5 of
    the output's scale for f32 operands, the bf16 tolerance for bf16)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    shape = qf.shape[:-1]
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(qf.shape[:-1] + vf.shape[-1:], dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    zero = torch.zeros((), device=q.device)
    for t0 in range(0, kf.shape[-2], KEYS):
        kt, vt = kf[..., t0:t0 + KEYS, :], vf[..., t0:t0 + KEYS, :]
        okt = ok[..., t0:t0 + KEYS]
        s = torch.where(okt, _mm_any(qf, kt.transpose(-1, -2), dtype,
                                     a_exact=True), neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        ms = torch.where(m_new == NEG_INF, zero, m_new * scale)[..., None]
        p = torch.where(okt, torch.exp(s * scale - ms), zero)
        alpha = torch.exp(m * scale - ms[..., 0])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm_any(p, vt, dtype)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def decode_plan(dtype: int, b: int, h: int, hkv: int, s: int,
                d: int) -> dict:
    """K4's split-decode launch as the library decides it, for q [B, H, D]
    over caches of S positions and Hkv KV heads: the split kernel's grid,
    threads and dynamic shared bytes, rows a block, splits, head-dim
    passes, the combine's grid and threads, the workspace (floats and
    bytes) and the kernels a call launches (reads the library; the CPU
    tests never call it)."""
    out = (ctypes.c_int * 11)()
    out64 = (ctypes.c_longlong * 1)()
    fn = _build.function("decode_any", "decode_any_plan",
                         [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    if fn(dtype, b, h, hkv, s, d, out, out64):
        raise ValueError(f"no split-decode plan for q [{b}, {h}, {d}] over "
                         f"{s} positions, {hkv} KV heads")
    return dict(grid=(out[0], out[1], out[2]), threads=out[3],
                smem_bytes=out[4], rows=out[5], splits=out[6],
                passes=out[7], combine_grid=out[8],
                combine_threads=out[9], workspace_floats=out64[0],
                workspace_bytes=4 * out64[0], launches=out[10])


def score_plan(q_dtype: int, hist_dtype: int, mode: int, b: int, m: int,
               h: int, hkv: int, s: int, d: int) -> dict:
    """K1's any-dims launch as the library decides it, for q [B, M, H, D]
    over a history of S positions and Hkv KV heads (dtype codes and mode
    as ``score_any_fwd`` takes them): its grid (row groups x cluster,
    head-dim passes), CTAs a cluster and in all, threads, dynamic shared
    bytes, rows a CTA, history splits, ring slots, the CTAs resident on an
    SM and the clusters resident at once on this card (the occupancy
    calls), the waves the grid takes, the kernels a call launches (1) and
    whether the products are bf16 (else split TF32).  Reads the library
    and the device; the CPU tests never call it."""
    out = (ctypes.c_int * 12)()
    fn = _build.function("score_any", "score_any_plan",
                         [ctypes.c_int] * 9 + [ctypes.c_void_p])
    if fn(q_dtype, hist_dtype, mode, b, m, h, hkv, s, d, out):
        raise ValueError(f"no any-dims K1 plan for q [{b}, {m}, {h}, {d}] "
                         f"over {s} positions, {hkv} KV heads")
    clusters = out[0] // out[2] * out[1]
    return dict(grid=(out[0], out[1]), cluster=out[2], ctas=out[0] * out[1],
                threads=out[3], smem_bytes=out[4], rows=out[5],
                hist_splits=out[6], passes=out[1], slots=out[7],
                blocks_per_sm=out[8], resident_clusters=out[9],
                waves=-(-clusters // max(out[9], 1)), launches=out[10],
                bf16=bool(out[11]))


def split_parts(q, k, v, ok, *, scale=1.0, dtype=None, v_scale=None):
    """The splits of K4's split decode and K1's any-dims variant: q [...,
    R, D], k / v [..., S, D], ok [..., R, S] (broadcastable).  The keys in
    splits of SPLIT positions (the last padded with masked zero keys); in
    each, the scores (q k^T) * ``scale`` (a float or a tensor
    broadcastable to [..., R, S]) in f32, a masked key's weight an exact
    0, the split's max m_i, sum l_i and accumulator P V (times
    ``v_scale``, broadcastable to [..., R, D], where given).  ``dtype``:
    the kernel's operand type, whose roundings the products then take
    (:func:`repro_torch.kernels.fused_ffn.ops._mm_any`: bf16 q and keys
    exact, P as bf16 hi + lo; f32 as split TF32); None: plain f32
    products.  Keys that no row sees are zeroed first, as the kernels never
    read them.  Returns [(m_i, l_i, acc_i)] in split order."""
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
        kt = kf[..., sl, :].transpose(-1, -2)
        prod = qf @ kt if dtype is None else _mm_any(qf, kt, dtype,
                                                     a_exact=True)
        sc = torch.where(oki, prod * scale, neg)
        mi = sc.amax(dim=-1)
        p = torch.where(oki, torch.exp(sc - mi[..., None]), zero)
        acc = p @ vf[..., sl, :] if dtype is None \
            else _mm_any(p, vf[..., sl, :], dtype)
        if v_scale is not None:
            acc = acc * v_scale
        parts.append((mi, p.sum(dim=-1), acc))
    return parts


def merge_parts(parts, s_self=None, v_self=None):
    """The splits merged in order with weights exp(m_i - max), a split with
    l_i = 0 skipped; with ``s_self`` (the rows' own scores, f32 [..., R])
    and ``v_self`` [..., R, D] the rows' own key merged last.  A row that
    sees no key gives zeros."""
    zero = torch.zeros((), device=parts[0][0].device)
    mx = torch.full(parts[0][0].shape, NEG_INF, device=zero.device)
    if s_self is not None:
        mx = torch.maximum(mx, s_self)
    for mi, li, _ in parts:
        mx = torch.where(li > 0, torch.maximum(mx, mi), mx)
    den = torch.zeros_like(mx)
    acc = torch.zeros(parts[0][2].shape, device=zero.device)
    for mi, li, ai in parts:
        w = torch.where(li > 0, torch.exp(mi - mx), zero)
        den = den + w * li
        acc = acc + w[..., None] * ai
    if s_self is not None:
        es = torch.exp(s_self - mx)
        den = den + es
        acc = acc + es[..., None] * v_self.float()
    return acc / den.clamp_min(1e-30)[..., None]


def cluster_fold(q, segments, *, dtype, s_self=None, v_self=None):
    """K1's any-dims variant's arithmetic (``score_any.cu``): q [..., R, D]
    f32 rows; ``segments`` in order, each (k, v, ok, scale, v_scale) with k
    / v [..., S, D], ok [..., R, S] (broadcastable) the keys a row sees,
    ``scale`` the scores' multiplier (a float or broadcastable to [..., R,
    1]) and ``v_scale`` (broadcastable to [..., R, 1]) or None.  Each
    segment's keys in splits of SPLIT, numbered from 0 in the segment;
    rank r of CLUSTER folds the splits whose index is r modulo CLUSTER, a
    segment after another, into its running state: per row, m' = max(m,
    the split's max), alpha = exp(m - m'), l = l alpha + sum p, acc = acc
    alpha + P V (the products with ``dtype``'s roundings,
    :func:`repro_torch.kernels.fused_ffn.ops._mm_any`: bf16 q and keys
    exact, P as bf16 hi + lo; f32 as split TF32), a row that sees no key
    of the split left as it was; after a segment's splits its accumulator
    times ``v_scale``.  The ranks' states merged in rank order: M = the
    max over the ranks with l > 0 and ``s_self`` (the rows' own scores,
    [..., R]), weights exp(m_r - M), then the own key's value ``v_self``
    [..., R, D] last.  Keys a split's rows do not see are zeroed first, as
    the kernel stages zeros past a split's live keys, and the rows padded
    to a multiple of 8 (the kernel's row tiles) so that a row's arithmetic
    never depends on how many rows share the call.  A row that sees no key
    gives zeros.  Returns [..., R, D] f32."""
    rows = q.shape[-2]
    pad = -rows % 8
    pad_rows = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
                if t is not None and pad else t)
    qf = pad_rows(q.float())
    dev = q.device
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    segs = []
    for k, v, ok, scale, v_scale in segments:
        if pad and ok.shape[-2] == rows:
            ok = torch.nn.functional.pad(ok, (0, 0, 0, pad), value=False)
        if pad and torch.is_tensor(scale) and scale.shape[-2] == rows:
            scale = pad_rows(scale)
        segs.append((k, v, ok, scale, v_scale))
    states = []
    for rank in range(CLUSTER):
        m = torch.full(qf.shape[:-1], NEG_INF, device=dev)
        l = torch.zeros(qf.shape[:-1], device=dev)
        acc = torch.zeros(qf.shape, device=dev)
        for k, v, ok, scale, v_scale in segs:
            n = -(-k.shape[-2] // SPLIT)
            for i in range(rank, n, CLUSTER):
                sl = slice(i * SPLIT, (i + 1) * SPLIT)
                oki = ok[..., sl]
                seen = oki.any(dim=-2)[..., None]
                kt = torch.where(seen, k[..., sl, :].float(), zero)
                vt = torch.where(seen, v[..., sl, :].float(), zero)
                short = SPLIT - kt.shape[-2]
                if short:
                    kt = torch.nn.functional.pad(kt, (0, 0, 0, short))
                    vt = torch.nn.functional.pad(vt, (0, 0, 0, short))
                    oki = torch.nn.functional.pad(oki, (0, short),
                                                  value=False)
                prod = _mm_any(qf, kt.transpose(-1, -2), dtype, a_exact=True)
                sc = torch.where(oki, prod * scale, neg)
                has = oki.any(dim=-1)
                m_new = torch.where(has, torch.maximum(m, sc.amax(dim=-1)),
                                    m)
                alpha = torch.where(has, torch.exp(m - m_new), 1.0)
                p = torch.where(oki, torch.exp(sc - m_new[..., None]), zero)
                l = torch.where(has, l * alpha + p.sum(dim=-1), l)
                acc = torch.where(has[..., None],
                                  acc * alpha[..., None]
                                  + _mm_any(p, vt, dtype), acc)
                m = m_new
            if v_scale is not None:
                acc = acc * v_scale
        states.append((m, l, acc))
    mx = (torch.full(qf.shape[:-1], NEG_INF, device=dev) if s_self is None
          else pad_rows(s_self[..., None])[..., 0])
    for mr, lr, _ in states:
        mx = torch.where(lr > 0, torch.maximum(mx, mr), mx)
    den = torch.zeros_like(mx)
    out = torch.zeros(qf.shape, device=dev)
    for mr, lr, ar in states:
        w = torch.where(lr > 0, torch.exp(mr - mx), zero)
        den = den + w * lr
        out = out + w[..., None] * ar
    if s_self is not None:
        es = torch.exp(pad_rows(s_self[..., None])[..., 0] - mx)
        den = den + es
        out = out + es[..., None] * pad_rows(v_self.float())
    return (out / den.clamp_min(1e-30)[..., None])[..., :rows, :]
