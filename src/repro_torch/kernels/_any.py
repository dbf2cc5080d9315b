"""The any-dims attention variant of K2 and K4 (``csrc/attention_any.cu``):
its launch geometry and its plain PyTorch twin.

The tiled kernels are instantiated for a few head dims (K2: up to 256 in
bf16, 128 in f32; K4: 256 / 128, G <= 16 and G * D <= 1024; K4's self-slot
form: 128).  At any other dim the wrappers launch this variant instead,
chosen from the dims before the launch, as the JAX wrappers pad D to the
128 lanes and so take any dim.  A block owns ``ROWS`` rows that read the
same keys (query positions of one head, or the query heads of one KV head),
walks its keys in tiles of ``KEYS`` with an online softmax in f32, and
streams D through shared memory in slices of 128 for the scores; the
rows' f32 accumulators sit in shared memory up to head dim ``SMEM_MAX_D``
and past it in a device-memory workspace of one [ROWS, D] slab a block.

:func:`attention_tiled` is the twin: the same key tiles, online softmax and
f32 accumulation on materialized operands, which the wrappers run on CPU
tensors when the dims pick this variant."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROWS = 16
KEYS = 32
SMEM_MAX_D = 2048
NEG_INF = -1e30


def workspace(row_tiles: int, groups: int, d: int, device):
    """The accumulators' workspace of a launch (None up to SMEM_MAX_D)."""
    if d <= SMEM_MAX_D:
        return None
    return torch.empty(row_tiles * groups * ROWS * d, dtype=torch.float32,
                       device=device)


def plan(row_tiles: int, groups: int, d: int) -> dict:
    """A launch's grid, threads and dynamic shared bytes (reads the
    library; the CPU tests never call it)."""
    out = (ctypes.c_int * 4)()
    fn = _build.function("attention_any", "attention_any_plan",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    if fn(row_tiles, groups, d, out):
        raise ValueError(f"no any-dims launch plan for {row_tiles} x "
                         f"{groups} blocks at head dim {d}")
    return dict(grid=(out[0], out[1]), threads=out[2], smem_bytes=out[3])


def attention_tiled(q, k, v, ok):
    """The variant's arithmetic: q [..., R, D] (already scaled), k / v
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
