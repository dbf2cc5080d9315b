"""Kernel K4's log-sum-exp output (``flash_decode(..., return_lse=True)``),
which a decode over a cache whose positions are split across ranks merges
with the other ranks' partial softmaxes.

On the CPU the wrapper's plain versions (the tiled kernel's and the
any-dims variant's) give the output they give without it, bitwise, and a
log-sum-exp equal to an independent f64 ``torch.logsumexp`` of the scaled
scores over the valid positions (-inf for a row with none); two halves of
a cache merged by the online-softmax rule from their outputs and
log-sum-exps equal the whole cache's decode, and JAX's ``flash_decode``.
The ``cuda``-marked cases hold the kernels' log-sum-exp against the plain
version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import flash_decode as j_flash_decode
from repro_torch.kernels.flash_decode import ops as fd

#: (head dim, query heads, KV heads): the tiled kernel (d 64 and 240,
#: padded to 256) and the any-dims variant (d 300; G 32)
DIMS = [(64, 4, 2), (240, 4, 2), (300, 2, 1), (32, 32, 1)]
LENGTHS = [37, 0, 1, 64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(d, h, hkv, dtype, s=64, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((4, h, d))).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((4, s, hkv, d))).to(dtype)
            for _ in range(2))
    return q, k, v, torch.tensor(LENGTHS, dtype=torch.int32)


def _lse64(q, k, lengths, window):
    """log sum exp of q . k / sqrt(D) (q scaled in its dtype, as the
    wrapper scales it) over each row's valid positions, in f64."""
    b, h, d = q.shape
    hkv = k.shape[2]
    qs = (q * (1.0 / math.sqrt(d))).double().reshape(b, hkv, h // hkv, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qs, k.double())
    pos = torch.arange(k.shape[1])[None, :]
    ok = pos < lengths.long()[:, None]
    if window:
        ok = ok & (pos >= lengths.long()[:, None] - window)
    sc = torch.where(ok[:, None, None, :], sc, torch.tensor(-math.inf,
                                                           dtype=sc.dtype))
    return torch.logsumexp(sc, dim=-1).reshape(b, h)


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,hkv", DIMS)
def test_lse_plain_matches_logsumexp(d, h, hkv, dtype, window):
    q, k, v, lens = _inputs(d, h, hkv, dtype)
    o, lse = fd.flash_decode(q, k, v, lens, window=window, return_lse=True)
    assert torch.equal(o, fd.flash_decode(q, k, v, lens, window=window))
    assert lse.dtype == torch.float32 and lse.shape == (4, h)
    want = _lse64(q, k, lens, window)
    assert torch.isneginf(lse[1]).all()
    np.testing.assert_allclose(lse[[0, 2, 3]].double().numpy(),
                               want[[0, 2, 3]].numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d,h,hkv", DIMS)
def test_split_halves_merge_to_the_whole(d, h, hkv):
    """Each half of the positions decoded alone, the two merged by their
    log-sum-exps (``sharding.softmax_merge``'s rule), equals JAX's
    decode of the whole cache in f32."""
    q, k, v, lens = _inputs(d, h, hkv, torch.float32, seed=1)
    half = k.shape[1] // 2
    parts = []
    for lo in (0, half):
        n = torch.clamp(lens - lo, 0, half).to(torch.int32)
        o, lse = fd.flash_decode(q, k[:, lo:lo + half], v[:, lo:lo + half],
                                 n, return_lse=True)
        have = (n > 0)[:, None]
        parts.append((torch.where(have, lse, torch.tensor(fd.NEG_INF)),
                      have.float(), o * have[..., None]))
    top = torch.maximum(parts[0][0], parts[1][0])
    num = sum(acc * torch.exp(m - top)[..., None] for m, _, acc in parts)
    den = sum(l_ * torch.exp(m - top) for m, l_, _ in parts)
    got = num / den[..., None]
    want = np.asarray(j_flash_decode(jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()),
                                     jnp.asarray(lens.numpy()),
                                     interpret=True))
    rows = [0, 2, 3]                 # row 1 has no valid position
    np.testing.assert_allclose(got[rows].numpy(), want[rows], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,hkv", DIMS)
def test_lse_kernel_vs_plain(cuda_device, d, h, hkv, dtype, window):
    """Both kernels' log-sum-exp against the plain version on the card,
    their output unchanged by asking for it."""
    q, k, v, lens = (t.to(cuda_device) for t in _inputs(d, h, hkv, dtype))
    o, lse = fd.flash_decode(q, k, v, lens, window=window, return_lse=True)
    alone = fd.flash_decode(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert torch.equal(o, alone)
    _, want = fd.flash_decode(q.cpu(), k.cpu(), v.cpu(), lens.cpu(),
                              window=window, return_lse=True)
    assert torch.isneginf(lse[1].cpu()).all()
    torch.testing.assert_close(lse.cpu()[[0, 2, 3]], want[[0, 2, 3]],
                               rtol=1e-5, atol=1e-4)
