"""Kernel K5's algorithm on the CPU: ``rwkv6_scan_subchunk``, the PyTorch
twin of the CUDA kernel (chunks of 64 steps, decays factored through
sub-chunks of 16, the products with the kernel's TF32 hi + lo operand
rounding), held to the JAX Pallas kernel in interpret mode, to the
token-by-token oracle and to the plain version, at the tolerances the
kernel meets on the card (``chip_smoke.py``):

* against the plain version: within 1e-4 elementwise (atol and rtol) in f32
  and in the state, 2e-2 for bf16 outputs (the ``cuda`` test of
  ``test_torch_rwkv.py``), and within 5e-4 (f32) / 8e-3 (bf16) of the
  output's scale (``K5_F32_TOL``, ``K5_BF16_TOL``);
* against the JAX kernel and the oracle: within 2e-3 of the scale
  (``K5_ORACLE_TOL``, the JAX test's own bound: the chunked sums reassociate
  the recurrence), 8e-3 for bf16 outputs (two bf16 ulps).

Every case has runs of w_log = -20 (a chunk's decay reaches -1280, where
the factoring through e^{-la} overflows) and a non-zero initial state.
Inputs are made from a numpy seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import ops as j_scan_ops
from repro_torch.kernels.rwkv6_scan import ops as scan
from repro_torch.kernels.rwkv6_scan import ref as scan_ref

torch.set_num_threads(1)
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # elementwise
PLAIN_TOL = {torch.float32: 5e-4, torch.bfloat16: 8e-3}  # of the scale
ORACLE_TOL = {torch.float32: 2e-3, torch.bfloat16: 8e-3}  # of the scale
STATE_TOL = 1e-4

TWIN_S = [1, 15, 16, 17, 63, 64, 65, 130]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _inputs(b, h, s, d, seed):
    """r, k, v [B,S,H,D], w_log with runs of -20, u [H,D], s0 [B,H,D,D],
    all f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    wl = np.clip(-np.exp(rng.uniform(np.log(1e-4), np.log(20.0),
                                     (b, s, h, d))), -20.0, -1e-4)
    wl[:, 5:40] = -20.0
    wl[:, 100:120] = -20.0
    u = (0.5 * rng.standard_normal((h, d))).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, wl.astype(np.float32), u, s0


def _torch(arrs, dtype):
    r, k, v, wl, u, s0 = (torch.from_numpy(a) for a in arrs)
    return (r.to(dtype), k.to(dtype), v.to(dtype), wl, u, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", TWIN_S)
def test_subchunk_twin_vs_plain_oracle_and_jax(s, dtype):
    b, h, d = (2, 2, 32) if s in (15, 65) else (1, 2, 64)
    arrs = _inputs(b, h, s, d, seed=100 + s)
    ops = _torch(arrs, dtype)
    o, sf = scan.rwkv6_scan_subchunk(*ops)
    assert o.dtype == dtype and sf.dtype == torch.float32
    assert o.shape == (b, s, h, d) and sf.shape == (b, h, d, d)
    assert torch.isfinite(o.float()).all() and torch.isfinite(sf).all()

    po, psf = scan.rwkv6_scan_plain(*ops)
    tol = CUDA_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(sf, psf, atol=STATE_TOL, rtol=STATE_TOL)
    assert _rel(o.float(), po.float()) <= PLAIN_TOL[dtype]

    # the oracle on the same (dtype-rounded) values, in f32
    f32 = [t.float() for t in ops]
    bh = [t.transpose(1, 2).reshape(b * h, s, d) for t in f32[:4]]
    ub = f32[4][None].expand(b, h, d).reshape(b * h, d)
    oo, osf = scan_ref.reference(*bh, ub, f32[5].reshape(b * h, d, d))
    oo = oo.reshape(b, h, s, d).transpose(1, 2)
    assert _rel(o.float(), oo) <= ORACLE_TOL[dtype]
    assert _rel(sf.reshape(b * h, d, d), osf) <= ORACLE_TOL[torch.float32]

    jo, jsf = j_scan_ops.rwkv6_scan(
        *(jnp.asarray(t.numpy()) for t in f32), interpret=True)
    assert _rel(o.float(), jo) <= ORACLE_TOL[dtype]
    assert _rel(sf, jsf) <= ORACLE_TOL[torch.float32]


def test_subchunk_twin_finite_under_full_strong_decay():
    """w_log = -20 at every step of two chunks: every factor is e^{<= 0}, so
    the outputs stay finite where the factoring through e^{-la} (-1280 a
    chunk) gives 0 x inf, and agree with the plain version."""
    b, h, s, d = 1, 2, 128, 64
    r, k, v, _, u, s0 = _inputs(b, h, s, d, seed=7)
    wl = np.full((b, s, h, d), -20.0, np.float32)
    ops = _torch((r, k, v, wl, u, s0), torch.float32)
    o, sf = scan.rwkv6_scan_subchunk(*ops)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    po, psf = scan.rwkv6_scan_plain(*ops)
    torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sf, psf, atol=STATE_TOL, rtol=STATE_TOL)


def test_subchunk_twin_state_carry():
    """Two calls with the state carried == one call, within the oracle's
    bound: the second call's chunks start at its first step, so its chunk
    boundaries (and sums) differ from the single call's."""
    b, h, s, d = 1, 2, 150, 64
    ops = _torch(_inputs(b, h, s, d, seed=9), torch.float32)
    r, k, v, wl, u, s0 = ops
    o, sf = scan.rwkv6_scan_subchunk(*ops)
    o1, st = scan.rwkv6_scan_subchunk(r[:, :70], k[:, :70], v[:, :70],
                                      wl[:, :70], u, s0)
    o2, s2 = scan.rwkv6_scan_subchunk(r[:, 70:], k[:, 70:], v[:, 70:],
                                      wl[:, 70:], u, st)
    assert _rel(torch.cat([o1, o2], 1), o) <= ORACLE_TOL[torch.float32]
    assert _rel(s2, sf) <= ORACLE_TOL[torch.float32]


def test_tf32_rounding_is_nearest_ties_away():
    """The twin's TF32 rounding is cvt.rna's (10 mantissa bits, to nearest,
    ties away from zero) for hi, and the tensor core's truncation for lo;
    hi + lo keeps ~20 bits."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12,
                      -(one + 2.0 ** -11), one + 3 * 2.0 ** -11,
                      0.0, 2.0 ** -20])
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10),
                         one + 2.0 ** -9, 0.0, 2.0 ** -20])
    assert torch.equal(scan._tf32(x), want)
    assert torch.equal(scan._tf32_trunc(torch.tensor([one + 3 * 2.0 ** -11])),
                       torch.tensor([one + 2.0 ** -10]))
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = scan._split(y)
    assert torch.equal(hi, scan._tf32(hi)) and torch.equal(lo,
                                                           scan._tf32(lo))
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -19
