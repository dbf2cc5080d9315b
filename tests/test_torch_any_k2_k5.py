"""The any-dims variants of K2 (``csrc/attention_any.cu``) and K5
(``csrc/rwkv6_scan_any.cu``) on the CPU: their plain twins, which follow
the kernels' roundings, against the JAX wrappers (Pallas in interpret
mode), at the dims the tests of ``test_torch_padding.py`` leave out.

* K2 at ragged head dims (bf16 260 and 264, f32 200) under ``sumi`` with
  ``q_offset``, and at head dims that take more than one head-dim pass on
  the card (bf16 600: three passes of at most 256 columns; f32 300: two):
  within 1e-5 of the output's scale for f32 operands (both sides f32
  throughout; the twin's split TF32 keeps ~2^-21 of each operand) and
  for bf16 5e-3 plus one bf16 ulp of the output (rtol 2^-7): P as bf16 hi
  + lo keeps ~2^-17 of a weight, so the two sides' f32 outputs differ by
  ~1e-6 and can round to bf16 one ulp apart, which past |x| = 2 is more
  than 5e-3 + 5e-3 |x|.
* K5 at head sizes 100 and 256, against JAX at the same tolerances; a
  sequence split in the middle of a chunk, the state carried, against the
  whole (within 1e-4 of the output's scale and STATE_TOL in the state: the
  chunk edges move, so la and the factored decays round elsewhere); runs
  of w_log = -20 at head size 128, finite and within 5e-4 of the output's
  scale of the plain version (``chip_smoke.py``'s K5_F32_TOL: the twin
  sums la in f32 step order as the kernel does, the plain version in f64,
  ~1e-4 of a decay apart at |la| ~ 1000).
* The twins' rounding helpers (``fused_ffn.ops._bf16_split``,
  ``_tf32_split``, ``_mm_any``; ``rwkv6_scan.ops._split``) against a
  direct computation in f64.

The kernels themselves against these twins: ``test_torch_any_k2_k5_cuda.py``
(``cuda``-marked) and ``chip_smoke.py``'s ``f2_phase``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.rwkv6_scan import ops as j_scan
from repro_torch.kernels import _any
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.fused_ffn import ops as ff
from repro_torch.kernels.rwkv6_scan import ops as scan

torch.set_num_threads(1)
F32_TOL = 1e-5
BF16_TOL = 5e-3
BF16_ULP = 2.0 ** -7
SPLIT_TOL = 1e-4
PLAIN_TOL = 5e-4
STATE_TOL = 1e-4
_DT = {"f32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dt):
    """The same values as a torch tensor and a jax array of ``dt``."""
    t, j = _DT[dt]
    return torch.from_numpy(a).to(t), jnp.asarray(a).astype(j)


def _close_dt(got, want, dt):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dt == "f32":
        tol = F32_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                                   rtol=BF16_ULP)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-6))


def _k2_case(dt, d, mode, sq, sk, **kw):
    rng = np.random.default_rng(d + sk)
    q, k, v = (_pair(_rand(rng, 2, sq, 4, d), dt),
               _pair(_rand(rng, 2, sk, 2, d), dt),
               _pair(_rand(rng, 2, sk, 2, d), dt))
    assert fa.route(d, q[0].dtype) == "any"
    want = j_fa.flash_attention(q[1], k[1], v[1], mode, **kw)
    got = fa.flash_attention(q[0], k[0], v[0], mode, **kw)
    assert got.shape == (2, sq, 4, d) and got.dtype == q[0].dtype
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d", [("bf16", 260), ("bf16", 264),
                                  ("f32", 200)])
def test_k2_any_ragged_dims_sumi_q_offset(dt, d):
    """Head dims off 16 (260: rows off 16-byte boundaries in bf16; 264,
    200: a ragged last slice) under sumi with 9 rows before the block."""
    _k2_case(dt, d, "sumi", 45, 54, n_history=30, q_offset=9)


@pytest.mark.parametrize("dt,d,mode", [("bf16", 600, "causal"),
                                       ("f32", 300, "full"),
                                       ("bf16", 600, "sliding")])
def test_k2_any_head_dim_passes(dt, d, mode):
    """Head dims whose output the card splits into passes (bf16 600:
    three of at most 256 columns; f32 300: two), each recomputing the
    scores: the twin's function is the whole head dim's."""
    _k2_case(dt, d, mode, 40, 40, window=16 if mode == "sliding" else 0)


def test_k2_any_twin_masked_rows_and_keys_exact():
    """A row that sees no key gives exact zeros, and a masked key's weight
    is an exact 0: keys no row sees change nothing, bitwise.  Under sumi
    with no history and q_offset 25, rows 0-4 (positions 25-29) see their
    own keys, rows 5-19 (positions 30-44, past the 30 keys) none."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rand(rng, 1, 20, 2, 300))
    k, v = (torch.from_numpy(_rand(rng, 1, 30, 1, 300)) for _ in range(2))
    got = fa.flash_attention(q, k, v, "sumi", n_history=0, q_offset=25)
    assert got[:, :5].abs().min() > 0 and not got[:, 5:].any()
    k2, v2 = k.clone(), v.clone()
    k2[:, :25], v2[:, :25] = 1e4, -1e4           # no row sees keys 0-24
    torch.testing.assert_close(
        fa.flash_attention(q, k2, v2, "sumi", n_history=0, q_offset=25),
        got, atol=0, rtol=0)


@pytest.mark.parametrize("dt,d,state", [("f32", 100, True),
                                        ("bf16", 100, False),
                                        ("f32", 256, True)])
def test_k5_any_head_sizes(dt, d, state):
    rng = np.random.default_rng(d + 1)
    b, s, h = 1, 70, 2
    r, k, v = (_pair(_rand(rng, b, s, h, d, scale=0.5), dt)
               for _ in range(3))
    w_log = -np.exp(_rand(rng, b, s, h, d))
    u = _rand(rng, h, d, scale=0.5)
    st = _rand(rng, b, h, d, d, scale=0.1) if state else None
    assert scan.route(d) == "any"
    jo, jsf = j_scan.rwkv6_scan(r[1], k[1], v[1], jnp.asarray(w_log),
                                jnp.asarray(u),
                                None if st is None else jnp.asarray(st))
    o, sf = scan.rwkv6_scan(r[0], k[0], v[0], torch.from_numpy(w_log),
                            torch.from_numpy(u),
                            None if st is None else torch.from_numpy(st))
    assert o.shape == (b, s, h, d) and sf.shape == (b, h, d, d)
    _close_dt(o, jo, dt)
    _close_dt(sf, jsf, "f32")


def _k5_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(_rand(rng, b, s, h, d, scale=0.5))
               for _ in range(3))
    w = torch.from_numpy(-np.exp(_rand(rng, b, s, h, d)))
    w[:, 10:30] = -20.0
    u = torch.from_numpy(_rand(rng, h, d, scale=0.5))
    st = torch.from_numpy(_rand(rng, b, h, d, d, scale=0.1))
    return r, k, v, w, u, st


def test_k5_any_split_mid_chunk_carries_state():
    """Steps 0-36 and then 37-99 with the state carried == steps 0-99 (the
    split falls inside the first 64-step chunk)."""
    r, k, v, w, u, st = _k5_inputs(5, 2, 100, 2, 128)
    o, sf = scan.rwkv6_scan(r, k, v, w, u, st)
    cut = 37
    o1, s1 = scan.rwkv6_scan(r[:, :cut], k[:, :cut], v[:, :cut],
                             w[:, :cut], u, st)
    o2, s2 = scan.rwkv6_scan(r[:, cut:], k[:, cut:], v[:, cut:],
                             w[:, cut:], u, s1)
    assert _rel(torch.cat([o1, o2], 1), o) <= SPLIT_TOL
    torch.testing.assert_close(s2, sf, atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("everywhere", [False, True])
def test_k5_any_finite_under_strong_decay(everywhere):
    """w_log = -20 (runs of it, or every step) at head size 128: a chunk's
    decay reaches -1280, where a factoring through e^{-la} gives 0 x inf."""
    r, k, v, w, u, st = _k5_inputs(6, 1, 130, 2, 128)
    if everywhere:
        w = torch.full_like(w, -20.0)
    o, sf = scan.rwkv6_scan(r, k, v, w, u, st)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    po, psf = scan.rwkv6_scan_plain(r, k, v, w, u, st)
    assert _rel(o, po) <= PLAIN_TOL
    torch.testing.assert_close(sf, psf, atol=STATE_TOL, rtol=STATE_TOL)


def test_twin_rounding_helpers_match_direct_computation():
    """The roundings the twins share with the kernels, held to f64: bf16
    hi + lo keeps x to 2^-16 of |x|; TF32 hi (10-bit mantissa, nearest)
    and lo (the remainder as the tensor core reads it) to 2^-21; ``_mm_any``
    to the f64 product within those roundings summed over k."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, 4096) * 10.0 ** rng.integers(
        -6, 6, 4096).astype(np.float32))
    x64 = x.double()
    hi, lo = ff._bf16_split(x)
    assert torch.equal(hi, x.bfloat16().float())
    assert torch.equal(lo, (x - hi).bfloat16().float())
    assert ((hi.double() + lo.double() - x64).abs()
            <= 2.0 ** -16 * x64.abs()).all()
    th, tl = scan._split(x)
    bits = th.view(torch.int32)
    assert not (bits & 0x1FFF).any() and not (tl.view(torch.int32)
                                               & 0x1FFF).any()
    assert ((th.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((th.double() + tl.double() - x64).abs()
            <= 2.0 ** -21 * x64.abs()).all()
    th2, tl2 = ff._tf32_split(x)
    assert torch.equal(th2, th) and torch.equal(tl2, tl)
    a = torch.from_numpy(_rand(rng, 16, 300))
    b = torch.from_numpy(_rand(rng, 300, 24))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    got = ff._mm_any(a, b, torch.float32).double()
    assert ((got - exact).abs() <= 2.0 ** -19 * scale + 1e-9).all()
    p = torch.rand(16, 300, dtype=torch.float64).float()
    vb = b.bfloat16().float()
    got = ff._mm_any(p, vb, torch.bfloat16).double()
    exact = p.double() @ vb.double()
    assert ((got - exact).abs()
            <= 2.0 ** -15 * (p.double() @ vb.double().abs())).all()


def test_k2_any_twin_against_direct_softmax():
    """``_any.attention_tiled`` (f32 operands, several key tiles, masked
    keys) against the softmax computed at once in f64."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_rand(rng, 3, 20, 40))
    k, v = (torch.from_numpy(_rand(rng, 3, 150, 40)) for _ in range(2))
    ok = torch.from_numpy(rng.random((3, 20, 150)) < 0.7)
    ok[0, 3] = False                              # a row that sees nothing
    scale = 40 ** -0.5
    got = _any.attention_tiled(q, k, v, ok, scale=scale, dtype=torch.float32)
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    want = p @ v.double()
    assert not got[0, 3].any()
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
