"""The any-dims kernels of K2 (``csrc/attention_any.cu``) and K5
(``csrc/rwkv6_scan_any.cu``) on the card against their plain twins
(``flash_attention_any_plain``; ``rwkv6_scan_subchunk`` with its la summed
in step order), bitwise across two calls, one launch a call as ``plan()``
says, and K5's rows alone bitwise the same rows inside a batch.  They need
an NVIDIA GPU and skip without one.  Tolerances: K2 f32 1e-5 (the
any-dims twins' f32 tolerance), bf16 ``chip_smoke.close``'s 1e-3 + 1.6e-2
|x| (two bf16 ulps); K5 chip_smoke's K5_F32_TOL /
K5_BF16_TOL of the output's scale (5e-4 / 8e-3) and K5_F32_TOL in the
state.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rwkv6_scan import ops as scan

F32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 1e-3, 1.6e-2
K5_TOL = {torch.float32: 5e-4, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,mode,kw", [
    (torch.bfloat16, 320, "causal", {}),
    (torch.bfloat16, 260, "sumi", dict(n_history=40, q_offset=9)),
    (torch.bfloat16, 600, "sliding", dict(window=33)),
    (torch.float32, 200, "sumi", dict(n_history=50, q_offset=6)),
    (torch.float32, 300, "full", {})])
def test_k2_any_kernel_vs_twin(cuda_device, dtype, d, mode, kw):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    sq = 100
    sk = sq + kw.get("q_offset", 0)
    q, k, v = (torch.randn(2, n, hh, d, generator=g, device=cuda_device)
               .to(dtype) for n, hh in ((sq, 4), (sk, 2), (sk, 2)))
    assert fa.route(d, dtype) == "any"
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mode, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == fa.plan(q)["launches"]
    assert torch.equal(fa.flash_attention(q, k, v, mode, **kw), got)
    want = fa.flash_attention_any_plain(q, k, v, mode, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 100),
                                     (torch.bfloat16, 256)])
def test_k5_any_kernel_vs_twin(cuda_device, dtype, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, s, h = 3, 150, 2
    r, k, v = (0.5 * torch.randn(b, s, h, d, generator=g, device=cuda_device)
               for _ in range(3))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    wl = -torch.exp(torch.randn(b, s, h, d, generator=g, device=cuda_device))
    wl[:, 20:60] = -20.0
    u = 0.5 * torch.randn(h, d, generator=g, device=cuda_device)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=cuda_device)
    assert scan.route(d) == "any"
    before = scan.rwkv6_scan.launches
    o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
    torch.cuda.synchronize()
    assert scan.rwkv6_scan.launches - before == scan.plan(r)["launches"]
    assert torch.isfinite(o.float()).all() and torch.isfinite(sf).all()
    o2, sf2 = scan.rwkv6_scan(r, k, v, wl, u, s0)
    assert torch.equal(o2, o) and torch.equal(sf2, sf)
    po, psf = scan.rwkv6_scan_subchunk(r, k, v, wl, u, s0, steps=True)
    assert _rel(o, po) <= K5_TOL[dtype]
    assert _rel(sf, psf) <= K5_TOL[torch.float32]
    # a row alone (another column split) == the row inside the batch
    oa, sfa = scan.rwkv6_scan(r[1:2], k[1:2], v[1:2], wl[1:2], u, s0[1:2])
    assert torch.equal(oa, o[1:2]) and torch.equal(sfa, sf[1:2])
