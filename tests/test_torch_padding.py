"""The kernel wrappers at the text models' shapes, on the CPU, against the
JAX wrappers (their Pallas kernels in interpret mode).

The port's kernels are instantiated for a few head dims; a wrapper runs any
other head dim padded to the next one with zeros and the softmax scale of
the unpadded dim (K1, K2, K4), or the RWKV state padded with zero rows and
columns (K5).  Each helper here wraps the plain version, as the CUDA launch
is wrapped on the card; the tests hold it to the JAX wrapper at small S and
T.  K3 takes model dims past 256 in its wide form; its plain version is
held to the JAX wrapper at d 3840, and its launch plan is checked.  Tolerance:
the kernel paths' 5e-3 (f32 inputs; ROADMAP.md's numeric contract).

Past the tiled kernels' dims the wrappers pick the any-dims variants (K2:
``csrc/attention_any.cu``; K4's split decode: ``csrc/decode_any.cu``; K3:
``csrc/ffn_any.cu``; K5: ``csrc/rwkv6_scan_any.cu``) from the dims; on CPU
tensors they run the variants' plain twins (K4's with its splits of 64
positions and ordered merge, K3's with its slices, chunks and split-TF32 /
bf16 hi + lo operands), held here to the JAX wrappers (interpret mode) at
the card check's dims, cut to small S and T: within 1e-5 for f32 operands
(both sides f32 throughout; scaled by the output's size past 1) and 5e-3
for bf16 operands (the port's bf16 tolerance; the two sides round q's
scaling and the output to bf16 at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.flash_decode import ops as j_fd
from repro.kernels.fused_score import ops as j_fs
from repro.kernels.fused_ffn import ops as j_ff
from repro.kernels.rwkv6_scan import ops as j_scan
from repro_torch.kernels import _any
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.fused_ffn import ops as ff
from repro_torch.kernels.fused_score import ops as fs
from repro_torch.kernels.padding import pad_last, padded_dim
from repro_torch.kernels.rwkv6_scan import ops as scan

torch.set_num_threads(1)
KERNEL_TOL = 5e-3
F32_TOL = 1e-5
BF16_TOL = 5e-3


def _close(got, want, tol=KERNEL_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_padded_dim_rounds_up_and_refuses_past_the_largest():
    """The padding helper refuses past the largest instantiation; the
    wrappers never reach it there: at those dims they route to the
    any-dims variants."""
    assert padded_dim(120, fa.HEAD_DIMS) == 128
    assert padded_dim(240, fa.HEAD_DIMS) == 256
    assert padded_dim(48, scan.HEAD_DIMS, "head size") == 64
    assert padded_dim(64, fd.HEAD_DIMS) == 64
    with pytest.raises(ValueError, match="exceeds"):
        padded_dim(300, fd.HEAD_DIMS)
    with pytest.raises(ValueError, match="head size 80"):
        padded_dim(80, scan.HEAD_DIMS, "head size")
    assert fd.route(300, 1, torch.bfloat16) == "any"
    assert fd.route(240, 4, torch.bfloat16) == "tiled"
    assert scan.route(80) == "any" and scan.route(48) == "tiled"
    rng = np.random.default_rng(300)
    q, kc = _rand(rng, 2, 2, 300), _rand(rng, 2, 9, 1, 300)
    out = fd.flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                          torch.from_numpy(kc),
                          torch.tensor([9, 4], dtype=torch.int32))
    assert out.shape == (2, 2, 300) and torch.isfinite(out).all()
    r = torch.from_numpy(_rand(rng, 1, 9, 1, 80))
    o, sf = scan.rwkv6_scan(r, r, r, -r.abs(), r[0, 0])
    assert o.shape == (1, 9, 1, 80) and sf.shape == (1, 1, 80, 80)
    t = torch.ones(2, 3)
    assert pad_last(t, 3) is t
    assert torch.equal(pad_last(t, 5)[:, 3:], torch.zeros(2, 2))


def _fa_plain(q, k, v, mode, *, window, n_history, q_offset, scale):
    return fa.flash_attention_plain(q, k, v, mode, window=window,
                                    n_history=n_history, q_offset=q_offset,
                                    scale=scale)


@pytest.mark.parametrize("d", [120, 240])
@pytest.mark.parametrize("mode,window", [("sliding", 16), ("causal", 0)])
def test_k2_padding_matches_jax_wrapper(d, mode, window):
    rng = np.random.default_rng(d)
    q, k, v = (_rand(rng, 1, 40, 4, d), _rand(rng, 1, 40, 2, d),
               _rand(rng, 1, 40, 2, d))
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mode, window=window)
    got = fa.flash_attention_padded(torch.from_numpy(q),
                                    torch.from_numpy(k),
                                    torch.from_numpy(v), mode,
                                    window=window, run=_fa_plain)
    assert got.shape == (1, 40, 4, d)
    _close(got, want)


def _fs_plain(q, kh, vh, kc, vc, mode, ks, vs, row_index, lengths, *,
              scale):
    return fs.fused_score_plain(q, kh, vh, kc, vc, mode=mode, k_scale=ks,
                                v_scale=vs, row_index=row_index,
                                lengths=lengths, scale=scale)


@pytest.mark.parametrize("d", [24, 40])
@pytest.mark.parametrize("mode,hist", [("cached", "int8"),
                                       ("cached", "native"),
                                       ("extend", "int8")])
def test_k1_padding_matches_jax_wrapper(d, mode, hist):
    """K1 at head dims between its instantiations (24 and 40: Climber at
    d_model 96 or 160 over 4 heads) padded to 32 / 64, against the JAX
    wrapper, which pads D to its 128 lanes (kernel in interpret mode);
    int8 history codes padded with zero codes, a dedup row index."""
    rng = np.random.default_rng(d)
    m = 5
    q = _rand(rng, 2, m, 4, d)
    kc, vc = _rand(rng, 2, m, 2, d), _rand(rng, 2, m, 2, d)
    kh, vh = _rand(rng, 3, 20, 2, d), _rand(rng, 3, 20, 2, d)
    kw_j, kw_t = {}, {}
    if hist == "int8":
        scales = []
        for a in (kh, vh):
            sc = np.abs(a).max(axis=(1, 3), keepdims=True)
            scales.append(sc.astype(np.float32))
        kh, vh = (np.round(a / sc * 127).astype(np.int8)
                  for a, sc in zip((kh, vh), scales))
        kw_j = dict(k_scale=jnp.asarray(scales[0]),
                    v_scale=jnp.asarray(scales[1]))
        kw_t = dict(k_scale=fs._norm_scale(torch.from_numpy(scales[0]), 3, 2),
                    v_scale=fs._norm_scale(torch.from_numpy(scales[1]), 3, 2))
    idx = np.array([2, 0], np.int32)
    jfn = j_fs.fused_cached_attention if mode == "cached" \
        else j_fs.fused_extend_attention
    want = jfn(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh),
               jnp.asarray(kc), jnp.asarray(vc), row_index=jnp.asarray(idx),
               path="kernel", interpret=True, **kw_j)
    got = fs.fused_score_padded(
        *(torch.from_numpy(a) for a in (q, kh, vh, kc, vc)), mode=mode,
        row_index=torch.from_numpy(idx), run=_fs_plain, **kw_t)
    assert got.shape == (2, m, 4, d)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("d,h", [(120, 8), (240, 4)])
def test_k4_padding_matches_jax_wrapper(d, h):
    rng = np.random.default_rng(d)
    q = _rand(rng, 3, h, d)
    kc, vc = _rand(rng, 3, 50, 2, d), _rand(rng, 3, 50, 2, d)
    lens = np.array([50, 17, 1], np.int32)
    want = j_fd.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.asarray(lens))
    got = fd.flash_decode_padded(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens), run=lambda q, k, v, l, window:
        fd.flash_decode_plain(q, k, v, l, window=window, prescaled=True))
    assert got.shape == (3, h, d)
    _close(got, want)


def test_k5_padding_matches_jax_wrapper_and_keeps_padding_zero():
    rng = np.random.default_rng(48)
    b, s, h, d = 2, 70, 2, 48
    r, k, v = (_rand(rng, b, s, h, d, scale=0.5) for _ in range(3))
    w_log = -np.exp(_rand(rng, b, s, h, d))
    u = _rand(rng, h, d, scale=0.5)
    st = _rand(rng, b, h, d, d, scale=0.1)
    jo, jsf = j_scan.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w_log,
                                                           u, st)))
    seen = {}

    def plain(*args):
        seen["args"] = args
        out = scan.rwkv6_scan_plain(*args)
        seen["state"] = out[1]
        return out
    o, sf = scan.rwkv6_scan_padded(*(torch.from_numpy(a) for a in (
        r, k, v, w_log, u, st)), run=plain)
    assert o.shape == (b, s, h, d) and sf.shape == (b, h, d, d)
    assert seen["args"][0].shape[-1] == 64
    pad = seen["state"]
    assert not pad[..., d:, :].any() and not pad[..., :, d:].any()
    _close(o, jo)
    _close(sf, jsf)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_k3_wide_slicing_matches_jax_wrapper(act):
    """d 3840 (the wide form's width) with d_ff 384: the plain version,
    which the wide form's CUDA kernel is held to on the card, against the
    JAX kernel (three d_ff blocks of 128) at T = 5."""
    rng = np.random.default_rng(3840)
    t, d, f = 5, 3840, 384
    x = _rand(rng, t, d)
    wu, wg = _rand(rng, d, f, scale=d ** -0.5), _rand(rng, d, f,
                                                      scale=d ** -0.5)
    wd = _rand(rng, f, d, scale=f ** -0.5)
    wg = wg if act == "swiglu" else None
    want = j_ff.fused_ffn_2d(jnp.asarray(x), jnp.asarray(wu),
                             jnp.asarray(wd),
                             None if wg is None else jnp.asarray(wg),
                             activation=act, bf=128)
    got = ff.fused_ffn_plain(torch.from_numpy(x), torch.from_numpy(wu),
                             torch.from_numpy(wd),
                             None if wg is None else torch.from_numpy(wg),
                             activation=act)
    _close(got, want)


def test_k3_wide_plan_follows_t():
    """The path follows T alone: the decode path (16-row CTAs over slices of
    WIDE_SLICE d_ff columns, at least one CTA an SM of an H100 at the text
    models' d_ff) up to WIDE_DECODE_T rows, the prefill GEMMs past it; two
    kernels a launch of at most WIDE_ROWS rows (three on the prefill path
    with the norm pre-pass)."""
    assert ff.WIDE_DECODE_T == 32 and ff.WIDE_SLICE == 64
    for t in (1, 4, 16, ff.WIDE_DECODE_T):
        for f in (10240, 15360):
            p = ff.wide_plan(t, f)
            assert p.path == "decode" and p.rows == 16 and p.tiles >= 132
    assert ff.wide_plan(4, 15360).tiles == 240
    assert ff.wide_plan(1, 10240).tiles == 160
    assert ff.wide_plan(ff.WIDE_DECODE_T, 10240).tiles == 2 * 160
    for t in (ff.WIDE_DECODE_T + 1, 300, 2000, ff.WIDE_ROWS):
        p = ff.wide_plan(t, 15360)
        assert p.path == "prefill" and p.rows == 128
        assert p.tiles == -(-t // 128)
    ts = (0, 1, ff.WIDE_DECODE_T, ff.WIDE_DECODE_T + 1, ff.WIDE_ROWS,
          ff.WIDE_ROWS + 1)
    bf16 = dict(f=15360, dtype=torch.bfloat16)
    assert [ff.kernel_launches(t, 3840, **bf16) for t in ts] == [
        0, 2, 2, 2, 2, 4]
    assert [ff.kernel_launches(t, 3840, norm=True, **bf16) for t in ts] == [
        0, 2, 2, 3, 3, 5]
    assert ff.kernel_launches(1028, 256, **bf16) == 1
    assert ff.kernel_launches(1028, 256, norm=True, **bf16) == 1


def test_k3_wide_workspace_bytes():
    """The workspace one wide call allocates: the prefill path's hidden
    planes (4 bytes an element) at most 130 MB at gemma3-12b's T 2000 (126
    MB for a launch of WIDE_ROWS rows), the decode path's partials at T 4
    15 MB, and at every T under the old form's bound, ceil(d_ff / 512)
    slices x WIDE_ROWS x d floats (944 MB at d 3840, d_ff 15360)."""
    d, f = 3840, 15360
    assert ff.wide_workspace_bytes(2000, d, f) == 2000 * f * 4 <= 130e6
    assert ff.wide_workspace_bytes(ff.WIDE_ROWS, d, f) == ff.WIDE_ROWS * f * 4
    assert ff.wide_workspace_bytes(4, d, f) == 240 * 4 * d * 4
    assert ff.wide_workspace_bytes(4, d, 10240) == 160 * 4 * d * 4
    assert ff.wide_workspace_bytes(300, d, f, norm=True) == 300 * (f + d) * 4
    assert ff.wide_workspace_bytes(0, d, f) == 0
    old = -(-f // 512) * 2048 * d * 4
    for t in list(range(1, 200)) + [300, 1100, 2000, 2048, 2049, 4096, 32768]:
        for act_f in (10240, 15360):
            for norm in (False, True):
                assert ff.wide_workspace_bytes(t, d, act_f, norm) < old


# ---------------------------------------------------------------------------
# the any-dims variants' plain twins against the JAX wrappers
# ---------------------------------------------------------------------------

_DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}


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
                                   rtol=BF16_TOL)


@pytest.mark.parametrize("dt,d,mode,window,q_offset", [
    ("bf16", 320, "causal", 0, 0), ("bf16", 320, "sliding", 16, 0),
    ("bf16", 512, "causal", 0, 0), ("bf16", 512, "sliding", 16, 0),
    ("f32", 256, "causal", 0, 0), ("f32", 256, "sliding", 16, 0),
    ("f32", 256, "full", 0, 0), ("f32", 256, "sumi", 0, 0),
    ("bf16", 320, "causal", 0, 9), ("f32", 200, "sumi", 0, 6)])
def test_k2_any_twin_matches_jax_wrapper(dt, d, mode, window, q_offset):
    rng = np.random.default_rng(d + q_offset)
    sq, sk = 37, 37 + q_offset
    q, k, v = (_pair(_rand(rng, 2, sq, 4, d), dt),
               _pair(_rand(rng, 2, sk, 2, d), dt),
               _pair(_rand(rng, 2, sk, 2, d), dt))
    kw = dict(window=window, n_history=24, q_offset=q_offset)
    assert fa.route(d, q[0].dtype) == "any"
    want = j_fa.flash_attention(q[1], k[1], v[1], mode, **kw)
    got = fa.flash_attention(q[0], k[0], v[0], mode, **kw)
    assert got.shape == (2, sq, 4, d) and got.dtype == q[0].dtype
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d,h,hkv,window", [
    ("bf16", 512, 4, 2, 0), ("bf16", 512, 4, 2, 16), ("bf16", 256, 16, 2, 0),
    ("f32", 256, 4, 2, 0), ("f32", 64, 40, 2, 16)])
def test_k4_any_twin_matches_jax_wrapper(dt, d, h, hkv, window):
    rng = np.random.default_rng(d + h)
    q = _pair(_rand(rng, 3, h, d), dt)
    kc, vc = (_pair(_rand(rng, 3, 70, hkv, d), dt) for _ in range(2))
    lens = np.array([70, 33, 1], np.int32)
    assert fd.route(d, h // hkv, q[0].dtype) == "any"
    want = j_fd.flash_decode(q[1], kc[1], vc[1], jnp.asarray(lens),
                             window=window)
    got = fd.flash_decode(q[0], kc[0], vc[0], torch.from_numpy(lens),
                          window=window)
    assert got.shape == (3, h, d) and got.dtype == q[0].dtype
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d,packed", [("f32", 256, False),
                                         ("f32", 192, True),
                                         ("bf16", 256, True)])
def test_k4_self_any_twin_matches_jax_route(dt, d, packed):
    """The self-slot form past head dim 128 against the JAX package's
    kernel route for it (each candidate's K/V written into a copy of its
    cache row, then ``flash_decode``; ``core/sumi.py``)."""
    from repro.core.sumi import _kernel_decode_attention
    rng = np.random.default_rng(d)
    b, m, h, hkv, s = 2, 5, 4, 2, 20
    q = _pair(_rand(rng, b, m, h, d), dt)
    ks, vs = (_pair(_rand(rng, b, m, hkv, d), dt) for _ in range(2))
    rows = np.array([[0, 1, 2, 1, 0], [2, 2, 1, 0, 1]] if packed
                    else [[0] * m, [1] * m])
    u = 3 if packed else b
    kc, vc = (_pair(_rand(rng, u, s, hkv, d), dt) for _ in range(2))
    lens = np.array([20, 7, 0][:u], np.int32)
    assert fd.route_self(d) == "any"
    want = _kernel_decode_attention(
        q[1], kc[1][rows], vc[1][rows], ks[1], vs[1],
        jnp.asarray(lens[rows]))
    if packed:
        got = fd.flash_decode_with_self(
            q[0], kc[0], vc[0], torch.from_numpy(lens), ks[0], vs[0],
            row_index=torch.from_numpy(rows.astype(np.int32)))
    else:
        got = fd.flash_decode_with_self(q[0], kc[0], vc[0],
                                        torch.from_numpy(lens), ks[0], vs[0])
    assert got.shape == (b, m, h, d)
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d,f,act,t,norm", [
    ("f32", 1024, 4096, "gelu", 4, True), ("f32", 1024, 4096, "gelu", 40,
                                           False),
    ("f32", 96, 200, "swiglu", 13, True), ("bf16", 100, 260, "swiglu", 9,
                                           True),
    ("bf16", 96, 203, "relu", 20, False),
    ("f32", 96, 200, "gelu", 1, True), ("f32", 96, 200, "gelu", 1, False),
    ("f32", 100, 520, "swiglu", 64, True),
    ("f32", 100, 520, "swiglu", 64, False),
    ("f32", 72, 300, "relu", 200, True), ("f32", 72, 300, "relu", 200, False),
    ("f32", 48, 3000, "gelu", 1000, True),
    ("bf16", 1023, 257, "swiglu", 9, True),
    ("bf16", 1023, 257, "gelu", 70, False)])
def test_k3_any_twin_matches_jax_wrapper(dt, d, f, act, t, norm):
    """The twin's slices, chunks and operand roundings (split TF32 for
    f32, bf16 hi + lo for bf16, at 2-byte-aligned rows too) against the
    JAX wrapper; at T 1000, d_ff 3000 a slice holds two chunks."""
    rng = np.random.default_rng(d + f + t)
    x = _pair(_rand(rng, t, d), dt)
    wu = _pair(_rand(rng, d, f, scale=d ** -0.5), dt)
    wd = _pair(_rand(rng, f, d, scale=f ** -0.5), dt)
    wg = _pair(_rand(rng, d, f, scale=d ** -0.5), dt) if act == "swiglu" \
        else (None, None)
    ns = _pair(_rand(rng, d, scale=0.1), dt) if norm else (None, None)
    assert ff.route(d, f, x[0].dtype) == "any"
    want = j_ff.fused_ffn_2d(x[1], wu[1], wd[1], wg[1], ns[1],
                             activation=act, interpret=True)
    got = ff.fused_ffn_2d(x[0], wu[0], wd[0], wg[0], ns[0], activation=act)
    assert got.shape == (t, d) and got.dtype == x[0].dtype
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d,h,hkv,window", [
    ("bf16", 512, 8, 2, 0), ("f32", 256, 8, 2, 100), ("bf16", 64, 40, 2, 0),
    ("f32", 64, 40, 2, 70)])
def test_k4_any_split_twin_long_cache(dt, d, h, hkv, window):
    """Five splits of 64 positions, lengths 0, 1 and S, G 4 and G 20; a
    window of 100 (70) at length 300 empties the leading splits."""
    rng = np.random.default_rng(d + h + window)
    s = 300
    q = _pair(_rand(rng, 3, h, d), dt)
    kc, vc = (_pair(_rand(rng, 3, s, hkv, d), dt) for _ in range(2))
    lens = np.array([0, 1, s], np.int32)
    assert fd.route(d, h // hkv, q[0].dtype) == "any"
    assert -(-s // _any.SPLIT) == 5
    want = j_fd.flash_decode(q[1], kc[1], vc[1], jnp.asarray(lens),
                             window=window)
    got = fd.flash_decode(q[0], kc[0], vc[0], torch.from_numpy(lens),
                          window=window)
    assert got.shape == (3, h, d) and got.dtype == q[0].dtype
    assert not got[0].any()                      # length 0: zeros
    _close_dt(got, want, dt)


@pytest.mark.parametrize("dt,d", [("bf16", 256), ("f32", 192)])
def test_k4_self_any_split_packed_three_rows(dt, d):
    """A packed row_index whose candidates point at three cache rows of
    lengths S, 0 and 1 (four splits), against the JAX package's route."""
    from repro.core.sumi import _kernel_decode_attention
    rng = np.random.default_rng(d + 3)
    b, m, h, hkv, s = 2, 6, 4, 2, 200
    q = _pair(_rand(rng, b, m, h, d), dt)
    ks, vs = (_pair(_rand(rng, b, m, hkv, d), dt) for _ in range(2))
    rows = np.array([[0, 1, 2, 1, 0, 2], [2, 2, 1, 0, 1, 0]])
    kc, vc = (_pair(_rand(rng, 3, s, hkv, d), dt) for _ in range(2))
    lens = np.array([s, 0, 1], np.int32)
    assert -(-s // _any.SPLIT) == 4
    want = _kernel_decode_attention(
        q[1], kc[1][rows], vc[1][rows], ks[1], vs[1],
        jnp.asarray(lens[rows]))
    got = fd.flash_decode_with_self(
        q[0], kc[0], vc[0], torch.from_numpy(lens), ks[0], vs[0],
        row_index=torch.from_numpy(rows.astype(np.int32)))
    assert got.shape == (b, m, h, d)
    _close_dt(got, want, dt)


@pytest.mark.parametrize("form", ["single-token", "self-slot"])
def test_k4_any_twin_padded_cache_is_bitwise_tight(form):
    """A cache padded past ``lengths`` (with NaN) decodes bitwise like the
    tight one: the padding's splits are empty and skipped exactly."""
    rng = np.random.default_rng(7)
    b, m, h, hkv, d, s, pad = 3, 4, 8, 2, 256, 130, 170
    lens = torch.tensor([130, 65, 0], dtype=torch.int32)
    kc, vc = (torch.from_numpy(_rand(rng, b, s, hkv, d)) for _ in range(2))
    kp, vp = (torch.cat([c, torch.full((b, pad, hkv, d), float("nan"))], 1)
              for c in (kc, vc))
    if form == "single-token":
        q = torch.from_numpy(_rand(rng, b, h, d))
        assert fd.route(d, h // hkv, q.dtype) == "any"
        tight = fd.flash_decode(q, kc, vc, lens, window=100)
        padded = fd.flash_decode(q, kp, vp, lens, window=100)
    else:
        q = torch.from_numpy(_rand(rng, b, m, h, d)).bfloat16()
        ks, vs = (torch.from_numpy(_rand(rng, b, m, hkv, d)).bfloat16()
                  for _ in range(2))
        assert fd.route_self(d) == "any"
        tight = fd.flash_decode_with_self(q, kc.bfloat16(), vc.bfloat16(),
                                          lens, ks, vs)
        padded = fd.flash_decode_with_self(q, kp.bfloat16(), vp.bfloat16(),
                                           lens, ks, vs)
    assert torch.isfinite(tight.float()).all()
    assert torch.equal(tight, padded)


def test_k3_any_slices_and_rows_follow_t():
    """Rows a CTA by T (16 up to 64 rows, then 64), slices from the CTA
    target, chunks of 256 inside a slice; the f32 twin's products are the
    split-TF32 ones (not a plain f32 product)."""
    assert ff.any_rows(64) == 16 and ff.any_rows(65) == 64
    assert ff.any_slice_cols(4, 4096) == 32           # 128 CTAs
    assert ff.any_slice_cols(64, 4100) == 64          # 4 x 65 CTAs
    assert ff.any_slice_cols(512, 4096) == 256        # 8 x 16 CTAs
    assert ff.any_slice_cols(1000, 3000) == 352       # two chunks a slice
    assert ff.any_slice_cols(8192, 4096) == 2048      # 128 x 2 CTAs
    assert ff.any_slice_cols(16384, 4096) == 4096     # one slice
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_rand(rng, 8, 64))
    b = torch.from_numpy(_rand(rng, 64, 16))
    got = ff._mm_any(a, b, torch.float32)
    assert not torch.equal(got, a @ b)
    np.testing.assert_allclose(got.numpy(), (a.double() @ b.double()).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [64, 65, 128])
def test_k4_any_twin_split_edges(s):
    """Caches that end on a split's edge or one past it, with lengths on
    and beside the edges (the last split full, holding one key, or
    empty), against the JAX wrapper."""
    rng = np.random.default_rng(s)
    b, h, hkv, d = 4, 8, 2, 320
    q = _pair(_rand(rng, b, h, d), "f32")
    kc, vc = (_pair(_rand(rng, b, s, hkv, d), "f32") for _ in range(2))
    lens = np.array([s, 64, 63, 1], np.int32)
    assert fd.route(d, h // hkv, q[0].dtype) == "any"
    want = j_fd.flash_decode(q[1], kc[1], vc[1], jnp.asarray(lens))
    got = fd.flash_decode(q[0], kc[0], vc[0], torch.from_numpy(lens))
    _close_dt(got, want, "f32")


@pytest.mark.parametrize("dt,d,state", [("f32", 128, True),
                                        ("f32", 96, False),
                                        ("bf16", 128, True)])
def test_k5_any_twin_matches_jax_wrapper(dt, d, state):
    rng = np.random.default_rng(d)
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
