"""Parity of the port's RWKV-6 pieces with the JAX package.

Kernel K5 (``repro_torch.kernels.rwkv6_scan``): on the CPU its wrapper runs
the plain version (the chunked formulation), held to the JAX Pallas kernel
in interpret mode and to the token-by-token oracle at 2e-3, the JAX test's
own bound (``tests/test_kernels.py``: the chunked sums reassociate the
recurrence), and to JAX ``wkv_chunked`` at 1e-5 relative to scale (the same
chunked arithmetic in f32; 1e-4 under strong decay).  The model pieces
(``models/rwkv6.py``) and the reduced rwkv6-7b bundle are held to JAX in
f32 within 1e-5 and 1e-4 (one layer's f32 ops, and two layers of them), and
at bf16 weights within 2e-2 relative to the logits' scale (one-ulp rounding
flips compounding; the 5e-3 of the port's numeric contract is not met
there, ROADMAP.md Queue 3).  Inputs are made from a numpy seed and handed
to both packages; the CUDA kernel itself is held to the plain version by
the ``cuda``-marked test (and by ``chip_smoke.py`` on the GPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.kernels.rwkv6_scan import ops as j_scan_ops
from repro.kernels.rwkv6_scan import ref as j_scan_ref
from repro.models import rwkv6 as JR
from repro.models.model import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.kernels.rwkv6_scan import ops as scan
from repro_torch.kernels.rwkv6_scan import ref as scan_ref
from repro_torch.models import rwkv6 as R
from repro_torch.models.model import build_model
from repro_torch.tree import leaves, params_from_jax

torch.set_num_threads(1)
SCAN_TOL = 2e-3      # chunked vs token-by-token (tests/test_kernels.py)
F32_TOL = 1e-5       # the same f32 arithmetic in both packages
# strong decay: exponents are differences of cumulative sums reaching ~1280
# in magnitude, whose f32 spacing is ~1e-4; torch and XLA sum in other orders
STRONG_TOL = 1e-4
MODEL_TOL = 1e-4     # two layers of f32 ops, reduced bundle
# bf16 weights, relative to the logits' scale: both packages round every
# projection and mixed stream to bf16, and their f32 sums before the rounding
# run in other orders, so 0.01-3% of each op's outputs differ by one bf16
# ulp and the flips compound over two layers (measured 1.8e-2 at the logits,
# 6e-3 on average; the Climber bundle's bf16 bound in test_torch_climber.py)
BF16_TOL = 2e-2

# f32 pieces run jitted (eager JAX dispatches op by op and takes seconds)
J_TIME_MIX = jax.jit(JR.time_mix, static_argnames=("cfg", "decode"))

RWKV_CASES = [(2, 2, 128, 64, 32), (1, 4, 100, 64, 64), (2, 1, 256, 32, 64),
              (1, 2, 64, 64, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(t, j):
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float32)
    return float(np.abs(t - j).max() / max(1e-6, np.abs(j).max()))


def _scan_inputs(b, h, s, d, seed, strong=False):
    """r, k, v, w_log [B,S,H,D] and u [H,D] as numpy f32.  ``strong`` puts
    runs of the clip value -20 into w_log (a chunk's decay reaches -1280,
    where a factored intra-chunk form would overflow)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    wl = -np.exp(rng.standard_normal((b, s, h, d))).astype(np.float32)
    if strong:
        wl = np.clip(-np.exp(rng.uniform(np.log(1e-4), np.log(20.0),
                                         (b, s, h, d))), -20.0, -1e-4)
        wl[:, 5:40] = -20.0
        wl = wl.astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    return r, k, v, wl, u


def _to_bh(x, b, h, s, d):
    return np.moveaxis(np.asarray(x), 2, 1).reshape(b * h, s, d)


@pytest.mark.parametrize("case", RWKV_CASES,
                         ids=[f"s{c[2]}d{c[3]}c{c[4]}" for c in RWKV_CASES])
def test_scan_plain_vs_pallas_interpret_and_oracle(case):
    b, h, s, d, chunk = case
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=s + d)
    o, sf = scan.rwkv6_scan(*map(_t, (r, k, v, wl, u)), chunk=chunk)
    jo, jsf = j_scan_ops.rwkv6_scan(*map(jnp.asarray, (r, k, v, wl, u)),
                                    chunk=chunk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(jsf), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    ub = np.broadcast_to(u[None], (b, h, d)).reshape(b * h, d)
    oref, sref = j_scan_ref.reference(
        *(jnp.asarray(_to_bh(x, b, h, s, d)) for x in (r, k, v, wl)),
        jnp.asarray(ub))
    oref = np.moveaxis(np.asarray(oref).reshape(b, h, s, d), 1, 2)
    np.testing.assert_allclose(o.numpy(), oref, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(sf.numpy().reshape(b * h, d, d),
                               np.asarray(sref), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strong"])
def test_scan_oracle_port_matches_jax(strong):
    b, h, s, d = 1, 2, 70, 32
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=3, strong=strong)
    bh = [_to_bh(x, b, h, s, d) for x in (r, k, v, wl)]
    ub = np.broadcast_to(u[None], (b, h, d)).reshape(b * h, d)
    s0 = np.random.default_rng(4).standard_normal((b * h, d, d)).astype(
        np.float32)
    o, sf = scan_ref.reference(*map(_t, bh), _t(ub), _t(s0))
    jo, jsf = j_scan_ref.reference(*map(jnp.asarray, bh), jnp.asarray(ub),
                                   jnp.asarray(s0))
    assert _rel(o, jo) < F32_TOL and _rel(sf, jsf) < F32_TOL


def test_scan_strong_decay_vs_oracle_and_pallas():
    """Runs of w_log = -20 over 35 steps: every output finite and within the
    oracle's bound (a factored intra-chunk form gives 0 x inf here)."""
    b, h, s, d = 1, 2, 130, 64
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=11, strong=True)
    s0 = np.random.default_rng(12).standard_normal((b, h, d, d)).astype(
        np.float32)
    o, sf = scan.rwkv6_scan(*map(_t, (r, k, v, wl, u)), _t(s0))
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    ub = np.broadcast_to(u[None], (b, h, d)).reshape(b * h, d)
    oref, sref = scan_ref.reference(
        *(_t(_to_bh(x, b, h, s, d)) for x in (r, k, v, wl)), _t(ub),
        _t(s0.reshape(b * h, d, d)))
    oref = oref.reshape(b, h, s, d).transpose(1, 2)
    torch.testing.assert_close(o, oref, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(sf.reshape(b * h, d, d), sref, atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    jo, jsf = j_scan_ops.rwkv6_scan(*map(jnp.asarray, (r, k, v, wl, u)),
                                    jnp.asarray(s0), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(jsf), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


def test_scan_state_carry():
    """Two half-sequence scans with the state carried == one full scan
    (the port's plain version, and against JAX with a given state)."""
    b, h, s, d = 1, 2, 128, 64
    r, k, v, wl, u = map(_t, _scan_inputs(b, h, s, d, seed=7))
    o_full, s_full = scan.rwkv6_scan(r, k, v, wl, u, chunk=32)
    o1, st = scan.rwkv6_scan(r[:, :64], k[:, :64], v[:, :64], wl[:, :64], u,
                             chunk=32)
    o2, s2 = scan.rwkv6_scan(r[:, 64:], k[:, 64:], v[:, 64:], wl[:, 64:], u,
                             st, chunk=32)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full,
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(s2, s_full, atol=SCAN_TOL, rtol=SCAN_TOL)
    jo2, js2 = JR.wkv_chunked(*(jnp.asarray(x[:, 64:].numpy())
                                for x in (r, k, v, wl)), jnp.asarray(u),
                              jnp.asarray(st.numpy()), chunk=32)
    assert _rel(o2, jo2) < F32_TOL and _rel(s2, js2) < F32_TOL


@pytest.mark.parametrize("s", [1, 37, 64, 150])
def test_scan_plain_vs_jax_wkv_chunked(s):
    """The plain version is ``wkv_chunked`` (chunk = min(64, S), padding
    with w_log 0) in the same f32 arithmetic."""
    b, h, d = 2, 2, 64
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=20 + s, strong=s == 150)
    s0 = np.random.default_rng(s).standard_normal((b, h, d, d)).astype(
        np.float32)
    o, sf = scan.rwkv6_scan(*map(_t, (r, k, v, wl, u)), _t(s0))
    jo, jsf = JR.wkv_chunked(*map(jnp.asarray, (r, k, v, wl, u, s0)))
    assert o.shape == (b, s, h, d) and sf.dtype == torch.float32
    tol = STRONG_TOL if s == 150 else F32_TOL
    assert _rel(o, jo) < tol and _rel(sf, jsf) < tol


def test_scan_plain_gradient_where_a_chunk_decay_overflows():
    """Where a chunk's decay passes 88.72, ``exp`` of the pairwise decays
    above the diagonal overflows f32: JAX's ``wkv_chunked`` backward
    takes 0 x inf there (its gradients are not finite), the plain
    version's masked exponent is 0, and its gradients are those of the
    same function in chunks of 4 steps (decays of at most 80, finite in
    JAX too); the forward values are JAX's."""
    b, h, s, d = 1, 2, 128, 32
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=31, strong=True)
    go = np.random.default_rng(32).standard_normal((b, s, h, d)).astype(
        np.float32)

    def j_grads(chunk):
        o, vjp = jax.vjp(lambda *a: JR.wkv_chunked(*a, chunk=chunk)[0],
                         *map(jnp.asarray, (r, k, v, wl, u)))
        return o, vjp(jnp.asarray(go))
    j_o, j_overflow = j_grads(64)
    assert not all(bool(jnp.isfinite(g).all()) for g in j_overflow)
    _, j_short = j_grads(4)
    assert all(bool(jnp.isfinite(g).all()) for g in j_short)
    ts = [_t(a).requires_grad_(True) for a in (r, k, v, wl, u)]
    o, _ = scan.rwkv6_scan_plain(*ts)
    o.backward(_t(go))
    assert _rel(o.detach(), j_o) < STRONG_TOL
    for t, jg in zip(ts, j_short):
        assert bool(torch.isfinite(t.grad).all())
        assert _rel(t.grad, jg) < STRONG_TOL


def test_scan_bf16_operands_keep_dtypes():
    b, h, s, d = 1, 2, 20, 32
    r, k, v, wl, u = _scan_inputs(b, h, s, d, seed=5)
    rb, kb, vb = (_t(x).to(torch.bfloat16) for x in (r, k, v))
    o, sf = scan.rwkv6_scan(rb, kb, vb, _t(wl), _t(u).to(torch.bfloat16))
    assert o.dtype == torch.bfloat16 and sf.dtype == torch.float32
    jo, jsf = JR.wkv_chunked(*(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16) for x in (rb, kb, vb)), jnp.asarray(wl),
        jnp.asarray(u).astype(jnp.bfloat16))
    assert _rel(sf, jsf) < F32_TOL
    assert _rel(o, np.asarray(jo.astype(jnp.float32))) < 1e-2  # 1 bf16 ulp


@pytest.mark.parametrize("bad", ["u", "state", "empty"])
def test_scan_rejects_bad_shapes(bad):
    r = torch.zeros(1, 4, 2, 8)
    u = torch.zeros(2, 8)
    kw = {}
    if bad == "u":
        u = torch.zeros(8)
    elif bad == "state":
        kw = dict(state=torch.zeros(1, 2, 8, 4))
    else:
        r = torch.zeros(1, 0, 2, 8)
    with pytest.raises(ValueError):
        scan.rwkv6_scan(r, r, r, r, u, **kw)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bundle():
    """The JAX bundle of the reduced rwkv6-7b and its bf16 parameters."""
    jb = j_build_model(j_reduced_config("rwkv6-7b"))
    jparams, _ = jb.init(jax.random.key(0))
    return jb, jparams


@pytest.fixture(scope="module")
def pieces(jax_bundle):
    """Reduced rwkv6-7b: JAX layer params in f32 (the first layer of the
    stack), a sequence and carried states, as numpy."""
    cfg = j_reduced_config("rwkv6-7b")
    jp = {n: np.asarray(a[0], np.float32) for n, a in
          jax_bundle[1]["stack"]["layers"]["l0"]["rwkv"].items()}
    for n in ("w0", "u", "mu", "c_mu", "ln_x_scale", "ln_x_bias"):
        # break the constant inits so every parameter matters
        jp[n] = jp[n] + 0.1 * np.random.default_rng(len(n)).standard_normal(
            jp[n].shape).astype(np.float32)
    rng = np.random.default_rng(2)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, d)).astype(np.float32)
    state = rng.standard_normal((2, d // hs, hs, hs)).astype(np.float32)
    return cfg, jp, {n: _t(a) for n, a in jp.items()}, x, x_prev, state


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_time_mix_vs_jax(pieces, decode):
    cfg, jp, tp, x, x_prev, state = pieces
    if decode:
        x = x[:, :1]
    jo, (jlast, jst) = J_TIME_MIX(jp, jnp.asarray(x), cfg,
                                  x_prev=jnp.asarray(x_prev),
                                  state=jnp.asarray(state), decode=decode)
    o, (last, st) = R.time_mix(tp, _t(x), cfg, x_prev=_t(x_prev),
                               state=_t(state), decode=decode)
    assert _rel(o, jo) < F32_TOL and _rel(st, jst) < F32_TOL
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_time_mix_without_carried_state_vs_jax(pieces):
    cfg, jp, tp, x, _, _ = pieces
    jo, (_, jst) = J_TIME_MIX(jp, jnp.asarray(x), cfg)
    o, (_, st) = R.time_mix(tp, _t(x), cfg)
    assert _rel(o, jo) < F32_TOL and _rel(st, jst) < F32_TOL


def test_channel_mix_vs_jax(pieces):
    cfg, jp, tp, x, x_prev, _ = pieces
    jf, jlast = JR.channel_mix(jp, jnp.asarray(x), cfg,
                               x_prev=jnp.asarray(x_prev))
    f, last = R.channel_mix(tp, _t(x), cfg, x_prev=_t(x_prev))
    assert _rel(f, jf) < F32_TOL
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    jf0, _ = JR.channel_mix(jp, jnp.asarray(x), cfg)
    assert _rel(R.channel_mix(tp, _t(x), cfg)[0], jf0) < F32_TOL


def test_wkv_decode_step_vs_jax(pieces):
    cfg, _, _, _, _, state = pieces
    rng = np.random.default_rng(9)
    b, nh, hs = state.shape[:3]
    r, k, v = (rng.standard_normal((b, nh, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.1, 1.0, (b, nh, hs)).astype(np.float32)
    u = rng.standard_normal((nh, hs)).astype(np.float32)
    jo, jst = JR.wkv_decode_step(*map(jnp.asarray, (r, k, v, w, u, state)))
    o, st = R.wkv_decode_step(*map(_t, (r, k, v, w, u, state)))
    assert _rel(o, jo) < F32_TOL and _rel(st, jst) < F32_TOL


def test_group_norm_vs_jax(pieces):
    cfg, jp, tp, x, _, _ = pieces
    nh = cfg.d_model // cfg.rwkv_head_size
    jg = JR._group_norm(jnp.asarray(x), jp["ln_x_scale"], jp["ln_x_bias"], nh)
    g = R._group_norm(_t(x), tp["ln_x_scale"], tp["ln_x_bias"], nh)
    assert _rel(g, jg) < F32_TOL
    xb = _t(x).to(torch.bfloat16)
    gb = R._group_norm(xb, tp["ln_x_scale"], tp["ln_x_bias"], nh)
    assert gb.dtype == torch.bfloat16


def test_init_matches_jax_layout(jax_bundle):
    """The port's random parameters have the JAX tree's names, shapes and
    dtypes, and its constant inits."""
    tp = build_model(reduced_config("rwkv6-7b")).init(
        torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jax_bundle[1])
    tl = leaves(tp)
    assert len(tl) == len(jl)
    for t, (path, j) in zip(tl, jl):
        name = jax.tree_util.keystr(path)
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16, name
        if any(f"'{n}'" in name for n in ("w0", "u", "mu", "ln_x_scale",
                                           "ln_x_bias", "c_mu", "scale",
                                           "bias")):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# the reduced rwkv6-7b bundle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles(jax_bundle):
    cfg = j_reduced_config("rwkv6-7b")
    jb, jparams = jax_bundle
    tb = build_model(reduced_config("rwkv6-7b"))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    return jb, jparams, tb, tokens, nxt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_bundle_prefill_and_decode_vs_jax(bundles, dtype):
    jb, jparams, tb, tokens, nxt = bundles
    if dtype == "f32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tol = MODEL_TOL if dtype == "f32" else BF16_TOL
    # bf16 runs JAX eagerly, so that every op rounds its output to bf16 as
    # PyTorch does (under jit XLA keeps fused bf16 intermediates in f32 and
    # the gap doubles); f32 is jitted for speed
    jit = jax.jit if dtype == "f32" else (lambda f: f)
    jc, _ = jb.cache_init(2, 128)
    jl2, jc = jit(lambda p, b, c: jb.prefill(p, b, caches=c))(
        jparams, {"tokens": jnp.asarray(tokens)}, jc)
    tl = tb.prefill(tparams, {"tokens": _t(tokens).long()})
    assert tl.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert _rel(tl, jl2.astype(jnp.float32)) < tol
    tc = tb.cache_init(2, 128, device="cpu")
    tl2, tc = tb.prefill(tparams, {"tokens": _t(tokens).long()}, caches=tc)
    assert _rel(tl2, jl2.astype(jnp.float32)) < tol
    step = {"tokens": nxt, "cur_index": jnp.int32(tokens.shape[1])}
    jl3, jc = jit(jb.decode_step)(jparams, jc, step)
    tl3, tc = tb.decode_step(tparams, tc, {"tokens": _t(nxt).long(),
                                            "cur_index": tokens.shape[1]})
    assert _rel(tl3, jl3.astype(jnp.float32)) < tol
    jleaves = jax.tree.leaves(jc)
    assert len(leaves(tc)) == len(jleaves)
    for t, j in zip(leaves(tc), jleaves):
        assert tuple(t.shape) == j.shape
        assert _rel(t, j.astype(jnp.float32)) < tol


def test_reduced_bundle_decode_continues_prefill(bundles):
    """prefill(S) then one decode step == prefill(S + 1) at the last
    position (the recurrent step against K5's chunked scan), f32."""
    _, jparams, tb, tokens, nxt = bundles
    tparams = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jparams), device="cpu")
    tc = tb.cache_init(2, 128, device="cpu")
    _, tc = tb.prefill(tparams, {"tokens": _t(tokens).long()}, caches=tc)
    dec, _ = tb.decode_step(tparams, tc, {"tokens": _t(nxt).long(),
                                          "cur_index": tokens.shape[1]})
    full = tb.prefill(tparams, {"tokens": _t(np.concatenate(
        [tokens, nxt], 1)).long()})
    assert _rel(dec[:, -1], full[:, -1].numpy()) < MODEL_TOL


@pytest.mark.cuda
def test_rwkv6_scan_kernel_vs_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    for dtype, (b, h, s, d), strong in [
            (torch.bfloat16, (2, 4, 130, 64), True),
            (torch.float32, (1, 2, 65, 64), False),
            (torch.float32, (2, 2, 37, 32), True),
            (torch.float32, (1, 3, 17, 64), True),
            (torch.bfloat16, (1, 64, 300, 64), True)]:
        r, k, v, wl, u = (_t(x).to(dev) for x in _scan_inputs(
            b, h, s, d, seed=s, strong=strong))
        r, k, v = (x.to(dtype) for x in (r, k, v))
        s0 = torch.randn(b, h, d, d, device=dev)
        before = scan.rwkv6_scan.launches
        o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
        torch.cuda.synchronize()
        assert scan.rwkv6_scan.launches == before + 1
        po, psf = scan.rwkv6_scan_plain(r, k, v, wl, u, s0)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(sf, psf, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rwkv6_scan_kernel_row_alone_bitwise():
    """Each row of a [4, 130, 64, 64] call (one block per row and head) is
    bitwise the same row called alone (B x H = 64 below the SM count: the
    value columns split over blocks), in o and the final state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    b, h, s, d = 4, 64, 130, 64
    r, k, v, wl, u = (_t(x).to(dev) for x in _scan_inputs(
        b, h, s, d, seed=31, strong=True))
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    s0 = torch.randn(b, h, d, d, device=dev)
    assert scan.plan(r)["col_split"] == 1
    assert scan.plan(r[:1])["col_split"] == 2
    o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
    for i in range(b):
        oi, sfi = scan.rwkv6_scan(r[i:i + 1], k[i:i + 1], v[i:i + 1],
                                  wl[i:i + 1], u, s0[i:i + 1])
        assert torch.equal(oi, o[i:i + 1]) and torch.equal(sfi, sf[i:i + 1])


# the bf16 gap above is rounding, not a port fault, when the port's bf16
# logits lie no further from the f32 logits than this many times JAX's own
# bf16 logits do (both round every op's output to bf16, in other orders)
BF16_GAP_FACTOR = 2.0


def test_reduced_bundle_bf16_gap_is_rounding(bundles):
    """Where the 1.8e-2 bf16 gap to JAX comes from: JAX's bf16 logits
    against JAX's f32 logits (same weights, upcast), and the port's bf16
    logits against the same f32 logits, for the prefill and one decode
    step.  The port may be at most BF16_GAP_FACTOR times further."""
    jb, jparams, tb, tokens, nxt = bundles
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    step = {"tokens": nxt, "cur_index": jnp.int32(tokens.shape[1])}
    gaps = {}
    for name, params, jit in (("f32", j32, jax.jit),
                              ("bf16", jparams, lambda f: f)):
        jc, _ = jb.cache_init(2, 128)
        pre, jc = jit(lambda p, b, c: jb.prefill(p, b, caches=c))(
            params, {"tokens": jnp.asarray(tokens)}, jc)
        dec, _ = jit(jb.decode_step)(params, jc, step)
        gaps[name] = (np.asarray(pre, np.float32), np.asarray(dec, np.float32))
    tc = tb.cache_init(2, 128, device="cpu")
    tpre, tc = tb.prefill(tparams, {"tokens": _t(tokens).long()}, caches=tc)
    tdec, _ = tb.decode_step(tparams, tc, {"tokens": _t(nxt).long(),
                                           "cur_index": tokens.shape[1]})
    for i, (what, port) in enumerate((("prefill", tpre), ("decode", tdec))):
        ref = gaps["f32"][i]
        jax_gap = _rel(gaps["bf16"][i], ref)
        port_gap = _rel(port, ref)
        print(f"{what}: JAX bf16 vs f32 {jax_gap:.3g}, port bf16 vs JAX f32 "
              f"{port_gap:.3g}")
        assert port_gap <= BF16_GAP_FACTOR * jax_gap, (what, port_gap,
                                                       jax_gap)
