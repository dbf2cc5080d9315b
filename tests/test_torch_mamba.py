"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``), on the CPU at the reduced jamba config
(d_model 256: d_inner 512, N 16, conv 4).

``mamba_apply`` at S 40 (one chunk) and 300 (two chunks of 256, the second
padded), from zero and from carried states; a prefill then decode steps
from the carried state; the in-place cache write of a decode step through
``layer_apply``; ``_conv1d``'s state; ``associative_scan`` against
``jax.lax.associative_scan``; ``mamba_init``'s layout and fixed values.
Weights come from JAX's ``mamba_init`` through ``tree.params_from_jax``,
inputs from a numpy seed; f32 throughout, within 1e-5 (ROADMAP.md, numeric
contract).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.ffn import ffn_init as j_ffn_init
from repro.models.layers import split_params
from repro_torch.configs import reduced_config
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, params_from_jax

torch.set_num_threads(1)
ARCH = "jamba-v0.1-52b"
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced_config(ARCH)
    jp, _ = split_params(JM.mamba_init(jax.random.key(2), jcfg))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    # a non-trivial conv bias and skip, so that both are exercised
    rng = np.random.default_rng(3)
    di = jcfg.mamba_expand * jcfg.d_model
    jp = dict(jp, conv_b=jnp.asarray(0.1 * rng.standard_normal(di),
                                     jnp.float32),
              d_skip=jnp.asarray(1 + 0.1 * rng.standard_normal(di),
                                 jnp.float32))
    return jcfg, jp, reduced_config(ARCH), params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _state(cfg, b, rng):
    di = cfg.mamba_expand * cfg.d_model
    conv = 0.5 * rng.standard_normal((b, cfg.mamba_d_conv - 1, di))
    ssm = 0.5 * rng.standard_normal((b, di, cfg.mamba_d_state))
    return conv.astype(np.float32), ssm.astype(np.float32)


_j_apply = jax.jit(JM.mamba_apply, static_argnums=(2,),
                   static_argnames=("decode",))


@pytest.mark.parametrize("s", [40, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_apply_prefill_matches_jax(weights, s, carried):
    jcfg, jp, cfg, tp = weights
    rng = np.random.default_rng(s)
    b = 2
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    st = _state(cfg, b, rng) if carried else None
    jy, (jconv, jssm) = _j_apply(
        jp, jnp.asarray(x), jcfg,
        state=tuple(map(jnp.asarray, st)) if st else None)
    with torch.inference_mode():
        ty, (tconv, tssm) = M.mamba_apply(
            tp, _t(x), cfg, state=tuple(map(_t, st)) if st else None)
    _close(ty, jy)
    _close(tconv, jconv)
    _close(tssm, jssm)
    assert tssm.dtype == torch.float32


def test_prefill_then_decode_from_carried_state(weights):
    """A 300-token prefill, then five single-token steps from its states,
    each against JAX's step from JAX's states; and the decode's output
    equals the same token appended to a longer prefill (the recurrence is
    the scan)."""
    jcfg, jp, cfg, tp = weights
    rng = np.random.default_rng(5)
    b, s = 2, 300
    x = rng.standard_normal((b, s + 5, cfg.d_model)).astype(np.float32)
    _, jst = _j_apply(jp, jnp.asarray(x[:, :s]), jcfg)
    with torch.inference_mode():
        _, tst = M.mamba_apply(tp, _t(x[:, :s]), cfg)
        for i in range(5):
            xi = x[:, s + i:s + i + 1]
            jy, jst = _j_apply(jp, jnp.asarray(xi), jcfg, state=jst,
                               decode=True)
            ty, tst = M.mamba_apply(tp, _t(xi), cfg, state=tst, decode=True)
            _close(ty, jy)
            _close(tst[0], jst[0])
            _close(tst[1], jst[1])
        full, _ = M.mamba_apply(tp, _t(x), cfg)
    np.testing.assert_allclose(ty[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-4, rtol=1e-4)


def test_decode_layer_writes_caches_in_place(weights):
    """``layer_apply`` on a ``mamba`` layer at decode copies the new conv
    and ssm states into the caches handed in (the same tensors come back);
    their values are JAX's new caches; a prefill returns new ones."""
    jcfg, jp, cfg, tp = weights
    rng = np.random.default_rng(6)
    b = 2
    lp_j = {"norm1": {"scale": jnp.zeros(cfg.d_model)},
            "norm2": {"scale": jnp.zeros(cfg.d_model)}, "mamba": jp,
            "ffn": jax.tree.map(lambda a: a.astype(jnp.float32),
                                split_params(j_ffn_init(jax.random.key(4),
                                                        jcfg))[0])}
    lp_t = params_from_jax(jax.tree.map(np.asarray, lp_j), device="cpu")
    conv, ssm = _state(cfg, b, rng)
    jc = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    tc = {"conv": _t(conv), "ssm": _t(ssm)}
    ids = {n: t.data_ptr() for n, t in tc.items()}
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kw = dict(mode="decode", positions=None, cur_len=None, impl="chunked",
              mask_mode="causal")
    jy, jnew, _ = JT.layer_apply(lp_j, jnp.asarray(x), jcfg, "mamba", 0,
                                 cache=jc, **kw)
    with torch.inference_mode():
        ty, tnew, aux = T.layer_apply(lp_t, _t(x), cfg, "mamba", 0,
                                      cache=tc, **kw)
    assert tnew is tc and aux == {}
    assert {n: t.data_ptr() for n, t in tnew.items()} == ids
    _close(ty, jy)
    for n in ("conv", "ssm"):
        _close(tc[n], jnew[n])
    with torch.inference_mode():
        _, pre, _ = T.layer_apply(lp_t, _t(x), cfg, "mamba", 0, cache=tc,
                                  **dict(kw, mode="prefill"))
    assert all(pre[n].data_ptr() != ids[n] for n in ids)


@pytest.mark.parametrize("s", [1, 3, 7])
def test_conv1d_state_matches_jax(s):
    rng = np.random.default_rng(s)
    b, k, di = 2, 4, 8
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    w = rng.standard_normal((k, di)).astype(np.float32)
    bias = rng.standard_normal(di).astype(np.float32)
    st = rng.standard_normal((b, k - 1, di)).astype(np.float32)
    for state in (None, st):
        jy, jst = JM._conv1d(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(bias), None if state is None
                             else jnp.asarray(state))
        ty, tst = M._conv1d(_t(x), _t(w), _t(bias),
                            None if state is None else _t(state))
        _close(ty, jy)
        _close(tst, jst)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 256])
def test_associative_scan_matches_jax(n):
    """The port of ``jax.lax.associative_scan``'s recursion on the
    (decay, increment) pairs of the selective scan, at even and odd
    lengths; also against a sequential scan."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    bb = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    _, jh = jax.lax.associative_scan(JM_combine, (jnp.asarray(a),
                                                  jnp.asarray(bb)), axis=1)
    _, th = M.associative_scan(M._combine, (_t(a), _t(bb)))
    _close(th, jh, 1e-6)
    h, seq = np.zeros((2, 3, 4), np.float32), []
    for i in range(n):
        h = a[:, i] * h + bb[:, i]
        seq.append(h)
    np.testing.assert_allclose(th.numpy(), np.stack(seq, 1), atol=1e-5,
                               rtol=1e-5)


def JM_combine(e1, e2):
    """The JAX package's combine (a closure inside ``mamba_apply``)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def test_init_matches_jax_layout_and_values():
    """Names, shapes and dtypes of ``mamba_init`` (stacked) are JAX's;
    ``dt_bias`` (-4.6 in bf16), ``conv_b`` and ``d_skip`` equal JAX's
    exactly, ``a_log`` (S4D-real, f32) within an f32 ulp (XLA's and
    torch's ``log`` round apart); ``conv_w`` is scaled by 0.5."""
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    jp, _ = split_params(JM.mamba_init(jax.random.key(0), jcfg, stacked=2))
    tp = M.mamba_init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu", stacked=2)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert tuple(jp[name].shape) == tuple(tp[name].shape), name
        assert str(jp[name].dtype) == str(tp[name].dtype).replace(
            "torch.", ""), name
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=2e-7, atol=0)
    for name in ("dt_bias", "conv_b", "d_skip"):
        np.testing.assert_array_equal(
            tp[name].float().numpy(),
            np.asarray(jnp.asarray(jp[name], jnp.float32)), err_msg=name)
    std = tp["conv_w"].float().std().item()
    assert abs(std - 0.5 * 0.88) < 0.03


def test_init_caches_mamba_layout():
    cfg = reduced_config(ARCH)
    c = T.init_caches(cfg, 3, 40, device="cpu")
    j, _ = JT.init_caches(j_reduced_config(ARCH), 3, 40)
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in leaves(c)] == [(tuple(a.shape), str(a.dtype))
                                    for a in jax.tree.leaves(j)]
    assert c["l0"]["ssm"].dtype == torch.float32
    assert c["l0"]["conv"].shape == (1, 3, 3, 512)
