"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), on the CPU.

The six cases of ``tests/test_moe.py`` ported: each runs the JAX
``moe_apply`` and the port's on the same weights (carried across by
``tree.params_from_jax``) and inputs (a numpy seed), and compares the
outputs and all three aux values (``load_balance_loss``,
``router_z_loss``, ``dropped_fraction``), at top-1, top-2 and top-8, with
and without a shared expert, under ``"chunked"`` and ``"pallas"`` (the
shared expert's FFN: JAX's Pallas kernel in interpret mode, the port's K3
wrapper on its plain version).  Tolerances (ROADMAP.md, numeric contract):
f32 within 1e-5, the kernel path and bf16 within 5e-3.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import moe as JM
from repro.models.layers import split_params
from repro.types import ModelConfig as JModelConfig
from repro.types import MoEConfig as JMoEConfig
from repro_torch import flags
from repro_torch import sharding as shd
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import moe as M
from repro_torch.tree import params_from_jax
from repro_torch.types import ModelConfig, MoEConfig

torch.set_num_threads(1)
F32_TOL = 1e-5
KERNEL_TOL = 5e-3


def make_cfgs(e=4, k=2, cf=4.0, shared=0, act="swiglu"):
    """The JAX test's config, as (JAX, port) dataclasses."""
    fields = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=2, d_ff=128, vocab_size=100, activation=act,
                  layer_pattern=("attn", "attn"))
    moe = dict(num_experts=e, top_k=k, d_ff_expert=128, capacity_factor=cf,
               num_shared_experts=shared)
    return (JModelConfig(moe=JMoEConfig(**moe), **fields),
            ModelConfig(moe=MoEConfig(**moe), **fields))


def _weights(jcfg, f32: bool = True):
    """JAX's ``moe_init`` values (cast to f32 unless ``f32`` is off) and the
    port's copy of them."""
    jp, _ = split_params(JM.moe_init(jax.random.key(0), jcfg))
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, dtype=np.float32, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


#: JAX's moe_apply jitted (one compile per shape, not one per op); the
#: bf16 case calls it eagerly, op by op as the port runs, since XLA's
#: fusions keep bf16 intermediates in f32 and move results by an ulp
_j_moe_apply = jax.jit(JM.moe_apply, static_argnums=(2,),
                       static_argnames=("impl",))


def _run(jcfg, cfg, jp, tp, x, impl, jdtype=jnp.float32,
         tdtype=torch.float32):
    fn = _j_moe_apply if jdtype == jnp.float32 else JM.moe_apply
    jout, jaux = fn(jp, jnp.asarray(x, jdtype), jcfg, impl=impl)
    with torch.inference_mode():
        tout, taux = M.moe_apply(tp, torch.as_tensor(x).to(tdtype), cfg,
                                 impl=impl)
    return (np.asarray(jnp.asarray(jout, jnp.float32)), jaux,
            tout.float().numpy(), taux)


def _check(jout, jaux, tout, taux, tol):
    np.testing.assert_allclose(tout, jout, atol=tol, rtol=tol)
    assert taux.keys() == jaux.keys()
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=name)


def _dense_oracle(params, x, cfg):
    """The JAX test's dense per-token expert mixture (no capacity)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ params["router"].astype(jnp.float32), -1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdims=True)
    up = jnp.einsum("td,edf->tef", xt, params["w_up"].astype(jnp.float32))
    if "w_gate" in params:
        g = jnp.einsum("td,edf->tef", xt,
                       params["w_gate"].astype(jnp.float32))
        h = jax.nn.silu(g) * up
    else:
        h = jax.nn.gelu(up)
    outs = jnp.einsum("tef,efd->ted", h,
                      params["w_down"].astype(jnp.float32))
    sel = jnp.take_along_axis(outs, idx[..., None], axis=1)
    return np.asarray((sel * gates[..., None]).sum(1).reshape(x.shape))


IMPLS = ("chunked", "pallas")


def _tol(impl):
    return KERNEL_TOL if impl == "pallas" else F32_TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_matches_jax_and_dense_oracle_no_drops(impl, act):
    jcfg, cfg = make_cfgs(cf=8.0, act=act)
    jp, tp = _weights(jcfg)
    x = _x((2, 32, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, impl)
    assert float(taux["dropped_fraction"]) == 0.0
    _check(jout, jaux, tout, taux, _tol(impl))
    np.testing.assert_allclose(tout, _dense_oracle(jp, jnp.asarray(x), jcfg),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("e,k", [(4, 1), (16, 8)])
def test_moe_top1_and_top8(impl, e, k):
    jcfg, cfg = make_cfgs(e=e, k=k, cf=8.0)
    jp, tp = _weights(jcfg)
    x = _x((2, 16, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, impl)
    _check(jout, jaux, tout, taux, _tol(impl))
    np.testing.assert_allclose(tout, _dense_oracle(jp, jnp.asarray(x), jcfg),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k", [2, 8])
def test_capacity_drops_counted(impl, k):
    """Starved capacity: the same assignments drop on both sides (the
    stable sort keeps JAX's order within an expert), the drop fraction is
    JAX's, the output finite and equal."""
    jcfg, cfg = make_cfgs(e=16 if k == 8 else 4, k=k, cf=0.3)
    jp, tp = _weights(jcfg)
    x = _x((4, 64, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, impl)
    assert float(taux["dropped_fraction"]) > 0.0
    assert np.isfinite(tout).all()
    _check(jout, jaux, tout, taux, _tol(impl))


@pytest.mark.parametrize("impl", IMPLS)
def test_shared_expert_added(impl):
    jcfg, cfg = make_cfgs(shared=1, cf=8.0)
    jp, tp = _weights(jcfg)
    x = _x((1, 8, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, impl)
    _check(jout, jaux, tout, taux, _tol(impl))
    tp2 = dict(tp)
    tp2["shared"] = {n: torch.zeros_like(t) for n, t in tp["shared"].items()}
    with torch.inference_mode():
        out2, _ = M.moe_apply(tp2, torch.as_tensor(x), cfg, impl=impl)
    assert np.abs(tout - out2.numpy()).max() > 1e-4


def test_aux_losses_sane():
    jcfg, cfg = make_cfgs(cf=8.0)
    jp, tp = _weights(jcfg)
    x = _x((2, 64, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, "chunked")
    _check(jout, jaux, tout, taux, F32_TOL)
    lb = float(taux["load_balance_loss"]) / cfg.moe.load_balance_loss
    assert 0.9 < lb < 4.0
    assert float(taux["router_z_loss"]) >= 0.0
    assert all(v.dtype == torch.float32 and v.dim() == 0
               for v in taux.values())


def test_capacity_rounding():
    m = MoEConfig(num_experts=4, top_k=2, d_ff_expert=8, capacity_factor=1.0)
    assert M._capacity(64, m) % 8 == 0
    assert M._capacity(64, m) >= 64 * 2 // 4
    for e, k, cf in ((4, 2, 1.0), (384, 8, 1.25), (16, 2, 1.25),
                     (128, 1, 1.25)):
        pm = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                       capacity_factor=cf)
        jm = JMoEConfig(**dataclasses.asdict(pm))
        for t in (1, 4, 5, 130, 500, 2000, 13520):
            assert M._capacity(t, pm) == JM._capacity(t, jm), (e, k, t)


@pytest.mark.parametrize("shared", [0, 1])
def test_bf16_matches_jax_within_kernel_tolerance(shared):
    """bf16 weights and tokens, as served: the expert products and the
    combine in bf16 on both sides (a token's contributions added in the
    sorted order)."""
    jcfg, cfg = make_cfgs(e=16, k=8, cf=2.0, shared=shared)
    jp, tp = _weights(jcfg, f32=False)
    x = _x((2, 16, 64))
    jout, jaux, tout, taux = _run(jcfg, cfg, jp, tp, x, "chunked",
                                  jdtype=jnp.bfloat16,
                                  tdtype=torch.bfloat16)
    _check(jout, jaux, tout, taux, KERNEL_TOL)


def test_moe_dispatch_is_moe_apply_and_a2a_raises():
    jcfg, cfg = make_cfgs(cf=8.0)
    _, tp = _weights(jcfg)
    x = torch.as_tensor(_x((1, 8, 64)))
    with torch.inference_mode():
        a, _ = M.moe_apply(tp, x, cfg)
        b, _ = M.moe_dispatch(tp, x, cfg)
    assert torch.equal(a, b)
    # the all-to-all path is SPMD code: it runs inside an active mesh
    # (tests/test_torch_cp_moe.py holds it on 4 ranks against JAX)
    with pytest.raises(ValueError, match="mesh_rules"):
        M.moe_apply_a2a(tp, x, cfg, mesh=None)
    with shd.mesh_rules(make_serving_mesh("1,1")), flags.moe_dispatch("a2a"):
        with torch.inference_mode():
            c, aux = M.moe_dispatch(tp, x, cfg)
    torch.testing.assert_close(c, a, atol=1e-6, rtol=1e-6)
    assert float(aux["dropped_fraction"]) == 0.0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_no_host_sync_and_deterministic_combine():
    """The path runs no op that reads a device value on the host (the text
    engine captures the decode step as a CUDA graph), and two calls are
    bitwise equal."""
    jcfg, cfg = make_cfgs(e=16, k=8, cf=0.5, shared=1)
    _, tp = _weights(jcfg)
    x = torch.as_tensor(_x((2, 16, 64)))
    mode = _Ops()
    with torch.inference_mode(), mode:
        a, _ = M.moe_apply(tp, x, cfg, impl="pallas")
    with torch.inference_mode():
        b, _ = M.moe_apply(tp, x, cfg, impl="pallas")
    names = mode.names
    del mode
    gc.collect()
    syncing = {"nonzero", "_local_scalar_dense", "bincount", "unique",
               "_unique2", "unique_consecutive", "masked_select", "item"}
    assert not names & syncing, names & syncing
    assert {"sort", "topk", "bmm", "scatter_add_"} <= names
    assert torch.equal(a, b)


def test_init_matches_jax_layout():
    """Names, shapes and dtypes of ``moe_init`` are JAX's (router f32,
    experts [E, d, f] / [E, f, d], the shared expert's d_ff f * shared),
    stacked too; the experts fan in over axis 1."""
    jcfg, cfg = make_cfgs(e=8, k=2, shared=2)
    jp, _ = split_params(JM.moe_init(jax.random.key(0), jcfg, stacked=3))
    tp = M.moe_init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", stacked=3)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
           for p, a in flat_j}
    want = {}
    for name, t in tp.items():
        items = t.items() if isinstance(t, dict) else [(None, t)]
        for sub, v in items:
            key = f"['{name}']" + (f"['{sub}']" if sub else "")
            want[key] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    assert got == want
    std = tp["w_up"].float().std().item()
    assert abs(std * np.sqrt(64) - 0.88) < 0.05     # trunc-normal, fan in d
