"""Helpers of the training parity tests (``tests/test_torch_train_*.py``):
a bundle's ``loss_fn`` and gradients against the JAX package's on the CPU.

:func:`check_loss_and_grads`: both packages fed the same f32 weights, the
loss and its metrics within 1e-5 and every leaf's gradient within 1e-4 of
the leaf's gradient norm.  :func:`check_bf16_step`: two train steps from
the same bf16 weights on the same batch, each step's loss within the 5e-3
contract.  JAX runs under ``jit`` (one compile per function, not one per
op).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.training.loop import make_train_step as j_make_train_step
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.training.loop import grads_of, make_train_step, to_device
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import leaves, params_from_jax
from repro_torch.types import ClimberConfig

torch.set_num_threads(1)
F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 5e-3
N_FRONT = 8          # stub patches / frames of the reduced batches

CLIMBER = dict(vocab_size=2_000, d_model=64, d_ff=128, n_heads=2,
               n_kv_heads=2, head_dim=32)


def configs(arch: str):
    """(JAX cfg, port cfg): the reduced config, or for Climber the small
    config of ``tests/test_training.py``."""
    if arch == "climber":
        return (dataclasses.replace(
            j_get_config("climber"), **CLIMBER,
            climber=JClimberConfig(num_blocks=2, layers_per_block=2)),
            dataclasses.replace(
                get_config("climber"), **CLIMBER,
                climber=ClimberConfig(num_blocks=2, layers_per_block=2)))
    return j_reduced_config(arch), reduced_config(arch)


@functools.lru_cache(maxsize=None)
def load(arch: str):
    """(JAX cfg, JAX bundle, port bundle, JAX bf16 weights of key 0): the
    weights drawn by a jitted ``init`` (one compile; eagerly each op would
    compile on its own), shared by the checks of one process."""
    jcfg, tcfg = configs(arch)
    jb = j_build_model(jcfg)
    jparams = jax.jit(lambda k: jb.init(k)[0])(jax.random.key(0))
    return jcfg, jb, build_model(tcfg), jparams


def batch_for(cfg, rng, *, patches: bool = True):
    """A numpy training batch for ``cfg`` (2 rows)."""
    if cfg.family == "climber":
        return {"history": rng.integers(0, cfg.vocab_size, (2, 32)).astype(
                    np.int32),
                "candidates": rng.integers(0, cfg.vocab_size, (2, 6)).astype(
                    np.int32),
                "side": rng.standard_normal((2, 12)).astype(np.float32),
                "labels": (rng.random((2, 6, cfg.climber.num_tasks))
                           < 0.4).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(
        np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((2, N_FRONT, cfg.d_model))
    elif cfg.modality == "vision" and patches:
        out["patch_embeds"] = rng.standard_normal((2, N_FRONT, cfg.d_model))
    return out


#: the batch entries that enter the model in the weights' dtype
STUBS = ("frames", "patch_embeds")


def _jbatch(batch, dtype):
    return {k: jnp.asarray(v, dtype if k in STUBS else None)
            for k, v in batch.items()}


def _tbatch(batch, dtype):
    return {k: (v.to(dtype) if k in STUBS else v)
            for k, v in to_device(batch, "cpu").items()}


def check_loss_and_grads(arch, impl, *, patches=True):
    """f32 weights: the loss, its metrics, every leaf's gradient."""
    jcfg, jb, tb, jparams = load(arch)
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    batch = batch_for(jcfg, np.random.default_rng(1),
                      patches=patches)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jb.loss_fn(p, b, impl=impl), has_aux=True))(
        j32, _jbatch(batch, jnp.float32))
    for p in leaves(t32):
        p.requires_grad_(True)
    tl, tm = tb.loss_fn(t32, _tbatch(batch, torch.float32), impl=impl)
    tg = grads_of(tl, t32)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    for got, want in zip(tg, jg):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(got.detach().numpy() - want).max() if want.size else 0.0
        assert err <= GRAD_TOL * max(np.linalg.norm(want), 1e-3), \
            (arch, got.shape, err, np.linalg.norm(want))


def check_bf16_step(arch, impl, *, patches=True):
    """bf16 weights: two train steps in each package from the same weights
    on the same batch: the first step's loss and the second's (the loss at
    the updated weights) within 5e-3, and the second below the first."""
    jcfg, jb, tb, jparams = load(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    batch = batch_for(jcfg, np.random.default_rng(1),
                      patches=patches)
    jcfg_opt = JAdamWConfig(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(j_make_train_step(jb, jcfg_opt, impl=impl))
    jb_batch = _jbatch(batch, jnp.bfloat16)
    jopt = j_adamw_init(jparams)
    for p in leaves(tparams):
        p.requires_grad_(True)
    tstep = make_train_step(tb, AdamWConfig(lr=1e-3, warmup_steps=1),
                            impl=impl)
    tb_batch = _tbatch(batch, torch.bfloat16)
    topt = adamw_init(tparams)
    losses = []
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt, jb_batch)
        tparams, topt, tm = tstep(tparams, topt, tb_batch)
        losses.append(float(tm["loss"]))
        assert abs(losses[-1] - float(jm["loss"])) <= BF16_TOL, \
            (losses, float(jm["loss"]))
    assert losses[1] < losses[0]


