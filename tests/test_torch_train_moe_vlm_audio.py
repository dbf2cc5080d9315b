"""The MoE, vision and audio families' ``loss_fn`` and gradients against
the JAX package's on the CPU (``tests/_train_parity.py``), under
``chunked``: kimi-k2-1t-a32b (MoE with a shared expert; the aux losses in
the metrics), llava-next-mistral-7b with stub ``patch_embeds`` (the CE
after them) and seamless-m4t-large-v2 (encoder-decoder, its decoder
layers recomputed).  Without patches llava's ``projector`` is a leaf the
loss does not use: its gradient is zero, and weight decay still moves
it."""
import numpy as np
import pytest
import torch

from repro_torch.models.model import build_model
from repro_torch.training.loop import grads_of, make_train_step, to_device
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import leaves
from tests._train_parity import (batch_for, check_bf16_step,
                                 check_loss_and_grads, configs)

torch.set_num_threads(1)
ARCHS = ["kimi-k2-1t-a32b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, "chunked")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_jax(arch):
    check_bf16_step(arch, "chunked")


def test_unused_leaf_gets_zero_grad_and_is_decayed():
    _, cfg = configs("llava-next-mistral-7b")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    batch = to_device(batch_for(cfg, np.random.default_rng(2),
                                patches=False), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = bundle.loss_fn(params, batch)
    grads = dict(zip(map(id, leaves(params)), grads_of(loss, params)))
    proj = params["projector"]
    assert torch.count_nonzero(grads[id(proj)]) == 0
    assert all(torch.count_nonzero(g) > 0 for k, g in grads.items()
               if k != id(proj))
    before = proj.detach().clone()
    step = make_train_step(bundle, AdamWConfig(lr=0.5, weight_decay=0.1,
                                               warmup_steps=1))
    step(params, adamw_init(params), batch)
    # no gradient: the update is the decay alone, p - lr * (wd * p)
    b32 = before.float()
    want = (b32 - 0.5 * (0.1 * b32)).to(before.dtype)
    assert not torch.equal(proj.detach(), before)
    assert torch.equal(proj.detach(), want)
