"""Every bundle's ``loss_fn`` and its gradients against the JAX package's,
on the CPU at reduced configs (``tests/_train_parity.py``): Climber under
``reference`` and ``chunked`` and the attention kinds (h2o-danube-3-4b
``swa``, gemma3-12b ``attn`` + ``swa``) here; rwkv6-7b and jamba-v0.1-52b
in ``tests/test_torch_train_recurrent.py``, the MoE, vision and audio
families in ``tests/test_torch_train_moe_vlm_audio.py``.
"""
import pytest
import torch

from tests._train_parity import check_bf16_step, check_loss_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("impl", ["reference", "chunked"])
def test_climber_loss_and_grads_match_jax(impl):
    check_loss_and_grads("climber", impl)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-12b"])
def test_attention_kinds_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, "chunked")


@pytest.mark.parametrize("arch,impl", [("climber", "reference"),
                                       ("h2o-danube-3-4b", "chunked")])
def test_bf16_train_step_matches_jax(arch, impl):
    check_bf16_step(arch, impl)
