"""The recurrent families' ``loss_fn`` and gradients against the JAX
package's on the CPU (``tests/_train_parity.py``): rwkv6-7b (``rwkv``,
K5's plain version on the prefill) and jamba-v0.1-52b (``mamba`` with a
dense FFN, ``attn`` with MoE: the chunked selective scan and the
sort-based dispatch under autograd), under ``chunked``."""
import pytest
import torch

from tests._train_parity import check_bf16_step, check_loss_and_grads

torch.set_num_threads(1)
ARCHS = ["rwkv6-7b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch, "chunked")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_jax(arch):
    check_bf16_step(arch, "chunked")
