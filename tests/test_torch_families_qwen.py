"""The two QKV-bias dense models of the port (qwen2-72b: GQA 4 query heads
over 1 KV head at its reduced size; qwen1.5-32b: as many KV heads as query
heads) against the JAX package, on the CPU at their reduced configs (the
helpers and tolerances are ``tests/test_torch_families.py``'s): each
bundle's prefill into caches and three decode steps under ``reference``,
``chunked`` and ``pallas``, and the trees (the QKV biases).
"""
import pytest
import torch

from tests.test_torch_families import IMPLS, check_bundle, check_trees

torch.set_num_threads(1)
ARCHS = ("qwen2-72b", "qwen1.5-32b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_bundle_prefill_and_decode_match_jax(arch, impl):
    check_bundle(arch, False, impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_weight_bridge_give_jax_trees(arch):
    check_trees(arch)
