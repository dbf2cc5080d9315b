"""The MoE models of the port (kimi-k2-1t-a32b: every layer MoE, top-8 of
its reduced 4 experts at 2, with a shared expert; llama4-maverick-400b-a17b:
a dense and an MoE layer, top-1, with a shared expert) against the JAX
package, on the CPU at their reduced configs (the helpers and tolerances
are ``tests/test_torch_families.py``'s).

Each bundle's prefill into caches and three decode steps under
``reference``, ``chunked`` and ``pallas`` (the shared expert's FFN through
the K3 wrapper); the trees; the aux losses summed over the stack.
"""
import pytest
import torch

from tests.test_torch_families import (IMPLS, check_aux_sums, check_bundle,
                                       check_trees)

torch.set_num_threads(1)
ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_bundle_prefill_and_decode_match_jax(arch, impl):
    check_bundle(arch, False, impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_weight_bridge_give_jax_trees(arch):
    """The f32 router, the stacked [G, E, d, f] experts, the shared
    expert."""
    check_trees(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_sums_over_the_stack(arch):
    check_aux_sums(arch)
