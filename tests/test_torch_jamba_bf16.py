"""jamba-v0.1-52b's bf16 route gap is rounding, not a port fault.

On the card the port's bf16 ``pallas`` and ``chunked`` prefills of jamba
part by a mean of 0.0329 of the mean |logit| (``chip_smoke.py``,
``text_attn_gates``).  Here, on the reduced config's bf16 weights carried
across from JAX, on the CPU, a 300-token prompt (past 256, so ``chunked``
takes its chunked attention) goes through ``reference``, ``chunked`` and
``pallas`` (the port's plain twins; JAX's Pallas kernels in interpret
mode) on both sides, and through JAX's ``reference`` in f32.  JAX's own
bf16 routes part as the port's do: each of the port's route gaps, and each
port route's gap to JAX's f32 logits, is at most GAP_FACTOR times JAX's
(measured here: pallas vs chunked 0.0120 against JAX's 0.0113; a route
against f32 0.016-0.018 against JAX's 0.014-0.018).  The metric is the
card gate's: mean |a - b| over mean |b|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.tree import params_from_jax
from tests.test_torch_families import ARCH, load

torch.set_num_threads(1)
GAP_FACTOR = 1.5
IMPLS = ("reference", "chunked", "pallas")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.fixture(scope="module")
def logits():
    jcfg, jb, j32, tb, _, jparams = load(ARCH)
    assert jax.tree.leaves(jparams)[0].dtype == jnp.bfloat16
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 300)).astype(np.int32)
    jl, tl = {}, {}
    for impl in IMPLS:
        jl[impl] = np.asarray(jnp.asarray(jb.prefill(
            jparams, {"tokens": jnp.asarray(toks)}, impl=impl)[0],
            jnp.float32))
        with torch.inference_mode():
            tl[impl] = tb.prefill(tparams, {"tokens": torch.as_tensor(
                toks).long()}, impl=impl)[0].float().numpy()
    f32 = np.asarray(jnp.asarray(jb.prefill(
        j32, {"tokens": jnp.asarray(toks)}, impl="reference")[0],
        jnp.float32))
    return jl, tl, f32


@pytest.mark.parametrize("a,b", [("pallas", "chunked"),
                                 ("reference", "chunked"),
                                 ("pallas", "reference")])
def test_port_routes_part_as_jax_routes_do(logits, a, b):
    jl, tl, _ = logits
    jax_gap, port_gap = _rel(jl[a], jl[b]), _rel(tl[a], tl[b])
    print(f"{a} vs {b}: JAX bf16 {jax_gap:.4g}, port bf16 {port_gap:.4g}")
    assert port_gap <= GAP_FACTOR * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("impl", IMPLS)
def test_each_port_route_is_as_far_from_f32_as_jax(logits, impl):
    jl, tl, f32 = logits
    jax_gap, port_gap = _rel(jl[impl], f32), _rel(tl[impl], f32)
    print(f"{impl} vs JAX f32: JAX bf16 {jax_gap:.4g}, port {port_gap:.4g}")
    assert port_gap <= GAP_FACTOR * jax_gap, (port_gap, jax_gap)
    assert np.isfinite(tl[impl]).all()
