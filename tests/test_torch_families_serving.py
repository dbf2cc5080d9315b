"""The text engine on the other decoder families, against the JAX engine,
on the CPU at their reduced configs: jamba-v0.1-52b (Mamba + MoE),
kimi-k2-1t-a32b and llama4-maverick-400b-a17b (MoE with a shared expert),
llava-next-mistral-7b (on tokens, as the JAX engine serves it), qwen2-72b
and qwen1.5-32b (QKV bias).  The launcher and the ``cuda``-marked kernel
launches are ``tests/test_torch_families_launch.py``.

``generate`` of three 60-token prompts and ``submit`` of a 100-token one,
six greedy tokens each, token for token equal to the JAX engine's (which
calls its bundle with the defaults, chunked prefill and reference decode;
the port's runs ``impl="pallas"``, on the CPU the kernels' plain
versions); a differing token is allowed only at a near tie (top-2 gap
under 1e-4), and reported.  The weights are JAX's, carried across by
``tree.params_from_jax`` (f32).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model as j_build_model
from repro.serving.engine import TextServingEngine as JTextServingEngine
from repro_torch.models import moe as M
from repro_torch.serving import ServeRequest, create_engine
from tests.test_torch_families import load

torch.set_num_threads(1)
ARCHS = ("jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama4-maverick-400b-a17b",
         "llava-next-mistral-7b", "qwen2-72b", "qwen1.5-32b")
N_TOKENS = 6


def _assert_tokens(tb, t32, prompt, got, want):
    """Equal, or parted at a near tie of the port's logits (top-2 gap under
    1e-4, printed)."""
    got, want = np.asarray(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    i = next(i for i, (a, c) in enumerate(zip(got, want)) if a != c)
    seq = list(prompt) + [int(t) for t in want[:i]]
    with torch.inference_mode():
        lg = tb.prefill(t32, {"tokens": torch.tensor([seq])})
    top = torch.topk(lg[0, -1].float(), 2).values
    gap = float(top[0] - top[1])
    assert gap < 1e-4, (f"tokens differ at step {i} (top-2 gap {gap}): "
                        f"{got} vs {want}")
    print(f"near tie at step {i}: top-2 gap {gap}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_and_submit_match_jax_engine(arch):
    jcfg, _, j32, tb, t32, _ = load(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, 60).astype(np.int32)
               for _ in range(3)]
    single = rng.integers(0, jcfg.vocab_size, 100).astype(np.int32)
    jb = j_build_model(jcfg)
    # its prefill jitted (one compile a prompt length, not one an op; the
    # engine jits its decode step itself)
    jb = dataclasses.replace(jb, prefill=jax.jit(jb.prefill))
    jeng = JTextServingEngine(jb, j32, batch=4, max_len=128)
    try:
        jouts = jeng.generate(prompts, n_tokens=N_TOKENS)
        jsingle = jeng.generate([single], n_tokens=N_TOKENS)[0]
    finally:
        jeng.shutdown()
    eng = create_engine("text", tb, t32, batch=4, max_len=128, device="cpu")
    try:
        outs = eng.generate(prompts, n_tokens=N_TOKENS)
        res = eng.submit(ServeRequest(history=single,
                                      n_tokens=N_TOKENS)).result(timeout=300)
    finally:
        eng.shutdown()
    for p, o, j in zip(prompts, outs, jouts):
        _assert_tokens(tb, t32, p, o, j)
    _assert_tokens(tb, t32, single, res.output, jsingle)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_engine_greedy_matches_repeated_prefill(arch, monkeypatch):
    """The engine's decode loop (the Mamba states and the attention caches
    written in place, the MoE at one token a step) equals re-prefilling
    the growing sequence.  The capacity is computed from the tokens of a
    call, so a prefill may drop assignments that a one-token step keeps
    (with random weights the reduced router drops 7-17% at 20 tokens): the
    bundle here takes the config with ``capacity_factor`` 8, the same
    weights, and the test checks that nothing was dropped."""
    from repro_torch.models.model import build_model
    _, _, _, tb, t32, _ = load(arch)
    cfg = dataclasses.replace(tb.cfg, moe=dataclasses.replace(
        tb.cfg.moe, capacity_factor=8.0))
    tb = build_model(cfg)
    drops = []
    real = M.moe_apply

    def counted(*a, **kw):
        out, aux = real(*a, **kw)
        drops.append(float(aux["dropped_fraction"]))
        return out, aux
    monkeypatch.setattr(M, "moe_apply", counted)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    eng = create_engine("text", tb, t32, batch=2, max_len=32, device="cpu")
    try:
        out = eng.generate([prompt], n_tokens=5)[0]
    finally:
        eng.shutdown()
    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(5):
            lg = tb.prefill(t32, {"tokens": torch.tensor([seq])},
                            impl="pallas")
            seq.append(int(torch.argmax(lg[0, -1])))
    assert drops and max(drops) == 0.0
    np.testing.assert_array_equal(np.array(seq[-5:]), out)
