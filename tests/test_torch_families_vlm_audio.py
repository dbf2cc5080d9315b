"""The vision model (llava-next-mistral-7b, with and without stub patch
embeddings) and the audio encoder-decoder (seamless-m4t-large-v2) of the
port against the JAX package, on the CPU at their reduced configs (the
helpers and the tolerances are ``tests/test_torch_families.py``'s; the two
QKV-bias dense models are ``tests/test_torch_families_qwen.py``).

Each bundle's prefill into caches and three decode steps under
``reference``, ``chunked`` and ``pallas`` (seamless under pallas: the
encoder's ``full`` attention, the decoder's ``causal`` one and the
cross-attention, Sq != Sk, through the K2 wrapper; every FFN through
K3's); seamless's decode step against a one-token-longer prefill; the
trees; the audio cache defaults; the audio bundle refused by the text
engine.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models.model import _frames_for, build_model
from repro_torch.serving import create_engine
from tests.test_torch_families import (IMPLS, check_bundle,
                                       check_decode_matches_prefill,
                                       check_trees, load)

torch.set_num_threads(1)
ARCHS = ("llava-next-mistral-7b", "seamless-m4t-large-v2")
CASES = [(a, False) for a in ARCHS] + [("llava-next-mistral-7b", True)]


@pytest.mark.parametrize("arch,patches", CASES)
@pytest.mark.parametrize("impl", IMPLS)
def test_bundle_prefill_and_decode_match_jax(arch, patches, impl):
    """llava with ``patches``: 16 stub patch embeddings projected and
    prepended, positions ``arange(16 + 40)``, decoding from 56."""
    check_bundle(arch, patches, impl)


def test_reduced_decode_matches_prefill():
    """seamless: the self caches and the cross K / V."""
    check_decode_matches_prefill("seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_weight_bridge_give_jax_trees(arch):
    """``projector``, ``frame_proj``, ``enc`` / ``dec``."""
    check_trees(arch)


def test_audio_cache_defaults_and_frames():
    cfg = reduced_config("seamless-m4t-large-v2")
    assert _frames_for(cfg, 4096) == 1024 and _frames_for(cfg, 16) == 8
    c = build_model(cfg).cache_init(1, 8, device="cpu", quant=True)
    assert c["xk"].shape[2] == 1024 and c["k"].dtype == torch.bfloat16


def test_text_engine_refuses_the_audio_bundle():
    """The text engine serves decoder families: an encoder-decoder bundle
    is refused at construction (the JAX engine takes it and fails at its
    first prefill with ``KeyError: 'frames'``)."""
    _, _, _, tb, t32, _ = load("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="decoder families"):
        create_engine("text", tb, t32, batch=2, max_len=64, device="cpu")


def test_vision_prefill_without_patches_is_the_text_prefill():
    """Without ``patch_embeds`` the vision bundle is the text decoder on
    the tokens alone (the engine's traffic); with them, the logits of the
    token positions change (the tokens attend to the patches)."""
    _, _, _, tb, t32, _ = load("llava-next-mistral-7b")
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, tb.cfg.vocab_size, (1, 12))).long()
    pe = torch.as_tensor(rng.standard_normal(
        (1, 4, tb.cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        plain = tb.prefill(t32, {"tokens": toks})
        with_pe = tb.prefill(t32, {"tokens": toks, "patch_embeds": pe})
    assert plain.shape == (1, 12, tb.cfg.vocab_size)
    assert with_pe.shape == (1, 16, tb.cfg.vocab_size)
    assert (with_pe[:, 4:] - plain).abs().max() > 1e-3
