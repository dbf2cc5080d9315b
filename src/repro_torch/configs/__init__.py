"""Config registry of the port: the JAX package's 11 architectures
(``repro/configs``), each a copy of its config.  Climber (the paper's
model); the text decoders rwkv6-7b (``rwkv``), gemma3-12b (``swa`` +
``attn``), h2o-danube-3-4b (``swa``), qwen2-72b and qwen1.5-32b (``attn``
with QKV bias), llava-next-mistral-7b (``attn`` and the vision branch),
the MoE models kimi-k2-1t-a32b and llama4-maverick-400b-a17b and the
Mamba + MoE hybrid jamba-v0.1-52b; and the audio encoder-decoder
seamless-m4t-large-v2."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.shapes import (  # noqa: F401  (re-exported)
    ASSIGNED_SHAPES, CLIMBER_BASE, CLIMBER_LONG, DECODE_32K, LONG_500K,
    PREFILL_32K, SHAPES, TRAIN_4K, get_shape)
from repro_torch.types import ModelConfig

_ARCH_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-32b": "qwen1_5_32b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gemma3-12b": "gemma3_12b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "climber": "climber",
}

ASSIGNED_ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "climber"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    """Every registered architecture's config, by arch id."""
    return {a: get_config(a) for a in _ARCH_MODULES}


#: the architectures the text engine serves: every decoder (not Climber,
#: not the audio encoder-decoder)
TEXT_ARCHS = tuple(a for a in _ARCH_MODULES
                   if a != "climber" and not get_config(a).enc_dec)


def reduce(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of ``cfg``, term for term the reduction of
    ``repro.configs.reduced_config``: the layer pattern compressed to its
    distinct kinds (doubled when there is one), one layer each (Climber: 2
    layers, 2 per block), d_model <= 256, <= 4 heads with the kv heads cut
    by the same query-per-kv ratio, d_ff <= 512, vocab <= 1024,
    ``sliding_window`` <= 64, ``frontend_tokens`` <= 16, <= 2 encoder
    layers, MoE at 4 experts (top-k <= 2, d_ff_expert <= 512) and
    ``rwkv_head_size <= head_dim``.  Climber's modules never read the layer
    pattern, so its doubled one-kind pattern changes nothing there."""
    pattern = tuple(dict.fromkeys(cfg.layer_pattern))
    if len(pattern) == 1:
        pattern = pattern * 2
    n_layers = len(pattern)
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, max(1, n_heads // cfg.q_per_kv
                                   if cfg.q_per_kv else n_heads))
    n_kv = max(1, min(n_kv, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(8, d_model // n_heads)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=4, top_k=min(moe.top_k, 2),
                                  d_ff_expert=min(moe.d_ff_expert, 512))
    climber = cfg.climber
    if climber is not None:
        climber = dataclasses.replace(climber, layers_per_block=2)
        n_layers = 2
    return dataclasses.replace(
        cfg,
        layer_pattern=pattern,
        n_layers=n_layers,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        sliding_window=(min(cfg.sliding_window, 64) if cfg.sliding_window
                        else 0),
        frontend_tokens=(min(cfg.frontend_tokens, 16) if cfg.frontend_tokens
                         else 0),
        moe=moe,
        climber=climber,
        rwkv_head_size=min(cfg.rwkv_head_size, head_dim),
    )


def reduced_config(arch: str) -> ModelConfig:
    """:func:`reduce` of the registered ``arch``."""
    return reduce(get_config(arch))
