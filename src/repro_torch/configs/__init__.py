"""Config registry of the port: Climber (the paper's model) and rwkv6-7b
(the text engine's model, K5 on its prefill).  The other architectures of
``repro.configs`` wait for their layer kinds (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import (  # noqa: F401  (re-exported)
    CLIMBER_BASE, CLIMBER_LONG)
from repro_torch.types import ModelConfig

_ARCH_MODULES = {"climber": "climber", "rwkv6-7b": "rwkv6_7b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Smoke-test variant, the reduction of ``repro.configs.reduced_config``:
    the layer pattern compressed to its distinct kinds (doubled when there
    is one) and one layer each, d_model <= 256, <= 4 heads, d_ff <= 512,
    vocab <= 1024, ``rwkv_head_size <= head_dim``.  Climber keeps its own
    layer pattern and gets 2 layers per block."""
    cfg = get_config(arch)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_model = min(cfg.d_model, 256)
    head_dim = max(8, d_model // n_heads)
    common = dict(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                  head_dim=head_dim, d_ff=min(cfg.d_ff, 512),
                  vocab_size=min(cfg.vocab_size, 1024))
    if cfg.climber is not None:
        return dataclasses.replace(
            cfg, n_layers=2, **common,
            climber=dataclasses.replace(cfg.climber, layers_per_block=2))
    pattern = tuple(dict.fromkeys(cfg.layer_pattern))
    if len(pattern) == 1:
        pattern = pattern * 2
    return dataclasses.replace(
        cfg, layer_pattern=pattern, n_layers=len(pattern), **common,
        rwkv_head_size=min(cfg.rwkv_head_size, head_dim))
