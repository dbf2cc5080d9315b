"""Config registry of the port.  Only Climber is ported so far; the other
architectures of ``repro.configs`` wait for their models (ROADMAP.md,
Queue 1 item 10)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import (  # noqa: F401  (re-exported)
    CLIMBER_BASE, CLIMBER_LONG)
from repro_torch.types import ModelConfig

_ARCHS = ("climber",)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {list(_ARCHS)}")
    from repro_torch.configs.climber import CONFIG
    return CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Smoke-test variant, the same reduction as ``repro.configs.
    reduced_config`` applies to Climber: 2 layers per block, d_model <= 256,
    <= 4 heads, d_ff <= 512, vocab <= 1024."""
    cfg = get_config(arch)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_model = min(cfg.d_model, 256)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=max(8, d_model // n_heads), d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        climber=dataclasses.replace(cfg.climber, layers_per_block=2))
