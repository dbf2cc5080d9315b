"""ModelBundle: the functional API of a text decoder.  Port of
``repro/models/model.py`` for the text-decoder family (the layer kinds of
``models/transformer.py``):

    bundle = build_model(cfg)
    params = bundle.init(generator, device="cuda")
    logits = bundle.prefill(params, batch)                   # [B,S,V]
    logits, caches = bundle.prefill(params, batch, caches=caches)
    logits, caches = bundle.decode_step(params, caches, batch)
    caches = bundle.cache_init(batch, max_len)

``build_model`` dispatches Climber to ``core.climber.build_climber``.  The
vision-language branch, the audio encoder-decoder family, training
(``loss_fn``) and the dry-run surfaces (``input_specs``) are not ported
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.devices import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.types import ModelConfig


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable          # (generator=None, device="cuda") -> params
    prefill: Callable       # (params, batch, caches=None) -> logits [, caches]
    decode_step: Callable   # (params, caches, batch) -> (logits, caches)
    cache_init: Callable    # (batch, max_len, dtype, device) -> caches


def _build_text(cfg: ModelConfig) -> ModelBundle:
    if cfg.modality == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision-language branch of the text bundle is "
            f"not ported yet (ROADMAP.md, what is left)")

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        """Random parameters (bf16) on ``device`` from ``generator``
        (default: seed 0 on that device).  Raises when ``device="cuda"``
        and no GPU is present."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return {"embed": L.embed_init(cfg, generator=generator, device=dev),
                "stack": T.stack_init(cfg, generator=generator, device=dev)}

    def forward(params, batch, *, mode: str, caches=None):
        x = L.embed(params["embed"], batch["tokens"], cfg)
        x, new_caches = T.stack_apply(params["stack"], x, cfg, mode=mode,
                                      caches=caches)
        return L.unembed(params["embed"], x, cfg), new_caches

    def prefill(params, batch, caches=None):
        """``batch["tokens"]`` [B,S] -> logits [B,S,V] (and the caches after
        the prompt when ``caches`` are given)."""
        logits, new_caches = forward(params, batch, mode="prefill",
                                     caches=caches)
        if caches is not None:
            return logits, new_caches
        return logits

    def decode_step(params, caches, batch):
        """One token per row (``batch["tokens"]`` [B,1]) against the caches;
        ``batch["cur_index"]`` is its position (unused by the rwkv kind,
        whose state carries the position)."""
        return forward(params, batch, mode="decode", caches=caches)

    def cache_init(batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        return T.init_caches(cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device))

    return ModelBundle(cfg, init, prefill, decode_step, cache_init)


def build_model(cfg: ModelConfig):
    if cfg.family == "climber":
        from repro_torch.core.climber import build_climber
        return build_climber(cfg)
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder-decoder family is not ported yet "
            f"(ROADMAP.md, what is left)")
    return _build_text(cfg)
