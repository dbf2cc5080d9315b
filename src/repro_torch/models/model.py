"""ModelBundle: the functional API of a text decoder.  Port of
``repro/models/model.py`` for the text-decoder family (the layer kinds of
``models/transformer.py``):

    bundle = build_model(cfg)
    params = bundle.init(generator, device="cuda")
    logits = bundle.prefill(params, batch)                   # [B,S,V]
    logits, caches = bundle.prefill(params, batch, caches=caches)
    logits, caches = bundle.decode_step(params, caches, batch)
    caches = bundle.cache_init(batch, max_len, quant=False)

``prefill`` and ``decode_step`` take the JAX signatures' ``impl``, with its
defaults (``"chunked"`` and ``"reference"``: no kernel); ``"pallas"`` runs
K2 on the attention prefill, K3 on every FFN and K4 on a non-ring decode.

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
    prefill: Callable       # (params, batch, impl, caches) -> logits [, caches]
    decode_step: Callable   # (params, caches, batch, impl) -> (logits, caches),
    #                         the caches handed in, written in place
    cache_init: Callable    # (batch, max_len, dtype, device, quant) -> caches


def _build_text(cfg: ModelConfig) -> ModelBundle:
    if cfg.modality == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision-language branch of the text bundle is "
            f"not ported yet (ROADMAP.md Queue 1 entry 4)")

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        """Random parameters (bf16) on ``device`` from ``generator``
        (default: seed 0 on that device).  Raises when ``device="cuda"``
        and no GPU is present."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return {"embed": L.embed_init(cfg, generator=generator, device=dev),
                "stack": T.stack_init(cfg, generator=generator, device=dev)}

    def forward(params, batch, *, mode: str, impl: str, caches=None):
        tokens = batch["tokens"]
        x = L.embed(params["embed"], tokens, cfg)
        b, s = x.shape[:2]
        cur_len = None
        if mode == "decode":
            cur = batch["cur_index"]
            if not isinstance(cur, torch.Tensor):
                # a fill, not a host-to-device copy, so that an eager step
                # can be captured too
                cur = torch.full((), int(cur), dtype=torch.int64,
                                 device=x.device)
            cur = cur.to(device=x.device, dtype=torch.int64).reshape(())
            positions = cur.reshape(1, 1).expand(b, 1)
            cur_len = cur + 1
        else:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, new_caches = T.stack_apply(params["stack"], x, cfg, mode=mode,
                                      positions=positions, caches=caches,
                                      cur_len=cur_len, impl=impl)
        return L.unembed(params["embed"], x, cfg), new_caches

    def prefill(params, batch, impl: str = "chunked", caches=None):
        """``batch["tokens"]`` [B,S] -> logits [B,S,V] (and the caches after
        the prompt when ``caches`` are given)."""
        logits, new_caches = forward(params, batch, mode="prefill",
                                     impl=impl, caches=caches)
        if caches is not None:
            return logits, new_caches
        return logits

    def decode_step(params, caches, batch, impl: str = "reference"):
        """One token per row (``batch["tokens"]`` [B,1]) at position
        ``batch["cur_index"]`` (an int or a 0-d tensor; a CUDA graph passes
        a device tensor in a static buffer) against the caches.  Writes the
        step's state into ``caches`` in place (every layer kind; the JAX
        package returns new arrays) and returns them with the logits: a
        caller that needs the caches from before the step clones them."""
        return forward(params, batch, mode="decode", impl=impl,
                       caches=caches)

    def cache_init(batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda", quant: bool = False):
        return T.init_caches(cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device), quant=quant)

    return ModelBundle(cfg, init, prefill, decode_step, cache_init)


def build_model(cfg: ModelConfig):
    if cfg.family == "climber":
        from repro_torch.core.climber import build_climber
        return build_climber(cfg)
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder-decoder family is not ported yet "
            f"(ROADMAP.md Queue 1 entry 4)")
    return _build_text(cfg)
