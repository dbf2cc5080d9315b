"""ModelBundle: the functional API of the text decoders and the audio
encoder-decoder.  Port of ``repro/models/model.py``:

    bundle = build_model(cfg)
    params = bundle.init(generator, device="cuda")
    loss, metrics = bundle.loss_fn(params, batch)            # train shapes
    logits = bundle.prefill(params, batch)                   # [B,S,V]
    logits, caches = bundle.prefill(params, batch, caches=caches)
    logits, caches = bundle.decode_step(params, caches, batch)
    caches = bundle.cache_init(batch, max_len, quant=False)

``prefill`` and ``decode_step`` take the JAX signatures' ``impl``, with its
defaults (``"chunked"`` and ``"reference"``: no kernel); ``"pallas"`` runs
K2 on the attention prefill, K3 on every dense FFN and shared expert and K4
on a non-ring decode.

The text family (dense / moe / hybrid / ssm / vlm) is one implementation
over ``models/transformer.py``; a vision config (``modality="vision"``)
adds the ``projector``, and its prefill takes optional stub
``patch_embeds`` [B, P, d], projected and prepended to the tokens
(positions ``arange(P + S)``: decoding continues at ``cur_index = P + S``).
The audio family (``enc_dec``) is ``models/encdec.py``: its prefill takes
``frames`` [B, F, d] and ``tokens`` and fills {k, v, xk, xv} caches.
``build_model`` dispatches Climber to ``core.climber.build_climber``.

``loss_fn`` is the JAX package's training loss, under its default impl
``"chunked"`` (no kernel): next-token :func:`cross_entropy` (in f32) after
a vision config's ``n_front`` patches, plus the MoE layers'
``load_balance_loss`` and ``router_z_loss``, with the layer stack (the
decoder's layers, for audio) recomputed in the backward pass
(``remat``).  The hand kernels have no backward: on the card a loss under
``"pallas"`` raises (a kernel wrapper refuses operands that require
grad); on the CPU the wrappers' plain versions differentiate.  The
dry-run surfaces (``input_specs``, ``input_logical``) are not ported
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.devices import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.types import ModelConfig


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable          # (generator=None, device="cuda") -> params
    loss_fn: Callable       # (params, batch, impl) -> (loss, metrics)
    prefill: Callable       # (params, batch, impl, caches) -> logits [, caches]
    decode_step: Callable   # (params, caches, batch, impl) -> (logits, caches),
    #                         the caches handed in, written in place
    cache_init: Callable    # (batch, max_len, dtype, device, quant) -> caches


def cross_entropy(logits, targets, mask):
    """Mean CE over masked positions; the log-sum-exp and the gather in
    f32."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def _generator(generator, dev):
    return (torch.Generator(device=dev).manual_seed(0) if generator is None
            else generator)


def _cur_index(batch, device):
    """``batch["cur_index"]`` as a 0-d int64 tensor on ``device``: a Python
    int becomes a fill, not a host-to-device copy, so that an eager step
    can be captured too."""
    cur = batch["cur_index"]
    if not isinstance(cur, torch.Tensor):
        cur = torch.full((), int(cur), dtype=torch.int64, device=device)
    return cur.to(device=device, dtype=torch.int64).reshape(())


def _build_text(cfg: ModelConfig) -> ModelBundle:
    is_vlm = cfg.modality == "vision"

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        """Random parameters (bf16) on ``device`` from ``generator``
        (default: seed 0 on that device).  Raises when ``device="cuda"``
        and no GPU is present."""
        dev = resolve_device(device)
        generator = _generator(generator, dev)
        params = {"embed": L.embed_init(cfg, generator=generator,
                                        device=dev),
                  "stack": T.stack_init(cfg, generator=generator,
                                        device=dev)}
        if is_vlm:
            params["projector"] = L.dense_init(
                (cfg.d_model, cfg.d_model), ("embed", "act_model"),
                generator=generator, device=dev)
        return params

    def embed_inputs(params, batch):
        x = L.embed(params["embed"], batch["tokens"], cfg)
        if is_vlm and "patch_embeds" in batch:
            pe = torch.matmul(batch["patch_embeds"].to(x.dtype),
                              params["projector"])
            x = torch.cat([pe, x], dim=1)
        return x

    def forward(params, batch, *, mode: str, impl: str, caches=None,
                remat: bool = False):
        x = embed_inputs(params, batch)
        b, s = x.shape[:2]
        cur_len = None
        if mode == "decode":
            cur = _cur_index(batch, x.device)
            positions = cur.reshape(1, 1).expand(b, 1)
            cur_len = cur + 1
        else:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, new_caches, aux = T.stack_apply(
            params["stack"], x, cfg, mode=mode, positions=positions,
            caches=caches, cur_len=cur_len, impl=impl, remat=remat)
        return L.unembed(params["embed"], x, cfg), new_caches, aux

    def loss_fn(params, batch, impl: str = "chunked"):
        """Next-token CE over ``batch["tokens"]`` [B,S] (after a vision
        config's optional ``patch_embeds``) plus the MoE aux losses.
        Returns (total, {"ce_loss", "load_balance_loss",
        "router_z_loss"}), 0-d f32 tensors."""
        logits, _, aux = forward(params, batch, mode="train", impl=impl,
                                 remat=True)
        n_front = batch["patch_embeds"].shape[1] if (
            is_vlm and "patch_embeds" in batch) else 0
        lg = logits[:, n_front:]
        targets = batch["tokens"][:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=lg.device)
        loss = cross_entropy(lg[:, :-1], targets, mask)
        total = loss + aux["load_balance_loss"] + aux["router_z_loss"]
        return total, {"ce_loss": loss, **aux}

    def prefill(params, batch, impl: str = "chunked", caches=None):
        """``batch["tokens"]`` [B,S] (a vision config: and optional
        ``batch["patch_embeds"]`` [B,P,d], prepended) -> logits [B,P+S,V]
        (and the caches after the prompt when ``caches`` are given)."""
        logits, new_caches, _ = forward(params, batch, mode="prefill",
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
        logits, new_caches, _ = forward(params, batch, mode="decode",
                                        impl=impl, caches=caches)
        return logits, new_caches

    def cache_init(batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda", quant: bool = False):
        return T.init_caches(cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device), quant=quant)

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, cache_init)


# ---------------------------------------------------------------------------
# audio encoder-decoder family
# ---------------------------------------------------------------------------

def _frames_for(cfg: ModelConfig, seq_len: int) -> int:
    return max(8, seq_len // 4)      # stub conv frontend downsamples 4x


def _build_audio(cfg: ModelConfig) -> ModelBundle:

    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        """Random parameters (bf16) on ``device`` from ``generator``
        (default: seed 0 on that device)."""
        dev = resolve_device(device)
        generator = _generator(generator, dev)
        return {"embed": L.embed_init(cfg, generator=generator, device=dev),
                **E.encdec_init(cfg, generator=generator, device=dev)}

    def loss_fn(params, batch, impl: str = "chunked"):
        """Next-token CE of the decoder over ``batch["tokens"]`` [B,S]
        beside the encoded ``batch["frames"]`` [B,F,d].  Returns (loss,
        {"ce_loss": loss})."""
        enc_out = E.encode(params, batch["frames"], cfg, impl=impl)
        x = L.embed(params["embed"], batch["tokens"], cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, _ = E.decode_stack(params, x, enc_out, cfg, mode="train",
                              positions=positions, impl=impl, remat=True)
        logits = L.unembed(params["embed"], x, cfg)
        targets = batch["tokens"][:, 1:]
        loss = cross_entropy(logits[:, :-1], targets,
                             torch.ones(targets.shape, dtype=torch.float32,
                                        device=x.device))
        return loss, {"ce_loss": loss}

    def prefill(params, batch, impl: str = "chunked", caches=None):
        """``batch["frames"]`` [B,F,d] and ``batch["tokens"]`` [B,S] ->
        logits [B,S,V] (and, with ``caches``, the self caches after the
        target prefix and the cross K / V of the frames)."""
        enc_out = E.encode(params, batch["frames"], cfg, impl=impl)
        x = L.embed(params["embed"], batch["tokens"], cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, new_caches = E.decode_stack(params, x, enc_out, cfg,
                                       mode="prefill", positions=positions,
                                       caches=caches, impl=impl)
        logits = L.unembed(params["embed"], x, cfg)
        if caches is not None:
            xk, xv = E.cross_kv(params, enc_out, cfg)
            return logits, {**new_caches, "xk": xk, "xv": xv}
        return logits

    def decode_step(params, caches, batch, impl: str = "reference"):
        """One target token per row at ``batch["cur_index"]``; writes its
        K / V into the self caches in place and returns them."""
        x = L.embed(params["embed"], batch["tokens"], cfg)
        b = x.shape[0]
        cur = _cur_index(batch, x.device)
        x, new_caches = E.decode_stack(
            params, x, None, cfg, mode="decode",
            positions=cur.reshape(1, 1).expand(b, 1), caches=caches,
            cur_len=cur + 1, impl=impl)
        return L.unembed(params["embed"], x, cfg), new_caches

    def cache_init(batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda", n_frames: Optional[int] = None,
                   quant: bool = False):
        """Self caches of ``max_len`` and cross K / V of ``n_frames``
        (default ``_frames_for(cfg, 4096)``); ``quant`` is ignored: the
        enc-dec caches stay in ``dtype``, as in the JAX package."""
        del quant
        return E.init_dec_caches(cfg, batch, max_len,
                                 n_frames or _frames_for(cfg, 4096),
                                 dtype=dtype, device=resolve_device(device))

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, cache_init)


def build_model(cfg):
    if cfg.family == "climber":
        from repro_torch.core.climber import build_climber
        return build_climber(cfg)
    if cfg.enc_dec:
        return _build_audio(cfg)
    return _build_text(cfg)
