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
grad); on the CPU the wrappers' plain versions differentiate.

The dry-run surfaces: ``input_specs(shape)`` gives the batch of a
``ShapeConfig`` as ``meta`` tensors (the JAX ``ShapeDtypeStruct``s: same
names, shapes, dtypes), ``input_logical(shape)`` their logical axes and
``cache_logical(quant)`` those of ``cache_init``'s leaves.

Under a mesh (``sharding.mesh_rules``) ``prefill`` and ``decode_step`` run
the rank's program on its blocks: the parameters from
``sharding.shard_params``, the batch and caches its rows (and, under the
long-context rules, its slice of the cache positions).  The FSDP axes are
gathered as each layer runs, heads and hidden columns split over
``model`` with their partial sums added there, and every rank returns the
whole logits of its rows (the vocabulary gathered over ``model``);
``loss_fn`` runs there too, differentiably, with a vocab-parallel loss
(:func:`cross_entropy`), which ``training.loop.make_train_step`` turns
into the sharded train step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.devices import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.types import ModelConfig, ShapeConfig


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable          # (generator=None, device="cuda") -> params
    loss_fn: Callable       # (params, batch, impl) -> (loss, metrics)
    prefill: Callable       # (params, batch, impl, caches) -> logits [, caches]
    decode_step: Callable   # (params, caches, batch, impl) -> (logits, caches),
    #                         the caches handed in, written in place
    cache_init: Callable    # (batch, max_len, dtype, device, quant) -> caches
    input_specs: Callable   # (ShapeConfig) -> {name: meta tensor}
    input_logical: Callable  # (ShapeConfig) -> {name: logical tuple}
    cache_logical: Callable  # (quant) -> logical tree of cache_init's leaves


def cross_entropy(logits, targets, mask, vocab: Optional[int] = None):
    """Mean CE over masked positions; the log-sum-exp and the gather in
    f32.

    Under a mesh (``sharding.mesh_rules``) it is JAX's global mean: the
    rows are the rank's block of the batch, so the masked sum and the
    mask count are added over the batch axes (one ``all_reduce``), and
    with ``logits`` the rank's block of a ``vocab`` split over ``model``
    (``layers.unembed(..., gather=False)``) it is vocab-parallel — the
    [B, S, V] logits are never gathered: the log-sum-exp is the maximum
    over ``model`` (a constant for the gradient) plus the log of the
    exponentials' sum over ``model``, and the gold logit comes from the
    rank that holds the target id, the two sums in one ``all_reduce``.
    Every rank goes on with the same loss (``uses="same"``)."""
    lf = logits.float()
    if vocab is None or lf.shape[-1] == vocab:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    else:
        v = lf.shape[-1]
        top = shd.pmax(lf.amax(dim=-1), "model")
        local = targets.long() - shd.axis_index("model") * v
        hit = (local >= 0) & (local < v)
        gold = torch.gather(lf, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        gold = torch.where(hit, gold, torch.zeros((), device=lf.device))
        sums = shd.psum(torch.stack([
            torch.exp(lf - top[..., None]).sum(dim=-1), gold]), "model")
        logz = top + torch.log(sums[0])
        gold = sums[1]
    nll = (logz - gold) * mask
    num, den = nll.sum(), mask.sum()
    tok = shd.batch_axes()
    if tok:
        num, den = shd.psum(torch.stack([num, den]), tok).unbind(0)
    return num / torch.clamp_min(den, 1.0)


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


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _decode_specs(shape: ShapeConfig):
    return {"tokens": _meta((shape.global_batch, 1), torch.int32),
            "cur_index": _meta((), torch.int32)}


@functools.lru_cache(maxsize=None)
def param_specs(cfg):
    """(logical names, global ``meta`` shapes) of ``cfg``'s parameter
    tree: the FSDP gather of the leaves outside the layer stacks and the
    sharded train step's gradient sums read it."""
    init = build_model(cfg).init
    with L.logical_params():
        lg = init(device="cpu")
    with L.abstract_params():
        sh = init(device="cpu")
    return lg, sh


def _gather_top(params, names, cfg):
    """``params`` with the FSDP axes of the top-level entries ``names``
    gathered (one collective a mesh axis), under a mesh; the stacks'
    layers are gathered as they run."""
    if shd.active() is None:
        return params
    lg, sh = param_specs(cfg)
    pick = {}
    for path in names:
        p, l_, s_ = params, lg, sh
        for k in path:
            p, l_, s_ = p[k], l_[k], s_[k]
        pick[path] = (p, l_, s_)
    keys = list(pick)
    got = shd.fsdp_gather({str(i): pick[k][0] for i, k in enumerate(keys)},
                          {str(i): pick[k][1] for i, k in enumerate(keys)},
                          {str(i): pick[k][2] for i, k in enumerate(keys)})
    out = dict(params)
    for i, path in enumerate(keys):
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = got[str(i)]
    return out


def top_paths(cfg: ModelConfig):
    """The paths of the leaves outside the layer stacks that a sharded
    forward gathers first (:func:`_gather_top`)."""
    top = [("embed", k) for k in (("embedding",) if cfg.tie_embeddings
                                  else ("embedding", "unembed"))]
    if cfg.enc_dec:
        return top + [("frame_proj",), ("enc_norm",), ("final_norm",)]
    return top + [("stack", "final_norm")] + (
        [("projector",)] if cfg.modality == "vision" else [])


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
            if pe.shape[-1] != cfg.d_model:     # "act_model" over model
                pe = shd.all_gather(pe, "model", dim=-1, uses="same")
            x = torch.cat([pe, x], dim=1)
        return x

    top = top_paths(cfg)

    def forward(params, batch, *, mode: str, impl: str, caches=None,
                remat: bool = False):
        params = _gather_top(params, top, cfg)
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
        return (L.unembed(params["embed"], x, cfg, gather=mode != "train"),
                new_caches, aux)

    def loss_fn(params, batch, impl: str = "chunked"):
        """Next-token CE over ``batch["tokens"]`` [B,S] (after a vision
        config's optional ``patch_embeds``) plus the MoE aux losses.
        Returns (total, {"ce_loss", "load_balance_loss",
        "router_z_loss"}), 0-d f32 tensors.  Under a mesh the rank's
        rows and vocab columns (:func:`cross_entropy`); the values are
        the global ones on every rank."""
        logits, _, aux = forward(params, batch, mode="train", impl=impl,
                                 remat=True)
        n_front = batch["patch_embeds"].shape[1] if (
            is_vlm and "patch_embeds" in batch) else 0
        lg = logits[:, n_front:]
        targets = batch["tokens"][:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=lg.device)
        loss = cross_entropy(lg[:, :-1], targets, mask, cfg.vocab_size)
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

    def input_specs(shape: ShapeConfig):
        """The batch of ``shape`` as ``meta`` tensors: decode one token a
        row and ``cur_index``; prefill / train the tokens, after a vision
        config's ``min(frontend_tokens, seq // 2)`` stub patches."""
        if shape.kind == "decode":
            return _decode_specs(shape)
        b, s = shape.global_batch, shape.seq_len
        specs = {}
        if is_vlm:
            p = min(cfg.frontend_tokens, s // 2)
            specs["patch_embeds"] = _meta((b, p, cfg.d_model),
                                          torch.bfloat16)
            s = s - p
        specs["tokens"] = _meta((b, s), torch.int32)
        return specs

    def input_logical(shape: ShapeConfig):
        lg = {"tokens": ("batch", None)}
        if shape.kind == "decode":
            lg["cur_index"] = ()
        elif is_vlm:
            lg["patch_embeds"] = ("batch", None, None)
        return lg

    def cache_logical(quant: bool = False):
        return T.cache_logical(cfg, quant)

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, cache_init,
                       input_specs, input_logical, cache_logical)


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

    top = top_paths(cfg)

    def loss_fn(params, batch, impl: str = "chunked"):
        """Next-token CE of the decoder over ``batch["tokens"]`` [B,S]
        beside the encoded ``batch["frames"]`` [B,F,d].  Returns (loss,
        {"ce_loss": loss}); under a mesh as the text family's."""
        params = _gather_top(params, top, cfg)
        enc_out = E.encode(params, batch["frames"], cfg, impl=impl)
        x = L.embed(params["embed"], batch["tokens"], cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, _ = E.decode_stack(params, x, enc_out, cfg, mode="train",
                              positions=positions, impl=impl, remat=True)
        logits = L.unembed(params["embed"], x, cfg, gather=False)
        targets = batch["tokens"][:, 1:]
        loss = cross_entropy(logits[:, :-1], targets,
                             torch.ones(targets.shape, dtype=torch.float32,
                                        device=x.device), cfg.vocab_size)
        return loss, {"ce_loss": loss}

    def prefill(params, batch, impl: str = "chunked", caches=None):
        """``batch["frames"]`` [B,F,d] and ``batch["tokens"]`` [B,S] ->
        logits [B,S,V] (and, with ``caches``, the self caches after the
        target prefix and the cross K / V of the frames)."""
        params = _gather_top(params, top, cfg)
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
        params = _gather_top(params, top, cfg)
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

    def input_specs(shape: ShapeConfig):
        """The batch of ``shape`` as ``meta`` tensors: decode one token a
        row and ``cur_index``; else ``_frames_for(seq)`` stub frames and
        the tokens."""
        b = shape.global_batch
        if shape.kind == "decode":
            return _decode_specs(shape)
        f = _frames_for(cfg, shape.seq_len)
        return {"frames": _meta((b, f, cfg.d_model), torch.bfloat16),
                "tokens": _meta((b, shape.seq_len), torch.int32)}

    def input_logical(shape: ShapeConfig):
        lg = {"tokens": ("batch", None)}
        if shape.kind == "decode":
            lg["cur_index"] = ()
        else:
            lg["frames"] = ("batch", None, None)
        return lg

    def cache_logical(quant: bool = False):
        del quant
        kv = ("stack", "cache_batch", "cache_seq", "cache_heads", None)
        return {n: kv for n in ("k", "v", "xk", "xv")}

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, cache_init,
                       input_specs, input_logical, cache_logical)


def warm_specs(cfg) -> None:
    """Build the per-config specs the sharded forwards cache (the layer
    stacks' and the top-level leaves' logical names and global shapes),
    so that a counted run (the dry run's) counts the step alone."""
    if cfg.family == "climber":
        from repro_torch.core.climber import param_specs as climber_specs
        climber_specs(cfg)
        return
    param_specs(cfg)
    (E.layer_specs if cfg.enc_dec else T.layer_specs)(cfg)


def build_model(cfg):
    if cfg.family == "climber":
        from repro_torch.core.climber import build_climber
        return build_climber(cfg)
    if cfg.enc_dec:
        return _build_audio(cfg)
    return _build_text(cfg)
