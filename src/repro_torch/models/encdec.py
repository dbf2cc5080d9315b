"""Encoder-decoder transformer (seamless-m4t style) for the audio family.
Port of ``repro/models/encdec.py``.

The audio frontend (mel-spectrogram + conformer conv feature extractor) is a
stub, as in the JAX package: the model consumes precomputed frame
embeddings [B, n_frames, d].  Encoder = bidirectional self-attention
(``full``); decoder = causal self-attention + cross-attention (``full``,
Sq != Sk) to the encoder output.  Decode carries a self-attention K/V cache
plus the precomputed cross-attention K/V.

Under ``impl="pallas"`` the encoder's and decoder's attention runs kernel
K2 (the cross-attention with Sq != Sk) and every FFN kernel K3; a decode
step's attention is ``decode_attention`` under every impl, as in the JAX
package (no K4).  A decode step writes the new token's K / V into the self
caches handed in, in place (the port's rule for every cache); the JAX
package builds new arrays.  The layers are a Python loop over the stacked
parameters (the JAX ``lax.scan``).  Under a mesh each layer's FSDP axes
are gathered as it runs and the three attentions and the FFN split their
heads / hidden over ``model``, as the decoder-only stack does
(``models/transformer.py``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_block, ffn_init
from repro_torch.models.transformer import _dus_batch
from repro_torch.tree import leaves, structure, tree_map, unflatten, unstack


def encdec_init(cfg, *, generator, device):
    ng_e, ng_d = cfg.n_enc_layers, cfg.n_layers
    kw = dict(generator=generator, device=device)

    def norm(n):
        return L.norm_init(cfg, cfg.d_model, device=device, stacked=n)
    enc_layers = {
        "norm1": norm(ng_e),
        "attn": A.qkv_init(cfg, stacked=ng_e, **kw),
        "norm2": norm(ng_e),
        "ffn": ffn_init(cfg, stacked=ng_e, **kw),
    }
    dec_layers = {
        "norm1": norm(ng_d),
        "self_attn": A.qkv_init(cfg, stacked=ng_d, **kw),
        "norm_x": norm(ng_d),
        "cross_attn": A.qkv_init(cfg, stacked=ng_d, **kw),
        "norm2": norm(ng_d),
        "ffn": ffn_init(cfg, stacked=ng_d, **kw),
    }
    return {
        "frame_proj": L.dense_init((cfg.d_model, cfg.d_model),
                                   ("embed", "embed_fsdp"), **kw),
        "enc": enc_layers,
        "enc_norm": L.norm_init(cfg, cfg.d_model, device=device),
        "dec": dec_layers,
        "final_norm": L.norm_init(cfg, cfg.d_model, device=device),
    }


@functools.lru_cache(maxsize=None)
def layer_specs(cfg):
    """(logical names, global ``meta`` shapes) of one encoder layer's and
    one decoder layer's parameters, the stack axis dropped, by ``"enc"``
    / ``"dec"``: what :func:`sharding.fsdp_gather` reads under a mesh."""
    with L.logical_params():
        lg = encdec_init(cfg, generator=None, device="cpu")
    with L.abstract_params():
        sh = encdec_init(cfg, generator=None, device="cpu")
    return {part: (tree_map(lambda t: t[1:], lg[part],
                            is_leaf=shd.is_logical),
                   tree_map(lambda t: t[0], sh[part]))
            for part in ("enc", "dec")}


def _gathered(p, cfg, part: str):
    """One layer of stack ``part`` with its FSDP axes gathered under a
    mesh (``p`` itself outside one)."""
    if shd.active() is None:
        return p
    lg, sh = layer_specs(cfg)[part]
    return shd.fsdp_gather(p, lg, sh)


def _layers(params, cfg, part: str):
    """The layers of stack ``part`` one by one, each with its FSDP axes
    gathered under a mesh (as it is about to run)."""
    return (_gathered(p, cfg, part) for p in unstack(params[part]))


def _self_attention(p, q, k, v, cfg, mode: str, impl: str):
    """Attention of the rank's query heads (``attention.heads_attention``:
    under ``impl="cp"`` context-parallel over ``model`` where JAX's runs
    it — the encoder's and the decoder's self-attention — and ``chunked``
    for the cross-attention, whose keys are the frames), then the
    out-projection, added over ``model`` where the heads are split."""
    o = A.heads_attention(q, k, v, cfg, mode, impl=impl)
    return _out(p, o, q.dtype, cfg)


def _out(p, o, dtype, cfg):
    split = p["wo"].shape[0] != cfg.n_heads
    out = A.project_out(p, o, partial=split)
    return shd.model_sum(out, dtype) if split else out


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None].expand(b, s)


def encode(params, frames, cfg, *, impl="chunked"):
    """frames [B,F,d] (stub frontend embeddings) -> encoder states
    [B,F,d]."""
    x = torch.matmul(frames, params["frame_proj"])
    positions = _positions(x)
    for p in _layers(params, cfg, "enc"):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        x = x + _self_attention(p["attn"], q, k, v, cfg, "full", impl)
        h2 = L.apply_norm(cfg, p["norm2"], x)
        x = x + ffn_block(p["ffn"], h2, cfg, impl=impl)
    return L.apply_norm(cfg, params["enc_norm"], x)


def cross_kv(params, enc_out, cfg):
    """Per-decoder-layer cross K/V, stacked: [L,B,F,Hkv,D] x2."""
    pos = _positions(enc_out)
    kv = [A.project_qkv(p["cross_attn"], enc_out, cfg, pos)[1:]
          for p in _layers(params, cfg, "dec")]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def decode_stack(params, x, enc_out, cfg, *, mode, positions, caches=None,
                 cur_len=None, impl="chunked", remat: bool = False):
    """Decoder over targets x [B,S,d].  ``caches``: {"k", "v"} stacked self
    caches + {"xk", "xv"} cross K/V (precomputed for decode).  Returns
    (x, new_caches): at decode the caches handed in, their self caches
    written in place; at prefill new self caches (the prompt's K / V
    padded to the cache length) beside the cross K / V handed in.
    ``mode="train"`` runs as ``"prefill"``; ``remat`` recomputes each
    decoder layer in the backward pass (the JAX ``jax.checkpoint`` of a
    layer)."""
    dec = unstack(params["dec"])
    per_layer = unstack(caches) if caches is not None else [None] * len(dec)
    new = []

    def body(x, p, cache):
        p = _gathered(p, cfg, "dec")       # inside the recompute, as JAX's
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["self_attn"], h, cfg, positions)
        new_cache = None
        if mode == "decode":
            slot = positions[:, 0]
            k_c = _dus_batch(cache["k"], k, slot)
            v_c = _dus_batch(cache["v"], v, slot)
            h_loc = q.shape[2]
            o = _out(p["self_attn"], A.decode_attention(
                q, A.local_kv_heads(k_c, cfg, h_loc),
                A.local_kv_heads(v_c, cfg, h_loc), cur_len), x.dtype, cfg)
        else:
            o = _self_attention(p["self_attn"], q, k, v, cfg, "causal", impl)
            if cache is not None:
                pad = (0, 0, 0, 0, 0, cache["k"].shape[1] - k.shape[1])
                new_cache = {"k": torch.nn.functional.pad(k, pad),
                             "v": torch.nn.functional.pad(v, pad)}
        x = x + o

        # cross attention (full mask over the encoder frames)
        hx = L.apply_norm(cfg, p["norm_x"], x)
        split = p["cross_attn"]["wq"].shape[1] != cfg.n_heads
        qx = A._proj(shd.psum_grad(hx) if split else hx,
                     p["cross_attn"]["wq"])
        if "bq" in p["cross_attn"]:
            qx = qx + p["cross_attn"]["bq"]
        qx = L.rope(qx, positions, cfg.rope_theta)
        h_loc = qx.shape[2]
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
            n_frames = torch.full((1,), xk.shape[1], dtype=torch.int64,
                                  device=x.device)
            ox = A.decode_attention(qx, A.local_kv_heads(xk, cfg, h_loc),
                                    A.local_kv_heads(xv, cfg, h_loc),
                                    n_frames)
            x = x + _out(p["cross_attn"], ox, x.dtype, cfg)
        else:
            _, xk, xv = A.project_qkv(p["cross_attn"], enc_out, cfg,
                                      _positions(enc_out))
            x = x + _self_attention(p["cross_attn"], qx, xk, xv, cfg, "full",
                                    impl)

        h2 = L.apply_norm(cfg, p["norm2"], x)
        return x + ffn_block(p["ffn"], h2, cfg, impl=impl), new_cache

    for p, cache in zip(dec, per_layer):
        if remat:
            x, new_cache = shd.checkpoint(body, x, p, cache)
        else:
            x, new_cache = body(x, p, cache)
        new.append(new_cache)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if caches is None:
        return x, None
    if mode == "decode":
        return x, caches
    flat = [leaves(c) for c in new]
    stacked = unflatten(structure(new[0]),
                        [torch.stack(ts) for ts in zip(*flat)])
    return x, {**stacked, "xk": caches["xk"], "xv": caches["xv"]}


def init_dec_caches(cfg, batch: int, max_len: int, n_frames: int, *,
                    dtype=torch.bfloat16, device):
    """Decoder self caches + cross K/V placeholders, stacked over layers."""
    shape_self = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    shape_cross = (cfg.n_layers, batch, n_frames, cfg.n_kv_heads,
                   cfg.head_dim)
    return {"k": torch.zeros(shape_self, dtype=dtype, device=device),
            "v": torch.zeros(shape_self, dtype=dtype, device=device),
            "xk": torch.zeros(shape_cross, dtype=dtype, device=device),
            "xv": torch.zeros(shape_cross, dtype=dtype, device=device)}
