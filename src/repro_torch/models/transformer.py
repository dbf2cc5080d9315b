"""Decoder layer stack with periodic layer patterns.  Port of
``repro/models/transformer.py`` for the ``rwkv`` layer kind.

Per-layer parameters are stacked by pattern group on a leading axis (one
group = one period of ``cfg.layer_pattern``), in the JAX package's names and
layouts, so ``params_from_jax`` loads them one to one; the JAX ``lax.scan``
over groups is a Python loop over that axis.  The ``attn``, ``swa`` and
``mamba`` kinds and MoE layers are not ported yet (ROADMAP.md, what is
left) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.tree import leaves, structure, tree_map, unflatten


def _check_kind(cfg, kind: str):
    if kind != "rwkv" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r}"
            f"{' with MoE' if cfg.moe is not None else ''} is not ported yet "
            f"(ROADMAP.md, what is left: the attention text kinds); the "
            f"port's text stack runs the rwkv kind")


def stack_init(cfg, *, generator, device):
    """Stacked-by-group parameters for the layer stack."""
    n_groups = cfg.n_groups
    layers = {}
    for j, kind in enumerate(cfg.layer_pattern):
        _check_kind(cfg, kind)
        layers[f"l{j}"] = {
            "norm1": L.norm_init(cfg, cfg.d_model, device=device,
                                 stacked=n_groups),
            "rwkv": R.rwkv_init(cfg, generator=generator, device=device,
                                stacked=n_groups),
            "norm2": L.norm_init(cfg, cfg.d_model, device=device,
                                 stacked=n_groups),
        }
    return {"layers": layers,
            "final_norm": L.norm_init(cfg, cfg.d_model, device=device)}


def init_caches(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
                device):
    """Decode caches, stacked over groups.  An rwkv layer's cache is O(1) in
    ``max_len``: the last token of the time-mix and channel-mix inputs and
    the f32 wkv state."""
    del max_len  # no per-position cache on the rwkv kind
    n_groups = cfg.n_groups
    hs = cfg.rwkv_head_size
    nh = cfg.d_model // hs
    caches = {}
    for j, kind in enumerate(cfg.layer_pattern):
        _check_kind(cfg, kind)
        caches[f"l{j}"] = {
            "x_tm": torch.zeros((n_groups, batch, cfg.d_model), dtype=dtype,
                                device=device),
            "x_cm": torch.zeros((n_groups, batch, cfg.d_model), dtype=dtype,
                                device=device),
            "state": torch.zeros((n_groups, batch, nh, hs, hs),
                                 dtype=torch.float32, device=device),
        }
    return caches


def layer_apply(p, x, cfg, kind: str, *, mode: str, cache=None):
    """One (time-mix + channel-mix) rwkv layer.  Returns (x, new_cache)."""
    _check_kind(cfg, kind)
    h = L.apply_norm(cfg, p["norm1"], x)
    x_prev = cache["x_tm"] if cache is not None else None
    st = cache["state"] if cache is not None else None
    y, (last_x, st_new) = R.time_mix(p["rwkv"], h, cfg, x_prev=x_prev,
                                     state=st, decode=(mode == "decode"))
    x = x + y
    h2 = L.apply_norm(cfg, p["norm2"], x)
    x_prev_cm = cache["x_cm"] if cache is not None else None
    f, last_cm = R.channel_mix(p["rwkv"], h2, cfg, x_prev=x_prev_cm)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "x_tm": last_x, "state": st_new,
                     "x_cm": last_cm}
    return x + f, new_cache


def stack_apply(params, x, cfg, *, mode: str, caches=None):
    """Run the full layer stack (a loop over pattern groups).  Returns
    (x, new_caches): the caches restacked over groups, or None without
    caches."""
    layers = params["layers"]
    n_groups = leaves(layers)[0].shape[0]
    per_group = []
    for g in range(n_groups):
        gp = tree_map(lambda a: a[g], layers)
        gc = tree_map(lambda a: a[g], caches) if caches is not None else None
        new: Dict[str, Any] = {}
        for j, kind in enumerate(cfg.layer_pattern):
            cj = gc.get(f"l{j}") if gc is not None else None
            x, nc = layer_apply(gp[f"l{j}"], x, cfg, kind, mode=mode,
                                cache=cj)
            if nc is not None:
                new[f"l{j}"] = nc
        per_group.append(new)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if caches is None:
        return x, None
    struct = structure(per_group[0])
    flat = [leaves(c) for c in per_group]
    return x, unflatten(struct, [torch.stack(ts) for ts in zip(*flat)])
