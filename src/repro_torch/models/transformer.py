"""Decoder layer stack with periodic layer patterns.  Port of
``repro/models/transformer.py``: the layer kinds ``attn`` (global),
``swa`` (sliding window), ``mamba`` and ``rwkv``, and MoE layers where
``cfg.moe.every_n_layers`` says (:func:`_is_moe_layer`, by the layer's
index within the period; a ``rwkv`` layer carries its own channel-mix and
no FFN).

Per-layer parameters are stacked by pattern group on a leading axis (one
group = one period of ``cfg.layer_pattern``), in the JAX package's names and
layouts, so ``params_from_jax`` loads them one to one; the JAX ``lax.scan``
over groups is a Python loop over that axis.  :func:`stack_apply` returns
the MoE layers' aux losses summed over the stack, as the JAX package does.

A decode step writes its state into the caches handed in, in place, for
every kind (through the per-group views of the stacked tensors): an
attention layer the new token's K / V into their slot, an rwkv or mamba
layer its O(1) states; :func:`stack_apply` returns those same caches.  The
JAX package builds new arrays; the values are the same (in the caches'
dtypes), and no cache is copied per step.  The slot and the valid lengths
come from device tensors (``index_put_``), so a captured CUDA graph reads
the position from its static buffer at replay.  A prefill into caches
returns new ones.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.ffn import ffn_block, ffn_init
from repro_torch.models.moe import moe_dispatch, moe_init
from repro_torch.tree import leaves, structure, tree_map, unflatten, unstack

KINDS = ("attn", "swa", "mamba", "rwkv")


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; the kinds are "
                         f"{KINDS}")


def _is_moe_layer(cfg, j: int) -> bool:
    return cfg.moe is not None and (j % cfg.moe.every_n_layers
                                    == cfg.moe.every_n_layers - 1)


def dense_ffn_layers(cfg):
    """The layers of one period that run a dense FFN (kernel K3 under
    ``impl="pallas"``): every layer but an ``rwkv`` one (its channel-mix
    is its own) and an MoE layer without a shared expert (its routed
    experts are ``torch.bmm``)."""
    return [j for j, kind in enumerate(cfg.layer_pattern)
            if kind != "rwkv" and (not _is_moe_layer(cfg, j)
                                   or cfg.moe.num_shared_experts)]


def stack_init(cfg, *, generator, device):
    """Stacked-by-group parameters for the layer stack."""
    n_groups = cfg.n_groups
    layers = {}
    for j, kind in enumerate(cfg.layer_pattern):
        _check_kind(kind)
        kw = dict(generator=generator, device=device, stacked=n_groups)
        p: Dict[str, Any] = {"norm1": L.norm_init(cfg, cfg.d_model,
                                                  device=device,
                                                  stacked=n_groups)}
        if kind == "rwkv":
            p["rwkv"] = R.rwkv_init(cfg, **kw)
        elif kind == "mamba":
            p["mamba"] = M.mamba_init(cfg, **kw)
        else:
            p["attn"] = A.qkv_init(cfg, **kw)
        p["norm2"] = L.norm_init(cfg, cfg.d_model, device=device,
                                 stacked=n_groups)
        if kind != "rwkv":   # rwkv carries its own channel-mix
            p["ffn"] = (moe_init(cfg, **kw) if _is_moe_layer(cfg, j)
                        else ffn_init(cfg, **kw))
        layers[f"l{j}"] = p
    return {"layers": layers,
            "final_norm": L.norm_init(cfg, cfg.d_model, device=device)}


@functools.lru_cache(maxsize=None)
def layer_specs(cfg):
    """Per layer ``l{j}`` of a pattern group: (logical names, global
    ``meta`` shapes) of its parameters, the stack axis dropped — what
    :func:`sharding.fsdp_gather` reads under a mesh."""
    with L.logical_params():
        lg = stack_init(cfg, generator=None, device="cpu")["layers"]
    with L.abstract_params():
        sh = stack_init(cfg, generator=None, device="cpu")["layers"]
    return (tree_map(lambda t: t[1:], lg, is_leaf=shd.is_logical),
            tree_map(lambda t: t[0], sh))


def cache_logical(cfg, quant: bool = False):
    """The logical names of :func:`init_caches`' leaves (the specs the JAX
    ``init_caches`` returns beside its caches)."""
    out = {}
    for j, kind in enumerate(cfg.layer_pattern):
        _check_kind(kind)
        if kind == "mamba":
            out[f"l{j}"] = {
                "conv": ("stack", "cache_batch", None, "ssm_inner"),
                "ssm": ("stack", "cache_batch", "ssm_inner", "ssm_state")}
        elif kind == "rwkv":
            out[f"l{j}"] = {
                "x_tm": ("stack", "cache_batch", "embed"),
                "x_cm": ("stack", "cache_batch", "embed"),
                "state": ("stack", "cache_batch", "heads", None, None)}
        else:
            kv = ("stack", "cache_batch", "cache_seq", "cache_heads", None)
            names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
            out[f"l{j}"] = {n: kv for n in names}
    return out


def cache_len(cfg, kind: str, max_len: int) -> int:
    """Slots of a layer's K / V cache: ``min(window, max_len)`` for a
    ``swa`` layer (a ring once ``max_len`` reaches the window), else
    ``max_len``."""
    if kind == "swa" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_caches(cfg, batch: int, max_len: int, *, dtype=torch.bfloat16,
                device, quant: bool = False):
    """Decode caches, stacked over groups.  An attention layer keeps K / V
    [G, B, clen, Hkv, D] (``quant=True``: int8 with per-(position, head)
    scales [..., 1] in ``dtype``); an rwkv layer's cache is O(1) in
    ``max_len``: the last token of the time-mix and channel-mix inputs and
    the f32 wkv state; a mamba layer's the last ``mamba_d_conv - 1`` conv
    inputs and the f32 ssm state [G, B, d_inner, N]."""
    n_groups = cfg.n_groups
    caches = {}
    for j, kind in enumerate(cfg.layer_pattern):
        _check_kind(kind)
        if kind == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            caches[f"l{j}"] = {
                "conv": torch.zeros((n_groups, batch, cfg.mamba_d_conv - 1,
                                     di), dtype=dtype, device=device),
                "ssm": torch.zeros((n_groups, batch, di, cfg.mamba_d_state),
                                   dtype=torch.float32, device=device),
            }
            continue
        if kind == "rwkv":
            hs = cfg.rwkv_head_size
            nh = cfg.d_model // hs
            caches[f"l{j}"] = {
                "x_tm": torch.zeros((n_groups, batch, cfg.d_model),
                                    dtype=dtype, device=device),
                "x_cm": torch.zeros((n_groups, batch, cfg.d_model),
                                    dtype=dtype, device=device),
                "state": torch.zeros((n_groups, batch, nh, hs, hs),
                                     dtype=torch.float32, device=device),
            }
            continue
        shape = (n_groups, batch, cache_len(cfg, kind, max_len),
                 cfg.n_kv_heads, cfg.head_dim)
        if quant:
            sshape = shape[:-1] + (1,)
            caches[f"l{j}"] = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=dtype, device=device),
                "v_scale": torch.zeros(sshape, dtype=dtype, device=device),
            }
        else:
            caches[f"l{j}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return caches


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _quantize_kv(x):
    """[B,S,H,D] -> (int8 values, bf16 per-(position, head) scales).  f32
    before the division and round half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp_min(scale, 1e-8)).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequant_kv(q, scale):
    return q.float() * scale.float()


def _dus_batch(cache, new, slot):
    """Write ``new`` [B,1,...] into ``cache`` [B,S,...] at row b's position
    ``slot[b]``, in place, and return ``cache``.  The slot is clamped into
    ``[0, S - 1]`` as ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = torch.clamp(slot, 0, cache.shape[1] - 1)
    cache.index_put_((rows, slot), new[:, 0].to(cache.dtype))
    return cache


def _lengths(cur_len, b: int):
    """``cur_len`` (a 0-d or [B] tensor) as contiguous int32 [B]."""
    return cur_len.to(torch.int32).reshape(-1).expand(b).contiguous()


def _attn_layer(p, x, cfg, kind, *, mode, positions, cache, cur_len, impl,
                mask_mode):
    """One attention mixer.  Under a mesh the rank holds its block of the
    query heads (and of the KV heads where they divide the model ways,
    else all of them: each rank reads the KV heads its query heads map
    to, :func:`attention.local_kv_heads`), its caches hold its batch
    rows and KV heads, and the out-projection's partial sum is added over
    ``model`` in f32 (``sharding.model_sum``).  Under the long-context
    rules a cache holds every KV head and the rank's slice of the
    positions (:func:`_split_cache_decode`).  The ranks hold whole
    sequences of their rows; under ``impl="cp"`` a prefill (or train)
    moves the heads to sequence blocks over ``model`` and runs
    :func:`attention.context_parallel_attention` where JAX's
    ``attention`` does (``attention.heads_attention``), and takes
    ``chunked`` elsewhere."""
    window = cfg.sliding_window if kind == "swa" else 0
    q, k, v = A.project_qkv(p["attn"], x, cfg, positions)
    quant = cache is not None and "k_scale" in cache
    seq_axes = shd.seq_split_axes() if cache is not None else ()
    if seq_axes and k.shape[2] != cache["k"].shape[2]:
        # the cache keeps every KV head: the model axis splits positions
        k = shd.all_gather(k, "model", dim=2)
        v = shd.all_gather(v, "model", dim=2)
    if mode == "decode" and seq_axes:
        o = _split_cache_decode(q, k, v, cache, cfg, positions=positions,
                                cur_len=cur_len, window=window,
                                axes=seq_axes, impl=impl)
        new_cache = cache
    elif mode == "decode":
        clen = cache["k"].shape[1]
        is_ring = bool(window) and clen <= window
        slot = positions[:, 0] % clen                 # ring (or identity) slot
        if quant:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                _dus_batch(cache[name], val, slot)
            k_cache = _dequant_kv(cache["k"], cache["k_scale"])
            v_cache = _dequant_kv(cache["v"], cache["v_scale"])
        else:
            k_cache = _dus_batch(cache["k"], k, slot)
            v_cache = _dus_batch(cache["v"], v, slot)
        new_cache = cache
        k_cache = A.local_kv_heads(k_cache, cfg, q.shape[2])
        v_cache = A.local_kv_heads(v_cache, cfg, q.shape[2])
        if is_ring:
            # the ring holds exactly the last <= window tokens; validity only
            o = A.decode_attention(q, k_cache, v_cache,
                                   torch.clamp(cur_len, max=clen), window=0)
        elif impl == "pallas":
            # kernel K4's single-token form
            from repro_torch.kernels.flash_decode.ops import flash_decode
            lens = _lengths(cur_len, q.shape[0])
            o = flash_decode(q[:, 0], k_cache.to(q.dtype),
                             v_cache.to(q.dtype), lens,
                             window=window)[:, None]
        else:
            o = A.decode_attention(q, k_cache, v_cache, cur_len,
                                   window=window)
    else:
        eff_mode = "sliding" if (kind == "swa" and window) else mask_mode
        o = A.heads_attention(q, k, v, cfg, eff_mode, impl=impl,
                              window=window)
        new_cache = None
        if cache is not None:  # prefill into cache buffers
            clen = cache["k"].shape[1] * shd.axis_size(seq_axes)
            s = k.shape[1]
            if clen < s:
                # ring cache: position p sits at slot p % clen; the last clen
                # positions [s-clen, s) land at slots rolled by s % clen.
                k_w = torch.roll(k[:, -clen:], s % clen, dims=1)
                v_w = torch.roll(v[:, -clen:], s % clen, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, clen - s)
                k_w, v_w = F.pad(k, pad), F.pad(v, pad)
            if seq_axes:   # the rank's slice of the positions
                loc = cache["k"].shape[1]
                off = shd.axis_index(seq_axes) * loc
                k_w, v_w = k_w.narrow(1, off, loc), v_w.narrow(1, off, loc)
            if quant:
                kq, ks = _quantize_kv(k_w)
                vq, vs = _quantize_kv(v_w)
                new_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            else:
                new_cache = {"k": k_w, "v": v_w}
    split = p["attn"]["wo"].shape[0] != cfg.n_heads
    out = A.project_out(p["attn"], o, partial=split)
    return (shd.model_sum(out, x.dtype) if split else out), new_cache


def _split_cache_decode(q, k, v, cache, cfg, *, positions, cur_len,
                        window: int, axes, impl: str):
    """One decode step over a cache whose positions are split over
    ``axes`` (the rank holds slots ``off ... off + loc`` of ``clen``):
    the token's K / V land on the rank that owns its slot, every rank
    attends its slots with all the query heads (gathered over ``model``),
    and the partial softmaxes merge across ``axes``
    (``sharding.softmax_merge``, f32).  Under ``impl="pallas"`` a cache
    that is not a ring runs kernel K4 on the rank's slots (its valid
    prefix there as the lengths), whose output and log-sum-exp are the
    rank's partial softmax; a ring decodes in plain PyTorch, as the
    mesh-less route (and JAX's) decodes it.  Returns the rank's query
    heads' output [B, 1, H_local, D]."""
    loc = cache["k"].shape[1]
    off = shd.axis_index(axes) * loc
    clen = loc * shd.axis_size(axes)
    is_ring = bool(window) and clen <= window
    slot = positions[:, 0] % clen - off
    own = (slot >= 0) & (slot < loc)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _dus_owned(cache[name], val, slot, own)
        k_cache = _dequant_kv(cache["k"], cache["k_scale"])
        v_cache = _dequant_kv(cache["v"], cache["v_scale"])
    else:
        k_cache = _dus_owned(cache["k"], k, slot, own)
        v_cache = _dus_owned(cache["v"], v, slot, own)
    h_loc = q.shape[2]
    split_q = h_loc != cfg.n_heads
    qa = shd.all_gather(q, "model", dim=2) if split_q else q
    b, _, h, d = qa.shape
    hkv = k_cache.shape[2]
    cur = cur_len.to(q.device).reshape(-1, 1)
    if impl == "pallas" and not is_ring:
        if window:   # cache_len makes a windowed cache a ring
            raise ValueError("a windowed cache longer than its window")
        from repro_torch.kernels.flash_decode.ops import flash_decode
        lens = torch.clamp(cur.expand(b, 1)[:, 0] - off, 0, loc)
        o_r, lse = flash_decode(qa[:, 0], k_cache.to(q.dtype),
                                v_cache.to(q.dtype),
                                lens.to(torch.int32).contiguous(),
                                return_lse=True)
        # the rank's normalized output as its partial state: max = lse,
        # sum 1 (0 on a rank with no valid slot, whose max stays finite)
        have = (lens > 0)[:, None].expand(b, h)
        m = torch.where(have, lse, torch.full_like(lse, A.NEG_INF))
        o = shd.softmax_merge(m, have.float(), o_r.float() * have[..., None],
                              axes)
        o = o.reshape(b, 1, h, d).to(q.dtype)
    else:
        qf = qa.float().reshape(b, hkv, h // hkv, d)
        s = torch.einsum("bhgd,bkhd->bhgk", qf,
                         k_cache.float()) / math.sqrt(d)
        pos = off + torch.arange(loc, device=q.device)[None, :]
        if is_ring:        # the ring holds exactly the last <= clen tokens
            valid = pos < torch.clamp(cur, max=clen)
        else:
            valid = pos < cur
            if window:
                valid = valid & (pos >= cur - window)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, A.NEG_INF))
        m = s.amax(dim=-1)
        pr = torch.where(valid, torch.exp(s - m[..., None]),
                         torch.zeros((), device=q.device))
        acc = torch.einsum("bhgk,bkhd->bhgd", pr, v_cache.float())
        o = shd.softmax_merge(m, pr.sum(dim=-1), acc, axes)
        o = o.reshape(b, 1, h, d).to(q.dtype)
    if split_q:
        o = o.narrow(2, shd.axis_index("model") * h_loc, h_loc)
    return o


def _dus_owned(cache, new, slot, own):
    """:func:`_dus_batch` on a slice of the positions: row b writes
    ``new[b]`` at local ``slot[b]`` where ``own[b]``, and leaves the
    cache as it was elsewhere (in place, no host sync)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(slot, 0, cache.shape[1] - 1)
    val = torch.where(own.reshape((-1,) + (1,) * (new.dim() - 2)),
                      new[:, 0].to(cache.dtype), cache[rows, at])
    cache.index_put_((rows, at), val)
    return cache


def _write_states(cache, new: Dict[str, Any], mode: str):
    """The O(1) states of a recurrent layer (rwkv, mamba) after the step:
    at decode copied into ``cache`` in place (and ``cache`` returned), at
    prefill a new dict."""
    if cache is None:
        return None
    if mode == "decode":
        for name, val in new.items():
            cache[name].copy_(val)
        return cache
    return {**cache, **new}


def layer_apply(p, x, cfg, kind: str, j: int, *, mode: str, positions=None,
                cache=None, cur_len=None, impl: str = "chunked",
                mask_mode: str = "causal"):
    """One (mixer + ffn) layer, ``j`` its index within the period (which
    says whether its FFN is MoE).  Returns (x, new_cache, aux): ``aux`` the
    MoE layer's losses and drop fraction, else empty."""
    _check_kind(kind)
    aux: Dict[str, Any] = {}
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind == "rwkv":
        x_prev = _whole_embed(cache["x_tm"], cfg) if cache is not None \
            else None
        st = cache["state"] if cache is not None else None
        y, (last_x, st_new) = R.time_mix(p["rwkv"], h, cfg, x_prev=x_prev,
                                         state=st,
                                         decode=(mode == "decode"),
                                         train=(mode == "train"))
        x = x + y
        h2 = L.apply_norm(cfg, p["norm2"], x)
        x_prev_cm = _whole_embed(cache["x_cm"], cfg) if cache is not None \
            else None
        f, last_cm = R.channel_mix(p["rwkv"], h2, cfg, x_prev=x_prev_cm)
        if cache is not None:
            last_x = _rank_embed(last_x, cache["x_tm"])
            last_cm = _rank_embed(last_cm, cache["x_cm"])
        new_cache = _write_states(cache, {"x_tm": last_x, "state": st_new,
                                          "x_cm": last_cm}, mode)
        return x + f, new_cache, aux
    if kind == "mamba":
        state = (cache["conv"], cache["ssm"]) if cache is not None else None
        y, (conv_s, ssm_s) = M.mamba_apply(p["mamba"], h, cfg, state=state,
                                           decode=(mode == "decode"))
        new_cache = _write_states(cache, {"conv": conv_s, "ssm": ssm_s},
                                  mode)
    else:
        y, new_cache = _attn_layer(p, h, cfg, kind, mode=mode,
                                   positions=positions, cache=cache,
                                   cur_len=cur_len, impl=impl,
                                   mask_mode=mask_mode)
    x = x + y
    h2 = L.apply_norm(cfg, p["norm2"], x)
    if _is_moe_layer(cfg, j):
        f, aux = moe_dispatch(p["ffn"], h2, cfg, impl=impl)
    else:
        f = ffn_block(p["ffn"], h2, cfg, impl=impl)
    return x + f, new_cache, aux


def _whole_embed(x, cfg):
    """A carried d_model state (rwkv's ``x_tm`` / ``x_cm``) whole: under
    the long-context rules with FSDP its ``embed`` axis is the rank's
    block over ``data``, gathered here."""
    if x.shape[-1] == cfg.d_model:
        return x
    return shd.gather_axis(x, shd.spec_axes("embed", cfg.d_model), -1)


def _rank_embed(x, like):
    """The rank's block of a whole d_model state ``x``, shaped as the
    cache leaf ``like`` (``x`` itself when the leaf is whole)."""
    loc = like.shape[-1]
    if x.shape[-1] == loc:
        return x
    return x.narrow(-1, shd.axis_index(shd.spec_axes("embed", x.shape[-1]))
                    * loc, loc)


def stack_apply(params, x, cfg, *, mode: str, positions=None, caches=None,
                cur_len=None, impl: str = "chunked",
                mask_mode: str = "causal", remat: bool = False):
    """Run the full layer stack (a loop over pattern groups).  Returns
    (x, new_caches, aux_sums): the caches None without caches; at decode
    the caches handed in, which every layer wrote in place; at prefill the
    new caches restacked over groups.  ``aux_sums``: the MoE layers'
    ``load_balance_loss`` and ``router_z_loss`` summed over the stack (0-d
    f32 tensors; zeros without MoE), as the JAX package sums them.

    ``mode="train"`` runs as ``"prefill"``; ``remat`` recomputes each
    pattern group in the backward pass (``torch.utils.checkpoint``, the
    JAX ``jax.checkpoint`` of a group), so only the groups' inputs are
    kept.  The stacked parameters are split per group once
    (:func:`~repro_torch.tree.unstack`)."""
    aux_acc = {name: torch.zeros((), dtype=torch.float32, device=x.device)
               for name in ("load_balance_loss", "router_z_loss")}

    specs = layer_specs(cfg) if shd.active() is not None else None

    def group_fn(x, gp, gc):
        new: Dict[str, Any] = {}
        aux_sum = {name: 0.0 for name in aux_acc}
        for j, kind in enumerate(cfg.layer_pattern):
            cj = gc.get(f"l{j}") if gc is not None else None
            pj = gp[f"l{j}"]
            if specs is not None:     # FSDP: the layer's weights whole
                pj = shd.fsdp_gather(pj, specs[0][f"l{j}"],
                                     specs[1][f"l{j}"])
            x, nc, aux = layer_apply(pj, x, cfg, kind, j,
                                     mode=mode, positions=positions,
                                     cache=cj, cur_len=cur_len, impl=impl,
                                     mask_mode=mask_mode)
            if nc is not None:
                new[f"l{j}"] = nc
            for name in aux_sum:
                if name in aux:
                    aux_sum[name] = aux_sum[name] + aux[name]
        return x, new, aux_sum

    groups = unstack(params["layers"])
    group_caches = (unstack(caches) if caches is not None
                    else [None] * len(groups))
    per_group = []
    for gp, gc in zip(groups, group_caches):
        if remat:
            x, new, aux_sum = shd.checkpoint(group_fn, x, gp, gc)
        else:
            x, new, aux_sum = group_fn(x, gp, gc)
        aux_acc = {name: aux_acc[name] + aux_sum[name] for name in aux_acc}
        per_group.append(new)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if caches is None:
        return x, None, aux_acc
    if mode == "decode":
        return x, caches, aux_acc
    struct = structure(per_group[0])
    flat = [leaves(c) for c in per_group]
    return x, unflatten(struct, [torch.stack(ts) for ts in zip(*flat)]), \
        aux_acc


def forward_collectives(cfg, data: int, model: int, *, fsdp: bool,
                        decode: bool = False, seq=(),
                        patches: bool = False,
                        cp_seq: int = 0) -> Dict[str, int]:
    """The collectives, by kind, that one sharded forward of a decoder
    family issues on a (data, model) mesh: a prefill, or with ``decode``
    one step.  Counted from the design of the sharded forwards:

    * with ``fsdp`` one gather of the top-level leaves and one a layer;
    * the embedding's psum and the logits' gather over a split vocabulary,
      and with ``patches`` the projector's gather;
    * a psum after each split product: attention's and rwkv's
      out-projections, dense FFNs, each expert's down projection, the
      shared experts;
    * Mamba's input gather and two psums;
    * where the data ways split the experts, the tokens gathered over the
      batch axes (when the batch is split) and the outputs summed.

    ``seq`` names the axes the rules give the caches' positions:
    ``("data", "model")`` under the long-context rules (the batch whole),
    ``("model",)`` under the dry run's serving profile.  Over those of
    more than one way, attention gathers K / V where the model ways split
    the KV heads, and a decode step gathers the query heads and merges the
    ranks' softmaxes (a max and a sum an axis).

    ``cp_seq``: a prefill of that many tokens under ``impl="cp"``.  Where
    the model ways (more than one) divide it, each attention layer moves
    its heads to sequence blocks and back (two ``all_to_all`` where the
    heads split, else the output blocks gathered), then exchanges the
    sliding halo (one ``p2p``, a window within a block) or gathers K and
    V."""
    got: Dict[str, int] = {}

    def add(kind, n=1):
        if n:
            got[kind] = got.get(kind, 0) + n

    def split(dim, ways):
        return int(ways > 1 and dim % ways == 0)
    ways = {"data": data, "model": model}
    seq_axes = [a for a in seq if ways[a] > 1]
    batch_split = data > 1 and "data" not in seq
    if fsdp and data > 1:
        add("all_gather", 1 + cfg.n_layers)
    add("all_reduce", split(cfg.vocab_size, model))
    add("all_gather", split(cfg.vocab_size, model))
    if patches:
        add("all_gather", split(cfg.d_model, model))
    n = cfg.n_groups
    for j, kind in enumerate(cfg.layer_pattern):
        if kind in ("attn", "swa"):
            heads = split(cfg.n_heads, model)
            add("all_reduce", n * heads)
            if cp_seq and not decode and split(cp_seq, model):
                add("all_to_all" if heads else "all_gather",
                    n * (2 if heads else 1))
                window = cfg.sliding_window if kind == "swa" else 0
                halo = bool(window) and window <= cp_seq // model
                add("p2p" if halo else "all_gather", n * (1 if halo else 2))
            if seq_axes:
                add("all_gather", 2 * n * split(cfg.n_kv_heads, model))
                if decode:
                    add("all_gather", n * heads)
                    add("all_reduce", 2 * n * len(seq_axes))
        if kind == "mamba":
            inner = split(2 * cfg.mamba_expand * cfg.d_model, model)
            add("all_gather", n * inner)
            add("all_reduce", 2 * n * inner)
        if kind == "rwkv":
            add("all_reduce", n * (split(cfg.d_model, model)
                                   + split(cfg.d_ff, model)))
            continue
        m = cfg.moe
        if not _is_moe_layer(cfg, j):
            add("all_reduce", n * split(cfg.d_ff, model))
            continue
        if split(m.num_experts, data):
            add("all_gather", n * batch_split)
            add("all_reduce", n)
        add("all_reduce", n * split(m.d_ff_expert, model))
        if m.num_shared_experts:
            add("all_reduce", n * split(m.d_ff_expert * m.num_shared_experts,
                                        model))
    return got



def _trailing_sum(cfg, j: int, data: int, model: int) -> int:
    """1 where layer ``j`` of the period ends with an ``all_reduce`` after
    its last product (the FFN's, the channel-mix's or the shared
    expert's sum over ``model``; without a shared expert, the routed
    experts' sum over their axis), which a recompute that stops at the
    last tensor the backward needs does not issue; else 0."""
    def split(dim, ways):
        return int(ways > 1 and dim % ways == 0)
    if not _is_moe_layer(cfg, j):
        return split(cfg.d_ff, model)
    m = cfg.moe
    if m.num_shared_experts:
        return split(m.d_ff_expert * m.num_shared_experts, model)
    return split(m.num_experts, data)


def train_collectives(cfg, data: int, model: int, *, fsdp: bool,
                      patches: bool = False, cp_seq: int = 0,
                      global_batch: int = 2,
                      dtypes=None) -> Dict[str, int]:
    """The collectives, by kind, that one sharded train step
    (``training.loop.make_train_step`` inside ``sharding.mesh_rules``) of
    a text or audio family issues on a (data, model) mesh, from the
    design:

    * the forward (:func:`forward_collectives` for a decoder), without the
      logits' gather — the loss is vocab-parallel: a max and a packed sum
      over ``model`` — and with the loss's sum over the split batch;
    * the remat'd layers' forward once more (a decoder's pattern groups,
      an encoder-decoder's decoder layers, recomputed in the backward
      with their FSDP gathers), up to the last tensor the backward needs
      (``sharding.checkpoint``): without a block's last product and the
      sum over ``model`` or the experts' axis that ends it
      (:func:`_trailing_sum`);
    * the backward's transposes: a ``reduce_scatter`` for each FSDP
      gather (one a dtype of the leaves it carried), each token and
      Mamba gather and each gathered K / V; an ``all_reduce`` for each
      ``psum_grad`` (the inputs of the split products: the query
      projection, and K / V where the KV heads are whole on every rank,
      the cross-attention's two inputs, the dense and shared FFNs, the
      experts, rwkv's mixed streams and lora, Mamba's input and
      ``x_dbc``, the unembedding) and for the experts' summed outputs;
      the all-to-alls and halos of ``impl="cp"`` again;
    * the gradients' sums over ``data`` (one ``all_reduce`` a dtype of
      the leaves replicated there) and the global norm's (one over every
      rank).

    ``cp_seq``: the tokens of a step under ``impl="cp"`` (0: another
    impl); ``global_batch`` picks the rules (``rules_for_shape``);
    ``dtypes`` maps a parameter's path (a tuple of keys) to its dtype
    (default: the initializers')."""
    got: Dict[str, int] = {}

    def add(kind, n=1):
        if n:
            got[kind] = got.get(kind, 0) + n

    def split(dim, ways):
        return int(ways > 1 and dim % ways == 0)
    mesh = shd.MeshShape(("data", "model"), (data, model))
    rules = shd.rules_for_shape(mesh, global_batch, fsdp=fsdp)
    batch_split = data > 1 and not rules.get("seq")
    vocab = split(cfg.vocab_size, model)
    heads = split(cfg.n_heads, model)
    kv = split(cfg.n_kv_heads, model)
    ffn = split(cfg.d_ff, model)
    cp = bool(cp_seq) and bool(split(cp_seq, model))

    def cp_pass(window: int, n: int, backward: bool):
        """An attention layer's context-parallel exchanges, ``n``
        times."""
        if not cp:
            return
        if heads:
            add("all_to_all", 2 * n)
        else:       # the blocks' gather; its backward is a narrow
            add("all_reduce" if backward else "all_gather", n)
        halo = bool(window) and window <= cp_seq // model
        add("p2p" if halo else
            ("reduce_scatter" if backward else "all_gather"),
            n * (1 if halo else 2))

    # the loss: the max and the packed sums over model, the batch's sum;
    # the unembedding's input gradient
    add("all_reduce", 3 * vocab + int(batch_split))
    if cfg.enc_dec:
        enc, dec = cfg.n_enc_layers, cfg.n_layers
        gathers = int(fsdp and data > 1)
        # forward (the decoder twice: remat) and the embedding's sum
        add("all_gather", gathers * (1 + enc + 2 * dec))
        add("all_reduce", vocab + enc * (heads + ffn)
            + dec * (2 * heads + ffn) + dec * 2 * heads)
        cp_pass(0, enc + 2 * dec, False)
        # backward: self-attention inputs, the cross-attention's query
        # and frames, the FFNs
        attn_in = heads + int(heads and not kv)
        add("all_reduce", enc * (attn_in + ffn)
            + dec * (attn_in + 2 * heads + ffn))
        cp_pass(0, enc + dec, True)
    else:
        fwd = forward_collectives(cfg, data, model, fsdp=fsdp,
                                  patches=patches, cp_seq=cp_seq)
        # the stack's recompute: all but the top-level leaves' gather,
        # the embedding's sum and the projector's gather
        top = {"all_gather": int(fsdp and data > 1) + vocab + (
            split(cfg.d_model, model) if patches else 0),
            "all_reduce": vocab}
        for kind, n in fwd.items():
            add(kind, 2 * n - top.get(kind, 0))
        add("all_gather", -vocab)           # no logits gathered
        n = cfg.n_groups
        add("all_reduce", -n * _trailing_sum(
            cfg, len(cfg.layer_pattern) - 1, data, model))
        for j, kind in enumerate(cfg.layer_pattern):
            if kind in ("attn", "swa"):
                add("all_reduce", n * (heads + int(heads and not kv)))
                cp_pass(cfg.sliding_window if kind == "swa" else 0, n,
                        True)
            if kind == "mamba" and split(
                    2 * cfg.mamba_expand * cfg.d_model, model):
                add("all_reduce", 2 * n)
                add("reduce_scatter", n)
            if kind == "rwkv":
                add("all_reduce", n * (2 * split(cfg.d_model, model)
                                       + split(cfg.d_ff, model)))
                continue
            m = cfg.moe
            if not _is_moe_layer(cfg, j):
                add("all_reduce", n * ffn)
                continue
            if split(m.num_experts, data):
                add("reduce_scatter", n * int(batch_split))
                add("all_reduce", n)
            add("all_reduce", n * split(m.d_ff_expert, model))
            if m.num_shared_experts:
                add("all_reduce", n * split(
                    m.d_ff_expert * m.num_shared_experts, model))
    # the FSDP gathers' reduce-scatters
    from repro_torch.models import model as MD
    from repro_torch.models.model import param_specs
    logical, shapes = param_specs(cfg)

    def dtype_of(path, t):
        return t.dtype if dtypes is None else dtypes(path)

    def fsdp_dtypes(lg, sh, path):
        """Distinct dtypes of the leaves one FSDP gather carries."""
        if isinstance(sh, dict):
            return set().union(*[fsdp_dtypes(lg[k], sh[k], path + (k,))
                                 for k in sh])
        spec = shd.logical_to_spec(lg, sh.shape, mesh, rules)
        return {dtype_of(path, sh) for e, name in zip(spec, lg)
                if name in shd.FSDP_NAMES and e is not None
                and data > 1 and "data" in shd._entry_axes(e)}
    if fsdp and data > 1:
        add("reduce_scatter", len(set().union(*[
            fsdp_dtypes(_at(logical, q), _at(shapes, q), q)
            for q in MD.top_paths(cfg)])))
        stacks = ([(cfg.n_enc_layers, ("enc",)), (cfg.n_layers, ("dec",))]
                  if cfg.enc_dec else
                  [(cfg.n_groups, ("stack", "layers", f"l{j}"))
                   for j in range(len(cfg.layer_pattern))])
        for reps, path in stacks:
            add("reduce_scatter", reps * len(fsdp_dtypes(
                tree_map(lambda t: t[1:], _at(logical, path),
                         is_leaf=shd.is_logical),
                tree_map(lambda t: t[0], _at(shapes, path)), path)))
    # the gradients' sums over data, the global norm's sum over the ranks
    sync = set()
    for path, (t, lg) in zip(_paths(shapes),
                             shd.zip_logical(shapes, logical)):
        spec = shd.logical_to_spec(lg, t.shape, mesh, rules)
        if data > 1 and "data" not in {a for e in spec
                                       for a in shd._entry_axes(e)}:
            sync.add(dtype_of(path, t))
    add("all_reduce", len(sync) + int(data * model > 1))
    return {k: v for k, v in got.items() if v}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, pre=()):
    """The key paths of a tree's leaves, in ``tree.leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], pre + (k,))]
    return [pre]
