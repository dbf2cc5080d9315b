"""Sort-based fixed-capacity top-k mixture of experts.  Port of
``repro/models/moe.py``.

Dispatch is the sort / scatter formulation of the JAX package (no [T,E,C]
one-hot):

  1. router logits (f32) -> softmax -> top_k expert ids and gates per
     token, the gates renormalised;
  2. the (token, k) assignments sorted by expert id with a stable sort (as
     ``jnp.argsort``);
  3. position within the expert from running counts; an assignment past
     the capacity (from ``t = B*S``) goes to a scratch row and is dropped;
  4. rows scattered into an [E, C, d] buffer, the expert products batched
     over it (``torch.bmm``: the JAX package runs them as an ``einsum``,
     no Pallas kernel, so they are plain PyTorch here by design);
  5. gathered back, gate-weighted, and summed over k.

The combine is deterministic: where the JAX package adds a token's k
contributions with ``.at[token_of].add`` (in the sorted order, in the
token dtype), the port inverts the sort into a [t, k] slot map, gathers,
and adds over k in that same order; a scatter-add with atomics would make
a captured decode step differ from an eager one.  Nothing on the path
syncs with the host (no ``nonzero``, ``bincount``, boolean-mask indexing
or ``.item()``): the text engine captures its decode step as a CUDA graph.
``torch.topk`` on CUDA promises no order among tied probabilities; a tie
that changes a route is not expected of continuous router logits.

The shared expert is a dense FFN through ``ffn_apply(..., impl)``: kernel
K3 under ``impl="pallas"``.  :func:`moe_apply_a2a` is the expert-parallel
path over a device mesh (explicit all-to-all exchanges), taken by
:func:`moe_dispatch` under ``flags.moe_dispatch("a2a")`` and an active mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import flags
from repro_torch import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_init


def moe_init(cfg, *, generator, device, stacked: int = 0):
    """Router (f32) [d, E], experts [E, d, f] / [E, f, d] fanned in over
    axis 1 (as the JAX ``fan_in_axes=(1,)``), a gate for swiglu, and the
    shared expert (a dense FFN of d_ff ``f * num_shared_experts``)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    kw = dict(generator=generator, device=device, stacked=stacked)
    up = ("experts", "embed", "expert_mlp")
    p = {"router": L.dense_init((d, e), ("embed", None), dtype=torch.float32,
                                   **kw),
         "w_up": L.dense_init((e, d, f), up, fan_in_axes=(1,), **kw),
         "w_down": L.dense_init((e, f, d), ("experts", "expert_mlp", "embed"),
                               fan_in_axes=(1,), **kw)}
    if cfg.activation == "swiglu":
        p["w_gate"] = L.dense_init((e, d, f), up, fan_in_axes=(1,), **kw)
    if m.num_shared_experts:
        p["shared"] = ffn_init(cfg, d_ff=f * m.num_shared_experts, **kw)
    return p


def _capacity(n_tokens: int, m) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8


def moe_dispatch(params, x, cfg,
                 impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """The dispatch switch: :func:`moe_apply_a2a` under
    ``flags.moe_dispatch("a2a")`` and an active mesh whose data ways divide
    the experts, else :func:`moe_apply`.  (The JAX package also falls back
    when the global tokens do not divide the mesh; under SPMD ``x`` is the
    rank's own block of tokens, so they divide by construction.)"""
    act = shd.active()
    if flags.MOE_DISPATCH.get() == "a2a" and act is not None:
        if cfg.moe.num_experts % shd.axis_size("data") == 0:
            return moe_apply_a2a(params, x, cfg, mesh=act[0], axis="data",
                                 impl=impl)
    return moe_apply(params, x, cfg, impl=impl)


def moe_apply(params, x, cfg,
              impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """x [B,S,d] -> (out [B,S,d], aux {load_balance_loss, router_z_loss,
    dropped_fraction}), the aux values 0-d f32 tensors."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    cap = _capacity(t, m)
    dev = x.device
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, k, dim=-1)          # [t,k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (Switch-style) ----
    flat_expert = expert_idx.reshape(-1)                       # [t*k]
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, flat_expert, torch.ones(t * k, dtype=torch.float32,
                                   device=dev)) / (t * k)
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- sort-based dispatch ----
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    token_of = order // k                                      # source row
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[sorted_expert]
    keep = pos < cap
    dest = torch.where(keep, sorted_expert * cap + pos,
                       torch.full_like(pos, e * cap))   # overflow: scratch

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, dest, xt[token_of])
    buf = buf[:-1].reshape(e, cap, d)

    # ---- expert GEMMs ----
    up = torch.bmm(buf, params["w_up"])
    if "w_gate" in params:
        g = torch.bmm(buf, params["w_gate"])
        h = F.silu(g.float()) * up.float()
    else:
        h = L.gelu(up.float())
    out_buf = torch.bmm(h.to(x.dtype), params["w_down"]).reshape(e * cap, d)

    # ---- combine: each token's k contributions in sorted order ----
    combined = _combine(out_buf, keep, dest, order, gates, t, k, e * cap)

    if "shared" in params:
        combined = combined + ffn_apply(params["shared"], xt, cfg,
                                        impl=impl).reshape(t, d)

    aux = {"load_balance_loss": load_balance * m.load_balance_loss,
           "router_z_loss": z_loss * m.router_z_loss,
           "dropped_fraction": 1.0 - keep.float().mean()}
    return combined.reshape(b, s, d), aux


def _combine(out_rows, keep, dest, order, gates, t: int, k: int, cap_rows):
    """Each token's k expert outputs, gate-weighted and added over k in
    sorted order (:func:`moe_apply`'s deterministic combine)."""
    dev = out_rows.device
    gathered = torch.where(keep[:, None],
                           out_rows[torch.clamp(dest, 0, cap_rows - 1)],
                           torch.zeros((), dtype=out_rows.dtype, device=dev))
    contrib = gathered * gates.reshape(-1)[order][:, None].to(out_rows.dtype)
    slot_of = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    parts = contrib[torch.sort(slot_of.reshape(t, k), dim=1).values]
    combined = torch.zeros((t, out_rows.shape[1]), dtype=out_rows.dtype,
                           device=dev)
    for j in range(k):
        combined = combined + parts[:, j]
    return combined


def moe_apply_a2a(params, x, cfg, *, mesh=None, axis: str = "data",
                  impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel MoE with explicit all-to-all dispatch (SPMD: every
    rank of the active mesh calls it inside ``sharding.mesh_rules``).

    ``x`` [b, s, d] is this rank's block of the tokens (tokens are split
    over every mesh axis); the experts are split over ``axis`` (E %
    ways == 0): ``params`` holds either every expert (the rank takes its
    block) or the rank's ``E / ways``.  Each rank routes its tokens, packs
    a capacity-padded send buffer per (shard, expert), exchanges it with
    one ``all_to_all`` out and one back, runs its local experts between,
    and averages its aux losses over every axis.  The capacity per (shard,
    global expert) is ``ceil(t_local * k * capacity_factor / E)`` rounded
    up to 4, as the JAX package's."""
    act = shd.active()
    if act is None or (mesh is not None and act[0] is not mesh):
        raise ValueError("moe_apply_a2a runs inside sharding.mesh_rules(mesh)")
    mesh = act[0]
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    n_shards = shd.axis_size(axis)
    if e % n_shards:
        raise ValueError(f"{e} experts do not split {n_shards} ways")
    e_local = e // n_shards
    tl = b * s
    cap = int(math.ceil(tl * k * m.capacity_factor / e))
    cap = max(4, -(-cap // 4) * 4)
    dev = x.device
    xt = x.reshape(tl, d)

    def local_experts(w):
        if w.shape[0] == e_local:
            return w
        return w.narrow(0, shd.axis_index(axis) * e_local, e_local)
    w_up = local_experts(params["w_up"])
    w_down = local_experts(params["w_down"])

    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_expert = expert_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    token_of = order // k
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tl * k, device=dev) - starts[sorted_expert]
    keep = pos < cap
    dest = torch.where(keep, sorted_expert * cap + pos,
                       torch.full_like(pos, e * cap))

    send = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    send.index_copy_(0, dest, xt[token_of])
    # shard i's tokens for shard j's experts go to shard j
    recv = shd.all_to_all(send[:-1], axis)
    buf = recv.reshape(n_shards, e_local, cap, d).transpose(0, 1).reshape(
        e_local, n_shards * cap, d)

    up = torch.bmm(buf, w_up)
    if "w_gate" in params:
        g = torch.bmm(buf, local_experts(params["w_gate"]))
        h = F.silu(g.float()) * up.float()
    else:
        h = L.gelu(up.float())
    out = torch.bmm(h.to(x.dtype), w_down)

    back = out.reshape(e_local, n_shards, cap, d).transpose(0, 1).reshape(
        n_shards * e_local * cap, d)
    got = shd.all_to_all(back.contiguous(), axis)
    combined = _combine(got, keep, dest, order, gates, tl, k, e * cap)

    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, flat_expert, torch.ones(tl * k, dtype=torch.float32,
                                   device=dev)) / (tl * k)
    every = mesh.axis_names
    lb = shd.pmean(e * torch.sum(me * ce), every)
    zl = shd.pmean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2), every)
    dropped = shd.pmean(1.0 - keep.float().mean(), every)

    if "shared" in params:
        combined = combined + ffn_apply(params["shared"], xt, cfg,
                                        impl=impl).reshape(tl, d)
    aux = {"load_balance_loss": lb * m.load_balance_loss,
           "router_z_loss": zl * m.router_z_loss,
           "dropped_fraction": dropped}
    return combined.reshape(b, s, d), aux
