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

The shared expert is a dense FFN through ``ffn_block(..., impl)``: kernel
K3 under ``impl="pallas"``.  Under a mesh the experts may be split over
the ``experts`` axes (the token exchange of :func:`moe_apply_a2a`) and
each expert's hidden over ``model`` (the down projection summed over
``model`` in f32); :func:`moe_apply_ep` is the ``"gspmd"`` setting's
exact exchange (the tokens gathered, each rank's experts' outputs summed).  :func:`moe_apply_a2a` is the expert-parallel
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
from repro_torch.models.ffn import ffn_block, ffn_init


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
    """The dispatch switch.  Under an active mesh where the rank holds a
    block of the experts (split over the rules' ``experts`` axes), the
    tokens are exchanged over those axes: :func:`moe_apply_ep` (the
    ``"gspmd"`` setting: :func:`moe_apply`'s function, its global
    capacity included; the tokens gathered, the outputs summed) or, under ``flags.moe_dispatch("a2a")``,
    :func:`moe_apply_a2a` (the JAX a2a function: capacity per shard).
    Else :func:`moe_apply_a2a` under ``"a2a"`` and a mesh whose data ways
    divide the experts, or :func:`moe_apply`.  (The JAX package also falls
    back when the global tokens do not divide the mesh; under SPMD ``x``
    is the rank's own block of tokens, so they divide by construction.)"""
    act = shd.active()
    e = cfg.moe.num_experts
    a2a = flags.MOE_DISPATCH.get() == "a2a"
    if act is not None and params["w_up"].shape[0] != e:
        axis = shd.spec_axes("experts", e)
        if a2a:
            return moe_apply_a2a(params, x, cfg, mesh=act[0], axis=axis,
                                 impl=impl)
        return moe_apply_ep(params, x, cfg, axis=axis, impl=impl)
    if a2a and act is not None:
        if e % shd.axis_size("data") == 0:
            return moe_apply_a2a(params, x, cfg, mesh=act[0], axis="data",
                                 impl=impl)
    return moe_apply(params, x, cfg, impl=impl)


def _expert_products(buf, w_up, w_gate, w_down, cfg, dtype):
    """The experts' FFNs on ``buf`` [E, C, d] (bmm).  Where the rank holds
    a block of each expert's hidden (``expert_mlp`` over ``model``), the
    down projection's partial sum is added over ``model`` in f32 and
    rounded once, and ``buf``'s gradient summed over ``model``."""
    if w_down.shape[1] != cfg.moe.d_ff_expert:
        buf = shd.psum_grad(buf)
    up = torch.bmm(buf, w_up)
    if w_gate is not None:
        g = torch.bmm(buf, w_gate)
        h = F.silu(g.float()) * up.float()
    else:
        h = L.gelu(up.float())
    h = h.to(dtype)
    if w_down.shape[1] != cfg.moe.d_ff_expert:
        return shd.model_sum(torch.bmm(h.float(), w_down.float()), dtype)
    return torch.bmm(h, w_down)


def _shared(params, xt, cfg, impl):
    m = cfg.moe
    return ffn_block(params["shared"], xt, cfg, impl=impl,
                     d_ff=m.d_ff_expert * m.num_shared_experts)


def moe_apply(params, x, cfg, impl: str = "xla", *,
              first: int = 0) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,d] -> (out [B,S,d], aux {load_balance_loss, router_z_loss,
    dropped_fraction}), the aux values 0-d f32 tensors.  ``params`` may
    hold a block of the experts, ``first`` on (:func:`moe_apply_ep`):
    the routing and the aux values are those of every expert, and ``out``
    sums the contributions of the held experts alone."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    held = params["w_up"].shape[0]
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
    mine = keep & (sorted_expert >= first) & (sorted_expert < first + held)
    dest = torch.where(mine, (sorted_expert - first) * cap + pos,
                       torch.full_like(pos, held * cap))  # scratch row

    buf = torch.zeros((held * cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, dest, xt[token_of])
    buf = buf[:-1].reshape(held, cap, d)

    # ---- expert GEMMs ----
    out_buf = _expert_products(buf, params["w_up"], params.get("w_gate"),
                               params["w_down"], cfg,
                               x.dtype).reshape(held * cap, d)

    # ---- combine: each token's k contributions in sorted order ----
    combined = _combine(out_buf, mine, dest, order, gates, t, k, held * cap)

    if "shared" in params:
        combined = combined + _shared(params, xt, cfg, impl).reshape(t, d)

    aux = {"load_balance_loss": load_balance * m.load_balance_loss,
           "router_z_loss": z_loss * m.router_z_loss,
           "dropped_fraction": 1.0 - keep.float().mean()}
    return combined.reshape(b, s, d), aux


def moe_apply_ep(params, x, cfg, *, axis,
                 impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """:func:`moe_apply` with the experts split over ``axis`` (SPMD, inside
    ``sharding.mesh_rules``): the same function as the JAX ``moe_apply``
    under GSPMD — the routing, the global capacity and which assignments
    it drops, the aux values.

    ``x`` [b, s, d] is the rank's block of the tokens (its batch rows over
    ``sharding.batch_axes()``); ``params`` hold the rank's ``E /
    ways(axis)`` experts.  The tokens are gathered over the batch axes
    (one ``all_gather`` an axis: t*d elements), so every rank routes every
    token in the global order, as one device would; :func:`moe_apply`
    dispatches them to the rank's block of the experts only, and the
    combined outputs (each token's contributions from the rank's experts)
    are added over ``axis`` (one ``all_reduce``).  The rank keeps its own
    rows.  The shared expert runs on the rank's own tokens.

    The backward: the gathered tokens' gradients are reduce-scattered
    (each rank's experts give a part), the sum's are summed over
    ``axis`` (each rank kept its own rows: ``uses="own"``), and the aux
    values — the same on every rank, from every token — pass ``1 /
    ways`` of their gradient on each of the batch axes' ranks, whose
    reduce-scatter adds the shares up."""
    if shd.active() is None:
        raise ValueError("moe_apply_ep runs inside sharding.mesh_rules(mesh)")
    e = cfg.moe.num_experts
    b = x.shape[0]
    n, held = shd.axis_size(axis), params["w_up"].shape[0]
    if e % n or held != e // n:
        raise ValueError(f"the rank holds {held} of {e} experts on {n} ways "
                         f"of {axis}")
    tok = shd.batch_axes()
    routed = {k: v for k, v in params.items() if k != "shared"}
    out, aux = moe_apply(routed, shd.gather_axis(x, tok, 0), cfg, impl=impl,
                         first=shd.axis_index(axis) * held)
    out = shd.psum(out, axis, uses="own").narrow(
        0, shd.axis_index(tok) * b, b)
    ways = shd.axis_size(tok)
    aux = {k: shd.grad_scale(v, 1.0 / ways) for k, v in aux.items()}
    if "shared" in params:
        t, d = b * x.shape[1], x.shape[2]
        out = out + _shared(params, x.reshape(t, d), cfg,
                            impl).reshape(x.shape)
    return out, aux


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


def moe_apply_a2a(params, x, cfg, *, mesh=None, axis="data",
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

    out = _expert_products(
        buf, w_up,
        local_experts(params["w_gate"]) if "w_gate" in params else None,
        w_down, cfg, x.dtype)

    back = out.reshape(e_local, n_shards, cap, d).transpose(0, 1).reshape(
        n_shards * e_local * cap, d)
    got = shd.all_to_all(back.contiguous(), axis)
    combined = _combine(got, keep, dest, order, gates, tl, k, e * cap)

    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, flat_expert, torch.ones(tl * k, dtype=torch.float32,
                                   device=dev)) / (tl * k)
    # the three aux means in one all-reduce an axis
    lb, zl, dropped = shd.pmean(torch.stack([
        e * torch.sum(me * ce),
        torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        1.0 - keep.float().mean()]), mesh.axis_names).unbind(0)

    if "shared" in params:
        combined = combined + _shared(params, xt, cfg, impl).reshape(tl, d)
    aux = {"load_balance_loss": lb * m.load_balance_loss,
           "router_z_loss": zl * m.router_z_loss,
           "dropped_fraction": dropped}
    return combined.reshape(b, s, d), aux
