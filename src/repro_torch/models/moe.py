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
K3 under ``impl="pallas"``.  ``moe_apply_a2a`` (expert-parallel
all-to-all dispatch over a device mesh) is not ported: it raises, naming
its ROADMAP.md item.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_init


def moe_init(cfg, *, generator, device, stacked: int = 0):
    """Router (f32) [d, E], experts [E, d, f] / [E, f, d] fanned in over
    axis 1 (as the JAX ``fan_in_axes=(1,)``), a gate for swiglu, and the
    shared expert (a dense FFN of d_ff ``f * num_shared_experts``)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    kw = dict(generator=generator, device=device, stacked=stacked)
    p = {"router": L.dense_init((d, e), dtype=torch.float32, **kw),
         "w_up": L.dense_init((e, d, f), fan_in_axes=(1,), **kw),
         "w_down": L.dense_init((e, f, d), fan_in_axes=(1,), **kw)}
    if cfg.activation == "swiglu":
        p["w_gate"] = L.dense_init((e, d, f), fan_in_axes=(1,), **kw)
    if m.num_shared_experts:
        p["shared"] = ffn_init(cfg, d_ff=f * m.num_shared_experts, **kw)
    return p


def _capacity(n_tokens: int, m) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8


def moe_dispatch(params, x, cfg,
                 impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """The JAX dispatch switch without a mesh: always :func:`moe_apply`
    (the all-to-all path needs an active mesh, which the port has not)."""
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
    gathered = torch.where(keep[:, None],
                           out_buf[torch.clamp(dest, 0, e * cap - 1)],
                           torch.zeros((), dtype=x.dtype, device=dev))
    contrib = gathered * gates.reshape(-1)[order][:, None].to(x.dtype)
    slot_of = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    slots = torch.sort(slot_of.reshape(t, k), dim=1).values     # [t,k]
    parts = contrib[slots]                                     # [t,k,d]
    combined = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        combined = combined + parts[:, j]

    if "shared" in params:
        combined = combined + ffn_apply(params["shared"], xt, cfg,
                                        impl=impl).reshape(t, d)

    aux = {"load_balance_loss": load_balance * m.load_balance_loss,
           "router_z_loss": z_loss * m.router_z_loss,
           "dropped_fraction": 1.0 - keep.float().mean()}
    return combined.reshape(b, s, d), aux


def moe_apply_a2a(params, x, cfg, *, mesh, axis: str = "data",
                  impl: str = "xla"):
    """Expert-parallel MoE with an explicit all-to-all over a device mesh:
    not ported yet."""
    raise NotImplementedError(
        "moe_apply_a2a (expert-parallel all-to-all dispatch over a device "
        "mesh) is not ported yet: ROADMAP.md, Queue 1 entry 5 (sharded "
        "serving)")
