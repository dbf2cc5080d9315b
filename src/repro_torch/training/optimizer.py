"""AdamW with the JAX package's arithmetic (port of
``repro/training/optimizer.py``).

The state mirrors the parameter tree: f32 moments ``mu`` / ``nu`` and an
int32 ``step`` (a 0-d tensor on the parameters' device, so nothing syncs
with the host).  The learning rate comes from the step before the
increment, the bias corrections from the step after it; both are computed
in f32 on the device, as JAX computes them.  The gradients are clipped by
their global norm, weight decay applies to every leaf, and each update is
done in f32 and cast back to the parameter's dtype.

:func:`adamw_update` writes the moments and the parameters in place under
``torch.no_grad()`` (the counterpart of JAX's ``donate_argnums``), one
slice of a leaf's leading axis at a time when the leaf is large, so that
its f32 temporaries stay bounded; the arithmetic is elementwise, so the
values do not depend on the slicing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.tree import leaves, tree_map

#: elements of a leaf updated at once: a leaf past it is sliced along its
#: leading axis (each f32 temporary of a slice at most 256 MB)
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> Dict[str, Any]:
    """Zero f32 moments shaped as the parameters, and step 0."""
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``: ``lr * min(1, (step + 1) / warmup)``
    in f32."""
    warm = torch.clamp_max(
        (step + 1).float() / _f32(max(cfg.warmup_steps, 1), step.device), 1.0)
    return _f32(cfg.lr, step.device) * warm


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """``t`` whole, or views of consecutive slices of its leading axis of
    at most :data:`SLICE_ELEMENTS` elements each (one row at least)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        yield t
        return
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    yield from t.split(rows, dim=0)


def global_norm(tree, split_axes: Optional[Sequence[tuple]] = None
                ) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in f32.

    Under a mesh ``tree`` holds the rank's blocks and ``split_axes`` (one
    entry a leaf, ``sharding.leaf_split_axes``) the mesh axes each is
    split over: the norm is that of the global tree.  Each leaf's sum of
    squares is divided by the number of ranks holding its block (a power
    of two on a mesh of power-of-two axes: exact) and the total is summed
    over every rank (one ``all_reduce``), so each block counts once."""
    flat = leaves(tree)
    if split_axes is None:
        split_axes = [()] * len(flat)
    total = None
    for g, axes in zip(flat, split_axes):
        rep = shd.replication(axes)
        for s in _slices(g):
            part = torch.sum(torch.square(s.float()))
            if rep > 1:
                part = part / rep
            total = part if total is None else total + part
    return torch.sqrt(shd.sum_ranks(total))


def adamw_update(cfg: AdamWConfig, grads, opt_state: Dict[str, Any],
                 params, split_axes: Optional[Sequence[tuple]] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step.  ``grads`` has the parameters' structure.  Updates
    ``params``, ``opt_state["mu"]`` / ``["nu"]`` and the step in place and
    returns (params, opt_state, {"grad_norm", "lr"}), the metrics 0-d f32
    tensors on the device.  Under a mesh the leaves are the rank's blocks
    and ``split_axes`` their split axes (:func:`global_norm`): the update
    is elementwise, so only the clip's norm reads other ranks."""
    with torch.no_grad():
        step = opt_state["step"]
        dev = step.device
        lr = _schedule(cfg, step)
        new_step = step + 1
        gn = global_norm(grads, split_axes)
        clip = torch.clamp_max(_f32(cfg.grad_clip, dev) / (gn + 1e-9), 1.0)
        bc1 = 1 - torch.pow(_f32(cfg.b1, dev), new_step.float())
        bc2 = 1 - torch.pow(_f32(cfg.b2, dev), new_step.float())
        for g, mu, nu, p in zip(leaves(grads), leaves(opt_state["mu"]),
                                leaves(opt_state["nu"]), leaves(params)):
            for gs, ms, ns, ps in zip(_slices(g), _slices(mu), _slices(nu),
                                      _slices(p)):
                g32 = gs.float() * clip
                ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
                ns.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
                p32 = ps.float()
                delta = (ms / bc1) / (torch.sqrt(ns / bc2) + cfg.eps) \
                    + cfg.weight_decay * p32
                ps.copy_(p32 - lr * delta)
        step.copy_(new_step)
    return params, opt_state, {"grad_norm": gn, "lr": lr}
