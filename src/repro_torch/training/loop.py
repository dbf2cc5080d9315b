"""Training loop (port of ``repro/training/loop.py``): a train step of
autograd plus :func:`~repro_torch.training.optimizer.adamw_update`, and the
host loop that runs it.

The gradients are taken with ``torch.autograd.grad`` over the parameter
leaves.  A leaf that the loss does not use gets a zero gradient, as under
``jax.value_and_grad``, so weight decay still moves it; a leaf the loss
uses always gets autograd's gradient.  The step updates the parameters
and the optimizer state in place.  The loop syncs with the host only on
logged steps (and once at the end).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.devices import resolve_device
from repro_torch.tree import leaves
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)


def grads_of(loss: torch.Tensor, params, seed: float = 1.0
             ) -> List[torch.Tensor]:
    """d loss / d leaf for every leaf of ``params`` (each requiring grad),
    in :func:`~repro_torch.tree.leaves` order, times ``seed``; zeros for a
    leaf the loss does not reach."""
    flat = leaves(params)
    grads = torch.autograd.grad(
        loss, flat, None if seed == 1.0 else torch.full_like(loss, seed),
        allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)]


def make_train_step(bundle, opt_cfg: AdamWConfig,
                    impl: str = "chunked") -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    parameters (leaves requiring grad) and the state updated in place;
    the metrics 0-d tensors on the device (``loss``, the loss's metrics,
    ``grad_norm``, ``lr``).

    Inside ``sharding.mesh_rules`` the step is the rank's: ``params``,
    the optimizer state and the batch are its blocks (``shard_params``
    under the active rules), the loss is the global one on every rank,
    and the backward runs the sharded forward's collectives' transposes
    — an FSDP leaf's gradient is reduce-scattered over the batch axes
    (``sharding.fsdp_gather``), a leaf replicated over a batch axis has
    its gradient summed there (``sharding.sync_grads``), and the rank's
    block of a leaf split over ``model`` is its own.  AdamW then updates
    the blocks, the clip reading the global norm
    (``optimizer.global_norm``).  The text and audio families (Climber's
    sharded step is not ported)."""

    def train_step(params, opt_state, batch, events=None):
        sharded = shd.active() is not None
        if sharded and bundle.cfg.family == "climber":
            raise NotImplementedError("the sharded train step covers the "
                                      "text and audio families, not "
                                      "Climber")
        loss, metrics = bundle.loss_fn(params, batch, impl=impl)
        split_axes = None
        if not sharded:
            grads = grads_of(loss, params)
        else:
            from repro_torch.models.model import param_specs
            logical, shapes = param_specs(bundle.cfg)
            split_axes = shd.leaf_split_axes(logical, shapes)
            grads = shd.sync_grads(
                grads_of(loss, params, 1.0 / shd.batch_redundancy()),
                split_axes)
        if events is not None:
            events[1].record()
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, split_axes)
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in
                                      metrics.items()}, **opt_metrics}

    return train_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """A numpy batch as tensors on ``device`` (same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train(bundle, batches: Iterator[Dict], n_steps: int,
          opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
          log_every: int = 10, impl: str = "chunked", params=None,
          callback: Optional[Callable] = None, device="cuda",
          step_times: Optional[list] = None):
    """The host loop: returns (params, opt_state, history).

    ``params`` default to ``bundle.init`` from a generator seeded with
    ``seed`` on ``device`` (``"cuda"`` by default: raises without a GPU);
    given params are trained in place on their own device.  ``batches``
    yields numpy batches, moved to the device each step.  ``history``
    holds one dict per logged step (every ``log_every`` and the last):
    ``loss``, the loss's metrics, ``grad_norm``, ``lr`` as floats,
    ``step``, ``wall_s``.  The returned parameters no longer require grad.

    ``step_times``, when a list, receives one dict per step after the run:
    ``fwd_bwd_ms`` (loss and gradients), ``opt_ms`` (the AdamW update)
    and ``step_ms`` (from this step's start to the next's: the next
    batch's move to the device and any wait for the host included), from
    CUDA events on the card and from the host clock on the CPU."""
    opt_cfg = opt_cfg or AdamWConfig()
    if params is None:
        dev = resolve_device(device)
        params = bundle.init(torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    dev = leaves(params)[0].device
    for p in leaves(params):
        p.requires_grad_(True)
    opt_state = adamw_init(params)
    step_fn = make_train_step(bundle, opt_cfg, impl=impl)
    marks = []
    history = []
    t0 = time.perf_counter()
    for step in range(n_steps):
        batch = to_device(next(batches), dev)
        events = _marks(dev) if step_times is not None else None
        if events is not None:
            events[0].record()
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             events)
        if events is not None:
            events[2].record()
            marks.append(events)
        if step % log_every == 0 or step == n_steps - 1:
            names = list(metrics)
            values = torch.stack([metrics[k].float().reshape(())
                                  for k in names]).tolist()
            entry = dict(zip(names, values))
            entry["step"] = step
            entry["wall_s"] = time.perf_counter() - t0
            history.append(entry)
            if callback:
                callback(entry)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for p in leaves(params):
        p.requires_grad_(False)
    if step_times is not None:
        step_times.extend(_step_times(marks))
    return params, opt_state, history


class _HostMark:
    """A CPU stand-in for a CUDA event: the host clock (CPU tensors are
    computed before an op returns)."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _marks(dev):
    if dev.type == "cuda":
        return [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    return [_HostMark() for _ in range(3)]


def _step_times(marks) -> List[Dict[str, float]]:
    out = []
    for i, (start, grads_done, end) in enumerate(marks):
        nxt = marks[i + 1][0] if i + 1 < len(marks) else end
        out.append({"step": i,
                    "fwd_bwd_ms": start.elapsed_time(grads_done),
                    "opt_ms": grads_done.elapsed_time(end),
                    "step_ms": start.elapsed_time(nxt)})
    return out
