"""Shared building blocks: initializers, norms, RoPE, activations.

Port of ``repro/models/layers.py``.  Norms and RoPE compute in float32 and
cast back to the input dtype, exactly as the JAX package does; parameters
default to bfloat16 like ``repro.models.layers.dense_init``."""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd

# under logical_params() every initializer returns its logical axis names
# (the JAX ``Param`` spec) instead of a tensor
_LOGICAL = contextvars.ContextVar("repro_torch_logical_params", default=False)


@contextlib.contextmanager
def logical_params():
    """Make the initializers return logical axis names: ``bundle.init``
    then builds the logical tree of its parameters
    (``sharding.param_logical``)."""
    tok = _LOGICAL.set(True)
    try:
        yield
    finally:
        _LOGICAL.reset(tok)


def logical_leaf(logical, stacked: int = 0) -> Optional[Tuple]:
    """The logical names of a leaf (with the ``"stack"`` axis of a stacked
    one) when the initializers record names, else None."""
    if not _LOGICAL.get():
        return None
    return (("stack",) if stacked else ()) + tuple(logical)


# under abstract_params() every initializer returns an empty ``meta``
# tensor of its shape and dtype (the JAX ``jax.eval_shape`` of an init)
_ABSTRACT = contextvars.ContextVar("repro_torch_abstract_params",
                                   default=False)


@contextlib.contextmanager
def abstract_params():
    """Make the initializers return ``meta`` tensors of their shapes and
    dtypes: ``bundle.init`` then builds a tree that allocates nothing and
    draws no random number (a trillion-parameter model's shapes)."""
    tok = _ABSTRACT.set(True)
    try:
        yield
    finally:
        _ABSTRACT.reset(tok)


def abstract_leaf(shape: Sequence[int], dtype,
                  stacked: int = 0) -> Optional[torch.Tensor]:
    """A ``meta`` tensor of the leaf's shape (with the stack axis) and
    dtype under :func:`abstract_params`, else None."""
    if not _ABSTRACT.get():
        return None
    shape = ((stacked,) if stacked else ()) + tuple(shape)
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# initializers (the port's own random numbers: a torch.Generator, never the
# JAX key stream — tests share weights through ``params_from_jax`` instead)
# ---------------------------------------------------------------------------

def dense_init(shape: Sequence[int], logical: Sequence[Optional[str]], *,
               generator: torch.Generator, device, dtype=torch.bfloat16,
               scale: Optional[float] = None, stacked: int = 0,
               fan_in_axes=None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) dense init, fan-in scaled; ``stacked``
    prepends a layer-stack axis.  Same distribution as the JAX
    ``dense_init``; the values differ (another generator).  ``logical``
    names the axes, as the JAX spec."""
    names = logical_leaf(logical, stacked)
    if names is not None:
        return names
    meta = abstract_leaf(shape, dtype, stacked)
    if meta is not None:
        return meta
    shape = tuple(shape)
    if fan_in_axes is None:
        fan_in_axes = tuple(range(len(shape) - 1)) if len(shape) >= 2 else (0,)
    fan_in = math.prod(shape[a] for a in fan_in_axes)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    def draw(shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        # scaled in place: one f32 copy is held at a time, not two
        return w.mul_(scale).to(dtype)

    if not stacked:
        return draw(shape)
    # a stacked leaf is drawn one layer at a time, so that the f32 draw
    # holds one layer (qwen2-72b's w_gate: 0.97 GB, not 77.5 GB at 80)
    out = torch.empty((stacked,) + shape, dtype=dtype, device=device)
    for i in range(stacked):
        out[i] = draw(shape)
    return out


def full_init(shape: Sequence[int], logical: Sequence[Optional[str]],
              fill: float, *, device, dtype=torch.bfloat16,
              stacked: int = 0) -> torch.Tensor:
    names = logical_leaf(logical, stacked)
    if names is not None:
        return names
    meta = abstract_leaf(shape, dtype, stacked)
    if meta is not None:
        return meta
    shape = ((stacked,) if stacked else ()) + tuple(shape)
    return torch.full(shape, fill, dtype=dtype, device=device)


def norm_init(cfg, d: int, *, device, stacked: int = 0):
    if cfg.norm == "rmsnorm":
        return {"scale": full_init((d,), ("embed",), 0.0, device=device,
                                   stacked=stacked)}
    return {"scale": full_init((d,), ("embed",), 1.0, device=device,
                               stacked=stacked),
            "bias": full_init((d,), ("embed",), 0.0, device=device,
                              stacked=stacked)}


# ---------------------------------------------------------------------------
# norms (always computed in f32, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """Population variance (``jnp.var``), not torch's unbiased default."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, params, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# rotary embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S].  theta == 0 disables RoPE."""
    if theta == 0.0:
        return x
    d = x.shape[-1]
    d2 = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(d2, dtype=torch.float32, device=x.device)
                      / d2)
    ang = positions[..., :, None].float() * freqs            # [..., S, d2]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, d2]
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:2 * d2].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                    dim=-1).to(x.dtype)
    if d > 2 * d2:
        out = torch.cat([out, x[..., 2 * d2:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(cfg, *, generator: torch.Generator, device):
    p = {"embedding": dense_init((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"), scale=0.02,
                                 generator=generator, device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"), generator=generator,
                                  device=device)
    return p


def embed(params, tokens, cfg):
    """Rows ``tokens`` of the table; under a mesh its ``vocab`` rows may be
    the rank's block (``sharding.embed_lookup``)."""
    return shd.embed_lookup(params["embedding"], tokens, cfg.vocab_size)


def unembed(params, x, cfg, *, gather: bool = True):
    """Logits in x's dtype; tied embeddings project on ``embedding.T``.
    Under a mesh whose ``model`` axis splits the vocabulary, the rank
    computes its vocab columns and (``gather``, the prefill's and the
    decode step's) gathers the others over ``model``: every rank returns
    the whole [B, S, V], as the JAX jit returns one global array.
    ``gather=False`` (the loss's) returns the rank's columns [B, S, V /
    ways], ``x``'s gradient summed over ``model``."""
    w = params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    if w.shape[-1] == cfg.vocab_size:
        return torch.matmul(x, w)
    if not gather:
        return torch.matmul(shd.psum_grad(x), w)
    return shd.all_gather(torch.matmul(x, w), "model", dim=-1, uses="same")


# ---------------------------------------------------------------------------
# activations (``jax.nn.gelu`` is the tanh approximation)
# ---------------------------------------------------------------------------

def gelu(x):
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"gelu": gelu, "relu": F.relu, "silu": F.silu}.get(name, gelu)
