"""Minimal pytree helpers with JAX's flattening order.

Nested ``dict`` / ``tuple`` / ``list`` containers are nodes (dict keys in
sorted order), ``None`` is an empty node (it flattens to nothing), and
everything else is a leaf.  The history-KV payloads keep the JAX package's
structure — ``{"b0": {"k": (values, scale), "v": ...}, ...}`` — so the
executor argument order matches the JAX engine leaf for leaf.

The weight bridge lives here too: :func:`params_from_jax` turns a JAX
values tree (numpy leaves) into the port's parameters for every bundle,
Climber's and the text decoder's alike."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.devices import resolve_device


def leaves(tree) -> List[Any]:
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        else:
            out.append(t)
    walk(tree)
    return out


def structure(tree):
    """Hashable description of the containers (leaves become ``"*"``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(x) for x in tree))
    return "*"


def unflatten(struct, flat) -> Any:
    """Rebuild a tree of ``struct`` (from :func:`structure`) from leaves."""
    it = iter(flat)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        kind, kids = s
        if kind == "dict":
            return {k: build(c) for k, c in kids}
        seq = [build(c) for c in kids]
        return tuple(seq) if kind == "tuple" else seq
    out = build(struct)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def tree_map(fn: Callable, tree, is_leaf: Callable = None):
    """Apply ``fn`` to every leaf (and to every subtree ``is_leaf`` marks)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, is_leaf) for x in tree)
    return fn(tree)


def unstack(tree) -> List[Any]:
    """The per-index trees of a tree of dicts, tuples and lists whose
    leaves are stacked on a leading axis (a layer stack): each leaf split
    once with ``unbind``, so that autograd stacks the per-index gradients
    once, where indexing ``a[i]`` per index would scatter each into a zero
    tensor of the whole leaf.  The views are those of ``a[i]``."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [unstack(v) for v in tree]
        return [type(tree)(p[i] for p in parts)
                for i in range(len(parts[0]))]
    return list(tree.unbind(0))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # JAX's bf16 numpy dtype
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cuda") -> Dict:
    """Turn a JAX values pytree — its leaves given as numpy arrays
    (``jax.tree.map(np.asarray, values)``) — into the port's parameters on
    ``device``: same names, same layouts, same dtypes (bf16 included).
    Raises when ``device="cuda"`` and no GPU is present."""
    dev = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, dev), tree)


def params_to(params: Dict, device) -> Dict:
    """A copy of ``params`` on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)
