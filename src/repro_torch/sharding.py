"""Logical-axis sharding rules with divisibility fallbacks, and the SPMD
collectives the port's mesh code issues.  Port of ``repro/sharding.py``.

Model code names every parameter and activation axis with a *logical*
name ("batch", "heads", "mlp", "vocab", ...).  A rule table maps each
logical name to mesh axes; :func:`logical_to_spec` resolves the mapping
against a mesh and a global shape, dropping a mesh axis that does not
divide the dimension (8 KV heads on a 16-way model axis stay replicated).

A resolved spec is a tuple with one entry per dimension (trailing ``None``
entries trimmed, as a ``PartitionSpec``): ``None``, one mesh-axis name, or
a tuple of names composed major to minor.  The rule functions take a mesh
*shape* (:class:`MeshShape`, or any object with ``axis_names`` and a
``shape`` mapping, such as ``launch.mesh.ServingMesh``), so they run without
processes, as the JAX package's run on an ``AbstractMesh``.

The port is SPMD: one process per device, each holding its *local* block
of every sharded tensor (:func:`local_shard`, :func:`shard_params`).  Code
running inside :func:`mesh_rules` reads the active mesh and issues its
collectives through :func:`psum`, :func:`all_gather`, :func:`all_to_all`
and :func:`ppermute_next`.  Each of them is a no-op on an axis of one way,
so a ``(1, 1)`` mesh runs exactly the ops of the mesh-less code, and each
counts what it issues in :data:`COUNTS` (by collective kind), which is how
the engine reports collectives per executor.

Gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only; under
gloo the other collectives stage a CUDA tensor through host memory here
(the shared-card runs, several gloo ranks on one card).

The model code's sharded forwards read the active rules through
:func:`fsdp_gather` (a layer's FSDP axes gathered as it runs),
:func:`model_sum` (a split product's partial sums added over ``model``),
:func:`batch_axes` / :func:`seq_split_axes` (how the batch and a decode
cache's positions are split) and :func:`softmax_merge` (attention over
positions split across ranks); :func:`per_chip_bytes` is the dry run's
residency count.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Logical = Tuple[Optional[str], ...]
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

# logical axis -> mesh axes (tried in order, composed when all divide)
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                       # replicated by default
    "seq_shard": ("data",),          # long-context: shard sequence over data
    "act_model": ("model",),
    # parameters
    "embed": (),                     # the d_model axis of params: replicated
    "embed_fsdp": ("data",),         # FSDP: shard d_model of big tables
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv_dim": (),
    "mlp": ("model",),
    "experts": ("pod", "data"),      # expert-parallel over the data/pod axes
    "expert_mlp": ("model",),
    "tokens": ("pod", "data"),       # flattened (batch*seq) token axis
    # kv-cache
    "cache_batch": ("pod", "data"),
    "cache_seq": (),
    "cache_seq_shard": ("data",),
    "cache_heads": ("model",),
    # mamba / rwkv state
    "ssm_inner": ("model",),
    "ssm_state": (),
    "stack": (),                     # stacked-layer leading axis: never sharded
}

# Logical layout of every stored/stacked history-KV leaf in the serving
# stack: quantized values [U, L, S, Hkv, D] and int8 scales [U, L, 1, Hkv, 1]
# share it (the divisibility fallback drops cache_seq_shard on the size-1
# scale dim).
SERVING_KV_LEAF: Logical = (
    "cache_batch", "stack", "cache_seq_shard", "cache_heads", None)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, no processes behind it."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _sizes(mesh) -> Dict[str, int]:
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def resolve_rules(mesh) -> dict:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod')."""
    names = set(mesh.axis_names)
    return {k: tuple(a for a in v if a in names)
            for k, v in DEFAULT_RULES.items()}


def serving_rules(mesh, kv_heads: Optional[int] = None) -> dict:
    """Rule table for the serving executors (engine, pool, DSO).

    ``cache_batch`` is REPLICATED: the leading axis of stacked history KV is
    "which pooled user row", indexed per candidate by the dedup / packed
    row index, so sharding it would put a cross-shard gather on every
    cached dispatch.  ``cache_seq_shard`` maps to the *model* axis only as
    a fallback: when the KV heads divide the model ways, attention is
    tensor-parallel over heads; when they don't, the history length takes
    the model axis instead (the ``seq_axis="model"`` convention of
    ``models.attention.context_parallel_attention``).  The request batch
    always rides ``data``."""
    rules = dict(resolve_rules(mesh))
    names = set(mesh.axis_names)
    rules["batch"] = tuple(a for a in ("data",) if a in names)
    rules["cache_batch"] = ()
    rules["cache_seq_shard"] = ("model",) \
        if cp_fallback(mesh, kv_heads) else ()
    return rules


def cp_fallback(mesh, kv_heads: Optional[int]) -> bool:
    """Whether :func:`serving_rules` shards the stored history length over
    ``model``: the KV heads do not divide a model axis of more than one
    way."""
    ways = _sizes(mesh).get("model", 1)
    return kv_heads is not None and ways > 1 and kv_heads % ways != 0


def rules_for_shape(mesh, global_batch: int, fsdp: bool = True) -> dict:
    """Workload-adapted rules: ``fsdp`` shards every parameter's d_model
    ("embed") axis over data; a batch too small to shard over the batch
    ways hands the data (and model) axes to the sequence axes."""
    rules = dict(resolve_rules(mesh))
    sizes = _sizes(mesh)
    if fsdp:
        rules["embed"] = tuple(a for a in ("data",) if a in sizes)
    batch_ways = math.prod(sizes[a] for a in rules.get("batch", ()))
    if global_batch < max(batch_ways, 2):
        rules["cache_seq"] = tuple(a for a in ("data", "model")
                                   if a in sizes)
        rules["seq"] = tuple(a for a in ("data",) if a in sizes)
    return rules


def logical_to_spec(logical: Logical, shape: Sequence[int], mesh,
                    rules: Optional[dict] = None) -> Spec:
    """Resolve logical axis names to a spec with divisibility fallback: a
    mesh axis already spent on an earlier dimension is skipped, one that
    does not divide what is left of the dimension is dropped, and
    trailing ``None`` entries are trimmed."""
    rules = rules or resolve_rules(mesh)
    sizes = _sizes(mesh)
    used = set()
    entries = []
    for dim, name in zip(shape, logical):
        if name is None:
            entries.append(None)
            continue
        picked = []
        rem = dim
        for ax in rules.get(name, ()):
            if ax in used:
                continue
            if rem % sizes[ax] == 0:
                picked.append(ax)
                used.add(ax)
                rem //= sizes[ax]
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of an array of global ``shape``."""
    sizes = _sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        ways = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[i] % ways:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{ways} ways ({spec})")
        out[i] //= ways
    return tuple(out)


def block_index(entry: SpecEntry, mesh, coords: Dict[str, int]) -> int:
    """The block a rank at ``coords`` holds along a dimension with spec
    ``entry`` (axes composed major to minor, as a ``NamedSharding``)."""
    sizes = _sizes(mesh)
    idx = 0
    for a in _entry_axes(entry):
        idx = idx * sizes[a] + int(coords[a])
    return idx


def local_shard(x: torch.Tensor, spec: Spec, mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``x`` (a global array) that the rank at ``coords``
    holds under ``spec``: a view, ``x`` itself when nothing is split."""
    loc = local_shape(x.shape, spec, mesh)
    for i, entry in enumerate(spec):
        if loc[i] != x.shape[i]:
            x = x.narrow(i, block_index(entry, mesh, coords) * loc[i],
                         loc[i])
    return x


def is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_logical(bundle):
    """The logical tree of ``bundle``'s parameters: the specs the JAX
    package's ``bundle.init`` returns (``("vocab", "embed")`` for an
    embedding table, ``("stack", "embed", "heads", None)`` for a stacked
    query projection).  The bundle's own ``init`` runs with every
    initializer returning its logical names instead of a tensor."""
    from repro_torch.models import layers as L
    with L.logical_params():
        return bundle.init(device="cpu")


def shard_params(params, logical, mesh, coords: Dict[str, int],
                 rules: Optional[dict] = None):
    """The rank's local tree of ``params`` (the full tree) under the
    ``logical`` tree (:func:`param_logical`): each split leaf is a
    contiguous copy of the rank's block, an unsplit one the leaf itself."""
    rules = rules or resolve_rules(mesh)

    def one(p, lg):
        if isinstance(p, dict):
            if set(p) != set(lg):
                raise ValueError(f"param keys {sorted(p)} vs logical "
                                 f"{sorted(lg)}")
            return {k: one(p[k], lg[k]) for k in p}
        if not is_logical(lg) or len(lg) != p.dim():
            raise ValueError(f"logical {lg} does not fit a param of shape "
                             f"{tuple(p.shape)}")
        spec = logical_to_spec(lg, p.shape, mesh, rules)
        blk = local_shard(p, spec, mesh, coords)
        return p if blk is p else blk.contiguous().clone()
    return one(params, logical)


# ---------------------------------------------------------------------------
# the active mesh: code inside mesh_rules() reads it
# ---------------------------------------------------------------------------

_ACTIVE: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_active_mesh_rules", default=None)


@contextlib.contextmanager
def mesh_rules(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (with ``rules``) the active mesh of this context."""
    token = _ACTIVE.set((mesh, rules or resolve_rules(mesh)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active():
    """``(mesh, rules)`` of the active context, or None."""
    return _ACTIVE.get()


def constrain_ctx(x: torch.Tensor, *logical: Optional[str],
                  global_shape: Optional[Sequence[int]] = None):
    """Check that ``x`` is the local block the active rules give an array
    of ``global_shape`` (default: ``x``'s own shape, a replicated array)
    with these logical axes; returns ``x``.  A no-op outside a mesh."""
    act = _ACTIVE.get()
    if act is None:
        return x
    mesh, rules = act
    shape = tuple(x.shape if global_shape is None else global_shape)
    want = local_shape(shape, logical_to_spec(tuple(logical), shape, mesh,
                                              rules), mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"local block {tuple(x.shape)} of {shape} under "
                         f"{logical}: the rules give {want}")
    return x


def axis_size(axis) -> int:
    """Ways of ``axis`` (a name, or a tuple of names composed) on the
    active mesh (1 outside a mesh or for an axis the mesh lacks)."""
    act = _ACTIVE.get()
    if act is None:
        return 1
    return math.prod(int(act[0].shape[a]) for a in _entry_axes(axis)
                     if a in act[0].axis_names)


def axis_index(axis) -> int:
    """This rank's index along ``axis`` (a name, or a tuple of names
    composed major to minor)."""
    act = _ACTIVE.get()
    if act is None:
        return 0
    mesh = act[0]
    idx = 0
    for a in _entry_axes(axis):
        if a in mesh.axis_names:
            idx = idx * int(mesh.shape[a]) + int(mesh.coords[a])
    return idx


# ---------------------------------------------------------------------------
# collectives (counted; a no-op at one way; differentiable)
# ---------------------------------------------------------------------------
#
# Each collective is a ``torch.autograd.Function`` whose backward is its
# transpose, so a sharded forward differentiates rank by rank.  A sum over
# an axis has two transposes, and the caller names the one it needs by
# how the ranks of the axis use the result:
#
# * ``uses="same"``: every rank of the axis computes the same thing from
#   the result, so each rank's gradient of it is already whole and the
#   backward is the identity (Megatron's "g": ``model_sum`` after a split
#   product, the embedding's sum, the loss's sums).  The replicated value
#   that *enters* such a split region needs the conjugate,
#   :func:`psum_grad` (Megatron's "f": identity forward, the gradients
#   summed backward), or a replicated leaf used there would get a
#   different partial gradient on each rank.
# * ``uses="own"``: each rank uses its own part of the result (keeps its
#   own rows), so each rank's gradient is partial and the backward sums
#   the gradients over the axis: the exact transpose.
#
# :func:`all_gather` likewise: ``uses="own"`` (the default: the gathered
# keys, weights or tokens each rank uses with its own block of the work)
# transposes to a ``reduce_scatter``, ``uses="same"`` to the rank's block
# of the gradient (no collective).  :func:`all_to_all` transposes to
# itself (the block exchange is an involution), :func:`ppermute_next` to
# the reverse ring shift.  The backward reads the mesh the forward ran on
# (autograd may run it on another thread, outside the ``mesh_rules``
# context), and counts what it issues in :data:`COUNTS` as the forward
# does.

#: collectives issued in this process, by kind: ``all_reduce``,
#: ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``p2p`` (model
#: code, forward and backward), ``broadcast`` and ``fetch`` (the serving
#: transport: headers, and results gathered to the leader)
COUNTS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()

USES = ("same", "own")


def count(kind: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTS[kind] = COUNTS.get(kind, 0) + n


def counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(COUNTS)


def _mesh_axis(axis: str):
    act = _ACTIVE.get()
    if act is None:
        raise RuntimeError(f"a collective over {axis!r} needs an active "
                           f"mesh (sharding.mesh_rules)")
    return act[0]


def _host_staged(mesh, t: torch.Tensor) -> bool:
    """Gloo moves CUDA tensors for broadcast / all_reduce only."""
    return mesh.backend == "gloo" and t.is_cuda


def _check_uses(uses: str) -> None:
    if uses not in USES:
        raise ValueError(f"uses must be one of {USES}, got {uses!r}")


# the collectives themselves, on an explicit mesh (no autograd)

def _ar(mesh, x: torch.Tensor, axis, op: str = "SUM") -> torch.Tensor:
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op),
                    group=mesh.group(axis))
    count("all_reduce")
    return y


def _ag(mesh, x: torch.Tensor, axis, n: int, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    src = x.contiguous()
    staged = _host_staged(mesh, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    count("all_gather")
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def _rs(mesh, x: torch.Tensor, axis, n: int, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, of which the rank keeps its block
    along ``dim`` (``x.shape[dim]`` split ``n`` ways, in axis order)."""
    import torch.distributed as dist
    src = x.movedim(dim, 0).contiguous()
    staged = _host_staged(mesh, src)
    if staged:
        src = src.cpu()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter(out, list(src.chunk(n, dim=0)),
                        group=mesh.group(axis))
    count("reduce_scatter")
    out = out.movedim(0, dim)
    return out.to(x.device) if staged else out


def _a2a(mesh, x: torch.Tensor, axis) -> torch.Tensor:
    import torch.distributed as dist
    src = x.contiguous()
    staged = _host_staged(mesh, src)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    count("all_to_all")
    return out.to(x.device) if staged else out


def _shift(mesh, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
    """Send ``x`` to rank i + step of ``axis`` (a ring) and return what
    rank i - step sent."""
    import torch.distributed as dist
    src = x.contiguous()
    staged = _host_staged(mesh, src)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    n = int(mesh.shape[axis])
    i = mesh.coords[axis]
    peers = mesh.axis_ranks(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, peers[(i + step) % n]),
        dist.P2POp(dist.irecv, out, peers[(i - step) % n])])
    for r in reqs:
        r.wait()
    count("p2p")
    return out.to(x.device) if staged else out


def _index(mesh, axis) -> int:
    idx = 0
    for a in _entry_axes(axis):
        idx = idx * int(mesh.shape[a]) + int(mesh.coords[a])
    return idx


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, uses):
        ctx.mesh, ctx.axis, ctx.uses = mesh, axis, uses
        return _ar(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.uses == "same":
            return g, None, None, None
        return _ar(ctx.mesh, g, ctx.axis), None, None, None


class _PSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        red = _ar(ctx.mesh, torch.cat([g.reshape(-1) for g in gs]),
                  ctx.axis)
        out, off = [], 0
        for g in gs:
            out.append(red[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return (None, None) + tuple(out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, n, dim, uses):
        ctx.mesh, ctx.axis, ctx.n, ctx.dim, ctx.uses = mesh, axis, n, dim, \
            uses
        ctx.loc = x.shape[dim]
        return _ag(mesh, x, axis, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.uses == "same":
            got = g.narrow(ctx.dim, _index(ctx.mesh, ctx.axis) * ctx.loc,
                           ctx.loc)
        else:
            got = _rs(ctx.mesh, g, ctx.axis, ctx.n, ctx.dim)
        return got, None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(ctx.mesh, g, ctx.axis), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _shift(mesh, x, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.mesh, g, ctx.axis, -ctx.step), None, None, None


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def psum(x: torch.Tensor, axis, *, uses: str = "same") -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (an ``all_reduce``), in ``x``'s dtype.
    ``uses`` says how the ranks of the axis use the sum (the section
    comment): ``"same"`` (the backward is the identity) or ``"own"`` (each
    keeps its own part; the backward sums the gradients over ``axis``)."""
    _check_uses(uses)
    if axis_size(axis) == 1:
        return x
    return _PSum.apply(x, _mesh_axis(axis), axis, uses)


def psum_grad(*xs: torch.Tensor, axis="model"):
    """The tensors ``xs`` themselves (one, or a tuple), whose gradients
    are summed over ``axis`` in the backward (one ``all_reduce`` carries
    them all): values the same on every rank of ``axis`` entering work
    that each rank does differently (its block of a split product;
    Megatron's "f").  No collective in the forward, and none in the
    backward of a tensor that needs no gradient.  The tensors of one call
    share a dtype (their gradients travel packed in it)."""
    if len({x.dtype for x in xs}) > 1:
        raise ValueError(f"psum_grad packs one dtype, got "
                         f"{sorted(str(x.dtype) for x in xs)}")
    if axis_size(axis) == 1 or not any(x.requires_grad for x in xs):
        return xs[0] if len(xs) == 1 else xs
    out = _PSumGrad.apply(_mesh_axis(axis), axis, *xs)
    return out[0] if len(xs) == 1 else out


def grad_scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x`` itself, its gradient multiplied by ``c`` in the backward."""
    if c == 1 or not x.requires_grad:
        return x
    return _GradScale.apply(x, c)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``axis`` (an ``all_reduce``); a
    constant for autograd."""
    if axis_size(axis) == 1:
        return x
    return _ar(_mesh_axis(axis), x.detach(), axis, "MAX")


def model_sum(x: torch.Tensor, dtype) -> torch.Tensor:
    """Tensor parallelism: the rank's partial sum of a product over a
    contracted axis split over ``model``, added over ``model`` in float32
    and rounded once to ``dtype``.  Every model rank goes on with the same
    sum (``uses="same"``: the backward is the identity)."""
    return psum(x.float(), "model").to(dtype)


def pmean(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Mean of ``x`` over every axis in ``axes`` (each rank uses the mean
    the same way)."""
    ways = 1
    for a in axes:
        if axis_size(a) > 1:
            x = psum(x, a)
            ways *= axis_size(a)
    return x / ways if ways > 1 else x


def all_gather(x: torch.Tensor, axis, dim: int, *,
               uses: str = "own") -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in ``axis`` order.
    ``uses="own"``: each rank does its own work with the whole (the
    backward reduce-scatters the gradients); ``"same"``: every rank does
    the same (the backward keeps the rank's block of the gradient)."""
    _check_uses(uses)
    n = axis_size(axis)
    if n == 1:
        return x
    return _AllGather.apply(x, _mesh_axis(axis), axis, n, dim, uses)


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """Block i of ``x`` (split evenly along dim 0) goes to rank i of
    ``axis``; returns the blocks received, in rank order.  Its own
    transpose."""
    if axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, _mesh_axis(axis), axis)


def ppermute_next(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Send ``x`` to rank i + 1 of ``axis`` (the last to the first) and
    return what rank i - 1 sent: a ring shift by one (the backward shifts
    the gradient back)."""
    if axis_size(axis) == 1:
        return x
    return _Shift.apply(x, _mesh_axis(axis), axis, 1)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Rows ``ids`` of an embedding table whose ``vocab`` rows may be split
    over ``model`` (the ``("vocab", "embed")`` layout): the rank's block
    looks up the ids it holds, zero elsewhere, and the blocks are summed.
    One nonzero term per row, so the sum is exact; every model rank goes
    on with the same rows (``uses="same"``), so the block's gradient is
    that of the rows it looked up."""
    rows = table.shape[0]
    if rows == vocab:
        return torch.nn.functional.embedding(ids, table)
    lo = axis_index("model") * rows
    local = ids - lo
    hit = (local >= 0) & (local < rows)
    out = torch.nn.functional.embedding(local.clamp(0, rows - 1), table)
    out = torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
    return psum(out, "model")


# ---------------------------------------------------------------------------
# the sharded forwards: FSDP gathers, split caches, per-chip bytes
# ---------------------------------------------------------------------------

#: the logical names of a parameter's d_model axes: ``rules_for_shape``'s
#: FSDP shards "embed" over ``data``, and "embed_fsdp" takes ``data`` where
#: "embed" does not
FSDP_NAMES = ("embed", "embed_fsdp")


def zip_logical(tree, logical):
    """``(leaf, logical)`` pairs of a tree of tensors (or anything with a
    ``shape``) and its logical tree, in key order."""
    if isinstance(tree, dict):
        if set(tree) != set(logical):
            raise ValueError(f"keys {sorted(tree)} vs logical "
                             f"{sorted(logical)}")
        return [pair for k in sorted(tree)
                for pair in zip_logical(tree[k], logical[k])]
    if not is_logical(logical) or len(logical) != len(tree.shape):
        raise ValueError(f"logical {logical} does not fit shape "
                         f"{tuple(tree.shape)}")
    return [(tree, logical)]


def per_chip_bytes(shapes, logical, mesh, rules: Optional[dict] = None
                   ) -> float:
    """Bytes one rank holds of the tree ``shapes`` (global tensors or meta
    stand-ins) under ``logical``: the sum over leaves of the local block's
    elements times the element size."""
    rules = rules or resolve_rules(mesh)
    total = 0
    for t, lg in zip_logical(shapes, logical):
        spec = logical_to_spec(lg, t.shape, mesh, rules)
        total += math.prod(local_shape(t.shape, spec, mesh)) \
            * t.element_size()
    return float(total)


def fsdp_gather(tree, logical, shapes):
    """The rank's blocks ``tree`` with every axis that the active rules
    split under an FSDP name (:data:`FSDP_NAMES`) gathered whole, for the
    layer about to run; ``logical`` and ``shapes`` give each leaf's
    logical names and global shape.  One ``all_gather`` per mesh axis
    (minor axes of a composed entry first) carries every such leaf of the
    tree, as bytes; a leaf with nothing to gather is returned as it is.
    Outside a mesh, or where nothing is split, ``tree`` itself.

    Differentiable: each rank uses the whole weights with its own rows of
    the batch, so the backward reduce-scatters each leaf's gradient over
    the same axes (major axes first), one ``reduce_scatter`` per axis and
    dtype carrying every leaf of that dtype."""
    act = _ACTIVE.get()
    if act is None:
        return tree
    mesh, rules = act
    sizes = _sizes(mesh)
    pending = []           # (tensor, [(dim, axis), ...] minor first)

    def walk(t, lg, sh):
        if isinstance(t, dict):
            return {k: walk(t[k], lg[k], sh[k]) for k in t}
        spec = logical_to_spec(lg, sh.shape, mesh, rules)
        steps = [(i, a) for i, (e, name) in enumerate(zip(spec, lg))
                 if name in FSDP_NAMES
                 for a in reversed(_entry_axes(e)) if sizes[a] > 1]
        if not steps:
            return t
        pending.append((t, steps))
        return _Slot(len(pending) - 1)

    out = walk(tree, logical, shapes)
    if not pending:
        return tree
    got = _FsdpGather.apply(mesh, [steps for _, steps in pending],
                            *[t for t, _ in pending])
    return _fill(out, got)


def _gather_rounds(steps_of):
    """The rounds of :func:`fsdp_gather`: per round, per mesh axis, the
    leaves (index, dim) whose next gather is over that axis."""
    left = [list(s) for s in steps_of]
    rounds = []
    while any(left):
        by_axis: Dict[str, list] = {}
        for i, steps in enumerate(left):
            if steps:
                dim, axis = steps.pop(0)
                by_axis.setdefault(axis, []).append((i, dim))
        rounds.append(by_axis)
    return rounds


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, steps_of, *tensors):
        ctx.mesh = mesh
        ctx.rounds = _gather_rounds(steps_of)
        cur = list(tensors)
        for by_axis in ctx.rounds:
            for axis, members in by_axis.items():
                n = int(mesh.shape[axis])
                parts = [cur[i].contiguous().reshape(-1).view(torch.uint8)
                         for i, _ in members]
                got = _ag(mesh, torch.cat(parts)[None], axis, n, dim=0)
                off = 0
                for (i, dim), raw in zip(members, parts):
                    t = cur[i]
                    blk = got[:, off:off + raw.numel()].contiguous()
                    off += raw.numel()
                    blk = blk.view(t.dtype).reshape((n,) + tuple(t.shape))
                    shape = list(t.shape)
                    shape[dim] *= n
                    cur[i] = blk.movedim(0, dim).reshape(shape)
        return tuple(cur)

    @staticmethod
    def backward(ctx, *grads):
        # autograd hands in zeros for an output the step did not use
        # (materialized gradients), so every rank scatters the same leaves
        mesh = ctx.mesh
        cur = list(grads)
        for by_axis in reversed(ctx.rounds):
            for axis, members in by_axis.items():
                n = int(mesh.shape[axis])
                by_dtype: Dict[torch.dtype, list] = {}
                for i, dim in members:
                    by_dtype.setdefault(cur[i].dtype, []).append((i, dim))
                for group in by_dtype.values():
                    rows = [cur[i].movedim(dim, 0).reshape(n, -1)
                            for i, dim in group]
                    red = _rs(mesh, torch.cat(rows, dim=1), axis, n, dim=0)
                    off = 0
                    for (i, dim), r in zip(group, rows):
                        g = cur[i].movedim(dim, 0)
                        loc = (g.shape[0] // n,) + tuple(g.shape[1:])
                        blk = red[0, off:off + r.shape[1]].reshape(loc)
                        off += r.shape[1]
                        cur[i] = blk.movedim(0, dim)
        return (None, None) + tuple(cur)


class _Slot:
    def __init__(self, i: int):
        self.i = i


def _fill(tree, got):
    if isinstance(tree, dict):
        return {k: _fill(v, got) for k, v in tree.items()}
    return got[tree.i] if isinstance(tree, _Slot) else tree


def gather_axis(x: torch.Tensor, axis, dim: int, *,
                uses: str = "own") -> torch.Tensor:
    """``x`` gathered along ``dim`` over every mesh axis of ``axis`` (a
    spec entry: composed axes gathered minor first); ``uses`` as
    :func:`all_gather`'s."""
    for a in reversed(_entry_axes(axis)):
        x = all_gather(x, a, dim, uses=uses)
    return x


def spec_axes(name: str, size: int) -> Tuple[str, ...]:
    """The mesh axes that the active rules give a lone dimension of
    ``size`` named ``name`` (divisibility fallback applied); () outside
    a mesh."""
    act = _ACTIVE.get()
    if act is None:
        return ()
    spec = logical_to_spec((name,), (size,), act[0], act[1])
    return _entry_axes(spec[0]) if spec else ()


def batch_axes() -> Tuple[str, ...]:
    """The mesh axes that split the batch rows (and the caches' batch)
    under the active rules, those of more than one way: the rules'
    ``batch`` axes, or none under ``rules_for_shape``'s long-context rules
    (a global batch too small to split; they give ``seq`` the data axis,
    and the sharded forwards take them at a batch of one).  () outside a
    mesh."""
    act = _ACTIVE.get()
    if act is None or act[1].get("seq"):
        return ()
    mesh, rules = act
    sizes = _sizes(mesh)
    return tuple(a for a in rules.get("batch", ())
                 if a in sizes and sizes[a] > 1)


def seq_split_axes() -> Tuple[str, ...]:
    """The mesh axes that split a decode cache's positions under the
    active rules: the ``cache_seq`` axes of more than one way that the
    batch does not take (``rules_for_shape``'s long-context rules: data
    and model; the serving profile's ``cache_seq=model``: model).  ()
    outside a mesh or with the positions whole.  The caller keeps the
    cache lengths divisible by their ways."""
    act = _ACTIVE.get()
    if act is None:
        return ()
    mesh, rules = act
    sizes = _sizes(mesh)
    taken = batch_axes()
    return tuple(a for a in rules.get("cache_seq", ())
                 if a in sizes and sizes[a] > 1 and a not in taken)


def softmax_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  axes: Sequence[str]) -> torch.Tensor:
    """Attention over keys split over ``axes``: each rank's row maxima
    ``m``, sums ``l`` of ``exp(s - m)`` and ``acc`` [..., D] of the
    ``exp(s - m)``-weighted values (f32) combined by the online-softmax
    rule — the maximum through a max ``all_reduce``, then the rescaled
    sums in one ``psum`` per axis.  Returns ``acc / l`` of every key."""
    top = m
    for a in axes:
        top = pmax(top, a)
    scale = torch.exp(m - top)
    packed = torch.cat([(l * scale)[..., None], acc * scale[..., None]],
                       dim=-1)
    for a in axes:
        packed = psum(packed, a)
    return packed[..., 1:] / packed[..., :1]


# ---------------------------------------------------------------------------
# the sharded train step: recompute, gradient sums, the global norm
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _restored(ctx: contextvars.Context):
    """The port's context variables (the active mesh, the flags) set to
    their values in ``ctx`` for the block."""
    tokens = [(var, var.set(val)) for var, val in ctx.items()
              if var.name.startswith("repro_torch")]
    try:
        yield
    finally:
        for var, tok in reversed(tokens):
            var.reset(tok)


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` (non-reentrant): only
    the inputs are kept, and ``fn`` runs again in the backward under the
    active mesh and flags of the forward (autograd may run the recompute
    on another thread, outside this context).  The recompute stops after
    the last tensor the backward needs (checkpoint's early stop), so it
    re-issues the forward's collectives up to there and not a trailing
    one, as XLA's remat drops work whose outputs nothing reads."""
    from torch.utils.checkpoint import checkpoint as ckpt
    ctx = contextvars.copy_context()
    return ckpt(fn, *args, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    _restored(ctx)))


def batch_redundancy() -> int:
    """Ways of the mesh axes other than ``model`` that do not split the
    batch rows (under the long-context rules, every such axis): the ranks
    along them compute the same loss from the same rows, so each seeds
    its backward with ``1 / redundancy`` of the loss's gradient and the
    sums over those axes (:func:`sync_grads`, the FSDP reduce-scatters)
    add up to the whole.  1 outside a mesh."""
    act = _ACTIVE.get()
    if act is None:
        return 1
    mesh = act[0]
    taken = batch_axes()
    return math.prod(int(mesh.shape[a]) for a in mesh.axis_names
                     if a != "model" and a not in taken)


def leaf_split_axes(logical, shapes) -> list:
    """Per leaf of the tree ``shapes`` (global shapes, in
    :func:`~repro_torch.tree.leaves` order) under ``logical``: the mesh
    axes of more than one way that the active rules split it over."""
    mesh, rules = _ACTIVE.get()
    sizes = _sizes(mesh)
    return [tuple(a for e in logical_to_spec(lg, t.shape, mesh, rules)
                  for a in _entry_axes(e) if sizes[a] > 1)
            for t, lg in zip_logical(shapes, logical)]


def _group_of(mesh, axes: Tuple[str, ...]):
    return axes[0] if len(axes) == 1 else axes


def sync_grads(grads: Sequence[torch.Tensor],
               split_axes: Sequence[Tuple[str, ...]]) -> list:
    """The gradients of the rank's blocks (``grads``, one per leaf, with
    :func:`leaf_split_axes`' ``split_axes``) summed over every mesh axis
    other than ``model`` that the leaf is replicated on: each rank's
    gradient there holds its own rows' share.  A leaf split over such an
    axis was gathered by :func:`fsdp_gather`, whose backward summed it
    already, or is the rank's own block of the experts; a leaf
    replicated over ``model`` has its whole gradient on every model rank
    (the ``psum_grad`` / ``uses="same"`` pairs).  One ``all_reduce`` per
    set of axes and dtype carries every such leaf."""
    mesh = _ACTIVE.get()[0]
    sizes = _sizes(mesh)
    groups: Dict[tuple, list] = {}
    for i, (g, split) in enumerate(zip(grads, split_axes)):
        axes = tuple(a for a in mesh.axis_names
                     if a != "model" and sizes[a] > 1 and a not in split)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in groups.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        red = _ar(mesh, flat, _group_of(mesh, axes))
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = red[off:off + n].view_as(grads[i])
            off += n
    return out


def replication(split_axes: Tuple[str, ...]) -> int:
    """Ranks of the active mesh that hold the same block of a leaf split
    over ``split_axes`` (1 outside a mesh)."""
    act = _ACTIVE.get()
    if act is None:
        return 1
    sizes = _sizes(act[0])
    return math.prod(sizes.values()) // math.prod(sizes[a]
                                                  for a in split_axes)


def sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the active mesh (one
    ``all_reduce``; ``x`` itself outside a mesh or on one rank)."""
    act = _ACTIVE.get()
    if act is None or math.prod(_sizes(act[0]).values()) == 1:
        return x
    return _ar(act[0], x, tuple(act[0].axis_names))
