"""Device meshes over ``torch.distributed``, and the ranks behind them.
Port of ``repro/launch/mesh.py``.

The port is SPMD, one process (rank) per device: a :class:`ServingMesh`
is the ``("data", "model")`` view of the default process group, carried by
a ``torch.distributed.device_mesh.DeviceMesh``, with the calling rank's
coordinates, its device and one process group per mesh axis.  On cards
the backend is NCCL with rank r on ``cuda:r``; on the CPU, or several
ranks sharing one card, it is gloo.

Nothing here starts a process group as a side effect (:func:`dry_mesh`
starts a fake one for its ``with`` block), and nothing touches a device
when imported.  The ranks are started by :func:`run_ranks` (the
launcher, the tests, ``chip_smoke.py``), which rendezvous through a file
and joins its children, with a time limit where the caller sets one.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")


class ServingMesh:
    """The mesh a rank serves on: ``axis_names`` / ``shape`` (the
    :mod:`repro_torch.sharding` rule functions read these), ``size``,
    this rank's ``rank`` and ``coords``, its ``device``, the ``backend``,
    and ``group(axis)`` — the process group of the ranks that share every
    other coordinate with this one.  ``device_mesh`` is None only for a
    one-rank mesh without a process group (which needs no group)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES,
                 *, device=None):
        import torch.distributed as dist
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in shape)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.axis_sizes))
        self.size = math.prod(self.axis_sizes)
        self.device_mesh = None
        self._flat: Dict[Tuple[str, ...], object] = {}
        if dist.is_available() and dist.is_initialized():
            self.backend = dist.get_backend()
            world = dist.get_world_size()
            if self.size != world:
                raise ValueError(
                    f"a {self.shape} mesh has {self.size} ranks; the process "
                    f"group has {world}: the mesh spans the group")
            from torch.distributed.device_mesh import DeviceMesh
            self.rank = dist.get_rank()
            self.device_mesh = DeviceMesh(
                "cuda" if self.backend == "nccl" else "cpu",
                torch.arange(self.size).reshape(self.axis_sizes),
                mesh_dim_names=self.axis_names)
            coords = self.device_mesh.get_coordinate()
        else:
            if self.size != 1:
                raise ValueError(
                    f"a {self.shape} mesh needs {self.size} ranks in a "
                    f"process group (launch.mesh.run_ranks starts them); "
                    f"none is initialised")
            self.backend = "none"
            self.rank = 0
            coords = [0] * len(self.axis_names)
        self.coords: Dict[str, int] = dict(zip(self.axis_names, coords))
        if device is None and self.backend != "none":
            device = f"cuda:{torch.cuda.current_device()}" \
                if self.backend == "nccl" else "cpu"
        #: None only for a one-rank mesh without a process group: it
        #: takes the device of the engine that serves on it
        self.device = None if device is None else torch.device(device)

    def group(self, axis):
        """The process group along ``axis``, or along several axes (a
        tuple, composed major to minor, as a spec entry): a flattened
        sub-mesh, made on first use by every rank alike; every axis in
        order is the whole group (the mesh spans it, ranks in order)."""
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        axis = tuple(axis)
        if axis == self.axis_names:
            import torch.distributed as dist
            return dist.group.WORLD
        if len(axis) == 1:
            return self.device_mesh.get_group(axis[0])
        flat = self._flat.get(axis)
        if flat is None:
            flat = self._flat[axis] = self.device_mesh[axis]._flatten()
        return flat.get_group()

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        import torch.distributed as dist
        return tuple(dist.get_process_group_ranks(self.group(axis)))

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def __repr__(self):
        return (f"ServingMesh({self.shape}, rank {self.rank} at "
                f"{self.coords}, {self.backend}, {self.device})")


def _world() -> Tuple[int, str]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_backend()
    return 1, "none"


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    n = math.prod(shape)
    world, backend = _world()
    if n > world:
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {n} ranks, the process "
            f"group has {world}: start them with launch.mesh.run_ranks "
            f"(launch.serve --mesh does)")
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"{n} NCCL ranks need {n} cards, this host has "
                         f"{torch.cuda.device_count()}")
    return ServingMesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks ("data", "model"); 2 x 16 x 16 = 512 ranks
    ("pod", "data", "model") multi-pod.  Needs that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + AXES if multi_pod else AXES
    return _make(shape, axes, device)


@contextlib.contextmanager
def dry_mesh(*, multi_pod: bool = False):
    """The production mesh (:func:`make_production_mesh`: 256 or 512
    ranks) over ``torch.distributed``'s ``fake`` process group in this one
    process, as rank 0 on the CPU: its collectives return at once and
    move nothing, so rank 0's program runs on ``meta`` tensors with its
    collectives counted (the dry run).  The group is torn down on exit;
    a process with a process group already initialised is refused."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("dry_mesh starts a fake process group of its "
                           "own; this process already has one")
    # torch's fake backend lives in its testing package
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()


def make_host_mesh(model_parallel: int = 1, device=None):
    """Every rank of the process group: ``model_parallel`` model ways,
    the rest data ways."""
    world, _ = _world()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide {world} rank(s)")
    return _make((world // model_parallel, model_parallel), AXES, device)


def parse_mesh(mesh: str) -> Tuple[int, int]:
    parts = [int(x) for x in mesh.split(",")]
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise ValueError(f"--mesh expects 'data,model' ways, got {mesh!r}")
    return parts[0], parts[1]


def make_serving_mesh(mesh: str = "", model_parallel: int = 0, device=None):
    """Resolve the serve CLI's mesh flags to a ("data", "model") mesh.

    ``mesh``: explicit "DATA,MODEL" ways (e.g. "2,2").  ``model_parallel``:
    N model ways, data ways = ranks // N.  Both empty / zero -> None
    (serving without a mesh)."""
    if mesh:
        return _make(parse_mesh(mesh), AXES, device)
    if model_parallel:
        return make_host_mesh(model_parallel, device)
    return None


def mesh_ranks(mesh: str = "", model_parallel: int = 0,
               cards: int = 0) -> int:
    """Ranks a launcher must start for its mesh flags (0: no mesh);
    ``--model-parallel`` alone spans ``cards`` (one rank per card), or
    ``model_parallel`` ranks on the CPU."""
    if mesh:
        d, m = parse_mesh(mesh)
        return d * m
    if model_parallel:
        return max(cards, model_parallel)
    return 0


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, target: Callable, world: int, backend: str,
               init_file: str, threads: int, args: tuple):
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        target(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target: Callable, world: int, *, backend: str = "gloo",
              args: tuple = (), timeout_s: Optional[float] = None,
              threads: int = 0,
              init_dir: Optional[str] = None) -> None:
    """Start ``world`` ranks of ``target(rank, *args)`` (a module-level
    function: spawned children import it by module) in a process group of
    ``backend``, rank r on ``cuda:r`` under NCCL, rendezvous through a file
    under ``init_dir`` (default: a fresh temporary directory).  Joins
    them; a rank that fails fails the call.  With ``timeout_s``, ranks
    still running after it are killed and the call raises
    ``TimeoutError`` (a collective one rank skipped would otherwise hang
    every rank); without, the call waits for the ranks however long they
    serve.  ``threads`` > 0 sets each rank's intra-op threads."""
    import torch.multiprocessing as mp
    owned = init_dir is None
    init_dir = init_dir or tempfile.mkdtemp(prefix="mesh-rdv-")
    init_file = os.path.join(init_dir, f"rdv-{os.getpid()}-{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(target, world, backend, init_file, threads, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0 if deadline is None else max(
                0.1, min(1.0, deadline - time.monotonic()))):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {target.__name__} did "
                                   f"not finish within {timeout_s:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5.0)
        if os.path.exists(init_file):
            os.remove(init_file)
        if owned:
            shutil.rmtree(init_dir, ignore_errors=True)
