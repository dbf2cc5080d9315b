"""Sharded serving over ``torch.distributed``: the leader drives, the
followers replay.

The JAX engine is single-controller: one ``serve`` call feeds every device
of its mesh.  The port keeps that contract on rank 0 (the *leader*), which
runs the whole ``FlameEngine`` — API, admission, PDA, the pool's metadata,
the DSO.  Every other rank (a *follower*) runs :func:`follow`: it builds
the same executors over its own shard of the parameters and keeps its own
shard of every pooled entry, and replays each of the leader's dispatches.

One dispatch (:class:`MeshExecutor`, called by the DSO under its dispatch
lock) is:

1. the leader broadcasts a header: the executor's key, the rows used, the
   host inputs as they were staged (candidates, row indices, histories,
   side features), and, for each pooled row among the inputs, the id of
   the dispatch row that produced it (the *tag* of its tensors), plus the
   pool operations since the last header (entries freed, spilled to the
   host tier, promoted back);
2. every rank builds its local arguments — the batch axis sliced to its
   ``data`` block, pooled rows from its own store — and runs its local
   executor on its shard of the parameters, which issues the model's
   collectives (``sharding.psum`` over ``model`` under tensor
   parallelism, the ``data`` all-gather that publishes fresh KV);
3. ``encode`` / ``extend`` outputs are already on every rank: each rank
   keeps its own rows under the dispatch's id, the leader hands its rows
   to the pool.  Scores are gathered to the leader over ``data`` (the
   counterpart of the JAX host fetch of a data-sharded output).

Collectives are issued only inside :func:`follow` on a follower and only
under the dispatch lock on the leader, so every rank issues them in the
same order.  A retried dispatch is broadcast as a dispatch of its own.
Shutdown broadcasts the stop header.

Pooled tensors carry their tag as an attribute (``_mesh_tag``: dispatch
id, row, leaf); a finalizer tells the followers to free a row once no
tensor of the leader carries its tag any more.
"""
from __future__ import annotations

import pickle
import queue
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.tree import leaves, structure, tree_map, unflatten

_TAG = "_mesh_tag"
#: collectives the serving transport issues (not the executors' own)
TRANSPORT = ("broadcast", "fetch")


def _tag_of(t) -> Optional[Tuple[int, int, int]]:
    return getattr(t, _TAG, None) if isinstance(t, torch.Tensor) else None


class Transport:
    """The leader's header broadcast over the mesh's whole group: a length,
    then the pickled header, on the card under NCCL, on the host under
    gloo."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._dev = mesh.device if mesh.backend == "nccl" else \
            torch.device("cpu")
        self.seq = 0
        self.bytes_sent = 0

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.broadcast(t, src=0)
        shd.count("broadcast")
        return t

    def send(self, header: dict) -> None:
        buf = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
        self._bcast(torch.tensor([len(buf)], dtype=torch.int64,
                                 device=self._dev))
        self._bcast(torch.frombuffer(bytearray(buf), dtype=torch.uint8)
                    .to(self._dev))
        self.bytes_sent += len(buf)

    def recv(self) -> dict:
        n = self._bcast(torch.zeros(1, dtype=torch.int64, device=self._dev))
        buf = self._bcast(torch.empty(int(n.item()), dtype=torch.uint8,
                                      device=self._dev))
        return pickle.loads(buf.cpu().numpy().tobytes())


class Mirror:
    """Pooled rows by tag.  On the leader: tags fresh rows, and records
    the pool operations the followers must repeat (``free`` when the
    last tensor carrying a tag dies, ``host`` / ``device`` when the pool
    spills an entry to its host tier or promotes it back).  On a follower: the store of its
    own shards, by (dispatch id, row).

    A tensor's finalizer may run wherever a garbage collection runs, also
    inside this class's own locked sections: it only queues the tag
    (``_deaths``, a lock-free queue), and :meth:`take_ops` applies the
    queued deaths to the live counts under the lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._live: Dict[Tuple[int, int], int] = {}
        self._deaths: "queue.SimpleQueue[Tuple[int, int]]" = \
            queue.SimpleQueue()
        self._ops: List[tuple] = []
        self.rows: Dict[Tuple[int, int], List[torch.Tensor]] = {}

    # ---- leader ----
    def _tag(self, t: torch.Tensor, tag: Tuple[int, int, int]) -> None:
        setattr(t, _TAG, tag)
        eid = tag[:2]
        with self._lock:
            self._live[eid] = self._live.get(eid, 0) + 1
        weakref.finalize(t, self._deaths.put, eid)

    def tag_rows(self, rows: List, seq: int) -> None:
        for r, tree in enumerate(rows):
            for j, t in enumerate(leaves(tree)):
                self._tag(t, (seq, r, j))

    def moved(self, old, new, where: str) -> None:
        """``HistoryKVPool.on_tier_move``: the entry's new tensors carry
        the old ones' tags, and the followers move their shards too."""
        eids = []
        for a, b in zip(leaves(old), leaves(new)):
            tag = _tag_of(a)
            if tag is not None:
                self._tag(b, tag)
                eids.append(tag[:2])
        with self._lock:
            self._ops.extend((where, eid) for eid in dict.fromkeys(eids))

    def take_ops(self) -> List[tuple]:
        """The operations since the last call: moves as recorded, then a
        ``free`` for each row whose last tagged tensor has died.  A death
        is queued after its tensor's increment, so no count passes 0
        while a tensor of its row lives."""
        with self._lock:
            while True:
                try:
                    eid = self._deaths.get_nowait()
                except queue.Empty:
                    break
                self._live[eid] -= 1
                if not self._live[eid]:
                    del self._live[eid]
                    self._ops.append(("free", eid))
            ops, self._ops = self._ops, []
        return ops

    # ---- follower ----
    def apply(self, ops: List[tuple]) -> None:
        for op, eid in ops:
            if op == "free":
                self.rows.pop(eid, None)
            elif eid in self.rows:
                self.rows[eid] = [self._move(t, op)
                                  for t in self.rows[eid]]

    def _move(self, t: torch.Tensor, where: str) -> torch.Tensor:
        if where == "host":
            out = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=self.device.type == "cuda")
            return out.copy_(t)
        return t.to(self.device)

    def get(self, tag: Tuple[int, int, int]) -> torch.Tensor:
        return self.rows[tag[:2]][tag[2]]


def _split_rows(tree, rows: Optional[int]):
    if rows is None:
        return tree
    return [tree_map(lambda a: a[r:r + 1], tree) for r in range(rows)]


class MeshExecutor:
    """One executor of a sharded engine, on every rank: ``inner`` is the
    rank's local executor (local shapes: ``max_batch`` rows a data rank,
    the rank's heads or history block of each KV leaf), ``key`` its
    ``(kind, bucket, dispatcher)``.  The first ``n_replicated`` arguments
    (the deduped / packed KV rows) reach every rank whole; the others are
    sliced to the rank's ``data`` block.  ``device_output``: the outputs
    are KV rows the pool keeps (already gathered over ``data`` inside the
    executor); otherwise they are scores, gathered to the leader."""

    def __init__(self, inner, *, key: tuple, mesh, transport: Transport,
                 mirror: Mirror, n_replicated: int, device_output: bool):
        self.inner = inner
        self.key = key
        self.mesh = mesh
        self.transport = transport
        self.mirror = mirror
        self.n_replicated = n_replicated
        self.device_output = device_output
        #: collectives the executor's own function issued, by kind
        self.collectives: Dict[str, int] = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ---- leader ----
    def __call__(self, *args, rows: Optional[int] = None):
        self.transport.seq += 1
        seq = self.transport.seq
        spec = []
        for a in args:
            if not isinstance(a, list):
                spec.append(("whole", np.asarray(a)))
                continue
            blocks = []
            for b in a:
                tag = _tag_of(b)
                if tag is not None:
                    blocks.append(("row", tag))
                elif isinstance(b, torch.Tensor):
                    raise ValueError(
                        f"executor {self.key}: a device argument without a "
                        f"pool tag cannot reach the other ranks")
                else:
                    blocks.append(("host", np.asarray(b)))
            spec.append(("blocks", blocks))
        self.transport.send({"key": self.key, "seq": seq, "rows": rows,
                             "args": spec, "ops": self.mirror.take_ops()})
        out = self._run(args, rows, seq)
        if self.device_output:
            self.mirror.tag_rows(out, seq)
        return out

    # ---- every rank ----
    def replay(self, header: dict):
        """A follower's run of the leader's dispatch ``header``."""
        args = []
        for kind, val in header["args"]:
            if kind == "whole":
                args.append(val)
            else:
                args.append([self.mirror.get(v) if k == "row" else v
                             for k, v in val])
        self._run(args, header["rows"], header["seq"])

    def _local(self, i: int, a):
        """The rank's part of argument ``i``: whole for a replicated one,
        else its ``data`` block of rows."""
        if i < self.n_replicated:
            return a
        n = self.inner.specs[i].shape[0]
        lo = self.mesh.coords.get("data", 0) * n
        if not isinstance(a, list):
            return a[lo:lo + n]
        out, start = [], 0
        for b in a:
            s, e = max(start, lo), min(start + b.shape[0], lo + n)
            if s < e:
                out.append(b[s - start:e - start])
            start += b.shape[0]
        return out

    def _run(self, args, rows: Optional[int], seq: int):
        local = [self._local(i, a) for i, a in enumerate(args)]
        before = shd.counts()
        if self.device_output:
            out = self.inner(*local, rows=rows)
        else:
            out = self.inner(*local)
        after = shd.counts()
        for k, v in after.items():
            d = v - before.get(k, 0)
            if d and k not in TRANSPORT:
                self.collectives[k] = self.collectives.get(k, 0) + d
        if self.device_output:
            if not self.mesh.leader:
                self.mirror.rows.update(
                    ((seq, r), leaves(tree)) for r, tree in enumerate(out))
            return out
        out = self._fetch(out)
        if not self.mesh.leader:
            return None
        host = tree_map(lambda t: t.cpu().numpy(), out)  # flamecheck: host-sync-ok(the leader's scores, gathered from every data rank, go to the host as a single-device executor's do)
        return _split_rows(host, rows)

    def _fetch(self, out):
        """Gather the scores of every data rank to the leader (ranks off
        the leader's ``model`` coordinate hold copies and send nothing)."""
        ways = self.mesh.shape.get("data", 1)
        if ways == 1 or any(c for a, c in self.mesh.coords.items()
                            if a != "data"):
            return out
        import torch.distributed as dist
        group = self.mesh.group("data")
        staged = self.mesh.backend == "gloo"
        flat = []
        for t in leaves(out):
            src = t.contiguous().cpu() if staged else t.contiguous()  # flamecheck: host-sync-ok(gloo gathers host tensors: the scores are staged once, at the dispatch's end)
            parts = [torch.empty_like(src) for _ in range(ways)] \
                if self.mesh.leader else None
            dist.gather(src, parts, dst=0, group=group)
            shd.count("fetch")
            flat.append(torch.cat(parts) if self.mesh.leader else None)
        return unflatten(structure(out), flat)


def follow(executors: Dict[tuple, MeshExecutor], transport: Transport,
           mirror: Mirror) -> int:
    """A follower's loop: replay the leader's dispatches until its stop
    header.  Returns the number of dispatches replayed."""
    n = 0
    while True:
        header = transport.recv()
        mirror.apply(header["ops"])
        if header.get("stop"):
            return n
        executors[header["key"]].replay(header)
        n += 1


def stop(transport: Transport, mirror: Mirror) -> None:
    """The leader's stop header (under the dispatch lock)."""
    transport.send({"stop": True, "ops": mirror.take_ops()})
