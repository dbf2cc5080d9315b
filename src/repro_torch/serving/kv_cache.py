"""KV state managers for serving.  Port of ``repro/serving/kv_cache.py``.

``KVCacheManager``   batched decode-cache slot manager for the text engine:
                     one pooled cache tree, per-slot lengths,
                     prefill-insert / release.

``HistoryKVPool`` is a byte-budgeted, optionally quantized LRU pool of
cached *history-side* SUMI K/V.  The SUMI mask makes the history prefix
self-contained, so its per-layer K/V depend only on the user history;
FlameEngine encodes it once, parks it here, and repeat traffic runs
candidate-only executors against the pooled entry.

*Keys and staleness.*  Entries are keyed by a stable user identity (or a
content hash of the history) and carry a **fingerprint** of the full
upstream history.  A key hit whose fingerprint differs is *stale*: it is
dropped and counted as a miss; ``lookup(want_basis=True)`` hands the dropped
entry back as a :class:`StaleBasis` (its K/V, the model window it encoded,
how many extensions it already carries), so the engine can re-encode only
the changed suffix against it.

*Capacity.*  ``slots`` bounds the entry count, ``budget_bytes`` the stored
bytes; eviction is strictly LRU.  An entry that alone exceeds
``budget_bytes`` is *rejected*, so ``bytes_used <= budget_bytes`` always
holds.

*Placement.*  ``placement="device"`` keeps stored tensors in the memory of
the pool's ``device`` (CUDA memory on the GPU, next to the weights);
``placement="host"`` keeps them in CPU memory.  ``spill_bytes > 0`` adds a
host second tier: primary-tier evictions demote there instead of being
dropped, and a later hit promotes the entry back (``spill_hits``).  A
demoted entry is one host buffer — pinned when the pool's device is the
card — holding its stored tensors at aligned offsets, so a promotion is
one host-to-device copy into one device buffer whose views are the entry's
tensors, bitwise the stored representation.

*Mesh.*  Under a mesh each rank's pool holds that rank's shard of every
entry (``sharding.SERVING_KV_LEAF``: heads over ``model``, or the history
length under the context-parallel fallback; the row axis replicated), and
``shard_ways`` (the model ways) splits ``budget_bytes``, the pool's total
across shards, evenly: a shard holds at most ``budget_bytes //
shard_ways``.  The layout is symmetric, so every shard holds the bytes
this one does (``shard_bytes``, the ``bytes_shard{i}`` stats).  A spilled
entry is this rank's shard too; ``on_tier_move(old, new, where)`` is told
of every demotion (``"host"``) and promotion (``"device"``) with the
entry's payload before and after, so that the other ranks can move their
shards the same way.

*Quantization.*  ``dtype`` selects the stored precision: ``"native"``,
``"bf16"``, or ``"int8"`` with a per-(layer, head) absmax scale.  The int8
codes and scales are bitwise those of the JAX ``quantize_leaf`` on the same
f32 input (both divide, multiply by 127 and round half to even, in that
order).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.tree import leaves, tree_map
from repro_torch.types import TensorSpec

POOL_DTYPES = ("native", "bf16", "int8")


@dataclasses.dataclass
class Slot:
    active: bool = False
    length: int = 0
    request_id: int = -1
    tokens: Optional[list] = None


class KVCacheManager:
    def __init__(self, bundle, batch: int, max_len: int, **kw):
        self.bundle = bundle
        self.batch = batch
        self.max_len = max_len
        self.caches = bundle.cache_init(batch, max_len, **kw)
        self.slots = [Slot() for _ in range(batch)]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def assign(self, request_id: int, prompt_len: int) -> int:
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free KV-cache slots")
        i = free[0]
        self.slots[i] = Slot(True, prompt_len, request_id, [])
        return i

    def release(self, slot: int):
        self.slots[slot] = Slot()

    def write_prefill(self, slot: int, caches_one):
        """Insert a single-sequence cache (batch=1, stacked-layer axis 0) into
        batch position ``slot`` of the pooled cache: an indexed copy along
        axis 1, in place (the JAX package builds a new tree)."""
        for full, one in zip(leaves(self.caches), leaves(caches_one)):
            full.narrow(1, slot, one.shape[1]).copy_(one)

    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self.slots], np.int32)


@dataclasses.dataclass
class _QuantLeaf:
    """One quantized KV leaf: values + (for int8) per-(layer, head) scale.

    KV leaves are [B, L, S, Hkv, D]; the int8 scale reduces over (S, D) and
    keeps (B, L, 1, Hkv, 1).  ``scale is None`` marks a plain bf16 cast.
    ``dtype`` is the compute dtype a dequantizing lookup hands back."""

    q: torch.Tensor
    scale: Optional[torch.Tensor]
    dtype: torch.dtype


def _is_quant(x) -> bool:
    return isinstance(x, _QuantLeaf)


def _scale_axes(ndim: int) -> Tuple[int, ...]:
    if ndim >= 4:
        return (ndim - 3, ndim - 1)          # (S, D) of [..., S, Hkv, D]
    return tuple(range(ndim))                # fallback: one global scale


def _int8(a: torch.Tensor):
    af = a.float()
    scale = torch.clamp_min(
        torch.amax(af.abs(), dim=_scale_axes(a.dim()), keepdim=True), 1e-8)
    q = torch.clamp(torch.round(af / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale


def quantize_leaf(a: torch.Tensor, dtype: str):
    """Stored representation of one KV leaf: the tensor itself for
    ``native``, a :class:`_QuantLeaf` otherwise."""
    if dtype == "native":
        return a
    if dtype == "bf16":
        return _QuantLeaf(a.to(torch.bfloat16), None, a.dtype)
    if dtype == "int8":
        q, scale = _int8(a)
        return _QuantLeaf(q, scale, a.dtype)
    raise ValueError(f"pool dtype must be one of {POOL_DTYPES}, got {dtype!r}")


def dequantize_leaf(stored):
    """Invert :func:`quantize_leaf` back to the compute dtype."""
    if not _is_quant(stored):
        return stored
    if stored.scale is None:
        return stored.q.to(stored.dtype)
    return (stored.q.float() * (stored.scale / 127.0)).to(stored.dtype)


def quantize_kv(kv, dtype: str):
    """Quantize a KV pytree; returns (payload pytree, stored nbytes)."""
    payload = tree_map(lambda a: quantize_leaf(a, dtype), kv)
    return payload, payload_bytes(payload)


def quantize_kv_graph(kv, dtype: str):
    """In-epilogue pool quantization for the fused encode executor: emits
    the :func:`raw_kv_view` structure directly — ``(int8 values, f32
    scale)`` tuples, ``(bf16 values, None)`` casts, or the native tensors —
    so the executor's output already IS the pool's stored representation
    (``put(prequantized=True)``).  Same arithmetic as :func:`quantize_leaf`,
    so the codes and scales are bitwise identical."""
    if dtype == "native":
        return kv

    def one(a):
        if dtype == "bf16":
            return (a.to(torch.bfloat16), None)
        if dtype == "int8":
            return _int8(a)
        raise ValueError(
            f"pool dtype must be one of {POOL_DTYPES}, got {dtype!r}")
    return tree_map(one, kv)


def dequantize_kv(payload):
    return tree_map(dequantize_leaf, payload, is_leaf=_is_quant)


def raw_kv_view(payload):
    """Zero-copy raw view of a stored payload for the fused executors: every
    quantized leaf becomes a ``(values, scale)`` tuple over the stored
    tensors (scale ``None`` for a bf16 cast).  Callers must not write to the
    tensors — they alias pool storage."""
    return tree_map(lambda s: (s.q, s.scale) if _is_quant(s) else s, payload,
                    is_leaf=_is_quant)


def raw_kv_specs(kv_specs, dtype: str):
    """:class:`TensorSpec` pytree matching :func:`raw_kv_view` output for a
    pool storing ``dtype`` — what the fused executors take."""
    def one(spec: TensorSpec):
        if dtype == "native":
            return spec
        if dtype == "bf16":
            return (TensorSpec(spec.shape, torch.bfloat16), None)
        if dtype == "int8":
            scale_shape = tuple(1 if i in _scale_axes(len(spec.shape)) else s
                                for i, s in enumerate(spec.shape))
            return (TensorSpec(spec.shape, torch.int8),
                    TensorSpec(scale_shape, torch.float32))
        raise ValueError(f"pool dtype must be one of {POOL_DTYPES}, "
                         f"got {dtype!r}")
    return tree_map(one, kv_specs, is_leaf=lambda x: isinstance(x, TensorSpec))


def _map_stored(payload, fn):
    """``payload`` with every stored tensor (values, scales, native leaves)
    replaced by ``fn(tensor)``, visited in :func:`raw_kv_view`'s leaf
    order."""
    if payload is None:
        return None
    if _is_quant(payload):
        return _QuantLeaf(fn(payload.q), None if payload.scale is None
                          else fn(payload.scale), payload.dtype)
    if isinstance(payload, dict):
        return {k: _map_stored(payload[k], fn) for k in sorted(payload)}
    if isinstance(payload, (tuple, list)):
        return type(payload)(_map_stored(x, fn) for x in payload)
    return fn(payload)


def payload_bytes(payload) -> int:
    """Stored bytes of a (possibly quantized) payload pytree."""
    return sum(t.numel() * t.element_size() for t in leaves(raw_kv_view(payload)))


def quantized_nbytes(kv, dtype: str) -> int:
    """Stored bytes :func:`quantize_kv` would produce, without quantizing:
    shape and dtype arithmetic only, so admission prechecks are free."""
    total = 0
    for a in leaves(kv):
        n = a.numel()
        if dtype == "native":
            total += n * a.element_size()
        elif dtype == "bf16":
            total += n * 2
        elif dtype == "int8":
            axes = _scale_axes(a.dim())
            total += n + 4 * int(np.prod([1 if i in axes else s
                                          for i, s in enumerate(a.shape)]))
        else:
            raise ValueError(
                f"pool dtype must be one of {POOL_DTYPES}, got {dtype!r}")
    return total


#: byte alignment of each stored tensor inside a spilled entry's buffer
#: (the CUDA allocator's own; the kernels' vector loads need 16)
_SPILL_ALIGN = 256


def _spill_span(t: torch.Tensor) -> int:
    """Bytes one stored tensor takes in a spilled entry's buffer."""
    return -(-t.numel() * t.element_size() // _SPILL_ALIGN) * _SPILL_ALIGN


def _spill_views(buf: torch.Tensor, payload):
    """``payload`` rebuilt from views of ``buf`` with the shapes and dtypes
    of its stored tensors, laid end to end at aligned offsets (one strided
    view each of ``buf`` reinterpreted once per dtype: a promotion's host
    work)."""
    typed: Dict[torch.dtype, torch.Tensor] = {}
    off = 0

    def view(t):
        nonlocal off
        flat = typed.get(t.dtype)
        if flat is None:
            flat = typed[t.dtype] = buf.view(t.dtype)
        stride, n = [], 1
        for d in reversed(t.shape):
            stride.insert(0, n)
            n *= d
        v = flat.as_strided(t.shape, stride, off // t.element_size())
        off += _spill_span(t)
        return v
    return _map_stored(payload, view)


# ---------------------------------------------------------------------------
# history-KV pool (GR serving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)           # identity semantics: tier members
class _PoolEntry:
    fingerprint: Hashable
    payload: object                # stored (possibly quantized) KV pytree
    nbytes: int
    hist_window: Optional[np.ndarray]   # model-window ids at encode time
    refreshes: int = 0             # incremental extensions since full encode
    #: the spill tier's one host buffer whose views are ``payload``'s
    #: tensors (None while the payload is in the primary tier's memory)
    spill_buf: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StaleBasis:
    """What ``lookup`` hands back for a dropped stale entry, so the engine
    can extend the cached prefix instead of re-encoding from scratch."""

    kv: object                     # K/V extension basis (dequantized, or a
                                   # raw stored view under ``raw_basis``)
    hist_window: Optional[np.ndarray]  # window the basis encoded
    refreshes: int = 0             # extensions already layered on this basis


class HistoryKVPool:
    """Byte-budgeted two-tier LRU pool of encoded history K/V (PDA v2).

    ``lookup(key, fingerprint, want_basis=..., raw=..., raw_basis=...)`` —
    one counted probe returning ``(kv, status, basis)`` with status
    ``"hit"``, ``"stale"`` (entry dropped; ``basis`` is its
    :class:`StaleBasis` when ``want_basis``) or ``"miss"``; it checks the
    primary tier, then the spill tier, promoting on a spill hit.
    ``raw=True`` (the executors) hands back :func:`raw_kv_view` of the
    stored payload, no dequantization, no copy, and ``raw_basis=True``
    does the same for a stale basis.  ``get`` is the v1 sugar (the
    dequantized kv on a hit, else None); ``peek`` the uncounted re-check
    of single-flight leader election, over both tiers; ``put`` admits and
    evicts LRU-first until ``slots`` and ``budget_bytes`` hold, demoting
    evictions to the spill tier when ``spill_bytes`` > 0.
    ``count_extension`` / ``count_refresh_reencode`` are the engine's
    callbacks behind the ``extensions`` / ``refresh_reencodes`` stats.
    All methods are thread-safe.

    The spill tier (``spill_bytes``, its own budget) holds each demoted
    entry as one host buffer, pinned when the pool's device is the card
    (pinned memory that cannot be had raises; there is no pageable
    fallback).  Demotion copies the entry's tensors into it outside the
    lock and waits for the copies; promotion is one host-to-device copy on
    the current stream into one device buffer, whose views become the
    entry's tensors.  The executors' streams wait on the default stream
    before they stage, so a dispatch of a promoted entry reads it after
    the copy.  No device tensor of the pool goes back to the caching
    allocator while a dispatcher's stream reads it: every rider keeps its
    own reference to the rows it dispatched until its dispatch has
    finished (the dispatcher waits for its stream before futures
    resolve)."""

    def __init__(self, slots: Optional[int] = 256, *,
                 budget_bytes: Optional[int] = None, dtype: str = "native",
                 placement: str = "device", spill_bytes: int = 0,
                 device="cuda", shard_ways: Optional[int] = None):
        if slots is None and budget_bytes is None:
            raise ValueError("pool needs slots and/or budget_bytes")
        if slots is not None and slots < 1:
            raise ValueError(f"pool needs >= 1 slot, got {slots}")
        if budget_bytes is not None and budget_bytes < 1:
            raise ValueError(f"budget_bytes must be >= 1, got {budget_bytes}")
        if dtype not in POOL_DTYPES:
            raise ValueError(f"dtype must be one of {POOL_DTYPES}, got {dtype!r}")
        if placement not in ("device", "host"):
            raise ValueError(f"placement must be device|host, got {placement!r}")
        self.slots = slots
        self.budget_bytes = budget_bytes
        self.dtype = dtype
        self.placement = placement
        self.device = resolve_device(device) if placement == "device" \
            else torch.device("cpu")
        self.spill_budget = int(spill_bytes)
        #: model ways of the mesh this pool serves (None: no mesh)
        self.shard_ways = shard_ways
        self._limit = budget_bytes if budget_bytes is None \
            or not shard_ways else budget_bytes // shard_ways
        self.on_tier_move = None
        self._entries: "collections.OrderedDict[Hashable, _PoolEntry]" = \
            collections.OrderedDict()
        self._spill: "collections.OrderedDict[Hashable, _PoolEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.evictions = 0
        self.rejects = 0
        self.extensions = 0
        self.refresh_reencodes = 0
        self.spill_hits = 0
        self.bytes_used = 0
        self.spill_bytes_used = 0

    @staticmethod
    def entry_bytes(kv) -> int:
        """Unquantized (compute-dtype) bytes of a KV pytree."""
        return payload_bytes(kv)

    def _place(self, payload):
        move = lambda t: t.to(self.device)  # noqa: E731  # flamecheck: host-sync-ok(into the pool's own memory: a no-op for a device pool on the executors' card; a host-placement pool keeps its rows on the host by contract)
        return tree_map(
            lambda s: _QuantLeaf(move(s.q), None if s.scale is None
                                 else move(s.scale), s.dtype)
            if _is_quant(s) else move(s), payload, is_leaf=_is_quant)

    def _load(self, e_payload, raw: bool):
        return raw_kv_view(e_payload) if raw else dequantize_kv(e_payload)

    # ---- spill tier ----
    def _to_spill(self, payload):
        """Copy a payload into one host buffer (pinned when the pool's
        device is the card); returns (buffer, payload of views into it).
        Waits for the copies: the source tensors may go back to the
        caching allocator as soon as the entry's payload is replaced."""
        pin = self.device.type == "cuda"
        size = sum(_spill_span(t) for t in leaves(raw_kv_view(payload)))
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
        if pin and not buf.is_pinned():
            raise RuntimeError("the spill tier needs pinned host memory and "
                               "the allocation returned pageable memory")
        host = _spill_views(buf, payload)
        for dst, src in zip(leaves(raw_kv_view(host)),
                            leaves(raw_kv_view(payload))):
            dst.copy_(src, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(self.device).synchronize()  # flamecheck: host-sync-ok(demotion to the spill tier: the copies must finish before the source rows go back to the caching allocator)
        return buf, host

    def _from_spill(self, buf: torch.Tensor, payload):
        """Promote a spilled entry: one host-to-device copy of its buffer on
        the current stream, the entry's tensors views of the device copy
        (the host buffer itself on a CPU pool).  PyTorch records the copy
        on the pinned buffer, so the buffer is not reused before the copy
        has read it."""
        if self.device.type == "cpu":
            return payload
        dev = torch.empty(buf.shape, dtype=torch.uint8, device=self.device)
        dev.copy_(buf, non_blocking=True)
        return _spill_views(dev, payload)

    # ---- lookup side ----
    def lookup(self, key: Hashable, fingerprint: Hashable, *,
               want_basis: bool = False, raw: bool = False,
               raw_basis: bool = False):
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if e.fingerprint == fingerprint:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    status = "hit"
                else:
                    del self._entries[key]      # stale: history advanced
                    self.bytes_used -= e.nbytes
                    self.stale += 1
                    self.misses += 1
                    status = "stale"
            else:
                e = self._spill.pop(key, None)
                if e is None:
                    self.misses += 1
                    return None, "miss", None
                self.spill_bytes_used -= e.nbytes
                if e.fingerprint == fingerprint:
                    self.hits += 1
                    self.spill_hits += 1
                    status = "promote"
                else:
                    self.stale += 1
                    self.misses += 1
                    status = "stale"
            payload, spill_buf = e.payload, e.spill_buf
        if status == "promote":
            # the copy runs outside the lock; while in flight the entry sits
            # in neither tier, and a concurrent miss of the same key may
            # encode and put meanwhile: admit only if the key is still
            # absent (the racing entry is at least as fresh, and this
            # request is served from its own promoted copy either way)
            if spill_buf is not None:
                moved = self._from_spill(spill_buf, payload)
                if moved is not payload and self.on_tier_move is not None:
                    self.on_tier_move(raw_kv_view(payload),
                                      raw_kv_view(moved), "device")
                payload = moved
            promoted = _PoolEntry(e.fingerprint, payload, e.nbytes,
                                  e.hist_window, e.refreshes)
            demoted: List[_PoolEntry] = []
            with self._lock:
                if key not in self._entries:
                    demoted = self._admit(key, promoted)
            self._finish_demotions(demoted)
            return self._load(payload, raw), "hit", None
        # payloads are never written once stored: load outside the lock
        if status == "hit":
            return self._load(payload, raw), "hit", None
        # the basis keeps the dropped tensors referenced for as long as the
        # engine's extend dispatch reads them
        basis = StaleBasis(self._load(payload, raw_basis), e.hist_window,
                           e.refreshes) if want_basis else None
        return None, "stale", basis

    def get(self, key: Hashable, fingerprint: Hashable):
        """v1 surface: the dequantized kv on a fresh hit, else None."""
        kv, _, _ = self.lookup(key, fingerprint)
        return kv

    def contains(self, key: Hashable, fingerprint: Hashable) -> bool:
        """Uncounted existence probe over both tiers (no recency touch)."""
        with self._lock:
            e = self._entries.get(key) or self._spill.get(key)
            return e is not None and e.fingerprint == fingerprint

    def peek(self, key: Hashable, fingerprint: Hashable, *,
             raw: bool = False):
        """A hit's ``lookup`` without touching the hit/miss counters, without
        dropping stale entries and without promoting: a spilled entry is
        handed back from the spill tier (host tensors, which the executors
        stage like any host rows)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.fingerprint == fingerprint:
                self._entries.move_to_end(key)
            else:
                e = self._spill.get(key)
                if e is None or e.fingerprint != fingerprint:
                    return None
            payload = e.payload
        return self._load(payload, raw)

    # ---- admission side ----
    def _admit(self, key: Hashable, entry: _PoolEntry) -> List[_PoolEntry]:  # flamecheck: locked-by-caller(self._lock)
        """Insert into the primary tier and evict until the limits hold;
        the caller holds the lock.  Returns the entries demoted to the
        spill tier, whose payloads are still in the primary tier's memory:
        the caller copies them out after releasing the lock
        (:meth:`_finish_demotions`), so lookups never wait on a copy."""
        demoted: List[_PoolEntry] = []
        old = self._entries.pop(key, None)
        if old is not None:                 # replace, don't leak its bytes
            self.bytes_used -= old.nbytes
        self._entries[key] = entry
        self.bytes_used += entry.nbytes
        while (self.slots is not None and len(self._entries) > self.slots) \
                or (self._limit is not None
                    and self.bytes_used > self._limit):
            k, ev = self._entries.popitem(last=False)   # LRU end
            self.bytes_used -= ev.nbytes
            self.evictions += 1
            if self.spill_budget > 0:
                stale_sp = self._spill.pop(k, None)
                if stale_sp is not None:    # keep the byte accounting true
                    self.spill_bytes_used -= stale_sp.nbytes
                self._spill[k] = ev
                self.spill_bytes_used += ev.nbytes
                demoted.append(ev)
        while self.spill_bytes_used > self.spill_budget and self._spill:
            _, ev = self._spill.popitem(last=False)
            self.spill_bytes_used -= ev.nbytes
            if ev in demoted:
                demoted.remove(ev)          # evicted again before its copy
        return demoted

    def _finish_demotions(self, demoted: List[_PoolEntry]):
        """Copy freshly demoted entries into the spill tier's host memory,
        outside the lock.  The copy is committed only if the entry still
        sits in the spill tier: a concurrent promotion took the entry's
        primary-tier payload and wins the race either way."""
        for ev in demoted:
            with self._lock:
                payload = ev.payload
            buf, host = self._to_spill(payload)
            if self.on_tier_move is not None:
                self.on_tier_move(raw_kv_view(payload), raw_kv_view(host),
                                  "host")
            with self._lock:
                if any(e is ev for e in self._spill.values()):
                    ev.payload, ev.spill_buf = host, buf

    def put(self, key: Hashable, fingerprint: Hashable, kv,
            hist_window: Optional[np.ndarray] = None, refreshes: int = 0, *,
            prequantized: bool = False, compute_dtype=None) -> bool:
        """Quantize + admit; returns False when the entry was rejected for
        exceeding ``budget_bytes`` on its own (checked from shapes before
        any quantize pass).  ``refreshes`` records how many incremental
        extensions are layered on the entry since its last full encode
        (read back through :class:`StaleBasis`).  ``prequantized=True``:
        ``kv`` already IS the stored representation (the
        :func:`raw_kv_view` structure of :func:`quantize_kv_graph`) and is
        wrapped with no quantize pass; ``compute_dtype`` (default f32) is
        what dequantizing lookups hand back.  A put clears the key's spill
        copy."""
        payload = None
        if prequantized:
            cdt = compute_dtype or torch.float32
            payload = tree_map(lambda x: _QuantLeaf(x[0], x[1], cdt)
                               if isinstance(x, tuple) else x, kv,
                               is_leaf=lambda x: isinstance(x, tuple))
            nbytes = payload_bytes(payload)
        else:
            nbytes = quantized_nbytes(kv, self.dtype)
        if self._limit is not None and nbytes > self._limit:
            with self._lock:
                self.rejects += 1
            return False
        if payload is None:
            payload = tree_map(lambda a: quantize_leaf(a, self.dtype), kv)
        payload = self._place(payload)
        if hist_window is not None:
            hist_window = np.array(hist_window)
        with self._lock:
            sp = self._spill.pop(key, None)
            if sp is not None:
                self.spill_bytes_used -= sp.nbytes
            demoted = self._admit(key, _PoolEntry(fingerprint, payload,
                                                  nbytes, hist_window,
                                                  refreshes))
        self._finish_demotions(demoted)
        return True

    def count_extension(self):
        with self._lock:
            self.extensions += 1

    def count_refresh_reencode(self):
        """A stale hit had an extendable basis, but the extension-drift cap
        forced a full re-encode instead."""
        with self._lock:
            self.refresh_reencodes += 1

    # ---- introspection / lifecycle ----
    def keys(self) -> List[Hashable]:
        """Primary-tier keys, LRU -> MRU order."""
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def drop(self, key: Hashable) -> bool:
        """Force-evict one key from both tiers; counted in ``evictions``."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self.bytes_used -= e.nbytes
            sp = self._spill.pop(key, None)
            if sp is not None:
                self.spill_bytes_used -= sp.nbytes
            if e is None and sp is None:
                return False
            self.evictions += 1
            return True

    def release(self) -> None:
        """Drop every entry of both tiers (engine shutdown); counters
        survive."""
        with self._lock:
            self._entries.clear()
            self._spill.clear()
            self.bytes_used = 0
            self.spill_bytes_used = 0

    def shard_bytes(self) -> List[int]:
        """Primary-tier bytes per model shard ([] without a mesh); the
        layout is symmetric, so every shard holds this one's bytes."""
        with self._lock:
            return [self.bytes_used] * (self.shard_ways or 0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            shard = {}
            if self.shard_ways:
                shard["shard_ways"] = self.shard_ways
                for i in range(self.shard_ways):
                    shard[f"bytes_shard{i}"] = self.bytes_used
            return {
                **shard,
                "entries": len(self._entries),
                "slots": self.slots if self.slots is not None else -1,
                "budget_bytes": (self.budget_bytes
                                 if self.budget_bytes is not None else -1),
                "hits": self.hits,
                "misses": self.misses,
                "stale": self.stale,
                "evictions": self.evictions,
                "rejects": self.rejects,
                "extensions": self.extensions,
                "refresh_reencodes": self.refresh_reencodes,
                "hit_rate": self.hits / total if total else 0.0,
                "bytes": self.bytes_used,
                "spill_entries": len(self._spill),
                "spill_bytes": self.spill_bytes_used,
                "spill_hits": self.spill_hits,
            }
