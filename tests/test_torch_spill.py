"""The port's ``HistoryKVPool`` spill tier and its v1 surface, without JAX.

- The port of ``tests/test_kv_pool_stress.py``: concurrent put / lookup /
  extend traffic against the pool's byte, slot and counter invariants,
  with the spill tier on.
- The spill tier's layout: a demoted entry is one host buffer whose views
  are its stored tensors, bitwise, at aligned offsets; a promoted entry's
  tensors are bitwise the stored ones; ``get`` / ``peek`` / ``contains`` /
  ``drop`` / ``release`` over both tiers.
- ``cuda``-marked: demotion and promotion on the card (pinned buffers, one
  host-to-device copy per promotion, leaves bitwise).  They skip here.

(The spill tier against the JAX pool's stats, trace for trace, is in
``tests/test_torch_overload.py``.)
"""
import gc
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.serving.kv_cache import (_SPILL_ALIGN, HistoryKVPool,
                                          payload_bytes, quantize_kv_graph,
                                          raw_kv_view)
from repro_torch.tree import leaves

N_THREADS = 8
N_OPS = 120


def _kv(seed: int, rows: int = 4):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, 8, generator=g),
            torch.randn(rows, 8, generator=g))


def _run_threads(fn):
    """Run ``fn(tid)`` on N_THREADS threads under a short switch interval
    (more interleavings); re-raise the first error; every thread must end
    inside its timeout."""
    errs = []

    def wrap(tid):
        try:
            fn(tid)
        except BaseException as e:  # noqa: BLE001 — surface in main thread
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=wrap, args=(i,))
                   for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a worker hung"
    finally:
        sys.setswitchinterval(old)
    if errs:
        raise errs[0]


def _assert_accounting(pool: HistoryKVPool):
    """Quiescent-state accounting invariants (threads joined)."""
    primary = sum(e.nbytes for e in pool._entries.values())
    spilled = sum(e.nbytes for e in pool._spill.values())
    assert pool.bytes_used == primary, \
        f"bytes_used={pool.bytes_used} but entries sum to {primary}"
    assert pool.spill_bytes_used == spilled, \
        f"spill_bytes_used={pool.spill_bytes_used} vs {spilled}"
    if pool.budget_bytes is not None:
        assert pool.bytes_used <= pool.budget_bytes
    assert pool.spill_bytes_used <= pool.spill_budget
    if pool.slots is not None:
        assert len(pool) <= pool.slots


# ---------------------------------------------------------------------------
# the port of tests/test_kv_pool_stress.py
# ---------------------------------------------------------------------------

def test_concurrent_churn_budget_and_counter_invariants():
    """Shared hot keyspace sized to force eviction + spill demotion."""
    one = payload_bytes(_kv(0))
    pool = HistoryKVPool(slots=6, budget_bytes=4 * one + 1,
                         placement="host", spill_bytes=3 * one + 1)
    lookups = [0] * N_THREADS

    def worker(tid):
        rng = np.random.default_rng(tid)
        for i in range(N_OPS):
            key = ("u", int(rng.integers(10)))
            # two rotating fingerprints per key force stale transitions
            fp = f"fp{(i // 7) % 2}"
            kv, status, basis = pool.lookup(key, fp, want_basis=True)
            lookups[tid] += 1
            if status == "hit":
                assert kv is not None and len(kv) == 2
            else:
                assert kv is None
                if status == "stale" and basis is not None:
                    pool.count_extension()
                pool.put(key, fp, _kv(key[1]),
                         hist_window=np.arange(16, dtype=np.int32))

    _run_threads(worker)
    _assert_accounting(pool)
    st = pool.stats()
    assert st["hits"] + st["misses"] == sum(lookups), \
        "every counted lookup must land in exactly one of hits/misses"
    assert pool.extensions <= pool.stale
    # churn actually happened, through the spill tier too
    assert st["misses"] > 0 and pool.evictions > 0 and st["spill_hits"] > 0


def test_concurrent_disjoint_writers_no_lost_updates():
    """With room for every entry, each writer's final put must survive."""
    keys_per_thread = 4
    n_keys = N_THREADS * keys_per_thread
    one = payload_bytes(_kv(0))
    pool = HistoryKVPool(slots=n_keys, budget_bytes=n_keys * one + 1,
                         placement="host")
    final_fp = {}

    def worker(tid):
        for i in range(N_OPS):
            key = ("t", tid, i % keys_per_thread)
            fp = f"{tid}-{i}"
            pool.put(key, fp, _kv(tid * 1000 + i % keys_per_thread),
                     hist_window=np.arange(8, dtype=np.int32))
            final_fp[key] = fp     # per-key writes are single-threaded
            kv, status, _ = pool.lookup(key, fp)
            assert status == "hit", f"own write lost: {key} -> {status}"
            # an uncounted, non-destructive read of another thread's key
            other = ("t", (tid + 1) % N_THREADS, i % keys_per_thread)
            pool.peek(other, "whatever")

    _run_threads(worker)
    _assert_accounting(pool)
    assert len(pool) == n_keys
    for key, fp in final_fp.items():
        kv, status, _ = pool.lookup(key, fp)
        assert status == "hit", f"lost update: {key} fp={fp} -> {status}"
        torch.testing.assert_close(kv[0], _kv(key[1] * 1000 + key[2])[0],
                                   rtol=0, atol=0)


def test_concurrent_extend_refresh_counters():
    """count_extension / count_refresh_reencode from many threads."""
    pool = HistoryKVPool(slots=4, placement="host")
    per_thread = 50

    def worker(tid):
        for i in range(per_thread):
            pool.count_extension()
            if i % 5 == 0:
                pool.count_refresh_reencode()

    _run_threads(worker)
    assert pool.extensions == N_THREADS * per_thread
    assert pool.refresh_reencodes == N_THREADS * (per_thread // 5)


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_concurrent_quantized_churn(dtype):
    """Quantized entries keep exact byte accounting under churn."""
    one = payload_bytes(_kv(0))
    pool = HistoryKVPool(slots=5, budget_bytes=6 * one, dtype=dtype,
                         placement="host", spill_bytes=2 * one)

    def worker(tid):
        for i in range(60):
            key = int((tid + i) % 8)
            if pool.get(key, "fp") is None:
                pool.put(key, "fp", _kv(key))

    _run_threads(worker)
    _assert_accounting(pool)


# ---------------------------------------------------------------------------
# the spill tier's layout and v1 surface
# ---------------------------------------------------------------------------

def _entry(seed=0, s=5):
    g = torch.Generator().manual_seed(seed)
    return {"b0": {"k": torch.randn(1, 2, s, 2, 4, generator=g),
                   "v": torch.randn(1, 2, s, 2, 4, generator=g)},
            "b1": {"k": torch.randn(1, 2, s, 2, 4, generator=g),
                   "v": torch.randn(1, 2, s, 2, 4, generator=g)}}


@pytest.mark.parametrize("dtype", ["native", "bf16", "int8"])
def test_demoted_entry_is_one_buffer_of_views(dtype):
    """Evicting into the spill tier packs the entry into one host buffer:
    every stored tensor a view of it at an aligned offset, in its stored
    dtype and bitwise; a spill hit promotes it back bitwise."""
    pool = HistoryKVPool(1, dtype=dtype, spill_bytes=1 << 20, device="cpu")
    raw = quantize_kv_graph(_entry(0), dtype)
    pool.put("a", "fa", raw, prequantized=True)
    want = [t.clone() for t in leaves(raw)]
    pool.put("b", "fb", quantize_kv_graph(_entry(1), dtype),
             prequantized=True)
    assert pool.keys() == ["b"] and pool.stats()["spill_entries"] == 1
    e = pool._spill["a"]
    buf = e.spill_buf
    assert buf is not None and buf.dtype == torch.uint8 and buf.dim() == 1
    got = leaves(raw_kv_view(e.payload))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
        assert (g.data_ptr() - buf.data_ptr()) % _SPILL_ALIGN == 0
        assert torch.equal(g, w)
    # peek / contains see the spill tier without promoting
    assert pool.contains("a", "fa") and not pool.contains("a", "other")
    assert pool.peek("a", "fa", raw=True) is not None
    assert pool.stats()["spill_hits"] == 0
    kv, status, _ = pool.lookup("a", "fa", raw=True)
    assert status == "hit" and pool.stats()["spill_hits"] == 1
    for g, w in zip(leaves(kv), want):
        assert torch.equal(g, w)
    # promoted back to the primary tier (MRU), "b" demoted in its place
    assert pool.keys() == ["a"] and list(pool._spill) == ["b"]


def test_spill_budget_put_drop_release_and_get():
    """The spill tier's own budget evicts LRU-first; ``put`` and ``drop``
    clear a key's spill copy; ``release`` empties both tiers; ``get`` is
    the dequantized v1 surface and ``entry_bytes`` the unquantized
    bytes."""
    one = payload_bytes(_entry(0))
    assert HistoryKVPool.entry_bytes(_entry(0)) == one
    pool = HistoryKVPool(1, spill_bytes=2 * one, device="cpu")
    for i in range(4):
        pool.put(i, f"f{i}", _entry(i))
    assert pool.keys() == [3] and list(pool._spill) == [1, 2]
    assert pool.spill_bytes_used == 2 * one and pool.evictions == 3
    torch.testing.assert_close(pool.get(2, "f2")["b0"]["k"],
                               _entry(2)["b0"]["k"], rtol=0, atol=0)
    assert list(pool._spill) == [1, 3] and pool.keys() == [2]
    pool.put(1, "new", _entry(5))                 # clears the spill copy
    assert 1 not in pool._spill and pool.keys() == [1]
    assert pool.drop(3) and not pool.contains(3, "f3")
    assert pool.get(9, "x") is None
    pool.release()
    assert len(pool) == 0 and pool.stats()["spill_entries"] == 0
    assert pool.bytes_used == 0 and pool.spill_bytes_used == 0


def test_stale_spill_entry_is_a_miss():
    pool = HistoryKVPool(1, spill_bytes=1 << 20, device="cpu")
    pool.put("a", "f1", _entry(0))
    pool.put("b", "f1", _entry(1))
    kv, status, basis = pool.lookup("a", "f2", want_basis=True)
    assert kv is None and status == "stale" and basis is not None
    st = pool.stats()
    assert st["stale"] == 1 and st["misses"] == 1 and st["spill_entries"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned memory and the device "
                    "copy have no CPU mode)")
    return torch.device("cuda", 0)


def _h2d_copies(fn):
    """``fn()`` under a dispatch mode counting ``copy_`` calls from host to
    device memory.  The mode leaves reference cycles behind; they are
    collected here: a collection that fell inside a later test's CUDA-graph
    capture invalidated that capture on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.copy_.default \
                    and args[0].is_cuda and not args[1].is_cuda:
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    del Count
    gc.collect()
    torch.cuda.synchronize()
    return out, n[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_spill_tier_on_the_card(cuda, dtype):
    """Demote and promote on the card: the spill buffers are pinned, a
    promotion is one host-to-device copy into one device buffer, and the
    promoted leaves are bitwise the stored ones."""
    pool = HistoryKVPool(1, dtype=dtype, spill_bytes=1 << 24, device=cuda)
    entries = {k: quantize_kv_graph(
        {b: {n: t.to(cuda) for n, t in kv.items()}
         for b, kv in _entry(i, s=257).items()}, dtype)
        for i, k in enumerate("ab")}
    want = [t.cpu() for t in leaves(entries["a"])]
    pool.put("a", "fa", entries["a"], prequantized=True)
    pool.put("b", "fb", entries["b"], prequantized=True)
    e = pool._spill["a"]
    assert e.spill_buf.is_pinned() and not e.spill_buf.is_cuda
    for g, w in zip(leaves(raw_kv_view(e.payload)), want):
        assert torch.equal(g, w)
    (kv, status, _), copies = _h2d_copies(
        lambda: pool.lookup("a", "fa", raw=True))
    assert status == "hit" and copies == 1
    got = leaves(kv)
    base = got[0].untyped_storage().data_ptr()
    for g, w in zip(got, want):
        assert g.is_cuda and g.untyped_storage().data_ptr() == base
        assert torch.equal(g.cpu(), w)
    # and "b", demoted by the promotion, is pinned host memory too
    assert pool._spill["b"].spill_buf.is_pinned()
