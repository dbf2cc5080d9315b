"""The port's fixed executor pool (paper Fig 10): ``ExecutorPool`` and
``DynamicStreamOrchestrator`` (``repro_torch/core/dso.py``), the ports of
``tests/test_dso.py``'s pool and orchestrator tests on the CPU (executors
run eagerly there), and ``padded_fraction`` and SUMI's two FLOP formulas
against the JAX package's (exact: the same arithmetic on Python numbers).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.dso import padded_fraction as j_padded_fraction
from repro.core.sumi import (cached_flops_per_request as j_cached_flops,
                             flops_per_request as j_flops)
from repro_torch.core.dso import (Chunk, DynamicStreamOrchestrator,
                                  ExecutorPool, padded_fraction,
                                  split_request)
from repro_torch.core.sumi import cached_flops_per_request, flops_per_request
from repro_torch.types import TensorSpec

torch.set_num_threads(1)


def test_padded_fraction():
    assert padded_fraction(128, [128]) == 0.0
    assert padded_fraction(1, [128]) > 0.99


@pytest.mark.parametrize("buckets", [(128,), (128, 64, 32),
                                     (1024, 512, 256, 128),
                                     (1024, 256), tuple(range(128, 1025,
                                                              128))])
def test_padded_fraction_matches_jax(buckets):
    for m in list(range(1, 300)) + [511, 512, 513, 1000, 1024, 1025, 4097]:
        assert padded_fraction(m, buckets) == j_padded_fraction(m, buckets)


@pytest.mark.parametrize("n_history,m,blocks,lpb,d,f", [
    (512, 128, 2, 12, 256, 1024), (1024, 512, 2, 12, 256, 1024),
    (96, 7, 3, 2, 64, 160), (2048, 1, 4, 6, 512, 2048)])
def test_flop_formulas_match_jax(n_history, m, blocks, lpb, d, f):
    assert flops_per_request(n_history, m, blocks, lpb, d, f) == \
        j_flops(n_history, m, blocks, lpb, d, f)
    assert cached_flops_per_request(n_history, m, blocks, lpb, d, f) == \
        j_cached_flops(n_history, m, blocks, lpb, d, f)


def _build_pool(buckets, n_streams=2, fn=None):
    def build_fn(bucket):
        return (fn or (lambda x: x * 2.0),
                (TensorSpec((1, bucket), torch.float32),))
    return ExecutorPool(build_fn, buckets, n_streams=n_streams, device="cpu")


def _pad_slice(request, chunk: Chunk):
    x, = request
    sl = x[:, chunk.start:chunk.start + chunk.valid]
    if chunk.valid < chunk.bucket:
        sl = np.pad(sl, ((0, 0), (0, chunk.bucket - chunk.valid)))
    return (sl,)


def _gather(results, chunks, m):
    return np.concatenate([r[:, :c.valid] for r, c in zip(results, chunks)],
                          axis=1)


def test_executor_pool_checkout():
    pool = _build_pool([32, 16])
    e1 = pool.acquire(32)
    e2 = pool.acquire(32)
    assert e1.eid != e2.eid
    assert e1 is not e2 and e1.static_in[0] is not e2.static_in[0]
    pool.release(e1)
    e3 = pool.acquire(32)
    assert e3.eid == e1.eid       # round-trips through the index queue
    assert {ex.bucket for ex in pool.executors} == {32, 16}
    assert len(pool.executors) == 4 and pool.build_time_s >= 0


def test_orchestrator_end_to_end_matches_direct():
    pool = _build_pool([32, 16], n_streams=2)
    dso = DynamicStreamOrchestrator(pool, _pad_slice, _gather)
    for m in (7, 16, 33, 70, 100):
        x = np.arange(m, dtype=np.float32)[None]
        out = dso.score((x,), m)
        np.testing.assert_allclose(out, x * 2.0)
        assert out.shape == (1, m)
    assert dso.chunk_count == sum(len(split_request(m, [32, 16]))
                                  for m in (7, 16, 33, 70, 100))
    dso.shutdown()


def test_concurrent_submissions():
    pool = _build_pool([16], n_streams=2)
    dso = DynamicStreamOrchestrator(pool, _pad_slice, _gather, max_workers=8)
    xs = [np.full((1, 40), float(i), np.float32) for i in range(8)]
    futs = [dso.submit((x,), 40) for x in xs]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(), np.full((1, 40), 2.0 * i))
    dso.shutdown()


def test_no_executor_is_held_twice_and_outputs_are_owned():
    """Under 8 workers and 2 executors a bucket, an executor's static
    buffers serve one chunk at a time (no eid is checked out twice at
    once), and a result never aliases the executor's static outputs."""
    held, lock, clash = set(), threading.Lock(), []

    def slow(x):
        time.sleep(0.002)
        return x * 2.0
    pool = _build_pool([32, 16], n_streams=2, fn=slow)
    acquire, release = pool.acquire, pool.release

    def tracked_acquire(bucket):
        ex = acquire(bucket)
        with lock:
            if ex.eid in held:
                clash.append(ex.eid)
            held.add(ex.eid)
        return ex

    def tracked_release(ex):
        with lock:
            held.discard(ex.eid)
        release(ex)
    pool.acquire, pool.release = tracked_acquire, tracked_release
    dso = DynamicStreamOrchestrator(pool, _pad_slice, _gather, max_workers=8)
    xs = [np.arange(m, dtype=np.float32)[None] + i
          for i, m in enumerate((40, 77, 130, 16, 33, 90, 128, 5))]
    futs = [dso.submit((x,), x.shape[1]) for x in xs]
    outs = [f.result() for f in futs]
    dso.shutdown()
    assert not clash and not held
    for x, o in zip(xs, outs):
        np.testing.assert_array_equal(o, x * 2.0)
    for ex in pool.executors:
        for o in outs:
            assert not np.shares_memory(o, ex.static_out.numpy())
