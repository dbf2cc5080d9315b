"""Sharded serving of the port: ``FlameEngine(mesh=...)`` against the
single-rank engine, and the single-rank engine against the JAX engine.

  * in process, a ``(1, 1)`` mesh is bitwise a mesh-less engine (no
    collective runs, the executors are the same);
  * 4 gloo ranks (one spawn, ``tests/_mesh_workers.py``), every run
    against the single-rank engine on the same weights and traffic:
    ``(4, 1)`` bitwise for ``reference`` and ``chunked`` over an int8 pool
    and for the pool-off ``full`` family (each data rank runs the
    single-device executor's local shape); ``(2, 2)`` within 5e-3 under
    ``chunked`` (native pool, and pool off) and ``fused`` (int8, deduped
    rows), with the per-shard pool bytes halved; ``(1, 4)`` with 2 KV
    heads on 4 model ways, the context-parallel fallback, within 5e-3;
    and the collectives each executor kind issued: ``cached`` / ``full``
    none of all-gather, all-to-all or point-to-point under ``(4, 1)``,
    no all-to-all or point-to-point under ``(2, 2)``;
    and a (2, 2) mesh whose pool spills to its host tier and promotes
    back (each rank its own shard) within 5e-3, with the same spill hits;
  * the launcher's ``--mesh 2,2`` on the CPU runs to its report;
  * the single-rank port engine against the JAX engine on the same
    carried weights (1e-4 over a native pool, as
    ``tests/test_torch_engine.py``).

The 5e-3 is the JAX package's own tolerance for its (2, 2) mesh
(``tests/test_sharded_serving.py``): the head-sharded out-projection and
the FFN's down projection add partial sums, a reassociation that compounds
through the block stack.
"""
import dataclasses
import gc
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.pda import RemoteFeatureStore as JStore
from repro.models import build_model
from repro.serving import create_engine as j_create_engine
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.core import climber as C
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.launch.mesh import make_serving_mesh, run_ranks
from repro_torch.serving import create_engine
from repro_torch.tree import tree_map
from tests import _mesh_workers as W

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 5e-3
#: the JAX sharded-serving test's config (4 heads, 4 KV heads), and one
#: with 2 KV heads whose history blocks (62 / 2 + 1 = 32 rows) split 4 ways
CFGS = {"tp": dict(vocab_size=5000, d_model=64, d_ff=256, n_heads=4,
                   n_kv_heads=4, head_dim=16),
        "cp": dict(vocab_size=5000, d_model=64, d_ff=256, n_heads=4,
                   n_kv_heads=2, head_dim=16)}
CFGS["spill"] = CFGS["tp"]
N_HISTORY = {"tp": 64, "cp": 62, "spill": 64}
POOL = dict(history_cache=True, pool_slots=16, buckets=(16,))
FULL = dict(history_cache=False, buckets=(16,))
#: (mesh, config, engine options, how the result is held)
RUNS = [
    ("4,1", "tp", dict(POOL, impl="reference", pool_dtype="int8"), "bitwise"),
    ("4,1", "tp", dict(POOL, impl="chunked", pool_dtype="int8"), "bitwise"),
    ("4,1", "tp", dict(FULL, impl="reference"), "bitwise"),
    ("2,2", "tp", dict(POOL, impl="chunked", pool_dtype="native"), "tol"),
    ("2,2", "tp", dict(FULL, impl="chunked"), "tol"),
    ("2,2", "tp", dict(POOL, impl="fused", pool_dtype="int8"), "tol"),
    ("1,4", "cp", dict(POOL, impl="chunked", pool_dtype="int8"), "tol"),
    # two primary slots for three returning users: every rank spills its
    # own shard of the evicted entry and promotes it on the user's return
    ("2,2", "spill", dict(POOL, impl="chunked", pool_dtype="int8",
                          pool_slots=2, pool_spill_bytes=1 << 20), "tol"),
]


def _traffic(name, seed=0):
    rr = np.random.default_rng(seed)
    if name == "spill":
        hist = [rr.integers(0, 5000, 64).astype(np.int32) for _ in range(3)]
        return [(hist[u], rr.integers(0, 5000, 11).astype(np.int32), u)
                for u in (0, 1, 2, 0, 1, 2)]
    return [(rr.integers(0, 5000, N_HISTORY[name]).astype(np.int32),
             rr.integers(0, 5000, 11).astype(np.int32), i % 2)
            for i in range(6)]


def _engine_kw(run_kw, name):
    return dict(run_kw, n_history=N_HISTORY[name], n_streams=1,
                max_batch=4, window_s=0.001)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Port-initialised f32 weights for each config; the 4-rank suite
    starts at once on a thread of its own, so the single-rank baselines
    (and the JAX engine's weights) are made while it runs."""
    params = {n: tree_map(lambda t: t.float(), C.climber_init(
        W.climber_cfg(**CFGS[n]), torch.Generator().manual_seed(i),
        device="cpu")) for i, n in enumerate(("tp", "cp"))}
    params["spill"] = params["tp"]
    job_dir = str(tmp_path_factory.mktemp("mesh_serving"))
    torch.save({"cfgs": CFGS, "params": params,
                "traffic": {n: _traffic(n) for n in CFGS},
                "runs": [dict(mesh=m, cfg=c, engine=_engine_kw(kw, c))
                         for m, c, kw, _ in RUNS]},
               os.path.join(job_dir, "job.pt"))
    err = []

    def spawn():
        try:
            run_ranks(W.engine_suite, 4, args=(job_dir,), timeout_s=300,
                      threads=1, init_dir=job_dir)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            err.append(e)
    th = threading.Thread(target=spawn)
    th.start()
    yield dict(params=params, job_dir=job_dir, thread=th, err=err)
    th.join()


def _single(params, name, run_kw, mesh=None):
    eng = create_engine(
        "flame", C.build_climber(W.climber_cfg(**CFGS[name])), params[name],
        mesh=mesh, device="cpu",
        store=RemoteFeatureStore(latency_s=0.0, feature_dim=12),
        **_engine_kw(run_kw, name))
    try:
        return W.serve_traffic(eng, _traffic(name)), eng.metrics()
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def suite(setup):
    setup["thread"].join()
    if setup["err"]:
        raise setup["err"][0]
    return [torch.load(os.path.join(setup["job_dir"], f"run{i}.pt"),
                       weights_only=False) for i in range(len(RUNS))]


def test_one_by_one_mesh_is_the_meshless_engine(setup):
    kw = dict(POOL, impl="chunked", pool_dtype="int8")
    base, _ = _single(setup["params"], "tp", kw)
    out, m = _single(setup["params"], "tp", kw, mesh=make_serving_mesh("1,1"))
    np.testing.assert_array_equal(base, out)
    assert m["pool_shard_ways"] == 1 and m["pool_bytes_shard0"] > 0
    assert m["mesh_data_ways"] == m["mesh_model_ways"] == 1
    assert not any(k.startswith("mesh_all") for k in m)   # no collective


def test_single_rank_against_jax_engine(setup):
    """(Runs while the 4-rank suite does.)"""
    jcfg = dataclasses.replace(
        j_get_config("climber"), **CFGS["tp"],
        climber=JClimberConfig(num_blocks=2, layers_per_block=2))
    jbundle = build_model(jcfg)
    jparams, _ = jbundle.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = {"tp": C.params_from_jax(jax.tree.map(np.asarray, j32),
                                      device="cpu")}
    kw = dict(n_history=64, buckets=(16,), history_cache=True, pool_slots=16,
              pool_dtype="native", impl="chunked", max_batch=4,
              window_s=0.001)
    jeng = j_create_engine("flame", jbundle, j32,
                           store=JStore(latency_s=0.0, feature_dim=12), **kw)
    try:
        jout = np.concatenate([np.asarray(jeng.serve(h, c, user_id=u)).ravel()
                               for h, c, u in _traffic("tp")])
    finally:
        jeng.shutdown()
    out, _ = _single(params, "tp", dict(kw, n_streams=1))
    np.testing.assert_allclose(out, jout, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"{m}-{c}-{kw['impl']}-"
                              f"{kw.get('pool_dtype', 'full')}"
                              for m, c, kw, _ in RUNS])
def test_mesh_run_against_single_rank(setup, suite, i):
    mesh, name, kw, how = RUNS[i]
    base, bm = _single(setup["params"], name, kw)
    out, m = suite[i]["out"], suite[i]["metrics"]
    assert out.shape == base.shape and np.isfinite(out).all()
    if how == "bitwise":
        np.testing.assert_array_equal(out, base)
    else:
        assert float(np.abs(out - base).max()) <= TOL
    d, mw = (int(x) for x in mesh.split(","))
    assert (m["mesh_data_ways"], m["mesh_model_ways"]) == (d, mw)
    assert m["dso_captured"] == 0 and m["dso_dispatch_failures"] == 0
    # the scoring kinds issue no reshard collective; the data-parallel
    # mesh none at all
    banned = ("all_to_all", "p2p") if mw > 1 else \
        ("all_to_all", "p2p", "all_gather", "all_reduce")
    for kind in ("cached", "full"):
        for op in banned:
            assert m.get(f"mesh_{op}_{kind}", 0) == 0, (kind, op)
    if kw["history_cache"]:
        assert m["pool_shard_ways"] == mw
        assert m["pool_bytes_shard0"] > 0
        assert m["pool_bytes_used_shard0"] == m["pool_bytes_shard0"]
        if mw == 2:
            assert m["pool_bytes_shard0"] == m["pool_bytes_shard1"]
            assert 2 * m["pool_bytes_shard0"] == bm["pool_bytes"]
        if name == "cp":
            # the history length rides the model axis: cached dispatches
            # gather it, the attention weights stay whole (no all_reduce
            # of an out-projection) while the FFN is still split
            assert m["mesh_all_gather_cached"] > 0
            assert m["mesh_all_reduce_cached"] > 0
        elif mw > 1:
            assert m.get("mesh_all_gather_cached", 0) == 0
        if d > 1:
            assert m["mesh_all_gather_encode"] > 0   # the publish
        if name == "spill":
            assert m["pool_spill_hits"] == bm["pool_spill_hits"] > 0


def test_launcher_mesh_on_cpu():
    """The launcher joins its ranks without a time limit: the test bounds
    the whole run, the launcher and the ranks it spawned (one session,
    killed as a group)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh", "2,2", "--requests", "8", "--history", "16",
         "--d-model", "32", "--buckets", "8,4", "--counts", "4,8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "[serve] mesh: data=2 x model=2 over 4 gloo rank(s)" in out
    assert "[serve] 8 requests" in out


class _CollectingLock:
    """A lock that runs a garbage collection as soon as it is held, and
    fails (rather than hangs) where its holder asks for it again."""

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        if not self._lock.acquire(timeout=5):
            raise RuntimeError("the mirror's lock taken inside itself")
        gc.collect()

    def __exit__(self, *exc):
        self._lock.release()


def test_mirror_finalizers_inside_its_lock():
    """A pooled tensor in a reference cycle dies in whatever collection
    finds it, also one inside the mirror's own locked sections: its
    finalizer must neither block there nor lose a count."""
    from repro_torch.serving import spmd

    def cyclic():
        t = torch.zeros(2)
        t.self_ref = t          # only a collection frees it
        return t

    mirror = spmd.Mirror(torch.device("cpu"))
    mirror._lock = _CollectingLock()
    enabled = gc.isenabled()
    gc.disable()
    try:
        rows = [[cyclic(), cyclic()], [cyclic()]]
        mirror.tag_rows(rows, seq=1)
        keep = rows[1][0]
        del rows                # row (1, 0) is garbage, not yet collected
        new = torch.zeros(2)
        # _tag's lock collects row (1, 0); then take_ops frees it
        mirror.moved([keep], [new], "host")
        assert mirror.take_ops() == [("host", (1, 1)), ("free", (1, 0))]
        del keep                # the row lives on in its moved tensor
        assert mirror.take_ops() == []
        del new
        assert mirror.take_ops() == [("free", (1, 1))]
    finally:
        if enabled:
            gc.enable()
