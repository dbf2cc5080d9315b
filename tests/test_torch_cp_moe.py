"""Context-parallel attention and expert-parallel MoE of the port against
the JAX package, on 4 gloo ranks (one spawn, ``tests/_mesh_workers.py``).

  * ``context_parallel_attention`` on ``(2, 2)`` and ``(1, 4)`` meshes
    (batch over ``data``, sequence over ``model``) in ``sliding`` 64 /
    ``causal`` / ``full`` mode at the JAX test's shapes, q [2, 256, 4, 32]
    and k / v [2, 256, 2, 32]: the ranks' blocks put together equal JAX's
    ``reference_attention`` within 1e-5 (the sliding case only if rank
    0's wrapped halo is masked); ``impl="cp"`` under the mesh takes the
    same route;
  * ``moe_apply_a2a`` on ``(4, 1)`` and ``(2, 2)`` (experts over
    ``data``, tokens over both axes) at a capacity that drops nothing:
    within 1e-5 of JAX's ``moe_apply`` on one device over every token;
    its aux losses, averages of per-shard values, within 1e-6 of JAX's
    ``moe_apply`` per token shard, averaged;
  * in process: the wrapped halo of a one-way sequence axis is masked
    (the JAX test's tail perturbation), and ``impl="cp"`` routes as the
    JAX ``attention`` does.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import moe as JM
from repro_torch import sharding as shd
from repro_torch.launch.mesh import make_serving_mesh, run_ranks
from repro_torch.models import attention as A
from tests import _mesh_workers as W
from tests.test_torch_moe import _weights, make_cfgs

torch.set_num_threads(1)
TOL = 1e-5
AUX_TOL = 1e-6
CP_MESHES = ("2,2", "1,4")
MOE_MESHES = ("4,1", "2,2")
MODES = (("sliding", 64), ("causal", 0), ("full", 0))


def _qkv(shape_q=(2, 256, 4, 32), shape_kv=(2, 256, 2, 32), seed=0):
    rr = np.random.default_rng(seed)
    return (rr.standard_normal(shape_q).astype(np.float32),
            rr.standard_normal(shape_kv).astype(np.float32),
            rr.standard_normal(shape_kv).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, k, v = _qkv()
    jcfg, cfg = make_cfgs(e=8, k=2, cf=8.0, shared=1)
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(1).standard_normal((8, 16, 64)).astype(
        np.float32)
    job_dir = str(tmp_path_factory.mktemp("cp_moe"))
    torch.save({"q": torch.as_tensor(q), "k": torch.as_tensor(k),
                "v": torch.as_tensor(v), "modes": MODES,
                "cp_meshes": CP_MESHES, "moe_meshes": MOE_MESHES,
                "x": torch.as_tensor(x), "moe_params": tp, "moe_cfg": cfg},
               os.path.join(job_dir, "job.pt"))
    err = []

    def spawn():
        try:
            run_ranks(W.cp_moe_suite, 4, args=(job_dir,), timeout_s=240,
                      threads=1, init_dir=job_dir)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            err.append(e)
    th = threading.Thread(target=spawn)
    th.start()
    yield dict(q=q, k=k, v=v, jcfg=jcfg, jp=jp, x=x, job_dir=job_dir,
               thread=th, err=err)
    th.join()


def _results(ranks):
    ranks["thread"].join()
    if ranks["err"]:
        raise ranks["err"][0]
    return [torch.load(os.path.join(ranks["job_dir"], f"rank{r}.pt"),
                       weights_only=False) for r in range(4)]


def _assemble(res, key, d, m):
    """The global array from the ranks' blocks (rank = data * m + model;
    batch over data, sequence over model)."""
    rows = [torch.cat([res[i * m + j][key] for j in range(m)], dim=1)
            for i in range(d)]
    return torch.cat(rows, dim=0).numpy()


@pytest.mark.parametrize("mesh", CP_MESHES)
def test_cp_attention_on_four_ranks(ranks, mesh):
    res = _results(ranks)
    d, m = (int(x) for x in mesh.split(","))
    q, k, v = (jnp.asarray(ranks[n]) for n in "qkv")
    for mode, window in MODES:
        ref = np.asarray(JA.reference_attention(q, k, v, mode, window=window))
        out = _assemble(res, (mesh, mode), d, m)
        assert float(np.abs(out - ref).max()) < TOL, (mesh, mode)
    ref = np.asarray(JA.reference_attention(q, k, v, "causal"))
    out = _assemble(res, (mesh, "route"), d, m)
    assert float(np.abs(out - ref).max()) < TOL


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_moe_a2a_on_four_ranks(ranks, mesh):
    res = _results(ranks)
    jcfg, jp, x = ranks["jcfg"], ranks["jp"], ranks["x"]
    ref, _ = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    ref = np.asarray(ref).reshape(-1, x.shape[-1])
    out = torch.cat([res[r][(mesh, "moe")][0] for r in range(4)]).numpy()
    assert float(np.abs(out - ref).max()) < TOL
    # aux: the mean over the 4 token shards of each shard's own losses
    shards = np.split(x.reshape(-1, x.shape[-1]), 4)
    want = {n: np.mean([float(JM.moe_apply(jp, jnp.asarray(s[None]),
                                           jcfg)[1][n]) for s in shards])
            for n in ("load_balance_loss", "router_z_loss")}
    for r in range(4):
        _, aux, local_eq_whole = res[r][(mesh, "moe")]
        assert local_eq_whole     # full expert weights or the rank's block
        assert aux["dropped_fraction"] == 0.0
        for n, w in want.items():
            assert abs(aux[n] - w) < AUX_TOL, (n, aux[n], w)
        counts = res[r][(mesh, "counts")]
        assert counts.get("all_to_all", 0) > 0


def test_cp_halo_masks_wraparound_one_way():
    """Rank 0's halo wraps around from the last rank and must be masked:
    on a one-way sequence axis the halo is the rank's own tail, so a
    changed tail leaves the first window of outputs unchanged."""
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 128, 2, 16),
                                                 (1, 128, 2, 16), seed=1))
    mesh = make_serving_mesh("1,1")
    with shd.mesh_rules(mesh):
        out1 = A.context_parallel_attention(q, k, v, "sliding", window=32,
                                            mesh=mesh)
        k2, v2 = k.clone(), v.clone()
        k2[:, -16:] = 99.0
        v2[:, -16:] = 99.0
        out2 = A.context_parallel_attention(q, k2, v2, "sliding", window=32,
                                            mesh=mesh)
    assert torch.equal(out1[:, :32], out2[:, :32])
    ref = JA.reference_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 "sliding", window=32)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref), atol=2e-6)


def test_cp_route():
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 64, 2, 16),
                                                 (1, 64, 2, 16), seed=2))
    chunked = A.attention(q, k, v, "causal", impl="chunked")
    # outside a mesh, and for a mode or offset cp does not take: chunked
    assert torch.equal(A.attention(q, k, v, "causal", impl="cp"), chunked)
    mesh = make_serving_mesh("1,1")
    with shd.mesh_rules(mesh):
        assert torch.equal(
            A.attention(q, k, v, "sumi", impl="cp", n_history=32),
            A.attention(q, k, v, "sumi", impl="chunked", n_history=32))
        cp = A.attention(q, k, v, "causal", impl="cp")
        assert torch.equal(cp, A.context_parallel_attention(
            q, k, v, "causal", window=0))
    with shd.mesh_rules(shd.MeshShape(("data",), (1,))):
        assert torch.equal(A.attention(q, k, v, "causal", impl="cp"),
                           chunked)
    torch.testing.assert_close(cp, chunked, atol=2e-6, rtol=2e-6)
    with pytest.raises(ValueError, match="mesh_rules"):
        A.context_parallel_attention(q, k, v, "causal", window=0)
