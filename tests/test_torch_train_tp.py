"""The sharded train step against the port's mesh-less gradients and JAX's
``make_train_step``, on the CPU at the reduced configs in f32.

Every rank of a gloo mesh takes its blocks of the parameters and of the
batch (``shard_params`` / the ``batch`` rows under ``rules_for_shape``,
FSDP on) and runs ``loss_fn`` and its backward inside
``sharding.mesh_rules`` (``tests/_mesh_workers.py::train_tp_suite``):

- each rank's gradient blocks (after ``sync_grads``) equal the blocks of
  the port's mesh-less gradients within 1e-5;
- a leaf's gradient agrees bitwise across the ranks of every axis the
  leaf is replicated on;
- two ``make_train_step`` steps give the loss and ``grad_norm`` of the
  port's mesh-less steps and of JAX's, and the blocks gathered after
  them JAX's parameters (``make_train_step`` of ``repro.training.loop``
  on one CPU device, jitted), within 1e-5;
- each step issues the collectives of the analytic count
  (``transformer.train_collectives``: the forward's, the remat
  recompute's, the backward's transposes, the gradient sums and the
  norm's), and no rank gathers the [B, S, V] logits.

Seven families (h2o-danube-3-4b, gemma3-12b with tied embeddings,
rwkv6-7b, jamba-v0.1-52b, kimi-k2-1t-a32b, llava-next-mistral-7b with stub
patches, seamless-m4t-large-v2) on the (1, 2) and (2, 1) meshes in one
spawn of 2 ranks; h2o and jamba also on (2, 2) in one spawn of 4; h2o
under ``impl="cp"`` too on all three (its prompt of 128 puts the sliding
window within a rank's block: the halo route), held to the same JAX
steps (JAX's ``attention`` takes ``chunked`` for ``cp`` without a
mesh).  The weights come from the port's initializers, whose tree is
JAX's, fed to both packages in f32.
"""
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_workers as W
from repro.configs import reduced_config as j_reduced_config
from repro.models.model import build_model as j_build_model
from repro.training.loop import make_train_step as j_make_train_step
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch import sharding as shd
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model, param_specs
from repro_torch.models.transformer import train_collectives
from repro_torch.training.loop import grads_of, make_train_step
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import tree_map

torch.set_num_threads(1)
F32_TOL = 1e-5
ARCHS = ("h2o-danube-3-4b", "gemma3-12b", "rwkv6-7b", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b", "llava-next-mistral-7b", "seamless-m4t-large-v2")
FOUR = ("h2o-danube-3-4b", "jamba-v0.1-52b")     # also on (2, 2)
CP = "h2o-danube-3-4b"
CP_SEQ = 128          # h2o's window 64 within a block: the halo route
SEQ = 32
N_FRONT = 8           # stub patches (llava) / frames (seamless)
TWO, ALL = ("1,2", "2,1"), ("1,2", "2,1", "2,2")


def _case(i, arch, impl, rng):
    """(run, JAX's bundle, its f32 weights, the port's, the batch): the
    port's initializers from a generator seeded ``i`` (the same tree of
    names and layouts as JAX's), a batch of 2 rows."""
    jcfg = j_reduced_config(arch)
    tb = build_model(reduced_config(arch))
    t32 = tree_map(lambda t: t.float(), tb.init(
        torch.Generator().manual_seed(i), device="cpu"))
    j32 = tree_map(lambda t: jnp.asarray(t.numpy()), t32)
    s = CP_SEQ if arch == CP else SEQ
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, s)).astype(
        np.int32)}
    if jcfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (2, N_FRONT, jcfg.d_model)).astype(np.float32)
    elif jcfg.modality == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (2, N_FRONT, jcfg.d_model)).astype(np.float32)
    tbatch = {k: torch.as_tensor(v).long() if k == "tokens"
              else torch.as_tensor(v) for k, v in batch.items()}
    name = arch + (":cp" if impl == "cp" else "")
    run = dict(name=name, arch=arch, batch=tbatch, impl=impl,
               meshes=ALL if arch in FOUR or impl == "cp" else TWO)
    return run, j_build_model(jcfg), j32, t32, batch


def _jax_steps(jb, j32, batch):
    """JAX's two ``make_train_step`` steps (jitted; XLA's backend
    optimizations off, which halves the compile): their metrics and the
    parameters after them."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = j_adamw_init(j32)
    step = jax.jit(j_make_train_step(jb, JAdamWConfig())).lower(
        j32, opt, jbatch).compile({"xla_backend_optimization_level": 0})
    p, metrics = j32, []
    for _ in range(2):
        p, opt, m = step(p, opt, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [np.asarray(a) for a in jax.tree.leaves(p)]


def _mesh_less(run, t32):
    """The port's mesh-less loss and gradients, and its two steps."""
    tb = build_model(reduced_config(run["arch"]))
    ref = tree_map(lambda t: t.clone().requires_grad_(True), t32)
    loss, _ = tb.loss_fn(ref, run["batch"], impl=run["impl"])
    grads = [g.detach() for g in grads_of(loss, ref)]
    step = make_train_step(tb, AdamWConfig(), impl=run["impl"])
    own, opt, steps = ref, adamw_init(ref), []
    for _ in range(2):
        own, opt, m = step(own, opt, run["batch"])
        steps.append({k: float(v) for k, v in m.items()})
    return float(loss.detach()), grads, steps


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    built = [_case(i, arch, "chunked", np.random.default_rng(31 + i))
             for i, arch in enumerate(ARCHS)]
    # h2o under cp: the same weights and batch as its chunked case
    built.append(_case(ARCHS.index(CP), CP, "cp",
                       np.random.default_rng(31 + ARCHS.index(CP))))
    runs = [b[0] for b in built]
    params = {b[0]["arch"]: b[3] for b in built}
    got, errors = {}, []

    dirs = {w: str(tmp_path_factory.mktemp(f"train_tp{w}")) for w in (2, 4)}

    def spawn(world, meshes):
        try:
            job_dir = dirs[world]
            torch.save({"meshes": meshes, "runs": runs, "params": params},
                       os.path.join(job_dir, "job.pt"))
            run_ranks(W.train_tp_suite, world, args=(job_dir,),
                      timeout_s=240, threads=1, init_dir=job_dir)
            for r in range(world):
                got[(world, r)] = torch.load(
                    os.path.join(job_dir, f"rank{r}.pt"), weights_only=False)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
    # the ranks run while this process computes the references
    spawns = [threading.Thread(target=spawn, args=a)
              for a in ((2, TWO), (4, ("2,2",)))]
    for t in spawns:
        t.start()
    with ThreadPoolExecutor(4) as pool:     # the compiles run in parallel
        jax_steps = dict(zip(ARCHS, pool.map(
            lambda b: _jax_steps(b[1], b[2], b[4]), built[:len(ARCHS)])))
    # JAX's attention takes chunked for cp without a mesh
    jax_steps[CP + ":cp"] = jax_steps[CP]
    mesh_less = {b[0]["name"]: _mesh_less(b[0], b[3]) for b in built}
    for t in spawns:
        t.join()
    if errors:
        raise errors[0]
    return dict(runs={r["name"]: r for r in runs}, jax=jax_steps,
                mesh_less=mesh_less, got=got)


NAMES = list(ARCHS) + [CP + ":cp"]
CASES = [(n, m) for n in NAMES
         for m in (ALL if n.split(":")[0] in FOUR or ":cp" in n else TWO)]


def _ranks(suite, mesh):
    world = 2 if mesh != "2,2" else 4
    _, model = (int(x) for x in mesh.split(","))
    return [({"data": r // model, "model": r % model},
             suite["got"][(world, r)]) for r in range(world)]


def _specs(name, mesh):
    """Each leaf's spec under the rank's rules, and the mesh."""
    arch = name.split(":")[0]
    data, model = (int(x) for x in mesh.split(","))
    ms = shd.MeshShape(("data", "model"), (data, model))
    rules = shd.rules_for_shape(ms, 2, fsdp=True)
    lg, shapes = param_specs(reduced_config(arch))
    return [shd.logical_to_spec(l_, t.shape, ms, rules)
            for t, l_ in shd.zip_logical(shapes, lg)], ms


@pytest.mark.parametrize("name,mesh", CASES)
def test_rank_gradients_match_mesh_less(suite, name, mesh):
    """Each rank's gradient blocks, and its loss, against the mesh-less
    run's within 1e-5."""
    loss, ref, _ = suite["mesh_less"][name]
    specs, ms = _specs(name, mesh)
    for coords, res in _ranks(suite, mesh):
        out = res[(mesh, name)]
        assert out["loss"] == pytest.approx(loss, rel=F32_TOL, abs=F32_TOL)
        assert len(out["grads"]) == len(ref)
        for i, (g, want, spec) in enumerate(zip(out["grads"], ref, specs)):
            np.testing.assert_allclose(
                g.numpy(), shd.local_shard(want, spec, ms, coords).numpy(),
                atol=F32_TOL, rtol=F32_TOL,
                err_msg=f"{name} {mesh} {coords} leaf {i} {spec}")


@pytest.mark.parametrize("name,mesh", CASES)
def test_replicated_leaves_agree_bitwise(suite, name, mesh):
    """A leaf's gradient is bitwise the same on the ranks that differ only
    along axes the leaf is not split over."""
    specs, _ = _specs(name, mesh)
    ranks = _ranks(suite, mesh)
    for i, spec in enumerate(specs):
        split = {a for e in spec for a in shd._entry_axes(e)}
        seen = {}
        for coords, res in ranks:
            key = tuple(coords[a] for a in ("data", "model") if a in split)
            g = res[(mesh, name)]["grads"][i]
            if key in seen:
                assert torch.equal(g, seen[key]), (name, mesh, i, coords)
            seen[key] = g


def _gathered(blocks, spec, ms, coords_of):
    """The global tensor of the ranks' ``blocks`` under ``spec``."""
    shape = list(blocks[0].shape)
    for d, e in enumerate(spec):
        shape[d] *= math.prod(ms.shape[a] for a in shd._entry_axes(e))
    out = torch.empty(shape, dtype=blocks[0].dtype)
    for blk, coords in zip(blocks, coords_of):
        view = out
        for d, e in enumerate(spec):
            if e is not None:
                n = blk.shape[d]
                view = view.narrow(d, shd.block_index(e, ms, coords) * n, n)
        view.copy_(blk)
    return out


@pytest.mark.parametrize("name,mesh", CASES)
def test_two_steps_match_jax(suite, name, mesh):
    """Two ``make_train_step`` steps: loss and ``grad_norm`` of each on
    every rank, and the parameters gathered after them, against JAX's."""
    metrics, params = suite["jax"][name]
    tol = F32_TOL
    specs, ms = _specs(name, mesh)
    ranks = _ranks(suite, mesh)
    own = suite["mesh_less"][name][2]
    for coords, res in ranks:
        out = res[(mesh, name)]
        for k in range(2):
            for key in ("loss", "grad_norm"):
                assert out[f"step{k}"][key] == pytest.approx(
                    own[k][key], rel=tol), ("mesh-less", key, k, coords)
            assert out[f"step{k}"]["loss"] == pytest.approx(
                metrics[k]["loss"], rel=tol, abs=tol), (k, coords)
            assert out[f"step{k}"]["grad_norm"] == pytest.approx(
                metrics[k]["grad_norm"], rel=tol), (k, coords)
    for i, spec in enumerate(specs):
        whole = _gathered([res[(mesh, name)]["params"][i]
                           for _, res in ranks], spec, ms,
                          [c for c, _ in ranks])
        np.testing.assert_allclose(whole.numpy(), params[i], atol=tol,
                                   rtol=tol, err_msg=f"{name} {mesh} {i}")


@pytest.mark.parametrize("name,mesh", CASES)
def test_collectives_match_the_analytic_count(suite, name, mesh):
    """Each train step's collectives by kind equal the analytic count,
    and the loss takes the rank's block of the vocabulary (no rank holds
    the [B, S, V] logits)."""
    arch = name.split(":")[0]
    cfg = reduced_config(arch)
    data, model = (int(x) for x in mesh.split(","))
    run = suite["runs"][name]
    cp_seq = run["batch"]["tokens"].shape[1] if ":cp" in name else 0
    want = train_collectives(
        cfg, data, model, fsdp=True, cp_seq=cp_seq,
        patches="patch_embeds" in run["batch"],
        dtypes=lambda path: torch.float32)
    for _, res in _ranks(suite, mesh):
        out = res[(mesh, name)]
        for k in range(2):
            assert out[f"step{k}_counts"] == want, (name, mesh, k)
        assert out["logits_widths"] == [cfg.vocab_size // model]
