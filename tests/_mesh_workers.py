"""Rank bodies of the port's multi-rank tests.  ``launch.mesh.run_ranks``
spawns each rank as a fresh process, which imports these by module, so
they live here and not in a test file; every rank returns what it found
through ``torch.save`` files under the job's directory."""
import dataclasses
import os

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.core.climber import build_climber
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.serving.engine import FlameEngine, serve_follower
from repro_torch.types import ClimberConfig


def climber_cfg(**kw):
    return dataclasses.replace(
        get_config("climber"), **kw,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))


def serve_traffic(eng, traffic):
    """Scores of ``traffic`` (history, candidates, user) served one by
    one, concatenated."""
    return np.concatenate([eng.serve(h, c, user_id=u).ravel()
                           for h, c, u in traffic])


def engine_suite(rank: int, job_dir: str):
    """Every run of ``job.pt`` (a mesh, a config, engine options), in
    order: rank 0 serves the traffic and saves scores and metrics as
    ``run<i>.pt``, every other rank follows."""
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    for i, run in enumerate(job["runs"]):
        mesh = make_serving_mesh(run["mesh"])
        bundle = build_climber(climber_cfg(**job["cfgs"][run["cfg"]]))
        params = job["params"][run["cfg"]]
        kw = dict(run["engine"], device="cpu",
                  store=RemoteFeatureStore(latency_s=0.0, feature_dim=12))
        if not mesh.leader:
            serve_follower(bundle, params, mesh=mesh, **kw)
            continue
        eng = FlameEngine(bundle, params, mesh=mesh, **kw)
        try:
            out = serve_traffic(eng, job["traffic"][run["cfg"]])
            metrics = eng.metrics()
        finally:
            eng.shutdown()
        torch.save({"out": out, "metrics": metrics},
                   os.path.join(job_dir, f"run{i}.pt"))


def cp_moe_suite(rank: int, job_dir: str):
    """``context_parallel_attention`` on each mesh and mode of ``job.pt``
    over this rank's block of q / k / v (batch over ``data``, sequence
    over ``model``), then ``moe_apply_a2a`` over its block of the tokens;
    saves the local outputs as ``rank<r>.pt``."""
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    res = {}
    for shape in job["cp_meshes"]:
        mesh = make_serving_mesh(shape)
        spec = ("data", "model")
        q, k, v = (shd.local_shard(job[n], spec, mesh, mesh.coords)
                   for n in "qkv")
        with shd.mesh_rules(mesh):
            for mode, window in job["modes"]:
                res[(shape, mode)] = A.context_parallel_attention(
                    q, k, v, mode, window=window, mesh=mesh)
            # the JAX impl="cp" route under an active mesh
            res[(shape, "route")] = A.attention(q, k, v, "causal", impl="cp")
    for shape in job["moe_meshes"]:
        mesh = make_serving_mesh(shape)
        x = job["x"].reshape(-1, job["x"].shape[-1])
        xl = shd.local_shard(x, (("data", "model"),), mesh, mesh.coords)
        params = job["moe_params"]
        with shd.mesh_rules(mesh):
            local = dict(params, **{n: shd.local_shard(params[n], ("data",),
                                                       mesh, mesh.coords)
                                    for n in ("w_up", "w_gate", "w_down")
                                    if n in params})
            out, aux = M.moe_apply_a2a(local, xl[None], job["moe_cfg"],
                                       mesh=mesh, axis="data")
            whole, _ = M.moe_apply_a2a(params, xl[None], job["moe_cfg"],
                                       mesh=mesh, axis="data")
        res[(shape, "moe")] = (out[0], {n: float(a) for n, a in aux.items()},
                               torch.equal(out, whole))
        res[(shape, "counts")] = shd.counts()
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))


def _local(x, logical, mesh, rules):
    return shd.local_shard(x, shd.logical_to_spec(logical, x.shape, mesh,
                                                  rules), mesh, mesh.coords)


def _local_tree(tree, logical, mesh, rules):
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], logical[k], mesh, rules)
                for k in tree}
    return _local(tree, logical, mesh, rules).contiguous().clone()


def text_tp_suite(rank: int, job_dir: str):
    """Every run of ``job.pt`` on each of its meshes: the rank's blocks of
    the f32 parameters (``shard_params``), of the caches and of the batch
    under ``rules_for_shape`` (FSDP on), a prefill into the caches and the
    decode steps inside ``mesh_rules``; saves each phase's logits (the
    rank's rows, every vocab column) and the collectives each phase issued
    as ``rank<r>.pt``.  A ``serving`` run takes the dry run's serving
    profile instead: FSDP off, the caches' positions over ``model``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    res = {}
    for mesh_spec in job["meshes"]:
        mesh = make_serving_mesh(mesh_spec)
        for run in job["runs"]:
            cfg = reduced_config(run["arch"])
            bundle = build_model(cfg)
            b = run["batch"]["tokens"].shape[0]
            rules = shd.rules_for_shape(mesh, b, fsdp=not run["serving"])
            if run["serving"]:      # the dry run's --profile serving
                rules["cache_seq"] = tuple(a for a in ("model",)
                                           if a in mesh.axis_names)
            params = shd.shard_params(job["params"][run["arch"]],
                                      shd.param_logical(bundle), mesh,
                                      mesh.coords, rules)
            batch = {k: _local(v, ("batch",) + (None,) * (v.dim() - 1),
                               mesh, rules)
                     for k, v in run["batch"].items()}
            kw = {"n_frames": run["n_frames"]} if cfg.enc_dec else {}
            caches = bundle.cache_init(b, run["max_len"],
                                       dtype=torch.float32, device="cpu",
                                       **kw)
            caches = _local_tree(caches, bundle.cache_logical(), mesh, rules)
            out = {"rows": shd.logical_to_spec(("batch",), (b,), mesh,
                                               rules)}
            with torch.inference_mode(), shd.mesh_rules(mesh, rules):
                c0 = shd.counts()
                logits, caches = bundle.prefill(params, batch,
                                                impl=run["impl"],
                                                caches=caches)
                out["prefill"] = logits
                out["prefill_counts"] = _diff(shd.counts(), c0)
                for i, (tok, cur) in enumerate(run["steps"]):
                    c0 = shd.counts()
                    logits, caches = bundle.decode_step(
                        params, caches, {"tokens": _local(
                            tok, ("batch", None), mesh, rules),
                            "cur_index": torch.tensor(cur)},
                        impl=run["impl"])
                    out[f"step{i}"] = logits
                    out[f"step{i}_counts"] = _diff(shd.counts(), c0)
            res[(mesh_spec, run["name"])] = out
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def train_tp_suite(rank: int, job_dir: str):
    """Every run of ``job.pt`` on each of its meshes (a run may name the
    meshes it takes): the rank's blocks of the f32 parameters and of the
    batch under ``rules_for_shape`` (FSDP on); the loss and the synced
    gradients of the blocks (``loss_fn`` → ``grads_of`` →
    ``sync_grads``, as ``make_train_step`` takes them) with the
    collectives they issued and the shape of every ``all_gather``; then
    two ``make_train_step`` steps on fresh blocks, their metrics, each
    step's collectives and the blocks after them; and the last dim of
    every logits block the loss took.  Saves ``rank<r>.pt``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as MD
    from repro_torch.training.loop import grads_of, make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.tree import leaves, tree_map
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    widths = []
    ce = MD.cross_entropy

    def logged(logits, *args):
        widths.append(logits.shape[-1])
        return ce(logits, *args)
    MD.cross_entropy = logged
    res = {}
    for mesh_spec in job["meshes"]:
        mesh = make_serving_mesh(mesh_spec)
        for run in job["runs"]:
            if mesh_spec not in run.get("meshes", job["meshes"]):
                continue
            cfg = reduced_config(run["arch"])
            bundle = MD.build_model(cfg)
            b = run["batch"]["tokens"].shape[0]
            rules = shd.rules_for_shape(mesh, b, fsdp=True)
            logical = shd.param_logical(bundle)

            def blocks():
                ps = shd.shard_params(job["params"][run["arch"]], logical,
                                      mesh, mesh.coords, rules)
                return tree_map(
                    lambda t: t.detach().clone().requires_grad_(True), ps)
            batch = {k: _local(v, ("batch",) + (None,) * (v.dim() - 1),
                               mesh, rules)
                     for k, v in run["batch"].items()}
            out = {"rows": shd.logical_to_spec(("batch",), (b,), mesh,
                                               rules)}
            with shd.mesh_rules(mesh, rules):
                params = blocks()
                split = shd.leaf_split_axes(*MD.param_specs(cfg))
                widths.clear()
                c0 = shd.counts()
                loss, _ = bundle.loss_fn(params, batch, impl=run["impl"])
                out["loss_counts"] = _diff(shd.counts(), c0)
                grads = shd.sync_grads(grads_of(
                    loss, params, 1.0 / shd.batch_redundancy()), split)
                out["grad_counts"] = _diff(shd.counts(), c0)
                out["logits_widths"] = list(widths)
                out["loss"] = float(loss)
                out["grads"] = [g.detach() for g in grads]
                out["split"] = split
                params = blocks()
                opt = adamw_init(params)
                step = make_train_step(bundle, AdamWConfig(), impl=run["impl"])
                for i in range(2):
                    c0 = shd.counts()
                    params, opt, metrics = step(params, opt, batch)
                    out[f"step{i}"] = {k: float(v) for k, v in metrics.items()}
                    out[f"step{i}_counts"] = _diff(shd.counts(), c0)
                out["params"] = [t.detach() for t in leaves(params)]
            res[(mesh_spec, run["name"])] = out
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))
