"""Where a train step's gradient norm comes from, on the card.

    python3 scripts/train_grad_probe.py [--arch rwkv6-7b] [--lr 3e-4]
        [--parts leaves,steps,mesh] [--out DIR]

For ``chip_smoke.py``'s train-mesh case (the model at full width cut to 2
layers, its seeded weights and batch of 2 x 256 tokens):

1. ``leaves``: each leaf's step-0 gradient norm from ``make_train_step``'s
   ``grads_of``, mesh-less on the card, with the weights in bf16, in f32,
   and in bf16 with cuBLAS's reduced-precision bf16 reductions off; each
   leaf's bf16 gradient's distance from its f32 one.  The same at a cut
   width (d_model 512, the weights made on the host) as a check against
   the CPU.
2. ``steps``: five ``make_train_step`` steps mesh-less in bf16 at ``--lr``
   (warm-up 1): loss, grad norm, the largest decay sum over one scan chunk
   (``-sum(w_log)``; ``exp`` of more than 88.72 overflows f32), the
   leaves whose gradient is not finite, whether each scan's input and
   output gradients are finite.  The inputs of the first scan whose
   chunk decay passes 88.72, with its output's gradient, go to
   ``scan_overflow.pt`` under ``--out`` (default ``build/train_grad_probe``),
   for ``scripts/scan_overflow_witness.py`` to run through JAX's
   ``wkv_chunked`` and the port's plain scan on the host.
3. ``mesh``: two gloo ranks sharing the card, on (1, 2) and (2, 1): each
   leaf's global step-0 gradient norm (``sync_grads``' blocks, each
   block counted once) in bf16 and f32.

Prints one JSON line per part; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
OUT = os.path.join(ROOT, "build", "train_grad_probe")
EXP_MAX = 88.72        # exp overflows f32 past it
MESHES = ("1,2", "2,1")


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                         f"{pre}/{k}")]
    return [pre]


def _case(arch: str, lr: float, width: int = 0):
    """(cfg, bundle, AdamW config, tokens) of chip_smoke's case; with
    ``width`` the model cut to that d_model (heads of 64, d_ff 3.5x)."""
    import chip_smoke as cs
    from repro_torch.training.optimizer import AdamWConfig
    cfg, bundle, _, tokens = cs.train_mesh_setup(arch, 2, 0)
    if width:
        from repro_torch.models.model import build_model
        cfg = dataclasses.replace(cfg, d_model=width, n_heads=width // 64,
                                  n_kv_heads=width // 64,
                                  d_ff=int(width * 3.5))
        bundle = build_model(cfg)
    return cfg, bundle, AdamWConfig(lr=lr, warmup_steps=1), tokens


def _grads(bundle, params, batch):
    import torch
    from repro_torch.training.loop import grads_of
    from repro_torch.tree import leaves
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = bundle.loss_fn(params, batch)
    g = [x.detach().float() for x in grads_of(loss, params)]
    torch.cuda.synchronize()
    return float(loss.detach()), g


def leaves_part(arch: str, lr: float, device) -> dict:
    import torch
    from repro_torch.tree import tree_map
    out = {}
    for width in (0, 512):
        cfg, bundle, _, tokens = _case(arch, lr, width)
        if width:       # the weights the host makes
            base = tree_map(lambda t: t.to(device), bundle.init(
                torch.Generator().manual_seed(0), "cpu"))
        else:
            base = bundle.init(torch.Generator(device=device).manual_seed(0),
                               device)
        names = _paths(base)
        batch = {"tokens": tokens.to(device)}
        runs = {}
        for tag, dt, reduced in (("f32", torch.float32, True),
                                 ("bf16", torch.bfloat16, True),
                                 ("bf16_exact_reduce", torch.bfloat16,
                                  False)):
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = reduced
            p = tree_map(lambda t: t.detach().to(dt).clone(), base)
            runs[tag] = _grads(bundle, p, batch)
            del p
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = True
        ref = runs["f32"][1]
        rows = {}
        for i, n in enumerate(names):
            r = float(ref[i].norm())
            rows[n] = {tag: float(g[i].norm()) for tag, (_, g) in
                       runs.items()}
            rows[n]["bf16_vs_f32"] = float((runs["bf16"][1][i] - ref[i])
                                           .norm()) / max(r, 1e-30)
        out[f"d{cfg.d_model}"] = {
            "loss": {t: v[0] for t, v in runs.items()},
            "norm": {t: math.sqrt(sum(float(x.norm()) ** 2 for x in v[1]))
                     for t, v in runs.items()},
            "leaves": rows}
        del base, runs, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def steps_part(arch: str, lr: float, device, out_dir: str = OUT) -> dict:
    import torch
    import repro_torch.models.rwkv6 as R
    from repro_torch.training import loop
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.tree import leaves
    cfg, bundle, opt_cfg, tokens = _case(arch, lr)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device)
    names = _paths(params)
    for p in leaves(params):
        p.requires_grad_(True)
    calls, seen = [], {}
    orig_scan = R.wkv_chunked

    def spy(r, k, v, w_log, u, state=None, chunk=R.CHUNK, *, train=False):
        b, s, h, d = w_log.shape
        c = min(chunk, s)
        rec = {"decay_sum": float((-w_log.detach()).reshape(
            b, s // c, c, h, d).sum(2).max()), "grads": {}}
        ins = dict(r=r, k=k, v=v, w_log=w_log)
        o, st = orig_scan(r, k, v, w_log, u, state, chunk, train=train)
        if torch.is_grad_enabled() and o.requires_grad:
            # copies: ``u`` is a parameter the update writes in place
            rec["inputs"] = {n: t.detach().clone() for n, t in ins.items()}
            rec["inputs"]["u"] = u.detach().clone()
            for n, t in list(ins.items()) + [("o", o)]:
                if t.requires_grad:
                    t.register_hook(lambda g, n=n, rec=rec:
                                    rec["grads"].__setitem__(n, g.detach()))
            calls.append(rec)
        return o, st
    R.wkv_chunked = spy

    def spy_update(opt_cfg, grads, opt_state, params, split_axes=None):
        seen["bad"] = [n for n, g in zip(names, grads)
                       if not bool(torch.isfinite(g).all())]
        return orig_update(opt_cfg, grads, opt_state, params, split_axes)
    orig_update = loop.adamw_update
    loop.adamw_update = spy_update
    step = loop.make_train_step(bundle, opt_cfg)
    opt = adamw_init(params)
    batch = {"tokens": tokens.to(device)}
    rows, dumped = [], None
    try:
        for i in range(5):
            calls.clear()
            params, opt, m = step(params, opt, batch)
            fired = [c for c in calls if c["grads"]]
            row = {"step": i, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "decay_sum_max": [c["decay_sum"] for c in fired],
                   "nonfinite_leaves": seen["bad"],
                   "scans": [{n: bool(torch.isfinite(g).all())
                              for n, g in c["grads"].items()}
                             for c in fired]}
            rows.append(row)
            for j, c in enumerate(fired):
                if dumped is None and c["decay_sum"] > EXP_MAX:
                    os.makedirs(out_dir, exist_ok=True)
                    dumped = os.path.join(out_dir, "scan_overflow.pt")
                    torch.save({"step": i, "scan": j,
                                "inputs": {n: t.cpu() for n, t in
                                           c["inputs"].items()},
                                "grad_o": c["grads"]["o"].cpu()}, dumped)
    finally:
        R.wkv_chunked = orig_scan
        loop.adamw_update = orig_update
    return {"lr": lr, "steps": rows, "dumped": dumped}


def mesh_rank(rank: int, job_dir: str):
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.model import param_specs
    from repro_torch.training.loop import grads_of
    from repro_torch.tree import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    device = job["device"]
    cfg, bundle, _, tokens = _case(job["arch"], job["lr"])
    logical = shd.param_logical(bundle)
    res = {}
    for spec in MESHES:
        mesh = make_serving_mesh(spec, device=device)
        rules = shd.rules_for_shape(mesh, tokens.shape[0], fsdp=True)
        local = None
        for turn in range(2):
            if turn == rank:
                full = bundle.init(torch.Generator(device=device)
                                   .manual_seed(0), device)
                local = shd.shard_params(full, logical, mesh, mesh.coords,
                                         rules)
                del full
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        rows = shd.logical_to_spec(("batch", None), tokens.shape, mesh,
                                   rules)
        batch = {"tokens": shd.local_shard(tokens, rows, mesh,
                                           mesh.coords).to(device)}
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            p = tree_map(lambda t: t.detach().to(dt).clone()
                         .requires_grad_(True), local)
            with shd.mesh_rules(mesh, rules):
                loss, _ = bundle.loss_fn(p, batch)
                split = shd.leaf_split_axes(*param_specs(cfg))
                g = shd.sync_grads(grads_of(
                    loss, p, 1.0 / shd.batch_redundancy()), split)
                sq = torch.stack([torch.sum(torch.square(x.float()))
                                  / shd.replication(a)
                                  for x, a in zip(g, split)])
                sq = shd.sum_ranks(sq)
            res[(spec, tag)] = (float(loss.detach()),
                                [math.sqrt(float(x)) for x in sq.cpu()])
            del p, g
            gc.collect()
            torch.cuda.empty_cache()
        del local
    if rank == 0:
        torch.save(res, os.path.join(job_dir, "rank0.pt"))


def mesh_part(arch: str, lr: float, device) -> dict:
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.model import param_specs
    names = _paths(param_specs(_case(arch, lr)[0])[1])
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(arch=arch, lr=lr, device=device),
                   os.path.join(tmp, "job.pt"))
        run_ranks(mesh_rank, 2, backend="gloo", args=(tmp,), timeout_s=600,
                  init_dir=tmp)
        res = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    return {f"{spec} {tag}": {
        "loss": loss, "norm": math.sqrt(sum(x * x for x in norms)),
        "leaves": dict(zip(names, norms))}
        for (spec, tag), (loss, norms) in res.items()}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--parts", default="leaves,steps,mesh")
    ap.add_argument("--out", default=OUT,
                    help="where the steps part saves scan_overflow.pt")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_grad_probe.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(f"[train_grad_probe] card: {cs.card_line()}", flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for part in a.parts.split(","):
        if part == "steps":
            out = steps_part(a.arch, a.lr, device, a.out)
        else:
            out = {"leaves": leaves_part, "mesh": mesh_part}[part](
                a.arch, a.lr, device)
        print(json.dumps({"part": part, "arch": a.arch, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
