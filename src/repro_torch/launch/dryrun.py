"""Multi-pod dry run of the port: each (arch x shape) on the production
mesh, per chip, without a device.  Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The JAX dry run lowers and compiles each step under GSPMD over 512 host
devices and reads XLA's analyses.  The port is SPMD with explicit
collectives, so the dry run runs rank 0's program itself: the production
mesh is ``launch.mesh.dry_mesh`` (torch's ``fake`` process group of 256 or
512 ranks in this process), the parameters, caches and inputs are
``meta`` tensors of rank 0's local blocks under
``sharding.rules_for_shape`` (nothing is allocated: kimi-k2's trillion
parameters are shapes), and the step — ``bundle.prefill``, one
``decode_step`` against a ``seq_len`` cache, or at the train shape one
step of ``training.loop.make_train_step`` with the AdamW state sharded
as the parameters, as JAX's — runs once under
``roofline.cost_analysis``: FLOPs, bytes, the collectives it issued by
kind (the backward's too), and :class:`roofline.LiveBytes`' eager peak.
``roofline.analyse`` with ``types.H100`` builds the report.

The port counts every layer it runs, so the JAX 1-group / 2-group
extrapolation (:func:`_extrapolated_cost`) only bounds the time: it gives
the full-depth count (the tests hold it to a full-depth run).  The eager
peak is the 2-group run's: a step frees each layer's temporaries.

Records keep the JAX keys and go to ``results/dryrun_torch/<tag>.json``
(never JAX's ``results/dryrun/``): ``memory_analysis.temp_size_in_bytes``
is the port's eager peak (``source`` says so), ``lower_s`` the abstract
set-up and ``compile_s`` the counted runs; the collective bytes are the
port's own collectives (the MoE token exchange of ``models/moe.py``, not
XLA's choice).  ``--impl`` takes the routes that launch no kernel
(``chunked``, ``reference``, ``cp``): a ``meta`` tensor launches nothing.
A train job's ``argument_size_in_bytes`` is the parameters, the AdamW
state and the inputs per chip, the arguments JAX's donated step takes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch import flags
from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch.configs import (ASSIGNED_ARCHS, ASSIGNED_SHAPES, get_config,
                                 get_shape)
from repro_torch.launch.mesh import dry_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, warm_specs
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import tree_map
from repro_torch.types import H100

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: the attention routes a dry run takes: none launches a kernel
IMPLS = ("chunked", "reference", "cp")

def per_chip_bytes(shapes, logical, mesh, rules) -> float:
    """Bytes resident on one chip of the tree ``shapes`` under its
    ``logical`` names and ``rules``."""
    return shd.per_chip_bytes(shapes, logical, mesh, rules)


def abstract_init(bundle) -> Tuple[Dict, Dict]:
    """(``meta`` parameters, logical names) without allocating."""
    with L.abstract_params():
        shapes = bundle.init(device="cpu")
    return shapes, shd.param_logical(bundle)


def abstract_caches(bundle, batch: int, max_len: int,
                    quant: bool = False) -> Tuple[Dict, Dict]:
    """(``meta`` caches, logical names) of ``cache_init``."""
    caches = bundle.cache_init(batch, max_len, device="meta", quant=quant)
    return caches, bundle.cache_logical(quant)


def local_blocks(shapes, logical, mesh, rules):
    """``meta`` tensors of rank 0's blocks of the tree ``shapes``."""
    if isinstance(shapes, dict):
        return {k: local_blocks(shapes[k], logical[k], mesh, rules)
                for k in shapes}
    spec = shd.logical_to_spec(logical, shapes.shape, mesh, rules)
    return torch.empty(shd.local_shape(shapes.shape, spec, mesh),
                       dtype=shapes.dtype, device="meta")


def abstract_opt_state(pshapes, plog):
    """(``meta`` AdamW state, logical names): ``mu`` / ``nu`` f32 under
    the parameters' names, ``step`` replicated (JAX's ``opt_specs``)."""
    return adamw_init(pshapes), {"mu": plog, "nu": plog, "step": ()}


def _input_shardings(bundle, shape, mesh, rules):
    """(rank 0's blocks of the inputs, the global input specs)."""
    specs = bundle.input_specs(shape)
    logical = bundle.input_logical(shape)
    full = {k: logical.get(k, (None,) * len(v.shape))
            for k, v in specs.items()}
    return local_blocks(specs, full, mesh, rules), specs


def _step_cost(cfg, shape, mesh, rules, attention_impl: str,
               kv_quant: bool = False) -> Dict:
    """Rank 0's step of ``cfg`` x ``shape`` on ``meta`` blocks under
    ``rules``, counted (``roofline.cost_analysis`` with the eager peak).
    A train step runs in grad mode, its backward counted too."""
    bundle = build_model(cfg)
    pshapes, plog = abstract_init(bundle)
    params = local_blocks(pshapes, plog, mesh, rules)
    batch, _ = _input_shardings(bundle, shape, mesh, rules)
    warm_specs(cfg)
    if shape.kind == "train":
        params = tree_map(lambda t: t.requires_grad_(True), params)
        ostate, olog = abstract_opt_state(pshapes, plog)
        opt = local_blocks(ostate, olog, mesh, rules)
        train_step = make_train_step(bundle, AdamWConfig(),
                                     impl=attention_impl)

        def step():
            return train_step(params, opt, batch)
        with shd.mesh_rules(mesh, rules):
            return RL.cost_analysis(step, fake=False, peak=True)
    if shape.kind == "prefill":
        def step():
            return bundle.prefill(params, batch, impl=attention_impl)
    else:   # decode: ONE token against a seq_len cache
        cshapes, clog = abstract_caches(bundle, shape.global_batch,
                                        shape.seq_len, quant=kv_quant)
        caches = local_blocks(cshapes, clog, mesh, rules)

        def step():
            return bundle.decode_step(params, caches, batch,
                                      impl="reference")
    with shd.mesh_rules(mesh, rules), torch.inference_mode():
        return RL.cost_analysis(step, fake=False, peak=True)


def _extrapolated_cost(cfg, shape, mesh, rules, attention_impl: str,
                       n_groups: int, kv_quant: bool = False) -> Dict:
    """Per-chip flops / bytes / collective bytes of the full depth from
    the 1-group and 2-group variants: total = c1 + (n_groups-1)*(c2-c1)
    (each layer group costs the same).  Also the collectives' counts by
    kind, and the 2-group run's eager peak and aten ops."""
    vals = {k: _step_cost(_with_layers(cfg, k), shape, mesh, rules,
                          attention_impl, kv_quant) for k in (1, 2)}

    def ext(a, b):
        return a + (n_groups - 1) * max(b - a, 0.0)
    out = {key: ext(vals[1][key], vals[2][key])
           for key in ("flops", "bytes accessed")}
    c1, c2 = vals[1]["collectives"], vals[2]["collectives"]
    detail = {k: ext(c1[k], c2[k]) for k in c1 if k != "counts"}
    out["collective_bytes"] = detail["total"]
    out["collective_detail"] = detail
    out["collective_counts"] = {k: int(ext(c1["counts"][k],
                                           c2["counts"][k]))
                                for k in c1["counts"]}
    out["peak_bytes"] = vals[2]["peak_bytes"]
    out["ops_2group"] = vals[2]["ops"]
    return out


def _with_layers(cfg, k_groups: int):
    """cfg with k layer-pattern groups (enc-dec: k enc + k dec layers)."""
    period = len(cfg.layer_pattern)
    rep = {"n_layers": k_groups * period}
    if cfg.enc_dec:
        rep["n_enc_layers"] = k_groups * period
    if cfg.climber is not None:
        rep["n_layers"] = k_groups
        rep["climber"] = dataclasses.replace(cfg.climber,
                                             layers_per_block=k_groups)
    return dataclasses.replace(cfg, **rep)


def should_skip(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def _check_impl(attention_impl: str) -> None:
    if attention_impl not in IMPLS:
        raise ValueError(
            f"--impl {attention_impl!r}: the dry run runs on meta tensors, "
            f"which launch no kernel; take one of {IMPLS}")


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               save: bool = True, verbose: bool = True,
               fsdp: bool = True, extra_tag: str = "",
               attention_impl: str = "chunked",
               rules_override: Optional[Dict] = None,
               moe_dispatch: str = "gspmd", kv_quant: bool = False) -> Dict:
    _check_impl(attention_impl)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{mesh_name}_{arch}_{shape_name}{extra_tag}"
    skip = should_skip(cfg, shape)
    if skip:
        rec = {"tag": tag, "arch": arch, "shape": shape_name,
               "mesh": mesh_name, "status": "skipped", "reason": skip}
        if save:
            _save(tag, rec)
        if verbose:
            print(f"[dryrun] SKIP {tag}: {skip}")
        return rec

    t0 = time.perf_counter()
    with dry_mesh(multi_pod=multi_pod) as mesh, \
            flags.moe_dispatch(moe_dispatch):
        chips = mesh.size
        rules = shd.rules_for_shape(mesh, shape.global_batch, fsdp=fsdp)
        if rules_override:
            names = set(mesh.axis_names)
            rules.update({k: tuple(a for a in v if a in names)
                          for k, v in rules_override.items()})
        # actual per-chip weight / cache residency for the memory estimate
        bundle = build_model(cfg)
        pshapes, plog = abstract_init(bundle)
        params_bytes_chip = per_chip_bytes(pshapes, plog, mesh, rules)
        cache_bytes_chip = None
        opt_bytes_chip = None
        if shape.kind == "train":
            opt_bytes_chip = per_chip_bytes(
                *abstract_opt_state(pshapes, plog), mesh, rules)
        if shape.kind == "decode":
            cshapes, clog = abstract_caches(bundle, shape.global_batch,
                                            shape.seq_len, quant=kv_quant)
            cache_bytes_chip = per_chip_bytes(cshapes, clog, mesh, rules)
        specs = bundle.input_specs(shape)
        input_bytes_chip = per_chip_bytes(
            specs, {k: bundle.input_logical(shape).get(
                k, (None,) * len(v.shape)) for k, v in specs.items()},
            mesh, rules)
        t_lower = time.perf_counter() - t0
        n_groups = cfg.n_groups if cfg.climber is None else \
            cfg.climber.layers_per_block
        ext = _extrapolated_cost(cfg, shape, mesh, rules, attention_impl,
                                 n_groups, kv_quant)
        t_compile = time.perf_counter() - t0 - t_lower

    mem_d = {"argument_size_in_bytes": params_bytes_chip
             + (cache_bytes_chip or 0.0) + (opt_bytes_chip or 0.0)
             + input_bytes_chip,
             "temp_size_in_bytes": ext["peak_bytes"],
             "source": "eager peak of the port (roofline.LiveBytes over "
                       "rank 0's 2-group run on meta tensors), not XLA's "
                       "buffer assignment"}
    report = RL.analyse(arch, shape_name, mesh_name, chips,
                        {"flops": ext["flops"],
                         "bytes accessed": ext["bytes accessed"]},
                        ext["collective_detail"], cfg, shape, hw=H100,
                        per_device_peak_memory=ext["peak_bytes"],
                        params_bytes_chip=params_bytes_chip,
                        cache_bytes_chip=cache_bytes_chip)
    rec = {
        "tag": tag, "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory_analysis": mem_d,
        "cost_analysis": {"flops": ext["flops"],
                          "bytes accessed": ext["bytes accessed"]},
        "roofline": report.to_dict(),
        "hlo_bytes_len": None,
        "params_bytes_chip": params_bytes_chip,
        "cache_bytes_chip": cache_bytes_chip,
        "opt_bytes_chip": opt_bytes_chip,
        "collective_counts": ext["collective_counts"],
        "aten_ops_2group": ext["ops_2group"],
        "impl": attention_impl, "moe_dispatch": moe_dispatch, "fsdp": fsdp,
        "hardware": "types.H100 (constants, no card)",
    }
    if save:
        _save(tag, rec)
    if verbose:
        gb = 1e9
        coll = " ".join(f"{k}={v / gb:.3f}GB"
                        for k, v in ext["collective_detail"].items()
                        if k != "total" and v)
        print(f"[dryrun] OK {tag}: chips={chips} "
              f"params={params_bytes_chip / gb:.3f}GB/chip "
              + (f"cache={cache_bytes_chip / gb:.3f}GB/chip "
                 if cache_bytes_chip is not None else "")
              + (f"adamw={opt_bytes_chip / gb:.3f}GB/chip "
                 if opt_bytes_chip is not None else "")
              + f"peak={ext['peak_bytes'] / gb:.3f}GB "
              f"flops={report.hlo_flops:.3e} "
              f"collectives[{coll or 'none'}] "
              f"compute={report.compute_s * 1e3:.2f}ms "
              f"memory_est={report.memory_s_est * 1e3:.2f}ms "
              f"collective={report.collective_s * 1e3:.2f}ms "
              f"dominant={report.dominant} "
              f"run={t_lower + t_compile:.1f}s")
    return rec


def _save(tag: str, rec: Dict):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--missing", action="store_true",
                    help="skip combinations that already have a result file")
    ap.add_argument("--moe-dispatch", default="gspmd",
                    choices=["gspmd", "a2a"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--rules", default="",
                    help='logical-rule overrides, e.g. "experts=data;seq=model"')
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode shapes)")
    ap.add_argument("--profile", default=None, choices=[None, "serving"],
                    help="apply the §Perf-optimized sharding profile")
    args = ap.parse_args(argv)
    _check_impl(args.impl)
    overrides = None
    if args.rules:
        overrides = {}
        for kv in args.rules.split(";"):
            k, v = kv.split("=")
            overrides[k.strip()] = tuple(a for a in v.split(",") if a)
    if args.profile == "serving":
        # TP-resident weights, sequence-sharded KV cache
        args.no_fsdp = True
        overrides = dict(overrides or {})
        overrides.setdefault("cache_seq", ("model",))

    jobs = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        shapes = [s.name for s in ASSIGNED_SHAPES]
        for a in ASSIGNED_ARCHS:
            for s in shapes:
                for mp in meshes:
                    jobs.append((a, s, mp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        for mp in meshes:
            jobs.append((args.arch, args.shape, mp))

    if args.missing:
        def _exists(a, s, mp):
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            return os.path.exists(os.path.join(
                RESULTS_DIR, f"{mesh_name}_{a}_{s}{args.tag}.json"))
        jobs = [j for j in jobs if not _exists(*j)]
        print(f"[dryrun] {len(jobs)} missing jobs to run")

    failures = []
    for a, s, mp in jobs:
        try:
            dryrun_one(a, s, multi_pod=mp, fsdp=not args.no_fsdp,
                       attention_impl=args.impl,
                       moe_dispatch=args.moe_dispatch, extra_tag=args.tag,
                       rules_override=overrides, kv_quant=args.kv_quant)
        except Exception as e:  # noqa: BLE001 — counted, exit code 1
            failures.append((a, s, mp, repr(e)))
            print(f"[dryrun] FAIL {a} {s} multi_pod={mp}: {e}")
            traceback.print_exc()
    print(f"[dryrun] done: {len(jobs) - len(failures)}/{len(jobs)} ok")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
