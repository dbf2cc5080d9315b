#!/usr/bin/env python3
"""Print the markdown table of the port's dry-run records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    python3 scripts/dryrun_table.py [--mesh pod16x16] [--tag T] [--compact]
        [DIR]

Reads ``results/dryrun_torch/*.json`` (or DIR) and prints one row per
(arch, shape) of the mesh (``--compact``: one an arch, a column a shape): the per-chip GB of weights and of caches, the
eager peak, the three roofline terms in ms (``types.H100`` constants: no
time here is measured on a card), the bound's term, the collective bytes
per chip by kind, and the seconds the CPU took for the job (``lower_s`` +
``compile_s``).  A skipped job prints its reason.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?",
                    default=os.path.join(ROOT, "results", "dryrun_torch"))
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="",
                    help="the records of this --tag of the dry run")
    ap.add_argument("--compact", action="store_true",
                    help="one row an arch: weights + caches, peak, bound "
                         "and CPU s of each shape")
    args = ap.parse_args(argv)
    recs = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") == args.mesh and rec["tag"] == (
                f"{args.mesh}_{rec['arch']}_{rec['shape']}{args.tag}"):
            recs.append(rec)
    gb = 1e9
    if args.compact:
        return compact(recs)
    else:
        print(f"| arch | shape | weights GB/chip | caches GB/chip | eager "
              f"peak GB | compute ms | memory ms | collective ms | bound "
              f"(term) | collective GB/chip by kind | CPU s |")
        print("|---|---|---|---|---|---|---|---|---|---|---|")
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if rec["status"] != "ok":
            if not args.compact:
                print(f"| {rec['arch']} | {rec['shape']} | skipped: "
                      f"{rec['reason']} |||||||||")
            continue
        rl = rec["roofline"]
        terms = {"compute": rl["compute_s"],
                 "memory": rl["memory_s_est"] or rl["memory_s"],
                 "collective": rl["collective_s"]}
        dom = rl["dominant"]
        coll = ", ".join(f"{k} {v / gb:.3f}"
                         for k, v in rl["collective_detail"].items()
                         if k != "total" and v)
        cache = rec.get("cache_bytes_chip")
        cpu_s = rec["lower_s"] + rec["compile_s"]
        peak = rec["memory_analysis"]["temp_size_in_bytes"] / gb
        print(f"| {rec['arch']} | {rec['shape']} | "
              f"{rec['params_bytes_chip'] / gb:.3f} | "
              f"{'-' if cache is None else f'{cache / gb:.3f}'} | "
              f"{peak:.3f} | "
              f"{terms['compute'] * 1e3:.2f} | {terms['memory'] * 1e3:.2f} "
              f"| {terms['collective'] * 1e3:.2f} | "
              f"{terms[dom] * 1e3:.2f} ({dom}) | {coll or '-'} | "
              f"{cpu_s:.1f} |")
    return 0


def compact(recs) -> int:
    """One row an arch, one column a shape: weights (+ caches, or + the
    AdamW state) GB a chip, the eager peak GB, the bound in ms with its
    term, and the CPU s."""
    gb = 1e9
    shapes = sorted({r["shape"] for r in recs},
                    key=lambda n: ("prefill" not in n, "long" in n, n))
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    by = {(r["arch"], r["shape"]): r for r in recs}
    for arch in sorted({r["arch"] for r in recs}):
        cells = []
        for shape in shapes:
            rec = by.get((arch, shape))
            if rec is None or rec["status"] != "ok":
                cells.append("skipped" if rec else "-")
                continue
            rl = rec["roofline"]
            terms = {"compute": rl["compute_s"],
                     "memory": rl["memory_s_est"] or rl["memory_s"],
                     "collective": rl["collective_s"]}
            dom = rl["dominant"]
            extra = rec.get("cache_bytes_chip")
            if extra is None:
                extra = rec.get("opt_bytes_chip")
            held = f"{rec['params_bytes_chip'] / gb:.3f}" + (
                "" if extra is None else f" + {extra / gb:.3f}")
            peak = rec["memory_analysis"]["temp_size_in_bytes"] / gb
            cells.append(f"{held} GB, peak {peak:.3f}; "
                         f"{terms[dom] * 1e3:.2f} ms {dom}; "
                         f"{rec['lower_s'] + rec['compile_s']:.1f} s")
        print(f"| {arch} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
