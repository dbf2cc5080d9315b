"""flamecheck CLI for the port — ``python -m repro_torch.analysis``.

Usage::

    python -m repro_torch.analysis                # default target set
    python -m repro_torch.analysis --strict       # CI gate (pragma hygiene)
    python -m repro_torch.analysis path.py --json # machine-readable
    python -m repro_torch.analysis --passes lock-discipline,host-sync

Exit codes: 0 clean, 1 findings, 2 usage/parse error.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Sequence

from repro_torch.analysis import future_leak, host_sync, lock_discipline
from repro_torch.analysis.common import Finding, ModuleSource

PASSES = {
    "lock-discipline": lock_discipline.run,
    "host-sync": host_sync.run,
    "future-leak": future_leak.run,
}

#: the port's modules flamecheck gates by default
DEFAULT_TARGETS = (
    "src/repro_torch/serving/api.py",
    "src/repro_torch/serving/engine.py",
    "src/repro_torch/serving/faults.py",
    "src/repro_torch/serving/kv_cache.py",
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/serving/generate.py",
    "src/repro_torch/core/dso.py",
    "src/repro_torch/core/pda.py",
    "src/repro_torch/kernels/*/ops.py",
)


def _repo_root() -> str:
    # src/repro_torch/analysis/cli.py -> the repo root is above src/
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def default_paths() -> List[str]:
    root = _repo_root()
    out: List[str] = []
    for pat in DEFAULT_TARGETS:
        out.extend(sorted(glob.glob(os.path.join(root, pat))))
    return out


def load_sources(paths: Sequence[str]) -> List[ModuleSource]:
    return [ModuleSource.load(p) for p in paths]


def run_passes(sources: Sequence[ModuleSource],
               passes: Sequence[str] = tuple(PASSES),
               strict: bool = False) -> List[Finding]:
    """Run the requested passes, apply pragma suppression, and (in strict
    mode) append pragma-hygiene findings.  Returns *all* findings; callers
    filter on ``.suppressed``."""
    by_path: Dict[str, ModuleSource] = {s.path: s for s in sources}
    findings: List[Finding] = []
    for name in passes:
        findings.extend(PASSES[name](sources))
    for f in findings:
        src = by_path.get(f.path)
        if src is not None:
            src.suppress(f)
    if strict:
        for src in sources:
            findings.extend(src.pragma_findings())
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="flamecheck: repo-specific static analysis for the "
                    "PyTorch port of the FLAME serving stack")
    ap.add_argument("paths", nargs="*",
                    help="files to analyze (default: the serving/core/"
                         "kernel modules)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on unused pragmas and empty reasons")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help="comma-separated subset of: " + ", ".join(PASSES))
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma-suppressed findings")
    args = ap.parse_args(argv)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        print(f"flamecheck: unknown pass(es): {', '.join(unknown)}",
              file=sys.stderr)
        return 2

    paths = list(args.paths) or default_paths()
    try:
        sources = load_sources(paths)
    except (OSError, SyntaxError) as e:
        print(f"flamecheck: {e}", file=sys.stderr)
        return 2

    findings = run_passes(sources, passes, strict=args.strict)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.as_json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        shown = findings if args.show_suppressed else active
        for f in shown:
            tag = " (suppressed)" if f.suppressed else ""
            print(f.format() + tag)
        print(f"flamecheck: {len(active)} finding(s), "
              f"{len(suppressed)} suppressed, "
              f"{len(sources)} file(s), passes: {', '.join(passes)}")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
