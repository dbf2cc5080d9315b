#!/usr/bin/env python3
"""Times kernel K5 (rwkv6_scan) with parts of it removed, to show where its
time goes on one NVIDIA GPU.

    python3 scripts/k5_parts.py [VARIANT ...]   # from the root of a checkout

A VARIANT is ``none`` (the kernel as it is) or cuts joined by ``+`` (e.g.
``diag+offdiag``); the default is every cut alone, then ``all``.  Each cut
edits a copy of ``src/repro_torch/csrc/rwkv6_scan.cu`` under
``build/k5_parts/`` (the served source stays as it is): ``la`` P1 (la and
the per-channel scalars), ``diag`` P2 (the pairwise diagonal blocks),
``factors`` P3 (Q and K), ``offdiag`` P4 (the off-diagonal scores), ``o``
P5's output (its products and stores), ``rdecS`` P5's r_dec S alone,
``state`` P5's k_dec^T v, ``loads`` every ``cp.async`` copy, ``all`` the
first seven and the loads, ``nosplit`` no column split at small batch (the
only cut whose result stays right).  Builds one library per variant (one
``nvcc`` each, all started together) and prints each one's device time
(calls replayed from a CUDA graph) at the text engine's prefill shapes
[4, 500, 64, 64] and [1, 300, 64, 64] (bf16).  A removed part makes the
results wrong; only the times mean something.  A cut whose text is no
longer in the source fails the run.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4, 500, 64, 64), (1, 300, 64, 64))
# cut -> [(text of the source, its replacement)]; each text must occur once,
# except where the cut replaces every occurrence (``loads``)
CUTS = {
    "la": [("    if (tid < D) {\n      const int d = tid;",
            "    if (false) {\n      const int d = tid;")],
    "diag": [("    if (tid < kDiag) {", "    if (false) {"),
             ("    } else if (tid < kDiag + kOff) {",
              "    } else if (false) {")],
    "factors": [("for (int x = tid; x < kC * D / 4;",
                 "for (int x = kC * D / 4; x < kC * D / 4;")],
    "offdiag": [("    if (warp < 6) {", "    if (false) {")],
    "o": [("    {  // o\n", "    if (false) {  // o\n")],
    "rdecS": [("      for (int k0 = 0; k0 < D; k0 += 8) {\n"
               "        FragB bb[NTO];",
               "      for (int k0 = D; k0 < D; k0 += 8) {\n"
               "        FragB bb[NTO];")],
    "state": [("    {  // k_dec^T v\n", "    if (false) {  // k_dec^T v\n")],
    "loads": [(" stage<", " if (false) stage<")],
    "nosplit": [("return D == 64 && 2LL * B * H <= sms ? 2 : 1;",
                 "return 1;")],
}
ALL = ("la", "diag", "factors", "offdiag", "o", "state", "loads")


def cut_source(src: str, variant: str) -> str:
    names = ALL if variant == "all" else \
        [] if variant == "none" else variant.split("+")
    for name in names:
        for old, new in CUTS[name]:
            n = src.count(old)
            if n == 0 or (n > 1 and name != "loads"):
                raise SystemExit(f"k5_parts: cut {name!r} matches {n} places "
                                 f"of rwkv6_scan.cu: {old!r}")
            src = src.replace(old, new)
    return src


def main(argv) -> int:
    variants = argv or ["none", *CUTS, "all"]
    bad = [v for v in variants if v not in ("none", "all") and
           any(c not in CUTS for c in v.split("+"))]
    if bad:
        print(f"k5_parts: unknown cut in {bad}; cuts: {', '.join(CUTS)}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("k5_parts.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import ops as scan
    out_dir = os.path.join(ROOT, "build", "k5_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC / "rwkv6_scan.cu").read_text()
    t0 = time.perf_counter()
    procs, libs = [], []
    for v in variants:
        cu = os.path.join(out_dir, f"{v}.cu")
        with open(cu, "w") as f:
            f.write(cut_source(src, v))
        libs.append(os.path.join(out_dir, f"{v}.so"))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", libs[-1], cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = []
    for p, lib in zip(procs, libs):
        log, _ = p.communicate()
        if p.returncode:
            print(log)
            return 1
        fn = ctypes.CDLL(lib).rwkv6_scan_fwd
        fn.argtypes = scan._ARGTYPES
        fn.restype = ctypes.c_int
        fns.append(fn)
    print(f"[k5_parts] card: {cs.card_line()}; {len(variants)} variants "
          f"built in {time.perf_counter() - t0:.1f}s")
    device = torch.device("cuda", 0)
    real = _build.function
    try:
        for b, s, h, d in SHAPES:
            g = torch.Generator(device=device).manual_seed(16)
            r, k, v = (torch.randn(b, s, h, d, generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
            wl = -torch.empty(b, s, h, d, device=device).uniform_(
                math.log(1e-4), math.log(20.0), generator=g).exp()
            u = (0.5 * torch.randn(h, d, generator=g, device=device)).to(
                torch.bfloat16)
            s0 = torch.randn(b, h, d, d, generator=g, device=device)
            for name, fn in zip(variants, fns):
                _build.function = lambda *a, _f=fn: _f
                ms = cs.device_ms(lambda: scan.rwkv6_scan(r, k, v, wl, u, s0))
                print(f"[k5_parts] [{b}, {s}, {h}, {d}] bf16 {name:>22}: "
                      f"{ms:.4f} ms device (CUDA graph)")
    finally:
        _build.function = real
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
