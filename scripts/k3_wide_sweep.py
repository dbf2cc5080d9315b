#!/usr/bin/env python3
"""K3's wide form over T on one NVIDIA GPU: both paths and the matmul chain.

    python3 scripts/k3_wide_sweep.py            # from the root of a checkout
    python3 scripts/k3_wide_sweep.py --profile  # also each kernel's share

Builds ``fused_ffn`` alone, then at d 3840 (gelu d_ff 15360 as gemma3-12b,
swiglu d_ff 10240 as h2o-danube-3-4b) times one call of the wide form on
its decode path (T up to 128) and on its prefill path (T from 16) beside
the matmul chain in bf16 (device time: 20 calls replayed from one CUDA
graph, median of 20 replays, warm L2), each path checked against the plain
version first.  The crossing of the two paths is what ``WIDE_DECODE_T``
follows.  With ``--profile`` it also prints each kernel's device time per
call at T 2000 and T 4 from ``torch.profiler``.  Prints the card's name and
power limit first; exits non-zero without CUDA.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = (1, 4, 8, 16, 24, 32, 40, 48, 64, 96, 128, 300, 600, 1100, 2000)


def main(argv) -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k3_wide_sweep.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ffn import ops as ff
    card = cs.card_line()
    print(f"[k3_wide_sweep] card: {card}", flush=True)
    print(f"[k3_wide_sweep] built fused_ffn in "
          f"{_build.build(['fused_ffn']):.1f}s", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(22)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)
                ).to(torch.bfloat16)

    threshold = ff.WIDE_DECODE_T
    d = 3840
    try:
        for act, f in (("gelu", 15360), ("swiglu", 10240)):
            wu, wd = rn(d, f, scale=d ** -0.5), rn(f, d, scale=f ** -0.5)
            wg = rn(d, f, scale=d ** -0.5) if act == "swiglu" else None

            def call(x):
                return ff.fused_ffn_2d(x, wu, wd, wg, activation=act)

            def chain(x):
                if act == "swiglu":
                    return (F.silu(x @ wg) * (x @ wu)) @ wd
                return F.gelu(x @ wu, approximate="tanh") @ wd
            for t in TS:
                x = rn(t, d)
                cols = []
                for path, limit in (("decode", 10 ** 9), ("prefill", 0)):
                    if (path == "decode" and t > 128) or \
                            (path == "prefill" and t < 16):
                        continue
                    ff.WIDE_DECODE_T = limit
                    cs.close(call(x), ff.fused_ffn_plain(
                        x, wu, wd, wg, activation=act),
                        f"K3 {act} T={t} {path} path")
                    cols.append(f"{path} {cs.device_ms(lambda: call(x)):.4f}")
                ff.WIDE_DECODE_T = threshold
                print(f"[k3_wide_sweep] {act} d_ff {f} T={t}: ms "
                      f"{', '.join(cols)}, chain "
                      f"{cs.device_ms(lambda: chain(x)):.4f}; {card}",
                      flush=True)
            if "--profile" in argv:
                for t in (2000, 4):
                    x = rn(t, d)
                    print(f"[k3_wide_sweep] {act} d_ff {f} T={t} "
                          f"({ff.wide_plan(t, f).path} path), per call: "
                          f"{profile_line(lambda: call(x))}; {card}",
                          flush=True)
            del wu, wd, wg
            torch.cuda.empty_cache()
    finally:
        ff.WIDE_DECODE_T = threshold
    return 0


def profile_line(fn, calls: int = 5) -> str:
    """Each CUDA kernel's device time per call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and str(getattr(e, "device_type", "")).endswith("CUDA"):
            name = e.key.split("(")[0].split("<")[0].replace(
                "void ", "").replace("flame::ffn::wide::", "")
            rows.append((us / calls / 1e3, name))
    rows.sort(reverse=True)
    return ", ".join(f"{name} {ms:.4f} ms" for ms, name in rows) or \
        "no device time in the trace"


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
