#!/usr/bin/env python3
"""Times the any-dims variants of K2 (``csrc/attention_any.cu``), K3
(``csrc/ffn_any.cu``), K4 (``csrc/decode_any.cu``) and K5
(``csrc/rwkv6_scan_any.cu``) built with other values of their tuning
constants, on one NVIDIA GPU.

    python3 scripts/any_variants.py [VARIANT ...]   # from a checkout's root

A VARIANT is ``base`` (the sources as they are) or settings joined by
``+``, each ``NAME=VALUE``: NAME a ``constexpr int`` of the sources
(e.g. ``kStages=4+kStep=128``; K2's ``kWarps`` rows a block / 16,
``kKeys``, ``kSlots``, ``kRowBytes``, ``kPass`` the head-dim pass width;
K5's ``kMinCols``, ``kFillSMs`` (its column split), ``kGroupO``,
``kGroupS``), an upper-case constant of
``kernels/fused_ffn/ops.py`` (e.g. ``ANY_COLS``, ``ANY_SMALL_T``: the
wrapper's slices and rows a CTA), or ``cut`` (``cut=noload``,
``cut=nomma`` or both, ``cut=noload,nomma``: K3 built with
``-DFFN_ANY_CUT_LOAD`` / ``-DFFN_ANY_CUT_MMA``, without its stages' copies
and / or its products, results wrong, not checked; ``cut=k2noload``,
``cut=k2nomma``: K2 likewise, with ``-DATTN_ANY_CUT_LOAD`` /
``-DATTN_ANY_CUT_MMA``; ``cut=k5clock``: K5 with ``-DWKV_ANY_CLOCK``,
block (0, 0)'s thread 0 prints the cycles of each phase after each call;
``cut=k1clock``: K1's any-dims variant (``csrc/score_any.cu``) with
``-DSCORE_ANY_CLOCK``, the first and last CTAs' thread 0 print the cycles
of each phase after each call; ``cut=clock``: with
``-DFFN_ANY_CLOCK``, block (0, 0)'s first consumer prints its cycles, and
those spent waiting for a stage's copies, after each call).  The default
is ``base`` alone.  Each variant's sources are copied under
``build/any_variants/`` with its constants replaced (the served sources
stay as they are; a NAME not defined exactly once across the four
sources fails the run; ``score_any.cu`` is built for every variant too,
its constants as they are, with its macros)
and built with its macros, one ``nvcc`` for each distinct build, all
started together.  Then every variant
runs the ``f2_phase`` shapes of ``chip_smoke.py``: K2 at [4, 500, 8, D]
with 2 KV heads, D 320 and 512 in bf16 and 256 in f32, ``causal`` and
``sliding`` (window 128); K5 at [4, 500, 32, 128] in bf16; K3 in f32 at d 1024,
d_ff 4096, T 4 and 512 (gelu) and in bf16 at 1020 x 4100, T 64 (swiglu);
K4's single-token form at [4, 8, 512] and [4, 16, 256] over 528 keys and
[1, 16, 256] over 4096, its self-slot form at [4, 128, 4, 256] over 264
(K1's any-dims variant, ``csrc/score_any.cu``, runs it).
Each call is held to its plain twin first (``chip_smoke.close``; K5's to
``rwkv6_scan_subchunk`` within ``K5_BF16_TOL`` of the scale), then timed
on the device (calls replayed from a CUDA graph, warm L2), in turns over
the variants, twice.  ``--profile`` also prints, for the first variant,
each case's device time by kernel (``torch.profiler``: K4's and K3's two
kernels apart, K5's scan apart from the wrapper's w_log and state
copies).  Exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("attention_any", "ffn_any", "decode_any", "rwkv6_scan_any")
# built for every variant: SOURCES with its constants, score_any as it is
BUILT = SOURCES + ("score_any",)
# cut=NAME: the source and the macro it is built with
CUTS = {"noload": ("ffn_any", "FFN_ANY_CUT_LOAD"),
        "nomma": ("ffn_any", "FFN_ANY_CUT_MMA"),
        "clock": ("ffn_any", "FFN_ANY_CLOCK"),
        "k2noload": ("attention_any", "ATTN_ANY_CUT_LOAD"),
        "k2nomma": ("attention_any", "ATTN_ANY_CUT_MMA"),
        "k5clock": ("rwkv6_scan_any", "WKV_ANY_CLOCK"),
        "k1clock": ("score_any", "SCORE_ANY_CLOCK")}


def settings(variant: str) -> dict:
    if variant == "base":
        return {}
    out = {}
    for part in variant.split("+"):
        name, _, value = part.partition("=")
        out[name] = value if name == "cut" else int(value)
    return out


def macros(name: str, cfg: dict) -> list:
    """The ``-D`` flags of ``name``'s build under ``cfg``."""
    if "cut" not in cfg:
        return []
    return [f"-D{CUTS[c][1]}" for c in cfg["cut"].split(",")
            if CUTS[c][0] == name]


def edited(src: str, cfg: dict) -> str:
    for key, value in cfg.items():
        if key == "cut" or key.isupper():
            continue
        src = re.sub(rf"constexpr int {key} = -?\d+;",
                     f"constexpr int {key} = {value};", src)
    return src


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("any_variants.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.rwkv6_scan import ops as scan

    profile = "--profile" in argv
    variants = [a for a in argv if a != "--profile"] or ["base"]
    out_dir = os.path.join(ROOT, "build", "any_variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(_build.CSRC)
    procs, libs, built = [], {}, {}
    for vi, variant in enumerate(variants):
        cfg = settings(variant)
        for key in cfg:
            if key == "cut" or key.isupper():
                continue
            hits = sum(len(re.findall(
                rf"constexpr int {key} = -?\d+;",
                open(os.path.join(csrc, f"{n}.cu")).read())) for n in SOURCES)
            if hits != 1:   # a name shared by two sources would change both
                raise SystemExit(f"constant {key} is defined {hits} times "
                                 f"in {SOURCES}, want once")
        if any(c not in CUTS for c in cfg.get("cut", "").split(",") if c):
            raise SystemExit(f"cuts are {sorted(CUTS)}, got {cfg['cut']}")
        for name in BUILT:
            src = open(os.path.join(csrc, f"{name}.cu")).read()
            if name in SOURCES:
                src = edited(src, cfg)
            flags = macros(name, cfg)
            key = (src, tuple(flags))
            if key in built:        # a variant that leaves this build be
                libs[(vi, name)] = built[key]
                continue
            path = os.path.join(out_dir, f"v{vi}_{name}.cu")
            with open(path, "w") as f:
                f.write(src)
            so = path[:-3] + ".so"
            libs[(vi, name)] = built[key] = so
            procs.append((variant, name, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", csrc,
                 "-o", so, path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for variant, name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise SystemExit(f"nvcc failed for {variant} {name}")
        for ln in _build._ptxas_summary(log):
            print(f"[any_variants] {variant} {name}: {ln}")
    print(f"[any_variants] card: {cs.card_line()}")

    real = _build.function
    current = {"vi": 0}
    loaded = {}

    def function(lib, symbol, argtypes):
        if lib not in BUILT:
            return real(lib, symbol, argtypes)
        key = (current["vi"], lib, symbol)
        if key not in loaded:
            fn = getattr(ctypes.CDLL(libs[(current["vi"], lib)]), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            loaded[key] = fn
        return loaded[key]
    _build.function = function

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(26)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=device)
                ).to(dtype)

    cases = []
    b, s, h, hkv = 4, 500, 8, 2
    for dtype, d in ((torch.bfloat16, 320), (torch.bfloat16, 512),
                     (torch.float32, 256)):
        q, k, v = (rn(b, s, h, d, dtype=dtype), rn(b, s, hkv, d, dtype=dtype),
                   rn(b, s, hkv, d, dtype=dtype))
        for mode, window in (("causal", 0), ("sliding", 128)):
            cases.append((f"K2 {str(dtype)[6:]} D {d} {mode}",
                          lambda q=q, k=k, v=v, mode=mode, window=window:
                          fa.flash_attention(q, k, v, mode, window=window),
                          lambda q=q, k=k, v=v, mode=mode, window=window:
                          fa.flash_attention_any_plain(q, k, v, mode,
                                                       window=window),
                          cs.close))
    b, s, h, d = 4, 500, 32, 128
    r, k, v = (rn(b, s, h, d, scale=0.5) for _ in range(3))
    wl = -torch.exp(torch.randn(b, s, h, d, generator=g, device=device))
    u = rn(h, d, scale=0.5, dtype=torch.float32)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=device)
    cases.append((f"K5 [{b}, {s}, {h}, {d}] bf16",
                  lambda: scan.rwkv6_scan(r, k, v, wl, u, s0)[0],
                  lambda: scan.rwkv6_scan_subchunk(r, k, v, wl, u, s0,
                                                   steps=True)[0],
                  lambda got, want, what: cs.close_scaled(
                      got, want, cs.K5_BF16_TOL, what)))
    for dtype, d, f, act, t in ((torch.float32, 1024, 4096, "gelu", 4),
                                (torch.float32, 1024, 4096, "gelu", 512),
                                (torch.bfloat16, 1020, 4100, "swiglu", 64)):
        wu, wd = rn(d, f, scale=d ** -0.5, dtype=dtype), \
            rn(f, d, scale=f ** -0.5, dtype=dtype)
        wg = rn(d, f, scale=d ** -0.5, dtype=dtype) \
            if act == "swiglu" else None
        x = rn(t, d, dtype=dtype)
        cases.append((f"K3 {str(dtype)[6:]} {act} {d} x {f} T {t}",
                      lambda x=x, wu=wu, wd=wd, wg=wg, act=act:
                      ff.fused_ffn_2d(x, wu, wd, wg, activation=act),
                      lambda x=x, wu=wu, wd=wd, wg=wg, act=act:
                      ff.fused_ffn_any_plain(x, wu, wd, wg,
                                             activation=act), cs.close))
    for b, s, lens, h, hkv, d in ((4, 528, [528, 517, 300, 130], 8, 2, 512),
                                  (4, 528, [528, 517, 300, 130], 16, 2, 256),
                                  (1, 4096, [4096], 16, 2, 256)):
        lens = torch.tensor(lens, dtype=torch.int32, device=device)
        q, kc, vc = rn(b, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
        cases.append((f"K4 single-token [{b}, {h}, {d}] over {s}",
                      lambda q=q, kc=kc, vc=vc, lens=lens:
                      fd.flash_decode(q, kc, vc, lens),
                      lambda q=q, kc=kc, vc=vc, lens=lens:
                      fd.flash_decode_any_plain(q, kc, vc, lens), cs.close))
    b, m, h, hkv, d, s = 4, 128, 4, 4, 256, 264
    q, ks, vs = rn(b, m, h, d), rn(b, m, hkv, d), rn(b, m, hkv, d)
    kc, vc = rn(b, s, hkv, d), rn(b, s, hkv, d)
    lens = torch.tensor([257, 260, 263, 258], dtype=torch.int32,
                        device=device)
    cases.append((f"K4 self-slot [{b}, {m}, {h}, {d}] over {s}",
                  lambda: fd.flash_decode_with_self(q, kc, vc, lens, ks, vs),
                  lambda: fd.flash_decode_with_self_any_plain(
                      q, kc, vc, lens, ks, vs), cs.close))

    knobs0 = {k: getattr(ff, k) for v in variants for k in settings(v)
              if k.isupper()}

    def set_knobs(variant):
        for k, v0 in knobs0.items():
            setattr(ff, k, settings(variant).get(k, v0))
    times, failed = {}, {}
    for rnd in range(2):
        for vi, variant in enumerate(variants):
            current["vi"] = vi
            set_knobs(variant)
            for label, kernel, plain, check in cases:
                if (variant, label) in failed:
                    continue
                try:     # a variant past a limit (shared memory) fails alone
                    with cs.uncounted():
                        if rnd == 0 and settings(variant).get(
                                "cut", "clock") in ("clock", "k1clock"):
                            check(kernel(), plain(), f"{variant}: {label}")
                        ms = cs.device_ms(kernel, per_graph=5, reps=10)
                except RuntimeError as e:
                    failed[(variant, label)] = str(e).splitlines()[0]
                    print(f"[any_variants] {variant} {label} failed: "
                          f"{failed[(variant, label)]}", flush=True)
                    continue
                times.setdefault((variant, label), []).append(ms)
    set_knobs("base")
    if profile:
        from k3_wide_sweep import profile_line
        current["vi"] = 0
        set_knobs(variants[0])
        for label, kernel, _, _ in cases:
            if (variants[0], label) in failed:
                continue
            with cs.uncounted():
                print(f"[any_variants] {variants[0]} {label}: "
                      f"{profile_line(kernel)}")
        set_knobs("base")
    for (variant, label), why in failed.items():
        print(f"[any_variants] {variant:40s} {label:40s} failed: {why}")
    for (variant, label), ms in times.items():
        print(f"[any_variants] {variant:40s} {label:40s} "
              + " ".join(f"{t:.4f}" for t in ms) + f" ms; {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
