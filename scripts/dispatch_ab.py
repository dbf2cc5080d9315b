#!/usr/bin/env python3
"""Per-dispatch times of the generation executors of one checkout, or the
times of its kernel K5 at the text prefill shapes, for an A/B of two
checkouts on one GPU.

    python3 scripts/dispatch_ab.py --tree DIR [--label NAME] [--what k5]

Imports the checkout at DIR (its ``src/`` and its ``chip_smoke.py``),
builds its kernels into DIR/build, and for ``impl="pallas"`` and
``impl="fused"`` builds the port's FlameEngine at the published Climber
width as ``chip_smoke.py``'s generation phases do (int8 pool, generate=8,
gen_vocab=256), serves one top-k request of user 0 so that its root entry
is pooled, then times the ``decode`` (bucket 128) and ``append`` executors
at batch 4 on that root with the checkout's own
``chip_smoke.gen_dispatch_times``: one eager call alone, the engine's
captured executor alone (where the checkout has one), and a CUDA-graph
replay (the device alone).  With ``--what k5`` it builds only the
checkout's ``rwkv6_scan`` and times its wrapper at the text engine's two
prefill shapes, the batched ``generate`` ([4, 500, 64, 64]) and a
``submit`` ([1, 300, 64, 64]): bf16 r / k / v, f32 w_log with runs of
-20, a non-zero f32 state, operands from a fixed seed (the same for every
checkout); the device time (CUDA-graph replay) and one eager call.  Run it
once per checkout in turns (parent, change, change, parent) in one call,
so that both run on one card.  With ``--what text`` it times K5 as
``--what k5`` does, then runs the checkout's ``chip_smoke.text_phase``
alone (rwkv6-7b at full width through the text engine: the batched
``generate``, two ``submit`` prefills and decodes, and its checks), so
the text engine's times are read without the Climber phases before it.
With ``--what k1`` it builds the checkout's ``fused_score`` and
``flash_decode`` and times, on operands from a fixed seed, K1 at the
scoring shape (bf16 q [4, 128, 4, 64], int8 history of 257 positions for
4 pool rows, a [4] dedup index) and K4's self-slot form at the decode
shape (bf16 [4, 128, 4, 64] against 4 beam caches of 265 positions), then
K1's ``extend`` mode at the ``extend`` family's two shapes (bf16 q and
suffix [4, 1, 4, 64] over 256 bf16 prefix rows, [4, 129, 4, 64] over
128): device time (CUDA-graph replay) and one eager call, for an A/B of
the kernels' unpacked calls between two checkouts.  With ``--what
k1any`` it builds the checkout's ``score_any`` (K1's any-dims variant)
and, at the wide-head Climber's shapes (head dim 256: ``cached`` bf16 q
[4, 128, 4, 256] over an int8 history of 257 positions for 4 pool rows
with a [4] dedup index, ``extend`` [4, 1, 4, 256] over 256 bf16 prefix
rows and [4, 129, 4, 256] over 128, packed [1, 128, 4, 256] over 4 int8
pool rows at alignment 8) and K4's self-slot shape past head dim 128
(bf16 [4, 128, 4, 256] over 264 keys), prints each call's launch plan,
its device time (CUDA-graph replay), one eager call, and each CUDA
kernel's device time per call (``torch.profiler`` over eager calls, so a
checkout whose call launches two kernels shows them apart).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--what", choices=("gen", "k5", "text", "k1", "k1any"),
                    default="gen")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    import torch
    if not torch.cuda.is_available():
        print("dispatch_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke as cs
    if args.what == "k5":
        k5_times(cs, tree, label)
        return 0
    if args.what == "k1":
        k1_times(cs, tree, label)
        return 0
    if args.what == "k1any":
        k1_any_times(cs, tree, label)
        return 0
    if args.what == "text":
        k5_ms = k5_times(cs, tree, label)
        cs.text_phase(torch.device("cuda", 0), cs.card_line(), k5_ms)
        return 0
    from repro_torch.configs import CLIMBER_BASE, get_config
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeRequest, TopKConfig, create_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[dispatch_ab {label}] card: {cs.card_line()}; kernels built in "
          f"{_build.build():.1f}s from {tree}")
    device = torch.device("cuda", 0)
    cfg = get_config("climber")
    n_history = CLIMBER_BASE.seq_len
    hist, _, _ = cs.make_gen_traffic(n_history, cfg.vocab_size, 0)
    for impl in ("pallas", "fused"):
        t0 = time.perf_counter()
        params = C.climber_init(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        bundle = C.build_climber(cfg)
        eng = create_engine(
            "flame", bundle, params, n_history=n_history,
            buckets=(128, 64, 32), max_batch=4, pool_dtype="int8",
            impl=impl, generate=cs.GEN_STEPS, gen_vocab=cs.GEN_VOCAB,
            device=device,
            store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, seed=0))
        try:
            eng.submit(ServeRequest(
                history=hist[0], generate=TopKConfig(k=4, steps=cs.GEN_STEPS),
                user_id=0)).result(timeout=600)
            root = eng.history_pool.peek(("u", 0), eng._fingerprint(hist[0]),
                                         raw=True)
            cs.gen_dispatch_times(eng, root, device,
                                  f"dispatch_ab {label} gen {impl}")
        finally:
            eng.shutdown()
        del params, eng
        torch.cuda.empty_cache()
        print(f"[dispatch_ab {label}] {impl} done in "
              f"{time.perf_counter() - t0:.1f}s")
    return 0


def k1_times(cs, tree: str, label: str):
    """Prints K1's (cached and extend mode) and K4's (self-slot form)
    unpacked times at the serving shapes."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8
    print(f"[dispatch_ab {label}] card: {cs.card_line()}; fused_score and "
          f"flash_decode built in "
          f"{_build.build(['fused_score', 'flash_decode']):.1f}s from {tree}")
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(18)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    q, kc, vc = rnd(4, 128, 4, 64), rnd(4, 128, 4, 64), rnd(4, 128, 4, 64)
    (kh, ks), (vh, vs) = (_int8(rnd(4, 1, 257, 4, 64, dtype=torch.float32))
                          for _ in range(2))
    kw = dict(mode="cached", k_scale=fs._norm_scale(ks[:, 0], 4, 4),
              v_scale=fs._norm_scale(vs[:, 0], 4, 4),
              row_index=torch.arange(4, dtype=torch.int32, device=device))
    k1 = lambda: fs.fused_score(q, kh[:, 0], vh[:, 0], kc, vc,  # noqa: E731
                                **kw)
    kcache, vcache = rnd(4, 265, 4, 64), rnd(4, 265, 4, 64)
    lens = torch.tensor([257, 259, 261, 264], dtype=torch.int32,
                        device=device)
    k4 = lambda: fd.flash_decode_with_self(  # noqa: E731
        q, kcache, vcache, lens, kc, vc)
    fns = [("K1 fused_score cached [4, 128, 4, 64]", k1),
           ("K4 flash_decode_with_self [4, 128, 4, 64]", k4)]
    # drawn after the operands above, which so stay those of earlier runs
    for m, p in ((1, 256), (129, 128)):
        ops = (rnd(4, m, 4, 64), rnd(4, p, 4, 64), rnd(4, p, 4, 64),
               rnd(4, m, 4, 64), rnd(4, m, 4, 64))
        fns.append((f"K1 fused_score extend [4, {m}, 4, 64] over {p}",
                    lambda ops=ops: fs.fused_score(*ops, mode="extend")))
    for name, fn in fns:
        print(f"[dispatch_ab {label}] {name}: "
              f"{cs.device_ms(fn):.4f} ms device (CUDA graph), "
              f"{cs.call_ms(fn):.4f} ms eager call")


def k1_any_times(cs, tree: str, label: str):
    """Prints K1's any-dims variant's plan, times and device time by kernel
    at the wide-head Climber's shapes and K4's self-slot shape."""
    import torch
    from k3_wide_sweep import profile_line
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_score import ops as fs
    print(f"[dispatch_ab {label}] card: {cs.card_line()}; score_any built "
          f"in {_build.build(['score_any']):.1f}s from {tree}")
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(33)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    h = hkv = 4
    d = 256
    fns = []
    q, kh, vh, kc, vc, ks, vs = cs.k1_operands(
        rnd, 4, 128, 4, 257, h, hkv, d, qdt=torch.bfloat16, hist="int8")
    kw = dict(mode="cached", k_scale=ks, v_scale=vs,
              row_index=torch.arange(4, device=device, dtype=torch.int32))
    fns.append(("K1 any cached [4, 128, 4, 256] over int8 [4, 257]",
                fs.plan(q, kh),
                lambda q=q, kh=kh, vh=vh, kc=kc, vc=vc, kw=kw:
                fs.fused_score(q, kh, vh, kc, vc, **kw)))
    for m, pre in ((1, 256), (129, 128)):
        q, kh, vh, kc, vc, _, _ = cs.k1_operands(
            rnd, 4, m, 4, pre, h, hkv, d, qdt=torch.bfloat16,
            hist=torch.bfloat16)
        fns.append((f"K1 any extend [4, {m}, 4, 256] over {pre}",
                    fs.plan(q, kh, mode="extend"),
                    lambda q=q, kh=kh, vh=vh, kc=kc, vc=vc:
                    fs.fused_score(q, kh, vh, kc, vc, mode="extend")))
    q, kh, vh, kc, vc, ks, vs = cs.k1_operands(
        rnd, 1, 128, 4, 257, h, hkv, d, qdt=torch.bfloat16, hist="int8")
    seg, _ = cs.packed_seg(1, 128, 4, 8, device, seed=5)
    kw = dict(mode="cached", k_scale=ks, v_scale=vs, row_index=seg)
    fns.append(("K1 any packed [1, 128, 4, 256] over 4 int8 rows",
                fs.plan(q, kh),
                lambda q=q, kh=kh, vh=vh, kc=kc, vc=vc, kw=kw:
                fs.fused_score(q, kh, vh, kc, vc, **kw)))
    q, kself, vself = (rnd(4, 128, n, d) for n in (h, hkv, hkv))
    kcache, vcache = rnd(4, 264, hkv, d), rnd(4, 264, hkv, d)
    lens = torch.tensor([257, 260, 263, 258], dtype=torch.int32,
                        device=device)
    fns.append(("K4 self-slot [4, 128, 4, 256] over 264",
                fd.plan(q, kcache, self_slot=True),
                lambda: fd.flash_decode_with_self(q, kcache, vcache, lens,
                                                  kself, vself)))
    with cs.uncounted():
        for name, plan, fn in fns:
            print(f"[dispatch_ab {label}] {name}: "
                  f"{cs.device_ms(fn):.4f} ms device (CUDA graph), "
                  f"{cs.call_ms(fn):.4f} ms eager call; by kernel "
                  f"{profile_line(fn)}; plan {plan}")


def k5_times(cs, tree: str, label: str) -> float:
    """Prints K5's times at the two prefill shapes; returns the device ms
    at the batched one, [4, 500, 64, 64]."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import ops as scan
    print(f"[dispatch_ab {label}] card: {cs.card_line()}; rwkv6_scan built "
          f"in {_build.build(['rwkv6_scan']):.1f}s from {tree}")
    for ln in _build.ptxas_log.get("rwkv6_scan", []):
        print(f"[dispatch_ab {label}]   ptxas: {ln.strip()}")
    device = torch.device("cuda", 0)
    times = []
    for b, s, h, d in ((4, 500, 64, 64), (1, 300, 64, 64)):
        g = torch.Generator(device=device).manual_seed(16)
        r, k, v = (torch.randn(b, s, h, d, generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        wl = -torch.empty(b, s, h, d, device=device).uniform_(
            math.log(1e-4), math.log(20.0), generator=g).exp()
        for lo, hi in ((5, 40), (200, 265)):
            wl[:, lo:hi] = -20.0
        u = (0.5 * torch.randn(h, d, generator=g, device=device)).to(
            torch.bfloat16)
        s0 = torch.randn(b, h, d, d, generator=g, device=device)
        ops = (r, k, v, wl, u, s0)
        dev = cs.device_ms(lambda: scan.rwkv6_scan(*ops))
        eager = cs.call_ms(lambda: scan.rwkv6_scan(*ops))
        print(f"[dispatch_ab {label}] rwkv6_scan [{b}, {s}, {h}, {d}] bf16: "
              f"{dev:.4f} ms device (CUDA graph), {eager:.4f} ms eager call")
        times.append(dev)
    return times[0]


if __name__ == "__main__":
    sys.exit(main())
