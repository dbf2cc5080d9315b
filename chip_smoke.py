#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order (any failure exits non-zero; no phase's failure is caught):

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), printing the build time;
2. kernel phase: each kernel's wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, at the serving path's shapes and at
   small edge shapes, within a stated tolerance; then times the kernel, the
   plain version and one PyTorch library call of the same function
   (``scaled_dot_product_attention``) with CUDA events, median of repeats,
   both on the device alone (calls replayed from a CUDA graph: the JSON
   line's times) and as eager calls with their host work;
3. engine phase: ``create_engine("flame", ...)`` at the published Climber
   width (d_model 256, 4 x 64 heads, d_ff 1024, 2 blocks x 12 layers, vocab
   2,000,000, bf16 weights from a seeded generator), history-KV pool with
   int8 storage, ``impl="fused"``; after a warm-up round, 14 requests from 4
   repeat users so that misses, single-flight waits, hits and dedup occur.
   Checks that every future resolves, that a user's hit equals its miss
   bitwise, that both kernels launched on the main path (24 launches per
   encode / cached dispatch), and that the scores match the port's plain
   path on the CPU (same weights copied to the CPU) within tolerance.
   Prints per-request encode and scoring times, and each executor's work
   called outside the engine (one eager call; a CUDA-graph replay);
4. prints one JSON line listing every ported kernel, then the result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM peaks (NVIDIA data sheet, dense), for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_TOL = 2e-5          # f32 operands: reassociated softmax / scale math
BF16_ATOL, BF16_RTOL = 1e-3, 1.6e-2   # bf16 outputs: 2 bf16 ulps
SCORE_TOL = 2e-2        # engine vs CPU plain path, int8 pool (tests' QTOL)

REPLACES = {
    "fused_score": "src/repro/kernels/fused_score/kernel.py:138",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:165",
}


def fail(msg: str):
    raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def call_ms(fn, reps: int = 50, warm: int = 5) -> float:
    """Median time of one eager call, host work included: CUDA events
    around the call on an idle device, so the Python wrapper's own time
    counts whenever it is longer than the kernel's (warm L2)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median wall time of one call that ends in a device synchronize (host
    clock): what one thread pays for a call, host work and device work."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Median device time of one call, host work excluded: ``per_graph``
    calls captured in one CUDA graph, each replay timed with CUDA events
    and divided by ``per_graph`` (warm L2)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    times.sort()
    return times[len(times) // 2]


def timings(name: str, kernel, plain, library):
    """Device and eager-call times of the kernel, its plain version and
    the library call; prints them and returns the device times."""
    dev = [device_ms(f) for f in (kernel, plain, library)]
    eager = [call_ms(f) for f in (kernel, plain, library)]
    print(f"[chip_smoke] {name} ms per call, device (CUDA graph) / eager "
          f"call: kernel {dev[0]:.4f} / {eager[0]:.4f}, plain "
          f"{dev[1]:.4f} / {eager[1]:.4f}, library {dev[2]:.4f} / "
          f"{eager[2]:.4f}")
    return dev


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(got, want, what: str):
    """Max abs error of ``got`` vs ``want``; fails past the dtype's
    tolerance."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    if got.dtype == torch.float32:
        atol, rtol = F32_TOL, F32_TOL
    else:
        atol, rtol = BF16_ATOL, BF16_RTOL
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        fail(f"{what}: max abs err {err.max().item():.3g} beyond "
             f"atol {atol:g} + rtol {rtol:g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def k1_phase(device):
    """fused_score (K1): every mode and history dtype against the plain
    version; returns its JSON entry measured at the cached-scoring shapes
    of the engine phase."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def case(b, m, u, s, h, hkv, d, *, qdt, hist, mode, dedup, lengths,
             unaligned=False):
        q, kc, vc = (rnd(b, m, n, d, dtype=qdt) for n in (h, hkv, hkv))
        kf, vf = rnd(u, s, hkv, d, dtype=torch.float32), \
            rnd(u, s, hkv, d, dtype=torch.float32)
        if unaligned:     # rows off 16-byte boundaries: the scalar loads
            kc, vc = (torch.cat([t[..., :1], t], -1)[..., 1:]
                      for t in (kc, vc))
        ks = vs = None
        if hist == "int8":
            (kh, ks), (vh, vs) = _int8(kf[:, None]), _int8(vf[:, None])
            kh, vh, ks, vs = kh[:, 0], vh[:, 0], ks[:, 0], vs[:, 0]
        else:
            kh, vh = kf.to(hist), vf.to(hist)
        if unaligned:
            kh, vh = (torch.cat([t[..., :1], t], -1)[..., 1:]
                      for t in (kh, vh))
        args = dict(mode=mode, k_scale=fs._norm_scale(ks, u, hkv),
                    v_scale=fs._norm_scale(vs, u, hkv),
                    row_index=(torch.arange(b, device=device) % u)
                    .to(torch.int32) if dedup else None,
                    lengths=torch.tensor([0] + [s - 1] * (u - 1),
                                         device=device, dtype=torch.int32)
                    if lengths else None)
        out = fs.fused_score(q, kh, vh, kc, vc, **args)
        torch.cuda.synchronize()
        want = fs.fused_score_plain(q, kh, vh, kc, vc, **args)
        err = close(out, want, f"fused_score {mode} q={qdt} hist={hist} "
                               f"dedup={dedup} lengths={lengths} "
                               f"{(b, m, u, s, h, hkv, d)}")
        return err, (q, kh, vh, kc, vc, args)

    shapes = [(4, 128, 4, 257, 4, 4, 64),      # engine's cached bucket 128
              (4, 32, 2, 257, 4, 4, 64),       # engine's bucket 32, deduped
              (3, 37, 3, 70, 4, 2, 32),        # ragged M and S, GQA
              (2, 9, 2, 5, 2, 1, 16)]          # tiny, S < one tile
    n_cases = 0
    for qdt in (torch.bfloat16, torch.float32):
        for hist in ("int8", torch.bfloat16, torch.float32):
            for mode in ("cached", "extend"):
                for i, shp in enumerate(shapes):
                    for dedup in (True, False):
                        if not dedup:      # one pool row per batch row
                            shp = (shp[0], shp[1], shp[0]) + shp[3:]
                        case(*shp, qdt=qdt, hist=hist, mode=mode,
                             dedup=dedup, lengths=(i % 2 == 1))
                        n_cases += 1
            case(3, 37, 2, 70, 4, 2, 32, qdt=qdt, hist=hist, mode="extend",
                 dedup=True, lengths=True, unaligned=True)
            n_cases += 1
    # the serving path's case: bf16 q, int8 history, 1-D dedup index
    main_err, (q, kh, vh, kc, vc, args) = case(
        4, 128, 4, 257, 4, 4, 64, qdt=torch.bfloat16, hist="int8",
        mode="cached", dedup=True, lengths=False)
    print(f"[chip_smoke] K1 fused_score: {n_cases + 1} cases within "
          f"tolerance; serving shape max abs err {main_err:.3g}")
    # library yardstick: SDPA on the dequantized, gathered, concatenated
    # operands with the SUMI mask (their preparation is not timed)
    b, m, h, d = q.shape
    s = kh.shape[1]
    idx = args["row_index"].long()
    kd = (kh.float() * args["k_scale"][:, None, :, None])[idx]
    vd = (vh.float() * args["v_scale"][:, None, :, None])[idx]
    kk = torch.cat([kd.to(q.dtype), kc], 1).transpose(1, 2).contiguous()
    vv = torch.cat([vd.to(q.dtype), vc], 1).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    mask = torch.cat([torch.ones(m, s, dtype=torch.bool, device=device),
                      torch.eye(m, dtype=torch.bool, device=device)], 1)
    ms, plain_ms, library_ms = timings(
        "K1 fused_score",
        lambda: fs.fused_score(q, kh, vh, kc, vc, **args),
        lambda: fs.fused_score_plain(q, kh, vh, kc, vc, **args),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask))
    uniq = int(idx.unique().numel())
    n_bytes = nbytes(q, kc, vc, args["row_index"], q) \
        + (kh[0].numel() * 2 + 2 * args["k_scale"][0].numel() * 4) * uniq
    flops = 4 * b * h * m * (s + 1) * d
    bound_ms, bound_by = bound(n_bytes, flops)
    return dict(name="fused_score", route="cuda",
                source="src/repro_torch/csrc/fused_score.cu",
                replaces=REPLACES["fused_score"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def k2_phase(device):
    """flash_attention (K2): all four masks and q_offset against the plain
    version; returns its JSON entry measured at the encode shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device=device).manual_seed(2)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def case(b, sq, sk, h, hkv, d, dtype, mode, unaligned=False, **kw):
        q = rnd(b, sq, h, d, dtype=dtype)
        k, v = rnd(b, sk, hkv, d, dtype=dtype), rnd(b, sk, hkv, d, dtype=dtype)
        if unaligned:     # rows off 16-byte boundaries: the scalar loads
            k, v = (torch.cat([t[..., :1], t], -1)[..., 1:] for t in (k, v))
        out = fa.flash_attention(q, k, v, mode, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, mode, **kw)
        return close(out, want, f"flash_attention {mode} {kw} {dtype} "
                                f"{(b, sq, sk, h, hkv, d)}"), (q, k, v)

    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (b, sq, h, hkv, d) in [(4, 257, 4, 4, 64), (2, 37, 4, 2, 32),
                                   (1, 5, 2, 1, 16), (2, 70, 2, 2, 128)]:
            for mode, kw in [("full", {}), ("causal", {}),
                             ("sliding", dict(window=40)),
                             ("sumi", dict(n_history=sq)),
                             ("sumi", dict(n_history=sq // 2 + 1)),
                             ("causal", dict(q_offset=30)),
                             ("sumi", dict(n_history=50, q_offset=50))]:
                sk = sq + kw.get("q_offset", 0)
                case(b, sq, sk, h, hkv, d, dtype, mode, **kw)
                n_cases += 1
        case(2, 37, 37, 4, 2, 32, dtype, "sumi", unaligned=True, n_history=20)
        n_cases += 1
    # the serving path's case: causal history encode (SUMI, n_history == S)
    main_err, (q, k, v) = case(4, 257, 257, 4, 4, 64, torch.bfloat16,
                               "sumi", n_history=257)
    print(f"[chip_smoke] K2 flash_attention: {n_cases + 1} cases within "
          f"tolerance; serving shape max abs err {main_err:.3g}")
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, plain_ms, library_ms = timings(
        "K2 flash_attention",
        lambda: fa.flash_attention(q, k, v, "sumi", n_history=257),
        lambda: fa.flash_attention_plain(q, k, v, "sumi", n_history=257),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True))
    b, s, h, d = q.shape
    flops = 4 * b * h * d * s * (s + 1) // 2
    bound_ms, bound_by = bound(nbytes(q, k, v, q), flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=REPLACES["flash_attention"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------

def make_traffic(n_history: int, vocab: int, seed: int):
    """A warm-up round, then 4 repeat users (0-3) in three measured rounds.
    W — users 4-7, each with a 128- and a 96-candidate request at once:
        every executor family and bucket runs before the measured rounds, so
        their latencies are not first-call set-up (allocator, cuBLAS);
    A — each user's first request (128 candidates) plus a second request
        of two users (96 candidates) arriving with it: misses, encodes and
        single-flight waits, co-batched chunks of one pool entry (dedup);
    B — every user again with its round-A candidates: pool hits that must
        equal round A bitwise;
    C — two users twice each with 96-candidate slates: hits whose same-
        bucket chunks of one pool entry may share a dispatch (dedup).
    Returns (histories, warm-up round, measured rounds)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = range(8)
    hist = [rng.integers(0, vocab, n_history + 8).astype(np.int32)
            for _ in users]
    first, second, third = ([rng.integers(0, vocab, m).astype(np.int32)
                             for _ in users] for m in (128, 96, 96))
    warm = [(u, c[u]) for u in range(4, 8) for c in (first, second)]
    rounds = [
        [(u, first[u]) for u in range(4)] + [(0, second[0]), (1, second[1])],
        [(u, first[u]) for u in range(4)],
        [(2, third[2]), (2, second[2]), (3, third[3]), (3, second[3])],
    ]
    return hist, warm, rounds


def dispatch_times(bundle, params, hist, n_history: int, cfg, device,
                   seed: int):
    """What the engine's two executors compute, called outside the engine
    at its shapes (batch 4; cached bucket 128, int8 pool rows): as one
    eager call on one thread, and replayed from a CUDA graph (the device
    alone).  Printed beside the in-engine times, it splits a dispatch into
    device work, host work and the engine's threading."""
    import numpy as np
    import torch
    from repro_torch.core.climber import N_SIDE_FEATURES
    from repro_torch.serving.kv_cache import quantize_kv_graph
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"history": torch.from_numpy(np.stack(
                 [h[:n_history] for h in hist[:4]])).to(device),
             "side": torch.randn(4, N_SIDE_FEATURES, generator=g,
                                 device=device)}
    cands = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                          device=device, dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32, device=device)

    def encode():
        return quantize_kv_graph(bundle.encode_history(
            params, batch, impl="fused"), "int8")

    with torch.inference_mode():
        raw = encode()
        fns = {"encode": encode,
               "cached b128": lambda: bundle.score_candidates(
                   params, raw, cands, impl="fused", row_index=idx)}
        for name, fn in fns.items():
            eager = host_ms(fn)
            dev = device_ms(fn, per_graph=1, reps=10)
            print(f"[chip_smoke] dispatch {name} (batch 4), alone: one "
                  f"eager call {eager:.2f} ms, device (CUDA graph) "
                  f"{dev:.2f} ms")


def engine_phase(cfg, device, *, n_history: int, buckets, seed: int = 0,
                 reference_device="cpu"):
    """Drive the port's engine; returns the kernels' launch counts over the
    measured rounds."""
    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.serving.kv_cache import quantize_kv_graph

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = C.climber_init(cfg, gen, device)
    bundle = C.build_climber(cfg)
    eng = create_engine(
        "flame", bundle, params, n_history=n_history, buckets=buckets,
        max_batch=4, pool_dtype="int8", impl="fused", device=device,
        store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, seed=seed))
    print(f"[chip_smoke] engine: Climber d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads, d_ff {cfg.d_ff}, "
          f"{cfg.climber.num_blocks} blocks x {cfg.climber.layers_per_block} "
          f"layers, vocab {cfg.vocab_size}; n_history {n_history}, buckets "
          f"{tuple(buckets)}, pool int8, impl fused "
          f"(set-up {time.perf_counter() - t0:.1f}s)")
    hist, warm, rounds = make_traffic(n_history, cfg.vocab_size, seed)

    def serve(rnd):
        futs = [eng.submit(ServeRequest(history=hist[u], candidates=c,
                                        user_id=u)) for u, c in rnd]
        return [f.result(timeout=600) for f in futs]

    outs, lat = [], []
    try:
        t_warm = time.perf_counter()
        outs.append([r.output for r in serve(warm)])
        t_warm = time.perf_counter() - t_warm
        before = eng.metrics()
        fa.flash_attention.launches = 0
        fs.fused_score.launches = 0
        t_run = time.perf_counter()
        phases = []
        for rnd in rounds:
            res = serve(rnd)
            outs.append([r.output for r in res])
            lat += [r.latency_s for r in res]
            phases += [r.timings for r in res]
        wall = time.perf_counter() - t_run
        launches = {"flash_attention": fa.flash_attention.launches,
                    "fused_score": fs.fused_score.launches}
        metrics = eng.metrics()
    finally:
        eng.shutdown()
    dispatches = {k: metrics[f"dso_dispatches_{k}"]
                  - before[f"dso_dispatches_{k}"]
                  for k in ("encode", "cached")}
    n_req = sum(len(r) for r in rounds)
    print(f"[chip_smoke] engine: warm-up round of {len(warm)} requests "
          f"{t_warm:.3f}s; {n_req} requests resolved in {wall:.3f}s "
          f"({n_req / wall:.2f} requests/s), latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; pool hits "
          f"{metrics['pool_hits']} misses {metrics['pool_misses']} (all "
          f"rounds), dispatches encode {dispatches['encode']} cached "
          f"{dispatches['cached']}, dedup rows saved "
          f"{metrics['dso_dedup_rows_saved']}")

    # every output finite, [M, num_tasks]
    for rnd, got in zip([warm] + rounds, outs):
        for (u, c), o in zip(rnd, got):
            if o.shape != (len(c), cfg.climber.num_tasks) \
                    or not np.isfinite(o).all():
                fail(f"user {u}: output {o.shape} not finite "
                     f"[{len(c)}, {cfg.climber.num_tasks}]")
    outs = outs[1:]                         # the measured rounds
    # a user's hit (round B) equals its miss (round A) bitwise
    for u in range(4):
        if not np.array_equal(outs[0][u], outs[1][u]):
            fail(f"user {u}: hit != miss (max diff "
                 f"{np.abs(outs[0][u] - outs[1][u]).max():.3g})")
    hits = metrics["pool_hits"] - before["pool_hits"]
    misses = metrics["pool_misses"] - before["pool_misses"]
    if hits < 6 or misses < 4:
        fail(f"measured rounds: pool hits {hits} / misses {misses}: the "
             f"traffic did not hit and miss")
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    want = {"flash_attention": n_layers * dispatches["encode"],
            "fused_score": n_layers * dispatches["cached"]}
    for name, n in launches.items():
        if n <= 0 or n != want[name]:
            fail(f"{name}: {n} launches on the main path, want "
                 f"{want[name]} ({n_layers} per dispatch)")
    print(f"[chip_smoke] engine: hit == miss bitwise for 4 users; launches "
          f"{launches} ({n_layers} per dispatch)")

    enc = [t["encode_s"] for t in phases if t["encode_s"] > 0]
    print(f"[chip_smoke] engine: per request, mean encode "
          f"{np.mean(enc) * 1e3:.1f} ms over {len(enc)} encodes, mean "
          f"candidate scoring (chunk dispatches incl. coalescing wait) "
          f"{np.mean([t['execute_s'] for t in phases]) * 1e3:.1f} ms")
    dispatch_times(bundle, params, hist, n_history, cfg, device, seed)

    # scores vs the port's plain path on the reference device (same
    # weights): encode -> int8 in the epilogue -> score_candidates
    t0 = time.perf_counter()
    ref_params = C.params_to(params, reference_device)
    del params
    store = RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, latency_s=0.0,
                               seed=seed)
    worst = 0.0
    with torch.inference_mode():
        for u in range(4):
            feats = store.query([int(i) for i in hist[u]])
            side = np.mean(list(feats.values()), axis=0,
                           keepdims=True).astype(np.float32)
            kv = C.encode_history(ref_params, {
                "history": torch.from_numpy(hist[u][None, :n_history]),
                "side": torch.from_numpy(side)}, cfg, impl="fused")
            raw = quantize_kv_graph(kv, "int8")
            for rnd, got in zip(rounds, outs):
                for (uu, c), o in zip(rnd, got):
                    if uu != u:
                        continue
                    want = torch.sigmoid(C.score_candidates(
                        ref_params, raw, torch.from_numpy(c[None]), cfg,
                        impl="fused")).numpy()[0]
                    worst = max(worst, float(np.abs(o - want).max()))
    if not worst <= SCORE_TOL:
        fail(f"engine scores vs the {reference_device} plain path: max abs "
             f"err {worst:.3g} > {SCORE_TOL}")
    print(f"[chip_smoke] engine: scores match the {reference_device} plain "
          f"path within {SCORE_TOL} (max abs err {worst:.3g}; "
          f"{time.perf_counter() - t0:.1f}s)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import CLIMBER_BASE, get_config
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = card_line()
    print(f"[chip_smoke] card: {card}")
    build_s = _build.build()
    print(f"[chip_smoke] kernels built in {build_s:.1f}s "
          f"({', '.join(_build.SOURCES)})")
    for name, lines in _build.ptxas_log.items():
        for ln in lines:
            print(f"[chip_smoke]   ptxas {name}: {ln.strip()}")
    device = torch.device("cuda", 0)

    entries = {"fused_score": k1_phase(device),
               "flash_attention": k2_phase(device)}
    launches = engine_phase(get_config("climber"), device,
                            n_history=CLIMBER_BASE.seq_len,
                            buckets=(128, 64, 32))
    kernels = []
    for name, e in entries.items():
        e = dict(e)
        e["launches"] = launches[name]
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
