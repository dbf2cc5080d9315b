"""Serving launcher of the port: the flame engine under synthetic traffic,
or the text engine on a reduced text model.

    PYTHONPATH=src python -m repro_torch.launch.serve --pool-dtype int8 \
        --users 8 --requests 64                      # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --engine text \
        --device cpu --requests 2 --tokens 6          # gemma3-12b
    PYTHONPATH=src python -m repro_torch.launch.serve --engine text \
        --arch jamba-v0.1-52b --device cpu --requests 2 --tokens 6
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --history 16 --d-model 32 --buckets 8,4 --counts 4,8
    PYTHONPATH=src python -m repro_torch.launch.serve --generate beam \
        --impl pallas --pool-dtype int8 --users 4 --requests 8   # generation
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --incremental-history --pack-tails --distribution jittered \
        --users 4 --requests 8 --history 16 --d-model 32 --buckets 8,4 \
        --counts 4,8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --no-history-cache --impl chunked --requests 4 --history 16 \
        --d-model 32 --buckets 8,4 --counts 4,8       # pool off, framework
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --engine implicit --requests 6 --history 16 --d-model 32 \
        --counts 4,8                                  # Table 5 "Default"
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fault-spec dispatch:0.2,evict:0.1 --shed-policy tiered \
        --degrade 5 --pool-spill-mb 64 --pool-slots 2 --users 4 \
        --slo-mix interactive=0.2,standard=0.5,bulk=0.3 --requests 16 \
        --history 16 --d-model 32 --buckets 8,4 --counts 4,8   # overload
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh 2,2 --requests 8 --history 16 --d-model 32 --buckets 8,4 \
        --counts 4,8                                  # 4 gloo ranks

Mirrors the ``--engine flame`` and ``--engine implicit`` flags of
``repro/launch/serve.py`` for the ported paths: the history-KV pool is on
unless ``--no-history-cache`` (the pool-off ``full`` family: the JAX
launcher's default, where ``--history-cache`` turns the pool on); ``--impl``
picks fused (kernels K1, K2), pallas (K2, K3, K4), chunked (the JAX
framework impl, plain PyTorch) or reference (plain PyTorch) — on the GPU
the kernels, on the CPU their plain PyTorch versions.  ``--generate``
turns the traffic's candidate slates into per-request token universes and
asks for top-k or beam generation instead of scoring.
``--incremental-history`` / ``--extend-buckets`` / ``--extend-refresh-limit``
turn on the ``extend`` family (stale hits re-encode only the changed
suffix), ``--pack-tails`` / ``--pack-rows`` / ``--pack-align`` segment
packing of the ``cached`` and ``decode`` families; both, and
``--generate``, need the pool.  ``--engine implicit`` serves each request
at batch 1 and its own candidate count, one executor per novel count built
in band (``jit_compiles``).
Overload and faults take the JAX launcher's flags and defaults:
``--pool-spill-mb`` (the pool's host spill tier), ``--slo-tier-defaults``
and ``--slo-mix`` (per-tier deadlines in ms, the traffic's tier weights),
``--shed-policy tiered``, ``--degrade`` (the degradation ladder's
queue-delay threshold in ms), ``--watchdog-grace-ms``, ``--fault-spec`` /
``--fault-seed`` (``serving/faults.py``'s grammar).  Under a fault spec or
shedding the run tolerates rejected and failed requests, counts them, and
exits non-zero if any future hangs.
``--mesh D,M`` / ``--model-parallel N`` serve the flame engine over a
("data", "model") mesh with the JAX launcher's meanings: the launcher
starts the ranks itself (``launch.mesh.run_ranks``; one rank per card
under NCCL with the default ``--device cuda``, gloo ranks on the CPU),
rank 0 serves the traffic and prints, every other rank replays its
dispatches (``serving.engine.serve_follower``).
The model is the launcher's reduced Climber (2 blocks x 2 layers, vocab
50,000, ``--d-model`` wide) with random weights from ``--seed``, or the
weights of ``--ckpt``, a checkpoint of that configuration (written by
``training.checkpoint.save``, by ``repro_torch.launch.train --ckpt`` or
by the JAX package's).
Requests go through ``submit``, so cross-request coalescing is exercised.

``--engine text`` mirrors ``serve_text`` of the JAX launcher: the reduced
``--arch`` config (any decoder of the registry, default gemma3-12b as in
the JAX launcher; random weights from ``--seed``), ``--requests``
16-token prompts through ``submit``, ``--tokens`` greedy tokens each,
under ``impl="pallas"``; on the GPU the rwkv kind's prefill runs kernel
K5, the attention kinds' prefill K2, every dense FFN and shared expert K3,
an ``attn`` layer's decode K4 (the routed experts and the Mamba scan are
plain PyTorch, as in the JAX package).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import TEXT_ARCHS, get_config, reduced_config
from repro_torch.core.climber import build_climber, climber_init
from repro_torch.devices import resolve_device
from repro_torch.launch import mesh as MESH
from repro_torch.models.attention import IMPLS
from repro_torch.models.model import build_model
from repro_torch.serving import (BeamConfig, DegradationPolicy,
                                 FaultInjector, ServeRequest, TopKConfig,
                                 create_engine)
from repro_torch.serving.engine import serve_follower
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload_async)
from repro_torch.training import checkpoint
from repro_torch.types import ClimberConfig


def _parse_kv_floats(spec: str, what: str) -> dict:
    """Parse ``name=value,name=value`` CLI maps (tier deadlines, mixes)."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise SystemExit(f"[serve] bad {what} entry {part!r} "
                             f"(want name=value)")
        k, v = part.split("=", 1)
        out[k.strip()] = float(v)
    return out


def _print_metrics(tag: str, m: dict):
    print(f"[serve] {tag}: " + ", ".join(
        f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(m.items())))


def serve(args, mesh=None) -> dict:
    """Serve the launcher's traffic; under ``mesh`` a follower rank
    replays the leader's dispatches instead (and returns None)."""
    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=50_000, d_model=args.d_model,
        d_ff=4 * args.d_model, n_heads=4, n_kv_heads=4,
        head_dim=args.d_model // 4,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    bundle = build_climber(cfg)
    params = climber_init(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    if args.ckpt:
        params, step = checkpoint.restore(args.ckpt, params)
        print(f"[serve] restored checkpoint @ step {step}")
    gen_kw = {} if args.generate == "none" else dict(
        generate=args.gen_steps, gen_vocab=args.gen_vocab)
    common = dict(n_history=args.history, feature_mode=args.feature_mode,
                  max_pending=args.max_pending, impl=args.impl,
                  n_workers=args.concurrency, device=device)
    if args.engine == "implicit":
        eng = create_engine("implicit", bundle, params, **common)
        try:
            print(f"[serve] implicit-shape engine: one executor per novel "
                  f"candidate count, built in band (impl {args.impl}, "
                  f"device {device}, kernels built in "
                  f"{eng.kernel_build_s:.1f}s)")
            return _run(args, cfg, eng)
        finally:
            eng.shutdown()
    tier_defaults = None
    if args.slo_tier_defaults.strip():
        tier_defaults = {k: v * 1e-3 for k, v in _parse_kv_floats(
            args.slo_tier_defaults, "--slo-tier-defaults").items()}
    flame_kw = dict(
        history_cache=not args.no_history_cache,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        n_streams=args.streams, coalesce=not args.no_coalesce,
        max_batch=args.max_batch, window_s=args.window_ms * 1e-3,
        pool_slots=args.pool_slots,
        pool_budget_bytes=(int(args.pool_budget_mb * 2**20)
                           if args.pool_budget_mb else None),
        pool_dtype=args.pool_dtype, pool_placement=args.pool_placement,
        pool_spill_bytes=int(args.pool_spill_mb * 2**20),
        deadline_s=args.deadline_ms * 1e-3, admission=args.admission,
        shed_policy=args.shed_policy, slo_tier_defaults=tier_defaults,
        watchdog_grace_s=args.watchdog_grace_ms * 1e-3,
        degradation=(DegradationPolicy(threshold_s=args.degrade * 1e-3)
                     if args.degrade > 0 else None),
        faults=(FaultInjector.parse(args.fault_spec, seed=args.fault_seed)
                if args.fault_spec.strip() else None),
        incremental_history=args.incremental_history,
        extend_buckets=(tuple(int(b) for b in args.extend_buckets.split(","))
                        if args.extend_buckets.strip() else None),
        extend_refresh_limit=args.extend_refresh_limit,
        pack_tails=args.pack_tails,
        pack_rows=args.pack_rows if args.pack_rows > 0 else None,
        pack_align=args.pack_align if args.pack_align > 0 else None,
        mesh=mesh, **common, **gen_kw)
    if mesh is not None and not mesh.leader:
        serve_follower(bundle, params, **flame_kw)
        return None
    eng = create_engine("flame", bundle, params, **flame_kw)
    try:
        fams = ", ".join(f"{k}:{v}" for k, v in eng.dso.families.items())
        print(f"[serve] kernels built in {eng.kernel_build_s:.1f}s, "
              f"executors in {eng.dso.build_time_s:.2f}s (CUDA-graph "
              f"captures {eng.dso.graph_capture_s:.2f}s, left "
              f"{eng.dso.graph_bytes / 2**20:.1f} MiB reserved; both 0 on "
              f"the CPU, where executors run eagerly) "
              f"(families {fams}, impl {args.impl}, device {device}, batch "
              f"axis "
              f"{eng.dso.policy.batch}, coalesce="
              f"{'on' if eng.dso.policy.enabled else 'off'}, pack_tails="
              f"{'on' if args.pack_tails else 'off'}, packed rows "
              f"{eng.dso.policy.rows} aligned to "
              f"{eng.dso.policy.pack_align})")
        if mesh is not None:
            print(f"[serve] mesh: data={mesh.shape['data']} x "
                  f"model={mesh.shape['model']} over {mesh.size} "
                  f"{mesh.backend} rank(s), executors "
                  f"{'captured' if eng.metrics()['dso_captured'] else 'eager'}")
        if eng.history_pool is not None:
            budget = (f"{args.pool_budget_mb:g} MB budget"
                      if args.pool_budget_mb else "no byte budget")
            print(f"[serve] history-KV pool: {args.pool_slots} slots, "
                  f"{budget}, dtype {args.pool_dtype}, placement "
                  f"{args.pool_placement}, spill tier "
                  f"{args.pool_spill_mb:g} MB")
        else:
            print("[serve] history-KV pool off: every request runs the "
                  "monolithic SUMI pass (family full)")
        return _run(args, cfg, eng)
    finally:
        eng.shutdown()


def _run(args, cfg, eng) -> dict:
    """Serve the launcher's traffic through ``eng`` and print the results."""
    tier_mix = _parse_kv_floats(args.slo_mix, "--slo-mix") \
        if args.slo_mix.strip() else None
    tc = TrafficConfig(
        candidate_counts=tuple(int(c) for c in args.counts.split(",")),
        distribution=args.distribution, n_requests=args.requests,
        n_history=args.history, seed=args.seed, n_users=args.users,
        tier_mix=tier_mix)
    reqs = generate_traffic(tc, n_items=cfg.vocab_size)
    if args.generate != "none":
        # the traffic's candidate slates become per-request token
        # universes, and each request asks for generation
        eos = args.gen_eos if args.gen_eos >= 0 else None
        gen = (TopKConfig(k=args.beam_width, steps=args.gen_steps,
                          eos=eos) if args.generate == "topk" else
               BeamConfig(width=args.beam_width, steps=args.gen_steps,
                          eos=eos))
        for r in reqs:
            r["generate"] = gen
        print(f"[serve] generative decode: {args.generate} width "
              f"{args.beam_width} x {args.gen_steps} steps, per-request "
              f"token universes from the candidate slates")
    # overload / chaos runs tolerate rejections and injected failures; the
    # liveness contract they do hold is zero hung futures
    chaos = args.engine == "flame" and (bool(args.fault_spec.strip())
                                        or args.shed_policy != "none")
    res = run_workload_async(eng, reqs,
                             arrival_gap_s=args.arrival_gap_ms * 1e-3,
                             tolerate_errors=chaos)
    unit = "gen tokens/s" if args.generate != "none" else "items/s"
    print(f"[serve] {res['requests']} requests | "
          f"{res['throughput_items_per_s']:.0f} {unit} | "
          f"p50 {res['p50_latency_ms']:.1f} ms | "
          f"p99 {res['p99_latency_ms']:.1f} ms")
    if chaos:
        hint = (f" retry_after~{res['retry_after_mean_ms']:.0f}ms "
                f"(x{res['retry_after_hinted']})"
                if res["retry_after_hinted"] else "")
        print(f"[serve] overload/chaos accounting: "
              f"resolved={res['resolved']} rejected={res['rejected']} "
              f"failed={res['failed']} hung={res['hung']}{hint}")
        if res["hung"]:
            _print_metrics("engine metrics", eng.metrics())
            raise SystemExit(f"[serve] liveness violated: {res['hung']} "
                             f"future(s) never resolved")
    if args.generate != "none":
        for i, out in enumerate(res["outputs"][:3]):
            best = [t for t in out[0].tolist() if t >= 0]
            print(f"[serve] req {i}: best sequence {best}")
    _print_metrics("engine metrics", eng.metrics())
    return res


def serve_text(args):
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    print(f"[serve] text engine on reduced {cfg.name}: {cfg.n_layers}L "
          f"d={cfg.d_model} pattern={cfg.layer_pattern} device {device}")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(
        args.seed), device)
    eng = create_engine("text", bundle, params, batch=2, max_len=128,
                        device=device)
    try:
        rng = np.random.default_rng(args.seed)
        futs = [eng.submit(ServeRequest(
            history=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
            n_tokens=args.tokens)) for _ in range(args.requests)]
        for f in futs:
            r = f.result()
            print(f"[serve] req {r.request_id}: generated "
                  f"{r.output.tolist()} in {r.latency_s * 1e3:.0f} ms")
        _print_metrics("metrics", eng.metrics())
    finally:
        eng.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="flame",
                    choices=["flame", "implicit", "text"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the traffic")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--history", type=int, default=128)
    ap.add_argument("--buckets", default="64,32,16")
    ap.add_argument("--counts", default="16,32,64")
    ap.add_argument("--distribution", default="uniform",
                    choices=["uniform", "zipf", "jittered", "lognormal"])
    ap.add_argument("--feature-mode", default="sync",
                    choices=["off", "sync", "async"])
    ap.add_argument("--no-history-cache", action="store_true",
                    help="pool off: every request runs the monolithic SUMI "
                         "pass over history + candidates (the full family)")
    ap.add_argument("--pool-slots", type=int, default=256,
                    help="history-KV pool capacity (entries, LRU-evicted)")
    ap.add_argument("--pool-budget-mb", type=float, default=0.0,
                    help="history-KV pool byte budget in MB (0 = entry "
                         "bound only)")
    ap.add_argument("--pool-dtype", default="native",
                    choices=["native", "bf16", "int8"],
                    help="stored precision of pool entries (int8 uses "
                         "per-head scales)")
    ap.add_argument("--pool-placement", default="device",
                    choices=["device", "host"],
                    help="device keeps entries in the engine device's "
                         "memory; host keeps them in CPU memory")
    ap.add_argument("--pool-spill-mb", type=float, default=0.0,
                    help="host second-tier budget in MB absorbing pool "
                         "evictions, pinned on the GPU (0 = no spill tier)")
    ap.add_argument("--incremental-history", action="store_true",
                    help="on stale pool hits sharing a window prefix with "
                         "the cached entry, re-encode only the suffix + "
                         "side token against the cached prefix K/V")
    ap.add_argument("--extend-buckets", default="",
                    help="comma list of trusted-prefix lengths for the "
                         "extend executor family (empty = the default "
                         "ladder n,3n/4,n/2)")
    ap.add_argument("--extend-refresh-limit", type=int, default=0,
                    help="force a full re-encode after this many "
                         "incremental extensions of one pool entry "
                         "(0 = uncapped)")
    ap.add_argument("--pack-tails", action="store_true",
                    help="segment packing: partial tail chunks of different "
                         "requests share (pack-rows, bucket) rows, each "
                         "candidate steered to its own user's pooled KV")
    ap.add_argument("--pack-rows", type=int, default=0,
                    help="row capacity of the packed executors (0 = auto "
                         "max_batch/4)")
    ap.add_argument("--pack-align", type=int, default=0,
                    help="start every packed segment on a multiple of this "
                         "(1 or a multiple of 8; 0 = auto: 8 under --impl "
                         "fused, else 1)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-request deadline budget (0 = none)")
    ap.add_argument("--admission", default="edf", choices=["edf", "fifo"])
    ap.add_argument("--slo-tier-defaults", default="",
                    help="per-tier default deadline budgets in ms, e.g. "
                         "'interactive=50,standard=250,bulk=2000', for "
                         "requests without a deadline (empty = only "
                         "--deadline-ms applies)")
    ap.add_argument("--shed-policy", default="none",
                    choices=["none", "tiered"],
                    help="tiered: when the queue is at depth or the "
                         "predicted wait blows an arrival's budget, fail "
                         "the worst lower-priority queued request "
                         "(ShedError, shed_{tier} counters)")
    ap.add_argument("--degrade", type=float, default=0.0,
                    help="graceful-degradation queue-delay threshold in ms "
                         "(0 = off): 1 flushes coalescing windows at once, "
                         "2 also halves bulk generation, 3 also serves bulk "
                         "scoring from the pool only; recovery reverses")
    ap.add_argument("--slo-mix", default="",
                    help="traffic tier mix as weights, e.g. "
                         "'interactive=0.2,standard=0.5,bulk=0.3' "
                         "(empty = all standard)")
    ap.add_argument("--watchdog-grace-ms", type=float, default=0.0,
                    help="fail any future still unresolved this long past "
                         "its deadline with WatchdogTimeout (0 = off)")
    ap.add_argument("--fault-spec", default="",
                    help="chaos injection arms, e.g. "
                         "'dispatch:0.2,stall:0.1:0.02,evict:0.1' "
                         "(repro_torch.serving.faults); the run then "
                         "tolerates failures but exits non-zero if any "
                         "future hangs")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="PRNG seed of the --fault-spec arms")
    ap.add_argument("--users", type=int, default=0,
                    help="repeat-user traffic: draw requests from this many "
                         "users with stable histories (0 = unique users)")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="pipeline worker threads")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable cross-request chunk coalescing")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="coalescing fill target / executor batch axis")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="coalescing time window")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="admission queue bound (backpressure)")
    ap.add_argument("--arrival-gap-ms", type=float, default=0.0,
                    help="max random gap between request arrivals")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="restore the Climber params from this checkpoint "
                         "(repro_torch.launch.train --ckpt)")
    ap.add_argument("--impl", default="fused", choices=list(IMPLS),
                    help="fused: K1 scores cached / decode calls, K2 the "
                         "encodes and full passes; pallas: K2 for every "
                         "attention pass but decode (K4), K3 for every FFN; "
                         "chunked: the JAX framework impl, plain PyTorch; "
                         "reference: plain PyTorch")
    ap.add_argument("--generate", default="none",
                    choices=["none", "topk", "beam"],
                    help="serve top-k / beam generation over the item "
                         "vocabulary from pooled history KV instead of "
                         "scoring candidate slates; the slates become "
                         "per-request token universes")
    ap.add_argument("--gen-steps", type=int, default=8,
                    help="generated sequence length (also the engine's "
                         "generation capacity, which pads beam caches)")
    ap.add_argument("--beam-width", type=int, default=4,
                    help="hypotheses kept per step (beam width for "
                         "--generate beam, k for --generate topk)")
    ap.add_argument("--gen-eos", type=int, default=-1,
                    help="EOS item id: a hypothesis emitting it finishes "
                         "early (gen_early_exits metric; -1 = no EOS)")
    ap.add_argument("--gen-vocab", type=int, default=512,
                    help="token-universe size of a generative request "
                         "without candidates")
    ap.add_argument("--mesh", default="",
                    help="serve the flame engine over a 'data,model' mesh, "
                         "e.g. --mesh 2,2: the request batch over data "
                         "ways, attention heads, FFN columns and the item "
                         "table over model ways; the launcher starts one "
                         "rank per device (empty = no mesh)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="shortcut for --mesh: N model ways, data ways = "
                         "cards // N (N ranks on the CPU)")
    ap.add_argument("--arch", default="gemma3-12b", choices=TEXT_ARCHS,
                    help="text engine: reduced config name")
    ap.add_argument("--tokens", type=int, default=12,
                    help="text engine: tokens per request")
    args = ap.parse_args(argv)
    if args.no_history_cache and args.generate != "none":
        ap.error("--generate needs the history-KV pool: in-flight beams "
                 "live in the HistoryKVPool as growing entries and the "
                 "decode step reads pooled history KV as its prompt")
    if args.engine == "implicit" and args.generate != "none":
        ap.error("--generate needs --engine flame: the implicit-shape "
                 "engine scores candidate slates")
    if args.no_history_cache and args.pack_tails:
        ap.error("--pack-tails needs the history-KV pool: segment packing "
                 "steers each candidate segment to its own user's POOLED "
                 "history KV — the monolithic full-pass family has no "
                 "per-user KV rows to steer to")
    if args.engine == "text":
        serve_text(args)
        return
    on_card = torch.device(args.device).type == "cuda"
    ranks = MESH.mesh_ranks(args.mesh, args.model_parallel,
                            torch.cuda.device_count() if on_card else 0)
    if not ranks:
        serve(args)
        return
    if args.engine != "flame":
        ap.error("--mesh / --model-parallel serve the flame engine")
    MESH.run_ranks(_serve_rank, ranks, backend="nccl" if on_card else "gloo",
                   args=(args,), threads=0 if on_card else 1)


def _serve_rank(rank: int, args):
    serve(args, MESH.make_serving_mesh(args.mesh, args.model_parallel))


if __name__ == "__main__":
    main()
