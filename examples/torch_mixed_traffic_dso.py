"""DSO demo on the PyTorch port: implicit-shape capture vs explicit-bucket
routing vs cross-request chunk coalescing under non-uniform upstream
candidate counts (paper §4.2.3 / Table 5; the port's twin of
``examples/mixed_traffic_dso.py``, at its sizes).

    PYTHONPATH=src python examples/torch_mixed_traffic_dso.py         # card
    PYTHONPATH=src python examples/torch_mixed_traffic_dso.py --device cpu \
        --small

Checks: every engine scores every request (finite, one row per candidate),
the implicit engine captures once per distinct candidate count, and the
bucketed engines' scores match the implicit engine's within ``TOL``.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.climber import build_climber, climber_init
from repro_torch.core.dso import split_request
from repro_torch.core.pda import RemoteFeatureStore
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.serving import create_engine
from repro_torch.serving.scheduler import run_workload_async
from repro_torch.types import ClimberConfig

#: bucketed (padded chunks, coalesced rows) against one pass per request:
#: the same arithmetic per candidate in other shapes, on bf16 weights
TOL = 2e-2
COUNTS = [17, 33, 64, 90, 128, 40, 77, 128, 25, 60]


def make_climber(device, d_model=128, layers=2, blocks=2, seed=0):
    """The benchmarks' CPU-feasible Climber (the paper's structure:
    blocks / SUMI / head), its bundle and seeded parameters."""
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=50_000, d_model=d_model,
        d_ff=4 * d_model, n_heads=4, n_kv_heads=4, head_dim=d_model // 4,
        climber=ClimberConfig(num_blocks=blocks, layers_per_block=layers))
    params = climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    return cfg, build_climber(cfg), params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="a narrower model over 64 history items (quick "
                         "CPU runs)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    d_model, history = (32, 64) if args.small else (96, 256)
    cfg, bundle, params = make_climber(device, d_model=d_model)
    rng = np.random.default_rng(0)
    reqs = [{"history": rng.integers(0, 1000, history).astype(np.int32),
             "candidates": rng.integers(0, 1000, m).astype(np.int32)}
            for m in COUNTS]

    print("bucket split plans (buckets 128/64/32/16):")
    for m in COUNTS[:5]:
        plan = split_request(m, [128, 64, 32, 16])
        print(f"  M={m:>4} -> " + " + ".join(
            f"{c.bucket}({c.valid})" for c in plan))

    def store():
        return RemoteFeatureStore(latency_s=0, feature_dim=12)

    def scored(res):
        return all(o.shape == (m, cfg.climber.num_tasks)
                   and np.isfinite(o).all()
                   for o, m in zip(res["outputs"], COUNTS))

    # implicit shape: a fresh executor (on the card a capture) per novel M,
    # in band
    eng = create_engine("implicit", bundle, params, n_history=history,
                        feature_mode="off", store=store(), n_workers=4,
                        device=device)
    t0 = time.perf_counter()
    res = run_workload_async(eng, reqs)
    t_implicit = time.perf_counter() - t0
    captures = eng.metrics()["jit_compiles"]
    print(f"\nimplicit shape: {t_implicit:.2f}s for {len(COUNTS)} requests "
          f"({captures} executors built in band; CUDA-graph captures on the "
          f"card)")
    eng.shutdown()
    ref = res["outputs"]
    ok = scored(res) and captures == len(set(COUNTS))
    errs = []

    for coalesce in (False, True):
        eng = create_engine("flame", bundle, params, n_history=history,
                            buckets=(128, 64, 32, 16), n_streams=2,
                            feature_mode="off", store=store(),
                            coalesce=coalesce, max_batch=4, window_s=0.005,
                            n_workers=4, device=device)
        t0 = time.perf_counter()
        res = run_workload_async(eng, reqs)
        dt = time.perf_counter() - t0
        m = eng.metrics()
        tag = "DSO + coalescing" if coalesce else "DSO routing     "
        print(f"{tag}: {dt:.2f}s "
              f"(executor pool built off-band in {eng.dso.build_time_s:.1f}s; "
              f"{m['dso_chunks']} chunks in {m['dso_dispatches']} "
              f"dispatches, avg fill {m['dso_avg_fill']:.1f})")
        print(f"-> speedup over implicit x{t_implicit / dt:.1f}")
        eng.shutdown()
        ok = ok and scored(res)
        errs.append(max(float(np.abs(np.asarray(a, np.float32)
                                     - np.asarray(b, np.float32)).max())
                        for a, b in zip(res["outputs"], ref)))
    ok = ok and max(errs) <= TOL
    print(f"launch counts: {_build.launch_counts()}")
    print(f"mixed_traffic_dso checks: {len(set(COUNTS))} distinct M -> "
          f"{captures} executors; max |bucketed - implicit| "
          f"{max(errs):.3g} (tol {TOL}): {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch_mixed_traffic_dso checks FAILED")


if __name__ == "__main__":
    main()
