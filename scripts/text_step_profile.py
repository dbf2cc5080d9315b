#!/usr/bin/env python3
"""Where a text model's captured decode step spends its device time.

    python3 scripts/text_step_profile.py gemma3-12b h2o-danube-3-4b

From the root of a checkout on one NVIDIA GPU: builds the text engine at
full width for each architecture (seeded bf16 weights, batch 4, caches of
528 positions, ``impl="pallas"``), prefills 4 prompts of 500 tokens,
loads that state into the captured decode step of 4 rows, and replays it:
the step's time (CUDA events, median of 20 replays), then one replay's
device time by kernel from ``torch.profiler`` (top 12, and the step's sum)
with K3's wide-form kernels (namespace ``flame::ffn::wide``) marked "K3"
and summed apart.  Prints the card's name and power limit
first; exits non-zero without CUDA.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3_WIDE = "flame::ffn::wide::"   # the namespace of K3's wide-form kernels


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available() or not argv:
        print("usage: text_step_profile.py ARCH... (needs an NVIDIA GPU)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model
    from repro_torch.serving import create_engine
    from torch.profiler import ProfilerActivity, profile
    card = cs.card_line()
    print(f"[text_step_profile] card: {card}", flush=True)
    _build.build(("flash_attention", "fused_ffn", "flash_decode"))
    device = torch.device("cuda", 0)
    for arch in argv:
        cfg = get_config(arch)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=device).manual_seed(0),
                             device)
        eng = create_engine("text", bundle, params, batch=4,
                            max_len=cs.TEXT_PROMPT + 28, device=device)
        try:
            rng = np.random.default_rng(17)
            tok = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (4, cs.TEXT_PROMPT)), device=device)
            with torch.inference_mode():
                caches = bundle.cache_init(4, cs.TEXT_PROMPT + 28,
                                           device=device)
                _, filled = bundle.prefill(params, {"tokens": tok},
                                           impl="pallas", caches=caches)
                g = eng._graphs[4]
                g.load(filled, tok[:, -1], tok.shape[1])
                del filled, caches
                ms = cs.call_ms(g.graph.replay, reps=20, warm=3)
                g.load(g.caches, tok[:, -1], tok.shape[1])
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    g.graph.replay()
                    torch.cuda.synchronize()
        finally:
            eng.shutdown()
        rows = {}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                name = e.name.split("(")[0].split("<")[0].replace(
                    "void ", "")
                name = ("K3 " if K3_WIDE in name else "") + \
                    name.split("::")[-1][:60]
                us = getattr(e, "device_time", None)
                if us is None:
                    us = getattr(e, "cuda_time", 0)
                n, t = rows.get(name, (0, 0.0))
                rows[name] = (n + 1, t + us / 1e3)
        total = sum(t for _, t in rows.values())
        k3 = sum(t for k, (_, t) in rows.items() if k.startswith("K3 "))
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:12]
        print(f"[text_step_profile] {arch}: decode step of 4 rows "
              f"(captured, replayed) {ms:.3f} ms; one replay's kernels sum "
              f"to {total:.3f} ms of device time, K3's wide form {k3:.3f} "
              f"ms ({k3 / max(total, 1e-9):.0%}); {card}", flush=True)
        print(f"[text_step_profile] {arch}: by kernel (launches, ms): "
              + "; ".join(f"{k} x{n} {t:.3f}" for k, (n, t) in top),
              flush=True)
        del eng, params, bundle
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
