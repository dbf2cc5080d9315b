#!/usr/bin/env python3
"""Run chosen kernel phases of ``chip_smoke.py`` on one NVIDIA GPU.

    python3 scripts/kernel_phases.py k1 k4      # from the root of a checkout
    python3 scripts/kernel_phases.py text gemma3 h2o
    python3 scripts/kernel_phases.py family jamba kimi llava seamless
    python3 scripts/kernel_phases.py f2 dso roofline

Builds only the sources the phases need (one ``nvcc`` per source, all
started together), prints the card, the build time and the ptxas lines of
those sources, then runs each phase as ``chip_smoke.py`` does (its sweep
against the plain version, its bitwise checks, its launch plan and its
timings) and prints the phase's JSON entry.  ``text`` runs the kernels at
the attention text kinds' shapes (``text_kernel_shapes``), ``gemma3`` and
``h2o`` the text engine at full width on gemma3-12b / h2o-danube-3-4b
(``text_attn_phase``); ``family`` the kernels at the other text families'
shapes (``family_kernel_shapes``), ``jamba``, ``kimi`` and ``llava`` the
text engine on jamba-v0.1-52b (16 layers), kimi-k2-1t-a32b (1 layer),
llava-next-mistral-7b (also its patch embeddings through the bundle),
and ``llama4``, ``qwen2`` and ``qwen15`` on llama4-maverick-400b-a17b,
qwen2-72b and qwen1.5-32b (each at its depth in ``FAMILY_CUTS``),
``seamless`` the audio bundle (``audio_phase``); ``train`` the training
phase (``train_phase``: Climber and h2o-danube-3-4b trained at full width
through ``launch.train``, Climber served from its checkpoint, a pallas
loss refused); ``f2`` the any-dims variants of K2-K5 against their plain
twins (``f2_phase``; ``k1any`` its first part alone: K1's any-dims
variant against its twin, its bitwise rules and times, then the B * H
past 65535 calls of K1, K2 and K4's self-slot form); ``wide`` the
wide-head Climber (head dims 256 and 192) through every family under
fused (``wide_head_phase``); ``dso`` the fixed executor pool at Climber's full
width (``dso_pool_phase``); ``mesh`` sharded serving on the card
(``mesh_phase``: a (1, 1) mesh in an NCCL group of one, then two gloo
ranks sharing the card); ``textmesh`` the text families' sharded forwards
on two gloo ranks sharing the card (``text_mesh_phase``), ``trainmesh``
the sharded train step on two gloo ranks sharing it
(``train_mesh_phase``), ``dryrun`` one job of ``launch/dryrun.py``
(``dryrun_phase``); ``examples`` the five ``examples/torch_*.py``, a
process each (``examples_phase``; every source built first); ``roofline``
the Climber families' bounds
beside their measured times (``roofline_phase``; the text and training
rows come with ``chip_smoke.py``'s phases that time those paths).  The
quick way to check and time one kernel after an edit; ``chip_smoke.py``
stays the whole proof.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"k1": "fused_score", "k2": "flash_attention", "k3": "fused_ffn",
          "k4": "flash_decode", "k5": "rwkv6_scan"}
TEXT = {"text": ("flash_attention", "fused_ffn", "flash_decode",
                 "rwkv6_scan"),
        "gemma3": ("flash_attention", "fused_ffn", "flash_decode"),
        "h2o": ("flash_attention", "fused_ffn", "flash_decode"),
        "family": ("flash_attention", "fused_ffn", "flash_decode"),
        "jamba": ("flash_attention", "fused_ffn", "flash_decode"),
        "kimi": ("flash_attention", "fused_ffn", "flash_decode"),
        "llava": ("flash_attention", "fused_ffn", "flash_decode"),
        "llama4": ("flash_attention", "fused_ffn", "flash_decode"),
        "qwen2": ("flash_attention", "fused_ffn", "flash_decode"),
        "qwen15": ("flash_attention", "fused_ffn", "flash_decode"),
        "seamless": ("flash_attention", "fused_ffn"),
        "examples": ("flash_attention", "fused_score", "flash_decode",
                     "fused_ffn", "rwkv6_scan", "attention_any",
                     "decode_any", "ffn_any", "rwkv6_scan_any", "score_any"),
        "train": ("flash_attention", "fused_score"),
        "f2": ("attention_any", "decode_any", "ffn_any", "rwkv6_scan_any",
               "score_any", "fused_score", "flash_attention",
               "flash_decode"),
        "k1any": ("score_any", "fused_score", "flash_attention",
                  "flash_decode"),
        "wide": ("flash_attention", "score_any"),
        "dso": ("flash_attention",),
        "mesh": ("flash_attention", "fused_score", "fused_ffn"),
        "textmesh": ("flash_attention", "fused_ffn", "flash_decode",
                     "rwkv6_scan"),
        "trainmesh": (),
        "dryrun": (),
        "roofline": ("flash_attention", "fused_score", "flash_decode",
                     "fused_ffn")}


def main(argv) -> int:
    import torch
    names = argv or list(PHASES)
    if any(n not in PHASES and n not in TEXT for n in names):
        print(f"usage: kernel_phases.py "
              f"[{'|'.join(list(PHASES) + list(TEXT))}]...",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_phases.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import CLIMBER_BASE, get_config
    from repro_torch.kernels import _build
    print(f"[kernel_phases] card: {cs.card_line()}")
    sources = list(dict.fromkeys(
        s for n in names for s in ((PHASES[n],) if n in PHASES
                                   else TEXT[n])))
    print(f"[kernel_phases] built {', '.join(sources)} in "
          f"{_build.build(sources):.1f}s")
    for name in sources:
        for ln in _build.ptxas_log.get(name, []):
            print(f"[kernel_phases]   ptxas {name}: {ln.strip()}")
    device = torch.device("cuda", 0)
    cfg = get_config("climber")
    s_pad = CLIMBER_BASE.seq_len // cfg.climber.num_blocks + 1 + cs.GEN_STEPS

    def text(arch, **kw):       # the launches of each path it drove
        paths = {}
        cs.text_attn_phase(device, cs.card_line(), arch, paths,
                           max_len=cs.TEXT_PROMPT + 28, **kw)
        return paths
    cuts = dict(cs.FAMILY_CUTS)

    def examples():             # the five examples, a process each
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            return cs.examples_phase(cs.card_line(), tmp)

    def mesh():                 # sharded serving on this card
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            return cs.mesh_phase(cfg, device, cs.card_line(),
                                 n_history=CLIMBER_BASE.seq_len, tmp=tmp)
    def textmesh():             # the text families sharded on this card
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            return cs.text_mesh_phase(device, cs.card_line(), tmp=tmp)
    def k1any():                # K1's any-dims variant, the grid limit
        entry = cs.k1_any_phase(device, cs.card_line())[1]
        cs.grid_limit_checks(device)
        return entry

    def trainmesh():            # the sharded train step on this card
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            return cs.train_mesh_phase(device, cs.card_line(), tmp=tmp)
    run = {"k1": lambda: cs.k1_phase(device),
           "k2": lambda: cs.k2_phase(device),
           "k3": lambda: cs.k3_phase(device, d_model=cfg.d_model,
                                     d_ff=cfg.d_ff),
           "k4": lambda: cs.k4_phase(device, rows=4, cands=128, s_pad=s_pad),
           "k5": lambda: cs.k5_phase(device),
           "text": lambda: cs.text_kernel_shapes(device, cs.card_line()),
           "gemma3": lambda: text("gemma3-12b", wrap=True),
           "h2o": lambda: text("h2o-danube-3-4b", wrap=False),
           "family": lambda: cs.family_kernel_shapes(device,
                                                     cs.card_line()),
           "jamba": lambda: text("jamba-v0.1-52b", wrap=False, n_layers=16),
           "kimi": lambda: text("kimi-k2-1t-a32b", wrap=False, n_layers=1),
           "llama4": lambda: text("llama4-maverick-400b-a17b", wrap=False,
                                  n_layers=cuts["llama4-maverick-400b-a17b"]),
           "qwen2": lambda: text("qwen2-72b", wrap=False,
                                 n_layers=cuts["qwen2-72b"]),
           "qwen15": lambda: text("qwen1.5-32b", wrap=False,
                                  n_layers=cuts["qwen1.5-32b"]),
           "examples": lambda: examples(),
           "llava": lambda: text("llava-next-mistral-7b", wrap=False, also={
               "vlm llava-next-mistral-7b (patches)":
               cs.vlm_patch_path(device, cs.card_line())}),
           "seamless": lambda: cs.audio_phase(device, cs.card_line()),
           "train": lambda: cs.train_phase(device, cs.card_line(),
                                           (128, 64, 32)),
           "f2": lambda: cs.f2_phase(device, cs.card_line()),
           "k1any": lambda: k1any(),
           "wide": lambda: {f"D {d}": cs.wide_head_phase(
               device, cs.card_line(), d, n_history=CLIMBER_BASE.seq_len,
               buckets=(128, 64, 32)) for d in cs.WIDE_HEAD_DIMS},
           "dso": lambda: cs.dso_pool_phase(cfg, device, cs.card_line(),
                                            n_history=CLIMBER_BASE.seq_len,
                                            buckets=(128, 64, 32)),
           "mesh": lambda: mesh(),
           "textmesh": lambda: textmesh(),
           "trainmesh": lambda: trainmesh(),
           "dryrun": lambda: cs.dryrun_phase(cs.card_line()),
           "roofline": lambda: cs.roofline_phase(
               cfg, device, cs.card_line(), n_history=CLIMBER_BASE.seq_len,
               buckets=(128, 64, 32), every_path=False)}
    for n in names:
        print(json.dumps(run[n]()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
