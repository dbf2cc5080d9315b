"""Model-zoo serving on the PyTorch port: prefill + KV-cache decode for the
assigned text architectures (reduced configs; the port's twin of
``examples/text_serving.py``).  The engine runs its bundle under
``TEXT_IMPL`` ("pallas"): on the card gemma3-12b prefills through K2 and
K3 and decodes through K4 and K3 (a captured step), rwkv6-7b scans
through K5.

    PYTHONPATH=src python examples/torch_text_serving.py              # card
    PYTHONPATH=src python examples/torch_text_serving.py --device cpu \
        [--arch rwkv6-7b] [--small]

Checks: each request gets ``--tokens`` ids in the vocabulary, and request
0's greedy tokens equal those of prefilling its growing sequence (a step
whose top-2 logit gap is under ``TIE_GAP`` is reported, not gated, and
where the two part there the comparison ends).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.model import build_model
from repro_torch.serving import TextServingEngine
from repro_torch.serving.engine import TEXT_IMPL

#: logits closer than this (bf16 weights) make a near tie
TIE_GAP = 0.1


def greedy_check(bundle, params, prompt, got, device) -> int:
    """Steps of ``got`` (the engine's tokens for ``prompt``) that equal
    prefilling the growing sequence; raises SystemExit on a gated
    mismatch."""
    seq = [int(t) for t in prompt]
    gated = 0
    with torch.inference_mode():
        for i, tok in enumerate(got):
            batch = {"tokens": torch.tensor([seq], device=device)}
            ref = bundle.prefill(params, batch, impl=TEXT_IMPL)[0, -1].float()
            top2 = torch.topk(ref, 2).values
            gap = float(top2[0] - top2[1])
            want = int(ref.argmax())
            if gap < TIE_GAP:
                print(f"  greedy step {i}: top-2 gap {gap:.3g} < {TIE_GAP}: "
                      f"near tie, reported not gated (engine {tok}, "
                      f"repeated prefill {want})")
                if want != tok:
                    break
            elif want != tok:
                raise SystemExit(f"torch_text_serving: greedy step {i}: "
                                 f"engine token {tok} != repeated prefill "
                                 f"{want} (top-2 gap {gap:.3g})")
            else:
                gated += 1
            seq.append(want)
    return gated


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="4 tokens and 8-token prompts (quick CPU runs)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_tokens, plen = (4, 8) if args.small else (args.tokens, 16)

    cfg = reduced_config(args.arch)
    print(f"serving reduced {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"pattern={cfg.layer_pattern} on {device} (impl {TEXT_IMPL})")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device=device)
    eng = TextServingEngine(bundle, params, batch=2, max_len=128,
                            device=device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
               rng.integers(0, cfg.vocab_size, plen).astype(np.int32)]
    outs = eng.generate(prompts, n_tokens=n_tokens)
    for i, o in enumerate(outs):
        print(f"request {i}: prompt {prompts[i][:6].tolist()}... -> "
              f"generated {o.tolist()}")
    eng.shutdown()
    ok = all(len(o) == n_tokens and 0 <= int(o.min())
             and int(o.max()) < cfg.vocab_size for o in outs)
    gated = greedy_check(bundle, params, prompts[0], outs[0].tolist(),
                         device)
    print(f"launch counts: {_build.launch_counts()}")
    print(f"text_serving checks: {len(outs)} x {n_tokens} tokens in the "
          f"vocabulary; greedy == repeated prefill on {gated}/{n_tokens} "
          f"steps gated: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("torch_text_serving checks FAILED")


if __name__ == "__main__":
    main()
