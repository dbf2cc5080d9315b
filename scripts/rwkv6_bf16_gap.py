"""rwkv6's step-0 gradient in bf16 against f32, on the host: the port's
and JAX's, and the port's at two thread counts (another summation order).

    PYTHONPATH=src python3 scripts/rwkv6_bf16_gap.py [--width 4096]
        [--vocab 1024] [--threads 8,5] [--no-jax]

rwkv6-7b cut to 2 layers at d_model ``--width`` (heads of 64, d_ff 3.5x)
and a vocabulary of ``--vocab``, the port's initializers seeded 0 and one
batch of 2 x 256 tokens, the loss's gradient (``loss_fn``, remat on) with
the weights in f32 and in bf16.  Prints the loss and global grad norm of
each run and, per leaf, its norm and the relative distance of the bf16
gradient from the f32 one (the port at the first thread count, JAX), and
of the run at the second thread count from the first, per dtype.  At
d_model 4096 the run takes ~6 GB and a few minutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                         f"{pre}/{k}")]
    return [pre]


def main(argv=None) -> int:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.loop import grads_of
    from repro_torch.tree import tree_map
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--threads", default="8,5")
    ap.add_argument("--no-jax", action="store_true")
    a = ap.parse_args(argv)
    kw = dict(n_layers=2, d_model=a.width, n_heads=a.width // 64,
              n_kv_heads=a.width // 64, d_ff=int(a.width * 3.5),
              vocab_size=a.vocab)
    bundle = build_model(dataclasses.replace(get_config("rwkv6-7b"), **kw))
    p0 = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(0).integers(0, a.vocab, (2, 256))
    names = _paths(p0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    runs = {}
    for th in (int(x) for x in a.threads.split(",")):
        torch.set_num_threads(th)
        for tag, dt in dtypes.items():
            p = tree_map(lambda t: t.to(dt).clone().requires_grad_(True), p0)
            loss, _ = bundle.loss_fn(p, {"tokens": torch.from_numpy(tokens)})
            runs[(f"port {th} threads", tag)] = (
                float(loss.detach()),
                [g.detach().float() for g in grads_of(loss, p)])
    if not a.no_jax:
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as j_get_config
        from repro.models.model import build_model as j_build_model
        jb = j_build_model(dataclasses.replace(j_get_config("rwkv6-7b"),
                                               **kw))
        for tag, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jp = tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(dt),
                          p0)
            (loss, _), g = jax.value_and_grad(jb.loss_fn, has_aux=True)(
                jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
            runs[("JAX", tag)] = (float(loss), [
                torch.from_numpy(np.array(x.astype(jnp.float32)))
                for x in jax.tree.leaves(g)])
    for (who, tag), (loss, g) in runs.items():
        norm = math.sqrt(sum(float(x.norm()) ** 2 for x in g))
        print(f"{who} {tag}: loss {loss:.6f}, grad norm {norm:.6f}")
    whos = list(dict.fromkeys(w for w, _ in runs))

    def dist(x, y):
        return float((x - y).norm()) / max(float(y.norm()), 1e-30)
    cols = [(f"{w} bf16 vs f32", runs[(w, "bf16")][1], runs[(w, "f32")][1])
            for w in whos if not w.startswith("port") or w == whos[0]]
    ports = [w for w in whos if w.startswith("port")]
    if len(ports) > 1:
        cols += [(f"port {tag} {ports[1]} vs {ports[0]}",
                  runs[(ports[1], tag)][1], runs[(ports[0], tag)][1])
                 for tag in dtypes]
    print("leaf: " + "; ".join(c[0] for c in cols))
    for i, n in enumerate(names):
        print(f"  {n}: " + " ".join(f"{dist(x[i], y[i]):.3g}"
                                     for _, x, y in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main())
