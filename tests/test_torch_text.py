"""The port's text engine (``TextServingEngine``, registered as ``"text"``)
on the reduced rwkv6-7b, against the JAX package.

Both engines get the same f32 weights (``params_from_jax``) and the same
prompts from a numpy seed; greedy tokens must agree token for token.
Batched ``generate`` gets prompts of equal length: the reference pads
unequal prompts at the end with token 0, which an RWKV state absorbs
(ROADMAP.md Queue 3), so equal lengths keep every row's answer its own.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models.model import build_model as j_build_model
from repro.serving.engine import TextServingEngine as JTextServingEngine
from repro_torch.configs import reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import ServeRequest, create_engine
from repro_torch.serving.engine import TextServingEngine
from repro_torch.tree import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
N_TOKENS = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config("rwkv6-7b")
    jb = j_build_model(jcfg)
    jparams, _ = jb.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tb = build_model(reduced_config("rwkv6-7b"))
    t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 24).astype(np.int32)
               for _ in range(3)]
    singles = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (9, 70)]
    jeng = JTextServingEngine(jb, j32, batch=4, max_len=128)
    try:
        jouts = jeng.generate(prompts, n_tokens=N_TOKENS)
        jsingles = [jeng.generate([p], n_tokens=N_TOKENS)[0]
                    for p in singles]
    finally:
        jeng.shutdown()
    return tb, t32, prompts, singles, jouts, jsingles


def test_generate_matches_jax_engine_token_for_token(setup):
    tb, t32, prompts, _, jouts, _ = setup
    eng = create_engine("text", tb, t32, batch=4, max_len=128, device="cpu")
    try:
        outs = eng.generate(prompts, n_tokens=N_TOKENS)
    finally:
        eng.shutdown()
    assert isinstance(eng, TextServingEngine)
    assert [len(o) for o in outs] == [N_TOKENS] * len(prompts)
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o, np.asarray(j))


def test_submit_matches_jax_engine_and_generate(setup):
    tb, t32, _, singles, _, jsingles = setup
    eng = create_engine("text", tb, t32, batch=4, max_len=128, device="cpu")
    try:
        futs = [eng.submit(ServeRequest(history=p, n_tokens=N_TOKENS))
                for p in singles]
        res = [f.result(timeout=120) for f in futs]
        direct = [eng.generate([p], n_tokens=N_TOKENS)[0] for p in singles]
        m = eng.metrics()
    finally:
        eng.shutdown()
    for r, j, d in zip(res, jsingles, direct):
        np.testing.assert_array_equal(r.output, np.asarray(j))
        np.testing.assert_array_equal(r.output, d)
        assert r.timings["prefill_s"] > 0 and r.timings["decode_s"] >= 0
    assert m["requests"] == len(singles)
    assert m["text_prefills"] == 2 * len(singles)
    assert m["text_decode_steps"] == 2 * len(singles) * (N_TOKENS - 1)


def test_greedy_matches_repeated_prefill(setup):
    """The engine's decode loop (one recurrent step per token) equals a
    manual loop that re-prefills the growing sequence (K5's chunked scan)
    at every step."""
    tb, t32, prompts, _, _, _ = setup
    eng = create_engine("text", tb, t32, batch=2, max_len=64, device="cpu")
    try:
        out = eng.generate([prompts[0], prompts[1]], n_tokens=4)[0]
    finally:
        eng.shutdown()
    seq = list(prompts[0])
    with torch.inference_mode():
        for _ in range(4):
            logits = tb.prefill(t32, {"tokens": torch.tensor([seq])})
            seq.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(np.array(seq[-4:]), out)


def test_engine_rejects_params_elsewhere_and_oversized_batches(setup):
    tb, t32, prompts, _, _, _ = setup
    moved = dict(t32, embed={"embedding": t32["embed"]["embedding"].to(
        "meta")})
    with pytest.raises(ValueError, match="params are on"):
        TextServingEngine(tb, moved, device="cpu")
    eng = TextServingEngine(tb, t32, batch=2, max_len=64, device="cpu")
    try:
        with pytest.raises(ValueError, match="batch of 2"):
            eng.generate(prompts, n_tokens=2)
        assert len(eng.kv.free_slots()) == 2
    finally:
        eng.shutdown()


def test_kv_cache_manager_slots_and_prefill_write(setup):
    tb, _, _, _, _, _ = setup
    from repro_torch.serving.kv_cache import KVCacheManager
    kv = KVCacheManager(tb, 3, 32, device="cpu")
    assert kv.caches["l0"]["state"].shape == (1, 3, 4, 64, 64)
    a = kv.assign(request_id=7, prompt_len=5)
    b = kv.assign(request_id=8, prompt_len=9)
    assert (a, b) == (0, 1) and kv.lengths().tolist() == [5, 9, 0]
    one = tb.cache_init(1, 32, dtype=torch.float32, device="cpu")
    one = {k: {n: torch.full_like(t, 2.5) for n, t in c.items()}
           for k, c in one.items()}
    kv.write_prefill(2, one)
    st = kv.caches["l1"]["state"]
    assert torch.equal(st[:, 2], torch.full_like(st[:, 2], 2.5))
    assert not st[:, :2].any()
    assert kv.caches["l1"]["x_tm"].dtype == torch.bfloat16
    kv.release(a)
    assert kv.free_slots() == [0, 2]
    kv.assign(1, 1)
    kv.assign(2, 1)
    with pytest.raises(RuntimeError, match="no free"):
        kv.assign(3, 1)


def test_launcher_serves_text_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "text", "--arch", "rwkv6-7b", "--device", "cpu", "--requests", "2",
         "--tokens", "6"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("generated [") == 2
    assert "text_decode_steps=10" in out.stdout


@pytest.mark.cuda
def test_text_engine_on_gpu_launches_k5_per_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_scan import ops as scan
    cfg = reduced_config("rwkv6-7b")
    tb = build_model(cfg)
    params = tb.init(torch.Generator(device="cuda").manual_seed(0))
    eng = create_engine("text", tb, params, batch=2, max_len=64)
    try:
        before = scan.rwkv6_scan.launches
        out = eng.generate([np.arange(40, dtype=np.int32)] * 2, n_tokens=5)
        assert scan.rwkv6_scan.launches - before == cfg.n_layers
    finally:
        eng.shutdown()
    assert [len(o) for o in out] == [5, 5]
