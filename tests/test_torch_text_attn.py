"""The attention text kinds (``attn`` / ``swa`` layers, ring and int8
caches) of the port against the JAX package, on the CPU at
``reduced_config("gemma3-12b")`` (pattern ``swa``, ``attn``; head dim 64,
window 64) and ``reduced_config("h2o-danube-3-4b")`` (``swa`` twice).

Inputs come from a numpy seed; the JAX weights are carried across by
``tree.params_from_jax``.  Tolerances (ROADMAP.md, numeric contract): f32
paths within 1e-5, kernel paths (``impl="pallas"``, JAX's Pallas kernels in
interpret mode, the port's plain versions) within 5e-3, int8 caches within
5e-2; greedy tokens token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model
from repro.serving.engine import TextServingEngine as JTextServingEngine
from repro_torch.configs import reduced_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.serving import ServeRequest, create_engine
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.tree import leaves, params_from_jax

torch.set_num_threads(1)
ARCHS = ("gemma3-12b", "h2o-danube-3-4b")
F32_TOL = 1e-5       # fp32 paths
KERNEL_TOL = 5e-3    # kernel paths (pallas)
INT8_TOL = 5e-2      # int8 caches
N_TOKENS = 6


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def bundles():
    """Per arch: (JAX cfg, JAX bundle, JAX f32 params, port bundle, port
    f32 params)."""
    out = {}
    for arch in ARCHS:
        jcfg = j_reduced_config(arch)
        jb = j_build_model(jcfg)
        jparams, _ = jb.init(jax.random.key(0))
        j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        tb = build_model(reduced_config(arch))
        t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
        out[arch] = (jcfg, jb, j32, tb, t32)
    return out


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_jax(window, per_row):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    cur = np.array([30, 1, 40], np.int32) if per_row else 30
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(cur),
                               window=window)
    got = A.decode_attention(_t(q), _t(kc), _t(vc), torch.as_tensor(cur),
                             window=window)
    _close(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# _attn_layer: prefill (sliding / causal) and decode, ring and non-ring
# caches, native and int8
# ---------------------------------------------------------------------------

def _layer_params(arch, kind_index):
    jcfg = j_reduced_config(arch)
    jp, _ = JL.split_params(JA.qkv_init(jax.random.key(3 + kind_index),
                                        jcfg))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, {"attn": jp}, {"attn": params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")}


def _cache(cfg, kind, b, max_len, quant, jax_side):
    clen = T.cache_len(cfg, kind, max_len)
    shape = (b, clen, cfg.n_kv_heads, cfg.head_dim)
    if jax_side:
        if quant:
            return {"k": jnp.zeros(shape, jnp.int8),
                    "v": jnp.zeros(shape, jnp.int8),
                    "k_scale": jnp.zeros(shape[:-1] + (1,), jnp.bfloat16),
                    "v_scale": jnp.zeros(shape[:-1] + (1,), jnp.bfloat16)}
        return {"k": jnp.zeros(shape, jnp.float32),
                "v": jnp.zeros(shape, jnp.float32)}
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8),
                "v": torch.zeros(shape, dtype=torch.int8),
                "k_scale": torch.zeros(shape[:-1] + (1,),
                                       dtype=torch.bfloat16),
                "v_scale": torch.zeros(shape[:-1] + (1,),
                                       dtype=torch.bfloat16)}
    return {"k": torch.zeros(shape), "v": torch.zeros(shape)}


def _dequant(c, jax_side):
    if "k_scale" not in c:
        return (_np(c["k"]), _np(c["v"])) if jax_side else (
            c["k"].float().numpy(), c["v"].float().numpy())
    if jax_side:
        return tuple(_np(c[n]) * _np(c[n + "_scale"]) for n in ("k", "v"))
    return tuple((c[n].float() * c[n + "_scale"].float()).numpy()
                 for n in ("k", "v"))


@pytest.mark.parametrize("arch,kind", [("gemma3-12b", "swa"),
                                       ("gemma3-12b", "attn"),
                                       ("h2o-danube-3-4b", "swa")])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [40, 100])
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_attn_layer_prefill_and_decode_match_jax(arch, kind, quant, s,
                                                 impl):
    """A prompt of ``s`` tokens into caches of ``max_len`` 128 (a ``swa``
    ring holds 64 slots: at s = 100 it rolls), then three decode steps.
    ``swa`` prefills with the ``sliding`` mask, ``attn`` with ``causal``;
    a ``swa`` cache decodes as a ring (``decode_attention``), an ``attn``
    cache under pallas through K4's single-token form."""
    jcfg, jp, tp = _layer_params(arch, 0 if kind == "swa" else 1)
    cfg = reduced_config(arch)
    rng = np.random.default_rng(7)
    b, max_len = 2, 128
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jc = _cache(jcfg, kind, b, max_len, quant, True)
    tc = _cache(cfg, kind, b, max_len, quant, False)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    tol = KERNEL_TOL if impl == "pallas" else F32_TOL
    jy, jc = JT._attn_layer(jp, jnp.asarray(x), jcfg, kind, mode="prefill",
                            positions=jnp.asarray(pos), cache=jc, cur_len=s,
                            impl=impl, mask_mode="causal")
    ty, tc = T._attn_layer(tp, _t(x), cfg, kind, mode="prefill",
                           positions=torch.as_tensor(pos), cache=tc,
                           cur_len=s, impl=impl, mask_mode="causal")
    _close(ty, jy, tol)
    for got, want in zip(_dequant(tc, False), _dequant(jc, True)):
        np.testing.assert_allclose(got, want, atol=INT8_TOL if quant
                                   else tol, rtol=tol)
    for step in range(3):
        cur = s + step
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JT._attn_layer(jp, jnp.asarray(x1), jcfg, kind,
                                mode="decode",
                                positions=jnp.full((b, 1), cur, jnp.int32),
                                cache=jc, cur_len=cur + 1, impl=impl,
                                mask_mode="causal")
        ty, tc = T._attn_layer(tp, _t(x1), cfg, kind, mode="decode",
                               positions=torch.full((b, 1), cur),
                               cache=tc, cur_len=torch.tensor(cur + 1),
                               impl=impl, mask_mode="causal")
        _close(ty, jy, INT8_TOL if quant else tol)


def test_quantize_kv_rounds_half_to_even_as_jax():
    """Codes at exact ties (x / scale = k + 0.5) round to even in both."""
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -2.5]]]],
                 np.float32)
    jq, js = JT._quantize_kv(jnp.asarray(x))
    tq, ts = T._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16


def test_init_caches_ring_lengths_and_int8_layout():
    cfg = reduced_config("gemma3-12b")
    c = T.init_caches(cfg, 3, 200, device="cpu")
    assert c["l0"]["k"].shape == (1, 3, 64, 2, 64)       # swa: a ring of 64
    assert c["l1"]["k"].shape == (1, 3, 200, 2, 64)      # attn: max_len
    q = T.init_caches(cfg, 3, 40, device="cpu", quant=True)
    assert q["l0"]["k"].shape == (1, 3, 40, 2, 64)       # min(64, 40)
    assert q["l0"]["k"].dtype == torch.int8
    assert q["l1"]["v_scale"].shape == (1, 3, 40, 2, 1)
    j, _ = JT.init_caches(j_reduced_config("gemma3-12b"), 3, 40, quant=True)
    assert [tuple(a.shape) for a in leaves(q)] == [
        tuple(a.shape) for a in jax.tree.leaves(j)]


# ---------------------------------------------------------------------------
# the text bundle: prefill and decode under reference / chunked / pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,s", [("reference", 100), ("chunked", 300),
                                    ("pallas", 100)])
def test_bundle_prefill_and_decode_match_jax(bundles, arch, impl, s):
    """Prefill into caches (``chunked`` at 300 tokens runs the chunked
    sliding route), then three decode steps, each impl on both sides."""
    jcfg, jb, j32, tb, t32 = bundles[arch]
    tol = KERNEL_TOL if impl == "pallas" else F32_TOL
    rng = np.random.default_rng(11)
    b, max_len = 2, s + 8
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jc, _ = jb.cache_init(b, max_len, dtype=jnp.float32)
    tc = tb.cache_init(b, max_len, dtype=torch.float32, device="cpu")
    jl, jc = jb.prefill(j32, {"tokens": jnp.asarray(toks)}, impl=impl,
                        caches=jc)
    with torch.inference_mode():
        tl, tc = tb.prefill(t32, {"tokens": torch.as_tensor(toks).long()},
                            impl=impl, caches=tc)
    _close(tl, jl, tol)
    for step in range(3):
        nt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = jb.decode_step(j32, jc, {"tokens": jnp.asarray(nt),
                                          "cur_index": jnp.int32(s + step)},
                                impl=impl)
        with torch.inference_mode():
            tl, tc = tb.decode_step(t32, tc, {
                "tokens": torch.as_tensor(nt).long(),
                "cur_index": torch.tensor(s + step)}, impl=impl)
        _close(tl, jl, tol)


def test_bundle_defaults_are_the_jax_ones(bundles):
    import inspect
    tb = bundles["gemma3-12b"][3]
    assert inspect.signature(tb.prefill).parameters["impl"].default \
        == "chunked"
    assert inspect.signature(tb.decode_step).parameters["impl"].default \
        == "reference"


# ---------------------------------------------------------------------------
# TextServingEngine against the JAX engine
# ---------------------------------------------------------------------------

def _first_mismatch_report(tb, t32, prompt, got, want):
    """Where greedy tokens differ, the port's top-2 logit gap at that step
    (a near tie is reported, not gated)."""
    seq = list(prompt) + [int(t) for t in want]
    i = next(i for i, (a, c) in enumerate(zip(got, want)) if a != c)
    with torch.inference_mode():
        lg = tb.prefill(t32, {"tokens": torch.tensor([seq[:len(prompt)
                                                          + i]])})
    top = torch.topk(lg[0, -1].float(), 2).values
    return i, float(top[0] - top[1])


def _assert_tokens(tb, t32, prompt, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want):
        i, gap = _first_mismatch_report(tb, t32, prompt, got, want)
        assert gap < 1e-4, (f"tokens differ at step {i} (top-2 gap {gap}): "
                            f"{got} vs {want}")
        print(f"near tie at step {i}: top-2 gap {gap}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_and_submit_match_jax_engine(bundles, arch):
    """``generate`` of three 60-token prompts (the ``swa`` rings wrap while
    decoding past the reduced window of 64) and ``submit`` of a 100-token
    prompt (its prefill rolls the ring), against the JAX engine."""
    jcfg, jb, j32, tb, t32 = bundles[arch]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, 60).astype(np.int32)
               for _ in range(3)]
    single = rng.integers(0, jcfg.vocab_size, 100).astype(np.int32)
    jeng = JTextServingEngine(jb, j32, batch=4, max_len=128)
    try:
        jouts = jeng.generate(prompts, n_tokens=N_TOKENS)
        jsingle = jeng.generate([single], n_tokens=N_TOKENS)[0]
    finally:
        jeng.shutdown()
    eng = create_engine("text", tb, t32, batch=4, max_len=128, device="cpu")
    try:
        outs = eng.generate(prompts, n_tokens=N_TOKENS)
        res = eng.submit(ServeRequest(history=single,
                                      n_tokens=N_TOKENS)).result(timeout=300)
    finally:
        eng.shutdown()
    for p, o, j in zip(prompts, outs, jouts):
        _assert_tokens(tb, t32, p, o, j)
    _assert_tokens(tb, t32, single, res.output, jsingle)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_repeated_prefill(bundles, arch):
    """The engine's decode loop (the ring's slot writes, K4's form on the
    CPU plain path) equals re-prefilling the growing sequence."""
    _, _, _, tb, t32 = bundles[arch]
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, tb.cfg.vocab_size, 62).astype(np.int32)
    eng = create_engine("text", tb, t32, batch=2, max_len=72, device="cpu")
    try:
        out = eng.generate([prompt], n_tokens=5)[0]
    finally:
        eng.shutdown()
    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(5):
            lg = tb.prefill(t32, {"tokens": torch.tensor([seq])},
                            impl="pallas")
            seq.append(int(torch.argmax(lg[0, -1])))
    np.testing.assert_array_equal(np.array(seq[-5:]), out)


def test_kv_cache_manager_passes_quant_through(bundles):
    tb = bundles["h2o-danube-3-4b"][3]
    kv = KVCacheManager(tb, 2, 32, device="cpu", quant=True)
    assert kv.caches["l0"]["k"].dtype == torch.int8
    assert kv.caches["l1"]["k_scale"].shape == (1, 2, 32, 1, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_attention_archs_on_cpu(arch):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "text", "--arch", arch, "--device", "cpu", "--requests", "2",
         "--tokens", "6"],
        env=env, capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"reduced {arch}" in out.stdout
    assert out.stdout.count("generated [") == 2
    assert "text_decode_steps=10" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_text_engine_on_gpu_launches_k2_k3_k4(arch):
    """On the card the engine's prefill launches K2 and K3 once a layer and
    each captured decode step K3 once a layer and K4's single-token form
    once an ``attn`` layer (a ``swa`` ring decodes in plain PyTorch); K3's
    counter adds the kernels of each call (``kernel_launches``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    cfg = reduced_config(arch)
    tb = build_model(cfg)
    params = tb.init(torch.Generator(device="cuda").manual_seed(0))
    eng = create_engine("text", tb, params, batch=2, max_len=96)
    n_tokens = 5
    try:
        before = (fa.flash_attention.launches, ff.fused_ffn_2d.launches,
                  fd.flash_decode.launches)
        out = eng.generate([np.arange(70, dtype=np.int32)] * 2,
                           n_tokens=n_tokens)
        after = (fa.flash_attention.launches, ff.fused_ffn_2d.launches,
                 fd.flash_decode.launches)
    finally:
        eng.shutdown()
    n_attn = cfg.n_groups * cfg.layer_pattern.count("attn")
    k3 = ff.kernel_launches(140, cfg.d_model) + (n_tokens - 1) \
        * ff.kernel_launches(2, cfg.d_model)
    assert [a - b for a, b in zip(after, before)] == [
        cfg.n_layers, cfg.n_layers * k3, n_attn * (n_tokens - 1)]
    assert [len(o) for o in out] == [n_tokens, n_tokens]


@pytest.mark.cuda
def test_int8_caches_on_gpu_within_contract():
    """Prefill and three decode steps under pallas on the card with int8
    caches against the same with native caches: logits within the int8
    tolerance of their scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cfg = reduced_config("gemma3-12b")
    tb = build_model(cfg)
    params = tb.init(torch.Generator(device="cuda").manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    got = {}
    with torch.inference_mode():
        for quant in (False, True):
            c = tb.cache_init(2, 112, device="cuda", quant=quant)
            lg, c = tb.prefill(params, {"tokens": toks}, impl="pallas",
                               caches=c)
            steps = [lg[:, -1]]
            for i in range(3):        # the same tokens on both sides
                lg, c = tb.decode_step(params, c, {
                    "tokens": toks[:, i:i + 1], "cur_index": torch.tensor(
                        100 + i, device="cuda")}, impl="pallas")
                steps.append(lg[:, -1])
            got[quant] = torch.stack(steps).float()
    scale = got[False].abs().max()
    assert float((got[True] - got[False]).abs().max() / scale) < INT8_TOL
