"""The other text families of the port against the JAX package, on the
CPU at their reduced configs.  This file: the Mamba + MoE hybrid
(jamba-v0.1-52b: a ``mamba`` layer with a dense FFN, an ``attn`` layer
with MoE); ``tests/test_torch_families_moe.py``: the MoE models
(kimi-k2-1t-a32b, llama4-maverick-400b-a17b);
``tests/test_torch_families_vlm_audio.py``: the vision model
(llava-next-mistral-7b, with and without stub patch embeddings), the audio
encoder-decoder (seamless-m4t-large-v2) and the two QKV-bias dense models
(qwen2-72b, qwen1.5-32b); ``tests/test_torch_families_serving.py``: the
text engine and the launcher on every decoder family.  The shared helpers
live here.

Each bundle's prefill into caches and three decode steps against JAX's
under ``reference``, ``chunked`` and ``pallas`` (JAX's Pallas kernels in
interpret mode, the port's wrappers on their plain versions), weights
carried across by ``tree.params_from_jax``; the port of
``tests/test_configs_smoke.py::test_reduced_decode_matches_prefill``;
``params_from_jax`` and the port's own ``init`` giving JAX's trees; the
MoE aux losses summed over the stack.  Tolerances (ROADMAP.md, numeric
contract): f32 within 1e-5, kernel paths within 5e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models.model import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.tree import leaves, params_from_jax

torch.set_num_threads(1)
F32_TOL = 1e-5
KERNEL_TOL = 5e-3
N_FRAMES = 16        # the audio prefill's stub frames (reduced)
N_PATCHES = 16       # the vision prefill's stub patches (frontend_tokens)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


class _Jitted:
    """A JAX bundle's ``prefill`` and ``decode_step`` jitted (one compile
    per shape and impl, not one per op; f32 results move by ulps)."""

    def __init__(self, jb):
        self.cache_init = jb.cache_init
        self.prefill = jax.jit(jb.prefill, static_argnames=("impl",))
        self.decode_step = jax.jit(jb.decode_step,
                                   static_argnames=("impl",))


@functools.lru_cache(maxsize=None)
def load(arch: str):
    """(JAX cfg, jitted JAX bundle, JAX f32 params, port bundle, port f32
    params, JAX params as drawn) of the reduced ``arch``."""
    jcfg = j_reduced_config(arch)
    jb = j_build_model(jcfg)
    jparams, _ = jb.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tb = build_model(reduced_config(arch))
    t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    return jcfg, _Jitted(jb), j32, tb, t32, jparams


def _inputs(cfg, b, s, rng, patches: bool):
    """(JAX batch, port batch, positions before the prompt's tokens)."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.as_tensor(toks).long()}
    extra, lead = None, 0
    if cfg.enc_dec:
        extra = "frames", rng.standard_normal((b, N_FRAMES, cfg.d_model))
    elif patches:
        extra = "patch_embeds", rng.standard_normal((b, N_PATCHES,
                                                     cfg.d_model))
        lead = N_PATCHES
    if extra:
        name, a = extra
        jbatch[name] = jnp.asarray(a, jnp.float32)
        tbatch[name] = torch.as_tensor(a.astype(np.float32))
    return jbatch, tbatch, lead


def check_bundle(arch, patches, impl):
    """A prompt (after 16 stub patches, or beside 16 stub frames) into
    caches, then three decode steps, ``impl`` on both sides: 40 tokens, and
    300 under ``chunked``, whose attention takes the chunked route past
    256 x 256 (below it both packages' ``chunked`` is the reference)."""
    jcfg, jb, j32, tb, t32, _ = load(arch)
    tol = KERNEL_TOL if impl == "pallas" else F32_TOL
    rng = np.random.default_rng(11)
    b, s = 2, 300 if impl == "chunked" else 40
    jbatch, tbatch, lead = _inputs(jcfg, b, s, rng, patches)
    max_len = lead + s + 8
    kw = {"n_frames": N_FRAMES} if jcfg.enc_dec else {}
    jc, _ = jb.cache_init(b, max_len, dtype=jnp.float32, **kw)
    tc = tb.cache_init(b, max_len, dtype=torch.float32, device="cpu", **kw)
    jl, jc = jb.prefill(j32, jbatch, impl=impl, caches=jc)
    with torch.inference_mode():
        tl, tc = tb.prefill(t32, tbatch, impl=impl, caches=tc)
    assert tl.shape == (b, lead + s, jcfg.vocab_size)
    _close(tl, jl, tol)
    for got, want in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(got, want, tol)
    for step in range(3):
        nt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        cur = lead + s + step
        jl, jc = jb.decode_step(j32, jc, {"tokens": jnp.asarray(nt),
                                          "cur_index": jnp.int32(cur)},
                                impl=impl)
        with torch.inference_mode():
            tl, tc = tb.decode_step(t32, tc, {
                "tokens": torch.as_tensor(nt).long(),
                "cur_index": torch.tensor(cur)}, impl=impl)
        _close(tl, jl, tol)


IMPLS = ("reference", "chunked", "pallas")
ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("impl", IMPLS)
def test_bundle_prefill_and_decode_match_jax(impl):
    """At 300 tokens the Mamba layer scans two chunks, the second padded."""
    check_bundle(ARCH, False, impl)


def check_decode_matches_prefill(arch):
    """The port of the JAX smoke test: one decode step with a cache ==
    the last position of a one-token-longer prefill, on the port's own
    bf16 weights, at the JAX test's tolerance."""
    b, s = 2, 64
    cfg = reduced_config(arch)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s))).long()}
    kw = {}
    if cfg.enc_dec:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        kw = {"n_frames": 16}
    with torch.inference_mode():
        caches = bundle.cache_init(b, s + 4, device="cpu", **kw)
        _, caches2 = bundle.prefill(params, batch, caches=caches,
                                    impl="reference")
        nt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1))).long()
        logits_dec, _ = bundle.decode_step(
            params, caches2, {"tokens": nt, "cur_index": s})
        b2 = dict(batch, tokens=torch.cat([batch["tokens"], nt], dim=1))
        logits_full = bundle.prefill(params, b2, impl="reference")
    np.testing.assert_allclose(logits_full[:, -1].float().numpy(),
                               logits_dec[:, 0].float().numpy(), atol=0.06,
                               rtol=0.05)


def test_reduced_decode_matches_prefill():
    """jamba: the ssm and conv caches of its Mamba layer, its attention
    layer's K / V, its MoE."""
    check_decode_matches_prefill(ARCH)


def _jax_tree_desc(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in flat]


def _desc(tree, prefix=""):
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _desc(tree[k],
                                                       f"{prefix}['{k}']")]
    return [(prefix, tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


def check_trees(arch):
    """``params_from_jax`` carries JAX's tree unchanged (bf16 leaves as
    bf16, f32 ones as f32), and the port's own ``init`` draws the same
    names, shapes and dtypes; the caches too."""
    jcfg, jb, _, tb, _, jparams = load(arch)
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    want = _jax_tree_desc(jparams)
    assert _desc(bridged) == want
    own = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert _desc(own) == want
    for got, w in zip(leaves(bridged), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(got.float().numpy(), _np(w))
    kw = {"n_frames": 24} if jcfg.enc_dec else {}
    jc, _ = jb.cache_init(2, 32, **kw)
    assert _desc(tb.cache_init(2, 32, device="cpu", **kw)) \
        == _jax_tree_desc(jc)


def test_init_and_weight_bridge_give_jax_trees():
    """The f32 router and ``a_log``, the stacked [G, E, d, f] experts, the
    Mamba block's parameters and caches."""
    check_trees(ARCH)


def check_aux_sums(arch):
    """``stack_apply`` returns the MoE layers' aux losses summed over the
    stack: JAX's sums."""
    from repro.models import transformer as JT
    jcfg, _, j32, tb, t32, _ = load(arch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    _, _, jaux = JT.stack_apply(j32["stack"], jnp.asarray(x), jcfg,
                                mode="prefill", positions=jnp.asarray(pos))
    with torch.inference_mode():
        _, _, taux = T.stack_apply(t32["stack"], torch.as_tensor(x), tb.cfg,
                                   mode="prefill",
                                   positions=torch.as_tensor(pos))
    assert taux.keys() == jaux.keys()
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=F32_TOL, atol=F32_TOL)
    assert float(taux["load_balance_loss"]) > 0


def test_moe_aux_sums_over_the_stack():
    """jamba's MoE ``attn`` layer; zeros for a stack without MoE."""
    check_aux_sums(ARCH)
    cfg = reduced_config("qwen2-72b")
    tb = build_model(cfg)
    params = tb.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        _, _, aux = T.stack_apply(params["stack"],
                                  torch.zeros((1, 4, cfg.d_model),
                                              dtype=torch.bfloat16), cfg,
                                  mode="prefill",
                                  positions=torch.arange(4)[None])
    assert all(float(v) == 0.0 for v in aux.values())


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch inside functions)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_smoke_f32_route_is_the_bundle_on_f32_weights():
    """``chip_smoke.py``'s f32 route (each layer's weights upcast as it
    runs), which holds jamba's pallas prefill on the card, computes the
    bf16 bundle as the bundle computes on an f32 copy of its weights, with
    the MoE routing replayed; replaying a route's own routing changes
    nothing; and the smoke's gate function passes on the CPU."""
    from repro_torch.tree import tree_map
    cs = _chip_smoke()
    cfg = reduced_config(ARCH)
    tb = build_model(cfg)
    params = tb.init(torch.Generator().manual_seed(0), device="cpu")
    up = tree_map(lambda t: t.float(), params)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 24)
    tok = {"tokens": torch.as_tensor(prompt[None]).long()}
    with torch.inference_mode():
        with cs.moe_routing() as routes:
            bf = tb.prefill(params, tok, impl="chunked")
        with cs.moe_routing(routes):
            again = tb.prefill(params, tok, impl="chunked")
        with cs.moe_routing(routes):
            want = tb.prefill(up, tok, impl="chunked")
        with cs.moe_routing(routes), cs.f32_route():
            got = tb.prefill(params, tok, impl="chunked")
    assert len(routes) == cfg.n_groups and torch.equal(again, bf)
    assert got.dtype == torch.float32 and bf.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    assert float((got - bf.float()).abs().max()) > 0
    line = cs.text_attn_gates(tb, params, prompt, "cpu", "test")
    assert "f32 chunked route" in line


@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
def test_smoke_moe_greedy_drops_nothing(arch):
    """``chip_smoke.py``'s MoE greedy check on the CPU: at capacity factor
    num_experts / top_k nothing drops, and the text engine's tokens equal
    an eager decode loop's and repeated prefills (the helper fails
    otherwise)."""
    cs = _chip_smoke()
    cfg = reduced_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               20).astype(np.int32)
    msg = cs.moe_greedy(cfg, params, prompt, "cpu", "test")
    assert "none dropped an assignment" in msg
