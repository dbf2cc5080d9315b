"""The port's training substrate against the JAX package's, on the CPU:
AdamW (its arithmetic over several steps, ``global_norm``, the warm-up
schedule, and the ports of ``tests/test_training.py``'s convergence and
clip tests) and checkpoints (the port's file byte-identical to JAX's
``checkpoint.save`` of the same values, restores both ways, a missing key,
bf16), the synthetic data bitwise, and the msgpack subset against
``msgpack`` itself.  Tolerances: f32 parameters within 1e-6, bf16
parameters within one bf16 ulp.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.data import GRInteractionDataset as JGR
from repro.data import TokenDataset as JTok
from repro.data import make_batch_iterator as j_batches
from repro.models import build_model as j_build_model
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import _schedule as j_schedule
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import global_norm as j_global_norm
from repro_torch.data import (GRInteractionDataset, TokenDataset,
                              make_batch_iterator)
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (AdamWConfig, _schedule,
                                            adamw_init, adamw_update,
                                            global_norm)
from repro_torch.tree import leaves, params_from_jax

torch.set_num_threads(1)


def _tree(rng, dtype):
    """A small nested tree: a 2-D weight, a stacked 3-D one, a vector and
    a scalar-like leaf."""
    shapes = {"dense": {"w": (6, 5), "b": (5,)}, "stack": {"w": (3, 4, 2)},
              "scale": (1,)}

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    t = build(shapes)
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


def _to_port(t):
    return params_from_jax(jax.tree.map(np.asarray, t), device="cpu")


def _ulp_bf16(x):
    """One bf16 ulp at each element of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_steps(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = _tree(rng, jdt)
    tp = _to_port(jp)
    jcfg = JAdamWConfig(lr=3e-2, warmup_steps=3, grad_clip=0.5)
    tcfg = AdamWConfig(lr=3e-2, warmup_steps=3, grad_clip=0.5)
    jopt, topt = j_adamw_init(jp), adamw_init(tp)
    step = jax.jit(lambda g, o, p: j_adamw_update(jcfg, g, o, p))
    for _ in range(6):
        jg = _tree(rng, jdt)
        jp, jopt, jm = step(jg, jopt, jp)
        tp, topt, tm = adamw_update(tcfg, _to_port(jg), topt, tp)
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in zip(leaves(tp), jax.tree.leaves(jp)):
            assert str(got.dtype).endswith(dtype)
            g = got.float().numpy()
            w = np.asarray(want, np.float32)
            tol = 1e-6 if dtype == "float32" else _ulp_bf16(w)
            assert np.all(np.abs(g - w) <= tol), np.abs(g - w).max()
        for name in ("mu", "nu"):
            for got, want in zip(leaves(topt[name]),
                                 jax.tree.leaves(jopt[name])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7)
    assert int(topt["step"]) == int(jopt["step"]) == 6


def test_adamw_slices_large_leaves_without_changing_values(monkeypatch):
    """A leaf past ``SLICE_ELEMENTS`` is updated a slice of its leading
    axis at a time: the values equal the whole-leaf update bitwise."""
    from repro_torch.training import optimizer as O
    g = torch.Generator().manual_seed(3)
    p = {"w": torch.randn(7, 6, 5, generator=g).to(torch.bfloat16),
         "v": torch.randn(11, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in p.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    whole = {k: v.clone() for k, v in p.items()}
    ow = adamw_init(whole)
    adamw_update(cfg, grads, ow, whole)
    monkeypatch.setattr(O, "SLICE_ELEMENTS", 64)
    assert len(list(O._slices(p["w"]))) > 1
    sliced = {k: v.clone() for k, v in p.items()}
    osl = adamw_init(sliced)
    _, _, m = adamw_update(cfg, grads, osl, sliced)
    for k in p:
        assert torch.equal(whole[k], sliced[k])
        assert torch.equal(ow["mu"][k], osl["mu"][k])
        assert torch.equal(ow["nu"][k], osl["nu"][k])


def test_schedule_and_global_norm_match_jax():
    jcfg, tcfg = JAdamWConfig(lr=1e-3, warmup_steps=7), \
        AdamWConfig(lr=1e-3, warmup_steps=7)
    for s in (0, 1, 3, 6, 7, 50):
        want = float(j_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert got == want, (s, got, want)
    assert abs(float(global_norm({"a": torch.tensor([3.0]),
                                  "b": torch.tensor([4.0])})) - 5.0) < 1e-6
    rng = np.random.default_rng(1)
    jt = _tree(rng, jnp.bfloat16)
    np.testing.assert_allclose(float(global_norm(_to_port(jt))),
                               float(j_global_norm(jt)), rtol=1e-6)


def test_adamw_quadratic_convergence():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    _, _, m = adamw_update(cfg, {"w": torch.full((3,), 100.0)}, opt, params)
    assert float(m["grad_norm"]) > 100.0
    assert torch.equal(params["w"], torch.zeros(3))


def test_synthetic_data_is_the_jax_packages_bitwise():
    want = next(j_batches(JGR(n_items=500, n_users=50, seed=3), 3, seed=4,
                          n_history=16, n_candidates=5))
    got = next(make_batch_iterator(GRInteractionDataset(
        n_items=500, n_users=50, seed=3), 3, seed=4, n_history=16,
        n_candidates=5))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    want = next(j_batches(JTok(vocab_size=97, branching=4), 2, seq_len=20))
    got = next(make_batch_iterator(TokenDataset(vocab_size=97, branching=4),
                                   2, seq_len=20))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def _packb(obj) -> bytes:
    """The codec's encoding of ``obj``, as ``checkpoint.save`` writes it."""
    out = []
    checkpoint._pack(obj, out)
    return b"".join(bytes(x) for x in out)


def test_msgpack_subset_matches_msgpack():
    payload = {"step": 70000, "neg": [-1, -33, -200, -70000, -2**40],
               "big": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63],
               "s": ["", "x" * 31, "y" * 32, "z" * 300, "é" * 40000],
               "b": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000],
               "m": {f"k{i}": i for i in range(17)}, "a": list(range(20)),
               "fix": {f"k{i}": i for i in range(3)}}
    want = msgpack.packb(payload, use_bin_type=True)
    assert _packb(payload) == want
    back = checkpoint.unpackb(want)
    back["b"] = [bytes(x) for x in back["b"]]
    assert back == msgpack.unpackb(want, raw=False)
    with pytest.raises(TypeError):
        _packb({"x": 1.5})


@pytest.fixture(scope="module")
def gemma():
    jb = j_build_model(j_reduced_config("gemma3-12b"))
    jparams, _ = jb.init(jax.random.key(0))
    return jparams


def test_checkpoint_file_is_jax_bytewise(gemma, tmp_path):
    jp = os.path.join(tmp_path, "jax.msgpack")
    tp = os.path.join(tmp_path, "port.msgpack")
    jckpt.save(jp, gemma, step=42)
    checkpoint.save(tp, _to_port(gemma), step=42)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()


def test_checkpoints_restore_both_ways(gemma, tmp_path):
    port = _to_port(gemma)
    jp = os.path.join(tmp_path, "jax.msgpack")
    jckpt.save(jp, gemma, step=7)
    like = {k: v for k, v in port.items()}
    got, step = checkpoint.restore(jp, like)
    assert step == 7
    for a, b in zip(leaves(got), leaves(port)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert any(t.dtype == torch.bfloat16 for t in leaves(got))
    tp = os.path.join(tmp_path, "port.msgpack")
    checkpoint.save(tp, port, step=9)
    back, jstep = jckpt.restore(tp, gemma)
    assert jstep == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(gemma)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_checkpoint_missing_key_raises(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"a": torch.zeros(2)}, step=0)
    with pytest.raises(KeyError):
        checkpoint.restore(path, {"a": torch.zeros(2), "b": torch.zeros(3)})
