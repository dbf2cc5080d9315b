"""The port's five examples (``examples/torch_*.py``) on the CPU.

Each runs in a subprocess at its small size with ``--device cpu``, all five
at once, and must exit 0 and print its own checks OK.  The quickstart's
scores are held to the JAX quickstart's forward on the same parameters
(f32, carried across by ``tree.params_from_jax``) within 1e-5, and an
example run without ``--device cpu`` exits non-zero where there is no GPU
(the entry points default to the card).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.models.model import build_model
from repro_torch.tree import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
#: example -> (its extra flags, the line it prints when its checks pass)
EXAMPLES = {
    "torch_quickstart": (["--impl", "pallas"], "quickstart checks"),
    "torch_serve_e2e": ([], "serve_e2e checks"),
    "torch_mixed_traffic_dso": ([], "mixed_traffic_dso checks"),
    "torch_text_serving": (["--arch", "rwkv6-7b"], "text_serving checks"),
    "torch_train_climber": ([], "train_climber checks"),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"     # five at once share the cores
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """All five examples started together (the first test that asks
    starts them, and runs while they do); name -> a function that waits
    for that example and returns (returncode, stdout, stderr)."""
    tmp = tmp_path_factory.mktemp("examples")
    procs, done = {}, {}
    for name, (flags, _) in EXAMPLES.items():
        extra = ["--ckpt", str(tmp / "ckpt.msgpack")] \
            if name == "torch_train_climber" else []
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"),
             "--device", "cpu", "--small", *flags, *extra],
            env=_env(), cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(name):
        if name not in done:
            stdout, stderr = procs[name].communicate(timeout=TIMEOUT_S)
            done[name] = (procs[name].returncode, stdout, stderr)
        return done[name]
    try:
        yield result
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_jax_quickstart(runs):
    """The port's quickstart forward against the JAX quickstart's (its
    config, its inputs, ``bundle.prefill`` under its default impl) on the
    same weights, cast to f32 on both sides (while the examples run)."""
    qs = _load("torch_quickstart")
    jcfg = dataclasses.replace(
        j_get_config("climber"), vocab_size=10_000, d_model=128, d_ff=512,
        n_heads=4, n_kv_heads=4, head_dim=32,
        climber=JClimberConfig(num_blocks=2, layers_per_block=2,
                               num_tasks=3))
    jbundle = j_build_model(jcfg)
    jparams, _ = jbundle.init(jax.random.key(0))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    rng = np.random.default_rng(0)     # the JAX quickstart's batch
    jbatch = {
        "history": jnp.asarray(rng.integers(0, jcfg.vocab_size, (1, 128)),
                               jnp.int32),
        "candidates": jnp.asarray(rng.integers(0, jcfg.vocab_size, (1, 32)),
                                  jnp.int32),
        "side": jnp.asarray(rng.standard_normal((1, 12)), jnp.float32),
    }
    want = np.asarray(jax.jit(jbundle.prefill)(j32, jbatch))

    cfg = qs.quickstart_config()
    t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    batch = qs.quickstart_batch(cfg)
    for k in batch:
        np.testing.assert_array_equal(np.asarray(batch[k], np.float32),
                                      np.asarray(jbatch[k], np.float32))
    got = qs.score(build_model(cfg), t32, batch, torch.device("cpu"))
    assert got.shape == want.shape == (1, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(runs, name):
    rc, stdout, stderr = runs(name)
    assert rc == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith(EXAMPLES[name][1])]
    assert len(line) == 1 and line[0].endswith(": OK"), stdout[-3000:]


def test_example_without_device_flag_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract does not apply")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S,
        cwd=ROOT)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "checks" not in out.stdout
