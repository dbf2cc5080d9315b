"""Train, then serve, in the port on the CPU: the ports of
``tests/test_system.py``'s ``test_train_then_serve_pipeline`` and
``test_served_scores_track_planted_preferences`` (Climber trained on
planted-preference data, then served through the PDA -> DSO -> FKE engine
under ``run_workload``), the training launcher at a reduced config writing
a checkpoint, and the serving launcher restoring one.

The two system tests start from the JAX test's own weights (the JAX
``init`` of key 0, carried across by ``params_from_jax``), and the port's
30 training steps are held to the JAX package's on the same batches: each
step's loss within the 5e-3 bf16 contract.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import GRInteractionDataset as JGRInteractionDataset
from repro.data import make_batch_iterator as j_make_batch_iterator
from repro.models import build_model as j_build_model
from repro.training.loop import train as j_train
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.types import ClimberConfig as JClimberConfig
from repro_torch.configs import get_config
from repro_torch.core.climber import build_climber
from repro_torch.data import GRInteractionDataset, make_batch_iterator
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.serving import FlameEngine
from repro_torch.serving.scheduler import (TrafficConfig, generate_traffic,
                                           run_workload)
from repro_torch.training import checkpoint
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.tree import leaves, params_from_jax
from repro_torch.types import ClimberConfig

torch.set_num_threads(1)


SMALL = dict(vocab_size=5_000, d_model=64, d_ff=128, n_heads=2,
             n_kv_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def trained_climber():
    jcfg = dataclasses.replace(
        j_get_config("climber"), **SMALL,
        climber=JClimberConfig(num_blocks=2, layers_per_block=2))
    jbundle = j_build_model(jcfg)
    jparams, _ = jbundle.init(jax.random.key(0))
    # copied before the JAX loop donates (deletes) its parameters
    params = params_from_jax(jax.tree.map(np.array, jparams), device="cpu")
    _, _, jhist = j_train(
        jbundle, j_make_batch_iterator(
            JGRInteractionDataset(n_items=5_000, n_users=500, seed=0), 16,
            n_history=32, n_candidates=8), 30,
        JAdamWConfig(lr=3e-3, warmup_steps=5), log_every=1,
        impl="reference", params=jparams)
    cfg = dataclasses.replace(
        get_config("climber"), **SMALL,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    bundle = build_climber(cfg)
    ds = GRInteractionDataset(n_items=5_000, n_users=500, seed=0)
    it = make_batch_iterator(ds, 16, n_history=32, n_candidates=8)
    params, _, hist = train(bundle, it, 30, AdamWConfig(lr=3e-3,
                                                        warmup_steps=5),
                            log_every=1, impl="reference", params=params)
    return cfg, bundle, params, ds, hist, jhist


def test_training_tracks_the_jax_package(trained_climber):
    *_, hist, jhist = trained_climber
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for got, want in zip(hist, jhist):
        assert abs(got["loss"] - want["loss"]) <= 5e-3, (got, want)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=2e-2)


def test_train_then_serve_pipeline(trained_climber):
    cfg, bundle, params, ds, hist, _ = trained_climber
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert not any(p.requires_grad for p in leaves(params))
    eng = FlameEngine(bundle, params, n_history=32, buckets=(32, 16, 8),
                      n_streams=2, device="cpu")
    try:
        tc = TrafficConfig(n_requests=12, n_history=32,
                           candidate_counts=(8, 16, 24),
                           distribution="jittered", seed=1)
        reqs = generate_traffic(tc, n_items=5_000)
        res = run_workload(lambda h, c: eng.serve(h, c), reqs,
                           concurrency=3)
        assert res["requests"] == 12
        assert res["throughput_items_per_s"] > 0
        summary = eng.metrics()
        assert summary["requests"] == 12
        assert summary["p99_latency_ms"] >= summary["mean_latency_ms"] * 0.5
    finally:
        eng.shutdown()


def test_served_scores_track_planted_preferences(trained_climber):
    cfg, bundle, params, ds, _, _ = trained_climber
    rng = np.random.default_rng(7)
    pos, neg = [], []
    with torch.inference_mode():
        for _ in range(40):
            r = ds.sample_request(rng, 32, 8)
            batch = {k: torch.from_numpy(np.asarray(r[k]))[None]
                     for k in ("history", "candidates", "side")}
            scores = bundle.prefill(params, batch)[0].numpy()   # [M,T]
            lab = r["labels"]
            pos.extend(scores[lab[:, 0] > 0.5, 0].tolist())
            neg.extend(scores[lab[:, 0] < 0.5, 0].tolist())
    assert np.mean(pos) > np.mean(neg)


def test_train_launcher_writes_a_checkpoint(tmp_path, capsys):
    path = os.path.join(tmp_path, "h2o.msgpack")
    out = train_launcher.main(["--arch", "h2o-danube-3-4b", "--reduced",
                               "--device", "cpu", "--steps", "4",
                               "--batch", "2", "--seq", "16", "--ckpt",
                               path])
    text = capsys.readouterr().out
    assert "checkpoint written" in text and "first loss" in text
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert len(out["step_times"]) == 4 and out["impl"] == "chunked"
    restored, step = checkpoint.restore(path, out["params"])
    assert step == 4
    for a, b in zip(leaves(restored), leaves(out["params"])):
        assert torch.equal(a, b)
    # --mesh is accepted and, as in the JAX launcher, never read
    run = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
           "--seq", "16"]
    host = train_launcher.main(run + ["--mesh", "host"])["history"]
    for mesh in ("pod16x16", "pod2x16x16"):
        pod = train_launcher.main(run + ["--mesh", mesh])["history"]
        assert [h["loss"] for h in pod] == [h["loss"] for h in host]
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--reduced", "--steps", "1"])


def test_serve_launcher_restores_a_climber_checkpoint(tmp_path, capsys):
    """A checkpoint of the serving launcher's Climber config, trained a
    few steps in the port, restored by ``launch.serve --ckpt``."""
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=50_000, d_model=32, d_ff=128,
        n_heads=4, n_kv_heads=4, head_dim=8,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    it = make_batch_iterator(GRInteractionDataset(n_items=50_000,
                                                  n_users=50), 2,
                             n_history=16, n_candidates=4)
    params, _, _ = train(build_climber(cfg), it, 3,
                         AdamWConfig(lr=1e-3, warmup_steps=1),
                         impl="reference", device="cpu")
    path = os.path.join(tmp_path, "climber.msgpack")
    checkpoint.save(path, params, step=3)
    serve_launcher.main(["--device", "cpu", "--ckpt", path, "--requests",
                         "4", "--history", "16", "--d-model", "32",
                         "--buckets", "8,4", "--counts", "4,8"])
    text = capsys.readouterr().out
    assert "restored checkpoint @ step 3" in text
    assert "4 requests" in text
