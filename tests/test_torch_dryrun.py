"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

- The bundles' ``input_specs`` / ``input_logical`` and the caches'
  logical names and shapes against JAX's ``build_model(cfg)`` (which
  needs no device) for every architecture and shape; ``should_skip`` and
  ``_with_layers`` against JAX's.
- Per-chip bytes: for every assigned architecture on both production
  meshes, FSDP on and off, the port's ``per_chip_bytes`` of the
  parameters (and of the caches at ``decode_32k`` / ``long_500k``, and of
  the AdamW state at ``train_4k``) equals the bytes of the shards of
  JAX's ``jax.eval_shape(bundle.init)`` (``jax.eval_shape(adamw_init)``
  under JAX's dry run's ``opt_specs``) leaves under JAX's own
  ``sharding.logical_to_spec`` — exactly.
- The dry run itself, in subprocesses (each its own fake process group):
  at reduced configs on a fake (2, 2) mesh the 1-group / 2-group
  extrapolation equals the full-depth count and the collectives by kind
  equal the analytic count, for the serving shapes and a train step; the
  train step's counted FLOPs equal the analytic count of its products
  (forward, remat recompute, backward); one full-size job
  (h2o-danube-3-4b ``decode_32k`` on ``pod16x16``) gives ``ok``, 256
  chips and JAX's per-chip parameter bytes; ``train_4k`` runs at a
  reduced config; ``--impl pallas`` is refused.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharding as jshd
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch import sharding as shd
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, all_configs,
                                 get_config)
from repro_torch.launch import dryrun as D
from repro_torch.models.model import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int8): torch.int8}


@pytest.fixture(scope="module")
def jdry():
    """JAX's dry-run module.  It sets ``XLA_FLAGS`` when imported; the
    backend is up first (so the flag changes nothing here) and the
    variable is put back for later processes."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jd


def _same_spec(port, jax_spec, jax_logical):
    assert set(port) == set(jax_spec)
    for k in port:
        assert tuple(port[k].shape) == tuple(jax_spec[k].shape), k
        assert port[k].dtype == DTYPES[jnp.dtype(jax_spec[k].dtype)], k
        assert port[k].device.type == "meta", k


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_input_specs_match_jax(arch):
    """Names, shapes, dtypes and logical names of every shape's inputs."""
    tb = build_model(get_config(arch))
    jb = j_build_model(j_get_config(arch))
    for shape in SHAPES.values():
        _same_spec(tb.input_specs(shape), jb.input_specs(shape), None)
        assert tb.input_logical(shape) == jb.input_logical(shape)


def _jax_caches(jb, batch, max_len, quant):
    box = {}

    def f():
        caches, specs = jb.cache_init(batch, max_len, quant=quant)
        box["specs"] = specs
        return caches
    return jax.eval_shape(f), box["specs"]


@pytest.mark.parametrize("arch", [a for a, c in sorted(all_configs().items())
                                  if c.family != "climber"])
def test_cache_logical_matches_jax(arch):
    """``cache_logical`` against the specs JAX's ``cache_init`` returns,
    and the ``meta`` caches' shapes and dtypes against its leaves, at the
    decode shapes (int8 too)."""
    tb = build_model(get_config(arch))
    jb = j_build_model(j_get_config(arch))
    for shape in (SHAPES["decode_32k"], SHAPES["long_500k"]):
        for quant in (False, True):
            jc, jspecs = _jax_caches(jb, shape.global_batch, shape.seq_len,
                                     quant)
            tc = tb.cache_init(shape.global_batch, shape.seq_len,
                               device="meta", quant=quant)
            assert tb.cache_logical(quant) == jspecs
            jl = jax.tree.leaves(jc)
            tl = [t for t, _ in shd.zip_logical(tc, tb.cache_logical(quant))]
            assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
            assert [t.dtype for t in tl] == [DTYPES[jnp.dtype(j.dtype)]
                                             for j in jl]


def test_skip_and_with_layers_match_jax(jdry):
    for arch, cfg in all_configs().items():
        jcfg = j_all_configs()[arch]
        for shape in SHAPES.values():
            assert D.should_skip(cfg, shape) == jdry.should_skip(jcfg, shape)
        for k in (1, 2, 3):
            got, want = D._with_layers(cfg, k), jdry._with_layers(jcfg, k)
            assert (got.n_layers, got.n_enc_layers) == \
                (want.n_layers, want.n_enc_layers)
            if cfg.climber is not None:
                assert got.climber.layers_per_block == \
                    want.climber.layers_per_block


class _Mesh:
    """What JAX's ``logical_to_spec`` / ``rules_for_shape`` read."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _jax_bytes(shapes, specs, mesh, rules):
    total = 0
    is_leaf = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    for sds, lg in zip(jax.tree.leaves(shapes),
                       jax.tree.leaves(specs, is_leaf=is_leaf)):
        spec = jshd.logical_to_spec(lg, sds.shape, mesh, rules)
        shard = list(sds.shape)
        for i, e in enumerate(spec):
            if e is not None:
                axes = (e,) if isinstance(e, str) else e
                shard[i] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(shard) * jnp.dtype(sds.dtype).itemsize
    return float(total)


def _jax_param_bytes(arch, mesh, global_batch, fsdp, opt=False):
    """JAX's per-chip bytes of the parameters (``opt``: of the AdamW
    state, as JAX's dry run shards it)."""
    jb = j_build_model(j_get_config(arch))
    box = {}

    def f(key):
        params, specs = jb.init(key)
        box["specs"] = specs
        return params
    shapes = jax.eval_shape(f, jax.random.key(0))
    rules = jshd.rules_for_shape(mesh, global_batch, fsdp=fsdp)
    if opt:     # repro/launch/dryrun.py: opt_shapes / opt_specs
        return _jax_bytes(jax.eval_shape(j_adamw_init, shapes),
                          {"mu": box["specs"], "nu": box["specs"],
                           "step": ()}, mesh, rules)
    return _jax_bytes(shapes, box["specs"], mesh, rules)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_per_chip_bytes_equal_jax(arch):
    """Parameters at every assigned shape's rules, caches at the decode
    shapes and the AdamW state at ``train_4k``, both meshes, FSDP on and
    off: equal bytes."""
    tb = build_model(get_config(arch))
    pshapes, plog = D.abstract_init(tb)
    jb = j_build_model(j_get_config(arch))
    for name, (names, sizes) in MESHES.items():
        jmesh = _Mesh(names, sizes)
        tmesh = shd.MeshShape(names, sizes)
        for fsdp in (True, False):
            for shape in (SHAPES["train_4k"], SHAPES["prefill_32k"],
                          SHAPES["decode_32k"], SHAPES["long_500k"]):
                rules = shd.rules_for_shape(tmesh, shape.global_batch,
                                            fsdp=fsdp)
                got = D.per_chip_bytes(pshapes, plog, tmesh, rules)
                assert got == _jax_param_bytes(arch, jmesh,
                                               shape.global_batch, fsdp), \
                    (name, fsdp, shape.name)
                if shape.kind == "train":
                    assert D.per_chip_bytes(
                        *D.abstract_opt_state(pshapes, plog), tmesh,
                        rules) == _jax_param_bytes(
                            arch, jmesh, shape.global_batch, fsdp,
                            opt=True), (name, fsdp, "adamw")
                if shape.kind != "decode":
                    continue
                cs, clg = D.abstract_caches(tb, shape.global_batch,
                                            shape.seq_len)
                jc, jspecs = _jax_caches(jb, shape.global_batch,
                                         shape.seq_len, False)
                jrules = jshd.rules_for_shape(jmesh, shape.global_batch,
                                              fsdp=fsdp)
                assert D.per_chip_bytes(cs, clg, tmesh, rules) == \
                    _jax_bytes(jc, jspecs, jmesh, jrules), \
                    (name, fsdp, shape.name, "caches")


def _start(code: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def _result(proc, timeout: float):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


EXTRAPOLATE = """
import dataclasses, json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import sharding as shd
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.types import ShapeConfig
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_serving_mesh("2,2", device="cpu")
shapes = {"prefill": ShapeConfig(name="p", seq_len=96, global_batch=4,
                                 kind="prefill"),
          "decode": ShapeConfig(name="d", seq_len=128, global_batch=4,
                                kind="decode"),
          "train": ShapeConfig(name="t", seq_len=64, global_batch=4,
                               kind="train")}
out = {}
for arch in ARCHS:
    base = reduced_config(arch)
    cfg = D._with_layers(base, 3)
    for kind, shape in shapes.items():
        if kind == "train" and arch not in TRAIN_ARCHS:
            continue
        rules = shd.rules_for_shape(mesh, shape.global_batch)
        ext = D._extrapolated_cost(cfg, shape, mesh, rules, "chunked", 3)
        full = D._step_cost(cfg, shape, mesh, rules, "chunked")
        coll = full["collectives"]
        out[arch + ":" + kind] = {
            "ext": [ext["flops"], ext["bytes accessed"],
                    ext["collective_detail"], ext["collective_counts"]],
            "full": [full["flops"], full["bytes accessed"],
                     {k: v for k, v in coll.items() if k != "counts"},
                     coll["counts"]]}
dist.destroy_process_group()
print(json.dumps(out))
"""
EXT_ARCHS = ("h2o-danube-3-4b", "gemma3-12b", "rwkv6-7b", "jamba-v0.1-52b",
             "kimi-k2-1t-a32b", "llava-next-mistral-7b")
#: the families whose train step the extrapolation test runs too
TRAIN_ARCHS = ("h2o-danube-3-4b", "jamba-v0.1-52b")
# the port's counters and the JAX-style kinds
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "all_to_all": "all-to-all", "reduce_scatter": "reduce-scatter",
         "p2p": "collective-permute"}


@pytest.fixture(scope="module")
def jobs():
    """The dry-run jobs, each a process of its own with its own fake
    group, started together: the extrapolation records (by
    ``arch:kind``), the full-size job and the reduced ``train_4k``."""
    procs = {"extrapolated": _start(
        f"ARCHS = {EXT_ARCHS!r}\nTRAIN_ARCHS = {TRAIN_ARCHS!r}\n"
        + EXTRAPOLATE), "full": _start(FULL_JOB), "train": _start(TRAIN_JOB)}
    try:
        return {k: _result(p, timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()


@pytest.fixture(scope="module")
def extrapolated(jobs):
    return jobs["extrapolated"]


def test_extrapolation_equals_full_depth_and_counts(extrapolated):
    """At reduced configs of 3 layer groups on a fake (2, 2) mesh the
    extrapolated FLOPs, bytes and collective bytes equal the full-depth
    counts, and the collectives by kind equal the analytic count of the
    sharded forwards (``transformer.forward_collectives``) and, for a
    train step (forward, remat recompute, backward, the gradient sums,
    the global norm), of ``transformer.train_collectives``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import (forward_collectives,
                                                train_collectives)
    got = extrapolated
    for arch in EXT_ARCHS:
        cfg = D._with_layers(reduced_config(arch), 3)
        vlm = cfg.modality == "vision"
        kinds = ("prefill", "decode") + (
            ("train",) if arch in TRAIN_ARCHS else ())
        for kind in kinds:
            rec = got[f"{arch}:{kind}"]
            assert rec["ext"][0] == pytest.approx(rec["full"][0], rel=1e-12)
            assert rec["ext"][1] == pytest.approx(rec["full"][1], rel=1e-12)
            assert rec["ext"][2] == pytest.approx(rec["full"][2], rel=1e-12)
            assert rec["ext"][3] == rec["full"][3]
            if kind == "train":
                want = train_collectives(cfg, 2, 2, fsdp=True, patches=vlm,
                                         global_batch=4)
            else:
                want = forward_collectives(
                    cfg, 2, 2, fsdp=True, decode=kind == "decode",
                    patches=kind == "prefill" and vlm)
            counts = {KINDS[k]: v for k, v in want.items()}
            assert {k: v for k, v in rec["full"][3].items() if v} == \
                counts, (arch, kind)


def test_train_step_flops_equal_the_analytic_count(extrapolated):
    """h2o-danube-3-4b's train step (3 layers, batch 4 x 64 on the fake
    (2, 2) mesh, one rank's share: 2 rows, 2 of the 4 query heads, the
    one KV head whole, half the FFN and the vocabulary) counts the FLOPs
    of its products within 1%: each layer's products in the forward, in
    the remat recompute and twice in the backward, but a layer group's
    last product (its FFN's down-projection) not in the recompute, which
    stops at the last tensor the backward needs; the unembedding's once
    forward and twice backward (outside the recompute)."""
    from repro_torch.configs import reduced_config
    cfg = D._with_layers(reduced_config("h2o-danube-3-4b"), 3)
    b, s, m = 2, 64, 2
    t = b * s
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff // m
    h, hkv = cfg.n_heads // m, cfg.n_kv_heads
    layer = (2 * t * d * (h + 2 * hkv) * hd       # q, k, v
             + 2 * 2 * b * h * s * s * hd         # scores, values
             + 2 * t * h * hd * d                 # out-projection
             + 3 * 2 * t * d * f)                 # swiglu
    unembed = 2 * t * d * cfg.vocab_size // m
    down = 2 * t * f * d
    want = (cfg.n_layers * layer * (1 + 1 + 2) - cfg.n_groups * down
            + unembed * (1 + 2))
    got = extrapolated["h2o-danube-3-4b:train"]["full"][0]
    assert got == pytest.approx(want, rel=0.01)


FULL_JOB = """
import json
from repro_torch.launch import dryrun as D
rec = D.dryrun_one("h2o-danube-3-4b", "decode_32k", save=False)
print(json.dumps({k: rec[k] for k in ("status", "chips",
                                       "params_bytes_chip",
                                       "cache_bytes_chip")}))
"""


def test_full_size_job(jobs):
    """h2o-danube-3-4b ``decode_32k`` on ``pod16x16`` at full size, in a
    process of its own."""
    rec = jobs["full"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    jmesh = _Mesh(*MESHES["pod16x16"])
    assert rec["params_bytes_chip"] == _jax_param_bytes(
        "h2o-danube-3-4b", jmesh, SHAPES["decode_32k"].global_batch, True)


TRAIN_JOB = """
import json
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as D
D.get_config = reduced_config
rec = D.dryrun_one("h2o-danube-3-4b", "train_4k", save=False)
print(json.dumps({k: rec[k] for k in ("status", "chips", "params_bytes_chip",
                                       "opt_bytes_chip", "memory_analysis",
                                       "collective_counts")}))
"""


def test_train_shape_and_pallas_refused(jobs):
    """``train_4k`` runs at a reduced config over the fake group of
    ``pod16x16``: its arguments are the parameters, the AdamW state and
    the inputs, and its backward reduce-scatters; ``--impl pallas`` is
    refused."""
    rec = jobs["train"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["opt_bytes_chip"] > 2 * rec["params_bytes_chip"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > \
        rec["params_bytes_chip"] + rec["opt_bytes_chip"]
    assert rec["collective_counts"]["reduce-scatter"] > 0
    with pytest.raises(ValueError, match="launch no kernel"):
        D.main(["--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
                "--impl", "pallas"])


def test_dry_mesh_refuses_a_live_group():
    """The dry mesh starts its own fake group and tears it down; a process
    with a group already initialised is refused."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import dry_mesh
    with dry_mesh() as mesh:
        assert mesh.size == 256 and mesh.coords == {"data": 0, "model": 0}
        with pytest.raises(RuntimeError, match="already"):
            with dry_mesh(multi_pod=True):
                pass
    assert not dist.is_initialized()


def test_live_bytes_peak():
    """The eager peak counts a step's own outputs while they live: inputs,
    views and in-place results add nothing, a freed temporary leaves."""
    from repro_torch import roofline as RL

    def step(x):
        a = x * 2                   # 4 KiB live
        b = a + 1                   # 8
        del a                       # 4
        b.view(-1).add_(1)          # a view, in place: nothing new
        c = torch.cat([b, b])       # 12: the peak
        return c.sum()              # + 4 bytes
    for dev in ("meta", "cpu"):
        x = torch.empty(32, 32, device=dev)
        got = RL.cost_analysis(step, x, fake=False, peak=True)
        assert got["peak_bytes"] == 3 * 32 * 32 * 4 + 4, dev


@pytest.mark.parametrize("dev", ["meta", "cpu"])
@pytest.mark.parametrize("inference", [False, True])
def test_live_bytes_peak_keeps_a_kept_view(dev, inference):
    """A temporary reshaped and kept holds its storage after the tensor
    the op returned is gone (``torch.inference_mode`` tracks no views):
    its bytes stay live until the view goes too."""
    from repro_torch import roofline as RL

    def step(x):
        kept = torch.matmul(x, x).reshape(-1)    # 4 KiB, held by the view
        y = torch.matmul(x, x)                   # 8
        z = y * 2                                # 12: the peak
        del kept, y                              # 4
        return z * 2                             # 8
    x = torch.empty(32, 32, device=dev)
    with torch.inference_mode(inference):
        got = RL.cost_analysis(step, x, fake=False, peak=True)
    assert got["peak_bytes"] == 3 * 32 * 32 * 4
