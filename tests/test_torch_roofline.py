"""The port's roofline (``repro_torch/roofline.py``), hardware spec, shapes
and registry against the JAX package's.

Every function of ``roofline.py`` is held to JAX's on every
``all_configs()`` x ``SHAPES`` pair with equal ``HardwareSpec`` numbers
(exact: both sides do the same float arithmetic on the same Python ints);
the five roofline cases of ``tests/test_sharding_roofline.py`` are ported
(HLO parsing becomes the collective bytes the counting mode records on a
one-process gloo group); ``cost_analysis`` on a reduced Climber is held to
``sumi.flops_per_request`` plus the two terms the reference route adds.
"""
import dataclasses
import os

import pytest
import torch

from repro import roofline as J
from repro import types as JT
from repro.configs import (ASSIGNED_ARCHS as J_ARCHS, ASSIGNED_SHAPES as
                           J_ASSIGNED, SHAPES as J_SHAPES,
                           all_configs as j_all_configs)
from repro_torch import roofline as R
from repro_torch import types as T
from repro_torch.configs import (ASSIGNED_ARCHS, ASSIGNED_SHAPES, SHAPES,
                                 all_configs, get_config, get_shape,
                                 reduced_config)
from repro_torch.core import climber as C
from repro_torch.core.sumi import flops_per_request

torch.set_num_threads(1)

SAMPLE_HLO = """
ENTRY %main {
  %p0 = bf16[16,8192]{1,0} parameter(0)
  %all-gather.1 = bf16[256,8192]{1,0} all-gather(%p0), dimensions={0}
  %all-reduce.2 = f32[1024]{0} all-reduce(%x), to_apply=%add
  %rs = f32[64,32]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = bf16[8,128]{1,0} all-to-all(%z), dimensions={0}
  %dot = f32[128,128]{1,0} dot(%m, %n)
}
"""


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_shapes_and_hardware():
    """The registry, the shapes and get_shape are JAX's; HardwareSpec()
    is the H100 (its data sheet's numbers) and no TPU constant is left."""
    mine, theirs = all_configs(), j_all_configs()
    assert list(mine) == list(theirs)
    for arch in mine:
        assert _as_dict(mine[arch]) == _as_dict(theirs[arch]), arch
    assert ASSIGNED_ARCHS == J_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert [s.name for s in ASSIGNED_SHAPES] == [s.name for s in J_ASSIGNED]
    for name in SHAPES:
        assert get_shape(name) is SHAPES[name]
    hw = T.HardwareSpec()
    assert hw == T.H100
    assert (hw.name, hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (
        "h100-sxm", 989e12, 3.35e12, 450e9)
    assert not any("tpu" in n.lower() for n in dir(T))
    assert not any("tpu" in n.lower() for n in dir(R))


@pytest.mark.parametrize("arch", list(j_all_configs()))
def test_roofline_functions_match_jax(arch):
    """model_flops, analytic_hbm_bytes, analytic_act_bytes, param counts
    and analyse (with and without per-card bytes) on every shape, equal
    HardwareSpec numbers on both sides."""
    cfg, jcfg = get_config(arch), j_all_configs()[arch]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    hw = T.H100
    jhw = JT.HardwareSpec(name=hw.name, peak_flops=hw.peak_flops,
                          hbm_bw=hw.hbm_bw, ici_bw=hw.ici_bw)
    coll = J.collective_bytes_from_hlo(SAMPLE_HLO)
    cost = {"flops": 3.7e15, "bytes accessed": 2.9e12, "collectives": coll}
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert R.model_flops(cfg, shape) == J.model_flops(jcfg, jshape)
        assert R.analytic_hbm_bytes(cfg, shape) == \
            J.analytic_hbm_bytes(jcfg, jshape)
        assert R.analytic_act_bytes(cfg, shape) == \
            J.analytic_act_bytes(jcfg, jshape)
        for kw in ({}, {"params_bytes_chip": 7.5e9,
                        "cache_bytes_chip": 1.25e9},
                   {"per_device_peak_memory": 6.0e10}):
            mine = R.analyse(arch, name, "1x4", 4, cost, None, cfg, shape,
                             hw, **kw)
            theirs = J.analyse(arch, name, "1x4", 4, cost, SAMPLE_HLO, jcfg,
                               jshape, jhw, **kw)
            assert mine.to_dict() == theirs.to_dict()
            assert (mine.dominant, mine.useful_ratio) == (
                theirs.dominant, theirs.useful_ratio)


@pytest.fixture
def gloo_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_parse(gloo_group):
    """The port of ``test_collective_parse``: the result bytes of the c10d
    collectives a step runs, by kind, all-reduce counted twice; computed
    ops are not collectives."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    g = gloo_group

    def step(x, y, z):
        dist.all_reduce(x)
        outs = (fc.all_reduce(x, "sum", g), fc.all_gather_tensor(y, 0, g),
                fc.reduce_scatter_tensor(z, "sum", 0, g),
                fc.all_to_all_single(z, None, None, g))
        return [fc.wait_tensor(t) for t in outs] + [x @ x[:, None]]
    cost = R.cost_analysis(step, torch.ones(1024),
                           torch.ones(256, 8, dtype=torch.bfloat16),
                           torch.ones(64, 32), fake=False)
    out = R.collective_bytes(cost)
    assert out["all-reduce"] == 2 * (1024 * 4) * 2        # 2x ring factor
    assert out["all-gather"] == 256 * 8 * 2
    assert out["reduce-scatter"] == 64 * 32 * 4
    assert out["all-to-all"] == 64 * 32 * 4
    assert out["collective-permute"] == 0
    assert out["total"] == sum(out[k] for k in R._COLLECTIVES)
    assert out["counts"]["all-reduce"] == 2
    assert cost["flops"] == 2 * 1024
    # one card runs no collective: zeros in the JAX form
    none = R.collective_bytes(R.cost_analysis(lambda a: a * 2,
                                              torch.ones(3)))
    assert none["total"] == 0 and set(none) == set(
        J.collective_bytes_from_hlo(""))


def test_model_flops_kinds():
    cfg = get_config("h2o-danube-3-4b")
    tr = R.model_flops(cfg, get_shape("train_4k"))
    pf = R.model_flops(cfg, get_shape("prefill_32k"))
    dc = R.model_flops(cfg, get_shape("decode_32k"))
    assert tr == pytest.approx(6 * cfg.param_count() * 4096 * 256, rel=1e-6)
    assert pf == pytest.approx(2 * cfg.param_count() * 32768 * 32, rel=1e-6)
    assert dc == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)


def test_moe_model_flops_use_active_params():
    kimi = get_config("kimi-k2-1t-a32b")
    fl = R.model_flops(kimi, get_shape("train_4k"))
    assert fl < 6 * kimi.param_count() * 4096 * 256 * 0.1   # far below total


def test_analytic_hbm_decode_cache_dominated():
    cfg = get_config("qwen2-72b")
    by = R.analytic_hbm_bytes(cfg, get_shape("decode_32k"))
    # KV cache read per token: 80L*2*8h*128d*32768*2B*128batch ~ 1.4e12
    assert by > 1e12


def test_report_dominant_and_ratio():
    cfg = get_config("h2o-danube-3-4b")
    shp = get_shape("train_4k")
    rep = R.analyse("a", "s", "m", 256, {"flops": 1e14,
                                         "bytes accessed": 1e9},
                    J.collective_bytes_from_hlo(SAMPLE_HLO), cfg, shp)
    assert rep.dominant in ("compute", "memory", "collective")
    assert 0 < rep.useful_ratio < 10


@pytest.mark.parametrize("n_history,m", [(32, 8), (64, 24)])
def test_cost_analysis_of_climber_against_flops_per_request(n_history, m):
    """``cost_analysis`` of a reduced Climber's prefill (reference route,
    fake tensors) equals ``sumi.flops_per_request`` plus what the route
    computes beyond the paper's count: each block's side token through
    every layer's projections and FFN, the dense scores of the masked
    pairs, the side projection and the fusion / multi-task head (counted
    apart); real tensors count the same."""
    cfg = reduced_config("climber")
    c = cfg.climber
    params = C.climber_init(cfg, torch.Generator().manual_seed(0), "cpu")
    bundle = C.build_climber(cfg)
    g = torch.Generator().manual_seed(1)
    batch = {"history": torch.randint(0, cfg.vocab_size, (1, n_history),
                                      generator=g, dtype=torch.int32),
             "candidates": torch.randint(0, cfg.vocab_size, (1, m),
                                         generator=g, dtype=torch.int32),
             "side": torch.randn(1, C.N_SIDE_FEATURES, generator=g)}
    run = lambda b: bundle.prefill(params, b, impl="reference")  # noqa
    got = R.cost_analysis(run, batch)
    assert got == R.cost_analysis(run, batch, fake=False)
    head = R.cost_analysis(lambda h: C._fuse_and_head(params, h, cfg),
                           torch.zeros(1, m, c.num_blocks, cfg.d_model))
    d, f = cfg.d_model, cfg.d_ff
    n_layers = c.num_blocks * c.layers_per_block
    hb = n_history // c.num_blocks
    s = hb + 1 + m                                   # + the side token
    pairs = hb * (hb + 1) / 2 + m * (hb + 1)         # what the mask keeps
    extra = n_layers * (2 * (4 * d * d + 2 * d * f) + 4 * d * (s * s - pairs))
    side = 2 * C.N_SIDE_FEATURES * d
    want = flops_per_request(n_history, m, c.num_blocks, c.layers_per_block,
                             d, f)
    assert got["flops"] == want + extra + side + head["flops"]
    assert got["bytes accessed"] > 0 and got["collectives"]["total"] == 0
