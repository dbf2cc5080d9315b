"""The port's logical-axis rules, parameter layouts, mesh-aware capacities
and mesh flags against the JAX package's.

The JAX rule functions run on ``jax.sharding.AbstractMesh(axis_sizes,
axis_names)``, the port's on a ``sharding.MeshShape`` of the same names
and sizes; every rule table and resolved spec must be equal (a JAX
``PartitionSpec`` is a tuple of the same entries).  The parameter logical
trees of every registry arch at its reduced config must equal the specs
the JAX ``bundle.init`` returns (traced with ``jax.eval_shape``: no
weights are made).
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jshd
from repro.configs import reduced_config as j_reduced_config
from repro.core.dso import CoalescePolicy as JCoalescePolicy
from repro.models import build_model as j_build_model
from repro_torch import sharding as shd
from repro_torch.configs import _ARCH_MODULES, reduced_config
from repro_torch.core.climber import build_climber, climber_init
from repro_torch.core.dso import CoalescePolicy
from repro_torch.launch import mesh as MESH
from repro_torch.models.model import build_model

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 4), ("data", "model")), ((4,), ("data",)),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
#: logical names x global shapes: the shapes of the JAX rule tests, the
#: serving KV leaves, and parameter / activation layouts
SPEC_CASES = [
    (shd.SERVING_KV_LEAF, (3, 2, 33, 4, 16)),
    (shd.SERVING_KV_LEAF, (3, 2, 33, 3, 16)),
    (shd.SERVING_KV_LEAF, (3, 2, 1, 3, 1)),
    (shd.SERVING_KV_LEAF, (3, 2, 64, 3, 16)),
    (shd.SERVING_KV_LEAF, (8, 4, 32, 2, 64)),
    (("batch", "seq_shard"), (4, 8)),
    (("tokens",), (8,)), (("tokens",), (6,)), (("tokens",), (512,)),
    (("vocab", "embed"), (2_000_000, 256)),
    (("stack", "embed", "heads", None), (2, 256, 4, 64)),
    (("stack", "heads", None, "embed"), (2, 4, 64, 256)),
    (("stack", "embed", "kv_heads", None), (40, 5120, 8, 128)),
    (("stack", "embed", "mlp"), (2, 256, 1024)),
    (("experts", "embed", "expert_mlp"), (384, 7168, 2048)),
    (("batch", "seq", "act_model"), (16, 4096, 4096)),
    (("cache_batch", "cache_seq", "cache_heads", None), (1, 32768, 8, 128)),
    (("ssm_inner", "ssm_state"), (8192, 16)),
    ((None, "embed", "mlp"), (2, 64, 64)),
]


def _rule_tables(mesh):
    """Every rule table the rule functions give on ``mesh``."""
    yield "resolve", lambda m, s: s.resolve_rules(m)
    for kv in (None, 1, 2, 3, 4, 8):
        yield f"serving{kv}", lambda m, s, kv=kv: s.serving_rules(m, kv)
    for b, f in itertools.product((1, 2, 8, 64), (True, False)):
        yield f"shape{b}{f}", lambda m, s, b=b, f=f: s.rules_for_shape(m, b, f)


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_rules_and_specs_against_jax(sizes, names):
    jm = AbstractMesh(sizes, names)
    tm = shd.MeshShape(names, sizes)
    for label, fn in _rule_tables(jm):
        jr, tr = fn(jm, jshd), fn(tm, shd)
        assert jr == tr, label
        for logical, shape in SPEC_CASES:
            want = tuple(jshd.logical_to_spec(logical, shape, jm, jr))
            assert shd.logical_to_spec(logical, shape, tm, tr) == want, \
                (label, logical, shape)
    # the composed-axes rule of the JAX dedup test
    jr = dict(jshd.resolve_rules(jm), tokens=tuple(names))
    tr = dict(shd.resolve_rules(tm), tokens=tuple(names))
    for n in (6, 8, 64, 1024):
        assert shd.logical_to_spec(("tokens",), (n,), tm, tr) == \
            tuple(jshd.logical_to_spec(("tokens",), (n,), jm, jr))
    assert shd.logical_to_spec(("batch",), (8,), tm) == \
        tuple(jshd.logical_to_spec(("batch",), (8,), jm))


def test_cp_fallback_and_local_blocks():
    m = shd.MeshShape(("data", "model"), (2, 2))
    assert shd.serving_rules(m, 3)["cache_seq_shard"] == ("model",)
    assert not shd.cp_fallback(m, 4) and shd.cp_fallback(m, 3)
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = ("data", None, "model")
    blocks = {}
    for d, mm in itertools.product(range(2), range(2)):
        b = shd.local_shard(x, spec, m, {"data": d, "model": mm})
        assert b.shape == shd.local_shape(x.shape, spec, m) == (2, 6, 4)
        blocks[d, mm] = b
    whole = torch.cat([torch.cat([blocks[d, 0], blocks[d, 1]], 2)
                       for d in range(2)], 0)
    assert torch.equal(whole, x)
    # composed axes: data major, model minor
    assert shd.block_index(("data", "model"), m, {"data": 1, "model": 0}) == 2
    with pytest.raises(ValueError, match="does not split"):
        shd.local_shape((3, 4), ("data",), m)


def _jax_specs(arch):
    box = {}

    def init(key):
        params, specs = j_build_model(j_reduced_config(arch)).init(key)
        box["specs"] = specs
        return params
    jax.eval_shape(init, jax.random.key(0))
    return jax.tree.map(tuple, box["specs"], is_leaf=shd.is_logical)


@pytest.mark.parametrize("arch", list(_ARCH_MODULES))
def test_param_logical_against_jax(arch):
    assert shd.param_logical(build_model(reduced_config(arch))) \
        == _jax_specs(arch)


def test_shard_params_blocks():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.types import ClimberConfig
    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=64, d_model=32, d_ff=64, n_heads=4,
        n_kv_heads=4, head_dim=8,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    bundle = build_climber(cfg)
    params = climber_init(cfg, torch.Generator().manual_seed(0), "cpu")
    logical = shd.param_logical(bundle)
    m = shd.MeshShape(("data", "model"), (2, 2))
    rules = shd.serving_rules(m, cfg.n_kv_heads)
    a = shd.shard_params(params, logical, m, {"data": 1, "model": 0}, rules)
    b = shd.shard_params(params, logical, m, {"data": 0, "model": 1}, rules)
    emb = params["embed"]["embedding"]
    assert torch.equal(torch.cat([a["embed"]["embedding"],
                                  b["embed"]["embedding"]]), emb)
    attn = params["blocks"]["b0"]["attn"]
    assert a["blocks"]["b0"]["attn"]["wq"].shape == (2, 32, 2, 8)
    assert torch.equal(a["blocks"]["b0"]["attn"]["wo"], attn["wo"][:, :2])
    assert a["blocks"]["b0"]["ffn"]["w_down"].shape == (2, 32, 32)
    # replicated leaves are the leaves themselves
    assert a["pos_embed"] is params["pos_embed"]
    assert a["blocks"]["b0"]["temp"] is params["blocks"]["b0"]["temp"]


def test_coalesce_policy_capacities_against_jax():
    for mb, pr, dw, on in itertools.product((1, 4, 6), (None, 1, 2), (1, 2, 4),
                                            (True, False)):
        kw = dict(max_batch=mb, pack_rows=pr, data_ways=dw, enabled=on)
        p, j = CoalescePolicy(**kw), JCoalescePolicy(**kw)
        assert (p.batch, p.rows) == (j.batch, j.rows), kw
    with pytest.raises(ValueError):
        CoalescePolicy(data_ways=0)


def test_mesh_flags():
    assert MESH.make_serving_mesh("", 0) is None
    m = MESH.make_serving_mesh("1,1")
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1} and m.leader and m.size == 1
    assert m.device is None     # no group: its engine's device
    assert MESH.make_serving_mesh(model_parallel=1).shape["model"] == 1
    for bad in ("4", "2,0", "1,2,3"):
        with pytest.raises(ValueError, match="data,model"):
            MESH.make_serving_mesh(bad)
    # no process group here: more ranks than one are refused, with how
    with pytest.raises(ValueError, match="run_ranks"):
        MESH.make_serving_mesh("2,2")
    with pytest.raises(ValueError, match="256 ranks"):
        MESH.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        MESH.make_production_mesh(multi_pod=True)
    assert MESH.mesh_ranks("2,2") == 4 and MESH.mesh_ranks("", 2) == 2
    assert MESH.mesh_ranks("", 2, cards=8) == 8 and MESH.mesh_ranks() == 0


def test_constrain_ctx_and_collectives_at_one_way():
    x = torch.zeros(4, 6)
    assert shd.constrain_ctx(x, "batch", None) is x      # no mesh: no-op
    m = MESH.make_serving_mesh("1,1")
    with shd.mesh_rules(m, shd.serving_rules(m)):
        assert shd.constrain_ctx(x, "batch", None) is x
        with pytest.raises(ValueError, match="local block"):
            shd.constrain_ctx(x, "batch", None, global_shape=(8, 6))
        before = shd.counts()
        assert shd.psum(x, "model") is x
        assert shd.all_gather(x, "data", 0) is x
        assert shd.all_to_all(x, "data") is x
        assert shd.ppermute_next(x, "model") is x
        assert shd.counts() == before
        ids = torch.tensor([[0, 3]])
        table = torch.arange(12.).reshape(4, 3)
        assert torch.equal(shd.embed_lookup(table, ids, 4), table[ids])
    with pytest.raises(RuntimeError, match="active mesh"):
        shd._mesh_axis("model")
    np.testing.assert_equal(shd.axis_size("model"), 1)
