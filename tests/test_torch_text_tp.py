"""The text families' sharded forwards against the JAX package, on the
CPU at their reduced configs: every rank of a gloo mesh runs
``bundle.prefill`` and ``decode_step`` on its blocks (``shard_params``
under ``rules_for_shape``, FSDP on) inside ``sharding.mesh_rules``, as
JAX's dry run calls them, and the logits gathered over the ranks equal
JAX's ``bundle.prefill`` / ``decode_step`` (one global array) within 1e-5
in f32.

Seven families (h2o-danube-3-4b ``swa``, gemma3-12b ``swa`` + ``attn``,
rwkv6-7b, jamba-v0.1-52b Mamba + MoE, kimi-k2-1t-a32b MoE with a shared
expert, llava-next-mistral-7b with stub patches, seamless-m4t-large-v2)
at batch 2 on the (1, 2), (2, 1) and (2, 2) meshes, a prompt into caches
and three greedy decode steps (JAX's greedy tokens fed to both); gemma3
and jamba also at batch 1 under the long-context rules (the caches'
positions split over data and model, the prompt past the sliding window
so the ring wraps, jamba's past d_model tokens so the Mamba input
projection takes its weight-gather route), and gemma3 under the dry run's serving profile (FSDP
off, the caches' positions over ``model``, the batch over ``data``).
The long-context cases run again under ``impl="pallas"`` on the port's
side: each rank's slice of the positions through K4's plain version and
its log-sum-exp, merged over the ranks (``_split_cache_decode``).
h2o-danube-3-4b (128 tokens: the sliding halo) and gemma3-12b (K / V
gathered) prefill under ``impl="cp"`` too, context-parallel over
``model`` (``attention.heads_attention``), against JAX's ``impl="cp"``
prefill (one device: its ``chunked`` route) and the port's mesh-less
run, with the cp collectives counted.
One spawn of 2 ranks runs the two 2-rank meshes and
one of 4 ranks the (2, 2) mesh; each phase's collectives are held to the
analytic count (``transformer.forward_collectives``), the model ranks'
logits to each other bitwise, and every case also to the port's
mesh-less run within 1e-5.  rwkv6-7b's mesh-less bundle is itself 1e-5
from JAX's at this input (9.97e-6 at the prefill: the CPU cumulative sum
of the decay runs in f64), so its JAX comparison takes the rwkv bundle's
tolerance of ``tests/test_torch_rwkv.py`` (``MODEL_TOL``, 1e-4) and the
mesh-less comparison holds the sharding at 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_workers as W
from repro.configs import reduced_config as j_reduced_config
from repro.models.model import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.transformer import forward_collectives
from repro_torch.tree import params_from_jax

torch.set_num_threads(1)
F32_TOL = 1e-5
MODEL_TOL = {"rwkv6-7b": 1e-4}    # tests/test_torch_rwkv.py MODEL_TOL
ARCHS = ("h2o-danube-3-4b", "gemma3-12b", "rwkv6-7b", "jamba-v0.1-52b",
         "kimi-k2-1t-a32b", "llava-next-mistral-7b", "seamless-m4t-large-v2")
#: the batch-1 long-context cases' prompts: past gemma3's 64-slot window
#: (the ring wraps), past jamba's d_model 256 in tokens (the Mamba input
#: projection gathers its weight, not its product) and its scan chunk
LONG = {"gemma3-12b": 72, "jamba-v0.1-52b": 300}
SERVING = ("gemma3-12b",)   # FSDP off, cache positions over model
#: the prefills under impl="cp": h2o's 128 tokens put its 64-token window
#: within a rank's block on 2 model ways (the halo), gemma3's 40 do not
#: (K / V gathered for both its kinds)
CP_SEQ = {"h2o-danube-3-4b": 128, "gemma3-12b": 40}
N_FRONT = 16         # stub patches (llava) / frames (seamless)
STEPS = 3


def _jax_run(jb, j32, jcfg, batch, max_len, impl="reference"):
    """JAX's prefill into caches (under ``impl``) and three greedy steps:
    (logits per phase, the tokens fed, the positions)."""
    prefill = jax.jit(jb.prefill, static_argnames=("impl",))
    decode = jax.jit(jb.decode_step, static_argnames=("impl",))
    b = batch["tokens"].shape[0]
    kw = {"n_frames": N_FRONT} if jcfg.enc_dec else {}
    caches, _ = jb.cache_init(b, max_len, dtype=jnp.float32, **kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, caches = prefill(j32, jbatch, impl=impl, caches=caches)
    outs = [np.asarray(logits)]
    lead = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    cur = lead + batch["tokens"].shape[1]
    steps = []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1:], axis=-1), np.int32)
        steps.append((torch.from_numpy(tok.copy()).long(), cur))
        logits, caches = decode(j32, caches, {"tokens": jnp.asarray(tok),
                                              "cur_index": jnp.int32(cur)},
                                impl="reference")
        outs.append(np.asarray(logits))
        cur += 1
    return outs, steps


def _case(arch, i, long, rng, serving=False, impl="reference"):
    jcfg = j_reduced_config(arch)
    jb = j_build_model(jcfg)
    jparams, _ = jb.init(jax.random.key(i))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    t32 = params_from_jax(jax.tree.map(np.asarray, j32), device="cpu")
    b, s = (1, LONG[arch]) if long else (2, CP_SEQ.get(arch, 40)
                                          if impl == "cp" else 40)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(
        np.int32)}
    if jcfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (b, N_FRONT, jcfg.d_model)).astype(np.float32)
    elif jcfg.modality == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (b, N_FRONT, jcfg.d_model)).astype(np.float32)
    max_len = -(-(s + STEPS) // 64) * 64 if long else s + N_FRONT + 8
    outs, steps = _jax_run(jb, j32, jcfg, batch, max_len,
                           "cp" if impl == "cp" else "reference")
    tbatch = {k: torch.as_tensor(v).long() if k == "tokens"
              else torch.as_tensor(v) for k, v in batch.items()}
    name = arch + (":long" if long else ":serving" if serving else "") + (
        ":" + impl if impl != "reference" else "")
    run = dict(name=name, arch=arch, batch=tbatch, max_len=max_len,
               steps=steps, impl=impl, n_frames=N_FRONT, serving=serving)
    return name, run, t32, outs, _port_run(arch, t32, run)


def _port_run(arch, t32, run):
    """The port's mesh-less prefill and steps on the same inputs."""
    tb = build_model(reduced_config(arch))
    b = run["batch"]["tokens"].shape[0]
    kw = {"n_frames": N_FRONT} if tb.cfg.enc_dec else {}
    caches = tb.cache_init(b, run["max_len"], dtype=torch.float32,
                           device="cpu", **kw)
    with torch.inference_mode():
        logits, caches = tb.prefill(t32, run["batch"], impl=run["impl"],
                                    caches=caches)
        outs = [logits]
        for tok, cur in run["steps"]:
            logits, caches = tb.decode_step(
                t32, caches, {"tokens": tok, "cur_index": torch.tensor(cur)},
                impl=run["impl"])
            outs.append(logits)
    return outs


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    rng = np.random.default_rng(30)
    runs, params, want, mesh_less = [], {}, {}, {}
    cases = [(i, arch, long, False, "reference")
             for i, arch in enumerate(ARCHS)
             for long in ((False, True) if arch in LONG else (False,))]
    cases += [(ARCHS.index(a), a, False, True, "reference") for a in SERVING]
    cases += [(ARCHS.index(a), a, True, False, "pallas") for a in LONG]
    cases += [(ARCHS.index(a), a, False, False, "cp") for a in CP_SEQ]
    for i, arch, long, serving, impl in cases:
        name, run, t32, outs, port = _case(arch, i, long, rng, serving, impl)
        runs.append(run)
        params[arch] = t32          # one key an arch: the same weights
        want[name] = outs
        mesh_less[name] = port
    got = {}
    for world, meshes in ((2, ("1,2", "2,1")), (4, ("2,2",))):
        job_dir = str(tmp_path_factory.mktemp(f"text_tp{world}"))
        torch.save({"meshes": meshes, "runs": runs, "params": params},
                   os.path.join(job_dir, "job.pt"))
        run_ranks(W.text_tp_suite, world, args=(job_dir,), timeout_s=240,
                  threads=1, init_dir=job_dir)
        for r in range(world):
            got[(world, r)] = torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                                         weights_only=False)
    return dict(runs={r["name"]: r for r in runs}, want=want, got=got,
                mesh_less=mesh_less)


def _ranks(suite, mesh):
    world = 2 if mesh != "2,2" else 4
    data, model = (int(x) for x in mesh.split(","))
    # rank r sits at (r // model, r % model): data-major, as DeviceMesh
    return [(r // model, r % model, suite["got"][(world, r)])
            for r in range(world)]


MESHES = ("1,2", "2,1", "2,2")
NAMES = list(ARCHS) + [a + ":long" for a in LONG] + [
    a + ":serving" for a in SERVING] + [a + ":long:pallas" for a in LONG] + [
    a + ":cp" for a in CP_SEQ]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_forward_matches_jax(suite, mesh, name):
    """The rank-gathered logits of the prefill and of each greedy step
    against JAX's, f32 within 1e-5 (rwkv6: 1e-4, module docstring) and
    against the port's mesh-less run within 1e-5; the model ranks of a
    data block agree bitwise; the greedy tokens equal JAX's."""
    want = suite["want"][name]
    tol = MODEL_TOL.get(name.split(":")[0], F32_TOL)
    ranks = _ranks(suite, mesh)
    data = max(d for d, _, _ in ranks) + 1
    for i, phase in enumerate(["prefill"] + [f"step{k}"
                                             for k in range(STEPS)]):
        blocks = {}
        for d, m, res in ranks:
            out = res[(mesh, name)][phase]
            if d in blocks:
                assert torch.equal(out, blocks[d]), (phase, d, m)
            blocks[d] = out
        spec = ranks[0][2][(mesh, name)]["rows"]
        whole = (torch.cat([blocks[d] for d in range(data)]) if spec
                 else blocks[0])
        np.testing.assert_allclose(whole.numpy(), want[i], atol=tol,
                                   rtol=tol, err_msg=f"{name} {phase}")
        np.testing.assert_allclose(
            whole.numpy(), suite["mesh_less"][name][i].numpy(),
            atol=F32_TOL, rtol=F32_TOL, err_msg=f"{name} {phase} mesh-less")
        if i < STEPS:
            np.testing.assert_array_equal(
                whole[:, -1].argmax(-1).numpy(),
                suite["runs"][name]["steps"][i][0][:, 0].numpy())


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_match_the_analytic_count(suite, mesh):
    """Each decoder family's prefill and decode steps issue exactly the
    collectives the design gives (batch split over data, positions
    whole)."""
    data, model = (int(x) for x in mesh.split(","))
    res = _ranks(suite, mesh)[0][2]
    for arch in ARCHS:
        cfg = reduced_config(arch)
        if cfg.enc_dec:
            continue
        vlm = cfg.modality == "vision"
        assert res[(mesh, arch)]["prefill_counts"] == forward_collectives(
            cfg, data, model, fsdp=True, patches=vlm), arch
        for k in range(STEPS):
            assert res[(mesh, arch)][f"step{k}_counts"] == \
                forward_collectives(cfg, data, model, fsdp=True,
                                    decode=True), (arch, k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(CP_SEQ))
def test_cp_collectives_match_the_analytic_count(suite, mesh, arch):
    """Under ``impl="cp"`` the prefill moves each attention layer's heads
    to sequence blocks and back and exchanges the halo or gathers K / V
    (``forward_collectives(..., cp_seq=S)``); the decode steps are the
    other impls' (no sequence to split)."""
    data, model = (int(x) for x in mesh.split(","))
    res = _ranks(suite, mesh)[0][2][(mesh, arch + ":cp")]
    cfg = reduced_config(arch)
    assert res["prefill_counts"] == forward_collectives(
        cfg, data, model, fsdp=True, cp_seq=CP_SEQ[arch])
    for k in range(STEPS):
        assert res[f"step{k}_counts"] == forward_collectives(
            cfg, data, model, fsdp=True, decode=True), k


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", [n for n in NAMES
                                  if ":long" in n or ":serving" in n])
def test_split_cache_collectives_match_the_analytic_count(suite, mesh,
                                                           name):
    """The long-context cases (FSDP on, the caches' positions over data
    and model, the batch whole) and the serving profile (FSDP off, the
    positions over model) issue the collectives the design gives: K / V
    gathered where the KV heads split, and at each decode step the query
    heads gathered and the softmaxes merged over the split axes."""
    data, model = (int(x) for x in mesh.split(","))
    res = _ranks(suite, mesh)[0][2][(mesh, name)]
    cfg = reduced_config(name.split(":")[0])
    kw = (dict(fsdp=False, seq=("model",)) if ":serving" in name
          else dict(fsdp=True, seq=("data", "model")))
    assert res["prefill_counts"] == forward_collectives(cfg, data, model,
                                                        **kw)
    for k in range(STEPS):
        assert res[f"step{k}_counts"] == forward_collectives(
            cfg, data, model, decode=True, **kw), k
