"""Isolation and no-fallback rules of the PyTorch port.

* ``src/repro_torch``, ``chip_smoke.py`` and the port's examples
  (``examples/torch_*.py``) import neither JAX nor anything of the JAX
  package ``repro``, nor ``msgpack`` (the card machine has none; the
  checkpoints have a codec of their own), checked on the source and on a
  fresh interpreter's loaded modules; the examples import nothing of
  ``benchmarks`` either (its helpers import the JAX package);
* entry points default to the GPU and raise without one — nothing moves to
  the CPU silently;
* on CPU tensors each kernel wrapper runs its plain version and its launch
  counter stays 0, and differentiates through it; on CUDA tensors a wrapper
  raises when grad mode is on and an operand requires grad (the kernels
  have no backward), and so does a loss under ``impl="pallas"``;
* the launcher runs end to end on the CPU at a tiny size, and
  ``chip_smoke.py`` exits non-zero with no result line off the GPU.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

torch.set_num_threads(1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str, extra=()) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax", "msgpack") \
        + tuple(extra)


def test_no_jax_or_repro_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 5
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    bad += [(str(f.relative_to(ROOT)), m) for f in examples
            for m in _imported_modules(f) if _forbidden(m, ("benchmarks",))]
    assert not bad, bad


def test_fresh_interpreter_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.core.climber, repro_torch.kernels._build\n"
            "import repro_torch.models.model, repro_torch.kernels.rwkv6_scan\n"
            "import repro_torch.launch.train, repro_torch.training.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract does not apply")
    from repro_torch.configs import reduced_config
    from repro_torch.core import climber as C
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import FlameEngine
    cfg = reduced_config("climber")
    with pytest.raises(RuntimeError, match="cuda"):
        C.climber_init(cfg)
    params = C.climber_init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        FlameEngine(C.build_climber(cfg), params, n_history=16)
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--requests", "1"])


def test_text_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract does not apply")
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import create_engine
    from repro_torch.tree import params_from_jax
    bundle = build_model(reduced_config("rwkv6-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        bundle.init()
    with pytest.raises(RuntimeError, match="cuda"):
        bundle.cache_init(1, 8)
    params = bundle.init(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        create_engine("text", bundle, params)
    eng = create_engine("text", bundle, params, batch=1, max_len=8,
                        device="cpu")
    eng.shutdown()
    # the weight bridge defaults to the card, like every other entry point
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    got = params_from_jax({"w": np.zeros(3, np.float32)}, device="cpu")
    assert got["w"].device.type == "cpu"


def test_params_on_another_device_are_not_moved():
    from repro_torch.configs import reduced_config
    from repro_torch.core import climber as C
    from repro_torch.serving import FlameEngine
    cfg = reduced_config("climber")
    params = C.climber_init(cfg, device="cpu")
    params["embed"]["embedding"] = params["embed"]["embedding"].to("meta")
    with pytest.raises(ValueError, match="params are on"):
        FlameEngine(C.build_climber(cfg), params, n_history=16,
                    device="cpu")


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.fused_score import ops as fs
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 12, 2, 16, generator=g) for _ in range(3))
    fa0, fs0 = fa.flash_attention.launches, fs.fused_score.launches
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, "causal"),
        fa.flash_attention_plain(q, k, v, "causal"), rtol=0, atol=0)
    kh, vh = (torch.randn(1, 20, 2, 16, generator=g) for _ in range(2))
    torch.testing.assert_close(
        fs.fused_cached_attention(q, kh, vh, k, v),
        fs.fused_score_plain(q, kh, vh, k, v, mode="cached"), rtol=0, atol=0)
    assert (fa.flash_attention.launches, fs.fused_score.launches) == (fa0,
                                                                       fs0)
    fd0, ff0 = fd.flash_decode.launches, ff.fused_ffn_2d.launches
    lens = torch.tensor([20], dtype=torch.int32)
    torch.testing.assert_close(
        fd.flash_decode(q[:, 0], kh, vh, lens),
        fd.flash_decode_plain(q[:, 0], kh, vh, lens), rtol=0, atol=0)
    x, wu, wd = (torch.randn(*sh, generator=g) for sh in ((5, 16), (16, 24),
                                                         (24, 16)))
    # f32 at d 16 is the any-dims variant's route: its plain twin (split
    # TF32 products) is the plain version the CPU wrapper runs, and it
    # keeps the f32 contract against the plain f32 version
    assert ff.route(16, 24, x.dtype) == "any"
    got = ff.fused_ffn_2d(x, wu, wd, activation="gelu")
    torch.testing.assert_close(
        got, ff.fused_ffn_any_plain(x, wu, wd, activation="gelu"), rtol=0,
        atol=0)
    torch.testing.assert_close(
        got, ff.fused_ffn_plain(x, wu, wd, activation="gelu"), rtol=1e-5,
        atol=1e-5)
    assert (fd.flash_decode.launches, ff.fused_ffn_2d.launches) == (fd0,
                                                                    ff0)
    with pytest.raises(ValueError):      # neither CUDA nor CPU: no fallback
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                           "causal")


def test_training_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU contract does not apply")
    from repro_torch.configs import reduced_config
    from repro_torch.core.climber import build_climber
    from repro_torch.launch import train as train_launcher
    from repro_torch.training.loop import train
    bundle = build_climber(reduced_config("climber"))
    with pytest.raises(RuntimeError, match="cuda"):
        bundle.init()
    with pytest.raises(RuntimeError, match="cuda"):
        train(bundle, iter([]), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--arch", "climber", "--reduced"])


def test_grad_guard_and_cpu_wrappers_differentiate_plain_versions():
    """The guard every CUDA launch runs first raises exactly when grad mode
    is on and an operand requires grad; on CPU tensors the wrappers run
    their plain versions, so their gradients are the plain versions'."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_ffn import ops as ff
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 12, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        _build.forbid_grad("flash_attention", q, k.detach(), None)
    with torch.no_grad():
        _build.forbid_grad("flash_attention", q, k, v)
    _build.forbid_grad("flash_attention", q.detach(), k.detach())
    got = torch.autograd.grad(fa.flash_attention(q, k, v, "causal").sum(),
                              (q, k, v))
    want = torch.autograd.grad(
        fa.flash_attention_plain(q, k, v, "causal").sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x, wu, wd = (torch.randn(*sh, generator=g, requires_grad=True)
                 for sh in ((5, 16), (16, 24), (24, 16)))
    assert ff.route(16, 24, x.dtype) == "any"   # the any-dims twin's route
    # a weighted sum, so that every output's gradient differs
    wt = torch.randn(5, 16, generator=g)
    got = torch.autograd.grad(
        (ff.fused_ffn_2d(x, wu, wd, activation="gelu") * wt).sum(),
        (x, wu, wd))
    twin = torch.autograd.grad(
        (ff.fused_ffn_any_plain(x, wu, wd, activation="gelu") * wt).sum(),
        (x, wu, wd))
    # the straight-through TF32 split against the plain f32 version's
    # gradients: the f32 contract
    want = torch.autograd.grad(
        (ff.fused_ffn_plain(x, wu, wd, activation="gelu") * wt).sum(),
        (x, wu, wd))
    for a, b, c in zip(got, twin, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_wrappers_raise_under_grad(cuda):
    """Every kernel wrapper refuses operands that require grad under grad
    mode (no plain fallback), runs under ``torch.no_grad()``, and a text
    loss under ``impl="pallas"`` raises where the chunked one trains."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.kernels.rwkv6_scan import ops as scan
    from repro_torch.models.model import build_model
    from repro_torch.training.loop import grads_of
    from repro_torch.tree import leaves
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)
    q, k, v = rnd(1, 64, 4, 64), rnd(1, 64, 4, 64), rnd(1, 64, 4, 64)
    kh, vh = rnd(1, 96, 4, 64), rnd(1, 96, 4, 64)
    lens = torch.full((1,), 96, dtype=torch.int32, device=cuda)
    x, wu, wd = rnd(8, 256), rnd(256, 1024), rnd(1024, 256)
    r5, k5, v5 = (rnd(1, 64, 2, 64) for _ in range(3))
    w5 = -torch.rand(1, 64, 2, 64, generator=g, device=cuda).to(
        torch.bfloat16) - 0.1
    u5 = rnd(2, 64, dtype=torch.float32)
    calls = {
        "flash_attention": (lambda t: fa.flash_attention(t, k, v, "causal"),
                            q),
        "fused_score": (lambda t: fs.fused_cached_attention(t, kh, vh, k, v),
                        q),
        "flash_decode": (lambda t: fd.flash_decode(t[:, 0], kh, vh, lens),
                         q),
        "flash_decode_with_self": (lambda t: fd.flash_decode_with_self(
            t[:, :8], kh, vh, lens, k[:, :8], v[:, :8]), q),
        "fused_ffn": (lambda t: ff.fused_ffn_2d(t, wu, wd,
                                                activation="gelu"), x),
        "rwkv6_scan": (lambda t: scan.rwkv6_scan(t, k5, v5, w5, u5), r5),
    }
    for name, (call, arg) in calls.items():
        with torch.no_grad():
            call(arg.clone().requires_grad_(True))
        with pytest.raises(RuntimeError, match="no backward"):
            call(arg.clone().requires_grad_(True))
    bundle = build_model(reduced_config("h2o-danube-3-4b"))
    params = bundle.init(device=cuda)
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {"tokens": torch.randint(0, 512, (1, 32), device=cuda)}
    with pytest.raises(RuntimeError, match="no backward"):
        bundle.loss_fn(params, batch, impl="pallas")
    loss, _ = bundle.loss_fn(params, batch, impl="chunked")
    assert all(torch.isfinite(t).all() for t in grads_of(loss, params))


def test_k5_cpu_wrapper_runs_plain_version_and_counts_nothing():
    from repro_torch.kernels.rwkv6_scan import ops as scan
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn(2, 70, 2, 32, generator=g) for _ in range(3))
    wl = -torch.rand(2, 70, 2, 32, generator=g) * 20 - 1e-4
    u = torch.randn(2, 32, generator=g)
    s0 = torch.randn(2, 2, 32, 32, generator=g)
    before = scan.rwkv6_scan.launches
    o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
    po, psf = scan.rwkv6_scan_plain(r, k, v, wl, u, s0)
    torch.testing.assert_close(o, po, rtol=0, atol=0)
    torch.testing.assert_close(sf, psf, rtol=0, atol=0)
    assert scan.rwkv6_scan.launches == before
    with pytest.raises(ValueError):      # neither CUDA nor CPU: no fallback
        scan.rwkv6_scan(*(t.to("meta") for t in (r, k, v, wl, u)))


def test_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--history", "16", "--d-model", "32",
         "--buckets", "8,4", "--counts", "4,8", "--users", "2",
         "--pool-dtype", "int8", "--concurrency", "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "4 requests" in out.stdout and "pool_hits" in out.stdout


@pytest.mark.parametrize("flags,want", [
    (["--engine", "implicit", "--counts", "4,8,6"], "jit_compiles="),
    (["--no-history-cache", "--impl", "pallas"], "(family full)"),
    (["--impl", "chunked", "--users", "2"], "impl chunked"),
])
def test_launcher_runs_baselines_on_cpu(flags, want):
    """The implicit-shape engine, the pool-off ``full`` family and the JAX
    framework impl through the launcher."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--history", "16", "--d-model", "32",
         "--buckets", "8,4", "--counts", "4,8", "--concurrency", "2"]
        + flags, env=_env(), capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "4 requests" in out.stdout and want in out.stdout


def test_launcher_refuses_pool_only_flags_without_pool(capsys):
    from repro_torch.launch import serve as launcher
    for flags, reason in ((["--generate", "topk"], "in-flight beams"),
                          (["--pack-tails"], "segment packing steers")):
        with pytest.raises(SystemExit):
            launcher.main(["--device", "cpu", "--no-history-cache"] + flags)
        assert reason in capsys.readouterr().err


def test_launcher_generates_topk_under_pallas_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--generate", "topk", "--impl", "pallas", "--gen-steps", "3",
         "--beam-width", "2", "--requests", "3", "--history", "16",
         "--d-model", "32", "--buckets", "8,4", "--counts", "4,8",
         "--users", "2", "--pool-dtype", "int8", "--concurrency", "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "impl pallas" in out.stdout and "gen tokens/s" in out.stdout
    assert "best sequence" in out.stdout and "decode_steps=" in out.stdout


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], env=_env(),
                             capture_output=True, text=True, timeout=300,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_build_targets_are_content_addressed():
    """A kernel library's file name carries a digest of its sources, so an
    edited kernel can never load a stale build (no compiler needed)."""
    from repro_torch.kernels import _build
    names = {n: _build._target(n).name for n in _build.SOURCES}
    assert len(set(names.values())) == len(_build.SOURCES)
    for n, t in names.items():
        assert t.startswith(n + "-") and t.endswith(".so")
    assert _build.BUILD == ROOT / "build"
    assert np.all([(_build.CSRC / f"{n}.cu").exists()
                   for n in _build.SOURCES])
