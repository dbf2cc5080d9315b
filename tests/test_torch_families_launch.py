"""The launcher's ``--engine text`` on every decoder family of the
registry, on the CPU (reduced configs, random weights from ``--seed``),
the kernels each family's config reaches under ``impl="pallas"``
(``serving/engine.py::_text_kernels``), and ``cuda``-marked cases that
serve a reduced MoE config (kimi-k2-1t-a32b) and the reduced jamba config
through the engine on the card, counting the launches of K2, K3 and K4.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import TEXT_ARCHS, get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import dense_ffn_layers
from repro_torch.serving import create_engine
from repro_torch.serving.engine import _text_kernels

torch.set_num_threads(1)
NEW_ARCHS = ("jamba-v0.1-52b", "kimi-k2-1t-a32b",
             "llama4-maverick-400b-a17b", "llava-next-mistral-7b",
             "qwen2-72b", "qwen1.5-32b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launcher_serves_the_family_on_cpu(arch, capsys):
    serve.main(["--engine", "text", "--arch", arch, "--device", "cpu",
                "--requests", "2", "--tokens", "6"])
    out = capsys.readouterr().out
    assert f"reduced {arch}" in out
    assert out.count("generated [") == 2
    assert "text_decode_steps=10" in out


def test_launcher_default_arch_and_choices(monkeypatch):
    """``--arch`` defaults to gemma3-12b, as the JAX launcher's, and takes
    every decoder arch of the registry (not Climber, not the audio
    encoder-decoder)."""
    seen = {}
    monkeypatch.setattr(serve, "serve_text",
                        lambda args: seen.setdefault("arch", args.arch))
    serve.main(["--engine", "text", "--device", "cpu"])
    assert seen["arch"] == "gemma3-12b"
    assert set(NEW_ARCHS) | {"rwkv6-7b", "gemma3-12b",
                             "h2o-danube-3-4b"} == set(TEXT_ARCHS)
    with pytest.raises(SystemExit):
        serve.main(["--engine", "text", "--arch", "seamless-m4t-large-v2"])


@pytest.mark.parametrize("arch,want", [
    ("jamba-v0.1-52b", ["flash_attention", "flash_decode", "fused_ffn"]),
    ("kimi-k2-1t-a32b", ["flash_attention", "flash_decode", "fused_ffn"]),
    ("llava-next-mistral-7b",
     ["flash_attention", "flash_decode", "fused_ffn"]),
    ("rwkv6-7b", ["rwkv6_scan"]),
])
def test_text_kernels_per_family(arch, want):
    assert _text_kernels(get_config(arch)) == want


def test_text_kernels_of_stacks_without_attention():
    """A Mamba stack reaches K3 through its dense FFNs only; one whose
    every layer is MoE without a shared expert reaches no kernel (the
    routed experts are ``torch.bmm``)."""
    import dataclasses
    cfg = get_config("jamba-v0.1-52b")
    mamba = dataclasses.replace(cfg, layer_pattern=("mamba",) * 8)
    assert _text_kernels(mamba) == ["fused_ffn"]
    all_moe = dataclasses.replace(
        mamba, moe=dataclasses.replace(cfg.moe, every_n_layers=1))
    assert _text_kernels(all_moe) == []


def _launches():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    return (fa.flash_attention.launches, ff.fused_ffn_2d.launches,
            fd.flash_decode.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-v0.1-52b"])
def test_text_engine_on_gpu_launches_k2_k3_k4(arch):
    """On the card the engine's prefill launches K2 once an ``attn`` layer
    and K3 once a layer with a dense FFN or a shared expert, and each
    captured decode step K3 as often and K4's single-token form once an
    ``attn`` layer; the routed experts and the Mamba scan launch none of
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels.fused_ffn import ops as ff
    cfg = reduced_config(arch)
    tb = build_model(cfg)
    params = tb.init(torch.Generator(device="cuda").manual_seed(0))
    eng = create_engine("text", tb, params, batch=2, max_len=96)
    n_tokens = 5
    prompts = [np.arange(70, dtype=np.int32) % cfg.vocab_size] * 2
    try:
        before = _launches()
        out = eng.generate(prompts, n_tokens=n_tokens)
        after = _launches()
    finally:
        eng.shutdown()
    n_attn = cfg.n_groups * sum(k == "attn" for k in cfg.layer_pattern)
    n_ffn = cfg.n_groups * len(dense_ffn_layers(cfg))
    k3 = sum(n * ff.kernel_launches(rows, cfg.d_model, f=cfg.d_ff,
                                    dtype=torch.bfloat16)
             for n, rows in ((1, 140), (n_tokens - 1, 2)))
    assert [a - b for a, b in zip(after, before)] == [
        n_attn, n_ffn * k3, n_attn * (n_tokens - 1)]
    assert [len(o) for o in out] == [n_tokens, n_tokens]
    assert all(0 <= int(t) < cfg.vocab_size for o in out for t in o)
