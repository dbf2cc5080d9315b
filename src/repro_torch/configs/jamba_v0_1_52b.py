"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.
(copied from ``repro/configs/jamba_v0_1_52b.py``).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887]
Pattern period 8: [mamba x3, attn, mamba x4]; MoE every 2nd layer.
Mamba-dominant -> runs long_500k (attn layers keep seq-sharded caches).
"""
from repro_torch.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every_n_layers=2),
    mamba_d_state=16,
    mamba_expand=2,
    mamba_d_conv=4,
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
