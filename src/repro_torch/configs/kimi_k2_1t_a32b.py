"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table config).
(copied from ``repro/configs/kimi_k2_1t_a32b.py``).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts top-8
[arXiv:2501.kimi2]

Every layer is MoE with one shared expert (DeepSeek-V3-style), d_ff_expert=2048.
"""
from repro_torch.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  every_n_layers=1, num_shared_experts=1),
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2501.kimi2",
)
