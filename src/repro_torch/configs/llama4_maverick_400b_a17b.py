"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with early fusion.
(copied from ``repro/configs/llama4_maverick_400b_a17b.py``).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E]

Alternating dense/MoE FFN (every 2nd layer MoE) with one shared expert,
following the Maverick interleave.  Early fusion: multimodal tokens enter the
shared embedding stream (text-only here; vision stub supplies embeddings).
"""
from repro_torch.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("attn", "attn"),   # period 2: dense FFN / MoE FFN interleave
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  every_n_layers=2, num_shared_experts=1),
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
