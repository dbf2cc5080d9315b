"""qwen1.5-32b [dense] — MHA-style GQA (kv=40) with QKV bias.
(copied from ``repro/configs/qwen1_5_32b.py``).

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("attn",),
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-0.5B",
)
