"""qwen2-72b [dense] — GQA with QKV bias.
(copied from ``repro/configs/qwen2_72b.py``).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064  [arXiv:2407.10671]
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("attn",),
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2407.10671",
)
