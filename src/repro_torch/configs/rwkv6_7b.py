"""rwkv6-7b (Finch) [ssm] — attention-free, data-dependent decay linear
attention (copied from ``repro/configs/rwkv6_7b.py``).

32L d_model=4096 d_ff=14336 vocab=65536  [arXiv:2404.05892]
State is O(1) in sequence length.

The paper's mask-aware flash-attention kernel does not apply (no
attention); the fused-kernel idea maps to the chunked wkv scan instead,
kernel K5 (``kernels/rwkv6_scan``) on every prefill's time-mix.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # 4096 / head_size 64
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    activation="relu",     # channel-mix uses squared relu
    norm="layernorm",
    layer_pattern=("rwkv",),
    rwkv_head_size=64,
    sub_quadratic=True,
    source="arXiv:2404.05892",
)
