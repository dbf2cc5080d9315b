"""Climber — the paper's own GR model (FLAME's serving workload).

The paper (Table 2) specifies 2 blocks x 12 layers and the SUMI scenarios
base (512 history + 128 candidates, 3.72 GFLOPs) / long (1024 + 512,
16.4 GFLOPs).  d_model is not published; d_model=256 reproduces the paper's
per-request GFLOPs to within ~2x and is recorded as an estimate in DESIGN.md.
Item/user features enter through an embedding table (vocab = item catalog).
"""
from repro_torch.types import ClimberConfig, ModelConfig

CONFIG = ModelConfig(
    name="climber",
    family="climber",
    n_layers=12,                 # per block; ClimberConfig.num_blocks blocks
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=2_000_000,        # item catalog size (music platform scale)
    activation="gelu",
    norm="layernorm",
    layer_pattern=("attn",),
    climber=ClimberConfig(num_blocks=2, layers_per_block=12,
                          num_tasks=3, num_experts_head=4,
                          adaptive_temperature=True),
    sub_quadratic=False,
    source="arXiv:2502.09888 (Climber) / FLAME Table 2",
)
