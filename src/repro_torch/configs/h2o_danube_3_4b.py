"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
(copied from ``repro/configs/h2o_danube_3_4b.py``).

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000  [arXiv:2401.16818]
SWA on all layers (mistral-style, window 4096).  On the port's text engine
every cache is a ring (``min(4096, max_len)`` slots); K2 runs every
prefill's ``sliding`` attention at head dim 120 and K3 every swiglu FFN.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    sliding_window=4096,
    layer_pattern=("swa",),
    sub_quadratic=True,
    source="arXiv:2401.16818",
)
