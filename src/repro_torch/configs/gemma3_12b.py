"""gemma3-12b [dense] — 5:1 local:global attention interleave, 128k context
(copied from ``repro/configs/gemma3_12b.py``).

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144  [hf:google/gemma-3-1b-pt]
head_dim = 3840/16 = 240.  Layer pattern period 6: 5 sliding-window (1024) + 1
global.  On the port's text engine the ``swa`` layers keep ring caches of
``min(1024, max_len)`` slots and the ``attn`` layers a full cache, which
decodes through kernel K4's single-token form under ``impl="pallas"``; K2
runs every prefill's attention (``sliding`` and ``causal``) and K3 every FFN.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    activation="gelu",
    norm="rmsnorm",
    sliding_window=1024,
    layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)
