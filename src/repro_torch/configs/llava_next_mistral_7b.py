"""llava-next-mistral-7b [vlm] — Mistral-7B backbone, anyres vision tiling.
(copied from ``repro/configs/llava_next_mistral_7b.py``).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT frontend is a stub, as in the JAX package: the bundle's prefill
takes precomputed patch embeddings (``patch_embeds``; anyres: up to 5 tiles
x 576 patches = 2880 image tokens), which the ``projector`` maps and
prepends to the text sequence.
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    layer_pattern=("attn",),
    modality="vision",
    frontend_tokens=2880,   # anyres: 5 tiles x 576 patches
    sub_quadratic=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
