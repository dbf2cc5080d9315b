"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
(copied from ``repro/configs/seamless_m4t_large_v2.py``).

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206  [arXiv:2308.11596]
Interpreted as 12 encoder + 12 decoder layers (24 total; see DESIGN.md §4).

The mel-spectrogram + conformer feature extractor is a stub, as in the JAX
package: the bundle's prefill takes precomputed frame embeddings
(``frames``; seq_len // 4 of them, mimicking 4x conv downsampling).
"""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers (12+12 = assigned 24L)
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,         # learned/sinusoidal positions; 0 disables RoPE
    layer_pattern=("attn",),
    modality="audio",
    frontend_tokens=0,      # dynamic: seq_len // 4 frames
    sub_quadratic=False,
    source="arXiv:2308.11596",
)
