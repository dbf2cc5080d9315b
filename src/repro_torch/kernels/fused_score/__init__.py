from repro_torch.kernels.fused_score.ops import (  # noqa: F401
    fused_cached_attention, fused_decode_attention, fused_extend_attention)
