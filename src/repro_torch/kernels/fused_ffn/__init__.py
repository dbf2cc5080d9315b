from repro_torch.kernels.fused_ffn.ops import fused_ffn  # noqa: F401
