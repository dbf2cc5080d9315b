from repro_torch.kernels.flash_decode.ops import (  # noqa: F401
    flash_decode, flash_decode_with_self)
