"""Device selection for the port's entry points.

Entry points (``FlameEngine``, ``climber_init``, the launcher) default to
``device="cuda"`` and raise when no GPU is present, unless the caller asks
for the CPU: nothing moves to the CPU silently."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path "
                f"on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"the port runs on cuda or cpu (meta: shapes "
                         f"alone), got {str(dev)!r}")
    return dev

