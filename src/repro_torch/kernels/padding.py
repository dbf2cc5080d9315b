"""Head-dim padding shared by the kernel wrappers.

A kernel is instantiated for a few head dims; a wrapper runs any other dim
at the next instantiated one, as the TPU wrappers pad D to their 128 lanes:
the operands get zero columns, the softmax scale stays that of the unpadded
dim, and the output is sliced back.  Zero columns add nothing to a dot
product and give zero output columns, so the result is the unpadded
function's."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def padded_dim(d: int, dims: Sequence[int], what: str = "head dim") -> int:
    """The smallest of ``dims`` that holds ``d``; raises past the largest."""
    for n in sorted(dims):
        if d <= n:
            return n
    raise ValueError(f"{what} {d} exceeds the kernel's largest "
                     f"instantiation {max(dims)}")


def pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zeros appended on its last axis up to width ``n``."""
    extra = n - t.shape[-1]
    return F.pad(t, (0, extra)) if extra else t
