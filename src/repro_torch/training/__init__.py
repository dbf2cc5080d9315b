"""Training: AdamW, the train loop and checkpoints (port of
``repro/training``)."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update)
