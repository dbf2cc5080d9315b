"""Synthetic data for training and traffic (a copy of ``repro/data``)."""
from repro_torch.data.synthetic import (  # noqa: F401
    GRInteractionDataset, TokenDataset, make_batch_iterator)
