"""Synthetic data pipelines (copied from ``repro/data/synthetic.py``: pure
numpy, so one seed gives the JAX package's arrays bitwise).

GRInteractionDataset — generative-recommendation interaction sequences with a
planted preference structure so the Climber model has real signal to learn:
each user has a latent taste vector; items have latent embeddings; history is
sampled by taste affinity and labels (click/like/finish) are Bernoulli in the
user-item affinity.  Zipf-distributed item popularity drives realistic cache
hit-rates for the PDA benchmark.

TokenDataset — LM token streams (markov-chain bigram structure, so loss can
fall below ln(V)) for the text-decoder architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class GRInteractionDataset:
    n_items: int = 100_000
    n_users: int = 10_000
    latent_dim: int = 16
    num_tasks: int = 3
    zipf_a: float = 1.3
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.item_latent = rng.standard_normal(
            (self.n_items, self.latent_dim)).astype(np.float32)
        self.user_latent = rng.standard_normal(
            (self.n_users, self.latent_dim)).astype(np.float32)
        self.task_bias = np.linspace(-1.0, 1.0, self.num_tasks).astype(np.float32)

    def _popular_items(self, rng, size) -> np.ndarray:
        return (rng.zipf(self.zipf_a, size=size) - 1) % self.n_items

    def sample_request(self, rng: np.random.Generator, n_history: int,
                       n_candidates: int) -> Dict[str, np.ndarray]:
        uid = rng.integers(self.n_users)
        taste = self.user_latent[uid]
        # history: popularity mixed with taste affinity
        pool = self._popular_items(rng, n_history * 4)
        aff = self.item_latent[pool] @ taste
        p = np.exp(aff - aff.max())
        p /= p.sum()
        history = rng.choice(pool, size=n_history, p=p)
        candidates = self._popular_items(rng, n_candidates)
        logits = self.item_latent[candidates] @ taste * 0.7
        labels = (rng.random((n_candidates, self.num_tasks))
                  < _sigmoid(logits[:, None] + self.task_bias)).astype(np.float32)
        side = np.concatenate([taste[:8], [n_history / 1024, n_candidates / 1024,
                                           1.0, 0.0]]).astype(np.float32)
        return {"history": history.astype(np.int32),
                "candidates": candidates.astype(np.int32),
                "side": side, "labels": labels, "user_id": uid}

    def batch(self, rng, batch_size: int, n_history: int, n_candidates: int
              ) -> Dict[str, np.ndarray]:
        reqs = [self.sample_request(rng, n_history, n_candidates)
                for _ in range(batch_size)]
        return {k: np.stack([r[k] for r in reqs]) for k in
                ("history", "candidates", "side", "labels")}


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@dataclasses.dataclass
class TokenDataset:
    """Markov bigram token stream: learnable structure for LM smoke training."""

    vocab_size: int = 1024
    branching: int = 8          # successors per token
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.successors = rng.integers(
            0, self.vocab_size, (self.vocab_size, self.branching)).astype(np.int32)

    def batch(self, rng, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        toks = np.empty((batch_size, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch_size)
        for t in range(1, seq_len):
            pick = rng.integers(0, self.branching, batch_size)
            toks[:, t] = self.successors[toks[:, t - 1], pick]
        return {"tokens": toks}


def make_batch_iterator(dataset, batch_size: int, seed: int = 0,
                        **kw) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield dataset.batch(rng, batch_size, **kw)
