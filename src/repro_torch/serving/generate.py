"""Host-side beam/top-k bookkeeping for generative candidate decode.  Copy
of ``repro/serving/generate.py`` (numpy only).

The accelerator work of a decode step (vocab scoring + KV append) lives in
``core/climber.py`` / ``core/dso.py``; everything about *which* hypotheses
survive is plain numpy here so the search logic is independently testable
(invariants in ``tests/test_torch_generate.py``) and shared by
the engine and the tests.

Score convention: a hypothesis's score is the sum of per-step
log-probabilities (log-softmax over the step's token universe), so scores
are monotonically non-increasing as hypotheses grow — the invariant the
propcheck suite pins down.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def log_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Numerically-stable fp64 log-softmax (host-side ranking only)."""
    x = np.asarray(x, np.float64)
    m = np.max(x, axis=axis, keepdims=True)
    z = x - m
    return z - np.log(np.sum(np.exp(z), axis=axis, keepdims=True))


def beam_step(cum: np.ndarray, seqs: List[Tuple[int, ...]],
              finished: np.ndarray, step_logprobs: np.ndarray,
              width: int, eos: Optional[int],
              universe: Sequence[int]):
    """One beam-search transition over ``width`` live hypotheses.

    ``cum`` [W] cumulative logprobs; ``seqs`` the W token tuples so far;
    ``finished`` [W] bool; ``step_logprobs`` [W, V] this step's
    log-softmax over the token ``universe`` (ignored for finished rows).
    Returns ``(cum', seqs', finished', parents)`` where ``parents`` [W]
    maps each surviving hypothesis to the beam slot it extends (its own
    slot for finished pass-throughs) — the engine uses it to route KV
    appends.

    Invariants (propcheck-asserted): a finished hypothesis contributes
    exactly one candidate — itself, unextended, at its frozen score — so
    finished beams are never re-expanded; live extensions add a
    log-probability (``<= 0``) so ``max(cum')`` never exceeds
    ``max(cum)``; and because a (parent, token) pair is unique and the
    universe carries no duplicate ids, no two live hypotheses are ever
    identical."""
    w = len(cum)
    universe = np.asarray(universe)
    cand_scores: List[float] = []
    cand_src: List[Tuple[int, int]] = []      # (parent slot, token or -1)
    for i in range(w):
        if finished[i]:
            cand_scores.append(float(cum[i]))
            cand_src.append((i, -1))
        else:
            for j, tok in enumerate(universe):
                cand_scores.append(float(cum[i] + step_logprobs[i, j]))
                cand_src.append((i, int(tok)))
    order = np.argsort(-np.asarray(cand_scores), kind="stable")[:width]
    new_cum = np.asarray([cand_scores[o] for o in order], np.float64)
    new_seqs: List[Tuple[int, ...]] = []
    new_fin = np.zeros(len(order), bool)
    parents = np.zeros(len(order), np.int64)
    for slot, o in enumerate(order):
        parent, tok = cand_src[o]
        parents[slot] = parent
        if tok < 0:
            new_seqs.append(seqs[parent])
            new_fin[slot] = True
        else:
            new_seqs.append(seqs[parent] + (tok,))
            new_fin[slot] = (eos is not None and tok == eos)
    return new_cum, new_seqs, new_fin, parents
