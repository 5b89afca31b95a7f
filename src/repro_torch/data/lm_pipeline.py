"""Synthetic LM token pipeline (fleshed out with the training substrate)."""

from __future__ import annotations

import numpy as np


def synthetic_lm_batch(
    rng: np.random.Generator, *, batch: int, seq_len: int, vocab: int
):
    """One (tokens, targets) pair of int32[batch, seq_len]."""
    tokens = rng.integers(0, vocab, (batch, seq_len), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return tokens, targets


def batches(seed: int, *, batch: int, seq_len: int, vocab: int):
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_lm_batch(rng, batch=batch, seq_len=seq_len,
                                 vocab=vocab)
