"""Synthetic recsys (Criteo-like) batch generator for DCN-v2."""

from __future__ import annotations

import numpy as np


def synthetic_recsys_batch(
    rng: np.random.Generator,
    *,
    batch: int,
    n_dense: int,
    n_sparse: int,
    vocab_sizes,
):
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, v, batch, dtype=np.int32) for v in vocab_sizes],
        axis=1,
    )
    # CTR-ish label correlated with a few dense features
    logits = dense[:, :3].sum(axis=1) * 0.5
    label = (logits + rng.standard_normal(batch) > 0.5).astype(np.float32)
    return dense, sparse, label
