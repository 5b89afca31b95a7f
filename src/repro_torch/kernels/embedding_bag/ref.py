"""Plain PyTorch version of the embedding-bag kernel (B5).

``out[b] = sum_k weights[b, k] * table[ids[b, k]]``, summed over k in
ascending order in fp32 and cast to the table's dtype, as the TPU kernel
does.  Ids follow ``jnp.take``: a negative id >= -V wraps to ``id + V``,
any other id outside ``[0, V)`` gives a NaN row.  Duplicate ids in a bag
accumulate.
"""

from __future__ import annotations

import torch


def check_inputs(table, ids, weights) -> None:
    if table.dim() != 2:
        raise ValueError(f"table has shape {tuple(table.shape)}, "
                         "expected [V, D]")
    if ids.dim() != 2:
        raise ValueError(f"ids has shape {tuple(ids.shape)}, expected [B, K]")
    if weights.shape != ids.shape:
        raise ValueError(f"weights has shape {tuple(weights.shape)}, "
                         f"expected {tuple(ids.shape)}")


def embedding_bag(table, ids, weights):
    """table ``[V, D]``, ids integer ``[B, K]``, weights ``[B, K]`` ->
    ``[B, D]`` in the table's dtype (``index_select`` plus a weighted sum
    over k in fp32)."""
    check_inputs(table, ids, weights)
    v = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    ok = (idx >= 0) & (idx < v)
    rows = table.index_select(0, torch.where(ok, idx, 0).reshape(-1))
    rows = rows.reshape(*ids.shape, table.shape[1]).float()
    rows = torch.where(ok[..., None], rows, float("nan"))
    w = weights.float()
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(ids.shape[1]):
        acc = acc + w[:, k, None] * rows[:, k]
    return acc.to(table.dtype)
