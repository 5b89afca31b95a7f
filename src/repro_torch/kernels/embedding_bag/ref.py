"""Plain PyTorch version of the embedding-bag kernel (B5).

``out[b] = sum_k weights[b, k] * table[ids[b, k]]``, summed over k in
ascending order in fp32 and cast to the table's dtype, as the TPU kernel
does.  Ids follow ``jnp.take``: a negative id >= -V wraps to ``id + V``,
any other id outside ``[0, V)`` gives a NaN row.  Duplicate ids in a bag
accumulate.  :func:`embedding_bag_fields` is the kernel's grouped form:
one bag per field, concatenated after the dense columns (DCN-v2's x0).
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


def check_fields(tables, ids, weights, dense=None, each=None) -> torch.dtype:
    """Shape and type checks of the grouped form, shared by the kernel
    wrapper and the plain version; returns x0's dtype.  The serving path
    pays it per forward, so it makes one pass over the tables, calling
    ``each(f, table)`` (the kernel wrapper's own work per table) after
    checking table ``f``."""
    if len(tables) == 0:
        raise ValueError("no tables")
    first = tables[0]
    width, dtype = first.shape[-1], first.dtype
    for f, t in enumerate(tables):
        shape = t.shape
        if len(shape) != 2:
            raise ValueError(f"table {f} has shape {tuple(shape)}, "
                             "expected [V, D]")
        if shape[1] != width:
            raise ValueError(f"table {f} has width {shape[1]}, expected "
                             f"{width} like table 0")
        if t.dtype != dtype:
            raise TypeError(f"table {f} has dtype {t.dtype}, expected "
                            f"{dtype} like table 0")
        if each is not None:
            each(f, t)
    if ids.dim() != 3 or ids.shape[1] != len(tables):
        raise ValueError(f"ids has shape {tuple(ids.shape)}, expected "
                         f"[B, {len(tables)}, K]")
    if weights.shape != ids.shape:
        raise ValueError(f"weights has shape {tuple(weights.shape)}, "
                         f"expected {tuple(ids.shape)}")
    if dense is None:
        return dtype
    if dense.dim() != 2 or dense.shape[0] != ids.shape[0]:
        raise ValueError(f"dense has shape {tuple(dense.shape)}, expected "
                         f"[{ids.shape[0]}, n_dense]")
    return torch.promote_types(dense.dtype, dtype)


def embedding_bag_fields(tables, ids, weights, dense=None):
    """tables: F ``[V_f, D]`` of one dtype, ids integer ``[B, F, K]``,
    weights ``[B, F, K]``, dense ``[B, n_dense]`` or None -> ``x0 = [dense
    || bag_0 || ... || bag_{F-1}]`` (each bag by :func:`embedding_bag`, then
    ``torch.cat``, which promotes to x0's dtype)."""
    check_fields(tables, ids, weights, dense)
    bags = [embedding_bag(t, ids[:, f], weights[:, f])
            for f, t in enumerate(tables)]
    return torch.cat(([] if dense is None else [dense]) + bags, dim=-1)
