"""Synthetic graph batches matching the GNN shape specs (deterministic
stand-ins for real loaders)."""

from __future__ import annotations

import numpy as np
import torch


def random_graph_batch(
    *, n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
    n_graphs: int = 0, with_positions: bool = False, seed: int = 0,
    pad_nodes: int = 0, pad_edges: int = 0, device=None,
):
    """Padded, fixed-shape graph batch dict of tensors on ``device``
    (default CUDA, raising without one).  The numpy draws are the JAX
    package's, so one seed gives the same batch in both."""
    from repro_torch.core.executor import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = max(pad_nodes, n_nodes)
    e = max(pad_edges, n_edges)
    g = {
        "node_feat": np.zeros((n, d_feat), np.float32),
        "edge_src": np.zeros(e, np.int32),
        "edge_dst": np.zeros(e, np.int32),
        "node_mask": np.zeros(n, bool),
        "edge_mask": np.zeros(e, bool),
    }
    g["node_feat"][:n_nodes] = rng.standard_normal(
        (n_nodes, d_feat)).astype(np.float32)
    g["edge_src"][:n_edges] = rng.integers(0, n_nodes, n_edges)
    g["edge_dst"][:n_edges] = rng.integers(0, n_nodes, n_edges)
    g["node_mask"][:n_nodes] = True
    g["edge_mask"][:n_edges] = True
    if with_positions:
        g["positions"] = np.zeros((n, 3), np.float32)
        g["positions"][:n_nodes] = rng.standard_normal(
            (n_nodes, 3)).astype(np.float32)
    if n_graphs:
        per = n_nodes // n_graphs
        gid = np.zeros(n, np.int32)
        gid[:n_nodes] = np.minimum(
            np.arange(n_nodes) // max(per, 1), n_graphs - 1)
        g["graph_ids"] = gid
        if n_classes == 1:
            g["targets"] = rng.standard_normal(n_graphs).astype(np.float32)
        else:
            g["labels"] = rng.integers(
                0, n_classes, n_graphs).astype(np.int32)
    else:
        g["labels"] = rng.integers(0, n_classes, n).astype(np.int32)
    return {k: torch.as_tensor(v, device=device) for k, v in g.items()}


def make_csr(n_nodes: int, edge_src, edge_dst):
    """CSR adjacency by source: ``(indptr int64[n_nodes + 1], dst of the
    edges sorted stably by source)``."""
    order = np.argsort(edge_src, kind="stable")
    sorted_src = np.asarray(edge_src)[order]
    sorted_dst = np.asarray(edge_dst)[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, sorted_src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, sorted_dst
