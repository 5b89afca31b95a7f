"""Uniform fanout neighbor sampler (GraphSAGE-style) for minibatch_lg.

Host-side numpy: given a CSR adjacency, sample a two-hop (fanout 15-10)
subgraph around a seed batch and emit a padded fixed-shape graph batch whose
layout matches the padded batches of ``data.graph_data`` — this is the
real sampled-training data path, not a stub.
"""

from __future__ import annotations

import numpy as np


def sample_subgraph(
    indptr, indices, seeds, *, fanouts=(15, 10), rng=None,
    pad_nodes: int | None = None, pad_edges: int | None = None,
):
    """Sample a k-hop subgraph.

    Returns dict with local edge lists (src/dst index into `nodes`),
    `nodes` (global ids, seeds first), and padded masks.
    """
    rng = rng or np.random.default_rng(0)
    seeds = np.asarray(seeds, np.int64)
    node_ids = [seeds]
    edge_src_g, edge_dst_g = [], []
    frontier = seeds
    for fanout in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = int(indptr[u]), int(indptr[u + 1])
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            sel = rng.choice(deg, size=take, replace=False)
            nbrs = indices[lo + sel]
            nxt.append(nbrs)
            edge_src_g.append(nbrs)
            edge_dst_g.append(np.full(take, u, np.int64))
        frontier = np.concatenate(nxt) if nxt else np.zeros(0, np.int64)
        node_ids.append(frontier)

    # relabel in first-occurrence order (seeds come first)
    all_ids = np.concatenate(node_ids)
    _, first_pos = np.unique(all_ids, return_index=True)
    nodes = all_ids[np.sort(first_pos)]
    lookup = {int(g): i for i, g in enumerate(nodes)}
    src = np.asarray(
        [lookup[int(g)] for g in np.concatenate(edge_src_g)]
        if edge_src_g else [], np.int32)
    dst = np.asarray(
        [lookup[int(g)] for g in np.concatenate(edge_dst_g)]
        if edge_dst_g else [], np.int32)

    n = pad_nodes or len(nodes)
    e = pad_edges or len(src)
    out = {
        "nodes": np.zeros(n, np.int64),
        "edge_src": np.zeros(e, np.int32),
        "edge_dst": np.zeros(e, np.int32),
        "node_mask": np.zeros(n, bool),
        "edge_mask": np.zeros(e, bool),
        "n_real_nodes": len(nodes),
        "n_real_edges": len(src),
        "n_seeds": len(seeds),
    }
    k_n = min(len(nodes), n)
    k_e = min(len(src), e)
    out["nodes"][:k_n] = nodes[:k_n]
    out["edge_src"][:k_e] = src[:k_e]
    out["edge_dst"][:k_e] = dst[:k_e]
    out["node_mask"][:k_n] = True
    out["edge_mask"][:k_e] = True
    return out
