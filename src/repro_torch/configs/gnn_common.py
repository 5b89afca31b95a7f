"""GNN shapes and the specialisation of an arch config to a shape."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    n_graphs: int = 0            # >0: batched small graphs, graph readout
    note: str = ""


# assigned shape set (4 cells per GNN arch)
GNN_SHAPES = (
    GNNShape("full_graph_sm", 2_708, 10_556, 1_433, 7,
             note="cora full-batch"),
    # 1024 seeds, fanout 15-10 two-hop sample of the 233k-node graph
    GNNShape("minibatch_lg", 169_984, 168_960, 602, 41,
             note="reddit-like sampled subgraph"),
    GNNShape("ogb_products", 2_449_029, 61_859_140, 100, 47,
             note="full-batch-large"),
    GNNShape("molecule", 30 * 128, 64 * 128, 16, 1, n_graphs=128,
             note="batch=128 small molecules (regression)"),
)


def _round_up(x, m):
    return -(-x // m) * m


def padded_sizes(shape: GNNShape) -> tuple[int, int]:
    """``(nodes, edges)`` of a shape's padded batch: nodes to a multiple of
    8, edges of 512, as the JAX package's ``graph_input_specs`` pads."""
    return _round_up(shape.n_nodes, 8), _round_up(shape.n_edges, 512)


def _specialize(cfg, shape: GNNShape):
    """Adapt an arch config to a shape's feature/class/readout layout."""
    return dataclasses.replace(
        cfg, d_in=shape.d_feat, n_classes=shape.n_classes,
        readout="graph" if shape.n_graphs else "node",
        n_graphs=shape.n_graphs,
    )
