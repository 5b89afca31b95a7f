"""GNN shapes, the specialisation of an arch config to a shape, input
stand-ins, their shardings and the training workload (the GNN archs and
equiformer), on no mesh or on any mesh: each model's loss takes the mesh,
whose layouts ``graph_shardings`` and the param specs give.  The GNN
archs sum through the segment scatter-sum kernel's custom op (B4) in
``gnn.Aggregation``; the equiformer's node sums are ``index_add_``.  On
a mesh both run per rank, on each rank's edges."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import equiformer, gnn, params as prm, \
    sharding as shd
from repro_torch.training import optimizer
from repro_torch.training.tree import value_and_grad

from .common import Workload, _replicated


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


def graph_input_specs(shape: GNNShape, *, with_positions: bool,
                      edge_mult: int = 1) -> dict:
    """Meta-tensor stand-ins for a padded graph batch."""
    n = _round_up(shape.n_nodes, 8)
    e = _round_up(shape.n_edges, max(edge_mult, 512))

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    g = {
        "node_feat": sds((n, shape.d_feat), torch.float32),
        "edge_src": sds((e,), torch.int32),
        "edge_dst": sds((e,), torch.int32),
        "node_mask": sds((n,), torch.bool),
        "edge_mask": sds((e,), torch.bool),
    }
    if with_positions:
        g["positions"] = sds((n, 3), torch.float32)
    if shape.n_graphs:
        g["graph_ids"] = sds((n,), torch.int32)
        if shape.n_classes == 1:
            g["targets"] = sds((shape.n_graphs,), torch.float32)
        else:
            g["labels"] = sds((shape.n_graphs,), torch.int32)
    else:
        g["labels"] = sds((n,), torch.int32)
    return g


def graph_shardings(mesh, sds_tree) -> dict:
    """Edge arrays use the whole mesh on big graphs; (pod, data) otherwise
    (512-way shards of a 10k-edge graph are pure collective overhead)."""
    e_len = sds_tree["edge_src"].shape[0]
    edge_spec = shd.EDGE if e_len > 1_000_000 else shd.BATCH

    def shard(sds):
        lead = edge_spec if sds.shape[0] == e_len else shd.BATCH
        spec = (lead,) + (None,) * (sds.ndim - 1)
        return shd.named_sharding(mesh, spec, sds.shape)

    return {k: shard(v) for k, v in sds_tree.items()}


def _specialize(cfg, shape: GNNShape):
    """Adapt an arch config to a shape's feature/class/readout layout."""
    if isinstance(cfg, equiformer.EquiformerConfig):
        return dataclasses.replace(
            cfg, d_node_in=shape.d_feat, n_classes=shape.n_classes,
            readout="graph" if shape.n_graphs else "node",
            n_graphs=shape.n_graphs,
            edge_chunk=262_144 if shape.n_edges > 1_000_000 else 0,
        )
    return dataclasses.replace(
        cfg, d_in=shape.d_feat, n_classes=shape.n_classes,
        readout="graph" if shape.n_graphs else "node",
        n_graphs=shape.n_graphs,
        # remat pays recompute to bound memory — only worth it at scale
        remat=shape.n_edges > 1_000_000,
    )


def gnn_workload(cfg, shape: GNNShape, mesh,
                 opt_cfg: optimizer.AdamWConfig | None = None) -> Workload:
    """The training step of a GNN arch or equiformer on ``shape``:
    ``value_and_grad`` of the model's loss and AdamW (no weight decay by
    default)."""
    opt_cfg = opt_cfg or optimizer.AdamWConfig(weight_decay=0.0)
    is_eq = isinstance(cfg, equiformer.EquiformerConfig)
    cfg = _specialize(cfg, shape)
    if is_eq:
        specs = equiformer.equiformer_param_specs(cfg)
        grad_fn = value_and_grad(equiformer.loss_fn)
        edge_mult = cfg.edge_chunk or 1
    else:
        specs = gnn.gnn_param_specs(cfg)
        grad_fn = value_and_grad(gnn.loss_fn)
        edge_mult = 1

    p_sds = prm.tree_sds(specs)
    o_sds = optimizer.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=p_sds, nu=p_sds)
    g_sds = graph_input_specs(shape, with_positions=is_eq,
                              edge_mult=edge_mult)
    shardings = None
    if mesh is not None:
        p_shd = prm.tree_shardings(mesh, specs)
        shardings = (p_shd, optimizer.AdamWState(
            step=_replicated(mesh), mu=p_shd, nu=p_shd),
            graph_shardings(mesh, g_sds))

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch, cfg, mesh)
        new_p, new_o, metrics = optimizer.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return new_p, new_o, metrics

    # message-passing "model flops": 2 * E * d_hidden^2 matmul-dominated per
    # layer (+ irrep factor for equiformer) — the useful-work yardstick.
    d = cfg.d_hidden
    if is_eq:
        per_edge = sum(
            2 * ((cfg.l_max + 1 - m) * d) ** 2 * (2 if m else 1)
            for m in range(cfg.m_max + 1)
        )
        flops = cfg.n_layers * shape.n_edges * per_edge
    else:
        flops = cfg.n_layers * (2 * shape.n_edges * d
                                + 2 * shape.n_nodes * d * d)
    return Workload(
        name=f"{cfg.name}/{shape.name}", kind="train", fn=step,
        in_sds=(p_sds, o_sds, g_sds), in_shardings=shardings,
        model_flops=3.0 * flops,   # fwd + bwd ~ 3x forward
    )
