"""PTMT x GNN integration: motif-transition features for node
classification.

    PYTHONPATH=src python -m repro_torch.examples.motif_features \\
        [--device cpu] [--steps 60]

Mines motif-transition processes from a temporal interaction stream,
builds per-node participation histograms over the top transition types,
and trains the `gin-tu` GNN with and without the motif features — the
paper's "motif statistics as structural signal" use case, end to end:
mining through the zone-scan kernel, training through the segment
scatter-sum kernel forward and backward.  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import MiningConfig, PTMTEngine, oracle
from repro_torch.core.encoding import decode_code_np, encode_process_np
from repro_torch.core.executor import resolve_device
from repro_torch.data.synthetic_graphs import triadic_stream
from repro_torch.models import gnn
from repro_torch.models.params import tree_init
from repro_torch.training import optimizer
from repro_torch.training.tree import value_and_grad


def mine_features(device=None):
    """Mine the stream and build the node features and labels.

    Returns ``(graph, result, top_codes, feat, labels)``: ``feat
    [n_nodes, 9]`` float32 is ``log1p`` of each node's participation in
    the 8 most frequent transition types and in all processes; ``labels``
    marks the nodes above the median of the first column.
    """
    # --- 1. mine motif transition processes ----------------------------
    graph = triadic_stream(4_000, 120, window=200, p_close=0.55, seed=3)
    engine = PTMTEngine(MiningConfig(delta=100, l_max=3, omega=6,
                                     backend="cuda"), device=device)
    res = engine.discover(graph)
    top_codes = [c for c, _ in sorted(res.counts.items(),
                                      key=lambda kv: -kv[1])[:8]]

    # --- 2. per-node participation histogram over top transition types --
    procs = oracle.enumerate_processes(graph.u, graph.v, graph.t, 100, 3)
    feat = np.zeros((graph.n_nodes, len(top_codes) + 1), np.float32)
    code_idx = {c: i for i, c in enumerate(top_codes)}
    for edges in procs:
        code = decode_code_np(encode_process_np(
            [(int(graph.u[e]), int(graph.v[e])) for e in edges], 3))
        idx = code_idx.get(code)
        nodes = {int(graph.u[e]) for e in edges} | {
            int(graph.v[e]) for e in edges}
        for n in nodes:
            if idx is not None:
                feat[n, idx] += 1
            feat[n, -1] += 1
    feat = np.log1p(feat)

    # --- 3. node classification: predict high-triadic-activity nodes ----
    labels = (feat[:, 0] > np.median(feat[:, 0])).astype(np.int32)
    return graph, res, top_codes, feat, labels


def graph_batch(graph, feat, labels, *, with_motifs: bool, device):
    """The training graph: node degree (and the motif features), every
    edge and node kept."""
    deg = np.zeros(graph.n_nodes)
    np.add.at(deg, graph.u, 1)
    np.add.at(deg, graph.v, 1)
    base = deg[:, None].astype(np.float32)
    x = np.concatenate([base, feat], 1) if with_motifs else base
    n_edges = len(graph.u)
    return {
        "node_feat": torch.as_tensor(x, device=device),
        "edge_src": torch.as_tensor(np.asarray(graph.u, np.int32),
                                    device=device),
        "edge_dst": torch.as_tensor(np.asarray(graph.v, np.int32),
                                    device=device),
        "node_mask": torch.ones(graph.n_nodes, dtype=torch.bool,
                                device=device),
        "edge_mask": torch.ones(n_edges, dtype=torch.bool, device=device),
        "labels": torch.as_tensor(labels, device=device),
    }


def train(g, *, steps: int = 60, seed: int = 0):
    """Train the gin-tu smoke config on ``g`` with AdamW for ``steps``
    full-batch steps; returns ``(last loss, accuracy)``."""
    device = g["node_feat"].device
    cfg = dataclasses.replace(
        get_arch("gin-tu").smoke_config,
        d_in=g["node_feat"].shape[1], n_classes=2)
    params = tree_init(gnn.gnn_param_specs(cfg),
                       generator=torch.Generator().manual_seed(seed),
                       device=device)
    state = optimizer.init_state(params)
    opt_cfg = optimizer.AdamWConfig(lr=5e-3, warmup_steps=1,
                                    weight_decay=0.0)
    grad_fn = value_and_grad(gnn.loss_fn)
    loss = torch.zeros(())
    for _ in range(steps):
        loss, grads = grad_fn(params, g, cfg)
        params, state, _ = optimizer.apply_updates(opt_cfg, params, grads,
                                                   state)
    with torch.no_grad():
        logits = gnn.forward(params, g, cfg)
    acc = float((torch.argmax(logits, -1) == g["labels"]).float().mean())
    return float(loss), acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: CUDA)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    graph, res, top_codes, feat, labels = mine_features(device)
    print(f"mined {len(res.counts)} motif types; top: {top_codes[:4]}")
    print("\ntraining gin-tu node classifier:")
    accs = []
    for with_motifs in (False, True):
        g = graph_batch(graph, feat, labels, with_motifs=with_motifs,
                        device=device)
        loss, acc = train(g, steps=args.steps)
        print(f"  {'with' if with_motifs else 'without'} motif features: "
              f"loss={loss:.3f} acc={acc:.3f}")
        accs.append(acc)
    print(f"\nmotif features improve accuracy: {accs[0]:.3f} -> "
          f"{accs[1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
