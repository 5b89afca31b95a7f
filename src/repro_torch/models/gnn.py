"""GNN layers and models via edge-index scatter (segment ops).

Message passing runs directly over an edge list: ``gather(src) -> edge
MLP -> segment sum/max(dst)``.  The aggregation of every layer is
:func:`_gather_agg`, which always calls the segment scatter-sum kernel's
wrapper (:func:`repro_torch.kernels.segment_spmm.ops.scatter_sum`): the
device of the tensors chooses between the kernel and its plain version.
The other segment sums (the gcn degree, :func:`scatter_mean`, the graph
readout) are ``index_add_``.

Graphs are padded, fixed-shape batches:
  node_feat [N, F] f32, edge_src/edge_dst int32[E], node_mask bool[N],
  edge_mask bool[E], plus optional graph_ids int32[N] for batched small
  graphs and labels.  Invalid edges point at node 0 with mask 0 and are
  dropped inside every aggregation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_spmm import ops as spmm_ops

from . import sharding as shd
from .params import ParamSpec


def _segment_sum(values, segment_ids, num_segments):
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values)


def segment_softmax(scores, segment_ids, num_segments, mask):
    """Numerically-stable softmax over edges grouped by destination.

    scores ``[E]`` or ``[E, H]`` (one softmax per column).  An empty or
    fully masked segment's max is -inf, as ``jax.ops.segment_max`` gives.
    """
    m = mask if scores.dim() == 1 else mask[:, None]
    scores = torch.where(m, scores, float("-inf"))
    idx = segment_ids.long()
    if scores.dim() > 1:
        idx = idx[:, None].expand_as(scores)
    seg_max = scores.new_full((num_segments, *scores.shape[1:]),
                              float("-inf"))
    seg_max.scatter_reduce_(0, idx, scores, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.where(m, torch.exp(scores - seg_max[segment_ids.long()]),
                      0.0)
    seg_sum = _segment_sum(exp, segment_ids, num_segments)
    return exp / (seg_sum[segment_ids.long()] + 1e-9)


def scatter_mean(values, segment_ids, num_segments, mask):
    vals = torch.where(mask[:, None], values, 0.0)
    tot = _segment_sum(vals, segment_ids, num_segments)
    cnt = _segment_sum(mask.to(values.dtype), segment_ids, num_segments)
    return tot / (cnt[:, None] + 1e-9)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                  # gcn | gin | gat | gatedgcn
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    n_heads: int = 1
    readout: str = "node"      # node | graph
    n_graphs: int = 0          # static graph count for graph readout

    def n_params(self) -> int:
        from .params import count_params

        return count_params(gnn_param_specs(self))


def gnn_param_specs(cfg: GNNConfig) -> dict:
    f32 = torch.float32
    l, dh = cfg.n_layers, cfg.d_hidden
    specs: dict[str, Any] = {
        "w_in": ParamSpec((cfg.d_in, dh), f32, (None, shd.MODEL)),
        "b_in": ParamSpec((dh,), f32, (None,), init="zeros"),
        "w_out": ParamSpec((dh, cfg.n_classes), f32, (None, None)),
        "b_out": ParamSpec((cfg.n_classes,), f32, (None,), init="zeros"),
    }
    layer: dict[str, ParamSpec] = {}
    if cfg.kind == "gin":
        layer["mlp_w1"] = ParamSpec((l, dh, dh), f32, (None, None, shd.MODEL))
        layer["mlp_b1"] = ParamSpec((l, dh), f32, (None, None), init="zeros")
        layer["mlp_w2"] = ParamSpec((l, dh, dh), f32, (None, shd.MODEL, None))
        layer["mlp_b2"] = ParamSpec((l, dh), f32, (None, None), init="zeros")
        layer["eps"] = ParamSpec((l,), f32, (None,), init="zeros")
    elif cfg.kind == "gat":
        hd = dh // cfg.n_heads
        layer["w"] = ParamSpec((l, dh, cfg.n_heads, hd), f32,
                               (None, None, shd.MODEL, None))
        layer["a_src"] = ParamSpec((l, cfg.n_heads, hd), f32,
                                   (None, shd.MODEL, None))
        layer["a_dst"] = ParamSpec((l, cfg.n_heads, hd), f32,
                                   (None, shd.MODEL, None))
    elif cfg.kind == "gatedgcn":
        for nm in ("wu", "wv", "wa", "wb", "wc"):
            layer[nm] = ParamSpec((l, dh, dh), f32, (None, None, shd.MODEL))
        layer["bn_n"] = ParamSpec((l, dh), f32, (None, None), init="zeros")
        layer["bn_e"] = ParamSpec((l, dh), f32, (None, None), init="zeros")
        specs["w_edge_in"] = ParamSpec((1, dh), f32, (None, None))
    else:  # gcn
        layer["w"] = ParamSpec((l, dh, dh), f32, (None, None, shd.MODEL))
        layer["b"] = ParamSpec((l, dh), f32, (None, None), init="zeros")
    specs["layers"] = layer
    return specs


# ---------------------------------------------------------------------------
# layer forward passes (single layer; the model loops over the stack)
# ---------------------------------------------------------------------------

def _gather_agg(h_src_val, edge_dst, n, edge_mask):
    return spmm_ops.scatter_sum(h_src_val, edge_dst, n, edge_mask)


def gcn_layer(h, lp, g, cfg):
    n = h.shape[0]
    src = g["edge_src"].long()
    deg = _segment_sum(g["edge_mask"].to(torch.float32), g["edge_dst"], n)
    norm = torch.rsqrt(torch.clamp(deg, min=1.0))
    msg = h[src] * norm[src, None]
    agg = _gather_agg(msg, g["edge_dst"], n, g["edge_mask"])
    agg = agg * norm[:, None]
    out = agg @ lp["w"] + lp["b"]
    return F.relu(out) + h


def gin_layer(h, lp, g, cfg):
    n = h.shape[0]
    agg = _gather_agg(h[g["edge_src"].long()], g["edge_dst"], n,
                      g["edge_mask"])
    mixed = (1.0 + lp["eps"]) * h + agg
    out = F.relu(mixed @ lp["mlp_w1"] + lp["mlp_b1"])
    out = out @ lp["mlp_w2"] + lp["mlp_b2"]
    return F.relu(out) + h


def gat_layer(h, lp, g, cfg):
    n = h.shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    hw = torch.einsum("nd,dhk->nhk", h, lp["w"])          # [N, H, hd]
    s_src = torch.einsum("nhk,hk->nh", hw, lp["a_src"])
    s_dst = torch.einsum("nhk,hk->nh", hw, lp["a_dst"])
    scores = F.leaky_relu(s_src[src] + s_dst[dst], 0.2)   # [E, H]
    alpha = segment_softmax(scores, g["edge_dst"], n, g["edge_mask"])
    msg = hw[src] * alpha[..., None]                       # [E, H, hd]
    agg = _gather_agg(msg.reshape(msg.shape[0], -1), g["edge_dst"], n,
                      g["edge_mask"])
    out = F.elu(agg.reshape(n, cfg.d_hidden))
    return out + h


def _norm(x, scale):
    """Centre and scale by the population std (``jnp.std``'s ddof=0)."""
    x = x - x.mean(-1, keepdim=True)
    return x / (x.std(-1, keepdim=True, correction=0) + 1e-6) * (1.0 + scale)


def gatedgcn_layer(state, lp, g, cfg):
    h, e = state
    n = h.shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    gate_in = h[src] @ lp["wa"] + h[dst] @ lp["wb"] + e @ lp["wc"]
    e_new = gate_in                                        # new edge features
    eta = torch.sigmoid(e_new)
    msg = eta * (h[src] @ lp["wv"])
    num = _gather_agg(msg, g["edge_dst"], n, g["edge_mask"])
    den = _gather_agg(eta, g["edge_dst"], n, g["edge_mask"])
    agg = num / (den + 1e-6)
    h_new = h @ lp["wu"] + agg
    # lightweight norm standing in for batchnorm (full-batch graphs)
    h_new = _norm(h_new, lp["bn_n"])
    e_new = _norm(e_new, lp["bn_e"])
    return F.relu(h_new) + h, F.relu(e_new) + e


_LAYERS = {"gcn": gcn_layer, "gin": gin_layer, "gat": gat_layer,
           "gatedgcn": gatedgcn_layer}


# ---------------------------------------------------------------------------
# model forward
# ---------------------------------------------------------------------------

def forward(params, g, cfg: GNNConfig):
    """g: graph batch dict -> logits ([N, classes] or [G, classes]).

    Runs on the device of ``params`` and ``g``; the stacked ``[L, ...]``
    layer parameters are applied one layer at a time.
    """
    h = F.relu(g["node_feat"] @ params["w_in"] + params["b_in"])
    n_edges = g["edge_src"].shape[0]
    if cfg.kind == "gatedgcn":
        e = h.new_ones((n_edges, 1)) @ params["w_edge_in"]
        state = (h, e)
    else:
        state = h
    layer_fn = _LAYERS[cfg.kind]
    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in params["layers"].items()}
        state = layer_fn(state, lp, g, cfg)
    h = state[0] if cfg.kind == "gatedgcn" else state

    h = torch.where(g["node_mask"][:, None], h, 0.0)
    if cfg.readout == "graph":
        pooled = _segment_sum(h, g["graph_ids"], cfg.n_graphs)
        return pooled @ params["w_out"] + params["b_out"]
    return h @ params["w_out"] + params["b_out"]
