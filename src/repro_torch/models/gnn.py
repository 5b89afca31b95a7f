"""GNN layers and models via edge-index scatter (segment ops).

Message passing runs directly over an edge list: ``gather(src) -> edge
MLP -> segment sum/max(dst)``.  Every layer aggregates through the segment
scatter-sum kernel's wrapper
(:func:`repro_torch.kernels.segment_spmm.ops.segment_sum`): :func:`forward`
sorts the destinations once (one segment plan per graph and forward) and
every aggregation of every layer reuses it.  gin and gcn sum ``h[src]``
straight from the node rows (the plan's order composed with ``src``), so
no ``[E, D]`` message tensor is made; gat and gatedgcn sum their per-edge
messages.  The device of the tensors chooses between the kernel and its
plain version.  The other segment sums (the gcn degree,
:func:`scatter_mean`, the graph readout) are ``index_add_``.
:func:`loss_fn` is the training loss; its gradient reaches every
aggregation through the segment sum's autograd Function (the same kernel
on the transposed plan for gin and gcn).

Graphs are padded, fixed-shape batches:
  node_feat [N, F] f32, edge_src/edge_dst int32[E], node_mask bool[N],
  edge_mask bool[E], plus optional graph_ids int32[N] for batched small
  graphs and labels.  Invalid edges point at node 0 with mask 0 and are
  dropped inside every aggregation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

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
    remat: bool = True         # checkpoint layer bodies (full-batch bwd)

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

class Aggregation:
    """The sums over a graph's in-edges (masked edges dropped), on one
    segment plan of ``edge_dst``.

    ``src_rows`` is ``plan.compose(edge_src)`` (gin and gcn).  The
    transposed plan that carries the gradient of :meth:`sources` back to
    the node rows is made once per graph, and only when a gradient is
    needed."""

    def __init__(self, plan: spmm_ops.SegmentPlan,
                 src_rows: torch.Tensor | None = None):
        self.plan = plan
        self.src_rows = src_rows
        self._transposed = None

    def edges(self, values):
        """Per node, the sum of ``values [E, D]`` over its in-edges."""
        return spmm_ops.segment_sum(values, self.plan)

    def sources(self, x):
        """Per node, the sum of ``x[src]`` over its in-edges, read from the
        node rows of ``x [N, D]``."""
        transposed = None
        if x.requires_grad and torch.is_grad_enabled():
            if self._transposed is None:
                self._transposed = spmm_ops.transpose(
                    self.plan, self.src_rows, x.shape[0])
            transposed = self._transposed
        return spmm_ops.segment_sum(x, self.plan, self.src_rows, transposed)


def gcn_layer(h, lp, g, cfg, agg):
    n = h.shape[0]
    deg = _segment_sum(g["edge_mask"].to(torch.float32), g["edge_dst"], n)
    norm = torch.rsqrt(torch.clamp(deg, min=1.0))
    # h[src] * norm[src, None] per edge, scaled per node before the gather
    out = agg.sources(h * norm[:, None]) * norm[:, None]
    out = out @ lp["w"] + lp["b"]
    return F.relu(out) + h


def gin_layer(h, lp, g, cfg, agg):
    mixed = (1.0 + lp["eps"]) * h + agg.sources(h)
    out = F.relu(mixed @ lp["mlp_w1"] + lp["mlp_b1"])
    out = out @ lp["mlp_w2"] + lp["mlp_b2"]
    return F.relu(out) + h


def gat_layer(h, lp, g, cfg, agg):
    n = h.shape[0]
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    hw = torch.einsum("nd,dhk->nhk", h, lp["w"])          # [N, H, hd]
    s_src = torch.einsum("nhk,hk->nh", hw, lp["a_src"])
    s_dst = torch.einsum("nhk,hk->nh", hw, lp["a_dst"])
    scores = F.leaky_relu(s_src[src] + s_dst[dst], 0.2)   # [E, H]
    alpha = segment_softmax(scores, g["edge_dst"], n, g["edge_mask"])
    msg = hw[src] * alpha[..., None]                       # [E, H, hd]
    out = F.elu(agg.edges(msg.reshape(msg.shape[0], -1)).reshape(
        n, cfg.d_hidden))
    return out + h


def _norm(x, scale):
    """Centre and scale by the population std (``jnp.std``'s ddof=0)."""
    x = x - x.mean(-1, keepdim=True)
    return x / (x.std(-1, keepdim=True, correction=0) + 1e-6) * (1.0 + scale)


def gatedgcn_layer(state, lp, g, cfg, agg):
    h, e = state
    src, dst = g["edge_src"].long(), g["edge_dst"].long()
    gate_in = h[src] @ lp["wa"] + h[dst] @ lp["wb"] + e @ lp["wc"]
    e_new = gate_in                                        # new edge features
    eta = torch.sigmoid(e_new)
    msg = eta * (h[src] @ lp["wv"])
    h_new = h @ lp["wu"] + agg.edges(msg) / (agg.edges(eta) + 1e-6)
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
    layer parameters are applied one layer at a time, every aggregation on
    one segment plan of ``edge_dst``.  With ``cfg.remat`` each layer body
    is checkpointed while gradients are recorded (its intermediates are
    recomputed in the backward pass); the plan is made once, outside.
    """
    n = g["node_feat"].shape[0]
    plan = spmm_ops.plan(g["edge_dst"], n, g["edge_mask"])
    agg = Aggregation(plan, plan.compose(g["edge_src"])
                      if cfg.kind in ("gcn", "gin") else None)
    h = F.relu(g["node_feat"] @ params["w_in"] + params["b_in"])
    n_edges = g["edge_src"].shape[0]
    if cfg.kind == "gatedgcn":
        e = h.new_ones((n_edges, 1)) @ params["w_edge_in"]
        state = (h, e)
    else:
        state = h
    layer_fn = functools.partial(_LAYERS[cfg.kind], g=g, cfg=cfg, agg=agg)
    if cfg.remat and torch.is_grad_enabled():
        layer_fn = functools.partial(ckpt.checkpoint, layer_fn,
                                     use_reentrant=False)
    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in params["layers"].items()}
        state = layer_fn(state, lp)
    h = state[0] if cfg.kind == "gatedgcn" else state

    h = torch.where(g["node_mask"][:, None], h, 0.0)
    if cfg.readout == "graph":
        pooled = _segment_sum(h, g["graph_ids"], cfg.n_graphs)
        return pooled @ params["w_out"] + params["b_out"]
    return h @ params["w_out"] + params["b_out"]


def loss_fn(params, batch, cfg: GNNConfig):
    """Training loss: the mean squared error of the first logit against
    ``batch["targets"]`` when ``n_classes == 1`` (regression); else the
    negative log-likelihood of ``batch["labels"]``, averaged over the
    graphs (graph readout) or over the nodes of ``node_mask``."""
    logits = forward(params, batch, cfg)
    if cfg.n_classes == 1:   # regression (molecule energies)
        target = batch["targets"].to(torch.float32)
        return torch.mean(torch.square(logits[:, 0] - target))
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    if cfg.readout == "graph":
        return torch.mean(nll)
    mask = batch["node_mask"].to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
