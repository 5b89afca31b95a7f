"""GNN layers and models via edge-index scatter (segment ops).

Message passing runs directly over an edge list: ``gather(src) -> edge
MLP -> segment sum/max(dst)``.  Every layer aggregates through the segment
scatter-sum kernel's custom op
(:func:`repro_torch.kernels.segment_spmm.ops.segment_sum`): :func:`forward`
sorts the destinations once (one segment plan per graph and forward) and
every aggregation of every layer reuses it.  gin and gcn sum ``h[src]``
straight from the node rows (the plan's order composed with ``src``), so
no ``[E, D]`` message tensor is made; gat and gatedgcn sum their per-edge
messages.  The device of the tensors chooses between the kernel and its
plain version.  The other segment sums (the gcn degree,
:func:`scatter_mean`, the graph readout) are ``index_add_``.
:func:`loss_fn` is the training loss; its gradient reaches every
aggregation through the segment sum's autograd (the same kernel on the
transposed plan for gin and gcn).

On a mesh (``mesh`` of more than one device; parameters, graph and batch
laid out by ``gnn_common.graph_shardings`` and the param specs) the
``constrain`` calls are the JAX package's, call for call: the node state
on the batch axes on its way into and out of every layer.  Between them
each rank works on its own edges (``sharding.scatter_local``): it builds
its segment plan from its edges, reads the node rows its edges touch
from the node state gathered whole (an all-gather), sums through B4 into
all N node rows as a partial sum, and the partial sum is reduced onto the
nodes' shards.  The degree, :func:`scatter_mean`, :func:`segment_softmax`
(a partial max, all-reduced, before its partial sum) and the graph
readout run per rank the same way.

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
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.segment_spmm import ops as spmm_ops

from . import sharding as shd
from .params import ParamSpec


def _segment_sum(values, segment_ids, num_segments):
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values)


def _reduced(x, like):
    """A partial sum over the rows' shards reduced onto ``like``'s
    placements (a node array: the nodes' shards); plain tensors as they
    are."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, like.placements)


def segment_sum_rows(values, segment_ids, num_segments):
    """``index_add_`` of ``values`` into ``num_segments`` rows by
    ``segment_ids``; on a mesh each rank adds its rows (the ids' shards)
    and the result is whole on every rank (a partial sum, all-reduced)."""
    return shd.whole(shd.scatter_local(
        lambda v, ids: _segment_sum(v, ids, num_segments), segment_ids,
        "partial", ("row", values), ("row", segment_ids)))


def segment_softmax(scores, segment_ids, num_segments, mask):
    """Numerically-stable softmax over edges grouped by destination.

    scores ``[E]`` or ``[E, H]`` (one softmax per column).  An empty or
    fully masked segment's max is -inf, as ``jax.ops.segment_max`` gives.
    On a mesh each rank takes the max of its edges per segment, the
    partial maxima are all-reduced (``Partial("max")``), then each rank
    sums its edges' exponentials into a partial sum, all-reduced; the
    max is a shift the softmax does not depend on, so no gradient is
    taken through it there (in exact arithmetic it has none).
    """
    if not isinstance(scores, DTensor):
        return _softmax_local(scores, segment_ids, num_segments, mask)

    def local_max(s, ids, m):
        return _segment_max(_masked(s, m)[0], ids, num_segments)

    row = ("row", segment_ids)
    seg_max = shd.whole(shd.scatter_local(
        local_max, segment_ids, "partial", ("row", scores.detach()), row,
        ("row", mask), reduce="max"))

    def local_exp(s, mx, ids, m):
        s, m = _masked(s, m)
        exp = _shifted_exp(s, mx, ids, m)
        return exp, _segment_sum(exp, ids, num_segments)

    exp, seg_sum = shd.scatter_local(
        local_exp, segment_ids, ("row", "partial"), ("row", scores),
        ("all", seg_max), row, ("row", mask))
    return shd.scatter_local(
        lambda e, tot, ids: e / (tot[ids.long()] + 1e-9), segment_ids,
        "row", ("row", exp), ("all", shd.whole(seg_sum)), row)


def _masked(scores, mask):
    """``scores`` at -inf where ``mask`` is off, and the mask broadcast to
    them."""
    m = mask if scores.dim() == 1 else mask[:, None]
    return torch.where(m, scores, float("-inf")), m


def _segment_max(scores, segment_ids, num_segments):
    idx = segment_ids.long()
    if scores.dim() > 1:
        idx = idx[:, None].expand_as(scores)
    seg_max = scores.new_full((num_segments, *scores.shape[1:]),
                              float("-inf"))
    return seg_max.scatter_reduce_(0, idx, scores, "amax",
                                   include_self=False)


def _shifted_exp(scores, seg_max, segment_ids, m):
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    return torch.where(m, torch.exp(scores - seg_max[segment_ids.long()]),
                       0.0)


def _softmax_local(scores, segment_ids, num_segments, mask):
    scores, m = _masked(scores, mask)
    exp = _shifted_exp(scores, _segment_max(scores, segment_ids,
                                            num_segments), segment_ids, m)
    seg_sum = _segment_sum(exp, segment_ids, num_segments)
    return exp / (seg_sum[segment_ids.long()] + 1e-9)


def scatter_mean(values, segment_ids, num_segments, mask):
    def local(v, ids, m):
        vals = torch.where(m[:, None], v, 0.0)
        tot = _segment_sum(vals, ids, num_segments)
        cnt = _segment_sum(m.to(v.dtype), ids, num_segments)
        return tot, cnt

    tot, cnt = shd.scatter_local(local, segment_ids, ("partial", "partial"),
                                 ("row", values), ("row", segment_ids),
                                 ("row", mask))
    return shd.whole(tot) / (shd.whole(cnt)[:, None] + 1e-9)


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
    segment plan of ``edge_dst``, and the gathers of node rows per edge.

    ``src_rows`` is ``plan.compose(edge_src)`` (gin and gcn).  The
    transposed plan that carries the gradient of :meth:`sources` back to
    the node rows is made once per graph, and only when a gradient is
    needed.  On a mesh the plan is this rank's (its own edges, summed
    into all N nodes); ``edges`` and ``nodes`` are an edge array and a
    node array of the graph, whose layouts the rank's edges and the
    nodes' shards follow."""

    def __init__(self, plan: spmm_ops.SegmentPlan,
                 src_rows: torch.Tensor | None = None, *, edges=None,
                 nodes=None):
        self.plan = plan
        self.src_rows = src_rows
        self.edge_layout, self.node_layout = edges, nodes
        self._transposed = None

    def per_edge(self, fn, *args):
        """``fn`` on this rank's edges (``scatter_local``'s ``args``), a
        per-edge result."""
        return shd.scatter_local(fn, self.edge_layout, "row", *args)

    def gather(self, x, index):
        """``x[index]`` per edge, ``x`` a node array."""
        return self.per_edge(lambda x_, i: x_[i.long()], ("all", x),
                             ("row", index))

    def edges(self, values):
        """Per node, the sum of ``values [E, D]`` over its in-edges."""
        return _reduced(shd.scatter_local(
            lambda v: spmm_ops.segment_sum(v, self.plan), self.edge_layout,
            "partial", ("row", values)), self.node_layout)

    def sources(self, x):
        """Per node, the sum of ``x[src]`` over its in-edges, read from the
        node rows of ``x [N, D]``."""

        def local(x_):
            transposed = None
            if x_.requires_grad and torch.is_grad_enabled():
                if self._transposed is None:
                    self._transposed = spmm_ops.transpose(
                        self.plan, self.src_rows, x_.shape[0])
                transposed = self._transposed
            return spmm_ops.segment_sum(x_, self.plan, self.src_rows,
                                        transposed)

        return _reduced(shd.scatter_local(local, self.edge_layout,
                                          "partial", ("all", x)),
                        self.node_layout)


def gcn_layer(h, lp, g, cfg, agg):
    n = h.shape[0]
    deg = _reduced(shd.scatter_local(
        lambda m, d: _segment_sum(m.to(torch.float32), d, n),
        g["edge_dst"], "partial", ("row", g["edge_mask"]),
        ("row", g["edge_dst"])), g["node_mask"])
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
    src, dst = ("row", g["edge_src"]), ("row", g["edge_dst"])
    hw = torch.einsum("nd,dhk->nhk", h, lp["w"])          # [N, H, hd]
    s_src = torch.einsum("nhk,hk->nh", hw, lp["a_src"])
    s_dst = torch.einsum("nhk,hk->nh", hw, lp["a_dst"])
    scores = agg.per_edge(                                 # [E, H]
        lambda a, b, s, d: F.leaky_relu(a[s.long()] + b[d.long()], 0.2),
        ("all", s_src), ("all", s_dst), src, dst)
    alpha = segment_softmax(scores, g["edge_dst"], n, g["edge_mask"])
    msg = agg.per_edge(                                    # [E, H * hd]
        lambda x, a, s: (x[s.long()] * a[..., None]).reshape(s.shape[0], -1),
        ("all", hw), ("row", alpha), src)
    out = F.elu(agg.edges(msg).reshape(n, cfg.d_hidden))
    return out + h


def _norm(x, scale):
    """Centre and scale by the population std (``jnp.std``'s ddof=0)."""
    x = x - x.mean(-1, keepdim=True)
    return x / (x.std(-1, keepdim=True, correction=0) + 1e-6) * (1.0 + scale)


def gatedgcn_layer(state, lp, g, cfg, agg):
    h, e = state
    src, dst = g["edge_src"], g["edge_dst"]
    gate_in = (agg.gather(h, src) @ lp["wa"] + agg.gather(h, dst) @ lp["wb"]
               + e @ lp["wc"])
    e_new = gate_in                                        # new edge features
    eta = torch.sigmoid(e_new)
    msg = eta * (agg.gather(h, src) @ lp["wv"])
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

def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def forward(params, g, cfg: GNNConfig, mesh=None):
    """g: graph batch dict -> logits ([N, classes] or [G, classes]).

    Runs on the device of ``params`` and ``g``; the stacked ``[L, ...]``
    layer parameters are applied one layer at a time, every aggregation on
    one segment plan of ``edge_dst``.  With ``cfg.remat`` each layer body
    is checkpointed while gradients are recorded (its intermediates are
    recomputed in the backward pass); the plan is made once, outside.  On
    a mesh ``params`` and ``g`` are DTensors laid out by their shardings,
    and the plan is this rank's, of its own edges.
    """
    n = g["node_feat"].shape[0]
    n_edges = g["edge_src"].shape[0]
    plan = spmm_ops.plan(_local(g["edge_dst"]), n, _local(g["edge_mask"]))
    agg = Aggregation(plan, plan.compose(_local(g["edge_src"]))
                      if cfg.kind in ("gcn", "gin") else None,
                      edges=g["edge_src"], nodes=g["node_mask"])
    h = F.relu(g["node_feat"] @ params["w_in"] + params["b_in"])
    h = shd.constrain(h, mesh, shd.BATCH, None)
    big = n_edges > 1_000_000

    def constrain_state(state):
        # node tensors over (pod, data); edge tensors over the whole mesh
        # when the graph is large enough to amortize the finer sharding
        def one(a):
            spec = ((shd.EDGE if big else shd.BATCH)
                    if a.shape[0] == n_edges else shd.BATCH)
            return shd.constrain(a, mesh, spec, None)

        if isinstance(state, tuple):
            return tuple(one(a) for a in state)
        return one(state)

    if cfg.kind == "gatedgcn":
        # [E, 1] ones laid out like the edges
        ones = torch.ones_like(g["edge_mask"], dtype=h.dtype)[:, None]
        e = ones @ params["w_edge_in"]
        state = (h, e)
    else:
        state = h
    base_fn = functools.partial(_LAYERS[cfg.kind], g=g, cfg=cfg, agg=agg)

    def layer_fn(s, lp):
        # constrain both the consumed and the produced state, as the JAX
        # package's scan body does
        return constrain_state(base_fn(constrain_state(s), lp))

    if cfg.remat and torch.is_grad_enabled():
        layer_fn = functools.partial(ckpt.checkpoint, layer_fn,
                                     use_reentrant=False)
    state = constrain_state(state)
    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in params["layers"].items()}
        state = layer_fn(state, lp)
    h = state[0] if cfg.kind == "gatedgcn" else state

    h = torch.where(g["node_mask"][:, None], h, 0.0)
    if cfg.readout == "graph":
        pooled = segment_sum_rows(h, g["graph_ids"], cfg.n_graphs)
        return pooled @ params["w_out"] + params["b_out"]
    return h @ params["w_out"] + params["b_out"]


def nll(logits, labels, rows=None):
    """``-log_softmax(logits)[i, labels[i]]`` per row (on a mesh each rank
    takes its rows, laid out like ``rows``)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return shd.scatter_local(
        lambda lp, y: -lp.gather(-1, y.long()[:, None])[:, 0],
        labels if rows is None else rows, "row", ("row", logp),
        ("row", labels))


def loss_fn(params, batch, cfg: GNNConfig, mesh=None):
    """Training loss: the mean squared error of the first logit against
    ``batch["targets"]`` when ``n_classes == 1`` (regression); else the
    negative log-likelihood of ``batch["labels"]``, averaged over the
    graphs (graph readout) or over the nodes of ``node_mask``."""
    logits = forward(params, batch, cfg, mesh)
    if cfg.n_classes == 1:   # regression (molecule energies)
        target = batch["targets"].to(torch.float32)
        return torch.mean(torch.square(logits[:, 0] - target))
    losses = nll(logits, batch["labels"])
    if cfg.readout == "graph":
        return torch.mean(losses)
    mask = batch["node_mask"].to(torch.float32)
    return torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
