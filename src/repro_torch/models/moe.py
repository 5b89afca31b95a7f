"""Mixture-of-Experts block: top-k routing with sort-based dispatch, as
the JAX package's ``models/moe.py`` computes it.

Token->expert assignments are sorted by expert id (a stable sort),
compacted into a capacity-bounded ``[E, C, D]`` buffer whose extra last
row takes the dropped assignments, run through a batched per-expert GEMM,
and scattered back with the combine weights.  Capacity overflow drops
tokens (GShard semantics).  Top-k breaks ties by the lower expert index,
as ``jax.lax.top_k`` does (``torch.topk`` does not): it is the first ``k``
of a stable descending sort.  Token groups run as a Python loop.

On a mesh (a DTensor ``x``) the groups ride the batch axes, as in the JAX
package's vmapped dispatch: each rank sorts, dispatches and combines its
own groups (``sharding.local_call``; DTensor has no rule for the stable
sort and index writes), the ``[G, E, C, D]`` buffers meet the ``model``
axis on their expert dimension, and each rank runs its experts' MLPs on
its groups.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import sharding as shd
from .layers import swiglu


def _top_k(probs, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    equal values in index order."""
    if isinstance(probs, DTensor):
        return shd.rowwise(lambda p: _top_k(p, k), probs, n_out=2)
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def router_topk(x, w_router, *, top_k: int, dtype=torch.float32):
    """Softmax router with renormalized top-k weights.

    x: [T, D] -> (weights [T, k] f32, experts [T, k] int64)
    """
    logits = x.to(dtype) @ shd.gathered(w_router).to(dtype)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return top_p, top_e


def _dispatch_group(xs, es, *, n_experts: int, capacity: int, top_k: int):
    """Sort-dispatch one token group. xs: [S, D], es: [S, k] ->
    (buf [E, C, D], slot [S*k], keep [S*k], order [S*k])."""
    d = xs.shape[1]
    flat_e = es.reshape(-1)
    sk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount by a scatter of ones: its output's size does not depend on
    # the data, so fake tensors (the dry run) can trace it
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=xs.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sk, device=xs.device) - starts[sorted_e]
    keep = rank < capacity
    slot = torch.where(keep, sorted_e * capacity + rank,
                       n_experts * capacity)
    gathered = xs[order // top_k]                              # [S*k, D]
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=xs.dtype,
                      device=xs.device)
    buf[slot] = gathered          # drops land in the last row, cut below
    return (buf[: n_experts * capacity].reshape(n_experts, capacity, d),
            slot, keep, order)


def _combine_group(out_buf, slot, keep, order, weights, *, top_k: int):
    """Inverse of :func:`_dispatch_group`. out_buf: [E, C, D] -> [S, D]."""
    e, c, d = out_buf.shape
    rows = out_buf.reshape(e * c, d)
    picked = rows[torch.clamp(slot, max=e * c - 1)]
    picked = torch.where(keep[:, None], picked, 0.0)
    sk = slot.shape[0]
    unsorted = torch.zeros((sk, d), dtype=out_buf.dtype,
                           device=out_buf.device)
    unsorted[order] = picked
    unsorted = unsorted.reshape(sk // top_k, top_k, d)
    w = weights.to(torch.float32)[..., None]
    return torch.sum(unsorted.to(torch.float32) * w, dim=1).to(
        out_buf.dtype)


def moe_block(
    x, *, w_router, w_gate, w_up, w_down, top_k: int,
    capacity_factor: float = 1.25, mesh=None, group_size: int = 4096,
):
    """Apply the expert MLPs to a flat token batch.

    x: [T, D]; w_router: [D, E]; w_gate/w_up: [E, D, F]; w_down: [E, F, D].
    Returns [T, D].  Tokens are split into groups (at most one per
    ``group_size`` tokens, the count cut until it divides T); each group
    dispatches and combines on its own, with its own capacity.
    """
    t, d = x.shape
    e = w_router.shape[1]
    groups = max(t // group_size, 1)
    while t % groups:
        groups -= 1
    s = t // groups
    capacity = max(int(s * top_k * capacity_factor / e), 1)

    weights, experts = router_topk(x, w_router, top_k=top_k)   # [T, k]
    if isinstance(x, DTensor):
        return _moe_sharded(x, weights, experts, w_gate, w_up, w_down,
                            groups=groups, capacity=capacity, top_k=top_k,
                            mesh=mesh)
    out = []
    for g in range(groups):
        rows = slice(g * s, (g + 1) * s)
        buf, slot, keep, order = _dispatch_group(
            x[rows], experts[rows], n_experts=e, capacity=capacity,
            top_k=top_k)
        buf = shd.constrain(buf, mesh, shd.MODEL, None, None)
        out_buf = swiglu(buf, w_gate, w_up, w_down)     # per expert
        out_buf = shd.constrain(out_buf, mesh, shd.MODEL, None, None)
        out.append(_combine_group(out_buf, slot, keep, order,
                                  weights[rows], top_k=top_k))
    return shd.constrain(torch.cat(out, 0), mesh, shd.BATCH, None)


def _moe_sharded(x, weights, experts, w_gate, w_up, w_down, *, groups: int,
                 capacity: int, top_k: int, mesh):
    """:func:`moe_block` on DTensors: ``[G, S, .]`` token groups on the
    batch axes, each rank's groups dispatched and combined on the rank,
    the expert MLPs on the ``[G, E, C, D]`` buffers' expert shards."""
    t, d = x.shape
    e = w_gate.shape[0]

    def grouped(z):
        return shd.constrain(shd.split_dim(z, 0, (groups, t // groups)),
                             mesh, shd.BATCH, None, None)

    xg, eg, wg = grouped(x), grouped(experts), grouped(weights)
    gp = tuple(xg.placements)

    def dispatch(xs, es):
        parts = [_dispatch_group(a, b, n_experts=e, capacity=capacity,
                                 top_k=top_k) for a, b in zip(xs, es)]
        return tuple(torch.stack(z) for z in zip(*parts))

    buf, slot, keep, order = shd.local_call(dispatch, (gp,) * 4, (gp, gp),
                                            xg, eg)
    buf = shd.constrain(buf, mesh, shd.BATCH, shd.MODEL, None, None)
    bp = tuple(buf.placements)
    # each rank's experts, gathered over the other axes (FSDP)
    wp = tuple(Shard(0) if p == Shard(1) else Replicate() for p in bp)

    def experts_mlp(bl, wg_, wu_, wd_):
        return torch.stack([swiglu(b, wg_, wu_, wd_) for b in bl])

    # each rank's groups use the gathered weights: partial gradients
    wgrad = tuple(Partial() if p == Shard(0) else q
                  for p, q in zip(bp, wp))
    out_buf = shd.local_call(experts_mlp, bp, (bp, wp, wp, wp), buf,
                             w_gate, w_up, w_down,
                             grad_placements=(bp, wgrad, wgrad, wgrad))
    out_buf = shd.constrain(out_buf, mesh, shd.BATCH, shd.MODEL, None, None)

    def combine(ob, sl, kp, od, ws):
        return torch.stack([_combine_group(*z, top_k=top_k)
                            for z in zip(ob, sl, kp, od, ws)])

    out = shd.local_call(combine, gp, (gp,) * 5, out_buf, slot, keep,
                         order, wg)
    return shd.constrain(shd.merge_dims(out, 0, 2), mesh, shd.BATCH, None)


def aux_load_balance_loss(x, w_router, *, top_k: int):
    """Switch-style auxiliary load-balancing loss (fraction * probability)."""
    logits = x.to(torch.float32) @ shd.gathered(w_router).to(
        torch.float32)
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    _, top_e = _top_k(probs, top_k)
    if isinstance(top_e, DTensor):
        onehot = shd.rowwise(lambda z: F.one_hot(z, e), top_e)
    else:
        onehot = F.one_hot(top_e, e)
    onehot = onehot.to(torch.float32).sum(dim=1)
    frac_tokens = torch.mean(onehot, dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
