"""GQA attention: the query-chunked prefill path and the cached decode
path of the JAX package's ``models/attention.py``, as plain tensor ops.

Query chunks run as a Python loop, each with a score tensor of
``[B, KV, G, chunk, T]``.  Local (sliding-window) and global layers share
one code path: ``is_local`` picks the window mask.  Scores are soft-capped
and masked in the queries' dtype, the softmax runs in float32, and the
probabilities are cast to ``v``'s dtype before the PV product, as in the
JAX package.

On a mesh (DTensor inputs) each rank attends with its own batch rows and
heads (``sharding.local_call``): the query heads keep their shards, and a
rank reads the KV heads its query heads group onto.  A decode step over a
cache sharded along its sequence runs each rank's slice of the cache and
combines the slices' partial softmax sums (the running maximum, the sum
of exponentials and the weighted values) across the shards.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import sharding as shd
from .layers import scalar_in

NEG_INF = -1e30


def _gqa_scores(q, k, scale):
    """q: [B, Sq, KV, G, dh]; k: [B, T, KV, dh] -> scores [B, KV, G, Sq, T]."""
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k)
    return scores * scalar_in(scale, scores.dtype)


def _probs(scores, mask, soft_cap, dtype):
    if soft_cap is not None:
        cap = scalar_in(soft_cap, scores.dtype)
        scores = torch.tanh(scores / cap) * cap
    scores = torch.where(mask, scores, scalar_in(NEG_INF, scores.dtype))
    return torch.softmax(scores.to(torch.float32), dim=-1).to(dtype)


def attend_chunked(
    q, k, v, *,
    q_positions, kv_positions, causal: bool = True,
    window: int | None = None, is_local: bool = False,
    scale: float, q_chunk: int = 512, soft_cap: float | None = None,
):
    """Chunked-query GQA attention.

    Args:
      q: [B, S, n_q, dh] queries (n_q = kv_heads * group).
      k, v: [B, T, n_kv, dh].
      q_positions: int[S]; kv_positions: int[T] (global positions).
      window: sliding-window width for local layers.
      is_local: use the window mask (when ``window`` is set).
    Returns: [B, S, n_q, dh]
    """
    if isinstance(q, DTensor):
        return _by_heads(q, k, v, lambda ql, kl, vl: attend_chunked(
            ql, kl, vl, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window, is_local=is_local, scale=scale,
            q_chunk=q_chunk, soft_cap=soft_cap))
    b, s, n_q, dh = q.shape
    t = k.shape[1]
    n_kv = k.shape[2]
    g = n_q // n_kv
    n_chunks = max(s // q_chunk, 1)
    chunk = s // n_chunks
    if chunk * n_chunks != s:
        raise ValueError(f"sequence length {s} does not split into "
                         f"{n_chunks} query chunks of {q_chunk}")
    q = q.reshape(b, s, n_kv, g, dh)
    outs = []
    for i in range(n_chunks):
        q_i = q[:, i * chunk:(i + 1) * chunk]
        pos_i = q_positions[i * chunk:(i + 1) * chunk]
        mask = torch.ones((chunk, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos_i[:, None] >= kv_positions[None, :]
        if window is not None and is_local:
            mask &= kv_positions[None, :] > pos_i[:, None] - window
        probs = _probs(_gqa_scores(q_i, k, scale), mask, soft_cap, v.dtype)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", probs, v))
    return torch.cat(outs, dim=1).reshape(b, s, n_q, dh)


def decode_mask(t: int, *, cache_len: int, window: int | None = None,
                is_local: bool = False, device=None):
    """The cache slots ``[1, t]`` a decode step attends to: the first
    ``cache_len``, and of those the last ``window`` on a local layer."""
    pos = torch.arange(t, device=device)
    mask = pos[None, :] < cache_len
    if window is not None and is_local:
        mask &= pos[None, :] > cache_len - 1 - window
    return mask


def attend_decode(
    q, k_cache, v_cache, *, cache_len: int, window: int | None = None,
    is_local: bool = False, scale: float, soft_cap: float | None = None,
    mask=None,
):
    """Single-position decode attention against a KV cache.

    q: [B, 1, n_q, dh]; k_cache/v_cache: [B, T_max, n_kv, dh];
    cache_len: number of valid cache positions (the new token's position
    is cache_len - 1 after insertion).  ``mask``: :func:`decode_mask` of
    these arguments, made here when not given (a decode step over many
    layers makes it once).
    """
    if isinstance(q, DTensor):
        return _decode_sharded(q, k_cache, v_cache, cache_len=cache_len,
                               window=window, is_local=is_local,
                               scale=scale, soft_cap=soft_cap)
    b, _, n_q, dh = q.shape
    t = k_cache.shape[1]
    n_kv = k_cache.shape[2]
    g = n_q // n_kv
    q = q.reshape(b, 1, n_kv, g, dh)
    if mask is None:
        mask = decode_mask(t, cache_len=cache_len, window=window,
                           is_local=is_local, device=q.device)
    probs = _probs(_gqa_scores(q, k_cache, scale), mask, soft_cap,
                   v_cache.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, n_q, dh)


def _by_heads(q, k, v, fn):
    """``fn(q, k, v)`` on each rank's batch rows and query heads of DTensor
    ``q [B, S, n_q, dh]``.  ``k`` and ``v`` follow ``q``'s batch shards,
    and its head shards where those divide the KV heads; otherwise they
    are replicated over those mesh dimensions and each rank picks the KV
    heads of its query heads."""
    mesh = q.device_mesh
    n_q, n_kv = q.shape[2], k.shape[2]
    g = n_q // n_kv
    qp = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)
    head_shards = math.prod(mesh.shape[i] for i, p in enumerate(qp)
                            if p == Shard(2))
    aligned = n_kv % head_shards == 0
    kvp = tuple(p if p == Shard(0) or aligned else Replicate() for p in qp)
    q = q.redistribute(mesh, qp) if tuple(q.placements) != qp else q
    h0 = shd.shard_offset(q, 2)

    def local(ql, kl, vl):
        if not aligned:
            hq = ql.shape[2]
            lo, hi = h0 // g, (h0 + hq - 1) // g + 1
            if hi - lo == 1 or (h0 % g == 0 and (hi - lo) * g == hq):
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            else:                      # one KV head per query head
                idx = (h0 + torch.arange(hq, device=ql.device)) // g
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl)

    # each rank's heads read part of a replicated k/v: partial gradients
    kvg = tuple(Partial() if p == Shard(2) and r == Replicate() else r
                for p, r in zip(qp, kvp))
    return shd.local_call(local, qp, (qp, kvp, kvp), q, k, v,
                          grad_placements=(qp, kvg, kvg))


def _decode_sharded(q, k_cache, v_cache, *, cache_len, window, is_local,
                    scale, soft_cap):
    """:func:`attend_decode` on DTensors: each rank attends over its slice
    of the cache ``[B, T, n_kv, dh]``; the slices' partial results, stacked
    on a new leading dimension sharded like the cache's sequence, combine
    into the softmax over the whole cache."""
    cp = tuple(k_cache.placements)
    # q: the cache's batch and KV-head shards, replicated over the rest
    qp = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in cp)
    # partials [1, B, 1, n_q, .]: the sequence's shards on dimension 0
    pp = tuple(Shard(0) if p == Shard(1) else Shard(p.dim + 1)
               if isinstance(p, Shard) else Replicate() for p in cp)
    t0 = shd.shard_offset(k_cache, 1)

    def local(ql, kl, vl):
        b, _, hq, dh = ql.shape
        t_loc, hk = kl.shape[1], kl.shape[2]
        scores = _gqa_scores(ql.reshape(b, 1, hk, hq // hk, dh), kl, scale)
        if soft_cap is not None:
            cap = scalar_in(soft_cap, scores.dtype)
            scores = torch.tanh(scores / cap) * cap
        pos = t0 + torch.arange(t_loc, device=ql.device)
        mask = pos < cache_len
        if window is not None and is_local:
            mask &= pos > cache_len - 1 - window
        scores = torch.where(mask, scores, scalar_in(NEG_INF, scores.dtype))
        scores = scores.to(torch.float32)                 # [b, k, g, 1, t]
        m = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - m)
        l_sum = e.sum(-1, keepdim=True)
        o = torch.einsum("bkgqt,btkd->bqkgd", e.to(vl.dtype), vl)

        def lead(x):                  # [b, k, g, 1, 1] -> [1, b, 1, hq, 1]
            return x.permute(0, 3, 1, 2, 4).reshape(1, b, 1, hq, 1)

        return (o.to(torch.float32).reshape(1, b, 1, hq, dh), lead(m),
                lead(l_sum))

    o, m, l_sum = shd.local_call(local, (pp, pp, pp), (qp, cp, cp), q,
                                 k_cache, v_cache)
    top = m.amax(0, keepdim=True)
    c = torch.exp(m - top)
    out = (o * c).sum(0) / (l_sum * c).sum(0)
    return out.to(v_cache.dtype)
