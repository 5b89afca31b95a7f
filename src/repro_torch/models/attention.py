"""GQA attention: the query-chunked prefill path and the cached decode
path of the JAX package's ``models/attention.py``, as plain tensor ops.

Query chunks run as a Python loop, each with a score tensor of
``[B, KV, G, chunk, T]``.  Local (sliding-window) and global layers share
one code path: ``is_local`` picks the window mask.  Scores are soft-capped
and masked in the queries' dtype, the softmax runs in float32, and the
probabilities are cast to ``v``'s dtype before the PV product, as in the
JAX package.
"""

from __future__ import annotations

import torch

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
