"""Shared NN layers of the LM zoo: RMSNorm, rotary embeddings, SwiGLU and
GELU MLPs, cross-entropy — plain tensor ops, rounding where the JAX
package's ``models/layers.py`` rounds (norms, RoPE and activations in
float32, cast back to the input's dtype)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import sharding as shd


@functools.cache
def scalar_in(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a host number (computed once per
    value and dtype).  JAX rounds a weakly typed scalar to the array's
    dtype before an operation, where PyTorch would compute with the
    scalar unrounded."""
    return torch.tensor(value, dtype=dtype).item()


def rms_norm(x, weight, *, eps: float = 1e-6):
    """RMSNorm in float32, scaled by ``1 + weight``, in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def rope_frequencies(d_head: int, theta: float, device=None):
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def rope_angles(positions, d_head: int, theta: float):
    """``(sin, cos)`` of the rotary angles of ``positions [..., seq]``:
    float32 ``[..., seq, 1, d_head / 2]``, to :func:`rotate` with."""
    freqs = rope_frequencies(d_head, theta, positions.device)  # [d/2]
    angles = positions[..., None].to(torch.float32) * freqs    # [..., s, d/2]
    angles = angles[..., None, :]                           # [..., s, 1, d/2]
    return torch.sin(angles), torch.cos(angles)


def rotate(x, sin, cos):
    """Rotate split halves of ``x [..., seq, heads, d_head]`` by the
    angles of :func:`rope_angles`, in float32."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, *, theta: float = 10_000.0):
    """Rotary position embedding on split halves, in float32.

    x: [..., seq, heads, d_head]; positions: [..., seq] integers.
    """
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    dtype = x.dtype
    gate = x @ shd.gathered(w_gate).to(dtype)
    up = x @ shd.gathered(w_up).to(dtype)
    hidden = F.silu(gate.to(torch.float32)).to(dtype) * up
    return hidden @ shd.gathered(w_down).to(dtype)


def gelu_mlp(x, w_up, w_down):
    """GELU MLP (tanh approximation, ``jax.nn.gelu``'s default)."""
    dtype = x.dtype
    h = x @ w_up.to(dtype)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(dtype)
    return h @ w_down.to(dtype)


def cross_entropy_loss(logits, targets, *, z_loss: float = 0.0):
    """Mean token cross-entropy at fp32 with optional z-loss."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        gold = _gold_sharded(logits, targets)
    else:
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = logz - gold
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    return torch.mean(loss)


def _gold_sharded(logits, targets):
    """The target's logit of each row of DTensor ``logits``, whose
    vocabulary may be sharded: each rank picks the targets that fall in
    its slice (a partial sum over the vocabulary's shards)."""
    last = logits.ndim - 1
    v0 = shd.shard_offset(logits, last)
    lp = tuple(logits.placements)
    tp = tuple(p if isinstance(p, Shard) and p.dim != last else Replicate()
               for p in lp)
    out = tuple(Partial() if p == Shard(last) else q
                for p, q in zip(lp, tp))

    def local(lg, tg):
        idx = tg.long() - v0
        inside = (idx >= 0) & (idx < lg.shape[-1])
        idx = idx.clamp(0, lg.shape[-1] - 1)
        picked = torch.gather(lg, -1, idx[..., None])[..., 0]
        return torch.where(inside, picked, 0.0)

    return shd.local_call(local, out, (lp, tp), logits, targets)
