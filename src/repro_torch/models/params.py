"""Parameter declaration: shapes, dtypes and logical shardings in one tree.

Parameters are plain nested dicts of tensors.  Each model declares a
matching tree of :class:`ParamSpec`; :func:`tree_init` makes the tensors
from it with an explicit :class:`torch.Generator`, :func:`tree_sds` makes
shape-and-dtype stand-ins (meta tensors, the JAX package's
``ShapeDtypeStruct``s), :func:`tree_shardings` resolves each leaf's
logical spec on a mesh and :func:`place_tree` lays a tree of tensors out
by those shardings as DTensors, :func:`count_params` counts them.  The
init rules are the JAX package's (``normal`` with a fan-in scale,
``zeros``, ``ones``, ``embed``); the numbers differ, as two generators
do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype = torch.float32
    logical: tuple = ()          # logical partition spec, same rank as shape
    init: str = "normal"         # normal | zeros | ones | embed
    scale: float | None = None   # stddev override


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_leaves(specs) -> list[ParamSpec]:
    """The specs of a tree, in the JAX package's flatten order (dict keys
    sorted)."""
    if is_spec(specs):
        return [specs]
    return [leaf for k in sorted(specs) for leaf in tree_leaves(specs[k])]


def tree_sds(specs):
    """A tree of meta tensors (``device="meta"``: shape and dtype, no
    storage) shaped like ``specs``."""
    if is_spec(specs):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    return {k: tree_sds(specs[k]) for k in sorted(specs)}


def tree_shardings(mesh, specs):
    """A tree of :class:`~.sharding.NamedSharding` shaped like ``specs``
    (``None`` without a mesh)."""
    from . import sharding as shd

    if mesh is None:
        return None
    if is_spec(specs):
        return shd.named_sharding(mesh, specs.logical, specs.shape)
    return {k: tree_shardings(mesh, specs[k]) for k in sorted(specs)}


def place_tree(tree, shardings):
    """Each leaf of ``tree`` (real or fake tensors, global shapes) as a
    DTensor laid out by the leaf of ``shardings`` of the same path
    (``distribute_tensor`` per leaf, in flatten order); a ``None``
    sharding, or a mesh of one device, leaves the tree as it is."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.training.tree import leaves, unflatten

    flat = leaves(shardings)
    if not flat or flat[0].mesh.size() == 1:
        return tree
    return unflatten(tree, [
        distribute_tensor(x, s.mesh, s.placements)
        for x, s in zip(leaves(tree), flat, strict=True)])


def _fan_in(shape) -> int:
    if len(shape) == 1:
        return shape[0]
    return math.prod(shape[:-1])


def init_param(spec: ParamSpec, *, generator: torch.Generator, device):
    """One parameter by its spec's init rule; normal draws are float32 from
    ``generator`` (on the generator's device), then cast and moved."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        scale = spec.scale or 1.0
    else:
        scale = spec.scale or 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype=spec.dtype, device=device)


def tree_init(specs, *, generator: torch.Generator, device=None):
    """A tree of tensors shaped like ``specs`` (leaves drawn in flatten
    order).  ``device`` defaults to CUDA, and raises without one."""
    from repro_torch.core.executor import resolve_device

    device = resolve_device(device)

    def init(node):
        if is_spec(node):
            return init_param(node, generator=generator, device=device)
        return {k: init(node[k]) for k in sorted(node)}

    return init(specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))
