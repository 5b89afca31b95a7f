"""Elastic scaling: restart the same job on a different mesh shape.

Checkpoints store whole arrays (see :mod:`.checkpoint`), so elasticity
reduces to (1) picking a new mesh for the surviving world and (2) moving
the restored tree where the new run needs it.  This module provides the
mesh-selection policy (the JAX package's, result for result), a
``DeviceMesh`` over the current ``torch.distributed`` world in that
shape, and the move.
"""

from __future__ import annotations

import math

from .tree import tree_map


def choose_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                      pod_size: int = 256) -> tuple[tuple, tuple]:
    """Pick (shape, axis_names) for a possibly-degraded device count.

    Policy: keep the ``model`` axis fixed (TP degree is a property of the
    architecture), give whole pods a ``pod`` axis, and absorb stragglers by
    shrinking ``data`` — the largest (pods * data * model) <= n_devices.
    """
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model //= 2
    rest = n_devices // model
    if rest * model >= 2 * pod_size and rest % (pod_size // model) == 0:
        pods = rest // (pod_size // model)
        data = pod_size // model
        return (pods, data, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_mesh_for(n_devices: int | None = None, *, device_type: str = "cuda",
                  **kw):
    """A ``DeviceMesh`` over the current process group in the shape
    :func:`choose_mesh_shape` picks for ``n_devices`` (default: the
    world size, which the shape must cover: one rank per device).
    ``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"``
    (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    shape, names = choose_mesh_shape(n, **kw)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} covers {math.prod(shape)} "
                         f"ranks, but the world has {world}")
    if device_type == "cuda":
        from repro_torch.core.executor import resolve_device

        resolve_device("cuda")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def reshard(tree, device):
    """Move a (restored) tree onto ``device``."""
    return tree_map(lambda x: x.to(device), tree)
