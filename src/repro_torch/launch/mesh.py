"""Production mesh definitions.

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module touches no process group.  The single-pod mesh is
16x16 = 256 ranks over ``("data", "model")``; multi-pod adds a leading
``pod`` axis for 2 pods = 512 ranks.  ``pod`` is pure data parallelism;
``data`` carries FSDP + batch; ``model`` carries TP/EP/sequence shards.

Such a mesh needs a process group of that many ranks.  The dry run
(``python -m repro_torch.launch.dryrun``) makes one with
:func:`fake_world`: PyTorch's ``"fake"`` backend, in one process as rank
0, whose collectives do nothing; nothing else makes one.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    with this process as rank 0 (the dry run's world: a rank's tensors
    and collectives are traced, none is sent)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production ``DeviceMesh`` over the default process group,
    whose world must hold exactly its ranks."""
    shape, axes = production_shape(multi_pod)
    return make_test_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), *,
                   device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the default process group."""
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"a mesh {tuple(shape)} needs a process group of {n} ranks, "
            f"have {have}: run the dry run (python -m "
            "repro_torch.launch.dryrun), which makes a fake world of that "
            "size")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
