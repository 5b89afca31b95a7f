"""Logical-axis names the models annotate their parameters with, and
``constrain``, the models' placement hint.

Each :class:`~repro_torch.models.params.ParamSpec` carries a ``logical``
tuple of these names (or ``None``) as plain data.  Nothing here maps them
onto devices yet: the resolver that turns them into placements on a mesh
is ROADMAP slice 9 (DTensor).
"""

BATCH = ("pod", "data")     # batch dim: data parallel over pods and data
FSDP = "data"               # parameter shards gathered on use
MODEL = "model"             # tensor-parallel axis
SEQ = ("data", "model")     # sequence sharding for giant KV caches
EDGE = ("pod", "data", "model")  # GNN edge streams: the whole mesh


def constrain(x, mesh, *spec):
    """``x`` laid out by the logical ``spec`` on ``mesh``: the identity
    without a mesh or on a one-device mesh (a ``DeviceMesh``).  Any other
    mesh raises: placing tensors on it is ROADMAP slice 9 (DTensor)."""
    if mesh is None or mesh.size() == 1:
        return x
    raise NotImplementedError(
        f"constrain to {spec} on a {mesh.size()}-device mesh is not "
        "ported yet: ROADMAP slice 9 (sharding on DTensor)")
