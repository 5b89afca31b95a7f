"""Logical-axis names the models annotate their parameters with.

Each :class:`~repro_torch.models.params.ParamSpec` carries a ``logical``
tuple of these names (or ``None``) as plain data.  Nothing here maps them
onto devices: the resolver that turns them into placements on a mesh is
ROADMAP slice 9.
"""

BATCH = ("pod", "data")     # batch dim: data parallel over pods and data
FSDP = "data"               # parameter shards gathered on use
MODEL = "model"             # tensor-parallel axis
SEQ = ("data", "model")     # sequence sharding for giant KV caches
EDGE = ("pod", "data", "model")  # GNN edge streams: the whole mesh
