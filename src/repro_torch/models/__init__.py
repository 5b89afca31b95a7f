"""Model zoo on PyTorch: parameter trees, the GNN layers and DCN-v2.

Parameters are plain nested dicts of tensors, declared by a matching tree
of :class:`params.ParamSpec`.  The aggregation of every GNN layer goes
through the segment scatter-sum kernel and every DCN-v2 sparse field
through the embedding-bag kernel (see :mod:`repro_torch.kernels`).
"""

from . import sharding

__all__ = ["sharding"]
