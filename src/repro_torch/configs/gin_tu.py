"""gin-tu — Graph Isomorphism Network [arXiv:1810.00826].
5L d=64, sum aggregator, learnable eps."""

from repro_torch.models.gnn import GNNConfig

from .common import ArchDef
from .gnn_common import GNN_SHAPES, gnn_workload

CONFIG = GNNConfig(
    name="gin-tu",
    kind="gin",
    n_layers=5,
    d_in=1433,          # overridden per shape
    d_hidden=64,
    n_classes=7,
)

SMOKE = GNNConfig(
    name="gin-tu-smoke",
    kind="gin",
    n_layers=2,
    d_in=16,
    d_hidden=16,
    n_classes=4,
)

ARCH = ArchDef(
    name="gin-tu", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=GNN_SHAPES, workload_fn=gnn_workload,
)
