"""gatedgcn — edge-gated graph convnet [arXiv:2003.00982]. 16L d=70."""

from repro_torch.models.gnn import GNNConfig

from .common import ArchDef
from .gnn_common import GNN_SHAPES, gnn_workload

CONFIG = GNNConfig(
    name="gatedgcn",
    kind="gatedgcn",
    n_layers=16,
    d_in=1433,          # overridden per shape
    d_hidden=70,
    n_classes=7,
)

SMOKE = GNNConfig(
    name="gatedgcn-smoke",
    kind="gatedgcn",
    n_layers=3,
    d_in=16,
    d_hidden=16,
    n_classes=4,
)

ARCH = ArchDef(
    name="gatedgcn", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=GNN_SHAPES, workload_fn=gnn_workload,
)
