"""gat-cora — graph attention network [arXiv:1710.10903].
2L, 8 heads x 8 features (d_hidden = 64 total), attn aggregator."""

from repro_torch.models.gnn import GNNConfig

from .common import ArchDef
from .gnn_common import GNN_SHAPES, gnn_workload

CONFIG = GNNConfig(
    name="gat-cora",
    kind="gat",
    n_layers=2,
    d_in=1433,          # overridden per shape
    d_hidden=64,        # 8 heads x 8 per-head features
    n_heads=8,
    n_classes=7,
)

SMOKE = GNNConfig(
    name="gat-cora-smoke",
    kind="gat",
    n_layers=2,
    d_in=16,
    d_hidden=16,
    n_heads=4,
    n_classes=4,
)

ARCH = ArchDef(
    name="gat-cora", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=GNN_SHAPES, workload_fn=gnn_workload,
)
