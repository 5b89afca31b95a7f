"""equiformer-v2 — SO(2)-eSCN equivariant graph attention
[arXiv:2306.12059].  12L d_hidden=128 l_max=6 m_max=2 8H.

Non-geometric shapes (cora / reddit-like / ogb_products) have no atomic
coordinates; their graph batches carry random unit-scale positions
(``random_graph_batch(..., with_positions=True)``)."""

from repro_torch.models.equiformer import EquiformerConfig

from .common import ArchDef
from .gnn_common import GNN_SHAPES, gnn_workload

CONFIG = EquiformerConfig(
    name="equiformer-v2",
    n_layers=12,
    d_hidden=128,
    l_max=6,
    m_max=2,
    n_heads=8,
    n_radial=32,
)

SMOKE = EquiformerConfig(
    name="equiformer-v2-smoke",
    n_layers=2,
    d_hidden=16,
    l_max=3,
    m_max=2,
    n_heads=4,
    n_radial=8,
)

ARCH = ArchDef(
    name="equiformer-v2", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=GNN_SHAPES, workload_fn=gnn_workload,
)
