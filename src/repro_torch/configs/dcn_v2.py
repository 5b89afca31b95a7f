"""dcn-v2 — deep & cross network v2 ranking [arXiv:2008.13535].

13 dense + 26 sparse fields, embed_dim=16, 3 cross layers, MLP 1024-1024-512.
Shapes: train_batch 65k, serve_p99 512, serve_bulk 262k, retrieval_cand 1x1M.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import recsys

from .common import ArchDef

CONFIG = recsys.DCNConfig(name="dcn-v2")

SMOKE = recsys.DCNConfig(
    name="dcn-v2-smoke",
    n_dense=4,
    n_sparse=6,
    embed_dim=8,
    n_cross_layers=2,
    mlp=(32, 16),
    vocab_sizes=(100, 100, 50, 50, 20, 20),
    bag_size=2,
    d_retrieval=8,
    n_items=1000,
)


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    kind: str                 # train | serve | retrieval
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", 65_536, "train"),
    RecsysShape("serve_p99", 512, "serve"),
    RecsysShape("serve_bulk", 262_144, "serve"),
    RecsysShape("retrieval_cand", 1, "retrieval", n_candidates=1_000_000),
)

ARCH = ArchDef(
    name="dcn-v2", family="recsys", config=CONFIG, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES,
)
