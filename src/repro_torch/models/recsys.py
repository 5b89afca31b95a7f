"""DCN-v2 ranking model [arXiv:2008.13535] + two-tower retrieval scoring.

The hot path is the sparse embedding lookup: each of the sparse fields is
one embedding bag, and one call of the embedding-bag kernel's grouped
wrapper (:func:`repro_torch.kernels.embedding_bag.ops.embedding_bag_fields`)
computes all of them and writes x0 with the dense columns, so the device
of the tensors chooses between the kernel and its plain version.

Structure (stacked DCN-v2): x0 = [dense || embedding bags] -> n cross layers
``x_{l+1} = x0 * (W x_l + b) + x_l`` -> deep MLP -> logit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import ops as bag_ops

from . import sharding as shd
from .params import ParamSpec

# Criteo-like vocabulary spread: a few huge fields, a body of medium ones
DEFAULT_VOCABS = tuple(
    [10_000_000, 8_000_000] + [1_000_000] * 4 + [100_000] * 8
    + [10_000] * 7 + [1_000] * 5
)


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    vocab_sizes: tuple = DEFAULT_VOCABS
    bag_size: int = 4             # multi-hot ids per field (padded)
    d_retrieval: int = 64
    n_items: int = 4_000_000      # retrieval corpus size

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def n_params(self) -> int:
        from .params import count_params

        return count_params(dcn_param_specs(self))


def dcn_param_specs(cfg: DCNConfig) -> dict:
    f32 = torch.float32
    d = cfg.d_interact
    specs: dict = {
        "tables": {
            f"t{i}": ParamSpec((v, cfg.embed_dim), f32, (shd.MODEL, None),
                               init="embed", scale=cfg.embed_dim ** -0.5)
            for i, v in enumerate(cfg.vocab_sizes)
        },
        "cross_w": ParamSpec((cfg.n_cross_layers, d, d), f32,
                             (None, None, shd.MODEL)),
        "cross_b": ParamSpec((cfg.n_cross_layers, d), f32, (None, None),
                             init="zeros"),
        "item_table": ParamSpec((cfg.n_items, cfg.d_retrieval), f32,
                                (shd.MODEL, None), init="embed",
                                scale=cfg.d_retrieval ** -0.5),
        "query_proj": ParamSpec((cfg.mlp[-1], cfg.d_retrieval), f32,
                                (None, None)),
    }
    dims = (d,) + tuple(cfg.mlp)
    for i in range(len(cfg.mlp)):
        specs[f"mlp_w{i}"] = ParamSpec((dims[i], dims[i + 1]), f32,
                                       (None, shd.MODEL if i == 0 else None))
        specs[f"mlp_b{i}"] = ParamSpec((dims[i + 1],), f32, (None,),
                                       init="zeros")
    specs["out_w"] = ParamSpec((cfg.mlp[-1], 1), f32, (None, None))
    specs["out_b"] = ParamSpec((1,), f32, (None,), init="zeros")
    return specs


def embedding_bag(table, ids, weights):
    """Sum-reduce a bag of rows: ids [B, bag], weights [B, bag] -> [B, D]."""
    return bag_ops.embedding_bag(table, ids, weights)


def interact_features(params, dense, sparse_ids, sparse_weights, cfg):
    """Build x0 = [dense || n_sparse embedding bags] (one kernel launch on
    the card)."""
    n = cfg.n_sparse
    tables = [params["tables"][f"t{i}"] for i in range(n)]
    return bag_ops.embedding_bag_fields(tables, sparse_ids[:, :n],
                                        sparse_weights[:, :n], dense)


def _mlp(params, h, cfg):
    for i in range(len(cfg.mlp)):
        h = F.relu(h @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"])
    return h


def forward(params, batch, cfg: DCNConfig):
    """batch: dense [B, n_dense] f32, sparse_ids [B, n_sparse, bag] int32,
    sparse_weights [B, n_sparse, bag] f32 -> logits [B]."""
    x0 = interact_features(params, batch["dense"], batch["sparse_ids"],
                           batch["sparse_weights"], cfg)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ params["cross_w"][i] + params["cross_b"][i]) + x
    h = _mlp(params, x, cfg)
    logit = h @ params["out_w"] + params["out_b"]
    return logit[:, 0]


def loss_fn(params, batch, cfg: DCNConfig):
    """Binary cross-entropy of the logits against ``batch["labels"]``
    (forward arithmetic only)."""
    logits = forward(params, batch, cfg).float()
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def query_embedding(params, batch, cfg: DCNConfig):
    """User/query tower: DCN trunk -> unit d_retrieval embedding."""
    x0 = interact_features(params, batch["dense"], batch["sparse_ids"],
                           batch["sparse_weights"], cfg)
    q = _mlp(params, x0, cfg) @ params["query_proj"]
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-9)


def retrieval_step(params, batch, candidate_ids, cfg: DCNConfig,
                   top_k: int = 100):
    """Score each query against a candidate corpus slice (batched dot).

    candidate_ids: int32[n_cand] -> (top scores [B, k], top ids [B, k]).
    Where scores tie, the order of their ids is ``torch.topk``'s.
    """
    q = query_embedding(params, batch, cfg)               # [B, dr]
    items = params["item_table"].index_select(0, candidate_ids.long())
    scores = q @ items.T                                  # [B, n_cand]
    top_s, top_i = torch.topk(scores, top_k, dim=-1)
    return top_s, candidate_ids[top_i]
