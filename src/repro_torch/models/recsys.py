"""DCN-v2 ranking model [arXiv:2008.13535] + two-tower retrieval scoring.

The hot path is the sparse embedding lookup: each of the sparse fields is
one embedding bag, and one call of the embedding-bag kernel's grouped
wrapper (:func:`repro_torch.kernels.embedding_bag.ops.embedding_bag_fields`)
computes all of them and writes x0 with the dense columns, so the device
of the tensors chooses between the kernel and its plain version.

Structure (stacked DCN-v2): x0 = [dense || embedding bags] -> n cross layers
``x_{l+1} = x0 * (W x_l + b) + x_l`` -> deep MLP -> logit.

On a mesh (``mesh`` of more than one device) the ``constrain`` calls are
the JAX package's (x0 on the batch axes, the retrieval scores on
"model"), and the tables stay row-sharded on "model" as
``dcn_param_specs`` lays them out: the lookup is vocab-parallel.  Each
rank maps the ids of its batch rows into the rows it holds (a table
replicated on "model", whose vocabulary does not divide it, belongs to
the rank at coordinate 0), zeroes the weights of the others and runs the
kernel once on its shards; the bags are a partial sum over "model",
reduced before the dense columns are put in front of them, and the
backward writes only the rank's own rows.  The retrieval's candidate
rows are looked up the same way, into a partial sum reduced onto the
candidates' shards.  An id outside ``[-V, V)`` gives a zero row there,
where the kernel gives a NaN row.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

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


def _owned(table, mesh_dim: int) -> tuple[int, int]:
    """``(first row, rows)`` of DTensor ``table``'s vocabulary this rank
    looks up: its shard along ``mesh_dim``, or all of it at coordinate 0
    of that dimension when the table is replicated there."""
    offset, size = shd._chunk(table.device_mesh, table.placements, 0,
                              table.shape[0])
    if table.placements[mesh_dim] == Shard(0):
        return offset, size
    coord = table.device_mesh.get_coordinate()[mesh_dim]
    return (offset, size) if coord == 0 else (0, 0)


def _local_ids(ids, owned, vocab: int):
    """Global ids (``jnp.take``'s wrap of negative ones) as rows of the
    local shard, and whether this rank owns them."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + vocab, ids)
    lo, size = owned
    own = (ids >= lo) & (ids < lo + size)
    return torch.where(own, ids - lo, 0), own


def _vocab_parallel(fn, tables, rows, extra):
    """``fn(local tables, owned ranges, *local extra)`` on each rank's
    table shards and its ``rows``-laid-out ``extra`` inputs; the output is
    laid out like ``rows``, a partial sum over "model"."""
    mesh = tables[0].device_mesh
    dim = list(mesh.mesh_dim_names).index(shd.MODEL)
    owned = [_owned(t, dim) for t in tables]
    rp = tuple(Shard(0) if p == Shard(0) else Replicate()
               for p in rows.placements)
    out = tuple(Partial() if i == dim else p for i, p in enumerate(rp))
    # each rank adds its rows' share: partial gradients over the others
    grads = [tuple(Partial() if i != dim or p != Shard(0) else p
                   for i, p in enumerate(t.placements)) for t in tables]
    n = len(tables)
    return shd.local_call(
        lambda *a: fn(list(a[:n]), owned, *a[n:]), out,
        tuple(tuple(t.placements) for t in tables) + (rp,) * len(extra),
        *tables, *extra, grad_placements=tuple(grads) + (rp,) * len(extra))


def interact_features(params, dense, sparse_ids, sparse_weights, cfg,
                      mesh=None):
    """Build x0 = [dense || n_sparse embedding bags] (one kernel launch on
    the card; on a mesh one per rank, on its table shards)."""
    n = cfg.n_sparse
    tables = [params["tables"][f"t{i}"] for i in range(n)]
    ids, weights = sparse_ids[:, :n], sparse_weights[:, :n]
    if not shd.on_mesh(mesh):
        return bag_ops.embedding_bag_fields(tables, ids, weights, dense)

    def bags(tabs, owned, ids_, w_):
        local = [_local_ids(ids_[:, f], owned[f], cfg.vocab_sizes[f])
                 for f in range(n)]
        return bag_ops.embedding_bag_fields(
            tabs, torch.stack([i for i, _ in local], 1).to(torch.int32),
            torch.stack([torch.where(own, w_[:, f], 0.0)
                         for f, (_, own) in enumerate(local)], 1))

    x_bags = _vocab_parallel(bags, tables, ids, (ids, weights))
    x_bags = x_bags.redistribute(mesh, dense.placements)
    x0 = torch.cat([dense, x_bags], dim=-1)
    return shd.constrain(x0, mesh, shd.BATCH, None)


def _mlp(params, h, cfg):
    for i in range(len(cfg.mlp)):
        h = F.relu(h @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"])
    return h


def forward(params, batch, cfg: DCNConfig, mesh=None):
    """batch: dense [B, n_dense] f32, sparse_ids [B, n_sparse, bag] int32,
    sparse_weights [B, n_sparse, bag] f32 -> logits [B]."""
    x0 = interact_features(params, batch["dense"], batch["sparse_ids"],
                           batch["sparse_weights"], cfg, mesh)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ params["cross_w"][i] + params["cross_b"][i]) + x
    h = _mlp(params, x, cfg)
    logit = h @ params["out_w"] + params["out_b"]
    return logit[:, 0]


def loss_fn(params, batch, cfg: DCNConfig, mesh=None):
    """Binary cross-entropy of the logits against ``batch["labels"]``;
    its gradient reaches every embedding table through the embedding-bag
    kernel's backward."""
    logits = forward(params, batch, cfg, mesh).float()
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def query_embedding(params, batch, cfg: DCNConfig, mesh=None):
    """User/query tower: DCN trunk -> unit d_retrieval embedding."""
    x0 = interact_features(params, batch["dense"], batch["sparse_ids"],
                           batch["sparse_weights"], cfg, mesh)
    q = _mlp(params, x0, cfg) @ params["query_proj"]
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-9)


def retrieval_step(params, batch, candidate_ids, cfg: DCNConfig, mesh=None,
                   top_k: int = 100):
    """Score each query against a candidate corpus slice (batched dot).

    candidate_ids: int32[n_cand] -> (top scores [B, k], top ids [B, k]).
    Where scores tie, the order of their ids is ``torch.topk``'s.
    """
    q = query_embedding(params, batch, cfg, mesh)         # [B, dr]
    table = params["item_table"]
    if shd.on_mesh(mesh):
        def rows(tabs, owned, ids_):
            local, own = _local_ids(ids_, owned[0], cfg.n_items)
            return torch.where(own[:, None], tabs[0].index_select(0, local),
                               0.0)

        # the candidates whole on every rank, each looking up its rows
        every = shd.replicate(candidate_ids.full_tensor(), mesh)
        items = _vocab_parallel(rows, [table], every, (every,))
        items = items.redistribute(mesh, candidate_ids.placements)
    else:
        items = table.index_select(0, candidate_ids.long())
    scores = q @ items.T                                  # [B, n_cand]
    scores = shd.constrain(scores, mesh, None, shd.MODEL)
    if not shd.on_mesh(mesh):
        top_s, top_i = torch.topk(scores, top_k, dim=-1)
        return top_s, candidate_ids[top_i]
    top_s, top_i = shd.rowwise(lambda z: torch.topk(z, top_k, dim=-1),
                               scores, n_out=2)
    return top_s, shd.scatter_local(
        lambda c, i: c[i], top_i, "row", ("all", candidate_ids),
        ("row", top_i))
