"""dcn-v2 — deep & cross network v2 ranking [arXiv:2008.13535].

13 dense + 26 sparse fields, embed_dim=16, 3 cross layers, MLP 1024-1024-512.
Shapes: train_batch 65k, serve_p99 512, serve_bulk 262k, retrieval_cand 1x1M.

The workloads run on no mesh or on any mesh: the model takes the mesh,
and its embedding bags run the embedding-bag kernel's custom op (B5)
vocab-parallel there, each rank on its table shards.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import params as prm, recsys, sharding as shd
from repro_torch.training import optimizer
from repro_torch.training.tree import value_and_grad

from .common import ArchDef, Workload, _replicated, _sds

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

def _batch_specs(cfg, b, mesh, with_labels):
    """Stand-ins of a batch of ``b`` examples and their shardings (rows on
    the batch axes; ``None`` without a mesh)."""
    sds = {
        "dense": _sds((b, cfg.n_dense), torch.float32),
        "sparse_ids": _sds((b, cfg.n_sparse, cfg.bag_size), torch.int32),
        "sparse_weights": _sds((b, cfg.n_sparse, cfg.bag_size),
                               torch.float32),
    }
    if with_labels:
        sds["labels"] = _sds((b,), torch.float32)
    if mesh is None:
        return sds, None
    return sds, {
        k: shd.named_sharding(mesh, (shd.BATCH,) + (None,) * (v.ndim - 1),
                              v.shape)
        for k, v in sds.items()}


def recsys_workload(cfg, shape: RecsysShape, mesh,
                    opt_cfg: optimizer.AdamWConfig | None = None) -> Workload:
    """DCN-v2's training step, forward or retrieval step on ``shape``."""
    specs = recsys.dcn_param_specs(cfg)
    p_sds = prm.tree_sds(specs)
    p_shd = None if mesh is None else prm.tree_shardings(mesh, specs)
    d = cfg.d_interact
    mlp_flops = d * cfg.mlp[0] + sum(
        a * b for a, b in zip(cfg.mlp[:-1], cfg.mlp[1:])
    )
    fwd_flops = 2.0 * shape.batch * (
        cfg.n_cross_layers * d * d + mlp_flops
    )
    name = f"{cfg.name}/{shape.name}"

    if shape.kind == "train":
        opt_cfg = opt_cfg or optimizer.AdamWConfig(weight_decay=0.0)
        o_sds = optimizer.AdamWState(step=_sds((), torch.int32), mu=p_sds,
                                     nu=p_sds)
        b_sds, b_shd = _batch_specs(cfg, shape.batch, mesh, True)
        grad_fn = value_and_grad(recsys.loss_fn)
        shardings = None
        if mesh is not None:
            shardings = (p_shd, optimizer.AdamWState(
                step=_replicated(mesh), mu=p_shd, nu=p_shd), b_shd)

        def step(params, opt_state, batch):
            loss, grads = grad_fn(params, batch, cfg, mesh)
            new_p, new_o, metrics = optimizer.apply_updates(
                opt_cfg, params, grads, opt_state)
            metrics["loss"] = loss
            return new_p, new_o, metrics

        return Workload(
            name=name, kind="train", fn=step,
            in_sds=(p_sds, o_sds, b_sds), in_shardings=shardings,
            model_flops=3.0 * fwd_flops,
        )

    b_sds, b_shd = _batch_specs(cfg, shape.batch, mesh, False)
    if shape.kind == "serve":
        def serve(params, batch):
            return recsys.forward(params, batch, cfg, mesh)

        return Workload(
            name=name, kind="serve", fn=serve, in_sds=(p_sds, b_sds),
            in_shardings=None if mesh is None else (p_shd, b_shd),
            model_flops=fwd_flops,
        )

    # retrieval: one query vs n_candidates batched dot
    cand_sds = _sds((shape.n_candidates,), torch.int32)

    def retrieve(params, batch, candidate_ids):
        return recsys.retrieval_step(params, batch, candidate_ids, cfg,
                                     mesh)

    return Workload(
        name=name, kind="serve", fn=retrieve,
        in_sds=(p_sds, b_sds, cand_sds),
        in_shardings=None if mesh is None else (
            p_shd, b_shd, shd.named_sharding(mesh, (shd.MODEL,),
                                             (shape.n_candidates,))),
        model_flops=fwd_flops
        + 2.0 * shape.batch * shape.n_candidates * cfg.d_retrieval,
    )


ARCH = ArchDef(
    name="dcn-v2", family="recsys", config=CONFIG, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES, workload_fn=recsys_workload,
)
