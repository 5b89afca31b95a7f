"""Registry entries and the training workload shared by all architecture
configs.

A training cell resolves to a :class:`Workload`: a step function plus
meta-tensor stand-ins (shape and dtype, no storage) for its inputs.  The
port places tensors on one device only, so its shardings are ``None``;
a mesh of more than one device raises until ROADMAP's sharding on
DTensor.  The prefill and decode workloads wait for slice 10 (the dry
run).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import params as prm, transformer
from repro_torch.training import optimizer
from repro_torch.training.tree import leaves, tree_map, value_and_grad

_SHARDING_TODO = "ROADMAP queue A: sharding on DTensor"


@dataclasses.dataclass
class Workload:
    """One training cell: ``fn(*args)`` with meta-tensor arg stand-ins."""

    name: str                 # e.g. "granite-8b/train_4k"
    kind: str                 # train | prefill | decode
    fn: Callable
    in_sds: tuple
    in_shardings: Any = None
    out_shardings: Any = None
    model_flops: float = 0.0  # 6*N*D (dense) or 6*N_active*D (MoE)


def single_device(mesh) -> None:
    """Raises unless ``mesh`` is ``None`` or holds one device: placing a
    workload's tensors across devices waits for DTensor."""
    if mesh is not None and mesh.size() != 1:
        raise NotImplementedError(
            f"a workload on a {mesh.size()}-device mesh is not ported yet: "
            f"{_SHARDING_TODO}")


@dataclasses.dataclass
class ArchDef:
    """Registry entry: full config + reduced smoke config + shape table.

    The JAX package's entries also carry a dry-run workload function; that
    waits for ROADMAP slice 10 here (:func:`lm_train_workload` and
    ``gnn_common.gnn_workload`` build the training cells).
    """

    name: str
    family: str                       # lm | gnn | recsys | mining
    config: Any
    smoke_config: Any
    shapes: tuple

    def shape(self, shape_name: str):
        return next(s for s in self.shapes if s.name == shape_name)


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


LM_SHAPES = (
    LMShape("train_4k", 4_096, 256, "train"),
    LMShape("prefill_32k", 32_768, 32, "prefill"),
    LMShape("decode_32k", 32_768, 128, "decode"),
    LMShape("long_500k", 524_288, 1, "decode"),
)


def lm_active_params(cfg) -> int:
    """Active parameter count (MoE: top_k + shared experts only)."""
    total = cfg.n_params()
    if not cfg.moe:
        return total
    expert = 3 * cfg.d_model * cfg.d_ff_expert
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert
    return total - inactive


def serve_param_specs(cfg) -> dict:
    """Inference-time parameter specs: every leaf stored at the compute
    dtype (the JAX package's ``_serve_param_specs``)."""

    def at_dtype(node):
        if prm.is_spec(node):
            return node._replace(dtype=cfg.dtype)
        return {k: at_dtype(v) for k, v in node.items()}

    return at_dtype(transformer.param_specs(cfg))


def _batch_shards(mesh, b: int) -> int:
    """How many ways the batch dim shards on this mesh (one device: 1)."""
    single_device(mesh)
    return 1


def choose_microbatches(cfg, shape: LMShape, mesh,
                        carry_budget: float = 2.5e9) -> int:
    """Gradient-accumulation factor bounding the saved layer inputs.

    The backward pass keeps one [b_local/k, S, D] bf16 layer input per
    layer; pick the smallest power-of-two k (dividing the per-shard batch)
    that fits them in ``carry_budget`` bytes per device.
    """
    if getattr(cfg, "microbatch_override", 0):
        return cfg.microbatch_override
    b_local = shape.global_batch // _batch_shards(mesh, shape.global_batch)
    k = 1
    while k < b_local:
        carry = (cfg.n_layers * (b_local / k) * shape.seq_len
                 * cfg.d_model * 2)
        if carry <= carry_budget:
            break
        k *= 2
    return k


def lm_train_workload(cfg, shape: LMShape, mesh,
                      opt_cfg: optimizer.AdamWConfig | None = None,
                      microbatches: int | None = None) -> Workload:
    """The LM training step on ``shape``: ``value_and_grad`` of
    ``transformer.loss_fn`` and AdamW.  With ``k > 1`` microbatches (the
    batch rows split into ``k`` consecutive parts) the gradients are
    summed in float32, then the loss and the gradients divided by ``k``,
    as the JAX package's accumulation scan does."""
    single_device(mesh)
    opt_cfg = opt_cfg or optimizer.AdamWConfig()
    p_sds = prm.tree_sds(transformer.param_specs(cfg))
    o_sds = optimizer.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=p_sds, nu=p_sds)
    b, s = shape.global_batch, shape.seq_len
    tok_sds = torch.empty((b, s), dtype=torch.int32, device="meta")
    batch_sds = {"tokens": tok_sds, "targets": tok_sds}
    k = microbatches or choose_microbatches(cfg, shape, mesh)
    grad_fn = value_and_grad(transformer.loss_fn)

    def step(params, opt_state, batch):
        if k == 1:
            loss, grads = grad_fn(params, batch, cfg, mesh)
        else:
            split = {n: x.reshape(k, x.shape[0] // k, *x.shape[1:])
                     for n, x in batch.items()}
            loss = 0.0
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(k):
                l, g = grad_fn(params, {n: x[i] for n, x in split.items()},
                               cfg, mesh)
                for acc, x in zip(leaves(grads), leaves(g), strict=True):
                    acc.add_(x.to(torch.float32))
                loss = loss + l
                del g
            loss = loss / k
            for acc in leaves(grads):
                acc.div_(k)
        new_p, new_o, metrics = optimizer.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return new_p, new_o, metrics

    return Workload(
        name=f"{cfg.name}/{shape.name}", kind="train", fn=step,
        in_sds=(p_sds, o_sds, batch_sds),
        model_flops=6.0 * lm_active_params(cfg) * b * s,
    )
