"""Workload plumbing shared by all architecture configs.

Every (arch x input-shape) cell resolves to a :class:`Workload`: a step
function, meta-tensor stand-ins (shape and dtype, no storage) for its
inputs and their shardings (:class:`~repro_torch.models.sharding.
NamedSharding` trees, ``None`` without a mesh).  ``launch/dryrun.py``
runs a cell's step once on fake tensors placed by those shardings on the
production mesh of a fake process group; the tests and ``chip_smoke.py``
run reduced configs for real.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models import params as prm, sharding as shd, transformer
from repro_torch.training import optimizer
from repro_torch.training.tree import leaves, tree_map, value_and_grad

@dataclasses.dataclass
class Workload:
    """One dry-run cell: ``fn(*args)`` with arg stand-ins and shardings."""

    name: str                 # e.g. "granite-8b/train_4k"
    kind: str                 # train | prefill | decode | serve | mine
    fn: Callable
    in_sds: tuple
    in_shardings: Any = None
    model_flops: float = 0.0  # 6*N*D (dense) or 6*N_active*D (MoE)

    def place(self, args) -> tuple:
        """``args`` (real or fake tensors shaped like ``in_sds``) laid out
        by ``in_shardings`` as DTensors (unchanged without shardings)."""
        if self.in_shardings is None:
            return tuple(args)
        return tuple(prm.place_tree(a, s)
                     for a, s in zip(args, self.in_shardings, strict=True))


def _replicated(mesh):
    return shd.named_sharding(mesh, (), ())


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class ArchDef:
    """Registry entry: full config + reduced smoke config + shape table."""

    name: str
    family: str                       # lm | gnn | recsys | mining
    config: Any
    smoke_config: Any
    shapes: tuple
    workload_fn: Callable             # (config, shape, mesh) -> Workload

    def shape(self, shape_name: str):
        return next(s for s in self.shapes if s.name == shape_name)

    def workload(self, shape_name: str, mesh) -> Workload:
        return self.workload_fn(self.config, self.shape(shape_name), mesh)

    def smoke_workload(self, shape_name: str, mesh) -> Workload:
        return self.workload_fn(
            self.smoke_config, self.shape(shape_name), mesh)

    def workload_with_depth(self, shape_name: str, mesh,
                            n_layers: int) -> Workload | None:
        """The full config at ``n_layers`` layers, with shape-dependent
        choices (the microbatch count) pinned to the full-depth config's,
        as the JAX package's calibration variants are."""
        if not hasattr(self.config, "n_layers"):
            return None
        shape = self.shape(shape_name)
        cfg = dataclasses.replace(self.config, n_layers=n_layers)
        kw = {}
        if self.family == "lm" and getattr(shape, "kind", "") == "train":
            kw["microbatches"] = choose_microbatches(
                self.config, shape, mesh)
        return self.workload_fn(cfg, shape, mesh, **kw)


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
    """How many ways the batch dim actually shards on this mesh."""
    if mesh is None:
        return 1
    axes = shd.resolve((shd.BATCH,), (b,), mesh)[0]
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = shd.mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


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


def _tokens(mesh, b: int, s: int):
    return (_sds((b, s), torch.int32),
            shd.named_sharding(mesh, (shd.BATCH, None), (b, s))
            if mesh is not None else None)


def lm_train_workload(cfg, shape: LMShape, mesh,
                      opt_cfg: optimizer.AdamWConfig | None = None,
                      microbatches: int | None = None) -> Workload:
    """The LM training step on ``shape``: ``value_and_grad`` of
    ``transformer.loss_fn`` and AdamW.  With ``k > 1`` microbatches (the
    batch rows split into ``k`` consecutive parts, each laid out on the
    batch axes) the gradients are summed in float32, then the loss and
    the gradients divided by ``k``, as the JAX package's accumulation scan
    does."""
    opt_cfg = opt_cfg or optimizer.AdamWConfig()
    specs = transformer.param_specs(cfg)
    p_sds = prm.tree_sds(specs)
    p_shd = prm.tree_shardings(mesh, specs)
    o_sds = optimizer.AdamWState(
        step=_sds((), torch.int32), mu=p_sds, nu=p_sds)
    b, s = shape.global_batch, shape.seq_len
    tok_sds, tok_shd = _tokens(mesh, b, s)
    batch_sds = {"tokens": tok_sds, "targets": tok_sds}
    shardings = None
    if mesh is not None:
        o_shd = optimizer.AdamWState(step=_replicated(mesh), mu=p_shd,
                                     nu=p_shd)
        shardings = (p_shd, o_shd, {"tokens": tok_shd, "targets": tok_shd})
    k = microbatches or choose_microbatches(cfg, shape, mesh)
    grad_fn = value_and_grad(transformer.loss_fn)

    def step(params, opt_state, batch):
        if k == 1:
            loss, grads = grad_fn(params, batch, cfg, mesh)
        else:
            m = b // k
            loss = 0.0
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(k):
                mb = {n: shd.constrain(x[i * m:(i + 1) * m], mesh,
                                       shd.BATCH, None)
                      for n, x in batch.items()}
                l, g = grad_fn(params, mb, cfg, mesh)
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
        in_sds=(p_sds, o_sds, batch_sds), in_shardings=shardings,
        model_flops=6.0 * lm_active_params(cfg) * b * s,
    )


def lm_prefill_workload(cfg, shape: LMShape, mesh) -> Workload:
    specs = serve_param_specs(cfg)
    b, s = shape.global_batch, shape.seq_len
    tok_sds, tok_shd = _tokens(mesh, b, s)

    @torch.no_grad()
    def step(params, tokens):
        logits, _ = transformer.forward(params, tokens, cfg, mesh)
        return logits

    return Workload(
        name=f"{cfg.name}/{shape.name}", kind="prefill", fn=step,
        in_sds=(prm.tree_sds(specs), tok_sds),
        in_shardings=None if mesh is None else (
            prm.tree_shardings(mesh, specs), tok_shd),
        model_flops=2.0 * lm_active_params(cfg) * b * s,
    )


def lm_decode_workload(cfg, shape: LMShape, mesh) -> Workload:
    specs = serve_param_specs(cfg)
    b, s = shape.global_batch, shape.seq_len
    c_specs = transformer.cache_specs(cfg, b, s)
    tok_sds, tok_shd = _tokens(mesh, b, 1)
    shardings = None
    if mesh is not None:
        shardings = (prm.tree_shardings(mesh, specs),
                     prm.tree_shardings(mesh, c_specs), tok_shd,
                     _replicated(mesh))

    @torch.no_grad()
    def step(params, cache, tokens, cache_len):
        return transformer.serve_step(
            params, cache, tokens, cache_len, cfg, mesh)

    return Workload(
        name=f"{cfg.name}/{shape.name}", kind="decode", fn=step,
        in_sds=(prm.tree_sds(specs), prm.tree_sds(c_specs), tok_sds,
                _sds((), torch.int32)),
        in_shardings=shardings,
        model_flops=2.0 * lm_active_params(cfg) * b,
    )


def lm_workload(cfg, shape: LMShape, mesh, **kw) -> Workload:
    if shape.kind == "train":
        return lm_train_workload(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return lm_prefill_workload(cfg, shape, mesh)
    return lm_decode_workload(cfg, shape, mesh)
