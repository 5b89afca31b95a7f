"""Registry entries shared by all architecture configs."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ArchDef:
    """Registry entry: full config + reduced smoke config + shape table.

    The JAX package's entries also carry a dry-run workload function; that
    waits for ROADMAP slice 10 here.
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
    from repro_torch.models import params as prm, transformer

    def at_dtype(node):
        if prm.is_spec(node):
            return node._replace(dtype=cfg.dtype)
        return {k: at_dtype(v) for k, v in node.items()}

    return at_dtype(transformer.param_specs(cfg))
