"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP in every
layer [hf:Snowflake/snowflake-arctic-base]."""

import torch

from repro_torch.models.transformer import TransformerConfig

from .common import LM_SHAPES, ArchDef, lm_workload

CONFIG = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,                 # dense residual MLP
    vocab=32000,
    rope_theta=10_000.0,
    moe=True,
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    dense_residual=True,
    dtype=torch.bfloat16,
    remat="full",
)

SMOKE = TransformerConfig(
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=256,
    rope_theta=10_000.0,
    moe=True,
    n_experts=4,
    top_k=2,
    d_ff_expert=96,
    dense_residual=True,
    capacity_factor=8.0,
    dtype=torch.float32,
    remat="none",
    q_chunk=16,
)

ARCH = ArchDef(
    name="arctic-480b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, workload_fn=lm_workload,
)
