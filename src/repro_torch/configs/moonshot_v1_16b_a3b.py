"""moonshot-v1-16b-a3b — DeepSeek-style MoE (64 experts, top-6, shared
experts) [hf:moonshotai/Moonlight-16B-A3B]."""

import torch

from repro_torch.models.transformer import TransformerConfig

from .common import LM_SHAPES, ArchDef, lm_workload

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,                    # all layers MoE (no dense MLP)
    vocab=163840,
    rope_theta=50_000.0,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    dtype=torch.bfloat16,
    remat="full",
)

SMOKE = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_head=12,
    d_ff=0,
    vocab=256,
    rope_theta=50_000.0,
    moe=True,
    n_experts=8,
    top_k=2,
    d_ff_expert=32,
    n_shared_experts=1,
    capacity_factor=8.0,
    dtype=torch.float32,
    remat="none",
    q_chunk=16,
)

ARCH = ArchDef(
    name="moonshot-v1-16b-a3b", family="lm", config=CONFIG,
    smoke_config=SMOKE, shapes=LM_SHAPES, workload_fn=lm_workload,
)
