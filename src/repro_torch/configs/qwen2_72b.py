"""qwen2-72b — dense LM, GQA kv=8, QKV bias [arXiv:2407.10671]."""

import torch

from repro_torch.models.transformer import TransformerConfig

from .common import LM_SHAPES, ArchDef, lm_workload

CONFIG = TransformerConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    dtype=torch.bfloat16,
    remat="full",
)

SMOKE = TransformerConfig(
    name="qwen2-72b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=160,
    vocab=512,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    dtype=torch.float32,
    remat="none",
    q_chunk=16,
)

ARCH = ArchDef(
    name="qwen2-72b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, workload_fn=lm_workload,
)
