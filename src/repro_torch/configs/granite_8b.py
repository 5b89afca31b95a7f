"""granite-8b — dense code LM, llama-arch, GQA [arXiv:2405.04324; hf]."""

import torch

from repro_torch.models.transformer import TransformerConfig

from .common import LM_SHAPES, ArchDef, lm_workload

CONFIG = TransformerConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    remat="full",
)

SMOKE = TransformerConfig(
    name="granite-8b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    dtype=torch.float32,
    remat="none",
    q_chunk=16,
)

ARCH = ArchDef(
    name="granite-8b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, workload_fn=lm_workload,
)
