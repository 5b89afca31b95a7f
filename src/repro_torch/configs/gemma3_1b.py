"""gemma3-1b — dense LM, 5:1 local:global sliding window, GQA kv=1
[hf:google/gemma-3-1b-pt]."""

import torch

from repro_torch.models.transformer import TransformerConfig

from .common import LM_SHAPES, ArchDef, lm_workload

CONFIG = TransformerConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab=262144,
    rope_theta=1_000_000.0,       # global layers
    rope_theta_local=10_000.0,    # local layers
    window=512,
    pattern_local=5,
    pattern_global=1,
    tie_embeddings=True,
    embed_scale=True,
    dtype=torch.bfloat16,
    remat="full",
)

SMOKE = TransformerConfig(
    name="gemma3-1b-smoke",
    n_layers=6,                   # one full 5:1 local/global period
    d_model=48,
    n_heads=2,
    n_kv_heads=1,
    d_head=24,
    d_ff=96,
    vocab=256,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    window=8,
    pattern_local=5,
    pattern_global=1,
    tie_embeddings=True,
    embed_scale=True,
    dtype=torch.float32,
    remat="none",
    q_chunk=16,
)

ARCH = ArchDef(
    name="gemma3-1b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=LM_SHAPES, workload_fn=lm_workload,
)
