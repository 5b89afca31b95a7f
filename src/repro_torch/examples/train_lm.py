"""End-to-end example: train a ~100M-param granite-style LM for a few
hundred steps on synthetic data with the full training substrate (AdamW +
cosine schedule, grad clipping, fault-tolerant checkpointing, crash
resume).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \\
        [--device cpu]

The small twin of granite-8b/train_4k: the same step function
(``configs.common.lm_train_workload``'s) trains the full width.  Runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.core.executor import resolve_device
from repro_torch.launch.train import make_step, token_batches
from repro_torch.models import transformer
from repro_torch.training import optimizer, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~100M params: granite family scaled to laptop size
    cfg = dataclasses.replace(
        get_arch("granite-8b").config,
        name="granite-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, d_head=64, d_ff=1536, vocab=8192,
        dtype=torch.float32, remat="none", q_chunk=128,
    )
    print(f"{cfg.name}: {cfg.n_params() / 1e6:.1f}M params on {device}")

    params = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=device)
    opt_cfg = optimizer.AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps)
    loop_cfg = train_loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=100)
    _, _, history = train_loop.run(
        step_fn=make_step(cfg, batch=args.batch, seq_len=args.seq_len,
                          opt_cfg=opt_cfg),
        params=params, opt_state=optimizer.init_state(params),
        batches=token_batches(cfg, batch=args.batch, seq_len=args.seq_len,
                              device=device),
        loop_cfg=loop_cfg, device=device)

    losses = [h["loss"] for h in history]
    print(f"steps {history[0]['step']}..{history[-1]['step']}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must make progress"
    return history


if __name__ == "__main__":
    main()
