"""Training CLI: ``python -m repro_torch.launch.train --arch granite-8b``.

Runs the fault-tolerant training loop on one device (CUDA unless
``--device cpu``): the LM archs only, on synthetic tokens from
``lm_pipeline``.  Resumes automatically from the newest checkpoint under
``--ckpt-dir``.  As in the JAX package's CLI, ``--smoke`` is on by
default and cannot be switched off, so the CLI always trains the reduced
config; the full configs train through
``configs.common.lm_train_workload``'s step.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import arch_names, get_arch
from repro_torch.configs.common import LMShape, lm_train_workload
from repro_torch.core.executor import resolve_device
from repro_torch.data import lm_pipeline
from repro_torch.models import transformer
from repro_torch.training import optimizer, train_loop


def make_step(cfg, *, batch: int, seq_len: int,
              opt_cfg: optimizer.AdamWConfig):
    """The CLI's training step: ``lm_train_workload``'s step on
    ``[batch, seq_len]`` tokens without microbatches (``value_and_grad``
    of ``transformer.loss_fn``, then AdamW)."""
    shape = LMShape("cli", seq_len, batch, "train")
    return lm_train_workload(cfg, shape, None, opt_cfg, microbatches=1).fn


def token_batches(cfg, *, batch: int, seq_len: int, device, seed: int = 0):
    """``lm_pipeline``'s synthetic token batches as int32 tensors on
    ``device``."""
    for tokens, targets in lm_pipeline.batches(
            seed, batch=batch, seq_len=seq_len, vocab=cfg.vocab):
        yield {"tokens": torch.as_tensor(tokens, device=device),
               "targets": torch.as_tensor(targets, device=device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: CUDA)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(
            f"{args.arch} is a {arch.family} arch — use the examples' "
            "programs for GNN/recsys/mining training"
        )
    device = resolve_device(args.device)
    cfg = arch.smoke_config if args.smoke else arch.config
    params = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=device)
    opt_state = optimizer.init_state(params)
    opt_cfg = optimizer.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
    )
    loop_cfg = train_loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, metrics_path=args.metrics,
    )
    params, opt_state, history = train_loop.run(
        step_fn=make_step(cfg, batch=args.batch, seq_len=args.seq_len,
                          opt_cfg=opt_cfg),
        params=params, opt_state=opt_state,
        batches=token_batches(cfg, batch=args.batch, seq_len=args.seq_len,
                              device=device),
        loop_cfg=loop_cfg, device=device,
    )
    losses = [h["loss"] for h in history]
    if losses:
        print(f"trained {len(losses)} steps on {device}: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"checkpoints under {args.ckpt_dir}")
    return params, opt_state, history


if __name__ == "__main__":
    main()
