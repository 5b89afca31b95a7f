"""Serve a small LM with batched requests through the serving engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Trains a tiny model briefly (so generations aren't pure noise), then runs a
mixed batch of prompts through the slot-pooled engine (the decode step is
``transformer.serve_step``, the same one a full-size config serves with).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.core.executor import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import optimizer
from repro_torch.training.tree import value_and_grad


def warmup(cfg, device, *, steps: int = 60, seed: int = 0):
    """``steps`` AdamW steps on a repeating pattern (k -> k+1 mod 8);
    returns ``(params, last loss)``."""
    params = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device=device)
    tokens = torch.arange(8, dtype=torch.int64, device=device).repeat(4, 8)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    opt_cfg = optimizer.AdamWConfig(lr=5e-3, warmup_steps=1)
    state = optimizer.init_state(params)
    grad_fn = value_and_grad(transformer.loss_fn)
    loss = None
    for _ in range(steps):
        loss, grads = grad_fn(params, batch, cfg)
        params, state, _ = optimizer.apply_updates(opt_cfg, params, grads,
                                                   state)
    return params, float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: CUDA)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_arch("gemma3-1b").smoke_config,
                              name="gemma3-tiny")
    params, loss = warmup(cfg, device, steps=args.steps)
    print(f"warmup train loss: {loss:.3f}")

    engine = ServingEngine(cfg, params, slots=2, max_len=96)
    requests = [
        Request(prompt=[0, 1, 2, 3], max_new_tokens=8),
        Request(prompt=[4, 5, 6], max_new_tokens=8),
        Request(prompt=[2, 3, 4, 5, 6], max_new_tokens=6),
    ]
    done = engine.run(requests)
    for i, r in enumerate(done):
        print(f"request {i}: prompt={r.prompt} -> generated={r.out}")
        if not (r.done and len(r.out) == r.max_new_tokens):
            raise SystemExit(f"request {i} did not finish with "
                             f"{r.max_new_tokens} tokens")
    # the learned pattern is k -> k+1 (mod 8); check the first request
    expected_next = (requests[0].prompt[-1] + 1) % 8
    print(f"expected continuation of {requests[0].prompt}: {expected_next}, "
          f"got {done[0].out[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
