"""Fault-tolerant training loop: periodic checkpoints, crash resume,
preemption handling.

  * resumes from the latest intact checkpoint (atomic manifests mean a
    mid-save crash falls back to the previous step);
  * catches SIGTERM/SIGINT (preemption notice) and checkpoints before exit;
  * metrics stream to a JSONL file for post-hoc analysis.

The step function runs eagerly; nothing is compiled.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Iterator

from . import checkpoint, optimizer


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 10
    metrics_path: str | None = None


class _PreemptionGuard:
    """Flips a flag on SIGTERM/SIGINT so the loop can checkpoint and exit."""

    def __init__(self):
        self.requested = False
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:   # not on the main thread
                pass
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)


def run(
    *,
    step_fn: Callable,
    params,
    opt_state: optimizer.AdamWState,
    batches: Iterator,
    loop_cfg: TrainLoopConfig,
    device=None,
) -> tuple:
    """Run (or resume) training. Returns ``(params, opt_state, history)``.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``.
    A resumed run restores its state onto ``device`` (default: where
    ``params`` and ``opt_state`` lie).
    """
    os.makedirs(loop_cfg.ckpt_dir, exist_ok=True)
    start_step = 0
    state_tree = {"params": params, "opt": opt_state}
    if checkpoint.latest_step(loop_cfg.ckpt_dir) is not None:
        state_tree, start_step = checkpoint.restore(
            loop_cfg.ckpt_dir, state_tree, device=device
        )
        params, opt_state = state_tree["params"], state_tree["opt"]

    metrics_f = None
    if loop_cfg.metrics_path:
        metrics_f = open(loop_cfg.metrics_path, "a")

    history = []
    with _PreemptionGuard() as guard:
        step = start_step
        for step in range(start_step + 1, loop_cfg.total_steps + 1):
            batch = next(batches)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {
                k: float(v) for k, v in metrics.items()
            }
            metrics["step"] = step
            metrics["step_time_s"] = time.perf_counter() - t0
            history.append(metrics)
            if metrics_f and step % loop_cfg.log_every == 0:
                metrics_f.write(json.dumps(metrics) + "\n")
                metrics_f.flush()
            if step % loop_cfg.ckpt_every == 0 or guard.requested:
                checkpoint.save(
                    loop_cfg.ckpt_dir, step,
                    {"params": params, "opt": opt_state},
                    keep=loop_cfg.keep_ckpts,
                )
            if guard.requested:
                break
        else:
            step = loop_cfg.total_steps
        # final checkpoint
        checkpoint.save(
            loop_cfg.ckpt_dir, step,
            {"params": params, "opt": opt_state}, keep=loop_cfg.keep_ckpts,
        )
    if metrics_f:
        metrics_f.close()
    return params, opt_state, history
