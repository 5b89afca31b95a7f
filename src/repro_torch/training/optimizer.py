"""AdamW + cosine schedule, written out on trees of tensors.

States are plain trees matching the parameter tree (the JAX package's
``AdamWState(step, mu, nu)``, flattened in the same order).  The update
follows the JAX formula operation for operation, in float32:
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  It is not
``torch.optim.AdamW``, whose decoupled decay is applied in another order.
Updates are functional: each step returns new tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any = None
    nu: Any = None


def init_state(params) -> AdamWState:
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to ``min_lr_ratio * lr`` (float32,
    as a tensor on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree):
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    new = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu),
        strict=True)]
    new_p = unflatten(params, [n[0] for n in new])
    new_m = unflatten(params, [n[1] for n in new])
    new_v = unflatten(params, [n[2] for n in new])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), metrics
