"""AdamW with a warmup-cosine schedule and global-norm clipping
(``repro/train/optimizer.py``).  Moments are float32 whatever the
param's type; each update runs in float32 and is cast back.

Weight decay follows the reference exactly: it applies to every leaf
whose *stacked* array has ``ndim >= 2``.  A segment's params are stacked
``(repeats, ...)``, so its norm scales ``(R, d)`` and biases ``(R, n)``
are decayed, and only unstacked vectors such as ``final_norm`` are not.

Like the reference, the update is functional: it returns new params and
a new state and leaves its inputs as they are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.io import flatten_with_paths, tree_map, unflatten_paths


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Any
    nu: Any


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), in
    float32: linear warmup to ``peak_lr``, then a cosine to ``min_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(1.0, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * \
        (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    def f32zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = next(iter(flatten_with_paths(params).values()))
    return OptState(step=torch.zeros((), dtype=torch.int32, device=leaf.device),
                    mu=tree_map(f32zeros, params),
                    nu=tree_map(f32zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in the
    reference's order (dict keys sorted)."""
    total = 0.0
    for x in flatten_with_paths(tree).values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, step_f)
    b2c = 1 - torch.pow(cfg.b2, step_f)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:                      # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m, v

    flat_p = flatten_with_paths(params)
    flat_g = flatten_with_paths(grads)
    flat_m = flatten_with_paths(state.mu)
    flat_v = flatten_with_paths(state.nu)
    out = {k: upd(p, flat_g[k], flat_m[k], flat_v[k])
           for k, p in flat_p.items()}
    new_p = unflatten_paths({k: o[0] for k, o in out.items()})
    new_m = unflatten_paths({k: o[1] for k, o in out.items()})
    new_v = unflatten_paths({k: o[2] for k, o in out.items()})
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                 "lr": lr}
