"""Optimizer and LR schedules (the port's own copy of
iadr1_tpu/train/optimizers.py, AdamW path).

The arithmetic is optax's, step for step: ``clip_by_global_norm`` first
(updates scaled by ``max_norm / norm`` only when ``norm >= max_norm``),
then Adam (eps outside the square root, bias correction by
``1 - b**count``), decoupled weight decay, and the learning rate read at
``schedule(count)`` before the count is incremented.  Parameters and
moments are updated in place, leaf by leaf, which keeps the transient
memory to one leaf instead of a parameter-sized copy of updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    schedule: str = "cosine"          # cosine | linear | constant
    warmup_ratio: float = 0.1
    warmup_steps: int | None = None   # overrides warmup_ratio when set
    total_steps: int = 0              # the schedule's horizon
    min_lr_ratio: float = 0.0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # dtype of the Adam first moment ("bfloat16" halves its memory; the
    # second moment stays f32)
    mu_dtype: str | None = None
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"
    loraplus_lr_ratio: float = 0.0


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """step -> learning rate: linear warmup from 0, then cosine, linear or
    constant decay (optax's join_schedules of its schedules)."""
    warmup = (cfg.warmup_steps if cfg.warmup_steps is not None
              else int(cfg.total_steps * cfg.warmup_ratio))
    peak = cfg.learning_rate
    end = peak * cfg.min_lr_ratio
    decay_steps = max(cfg.total_steps - warmup, 1)
    if cfg.schedule == "cosine":
        def decay(count):
            count = min(float(count), float(decay_steps))
            cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return peak * ((1 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)
    elif cfg.schedule == "linear":
        def decay(count):
            return _linear(peak, end, decay_steps, count)
    elif cfg.schedule == "constant":
        def decay(count):
            return peak
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if warmup == 0:
        return decay

    def schedule(count):
        if count < warmup:
            return _linear(0.0, peak, warmup, count)
        return decay(count - warmup)

    return schedule


def _linear(init: float, end: float, steps: int, count) -> float:
    count = min(max(float(count), 0.0), float(steps))
    return (init - end) * (1 - count / steps) + end


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...)),
    in place.  ``init(params)`` -> state; ``apply(params, grads, state)``
    updates ``params`` and ``state`` in place."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, mu_dtype,
                 max_grad_norm):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.max_grad_norm = max_grad_norm

    def init(self, params: list[torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def apply(self, params, grads, state, grad_norm=None) -> None:
        if grad_norm is None:
            grad_norm = global_norm(grads)
        clip = (self.max_grad_norm is not None and self.max_grad_norm > 0
                and bool(grad_norm >= self.max_grad_norm))
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        # bias corrections in f32, as optax computes them
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** count)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g.float()
            if clip:
                g = g / grad_norm * self.max_grad_norm
            # as in optax, b1 * mu is taken in mu's dtype (b1 rounded to
            # it too) before the f32 sum
            b1_mu = float(torch.tensor(self.b1, dtype=mu.dtype))
            m = (1 - self.b1) * g + b1_mu * mu
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            update = (m / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            mu.copy_(m)                                 # cast to mu_dtype
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.copy_(p + (-lr) * update)
        state["count"] = count


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_optimizer(cfg: OptimizerConfig):
    """(optimizer, schedule) for the AdamW path; the other optimizers and
    LoRA+ wait for ROADMAP A.14."""
    if cfg.optimizer != "adamw" or cfg.loraplus_lr_ratio:
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}"
            + (" with LoRA+" if cfg.loraplus_lr_ratio else "")
            + " is not ported yet (ROADMAP A.14); the port has AdamW")
    schedule = make_schedule(cfg)
    mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None
    return AdamW(schedule, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay,
                 mu_dtype, cfg.max_grad_norm), schedule
