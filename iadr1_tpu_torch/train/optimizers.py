"""Optimizer and LR schedules (the port's own copy of
iadr1_tpu/train/optimizers.py).  AdamW is here; every other optimizer
``make_optimizer`` builds is in ``train/custom_optim.py``.

The arithmetic is optax's, step for step: ``clip_by_global_norm`` first
(updates scaled by ``max_norm / norm`` only when ``norm >= max_norm``),
then Adam (eps outside the square root, bias correction by
``1 - b**count``), decoupled weight decay, and the learning rate read at
``schedule(count)`` before the count is incremented.  Parameters and
moments are updated in place, leaf by leaf, which keeps the transient
memory to one leaf instead of a parameter-sized copy of updates.  On a
mesh AdamW updates each rank's local shards (its moments are DTensors
placed as their parameters) and ``global_norm`` reduces over the whole
mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from iadr1_tpu_torch.core.mesh import is_dtensor, local


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
    # adamw | adafactor | sgd | lion | galore | apollo | badam | adam_mini
    # | muon
    optimizer: str = "adamw"
    # the custom optimizers' knobs (LLaMA-Factory's finetuning_args names
    # and defaults)
    galore_rank: int = 16
    galore_update_interval: int = 200
    galore_scale: float = 0.25
    apollo_rank: int = 16
    apollo_update_interval: int = 200
    apollo_scale: float = 1.0
    apollo_scale_type: str = "channel"   # channel | tensor (APOLLO-mini)
    badam_switch_interval: int = 50
    badam_switch_mode: str = "ascending"
    badam_num_layers: int = 0            # 0: the decoder's depth
    adam_mini_head_dim: int = 0          # 0: a value per neuron for q/k too
    loraplus_lr_ratio: float = 0.0       # > 0 enables LoRA+
    loraplus_lr_embedding: float = 1e-6


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


def bias_correction(b: float, count) -> float:
    """1 - b**count in f32, as optax computes it."""
    return float(1 - torch.tensor(b, dtype=torch.float32) ** count)


# elements of one leaf AdamW updates at a time (256 MB in f32): a 3B
# model's stacked MLP kernels are 3 GB a leaf, and a whole-leaf update's
# temporaries would take several times that beside 60 GB of parameters,
# gradients and moments
UPDATE_SLICE = 1 << 26


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...)),
    in place.  ``init(params, paths)`` -> state (AdamW reads no paths);
    ``apply(params, grads, state)`` updates ``params`` and ``state`` in
    place; on DTensors, each rank's shards."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, mu_dtype,
                 max_grad_norm):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.max_grad_norm = max_grad_norm

    def init(self, params: list[torch.Tensor],
             paths: list[str] | None = None) -> dict:
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
        bc1 = bias_correction(self.b1, count)
        bc2 = bias_correction(self.b2, count)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            # as in optax, b1 * mu is taken in mu's dtype (b1 rounded to
            # it too) before the f32 sum
            b1_mu = float(torch.tensor(self.b1, dtype=mu.dtype))
            # views: the slices' copies land in the leaves themselves
            flat = [local(p).view(-1), local(g).reshape(-1),
                    local(mu).view(-1), local(nu).view(-1)]
            # a slice of the leaf at a time: the update's f32 temporaries
            # stay within a few slices, however large the leaf
            for i in range(0, flat[0].numel(), UPDATE_SLICE):
                p_, g_, mu_, nu_ = (t[i:i + UPDATE_SLICE] for t in flat)
                g_ = g_.float()
                if clip:
                    g_ = g_ / grad_norm * self.max_grad_norm
                m = (1 - self.b1) * g_ + b1_mu * mu_
                nu_.copy_((1 - self.b2) * g_.square() + self.b2 * nu_)
                update = (m / bc1) / (torch.sqrt(nu_ / bc2) + self.eps)
                mu_.copy_(m)                            # cast to mu_dtype
                if self.weight_decay:
                    update = update + self.weight_decay * p_
                p_.copy_(p_ + (-lr) * update)
        state["count"] = count


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, an f32 scalar (optax).
    The f32 squares are summed in f64 and the root rounded to f32 once, so
    the norm is the same however the elements are split and ordered: one
    process's, and a mesh's whatever its shards.  Over DTensors the sum is
    over the whole mesh, each element once: a shard counts on the ranks at
    coordinate 0 of the axes it is replicated on, and one all-reduce over
    every rank gives all of them the same norm (the clipping decision must
    agree)."""
    tensors = list(tensors)
    if not any(is_dtensor(t) for t in tensors):
        return torch.sqrt(sum(_square_sum(t) for t in tensors)).float()
    total = sum(_square_sum(local(t)) for t in tensors
                if not is_dtensor(t) or _counted_here(t))
    total = torch.as_tensor(total, dtype=torch.float64,
                            device=local(tensors[0]).device).clone()
    dist.all_reduce(total)
    return torch.sqrt(total).float()


def _square_sum(t) -> torch.Tensor:
    """The f64 sum of t's f32 squares, a slice at a time (the f64
    temporaries stay within one slice)."""
    flat = t.float().reshape(-1)
    return sum((flat[i:i + UPDATE_SLICE].square().sum(dtype=torch.float64)
                for i in range(0, flat.numel(), UPDATE_SLICE)),
               flat.new_zeros((), dtype=torch.float64))


def _counted_here(t) -> bool:
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if not p.is_shard())


def make_optimizer(cfg: OptimizerConfig):
    """(optimizer, schedule), each optimizer chained as the JAX package
    chains it: clipping by the global norm first; for galore, apollo,
    badam and adam_mini the scaler, weight decay, then the learning rate;
    LoRA+ whenever ``loraplus_lr_ratio`` > 0."""
    from iadr1_tpu_torch.train import custom_optim as co

    schedule = make_schedule(cfg)
    clip = cfg.max_grad_norm if cfg.max_grad_norm and (
        cfg.max_grad_norm > 0) else None
    adam = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    if cfg.loraplus_lr_ratio and cfg.loraplus_lr_ratio > 0:
        return co.LoraPlus(schedule, lr_ratio=cfg.loraplus_lr_ratio,
                           lr_embedding=cfg.loraplus_lr_embedding,
                           weight_decay=cfg.weight_decay, max_grad_norm=clip,
                           **adam), schedule
    chained = dict(weight_decay=cfg.weight_decay, max_grad_norm=clip)
    if cfg.optimizer == "galore":
        return co.GaLore(schedule, rank=cfg.galore_rank,
                         update_proj_gap=cfg.galore_update_interval,
                         scale=cfg.galore_scale, **adam, **chained), schedule
    if cfg.optimizer == "apollo":
        return co.Apollo(schedule, rank=cfg.apollo_rank,
                         update_proj_gap=cfg.apollo_update_interval,
                         scale=cfg.apollo_scale,
                         scale_type=cfg.apollo_scale_type, **adam,
                         **chained), schedule
    if cfg.optimizer == "badam":
        return co.BAdam(schedule, num_layers=cfg.badam_num_layers or None,
                        switch_interval=cfg.badam_switch_interval,
                        switch_mode=cfg.badam_switch_mode, **adam,
                        **chained), schedule
    if cfg.optimizer == "adam_mini":
        return co.AdamMini(schedule, head_dim=cfg.adam_mini_head_dim or None,
                           **adam, **chained), schedule
    if cfg.optimizer == "muon":
        return co.Muon(schedule, weight_decay=cfg.weight_decay,
                       adam_b1=cfg.b1, adam_b2=cfg.b2,
                       max_grad_norm=clip), schedule
    if cfg.optimizer == "adafactor":
        return co.Adafactor(schedule, max_grad_norm=clip), schedule
    if cfg.optimizer == "lion":
        return co.Lion(schedule, weight_decay=cfg.weight_decay,
                       max_grad_norm=clip), schedule
    if cfg.optimizer == "sgd":
        return co.SGD(schedule, max_grad_norm=clip), schedule
    if cfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None
    return AdamW(schedule, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay,
                 mu_dtype, cfg.max_grad_norm), schedule
