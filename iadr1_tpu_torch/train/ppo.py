"""PPO trainer (the port's own copy of iadr1_tpu/train/ppo.py): the
clipped surrogate plus the clipped value loss with GAE, as TRL's
PPOTrainer that LLaMA-Factory's CustomPPOTrainer wraps:

* per-token KL-penalty rewards -kl_coef * (logp - ref_logp), the score
  added at the last response token (TRL's compute_rewards);
* GAE with (gamma, lam), the advantages masked-whitened;
* the clipped surrogate plus vf_coef * 0.5 * the clipped value loss;
* an adaptive or fixed KL controller;
* optional score normalization by running moments.

One experience pass scores old logps, reference logps and values for the
whole rollout without a graph; GAE and the reward shaping are small [B, N]
numpy arrays on the host; then ``ppo_epochs`` x minibatch updates revisit
the same experience.  The value head rides the parameter tree
({"model": ..., "vhead": ...}), so policy and value train from one
forward.  The rollout runs on the port's ``RolloutEngine`` (K1 prefill,
K4 decode on the card) from a compute-dtype copy of the policy's dense
weights, as the GRPO trainer's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.train.grpo import (
    _update_batch_to_device,
    bundle_score_fn,
    chunked_token_logps,
    collate_text_prompts,
    sampling_generator,
)
from iadr1_tpu_torch.train.preference import apply_update, init_value_head
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    cast_dense_params,
)
from iadr1_tpu_torch.train.sft import batch_to_device
from iadr1_tpu_torch.train.state import tree_leaves

# profiler range names of a PPO step's phases
PPO_RANGES = ("ppo_rollout", "ppo_experience", "ppo_update")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # TRL's PPOConfig defaults as the reference trainer configures them
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 0.1
    init_kl_coef: float = 0.2
    ppo_target: float = 6.0           # finetuning_args.ppo_target
    adaptive_kl: bool = True          # target None -> the fixed controller
    kl_horizon: float = 10000.0
    ppo_epochs: int = 4
    mini_batch_size: int = 1
    whiten_rewards: bool = False
    score_norm: bool = False
    score_clip: float = 0.0           # 0 = off
    max_prompt_length: int = 1024
    max_completion_length: int = 512
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    logp_chunk_size: int = 1024
    remat: str = "save_flash"


class AdaptiveKLController:
    """TRL's AdaptiveKLController: kl_coef *= 1 + clip(err, +-0.2) * n/H."""

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int):
        err = np.clip(current_kl / self.target - 1.0, -0.2, 0.2)
        self.value *= 1.0 + err * n_steps / self.horizon


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current_kl: float, n_steps: int):
        pass


class RunningMoments:
    """TRL's RunningMoments (Welford over batches) for score scaling."""

    def __init__(self):
        self.mean, self.std, self.var, self.count = 0.0, 1.0, 1.0, 1e-24

    def update(self, xs: np.ndarray) -> tuple[float, float]:
        xs_count = xs.size
        xs_mean = float(xs.mean())
        xs_var = float(xs.var())
        delta = xs_mean - self.mean
        tot_count = self.count + xs_count
        new_sum = xs_var * xs_count
        old_sum = (self.var * self.count
                   + delta ** 2 * self.count * xs_count / tot_count)
        self.mean += delta * xs_count / tot_count
        self.var = (old_sum + new_sum) / tot_count
        self.std = float(np.sqrt(self.var * tot_count
                                 / max(tot_count - 1, 1)))
        self.count = tot_count
        return xs_mean, float(np.sqrt(xs_var * xs_count
                                      / max(xs_count - 1, 1)))


def masked_whiten(x: np.ndarray, mask: np.ndarray,
                  shift_mean: bool = True) -> np.ndarray:
    m = mask.astype(np.float64)
    total = max(m.sum(), 1.0)
    mean = (x * m).sum() / total
    var = ((x - mean) ** 2 * m).sum() / total
    out = (x - mean) * (var + 1e-8) ** -0.5
    if not shift_mean:
        out = out + mean
    return out.astype(np.float32)


def compute_gae(rewards: np.ndarray, values: np.ndarray, mask: np.ndarray,
                gamma: float, lam: float) -> tuple[np.ndarray, np.ndarray]:
    """GAE over the response tokens (TRL's compute_advantages).

    rewards/values/mask: [B, N].  Returns (advantages whitened, returns)."""
    values = values * mask
    rewards = rewards * mask
    B, N = rewards.shape
    adv = np.zeros((B, N), np.float64)
    lastgaelam = np.zeros(B, np.float64)
    for t in reversed(range(N)):
        nextvalues = values[:, t + 1] if t < N - 1 else 0.0
        delta = rewards[:, t] + gamma * nextvalues - values[:, t]
        lastgaelam = delta + gamma * lam * lastgaelam
        adv[:, t] = lastgaelam
    returns = (adv + values).astype(np.float32)
    adv = masked_whiten(adv, mask)
    return adv * mask, returns * mask


def _pred_slice(hidden, prompt_len: int, n: int):
    # hidden states at P-1 .. P+N-2 predict response tokens 0..N-1; the
    # value head reads the same positions
    return hidden[:, prompt_len - 1:prompt_len - 1 + n]


def _values(pred, vhead):
    return (pred.float() @ vhead["kernel"] + vhead["bias"])[..., 0]


def make_experience_fn(score_fn, cfg: PPOConfig, ref_score_fn=None):
    """``(params, ref_params, batch) -> (old_logps, ref_logps, values)``
    [B, N] each, without a graph; ``params`` = {"model", "vhead"}."""
    if ref_score_fn is None:
        ref_score_fn = score_fn

    @torch.no_grad()
    def experience(params, ref_params, batch):
        batch = _update_batch_to_device(
            batch, tree_leaves(params)[0].device)
        P, N = batch["prompt_len"], batch["completion_ids"].shape[1]
        hidden, kernel = score_fn(params["model"], batch)
        pred = _pred_slice(hidden, P, N)
        logps = chunked_token_logps(pred, kernel, batch["completion_ids"],
                                    cfg.logp_chunk_size)
        values = _values(pred, params["vhead"])
        del hidden, pred
        ref_hidden, ref_kernel = ref_score_fn(ref_params, batch)
        ref_logps = chunked_token_logps(
            _pred_slice(ref_hidden, P, N), ref_kernel,
            batch["completion_ids"], cfg.logp_chunk_size)
        return logps, ref_logps, values

    return experience


def make_ppo_update_step(score_fn, optimizer, cfg: PPOConfig, schedule=None):
    """``step(state, ref_params, batch) -> (state, metrics)``, one
    minibatch update.  batch adds old_logps, old_values, advantages and
    returns [B, N] to input_ids/segment_ids/position_ids/completion_*
    and prompt_len; ``ref_params`` is not read (the KL sits in the
    rewards).  Metrics add grad_norm to the JAX step's."""

    def step(state, ref_params, batch):
        batch = _update_batch_to_device(
            batch, tree_leaves(state.params)[0].device)
        mask = batch["completion_mask"].float()
        denom = mask.sum().clamp(min=1.0)
        params = state.params
        with record_function(PPO_RANGES[2]):
            hidden, kernel = score_fn(params["model"], batch)
            P, N = batch["prompt_len"], batch["completion_ids"].shape[1]
            pred = _pred_slice(hidden, P, N)
            logps = chunked_token_logps(pred, kernel,
                                        batch["completion_ids"],
                                        cfg.logp_chunk_size)
            vpred = _values(pred, params["vhead"])

            # TRL's PPOTrainer.loss
            adv = batch["advantages"].float()
            old_logps = batch["old_logps"].float()
            old_values = batch["old_values"].float()
            returns = batch["returns"].float()
            ratio = torch.exp(logps - old_logps)
            pg1 = -adv * ratio
            pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.cliprange,
                                     1.0 + cfg.cliprange)
            pg_loss = (torch.maximum(pg1, pg2) * mask).sum() / denom
            vclip = old_values + torch.clamp(
                vpred - old_values, -cfg.cliprange_value,
                cfg.cliprange_value)
            vf1 = (vpred - returns).square()
            vf2 = (vclip - returns).square()
            vf_loss = 0.5 * (torch.maximum(vf1, vf2) * mask).sum() / denom
            loss = pg_loss + cfg.vf_coef * vf_loss
            with torch.no_grad():
                metrics = {
                    "loss": loss, "pg_loss": pg_loss, "vf_loss": vf_loss,
                    "approx_kl": 0.5 * ((logps - old_logps).square()
                                        * mask).sum() / denom,
                    "clipfrac": ((pg2 > pg1).float() * mask).sum() / denom,
                }
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


class PPOTrainer:
    """Host loop: rollout -> score -> KL-shaped rewards -> GAE ->
    ``ppo_epochs`` x minibatch updates.

    ``reward_fn(texts, examples) -> [n_prompts] floats`` stands in for the
    reference's reward model or reward server.  ``state.params`` is
    {"model", "vhead"} (``make_ppo_state_params``); ``ref_params`` the
    frozen reference model, on ``device``.  The rollout of step k (from 0)
    draws from a generator seeded by (``seed``, k) alone, as the GRPO
    trainer's."""

    def __init__(self, bundle, tokenizer, optimizer, cfg: PPOConfig,
                 reward_fn: Callable, state, ref_params,
                 sampling_overrides: dict | None = None, schedule=None,
                 device=None, seed: int = 0):
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.reward_fn = reward_fn
        self.state = state
        self.ref_params = ref_params
        self.device = resolve_device(device)
        self.seed = seed
        sampling = SamplingConfig(
            max_new_tokens=cfg.max_completion_length,
            temperature=cfg.temperature, top_p=cfg.top_p, top_k=cfg.top_k,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or tokenizer.eos_token_id,
            **(sampling_overrides or {}))
        self.engine = RolloutEngine(
            bundle, sampling,
            max_len=cfg.max_prompt_length + cfg.max_completion_length,
            device=self.device)
        remat = True if cfg.remat == "save_flash" else cfg.remat
        score = bundle_score_fn(bundle, remat=remat)
        self.experience_fn = make_experience_fn(score, cfg)
        self.update_step = make_ppo_update_step(score, optimizer, cfg,
                                                schedule)
        self.kl_ctl = (
            AdaptiveKLController(cfg.init_kl_coef, cfg.ppo_target,
                                 cfg.kl_horizon)
            if cfg.adaptive_kl else FixedKLController(cfg.init_kl_coef))
        self.running = RunningMoments()
        self._rollouts = 0
        self.metrics_history: list[dict] = []

    def _collate_prompts(self, examples: Sequence[dict]) -> dict:
        return collate_text_prompts(
            self.bundle, examples, self.cfg.max_prompt_length,
            self.tokenizer.pad_token_id or self.tokenizer.eos_token_id)

    def step(self, examples: Sequence[dict]) -> dict:
        cfg = self.cfg
        batch = self._collate_prompts(examples)
        with record_function(PPO_RANGES[0]):
            policy = cast_dense_params(self.state.params["model"],
                                       self.bundle.precision.compute_dtype)
            generator = sampling_generator(self.seed, self._rollouts,
                                           self.device)
            self._rollouts += 1
            rollout = self.engine.generate(
                policy, batch_to_device(batch, self.device), generator)
            del policy
        completion_ids = rollout["completion_ids"].cpu().numpy()
        completion_mask = rollout["completion_mask"].cpu().numpy()
        prompt_ids = rollout["prompt_ids"].cpu().numpy()
        prompt_mask = rollout["prompt_mask"].cpu().numpy()
        del rollout
        texts = self.tokenizer.batch_decode(
            [ids[m.astype(bool)]
             for ids, m in zip(completion_ids, completion_mask)],
            skip_special_tokens=True)
        scores = np.asarray(self.reward_fn(texts, examples), np.float64)

        # score scaling / normalization (TRL's use_score_scaling/norm)
        if cfg.score_norm:
            self.running.update(scores)
            scores = (scores - self.running.mean) / max(self.running.std,
                                                        1e-8)
        if cfg.score_clip and cfg.score_clip > 0:
            scores = np.clip(scores, -cfg.score_clip, cfg.score_clip)

        full_ids = np.concatenate([prompt_ids, completion_ids], axis=1)
        full_mask = np.concatenate([prompt_mask, completion_mask], axis=1)
        B, P = prompt_ids.shape
        N = completion_ids.shape[1]
        if "position_ids" in batch:   # M-RoPE: prompt grids + delta positions
            comp_pos = (P + batch["mrope_deltas"][:, None]
                        + np.arange(N)[None, :])
            positions = np.concatenate(
                [batch["position_ids"], np.broadcast_to(comp_pos, (3, B, N))],
                axis=-1)
        else:
            positions = np.clip(np.cumsum(full_mask, axis=1) - 1, 0, None)
        base_batch = {"input_ids": full_ids, "segment_ids": full_mask,
                      "position_ids": positions,
                      "completion_ids": completion_ids,
                      "completion_mask": completion_mask, "prompt_len": P}
        with record_function(PPO_RANGES[1]):
            old_logps, ref_logps, old_values = (
                x.cpu().numpy().astype(np.float64) for x in
                self.experience_fn(self.state.params, self.ref_params,
                                   base_batch))

        # KL-shaped per-token rewards (TRL's compute_rewards, "kl")
        kl = (old_logps - ref_logps) * completion_mask
        rewards = -self.kl_ctl.value * kl
        last_idx = np.maximum(completion_mask.sum(axis=1).astype(int) - 1, 0)
        rewards[np.arange(B), last_idx] += scores
        if cfg.whiten_rewards:
            rewards = masked_whiten(rewards, completion_mask,
                                    shift_mean=False)
        advantages, returns = compute_gae(
            rewards, old_values * completion_mask, completion_mask,
            cfg.gamma, cfg.lam)

        # ppo_epochs x shuffled minibatches over the same experience
        mb = max(min(cfg.mini_batch_size, B), 1)
        n_mb = B // mb
        agg: dict[str, list[float]] = {}
        order_rng = np.random.default_rng(int(self.state.step))
        for _ in range(cfg.ppo_epochs):
            perm = order_rng.permutation(B)
            for j in range(n_mb):
                sel = np.sort(perm[j * mb:(j + 1) * mb])
                mb_batch = {}
                for k, v in base_batch.items():
                    if k == "position_ids" and v.ndim == 3:   # [3, B, T]
                        mb_batch[k] = v[:, sel]
                    elif isinstance(v, np.ndarray) and v.shape[0] == B:
                        mb_batch[k] = v[sel]
                    else:
                        mb_batch[k] = v
                mb_batch["old_logps"] = old_logps[sel].astype(np.float32)
                mb_batch["old_values"] = old_values[sel].astype(np.float32)
                mb_batch["advantages"] = advantages[sel]
                mb_batch["returns"] = returns[sel]
                self.state, metrics = self.update_step(
                    self.state, self.ref_params, mb_batch)
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(float(v))

        # the controller reads the per-token mean KL, as the JAX trainer
        # does (TRL feeds it the per-sequence sum: ROADMAP C)
        mean_kl = float((kl.sum(axis=1)
                         / np.maximum(completion_mask.sum(axis=1), 1)).mean())
        self.kl_ctl.update(mean_kl, B)
        out = {k: float(np.mean(v)) for k, v in agg.items()}
        out.update({
            "reward": float(scores.mean()),
            "kl": mean_kl,
            "kl_coef": float(self.kl_ctl.value),
            "completion_length": float(completion_mask.sum(axis=1).mean()),
        })
        self.metrics_history.append(out)
        return out


def make_ppo_state_params(model_params, hidden_size: int,
                          generator: torch.Generator | None = None) -> dict:
    """The policy + value tree for PPOTrainer (the value-head model's
    counterpart); the head on the parameters' device, drawn from
    ``generator`` (default: seed 0 there)."""
    if generator is None:
        device = tree_leaves(model_params)[0].device
        generator = torch.Generator(device=device).manual_seed(0)
    return {"model": model_params,
            "vhead": init_value_head(generator, hidden_size)}
