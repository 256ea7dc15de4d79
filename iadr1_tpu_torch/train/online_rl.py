"""On-policy trainers beyond SC-GRPO: RLOO and online DPO (the port's own
copy of the first half of iadr1_tpu/train/online_rl.py; XPO and Nash-MD
wait for ROADMAP A.14b).

Both reuse the SC-GRPO machinery: the in-program RolloutEngine, host-side
structured rewards and chunked sequence logps.

* RLOO (TRL's rloo_trainer): the group baseline is leave-one-out,
  adv_i = r_i - mean(r_j, j != i), optionally whitened, instead of GRPO's
  (r - mean) / std.  KL control runs through the update step's k3 penalty
  (GRPOConfig.beta) rather than TRL's in-reward kl_coef.  The trainer is
  the GRPO trainer with its ``compute_advantages`` hook replaced, so the
  shared-prompt and dense updates are the GRPO ones.
* Online DPO (TRL's online_dpo_trainer): two completions per prompt,
  ranked by the summed structured rewards (ties to the first sample), and
  the DPO loss on the on-policy chosen/rejected pair against the frozen
  reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from torch.profiler import record_function

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.train.grpo import (
    GRPOTrainer,
    bundle_score_fn,
    collate_text_prompts,
    sampling_generator,
)
from iadr1_tpu_torch.train.preference import DPOConfig, make_dpo_step
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    cast_dense_params,
)
from iadr1_tpu_torch.train.sft import batch_to_device

# profiler range name of an online DPO step's rollout
ONLINE_DPO_ROLLOUT = "online_dpo_rollout"


def rloo_advantages(rewards: np.ndarray, k: int,
                    normalize: bool = False) -> np.ndarray:
    """Leave-one-out advantages over consecutive groups of ``k``:
    baseline_i = (sum - r_i) / (k - 1); optionally whitened over the whole
    batch (TRL's normalize_advantage)."""
    if k < 2:
        raise ValueError("RLOO needs at least 2 generations per prompt")
    r = rewards.reshape(-1, k).astype(np.float64)
    baseline = (r.sum(axis=1, keepdims=True) - r) / (k - 1)
    adv = (r - baseline).reshape(-1)
    if normalize:
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return adv.astype(np.float32)


class RLOOTrainer(GRPOTrainer):
    """The GRPO host loop with the RLOO leave-one-out baseline (set
    GRPOConfig.beta to TRL's kl_coef for KL control)."""

    def __init__(self, *args, normalize_advantages: bool = False, **kw):
        super().__init__(*args, **kw)
        self.normalize_advantages = normalize_advantages

    def compute_advantages(self, rewards: np.ndarray) -> np.ndarray:
        return rloo_advantages(rewards, self.cfg.num_generations,
                               self.normalize_advantages)


def online_dpo_order(scores: np.ndarray) -> np.ndarray:
    """Rows [2n] (prompt i's samples at 2i and 2i + 1) -> the update's row
    order: the n chosen, then the n rejected.  The higher score is
    chosen; a tie goes to the first sample."""
    n = scores.shape[0] // 2
    pair = scores.reshape(n, 2)
    chosen_col = (pair[:, 1] > pair[:, 0]).astype(np.int64)
    chosen_idx = 2 * np.arange(n) + chosen_col
    rejected_idx = 2 * np.arange(n) + (1 - chosen_col)
    return np.concatenate([chosen_idx, rejected_idx])


class OnlineDPOTrainer:
    """Host loop: roll out 2 completions a prompt -> score -> DPO update.

    ``reward_funcs`` follow the reward signature (summed);
    ``missing_eos_penalty`` is subtracted from completions that never
    emitted EOS.  The rollout of step k draws from a generator seeded by
    (``seed``, k), as the GRPO trainer's."""

    def __init__(self, bundle, tokenizer, optimizer, cfg: DPOConfig,
                 reward_funcs: Sequence[Callable], state, ref_params,
                 max_prompt_length: int = 512,
                 max_completion_length: int = 128,
                 sampling_overrides: dict | None = None, schedule=None,
                 missing_eos_penalty: float | None = None, device=None,
                 seed: int = 0):
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.reward_funcs = list(reward_funcs)
        self.state = state
        self.ref_params = ref_params
        self.max_prompt_length = max_prompt_length
        self.max_completion_length = max_completion_length
        self.missing_eos_penalty = missing_eos_penalty
        self.device = resolve_device(device)
        self.seed = seed
        sampling_kw = dict(
            max_new_tokens=max_completion_length,
            # TRL's OnlineDPOConfig defaults: temperature 0.9, no truncation
            temperature=0.9, top_p=1.0, top_k=0,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or tokenizer.eos_token_id,
        )
        sampling_kw.update(sampling_overrides or {})
        self.engine = RolloutEngine(
            bundle, SamplingConfig(**sampling_kw),
            max_len=max_prompt_length + max_completion_length,
            device=self.device)
        self.update_step = make_dpo_step(bundle_score_fn(bundle), optimizer,
                                         cfg, schedule)
        self._rollouts = 0
        self.metrics_history: list[dict] = []

    def _collate_prompts(self, examples):
        return collate_text_prompts(
            self.bundle, examples, self.max_prompt_length,
            self.tokenizer.pad_token_id or self.tokenizer.eos_token_id)

    def step(self, examples: Sequence[dict]) -> dict:
        """examples: [{"prompt_ids": [...], "solution": str, ...extras}]."""
        n = len(examples)
        rollout_batch = self._collate_prompts(examples)
        with record_function(ONLINE_DPO_ROLLOUT):
            policy = cast_dense_params(self.state.params,
                                       self.bundle.precision.compute_dtype)
            generator = sampling_generator(self.seed, self._rollouts,
                                           self.device)
            self._rollouts += 1
            rollout = self.engine.generate(
                policy, batch_to_device(rollout_batch, self.device),
                generator, group_size=2)
            del policy
        completion_ids = rollout["completion_ids"].cpu().numpy()   # [2n, N]
        completion_mask = rollout["completion_mask"].cpu().numpy()
        prompt_ids = rollout["prompt_ids"].cpu().numpy()
        prompt_mask = rollout["prompt_mask"].cpu().numpy()
        del rollout
        texts = self.tokenizer.batch_decode(
            [ids[m.astype(bool)]
             for ids, m in zip(completion_ids, completion_mask)],
            skip_special_tokens=True)
        completions = [[{"role": "assistant", "content": t}] for t in texts]
        reward_kwargs = {
            k: [ex.get(k) for ex in examples for _ in range(2)]
            for k in {k for ex in examples for k in ex if k != "prompt_ids"}
        }
        scores = np.zeros(2 * n)
        for fn in self.reward_funcs:
            scores += np.asarray(
                fn(completions=completions,
                   current_step=int(self.state.step), **reward_kwargs),
                np.float64)
        if self.missing_eos_penalty is not None:
            no_eos = completion_mask.sum(axis=1) >= completion_ids.shape[1]
            scores = scores - no_eos * self.missing_eos_penalty

        order = online_dpo_order(scores)
        update_batch = self._update_batch(
            prompt_ids[order], prompt_mask[order], completion_ids[order],
            completion_mask[order])
        self.state, metrics = self.update_step(
            self.state, self.ref_params, update_batch)
        pair = scores.reshape(n, 2)
        out = {k: float(v) for k, v in metrics.items()}
        out["objective/scores"] = float(scores.mean())
        out["objective/scores_margin"] = float(
            (pair.max(axis=1) - pair.min(axis=1)).mean())
        out["completion_length"] = float(
            completion_mask[order].sum(axis=1).mean())
        self.metrics_history.append(out)
        return out

    def _update_batch(self, prompt_ids, prompt_mask, comp_ids,
                      comp_mask) -> dict:
        """The DPO batch of the ordered rows (numpy): prompt + completion,
        the completion labeled, positions counted over the real tokens
        (broadcast to the three M-RoPE axes where the model has them)."""
        full_ids = np.concatenate([prompt_ids, comp_ids], axis=1)
        full_mask = np.concatenate([prompt_mask, comp_mask], axis=1)
        labeled = np.concatenate([np.zeros_like(prompt_mask), comp_mask],
                                 axis=1).astype(bool)
        labels = np.where(labeled, full_ids, IGNORE_INDEX)
        positions = np.clip(np.cumsum(full_mask, axis=1) - 1, 0, None)
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        if getattr(tcfg, "mrope_section", None) is not None:
            positions = np.broadcast_to(
                positions, (3,) + positions.shape).copy()
        return {"input_ids": full_ids, "labels": labels,
                "segment_ids": full_mask, "position_ids": positions}
