"""On-policy trainers beyond SC-GRPO: RLOO, online DPO, XPO and Nash-MD
(the port's own copy of iadr1_tpu/train/online_rl.py).

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
* XPO (TRL's xpo_trainer): one completion from the policy and one from
  the reference a prompt, the higher score chosen (ties to the policy);
  DPO on the pair's log-ratios plus alpha times the policy's logps on the
  reference's completion (the exploration term).
* Nash-MD (TRL's nash_md_trainer): the policy's completion against one
  from the geometric mixture of policy and reference
  (``RolloutEngine.generate_mixture``), judged by the rewards (p = 1, 0,
  or 1/2 on a tie); loss beta * sum(stopgrad(log ratio) * logp)
  - (p - 1/2) * sum(logp).

The XPO and Nash-MD update steps are plain functions as the DPO step is
(``train/preference.py``): the reference is scored under
``torch.no_grad()`` before the policy's forward.

On a mesh (``core/mesh.py``) every trainer takes its share of the step's
prompts by whole prompts (``host_batch_slice``; RLOO's groups come with
them, as GRPO's do), rolls them out on this rank's copy of the policy and
the reference (``train/rollout.py rollout_copy``: gathered whole at tp =
1, the tp slice at tp > 1), pairs and scores them per prompt, and updates
the sharded state with the whole batch's means; the logged statistics
gather every rank's rows (``gather_host_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.distributed import host_batch_slice
from iadr1_tpu_torch.core.mesh import (
    batch_mean,
    compute_view,
    full,
    gather_host_rows,
    kernel_mesh,
    mesh_scope,
)
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.train.grpo import (
    GRPOTrainer,
    bundle_score_fn,
    chunked_token_logps,
    collate_text_prompts,
    sampling_generator,
)
from iadr1_tpu_torch.train.preference import (
    PREF_RANGES,
    DPOConfig,
    _on_params_device,
    apply_update,
    make_dpo_step,
)
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    mesh_tp,
    rollout_copy,
)
from iadr1_tpu_torch.train.sft import batch_to_device
from iadr1_tpu_torch.train.state import tree_leaves

# profiler range names of an online DPO step's rollout and of the XPO and
# Nash-MD steps' rollouts
ONLINE_DPO_ROLLOUT = "online_dpo_rollout"
PAIRED_ROLLOUT = "paired_rollout"


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
        if not self.normalize_advantages:     # per group: whole groups here
            return rloo_advantages(rewards, self.cfg.num_generations)
        # whitened over the whole batch: every rank's rewards, then its rows
        adv = rloo_advantages(gather_host_rows(rewards),
                              self.cfg.num_generations, True)
        return adv[host_batch_slice(len(adv))]


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
        # tp > 1: the rollouts decode tensor-parallel
        self._tp = mesh_tp()
        self._rollouts = 0
        self.metrics_history: list[dict] = []

    def _collate_prompts(self, examples):
        return collate_text_prompts(
            self.bundle, examples, self.max_prompt_length,
            self.tokenizer.pad_token_id or self.tokenizer.eos_token_id)

    def _share(self, examples: Sequence[dict]) -> list:
        """This rank's share of the step's examples (all of them off a
        mesh)."""
        return list(examples)[host_batch_slice(len(examples))]

    def _tp_kw(self) -> dict:
        return {} if self._tp is None else {"tp": self._tp}

    def step(self, examples: Sequence[dict]) -> dict:
        """examples: [{"prompt_ids": [...], "solution": str, ...extras}].
        On a mesh every rank passes the whole list and takes its share;
        the metrics cover the whole list."""
        examples = self._share(examples)
        rollout_batch = self._collate_prompts(examples)
        with record_function(ONLINE_DPO_ROLLOUT):
            policy = rollout_copy(self.bundle, self.state.params, self._tp)
            generator = sampling_generator(self.seed, self._rollouts,
                                           self.device)
            self._rollouts += 1
            rollout = self.engine.generate(
                policy, batch_to_device(rollout_batch, self.device),
                generator, group_size=2, **self._tp_kw())
            del policy
        rollout = {k: rollout[k].cpu().numpy() for k in (
            "prompt_ids", "prompt_mask", "completion_ids", "completion_mask")}
        completion_ids = rollout["completion_ids"]              # [2n, N]
        completion_mask = rollout["completion_mask"]
        scores = self._score(rollout, examples, reps=2)
        if self.missing_eos_penalty is not None:
            no_eos = completion_mask.sum(axis=1) >= completion_ids.shape[1]
            scores = scores - no_eos * self.missing_eos_penalty

        order = online_dpo_order(scores)
        update_batch = completion_batch(
            self.bundle, *(rollout[k][order] for k in (
                "prompt_ids", "prompt_mask", "completion_ids",
                "completion_mask")))
        self.state, metrics = self.update_step(
            self.state, self.ref_params, update_batch)
        pair = gather_host_rows(scores).reshape(-1, 2)
        out = {k: float(v) for k, v in metrics.items()}
        out["objective/scores"] = float(pair.mean())
        out["objective/scores_margin"] = float(
            (pair.max(axis=1) - pair.min(axis=1)).mean())
        out["completion_length"] = float(gather_host_rows(
            completion_mask[order].sum(axis=1)).mean())
        self.metrics_history.append(out)
        return out

    def _score(self, rollout, examples, reps: int = 1) -> np.ndarray:
        """The summed rewards of the rollout's completions (numpy), each
        example's columns repeated ``reps`` times consecutively."""
        texts = self.tokenizer.batch_decode(
            [ids[m.astype(bool)] for ids, m in zip(
                rollout["completion_ids"], rollout["completion_mask"])],
            skip_special_tokens=True)
        completions = [[{"role": "assistant", "content": t}] for t in texts]
        kwargs = {k: [ex.get(k) for ex in examples for _ in range(reps)]
                  for k in {k for ex in examples for k in ex
                            if k != "prompt_ids"}}
        scores = np.zeros(len(completions))
        for fn in self.reward_funcs:
            scores += np.asarray(
                fn(completions=completions,
                   current_step=int(self.state.step), **kwargs), np.float64)
        return scores


def completion_batch(bundle, prompt_ids, prompt_mask, comp_ids,
                     comp_mask) -> dict:
    """The update batch of prompt + completion rows (numpy): the
    completion labeled, positions counted over the real tokens (broadcast
    to the three M-RoPE axes where the model has them)."""
    full_ids = np.concatenate([prompt_ids, comp_ids], axis=1)
    full_mask = np.concatenate([prompt_mask, comp_mask], axis=1)
    labeled = np.concatenate([np.zeros_like(prompt_mask), comp_mask],
                             axis=1).astype(bool)
    labels = np.where(labeled, full_ids, IGNORE_INDEX)
    positions = np.clip(np.cumsum(full_mask, axis=1) - 1, 0, None)
    tcfg = getattr(bundle.cfg, "text", bundle.cfg)
    if getattr(tcfg, "mrope_section", None) is not None:
        positions = np.broadcast_to(positions, (3,) + positions.shape).copy()
    return {"input_ids": full_ids, "labels": labels,
            "segment_ids": full_mask, "position_ids": positions}


# ---------------------------------------------------------------------------
# XPO and Nash-MD
# ---------------------------------------------------------------------------


def _completion_token_logps(score_fn, params, batch, chunk_size):
    """(token logps [B, T-1], mask) on the labeled (completion) positions,
    the logps 0 elsewhere."""
    hidden, kernel = score_fn(params, batch)
    targets = batch["labels"][:, 1:]
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets != IGNORE_INDEX, targets, 0)
    # under tp the logps are DTensors: the losses take them whole
    tok = full(chunked_token_logps(hidden[:, :-1], kernel, safe, chunk_size))
    return tok * mask, mask


@dataclasses.dataclass(frozen=True)
class XPOConfig:
    beta: float = 0.1
    alpha: float = 1e-5            # the exploration coefficient
    loss_type: str = "sigmoid"     # sigmoid | ipo
    logp_chunk_size: int = 1024


def make_xpo_update_step(score_fn, optimizer, cfg: XPOConfig,
                         schedule=None):
    """``step(state, ref_params, batch) -> (state, metrics)``.

    batch rows: the first n the policy's completions, the last n the
    reference's (prompt + completion, the completion labeled);
    ``chosen_mask`` [n] bool, True where the policy's completion won.
    Loss (TRL's xpo_trainer): DPO on the (chosen, rejected) log-ratios
    plus alpha * the policy's logps on the reference's completions."""
    if cfg.loss_type not in ("sigmoid", "ipo"):
        raise ValueError(f"invalid XPO loss type {cfg.loss_type!r}")

    def seq_logps(params, batch):
        tok, _ = _completion_token_logps(score_fn, params, batch,
                                         cfg.logp_chunk_size)
        return tok.sum(dim=1)

    def step(state, ref_params, batch):
        batch = _on_params_device(state, batch)
        cm = batch["chosen_mask"].bool()
        with mesh_scope():
            with record_function(PREF_RANGES[0]), torch.no_grad():
                ref_sum = seq_logps(compute_view(ref_params), batch)
            with record_function(PREF_RANGES[1]):
                pol_sum = seq_logps(compute_view(state.params), batch)
                n = pol_sum.shape[0] // 2
                pol_m, pol_r = pol_sum[:n], pol_sum[n:]
                ref_m, ref_r = ref_sum[:n], ref_sum[n:]
                chosen = torch.where(cm, pol_m - ref_m, pol_r - ref_r)
                rejected = torch.where(cm, pol_r - ref_r, pol_m - ref_m)
                logits = chosen - rejected
                if cfg.loss_type == "sigmoid":
                    dpo = -F.logsigmoid(cfg.beta * logits)
                else:
                    dpo = (logits - 1.0 / (2.0 * cfg.beta)) ** 2
                xpo = cfg.alpha * pol_r
                loss = batch_mean(dpo + xpo)
                metrics = {"loss": loss, "loss/dpo": batch_mean(dpo),
                           "loss/xpo": batch_mean(xpo),
                           "rewards/chosen": batch_mean(cfg.beta * chosen),
                           "rewards/rejected": batch_mean(
                               cfg.beta * rejected)}
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


@dataclasses.dataclass(frozen=True)
class NashMDConfig:
    beta: float = 0.1              # the KL coefficient
    mixture_coef: float = 0.5      # the mixture opponent's weight
    logp_chunk_size: int = 1024


def make_nash_md_update_step(score_fn, optimizer, cfg: NashMDConfig,
                             schedule=None):
    """``step(state, ref_params, batch) -> (state, metrics)``.

    batch: the policy's completions (labeled) and ``probability`` [B],
    P(the policy's completion beats the mixture's).  Loss (TRL's
    nash_md_trainer): beta * the REINFORCE KL - (p - 1/2) * sum logps."""

    def step(state, ref_params, batch):
        batch = _on_params_device(state, batch)
        prob = batch["probability"].float()
        with mesh_scope():
            with record_function(PREF_RANGES[0]), torch.no_grad():
                ref_tok, _ = _completion_token_logps(
                    score_fn, compute_view(ref_params), batch,
                    cfg.logp_chunk_size)
            with record_function(PREF_RANGES[1]):
                pol_tok, _ = _completion_token_logps(
                    score_fn, compute_view(state.params), batch,
                    cfg.logp_chunk_size)
                log_ratio = (pol_tok - ref_tok).detach()
                score = (prob - 0.5) * pol_tok.sum(dim=1)
                kl_loss = (log_ratio * pol_tok).sum(dim=1)
                loss = batch_mean(cfg.beta * kl_loss - score)
                metrics = {"loss": loss,
                           "objective/kl": batch_mean(log_ratio.sum(dim=1)),
                           "objective/score": batch_mean(score),
                           "objective/probability": batch_mean(prob)}
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


class _PairedOnlineTrainer(OnlineDPOTrainer):
    """XPO's and Nash-MD's host plumbing, over online DPO's (the prompt
    collation, the rewards' scores): the rollouts, each from its own
    generator stream, and the update rows."""

    def _rollout(self, batch, model=None, mixture_coef=None) -> dict:
        """The completions (numpy) of the policy, from its dense layers
        cast to the compute dtype, or of ``model`` as it is stored; with
        ``mixture_coef``, of the geometric mixture of the policy and
        ``model``.  Each rollout draws from its own generator stream.  On
        a mesh each is this rank's copy (``rollout_copy``)."""
        with record_function(PAIRED_ROLLOUT):
            generator = sampling_generator(self.seed, self._rollouts,
                                           self.device)
            self._rollouts += 1
            batch = batch_to_device(batch, self.device)
            if model is not None:
                model = self._stored_copy(model)
            if model is not None and mixture_coef is None:
                out = self.engine.generate(model, batch, generator,
                                           **self._tp_kw())
            else:
                policy = rollout_copy(self.bundle, self.state.params,
                                      self._tp)
                out = (self.engine.generate(policy, batch, generator,
                                            **self._tp_kw())
                       if model is None else self.engine.generate_mixture(
                           policy, model, mixture_coef, batch, generator,
                           **self._tp_kw()))
                del policy
            del model
        return {k: out[k].cpu().numpy() for k in (
            "prompt_ids", "prompt_mask", "completion_ids", "completion_mask")}

    def _stored_copy(self, model):
        """A model rolled out as it is stored: itself off a mesh, else this
        rank's copy in its own dtype."""
        if kernel_mesh() is None:
            return model
        dtype = next(t for t in tree_leaves(model)).dtype
        return rollout_copy(self.bundle, model, self._tp, dtype)

    def _rows(self, *rollouts) -> dict:
        """The update batch of the rollouts' rows, one after another."""
        return completion_batch(self.bundle, *(
            np.concatenate([r[k] for r in rollouts]) for k in (
                "prompt_ids", "prompt_mask", "completion_ids",
                "completion_mask")))


class XPOTrainer(_PairedOnlineTrainer):
    """TRL's XPOTrainer: a completion from the policy and one from the
    frozen reference a prompt; the rewards pick the winner (a tie goes to
    the policy); the DPO + exploration update (make_xpo_update_step).  The
    reference rolls out from its own copy, as it is stored."""

    def __init__(self, bundle, tokenizer, optimizer, cfg: XPOConfig,
                 reward_funcs, state, ref_params,
                 max_prompt_length: int = 512,
                 max_completion_length: int = 128,
                 sampling_overrides: dict | None = None, schedule=None,
                 device=None, seed: int = 0):
        super().__init__(bundle, tokenizer, optimizer,
                         DPOConfig(beta=cfg.beta), reward_funcs, state,
                         ref_params, max_prompt_length, max_completion_length,
                         sampling_overrides, schedule, device=device,
                         seed=seed)
        self.cfg = cfg
        self.update_step = make_xpo_update_step(bundle_score_fn(bundle),
                                                optimizer, cfg, schedule)

    def step(self, examples: Sequence[dict]) -> dict:
        examples = self._share(examples)
        batch = self._collate_prompts(examples)
        model_data = self._rollout(batch)
        ref_data = self._rollout(batch, self.ref_params)
        scores_m = self._score(model_data, examples)
        scores_r = self._score(ref_data, examples)
        update_batch = self._rows(model_data, ref_data)
        update_batch["chosen_mask"] = scores_m >= scores_r
        self.state, metrics = self.update_step(self.state, self.ref_params,
                                               update_batch)
        out = {k: float(v) for k, v in metrics.items()}
        out["objective/model_scores"] = float(gather_host_rows(
            scores_m).mean())
        out["objective/ref_scores"] = float(gather_host_rows(scores_r).mean())
        self.metrics_history.append(out)
        return out


class NashMDTrainer(_PairedOnlineTrainer):
    """TRL's NashMDTrainer: the opponent's completion is sampled from the
    geometric mixture of the policy and the reference
    (``RolloutEngine.generate_mixture``, each with its own KV cache); the
    rewards judge the pair (probability the policy wins: 1, 0, 1/2 on a
    tie)."""

    def __init__(self, bundle, tokenizer, optimizer, cfg: NashMDConfig,
                 reward_funcs, state, ref_params,
                 max_prompt_length: int = 512,
                 max_completion_length: int = 128,
                 sampling_overrides: dict | None = None, schedule=None,
                 device=None, seed: int = 0):
        super().__init__(bundle, tokenizer, optimizer,
                         DPOConfig(beta=cfg.beta), reward_funcs, state,
                         ref_params, max_prompt_length, max_completion_length,
                         sampling_overrides, schedule, device=device,
                         seed=seed)
        self.cfg = cfg
        self.update_step = make_nash_md_update_step(
            bundle_score_fn(bundle), optimizer, cfg, schedule)

    def step(self, examples: Sequence[dict]) -> dict:
        examples = self._share(examples)
        batch = self._collate_prompts(examples)
        model_data = self._rollout(batch)
        mixture_data = self._rollout(batch, self.ref_params,
                                     self.cfg.mixture_coef)
        scores_m = self._score(model_data, examples)
        scores_x = self._score(mixture_data, examples)
        update_batch = self._rows(model_data)
        update_batch["probability"] = np.where(
            scores_m > scores_x, 1.0,
            np.where(scores_m < scores_x, 0.0, 0.5)).astype(np.float32)
        self.state, metrics = self.update_step(self.state, self.ref_params,
                                               update_batch)
        out = {k: float(v) for k, v in metrics.items()}
        out["objective/model_scores"] = float(gather_host_rows(
            scores_m).mean())
        out["objective/mixture_scores"] = float(gather_host_rows(
            scores_x).mean())
        self.metrics_history.append(out)
        return out
