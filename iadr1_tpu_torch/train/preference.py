"""Preference-learning stages (the port's own copy of
iadr1_tpu/train/preference.py): DPO (+ hinge/IPO/ORPO/SimPO/CPO), KTO,
BCO, the process reward model and the pairwise reward model.

Behavior matches the reference's vendored LLaMA-Factory and TRL trainers:

* DPO: chosen and rejected run as one concatenated batch of 2B rows;
  sequence logps are sums (means for IPO/ORPO/SimPO); the preference
  losses follow TRL's dpo_loss (sigmoid with label smoothing, hinge, ipo)
  plus LLaMA-Factory's odds-ratio and SimPO losses; ``ftx`` mixes in the
  chosen side's SFT loss.
* KTO: per-example desirable/undesirable tags; the KL baseline is the
  batch mean of the policy/reference gap on mismatched prompt/completion
  rows (``kl_*`` keys of the batch, built by the CLI).
* BCO: -logsigmoid(+-(beta * (pol - ref) - delta)), delta the running
  mean of the implicit rewards kept on the host (``RunningMoments``).
* PRM: token classification at each step's separator token.
* RM: a scalar value head read at each row's last real token,
  -logsigmoid(chosen - rejected).

Every step is a plain function ``step(state, ...) -> (state, metrics)``
over tensors, as ``make_grpo_update_step`` is: the batch moves to the
parameters' device, the state is updated in place, the frozen reference
is scored under ``torch.no_grad()`` before the policy's forward, and the
metrics (0-d tensors) add ``grad_norm`` (before clipping) to the JAX
step's.  All logp scoring is chunked over the LM head, so no [B, T, V]
logits are formed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from iadr1_tpu_torch.core.mesh import (
    batch_mean,
    compute_view,
    full,
    mesh_scope,
)
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.train.grpo import (
    _update_batch_to_device,
    chunked_token_logps,
)
from iadr1_tpu_torch.train.optimizers import global_norm
from iadr1_tpu_torch.train.sft import mesh_metrics
from iadr1_tpu_torch.train.state import tree_leaves

# profiler range names of a preference step's phases
PREF_RANGES = ("pref_reference", "pref_forward", "pref_optimizer")


def sequence_logps(hidden, head_kernel, labels, chunk_size: int = 1024):
    """(sum_logps [B], valid_len [B]) of the labeled tokens.

    hidden [B, T, H]; labels [B, T] with IGNORE_INDEX on prompt and pad
    positions; next-token alignment (labels[t] is predicted from
    hidden[t - 1])."""
    pred = hidden[:, :-1]
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, 0)
    token_logps = chunked_token_logps(pred, head_kernel, safe, chunk_size)
    seq = torch.where(mask, token_logps, 0.0).sum(dim=1)
    return seq, mask.sum(dim=1).clamp(min=1)


def apply_update(state, optimizer, loss, metrics, schedule):
    """Gradients of ``loss`` over the state's parameters, their norm
    (added to the metrics, which are detached; on a mesh summed over the
    batch ranks' shares) and the in-place update."""
    leaves = tree_leaves(state.params)
    with mesh_scope():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with record_function(PREF_RANGES[2]):
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = mesh_metrics(metrics)
        metrics["grad_norm"] = global_norm(grads)
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(schedule(state.step))
        new_state = state.apply_gradients(grads, optimizer,
                                          metrics["grad_norm"])
    return new_state, metrics


def _on_params_device(state, batch):
    return _update_batch_to_device(
        batch, tree_leaves(state.params)[0].device)


# ---------------------------------------------------------------------------
# DPO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1                 # pref_beta
    # sigmoid | hinge | ipo | orpo | simpo | cpo
    # cpo = reference-free sigmoid + ftx * NLL on chosen (TRL's
    # cpo_alpha -> ftx)
    loss_type: str = "sigmoid"
    label_smoothing: float = 0.0      # dpo_label_smoothing
    simpo_gamma: float = 0.5
    ftx: float = 0.0                  # SFT-loss mixing weight (pref_ftx)
    logp_chunk_size: int = 1024

    @property
    def average_logps(self) -> bool:
        # IPO/ORPO/SimPO use length-averaged logps
        return self.loss_type in ("ipo", "orpo", "simpo")

    @property
    def use_ref_model(self) -> bool:
        return self.loss_type in ("sigmoid", "hinge", "ipo")


def _sigmoid_loss(logits, beta, label_smoothing):
    return (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
            - F.logsigmoid(-beta * logits) * label_smoothing)


def preference_loss(cfg: DPOConfig, pol_c, pol_r, ref_c=None, ref_r=None):
    """Per-pair preference losses (LLaMA-Factory's compute_preference_loss
    and TRL's dpo_loss variants)."""
    if cfg.loss_type == "orpo":
        log_odds = (pol_c - pol_r) - (
            torch.log1p(-torch.exp(pol_c)) - torch.log1p(-torch.exp(pol_r)))
        return -pol_c + cfg.beta * (-F.logsigmoid(log_odds))
    if cfg.loss_type == "simpo":
        logits = (pol_c - pol_r) - cfg.simpo_gamma / cfg.beta
        return -F.logsigmoid(cfg.beta * logits)
    if cfg.loss_type == "cpo":
        # reference-free (the beta -> 0 limit of the reference's weight)
        return _sigmoid_loss(pol_c - pol_r, cfg.beta, cfg.label_smoothing)

    logits = (pol_c - pol_r) - (ref_c - ref_r)
    if cfg.loss_type == "sigmoid":
        return _sigmoid_loss(logits, cfg.beta, cfg.label_smoothing)
    if cfg.loss_type == "hinge":
        return torch.relu(1.0 - cfg.beta * logits)
    if cfg.loss_type == "ipo":
        return (logits - 1.0 / (2.0 * cfg.beta)) ** 2
    raise ValueError(f"unknown DPO loss type {cfg.loss_type!r}")


def make_dpo_step(score_fn, optimizer, cfg: DPOConfig, schedule=None):
    """``step(state, ref_params, batch) -> (state, metrics)``.

    batch: input_ids/labels/segment_ids/position_ids, all [2B, T], the
    first B rows chosen and the last B rejected (LLaMA-Factory's
    concatenated_forward).  ``score_fn(params, batch) -> (hidden,
    head_kernel)`` as ``train.grpo.bundle_score_fn``.  The reference-free
    losses (orpo, simpo, cpo) never read ``ref_params``."""
    if cfg.loss_type not in ("sigmoid", "hinge", "ipo", "orpo", "simpo",
                             "cpo"):
        raise ValueError(f"unknown DPO loss type {cfg.loss_type!r}")

    def seq_logps(params, batch):
        hidden, kernel = score_fn(params, batch)
        seq, n = sequence_logps(hidden, kernel, batch["labels"],
                                cfg.logp_chunk_size)
        # under tp the row sums are DTensors: the loss takes them whole
        seq, n = full(seq), full(n)
        return (seq / n if cfg.average_logps else seq), seq, n

    def step(state, ref_params, batch):
        batch = _on_params_device(state, batch)
        B = batch["input_ids"].shape[0] // 2
        ref_c = ref_r = None
        with mesh_scope():
            if cfg.use_ref_model:
                with record_function(PREF_RANGES[0]), torch.no_grad():
                    ref_logps, _, _ = seq_logps(compute_view(ref_params),
                                                batch)
                ref_c, ref_r = ref_logps[:B], ref_logps[B:]
            with record_function(PREF_RANGES[1]):
                logps, seq_sum, n = seq_logps(compute_view(state.params),
                                              batch)
                pol_c, pol_r = logps[:B], logps[B:]
                losses = preference_loss(cfg, pol_c, pol_r, ref_c, ref_r)
                if cfg.ftx > 1e-6:
                    # the chosen side's SFT loss mixed in
                    losses = losses + cfg.ftx * (-(seq_sum[:B] / n[:B]))
                loss = batch_mean(losses)
                with torch.no_grad():
                    chosen = cfg.beta * (pol_c - (0.0 if ref_c is None
                                                  else ref_c))
                    rejected = cfg.beta * (pol_r - (0.0 if ref_r is None
                                                    else ref_r))
                    metrics = {
                        "loss": loss,
                        "rewards/chosen": batch_mean(chosen),
                        "rewards/rejected": batch_mean(rejected),
                        "rewards/accuracies": batch_mean(
                            (chosen > rejected).float()),
                        "rewards/margins": batch_mean(chosen - rejected),
                    }
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


# ---------------------------------------------------------------------------
# KTO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KTOConfig:
    beta: float = 0.1
    desirable_weight: float = 1.0
    undesirable_weight: float = 1.0
    logp_chunk_size: int = 1024


def _sub_batch(batch, prefix):
    return {"input_ids": batch[f"{prefix}input_ids"],
            "labels": batch[f"{prefix}labels"],
            "segment_ids": batch.get(f"{prefix}segment_ids"),
            "position_ids": batch[f"{prefix}position_ids"]}


def make_kto_step(score_fn, optimizer, cfg: KTOConfig, schedule=None):
    """``step(state, ref_params, batch) -> (state, metrics)``.

    batch: the target rows (input_ids/labels/segment_ids/position_ids),
    the mismatched KL rows (the same keys prefixed ``kl_``) and ``tags``
    [B] (1 = desirable).  The KL baseline, the batch-mean policy/reference
    gap on the KL rows clipped at 0, takes no gradient (as in JAX and
    TRL), so the policy scores the KL rows without a graph."""

    def seq_logps(params, batch):
        hidden, kernel = score_fn(params, batch)
        return sequence_logps(hidden, kernel, batch["labels"],
                              cfg.logp_chunk_size)[0]

    def step(state, ref_params, batch):
        batch = _on_params_device(state, batch)
        target, kl_rows = _sub_batch(batch, ""), _sub_batch(batch, "kl_")
        tags = batch["tags"].float()
        with record_function(PREF_RANGES[0]), torch.no_grad():
            ref = seq_logps(ref_params, target)
            ref_kl = seq_logps(ref_params, kl_rows)
            pol_kl = seq_logps(state.params, kl_rows)
            kl = (pol_kl - ref_kl).mean().clamp(min=0.0)
        with record_function(PREF_RANGES[1]):
            pol = seq_logps(state.params, target)
            ratio = pol - ref
            chosen_losses = 1.0 - torch.sigmoid(cfg.beta * (ratio - kl))
            rejected_losses = 1.0 - torch.sigmoid(cfg.beta * (kl - ratio))
            losses = (cfg.desirable_weight * tags * chosen_losses
                      + cfg.undesirable_weight * (1.0 - tags)
                      * rejected_losses)
            loss = losses.mean()
            with torch.no_grad():
                rewards = cfg.beta * ratio
                n_des = tags.sum().clamp(min=1.0)
                n_und = (1 - tags).sum().clamp(min=1.0)
                metrics = {
                    "loss": loss, "kl": kl,
                    "rewards/chosen": (rewards * tags).sum() / n_des,
                    "rewards/rejected": (rewards * (1 - tags)).sum() / n_und,
                }
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


# ---------------------------------------------------------------------------
# BCO (binary classifier optimization)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BCOConfig:
    beta: float = 0.1
    logp_chunk_size: int = 1024


class RunningMoments:
    """Host-side running mean of the implicit rewards (BCO's reward shift
    delta; TRL's RunningMoments).  Welford over batch aggregates, so a
    resumed stream stays exact."""

    def __init__(self):
        self.mean = 0.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, batch_mean: float, batch_var: float,
               batch_count: float) -> float:
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_sum = batch_var * batch_count
        old_sum = (self.var * self.count
                   + delta ** 2 * self.count * batch_count / tot)
        self.mean += delta * batch_count / tot
        self.var = (old_sum + new_sum) / tot
        self.count = tot
        return self.mean

    def state_dict(self) -> dict:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, d: dict):
        self.mean, self.var, self.count = d["mean"], d["var"], d["count"]


def make_bco_step(score_fn, optimizer, cfg: BCOConfig, schedule=None):
    """``step(state, ref_params, batch, delta) -> (state, metrics)``.

    batch: the target rows + ``tags`` [B] (1 = desirable); ``delta`` the
    running mean of the implicit rewards (a float), kept on the host by
    ``RunningMoments`` from the metrics' reward_mean, reward_var (the
    population variance) and reward_count."""

    def seq_logps(params, batch):
        hidden, kernel = score_fn(params, batch)
        return sequence_logps(hidden, kernel, batch["labels"],
                              cfg.logp_chunk_size)[0]

    def step(state, ref_params, batch, delta):
        batch = _on_params_device(state, batch)
        tags = batch["tags"].float()
        delta = torch.as_tensor(delta, dtype=torch.float32,
                                device=tags.device)
        with record_function(PREF_RANGES[0]), torch.no_grad():
            ref = seq_logps(ref_params, batch)
        with record_function(PREF_RANGES[1]):
            pol = seq_logps(state.params, batch)
            rewards = cfg.beta * (pol - ref)
            chosen_losses = -F.logsigmoid(rewards - delta)
            rejected_losses = -F.logsigmoid(-(rewards - delta))
            loss = (tags * chosen_losses
                    + (1.0 - tags) * rejected_losses).mean()
            with torch.no_grad():
                r = rewards.detach()
                n_des = tags.sum().clamp(min=1.0)
                n_und = (1 - tags).sum().clamp(min=1.0)
                metrics = {
                    "loss": loss, "delta": delta,
                    "rewards/chosen": (r * tags).sum() / n_des,
                    "rewards/rejected": (r * (1 - tags)).sum() / n_und,
                    "reward_mean": r.mean(),
                    "reward_var": r.var(unbiased=False),
                    "reward_count": torch.tensor(float(r.shape[0])),
                }
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


# ---------------------------------------------------------------------------
# PRM (process reward model)
# ---------------------------------------------------------------------------


def encode_prm_example(prompt_ids: list[int], completions_ids: list[list[int]],
                       step_labels: list[bool], separator_ids: list[int],
                       train_on_last_step_only: bool = False):
    """(input_ids, labels): per-step binary labels at each step's final
    (separator) token, IGNORE_INDEX elsewhere (TRL's PRMTrainer
    tokenize_row)."""
    labels = [int(x) for x in step_labels]
    if train_on_last_step_only:
        labels = [IGNORE_INDEX] * (len(labels) - 1) + [labels[-1]]
    ids = list(prompt_ids)
    lab = [IGNORE_INDEX] * len(prompt_ids)
    for completion, label in zip(completions_ids, labels):
        step = list(completion) + list(separator_ids)
        ids += step
        lab += [IGNORE_INDEX] * (len(step) - 1) + [label]
    return ids, lab


def init_prm_head(generator: torch.Generator, hidden_size: int,
                  num_labels: int = 2, dtype=torch.float32) -> dict:
    """Normal(0, 0.01) kernel [hidden, num_labels], zero bias, on the
    generator's device."""
    device = generator.device
    return {
        "kernel": torch.randn((hidden_size, num_labels), generator=generator,
                              dtype=dtype, device=device) * 0.01,
        "bias": torch.zeros((num_labels,), dtype=dtype, device=device),
    }


def make_prm_step(hidden_fn, optimizer, schedule=None):
    """``step(state, batch) -> (state, metrics)``: token classification
    over the step-separator positions (TRL's PRMTrainer, CE on the labeled
    positions).  state.params = {"model": ..., "prm_head":
    init_prm_head(...)}; batch labels [B, T] hold 0/1 at each step's last
    token and IGNORE_INDEX elsewhere."""

    def step(state, batch):
        batch = _on_params_device(state, batch)
        labels = batch["labels"]
        mask = labels != IGNORE_INDEX
        safe = torch.where(mask, labels, 0)
        params = state.params
        with record_function(PREF_RANGES[1]):
            hidden = hidden_fn(params["model"], batch)
            head = params["prm_head"]
            logits = hidden.float() @ head["kernel"] + head["bias"]
            logp = torch.log_softmax(logits, dim=-1)
            tok = logp.gather(-1, safe[..., None].long())[..., 0]
            n = mask.sum().clamp(min=1)
            loss = -(torch.where(mask, tok, 0.0).sum() / n)
            with torch.no_grad():
                acc = (mask & (logits.argmax(-1) == safe)).sum() / n
                metrics = {"loss": loss, "accuracy": acc,
                           "n_label_tokens": n}
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step


# ---------------------------------------------------------------------------
# pairwise reward model
# ---------------------------------------------------------------------------


def init_value_head(generator: torch.Generator, hidden_size: int,
                    dtype=torch.float32) -> dict:
    """Scalar value head (TRL's AutoModelForCausalLMWithValueHead
    analogue): Normal(0, 0.01) kernel [hidden, 1], zero bias, on the
    generator's device."""
    return init_prm_head(generator, hidden_size, 1, dtype)


def make_rm_step(hidden_fn, optimizer, schedule=None):
    """``step(state, batch) -> (state, metrics)``.

    state.params = {"model": <bundle params>, "value_head": {...}};
    batch rows: chosen first half, rejected second half.  The score is the
    value at each row's last real token and the loss
    -logsigmoid(chosen - rejected)."""

    def step(state, batch):
        batch = _on_params_device(state, batch)
        B = batch["input_ids"].shape[0] // 2
        params = state.params
        with record_function(PREF_RANGES[1]):
            hidden = hidden_fn(params["model"], batch)
            vh = params["value_head"]
            values = (hidden.float() @ vh["kernel"].float())[..., 0] \
                + vh["bias"][0]
            mask = batch["segment_ids"] != 0
            last = (mask.sum(dim=1) - 1).clamp(min=0)
            scores = values.gather(1, last[:, None].long())[:, 0]
            chosen, rejected = scores[:B], scores[B:]
            loss = -F.logsigmoid(chosen - rejected).mean()
            with torch.no_grad():
                metrics = {"loss": loss,
                           "accuracy": (chosen > rejected).float().mean(),
                           "chosen_score": chosen.mean(),
                           "rejected_score": rejected.mean()}
        return apply_update(state, optimizer, loss, metrics, schedule)

    return step
