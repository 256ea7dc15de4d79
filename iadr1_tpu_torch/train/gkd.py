"""GKD: generalized knowledge distillation, the on-policy JSD to a teacher
(the port's own copy of iadr1_tpu/train/gkd.py; TRL's GKDTrainer).

The student minimizes the generalized Jensen-Shannon divergence to a
frozen teacher on the completion tokens.  With probability ``lmbda`` a
step's completions are sampled on-policy from the student, else they are
the dataset's; the draw comes from a host ``np.random.default_rng(seed)``,
as in JAX.

The JSD never forms two [B, T, V] logits tensors: as the chunked CE loss
(``train/sft.py``), the student's and the teacher's logits are formed a
chunk of tokens at a time under a checkpoint, so that peak memory is two
[chunk, V] blocks.  The teacher's forward runs under ``torch.no_grad()``
before the student's.

On a mesh (``core/mesh.py``) the teacher is sharded as the student is;
every rank draws the same on-policy choice, takes its share of the step's
examples, rolls out (on-policy) on its copy of the student
(``train/rollout.py rollout_copy``) and averages the JSD over the whole
batch's completion tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.distributed import host_batch_slice
from iadr1_tpu_torch.core.mesh import batch_total, compute_view, mesh_scope
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.train.grpo import (
    bundle_score_fn,
    collate_text_prompts,
    sampling_generator,
)
from iadr1_tpu_torch.train.online_rl import completion_batch
from iadr1_tpu_torch.train.preference import _on_params_device, apply_update
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    mesh_tp,
    rollout_copy,
)
from iadr1_tpu_torch.train.sft import batch_to_device

# profiler range names of a GKD step's phases
GKD_RANGES = ("gkd_rollout", "gkd_teacher", "gkd_forward")


@dataclasses.dataclass(frozen=True)
class GKDConfig:
    beta: float = 0.5          # the JSD's interpolant (TRL's default)
    temperature: float = 0.9
    lmbda: float = 0.5         # the on-policy share of steps
    max_prompt_length: int = 512
    max_completion_length: int = 128
    logit_chunk_size: int = 512


def _token_jsd(s_logits, t_logits, beta: float):
    """Per-token generalized JSD over [n, V] logits (nats), TRL's
    generalized_jsd_loss: beta 0 is KL(teacher || student), beta 1
    KL(student || teacher)."""
    s_logp = torch.log_softmax(s_logits, dim=-1)
    t_logp = torch.log_softmax(t_logits, dim=-1)
    if beta == 0.0:
        return (t_logp.exp() * (t_logp - s_logp)).sum(dim=-1)
    if beta == 1.0:
        return (s_logp.exp() * (s_logp - t_logp)).sum(dim=-1)
    m_logp = torch.logaddexp(s_logp + math.log1p(-beta),
                             t_logp + math.log(beta))
    kl_t = (t_logp.exp() * (t_logp - m_logp)).sum(dim=-1)
    kl_s = (s_logp.exp() * (s_logp - m_logp)).sum(dim=-1)
    return beta * kl_t + (1.0 - beta) * kl_s


def _head(h, kernel):
    # the JAX product's promotion (a bf16 hidden with an f32 kernel is an
    # f32 product), then f32 logits
    dtype = torch.promote_types(h.dtype, kernel.dtype)
    return torch.matmul(h.to(dtype), kernel.to(dtype)).float()


def _chunk_jsd(s, t, s_kernel, t_kernel, m, beta, temperature):
    s_logits = _head(s, s_kernel) / temperature
    t_logits = _head(t, t_kernel) / temperature
    return (_token_jsd(s_logits, t_logits, beta) * m).sum()


def chunked_jsd_loss(student_hidden, teacher_hidden, student_kernel,
                     teacher_kernel, labels, *, beta: float,
                     temperature: float, chunk_size: int):
    """(masked mean JSD, label count) between the student's and the
    teacher's next-token distributions, a chunk of tokens at a time; on a
    mesh the mean is over the whole batch's labels (this rank's share of
    it) and the count this rank's.

    hidden [B, T, H]; labels [B, T] with IGNORE_INDEX outside the
    completion tokens (next-token alignment: hidden[t] predicts
    labels[t + 1])."""
    H = student_hidden.shape[-1]
    s_pred = student_hidden[:, :-1].reshape(-1, H)
    t_pred = teacher_hidden[:, :-1].reshape(-1, teacher_hidden.shape[-1])
    mask = (labels[:, 1:] != IGNORE_INDEX).reshape(-1).float()
    total = torch.zeros((), dtype=torch.float32, device=s_pred.device)
    for c0 in range(0, s_pred.shape[0], chunk_size):
        c = slice(c0, c0 + chunk_size)
        total = total + ckpt(_chunk_jsd, s_pred[c], t_pred[c],
                             student_kernel, teacher_kernel, mask[c], beta,
                             temperature)
    count = mask.sum()
    return total / batch_total(count).clamp(min=1.0), count


def make_gkd_step(score_fn, teacher_score_fn, optimizer, cfg: GKDConfig,
                  schedule=None):
    """``step(state, teacher_params, batch) -> (state, metrics)``.

    ``score_fn(params, batch) -> (hidden, head_kernel)`` as
    ``train.grpo.bundle_score_fn``; the teacher shares the batch layout
    and the vocabulary.  batch: input_ids/labels/segment_ids/position_ids.
    """

    def step(state, teacher_params, batch):
        batch = _on_params_device(state, batch)
        with mesh_scope():
            with record_function(GKD_RANGES[1]), torch.no_grad():
                t_hidden, t_kernel = teacher_score_fn(
                    compute_view(teacher_params), batch)
            with record_function(GKD_RANGES[2]):
                s_hidden, s_kernel = score_fn(compute_view(state.params),
                                              batch)
                loss, n = chunked_jsd_loss(
                    s_hidden, t_hidden, s_kernel, t_kernel, batch["labels"],
                    beta=cfg.beta, temperature=cfg.temperature,
                    chunk_size=cfg.logit_chunk_size)
        return apply_update(state, optimizer, loss,
                            {"loss": loss, "n_label_tokens": n}, schedule)

    return step


class GKDTrainer:
    """Host loop: with probability ``lmbda`` the student samples the
    step's completions (on-policy), else the dataset's are used; then the
    chunked-JSD update against the frozen teacher.  The student rolls out
    from a copy of its dense layers in the compute dtype; rollout k draws
    from a generator seeded by (``seed``, k)."""

    def __init__(self, bundle, teacher_bundle, tokenizer, optimizer,
                 cfg: GKDConfig, state, teacher_params, schedule=None,
                 sampling_overrides: dict | None = None, seed: int = 0,
                 device=None):
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.state = state
        self.teacher_params = teacher_params
        self.device = resolve_device(device)
        self.seed = seed
        sampling_kw = dict(
            max_new_tokens=cfg.max_completion_length,
            temperature=cfg.temperature, top_p=1.0, top_k=0,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id or tokenizer.eos_token_id)
        sampling_kw.update(sampling_overrides or {})
        self.engine = RolloutEngine(
            bundle, SamplingConfig(**sampling_kw),
            max_len=cfg.max_prompt_length + cfg.max_completion_length,
            device=self.device)
        self.update_step = make_gkd_step(
            bundle_score_fn(bundle), bundle_score_fn(teacher_bundle),
            optimizer, cfg, schedule)
        self._host_rng = np.random.default_rng(seed)
        # tp > 1: the rollout decodes tensor-parallel
        self._tp = mesh_tp()
        self._rollouts = 0
        self.metrics_history: list[dict] = []

    def step(self, examples: Sequence[dict]) -> dict:
        """examples: [{"prompt_ids": [...], "completion_ids": [...]}].
        On a mesh every rank passes the whole list (and so draws the same
        on-policy choice) and takes its share of it."""
        cfg = self.cfg
        pad = self.tokenizer.pad_token_id or self.tokenizer.eos_token_id
        on_policy = float(self._host_rng.random()) <= cfg.lmbda
        examples = list(examples)[host_batch_slice(len(examples))]
        prompt = collate_text_prompts(self.bundle, examples,
                                      cfg.max_prompt_length, pad)
        prompt_ids, prompt_mask = prompt["input_ids"], prompt["attention_mask"]
        if on_policy:
            with record_function(GKD_RANGES[0]):
                policy = rollout_copy(self.bundle, self.state.params,
                                      self._tp)
                generator = sampling_generator(self.seed, self._rollouts,
                                               self.device)
                self._rollouts += 1
                kw = {} if self._tp is None else {"tp": self._tp}
                rollout = self.engine.generate(
                    policy, batch_to_device(prompt, self.device), generator,
                    **kw)
                del policy
            comp_ids = rollout["completion_ids"].cpu().numpy()
            comp_mask = rollout["completion_mask"].cpu().numpy()
        else:
            N = cfg.max_completion_length
            comp_ids = np.full((len(examples), N),
                               self.tokenizer.pad_token_id or 0, np.int64)
            comp_mask = np.zeros((len(examples), N), np.int64)
            for i, ex in enumerate(examples):
                ids = list(ex["completion_ids"])[:N]
                comp_ids[i, :len(ids)] = ids
                comp_mask[i, :len(ids)] = 1

        batch = completion_batch(self.bundle, prompt_ids, prompt_mask,
                                 comp_ids, comp_mask)
        self.state, metrics = self.update_step(
            self.state, self.teacher_params, batch)
        out = {k: float(v) for k, v in metrics.items()}
        out["on_policy"] = float(on_policy)
        self.metrics_history.append(out)
        return out
