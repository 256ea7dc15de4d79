"""SC-GRPO: structured-control group-relative policy optimization (the
port's own copy of iadr1_tpu/train/grpo.py).

Per step: roll out G completions per prompt with the in-program
RolloutEngine (each prompt prefilled once, its KV cache fanned out G
ways), score them on the host with the structured reward functions,
group-normalize the advantages ((r - mean_G) / (std_G + 1e-4)), then
update: per-token policy and frozen-reference log-probabilities, the k3 KL
estimator (exp(ref - lp) - (ref - lp) - 1) and the loss
-(exp(lp - sg(lp)) * adv - beta * KL), averaged per sequence and then over
the batch.

Prompts repeat G times *consecutively*, so the group normalization is
right for any number of prompts per step.  Generation, scoring and update
share one device and one copy of the policy parameters.

On a mesh (``core/mesh.py``) each batch rank takes its share of the
step's prompts (whole groups), rolls them out with the sampler drawing for
the global batch (``train/rollout.py``): on a copy of the policy gathered
whole at tp = 1, on its tp slice gathered over dp and fsdp at tp > 1
(``tp_local_params``, a tensor-parallel decode with explicit
collectives); it scores them and updates on the sharded state; the
update's normalizers are global, and the metrics cover every rank's rows.

LoRA mode with reference elision (``base_params`` and a LoRA
``tuning_cfg``): the state holds the adapter tree alone, the frozen base
rides the reference slot, the policy is base + factored adapters and the
KL reference is the bare base, so one copy of the base weights serves
rollout, policy and reference, on a mesh too (the base sharded by its
logical axes, or a quantized base replicated; the adapters and their
moments sharded by ``train/adapters.py lora_logical_axes``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.distributed import host_batch_slice
from iadr1_tpu_torch.core.mesh import (
    batch_mean,
    batch_total,
    compute_view,
    gather_host_rows,
    kernel_mesh,
    local,
    mesh_scope,
)
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.models.registry import GRPO_NOT_YET_PORTED
from iadr1_tpu_torch.train.adapters import lora_logical_axes
from iadr1_tpu_torch.train.optimizers import global_norm
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    cast_dense_params,
    mesh_tp,
    rollout_copy,
    tp_local_params,
)
from iadr1_tpu_torch.train.sft import (
    batch_to_device,
    chunk_logits,
    mesh_metrics,
    pick_logits,
)
from iadr1_tpu_torch.train.state import tree_leaves

# profiler range names of an update's phases (the backward's kernels are
# launched from autograd's device thread, outside any range of this one)
UPDATE_RANGES = ("grpo_reference", "grpo_forward", "grpo_optimizer")

# the collated prompt batch's own keys; every other key is one of the
# arrays the family's ``vision_arrays`` returned, which the update carries
PROMPT_KEYS = ("input_ids", "attention_mask", "position_ids", "mrope_deltas")


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    num_generations: int = 4          # G
    beta: float = 0.04                # KL coefficient
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    max_prompt_length: int = 1024
    max_completion_length: int = 512
    scale_rewards: bool = True        # divide by the group's std
    logp_chunk_size: int = 1024       # LM-head chunking of the logp scoring
    # num_iterations (mu): update passes per rollout; > 1 makes the step
    # off-policy against the generation-time logps and engages epsilon.
    # epsilon / epsilon_high: ratio clipping bounds.  loss_type: "grpo"
    # (per-sequence mean of token losses, then mean), "bnpo" (token sum /
    # total tokens), "dr_grpo" (token sum / (B * max_completion_length)).
    num_iterations: int = 1
    epsilon: float = 0.2
    epsilon_high: float | None = None
    loss_type: str = "grpo"
    # periodic reference refresh: every sync_steps,
    # ref <- alpha * policy + (1 - alpha) * ref
    sync_ref_model: bool = False
    ref_model_mixup_alpha: float = 0.6
    ref_model_sync_steps: int = 512
    # "save_flash" (= True) keeps the flash (out, lse) across the remat;
    # "full" recomputes them in the backward; False keeps everything
    remat: str | bool = "save_flash"
    # factor the update forward so that the unique prompts run once and
    # the completions attend the shared prompt KV (models/shared_prompt.py);
    # off when the bundle has no shared path
    shared_prompt_scoring: bool = True


# ---------------------------------------------------------------------------
# the update step
# ---------------------------------------------------------------------------


def _chunk_logps(hc, kernel, tc, logits_dtype):
    logits = chunk_logits(hc, kernel, logits_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    picked = pick_logits(logits, tc)
    return (picked - lse).float()


def chunked_token_logps(
    hidden: torch.Tensor,        # [B, N, H]; hidden[:, i] predicts
    head_kernel: torch.Tensor,   # [H, V]     targets[:, i]
    targets: torch.Tensor,       # [B, N]
    chunk_size: int = 1024,
    logits_dtype=torch.float32,
) -> torch.Tensor:
    """Per-token log p(targets) [B, N] f32 without the [B, N, V] logits:
    the LM-head product (the chunked CE's, ``sft.chunk_logits``) and the
    log-softmax run chunk by chunk over the flattened tokens, each chunk
    under a checkpoint."""
    B, N, H = hidden.shape
    h = hidden.reshape(-1, H)
    t = targets.reshape(-1).long()
    parts = [ckpt(_chunk_logps, h[c0:c0 + chunk_size], head_kernel,
                  t[c0:c0 + chunk_size], logits_dtype)
             for c0 in range(0, B * N, chunk_size)]
    return torch.cat(parts).reshape(B, N)


def completion_logps(score_fn, params, batch,
                     chunk_size: int = 1024) -> torch.Tensor:
    """Per-token logps [B, N] of the completion tokens given the full
    sequence (the dense path).

    ``score_fn(params, batch) -> (hidden [B, P+N, H], head_kernel [H, V])``;
    batch: input_ids [B, P+N] (left-padded prompt + completion),
    segment_ids, position_ids, completion_ids, prompt_len."""
    hidden, kernel = score_fn(params, batch)
    P = batch["prompt_len"]
    N = batch["completion_ids"].shape[1]
    # hidden states at P-1 .. P+N-2 predict completion tokens 0 .. N-1
    pred = hidden[:, P - 1:P - 1 + N]
    return chunked_token_logps(pred, kernel, batch["completion_ids"],
                               chunk_size)


def bundle_score_fn(bundle, remat=True):
    """The default score_fn of a registry ModelBundle (extra keywords,
    ``lora=``, pass through to its ``hidden_fn``)."""
    def score(params, batch, **kw):
        return (bundle.hidden_fn(params, batch, remat=remat, **kw),
                bundle.head_kernel_fn(params))

    return score


def _update_batch_to_device(batch: dict, device) -> dict:
    out = batch_to_device({k: v for k, v in batch.items()
                           if k != "prompt_len"}, device)
    if "prompt_len" in batch:
        out["prompt_len"] = int(batch["prompt_len"])
    return out


def make_grpo_update_step(score_fn, optimizer, cfg: GRPOConfig,
                          schedule=None, logps_fn=None, ref_logps_fn=None):
    """``step(state, ref_params, batch) -> (new_state, metrics)``.

    ``score_fn(params, batch) -> (hidden, head_kernel)`` (see
    ``bundle_score_fn``) scores the dense batch; ``logps_fn(params, batch)
    -> [B, N]`` (and ``ref_logps_fn``) replace the whole scoring path: the
    shared-prompt factorization does.

    Dense batch: input_ids [B, P+N], segment_ids, position_ids,
    completion_ids [B, N], completion_mask [B, N], advantages [B],
    prompt_len (int); ``old_logps`` [B, N] when the step is off-policy.
    The batch is moved to the parameters' device and the state is updated
    in place.  Metrics are 0-d tensors: loss, kl, clip_ratio, grad_norm
    (before clipping), completion_length and, with a schedule,
    learning_rate."""
    if cfg.loss_type not in ("grpo", "bnpo", "dr_grpo"):
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
    if logps_fn is None:
        def logps_fn(params, batch):
            return completion_logps(score_fn, params, batch,
                                    cfg.logp_chunk_size)
    if ref_logps_fn is None:
        ref_logps_fn = logps_fn
    eps_low = cfg.epsilon
    eps_high = cfg.epsilon_high if cfg.epsilon_high is not None else cfg.epsilon

    def step(state, ref_params, batch):
        leaves = tree_leaves(state.params)
        batch = _update_batch_to_device(batch, leaves[0].device)
        mask = batch["completion_mask"].float()
        with mesh_scope():
            # the frozen reference first: its activations are gone before
            # the policy's forward keeps its own
            with record_function(UPDATE_RANGES[0]), torch.no_grad():
                ref_logps = ref_logps_fn(compute_view(ref_params), batch)
            with record_function(UPDATE_RANGES[1]):
                logps = logps_fn(compute_view(state.params), batch)
                diff = ref_logps - logps
                kl = torch.exp(diff) - diff - 1.0          # the k3 estimator
                adv = batch["advantages"].float()[:, None]
                # off-policy passes (mu > 1) score against the
                # generation-time logps in the batch; on-policy the ratio
                # is 1 and the clipping inert
                old_logps = batch.get("old_logps")
                if old_logps is None:
                    old_logps = logps.detach()
                coef1 = torch.exp(logps - old_logps)
                coef2 = torch.clamp(coef1, 1.0 - eps_low, 1.0 + eps_high)
                per_token = -(torch.minimum(coef1 * adv, coef2 * adv)
                              - cfg.beta * kl)
                denom = mask.sum(dim=1).clamp(min=1.0)
                total = batch_total(mask.sum()).clamp(min=1.0)
                if cfg.loss_type == "grpo":
                    loss = batch_mean((per_token * mask).sum(dim=1) / denom)
                elif cfg.loss_type == "bnpo":
                    loss = (per_token * mask).sum() / total
                else:
                    loss = (per_token * mask).sum() / (
                        batch_total(mask.shape[0])
                        * cfg.max_completion_length)
                with torch.no_grad():
                    metrics = {
                        "loss": loss.detach(),
                        "kl": batch_mean((kl * mask).sum(dim=1) / denom),
                        "clip_ratio": (((coef1 - coef2).abs() > 1e-9).float()
                                       * mask).sum() / total,
                    }
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with record_function(UPDATE_RANGES[2]):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            metrics = mesh_metrics(metrics)
            metrics["grad_norm"] = global_norm(grads)
            if schedule is not None:
                metrics["learning_rate"] = torch.tensor(schedule(state.step))
            new_state = state.apply_gradients(grads, optimizer,
                                              metrics["grad_norm"])
        metrics["completion_length"] = batch_total(
            batch_mean(mask.sum(dim=1)))
        return new_state, metrics

    return step


def make_grpo_logps_eval(score_fn, cfg: GRPOConfig, logps_fn=None):
    """``(params, batch) -> [B, N]`` generation-time logps, without
    gradients: the ``old_logps`` snapshot before mu-iteration updates."""
    if logps_fn is None:
        def logps_fn(params, batch):
            return completion_logps(score_fn, params, batch,
                                    cfg.logp_chunk_size)

    @torch.no_grad()
    def run(params, batch):
        device = tree_leaves(params)[0].device
        with mesh_scope():
            return local(logps_fn(compute_view(params),
                                  _update_batch_to_device(batch, device)))

    return run


# ---------------------------------------------------------------------------
# host-side orchestration
# ---------------------------------------------------------------------------


def group_advantages(rewards: np.ndarray, num_generations: int,
                     scale: bool = True) -> np.ndarray:
    """(r - mean_G) / (std_G + 1e-4) over consecutive groups of G (the
    std with ddof = 1, as torch's)."""
    r = rewards.reshape(-1, num_generations)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, ddof=1, keepdims=True)
    adv = r - mean
    if scale:
        adv = adv / (std + 1e-4)
    return adv.reshape(-1).astype(np.float32)


def _pad_id(tokenizer) -> int:
    return tokenizer.pad_token_id or tokenizer.eos_token_id


def sampling_generator(seed: int, k: int, device) -> torch.Generator:
    """The generator of rollout ``k`` (from 0) of a run seeded ``seed``:
    seeded by the two alone, so a resumed run draws what an uninterrupted
    one would."""
    state = int(np.random.SeedSequence([seed, k]).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state & (2 ** 63 - 1))


def collate_text_prompts(bundle, examples: Sequence[dict], P: int,
                         pad: int) -> dict:
    """Pre-encoded ``prompt_ids`` left-padded to ``P`` (numpy): input_ids
    and attention_mask [B, P], and for an M-RoPE model the text position
    grid [3, B, P] with its mrope_deltas.  A prompt longer than P keeps
    its last P ids, unless it holds image tokens, which raises."""
    img_id = getattr(bundle.cfg, "image_token_id", None)
    ids_list = []
    for ex in examples:
        ids = ex["prompt_ids"][-P:]
        if len(ex["prompt_ids"]) > P and img_id is not None and (
            img_id in ex["prompt_ids"]
        ):
            # slicing through an image-token run would desynchronize the
            # feature scatter indices: fail loudly instead
            raise ValueError(
                f"prompt ({len(ex['prompt_ids'])} tokens) with image "
                f"tokens exceeds max_prompt_length={P}; raise "
                "max_prompt_length or lower max_pixels")
        ids_list.append(ids)
    B = len(ids_list)
    input_ids = np.full((B, P), pad, np.int64)
    mask = np.zeros((B, P), np.int64)
    for i, ids in enumerate(ids_list):
        input_ids[i, P - len(ids):] = ids
        mask[i, P - len(ids):] = 1
    batch = {"input_ids": input_ids, "attention_mask": mask}
    tcfg = getattr(bundle.cfg, "text", bundle.cfg)
    if getattr(tcfg, "mrope_section", None) is not None:
        # text-only prompts on an M-RoPE model: the three axes share the
        # text position stream
        pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
        batch["position_ids"] = np.broadcast_to(pos, (3, B, P)).copy()
        batch["mrope_deltas"] = pos[:, -1] + 1 - P
    return batch


class GRPOTrainer:
    """Host loop: collate prompts -> rollout -> rewards -> update.

    ``reward_funcs`` have the signature fn(completions, solution=...,
    **cols) -> list[float]; the rewards of all functions are summed.
    ``tokenizer`` needs ``batch_decode``, ``eos_token_id`` and
    ``pad_token_id``.  ``state`` holds the policy (f32 by default) and
    ``ref_params`` the frozen reference, both on ``device``.

    LoRA mode: ``base_params`` (the frozen base, bf16 or quantized) and a
    LoRA ``tuning_cfg``; ``state.params`` is then the adapter tree
    (``train/adapters.py init_lora_params``) and ``ref_params`` is not
    read (pass None): the base is the reference.  The reference refresh
    does nothing there.

    Sampling: the rollout of trainer step k (counted from 0) draws from a
    generator seeded by (``seed``, k) alone, so a run resumed at step k
    (``fast_forward_rng(k)``) draws what an uninterrupted run would."""

    def __init__(self, bundle, tokenizer, optimizer, cfg: GRPOConfig,
                 reward_funcs: Sequence[Callable], state, ref_params,
                 sampling_overrides: dict | None = None, schedule=None,
                 template=None, prompt_collator: Callable | None = None,
                 base_params=None, tuning_cfg=None, device=None,
                 seed: int = 0):
        self._lora_mode = base_params is not None
        if self._lora_mode and (tuning_cfg is None
                                or tuning_cfg.finetuning_type != "lora"):
            raise ValueError("base_params requires a LoRA TuningConfig")
        if bundle.family in GRPO_NOT_YET_PORTED:
            raise NotImplementedError(
                f"SC-GRPO for the {bundle.family} family is not ported yet "
                f"({GRPO_NOT_YET_PORTED[bundle.family]})")
        # tp > 1: the rollout decodes tensor-parallel (``tp_local_params``)
        self._tp = mesh_tp()
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.reward_funcs = list(reward_funcs)
        self.state = state
        # LoRA mode: the frozen base rides the reference slot
        self.ref_params = base_params if self._lora_mode else ref_params
        self.template = template
        # optional VLM collator: (examples, G) -> rollout batch with the
        # vision arrays and M-RoPE positions (cli/train_grpo.py)
        self.prompt_collator = prompt_collator
        self.device = resolve_device(device)
        self.seed = seed
        sampling = SamplingConfig(
            max_new_tokens=cfg.max_completion_length,
            temperature=cfg.temperature, top_p=cfg.top_p, top_k=cfg.top_k,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=_pad_id(tokenizer),
            **(sampling_overrides or {}),
        )
        scale = tuning_cfg.lora_scale if self._lora_mode else 1.0
        self.engine = RolloutEngine(
            bundle, sampling,
            max_len=cfg.max_prompt_length + cfg.max_completion_length,
            device=self.device, lora_scale=scale)
        remat = True if cfg.remat == "save_flash" else cfg.remat
        self._shared = (cfg.shared_prompt_scoring
                        and bundle.shared_pred_fn is not None)
        G = cfg.num_generations

        def shared_logps(params, batch, **lora_kw):
            pred = bundle.shared_pred_fn(params, batch, G, remat=remat,
                                         **lora_kw)
            return chunked_token_logps(
                pred, bundle.head_kernel_fn(params),
                batch["completion_ids"], cfg.logp_chunk_size)

        logps_fn = shared_logps if self._shared else None
        ref_logps_fn = None
        score_fn = bundle_score_fn(bundle, remat=remat)
        if self._lora_mode:
            # the policy: the base (closed over; on a mesh its compute
            # view) plus the adapters the state holds; the reference: the
            # base alone
            base = base_params
            ref_score_fn = score_fn

            def score_fn(lora, batch):
                return ref_score_fn(compute_view(base), batch, lora=lora,
                                    lora_scale=scale)

            if self._shared:
                def logps_fn(lora, batch):
                    return shared_logps(compute_view(base), batch, lora=lora,
                                        lora_scale=scale)

                ref_logps_fn = shared_logps
            else:
                def ref_logps_fn(base, batch):
                    return completion_logps(ref_score_fn, base, batch,
                                            cfg.logp_chunk_size)

        self.update_step = make_grpo_update_step(
            score_fn, optimizer, cfg, schedule, logps_fn=logps_fn,
            ref_logps_fn=ref_logps_fn)
        self.logps_eval = make_grpo_logps_eval(score_fn, cfg,
                                               logps_fn=logps_fn)
        self._rollouts = 0          # rollouts drawn: the sampling stream's k
        self.metrics_history: list[dict] = []

    # --- reference refresh and sampling stream -----------------------------

    @torch.no_grad()
    def maybe_sync_ref(self) -> bool:
        """ref <- (1 - alpha) * ref + alpha * policy every
        ``ref_model_sync_steps`` optimizer steps, when ``sync_ref_model``;
        never in LoRA mode, where the frozen base is the reference."""
        if not self.cfg.sync_ref_model or self._lora_mode:
            return False
        step = int(self.state.step)
        if step == 0 or step % self.cfg.ref_model_sync_steps != 0:
            return False
        alpha = self.cfg.ref_model_mixup_alpha
        for r, p in zip(tree_leaves(self.ref_params),
                        tree_leaves(self.state.params)):
            r, p = local(r), local(p)       # the same placements on a mesh
            r.copy_(((1.0 - alpha) * r.float() + alpha * p.float()).to(r.dtype))
        return True

    def fast_forward_rng(self, n_steps: int) -> None:
        """Advance the sampling stream as if ``n_steps`` rollouts had run
        (resume: the stream stays aligned with an uninterrupted run)."""
        self._rollouts += n_steps

    def _next_generator(self) -> torch.Generator:
        generator = sampling_generator(self.seed, self._rollouts,
                                       self.device)
        self._rollouts += 1
        return generator

    # --- the update ---------------------------------------------------------

    def _run_updates(self, update_batch):
        """One update pass (mu = 1, the SC-GRPO recipe) or mu off-policy
        passes against the snapshotted generation-time logps (epsilon
        clipping engages only there)."""
        mu = self.cfg.num_iterations
        if mu > 1:
            update_batch = dict(update_batch)
            update_batch["old_logps"] = self.logps_eval(self.state.params,
                                                        update_batch)
        for _ in range(mu):
            self.state, metrics = self.update_step(
                self.state, self.ref_params, update_batch)
        return self.state, metrics

    def compute_advantages(self, rewards: np.ndarray) -> np.ndarray:
        """Group-normalized advantages; a subclass hook."""
        return group_advantages(rewards, self.cfg.num_generations,
                                self.cfg.scale_rewards)

    def _collate_prompts(self, examples: Sequence[dict]) -> dict:
        """Left-pad tokenized prompts to max_prompt_length, one row per
        UNIQUE prompt (the engine fans the prefilled KV cache out G ways);
        numpy arrays."""
        return collate_text_prompts(self.bundle, examples,
                                    self.cfg.max_prompt_length,
                                    _pad_id(self.tokenizer))

    # --- one GRPO step ------------------------------------------------------

    def step(self, examples: Sequence[dict]) -> dict:
        """examples: [{"prompt_ids": [...], "solution": str, ...extras}]
        -> the step's metrics (floats).  On a mesh every rank passes the
        step's whole list and takes its share of it; the metrics cover
        the whole list."""
        G = self.cfg.num_generations
        examples = list(examples)[host_batch_slice(len(examples))]
        if self.prompt_collator is not None:
            # the unique-prompt batch for the prefix-cached rollout (the
            # tower runs once per prompt).  Shared-prompt scoring reuses it
            # for the update; the dense path needs a G-repeated batch (its
            # scatter plan wants one row per rollout).
            rollout_batch = self.prompt_collator(examples, 1)
            batch = (rollout_batch if self._shared
                     else self.prompt_collator(examples, G))
        else:
            rollout_batch = batch = self._collate_prompts(examples)
        policy, kw = self._rollout_params()
        if self._tp is not None:
            kw["tp"] = self._tp
        rollout = self.engine.generate(
            policy, batch_to_device(rollout_batch, self.device),
            self._next_generator(), group_size=G, **kw)
        del policy, kw
        completion_ids = rollout["completion_ids"].cpu().numpy()
        completion_mask = rollout["completion_mask"].cpu().numpy()
        prompt_ids = rollout["prompt_ids"].cpu().numpy()
        prompt_mask = rollout["prompt_mask"].cpu().numpy()
        del rollout

        texts = self.tokenizer.batch_decode(
            [ids[m.astype(bool)]
             for ids, m in zip(completion_ids, completion_mask)],
            skip_special_tokens=True)
        completions = [[{"role": "assistant", "content": t}] for t in texts]
        # reward kwargs: every extra column repeated G times per example
        keys = {k for ex in examples for k in ex if k != "prompt_ids"}
        reward_kwargs = {key: [ex.get(key) for ex in examples
                               for _ in range(G)] for key in keys}
        rewards_per_func = np.zeros((len(completions),
                                     len(self.reward_funcs)))
        step_idx = int(self.state.step)
        for i, fn in enumerate(self.reward_funcs):
            out = fn(completions=completions, current_step=step_idx,
                     **reward_kwargs)
            rewards_per_func[:, i] = np.asarray(out, np.float64)
        rewards = rewards_per_func.sum(axis=1)
        # whole groups lie on each rank, so the group statistics are local
        advantages = self.compute_advantages(rewards)

        # truncation rate: completions that hit max_completion_length
        # without emitting EOS.  A too-short budget truncates every answer
        # mid-sentence, every structured reward scores 0, and training
        # "runs" while learning nothing.
        eos_id = self.tokenizer.eos_token_id
        full_rows = completion_mask.sum(axis=1) == completion_ids.shape[1]
        truncated = full_rows & (completion_ids[:, -1] != eos_id)
        trunc_frac = float(truncated.mean())
        if trunc_frac > 0.5 and not np.any(rewards):
            warnings.warn(
                f"{trunc_frac:.0%} of completions hit "
                f"max_completion_length={self.cfg.max_completion_length} "
                "without EOS and every reward is zero -- answers are "
                "likely truncated before they can be scored; raise "
                "GRPOConfig.max_completion_length",
                stacklevel=2)

        update_batch = self._update_batch(
            batch, prompt_ids, prompt_mask, completion_ids, completion_mask,
            advantages)
        self.state, metrics = self._run_updates(update_batch)
        # the metrics read every rank's rows
        rewards_per_func = gather_host_rows(rewards_per_func)
        rewards = rewards_per_func.sum(axis=1)
        trunc_frac = float(gather_host_rows(truncated).mean())
        out = {k: float(v) for k, v in metrics.items()}
        out["completion_truncated_frac"] = trunc_frac
        out["ref_synced"] = float(self.maybe_sync_ref())
        out["reward"] = float(rewards.mean())
        out["reward_std"] = float(
            rewards.reshape(-1, G).std(axis=1, ddof=1).mean())
        for i, fn in enumerate(self.reward_funcs):
            out[f"rewards/{fn.__name__}"] = float(
                rewards_per_func[:, i].mean())
        self.metrics_history.append(out)
        return out

    def _rollout_params(self):
        """(the rollout's parameters, its ``lora=`` keyword): the policy's
        matmul weights cast to the compute dtype once per step, not once
        per layer per decode step (the tokens are the same).  In LoRA mode
        the adapters are, and the base is read as it is off a mesh.  On a
        mesh each is this rank's rollout copy: gathered whole at tp = 1,
        its tp slice at tp > 1."""
        if not self._lora_mode:
            return rollout_copy(self.bundle, self.state.params, self._tp), {}
        dtype = self.bundle.precision.compute_dtype
        base, lora = self.ref_params, self.state.params
        if self._tp is not None:
            tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
            axes = self.bundle.logical_axes()
            return rollout_copy(self.bundle, base, self._tp), {
                "lora": tp_local_params(lora, lora_logical_axes(lora, axes),
                                        tcfg, self._tp.rank, self._tp.size,
                                        dtype)}
        if kernel_mesh() is not None:
            base = cast_dense_params(base, dtype)
        return base, {"lora": cast_dense_params(lora, dtype)}

    def _update_batch(self, batch, prompt_ids, prompt_mask, completion_ids,
                      completion_mask, advantages) -> dict:
        """The update batch as numpy arrays: the factored one (unique
        prompts, completions per rollout) under shared-prompt scoring,
        else the dense G-repeated one."""
        G = self.cfg.num_generations
        B, P = prompt_ids.shape
        N = completion_ids.shape[1]
        steps = np.arange(N)[None, :]
        common = {"completion_ids": completion_ids,
                  "completion_mask": completion_mask,
                  "advantages": advantages}
        common.update({k: v for k, v in batch.items()
                       if k not in PROMPT_KEYS})
        if self._shared:
            pu_mask = prompt_mask[::G]
            if "position_ids" in batch:         # M-RoPE (VLM collator batch)
                pu_pos = np.asarray(batch["position_ids"])       # [3, n, P]
                deltas = np.asarray(batch["mrope_deltas"])       # [n]
                comp_pos = np.broadcast_to(
                    P + np.repeat(deltas, G)[:, None] + steps,
                    (3, B, N)).copy()
            else:
                pu_pos = np.clip(np.cumsum(pu_mask, axis=1) - 1, 0, None)
                comp_pos = np.repeat(pu_mask.sum(axis=1), G)[:, None] + steps
            return {"prompt_ids": prompt_ids[::G],
                    "prompt_segments": pu_mask,
                    "prompt_positions": pu_pos,
                    "completion_positions": comp_pos, **common}
        full_mask = np.concatenate([prompt_mask, completion_mask], axis=1)
        if "position_ids" in batch:    # M-RoPE: prompt grids + delta positions
            prompt_pos = np.asarray(batch["position_ids"])
            deltas = np.asarray(batch["mrope_deltas"])
            if deltas.shape[0] != B:
                # the unique-prompt batch of text prompts: one grid per
                # rollout (the JAX trainer raises here, ROADMAP C.R24)
                prompt_pos = np.repeat(prompt_pos, G, axis=1)
                deltas = np.repeat(deltas, G)
            comp_pos = np.broadcast_to(P + deltas[:, None] + steps, (3, B, N))
            positions = np.concatenate([prompt_pos, comp_pos], axis=-1)
        else:
            positions = np.clip(np.cumsum(full_mask, axis=1) - 1, 0, None)
        return {"input_ids": np.concatenate([prompt_ids, completion_ids],
                                            axis=1),
                "segment_ids": full_mask, "position_ids": positions,
                "prompt_len": P, **common}

