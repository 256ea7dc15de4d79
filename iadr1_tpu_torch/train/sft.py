"""PA-SFT: masked cross-entropy training step over packed batches (the
port's own copy of iadr1_tpu/train/sft.py, chunked-CE path).

The loss is averaged over the real label tokens of the whole batch
(labels IGNORE_INDEX carry none).  The LM head runs chunk by chunk, each
chunk under a checkpoint, so the [B, T, V] logits are never materialised;
the head product is a plain ``torch.matmul``, as JAX left it to XLA.  The
fused-CE option and ``IterativeSFTTrainer`` are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.profiler import record_function

from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.train.optimizers import global_norm as optax_global_norm
from iadr1_tpu_torch.train.state import tree_leaves


# profiler range names of a step's forward and optimizer phases (the
# backward's kernels are launched from autograd's device thread, outside
# any range of this one)
STEP_RANGES = ("sft_forward", "sft_optimizer")


def sft_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Next-token masked CE over full logits [B, T, V] (the small oracle):
    logits[t] predicts labels[t + 1].  Returns (loss, metrics)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, 0)
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, safe[..., None])[..., 0]
    n_tokens = mask.sum().clamp(min=1)
    loss = -torch.where(mask, token_logp, 0.0).sum() / n_tokens
    acc = (mask & (logits.argmax(-1) == targets)).sum() / n_tokens
    return loss, {"loss": loss, "accuracy": acc, "n_label_tokens": mask.sum()}


def _chunk_ce(hc, kernel, tc, mc, logits_dtype):
    """One chunk: (sum of token losses, correct count).  The kernel is
    cast to the hidden dtype first (the JAX einsum's operand cast), inside
    the chunk, so its gradient accumulates across chunks in f32."""
    logits = torch.matmul(hc.to(logits_dtype),
                          kernel.to(hc.dtype).to(logits_dtype))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, tc[:, None])[:, 0]
    # per-token losses and their sum in f32 whatever the logits dtype
    token_loss = torch.where(mc, lse.float() - picked.float(), 0.0)
    correct = (mc & (logits.argmax(-1) == tc)).sum()
    return token_loss.sum(), correct


def chunked_sft_loss(hidden: torch.Tensor, head_kernel: torch.Tensor,
                     labels: torch.Tensor, chunk_size: int = 512,
                     logits_dtype=torch.float32):
    """Masked CE without materialising the [B, T, V] logits.

    hidden [B, T, H], head_kernel [H, V], labels [B, T].  Each [chunk, V]
    logits block is formed in ``logits_dtype`` under a checkpoint, so the
    backward recomputes it and peak memory is one block.  Returns (loss,
    metrics)."""
    H = hidden.shape[-1]
    h = hidden[:, :-1].reshape(-1, H)
    t = labels[:, 1:].reshape(-1).long()
    mask = t != IGNORE_INDEX
    safe = torch.where(mask, t, 0)
    pad = (-h.shape[0]) % chunk_size
    h = torch.nn.functional.pad(h, (0, 0, 0, pad))
    safe = torch.nn.functional.pad(safe, (0, pad))
    mask_p = torch.nn.functional.pad(mask, (0, pad))
    chunk = functools.partial(_chunk_ce, logits_dtype=logits_dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, h.shape[0], chunk_size):
        c = slice(c0, c0 + chunk_size)
        ls, cs = ckpt(chunk, h[c], head_kernel, safe[c], mask_p[c])
        loss_sum = loss_sum + ls
        correct = correct + cs
    n_tokens = mask.sum().clamp(min=1)
    loss = loss_sum / n_tokens
    return loss, {"loss": loss, "accuracy": correct / n_tokens,
                  "n_label_tokens": mask.sum()}


def batch_to_device(batch: dict, device) -> dict:
    """Collator output (numpy or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_chunked_sft_step(
    hidden_fn: Callable[[Any, dict], torch.Tensor],
    head_kernel_fn: Callable[[Any], torch.Tensor],
    optimizer,
    schedule=None,
    chunk_size: int = 512,
    aux_loss_coef: float = 0.0,
    logits_dtype=torch.float32,
):
    """SFT step with the chunked CE loss: ``step(state, batch) ->
    (new_state, metrics)``.  The batch is moved to the parameters'
    device; metrics (0-d tensors) are loss, accuracy, n_label_tokens,
    grad_norm (before clipping) and, with a schedule, learning_rate (read
    at the step before the update).  The state is updated in place.  The
    forward, backward and optimizer phases are named ranges
    (``STEP_RANGES``) for a profiler; they cost nothing measurable when
    none runs."""
    if aux_loss_coef:
        raise NotImplementedError(
            "the MoE router aux loss is not ported yet (ROADMAP A.13)")

    def step(state, batch):
        leaves = tree_leaves(state.params)
        batch = batch_to_device(batch, leaves[0].device)
        with record_function(STEP_RANGES[0]):
            hidden = hidden_fn(state.params, batch)
            loss, metrics = chunked_sft_loss(
                hidden, head_kernel_fn(state.params), batch["labels"],
                chunk_size, logits_dtype=logits_dtype)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with record_function(STEP_RANGES[1]):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = optax_global_norm(grads)
            if schedule is not None:
                metrics["learning_rate"] = torch.tensor(schedule(state.step))
            new_state = state.apply_gradients(grads, optimizer,
                                              metrics["grad_norm"])
        return new_state, metrics

    return step
