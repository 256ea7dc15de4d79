"""PA-SFT: masked cross-entropy training step over packed batches (the
port's own copy of iadr1_tpu/train/sft.py).

The loss is averaged over the real label tokens of the whole batch
(labels IGNORE_INDEX carry none).  The LM head runs chunk by chunk, each
chunk under a checkpoint, so the [B, T, V] logits are never materialised;
the head product is a plain ``torch.matmul``, as JAX left it to XLA.
``make_fused_chunked_ce`` forms the head's gradients inside the forward
loop instead; ``make_sft_step`` is the unchunked step over full logits and
``IterativeSFTTrainer`` trl's step-at-a-time trainer.

On a mesh (``core/mesh.py``) each rank feeds its own rows, the token
count that averages the loss is the global one (``batch_total``), and
the step sums the ranks' shares of the loss and metrics.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from iadr1_tpu_torch.core.mesh import (
    batch_total,
    compute_view,
    full,
    is_dtensor,
    kernel_mesh,
    mesh_scope,
)
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.train.optimizers import global_norm as optax_global_norm
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves


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
    n_tokens = batch_total(mask.sum()).clamp(min=1)
    loss = -torch.where(mask, token_logp, 0.0).sum() / n_tokens
    acc = (mask & (logits.argmax(-1) == targets)).sum() / n_tokens
    return loss, {"loss": loss, "accuracy": acc, "n_label_tokens": mask.sum()}


def chunk_logits(hc, kernel, logits_dtype):
    """One chunk's LM-head product [chunk, V] in ``logits_dtype``.  The
    kernel is cast to the hidden dtype first (the JAX einsum's operand
    cast), inside the chunk, so its gradient accumulates across chunks in
    f32.  The CE loss and GRPO's token log-probabilities share it, so both
    heads round alike."""
    return torch.matmul(hc.to(logits_dtype),
                        kernel.to(hc.dtype).to(logits_dtype))


def pick_logits(logits, targets):
    """logits[i, targets[i]] of [N, V] logits.  Over vocabulary-sharded
    DTensor logits (tp) it is a masked sum, which DTensor reduces over the
    shards; the one nonzero term makes it exact."""
    if is_dtensor(logits):
        onehot = torch.nn.functional.one_hot(targets, logits.shape[-1])
        return (logits * onehot.to(logits.dtype)).sum(-1)
    return logits.gather(1, targets[:, None])[:, 0]


def _chunk_ce(hc, kernel, tc, mc, logits_dtype):
    """One chunk: (sum of token losses, correct count)."""
    logits = chunk_logits(hc, kernel, logits_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    picked = pick_logits(logits, tc)
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
    n_tokens = batch_total(mask.sum()).clamp(min=1)
    loss = loss_sum / n_tokens
    return loss, {"loss": loss, "accuracy": correct / n_tokens,
                  "n_label_tokens": mask.sum()}


def _fused_ce(hidden, kernel, labels, chunk_size, logits_dtype,
              want_grads: bool):
    """The fused CE's loop: (loss, correct count, n_tokens, d_hidden,
    d_kernel); the gradients are those of the loss itself (cotangent 1),
    None unless ``want_grads``."""
    B, T, H = hidden.shape
    h = hidden[:, :-1].reshape(-1, H)
    t = labels[:, 1:].reshape(-1).long()
    mask = t != IGNORE_INDEX
    safe = torch.where(mask, t, 0)
    N = h.shape[0]
    pad = (-N) % chunk_size
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad))
    tp = torch.nn.functional.pad(safe, (0, pad))
    mp = torch.nn.functional.pad(mask, (0, pad))
    kt = kernel.to(hp.dtype)
    n_tokens = mask.sum().clamp(min=1)
    inv_n = 1.0 / n_tokens.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    dh, dk = [], None
    if want_grads:
        dk = torch.zeros(kernel.shape, dtype=torch.float32,
                         device=kernel.device)
    for c0 in range(0, hp.shape[0], chunk_size):
        hc, tc, mc = (x[c0:c0 + chunk_size] for x in (hp, tp, mp))
        logits = chunk_logits(hc, kernel, logits_dtype)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(1, tc[:, None])[:, 0]
        loss_sum = loss_sum + torch.where(mc, lse - picked, 0.0).sum()
        correct = correct + (mc & (logits.argmax(-1) == tc)).sum()
        if not want_grads:
            continue
        # dlogits = (softmax - onehot) * mask / n_tokens, formed in f32 and
        # consumed at the compute dtype; both head products accumulate in
        # f32 (JAX's preferred_element_type)
        mcf = mc.float() * inv_n
        dlog = torch.exp(logits.float() - lse.float()[:, None]) * mcf[:, None]
        dlog[torch.arange(hc.shape[0], device=hc.device), tc] -= mcf
        dlog = dlog.to(hc.dtype).float()
        dh.append(torch.matmul(dlog, kt.float().T).to(hidden.dtype))
        dk.addmm_(hc.float().T, dlog)
    loss = loss_sum / n_tokens
    if not want_grads:
        return loss, correct, mask.sum(), None, None
    dh = torch.cat(dh)[:N].reshape(B, T - 1, H)
    dh = torch.nn.functional.pad(dh, (0, 0, 0, 1))
    return loss, correct, mask.sum(), dh, dk.to(kernel.dtype)


class _FusedChunkedCE(torch.autograd.Function):
    """(hidden, kernel, labels) -> (loss, the loss again for the metrics,
    accuracy, n_label_tokens).  The forward keeps the gradients its loop
    made; the backward only scales them by the sum of the two loss
    cotangents (the JAX custom VJP's ``fused_bwd``)."""

    @staticmethod
    def forward(ctx, hidden, kernel, labels, chunk_size, logits_dtype):
        want = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        loss, correct, n_label, dh, dk = _fused_ce(
            hidden, kernel, labels, chunk_size, logits_dtype, want)
        ctx.save_for_backward(dh, dk)
        acc = correct / n_label.clamp(min=1)
        ctx.mark_non_differentiable(acc, n_label)
        return loss, loss.clone(), acc, n_label

    @staticmethod
    def backward(ctx, g_loss, g_metric, _acc, _n):
        dh, dk = ctx.saved_tensors
        g = (g_loss + g_metric).float()
        return ((dh.float() * g).to(dh.dtype), (dk.float() * g).to(dk.dtype),
                None, None, None)


def make_fused_chunked_ce(chunk_size: int, logits_dtype=torch.float32):
    """Chunked masked CE that computes its own gradients in the forward
    loop: ``fused(hidden, head_kernel, labels) -> (loss, metrics)`` with
    ``chunked_sft_loss``'s value and metrics.

    Each chunk forms dlogits = (softmax(logits) - onehot(t)) * mask /
    n_tokens, then d_hidden = dlogits @ W^T and d_W += h^T @ dlogits ([H, V]
    f32, carried through the loop).  No chunk is recomputed in the
    backward, which only scales the saved gradients by the incoming
    cotangent; the loss leaves twice (``loss`` and ``metrics["loss"]``)
    and the scale is the sum of both cotangents."""

    def fused(hidden, kernel, labels):
        loss, metric_loss, acc, n_label = _FusedChunkedCE.apply(
            hidden, kernel, labels, chunk_size, logits_dtype)
        return loss, {"loss": metric_loss, "accuracy": acc,
                      "n_label_tokens": n_label}

    return fused


def batch_to_device(batch: dict, device) -> dict:
    """Collator output (numpy or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def mesh_metrics(metrics: dict) -> dict:
    """A step's metrics, detached and whole (a DTensor over the tp
    submesh gathered); on a mesh each is the sum of the batch ranks'
    shares."""
    return {k: batch_total(full(v.detach())) for k, v in metrics.items()}


def _make_step(loss_fn, optimizer, schedule):
    """``step(state, batch)`` over ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradients of every leaf, their global norm, the update
    in place.  On a mesh ``batch`` is this rank's rows."""

    def step(state, batch):
        leaves = tree_leaves(state.params)
        batch = batch_to_device(batch, leaves[0].device)
        with mesh_scope():
            with record_function(STEP_RANGES[0]):
                loss, metrics = loss_fn(compute_view(state.params), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with record_function(STEP_RANGES[1]):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            metrics = mesh_metrics(metrics)
            metrics["grad_norm"] = optax_global_norm(grads)
            if schedule is not None:
                metrics["learning_rate"] = torch.tensor(schedule(state.step))
            new_state = state.apply_gradients(grads, optimizer,
                                              metrics["grad_norm"])
        return new_state, metrics

    return step


def make_chunked_sft_step(
    hidden_fn: Callable[[Any, dict], torch.Tensor],
    head_kernel_fn: Callable[[Any], torch.Tensor],
    optimizer,
    schedule=None,
    chunk_size: int = 512,
    aux_loss_coef: float = 0.0,
    fused_ce: bool = False,
    logits_dtype=torch.float32,
):
    """SFT step with the chunked CE loss: ``step(state, batch) ->
    (new_state, metrics)``.  The batch is moved to the parameters'
    device; metrics (0-d tensors) are loss, accuracy, n_label_tokens,
    grad_norm (before clipping) and, with a schedule, learning_rate (read
    at the step before the update).  The state is updated in place.  The
    forward, backward and optimizer phases are named ranges
    (``STEP_RANGES``) for a profiler; they cost nothing measurable when
    none runs.

    ``aux_loss_coef`` > 0: ``hidden_fn`` returns (hidden, aux), the MoE
    router's load-balancing loss, and the step minimises CE + coef * aux;
    the metrics' "loss" is that sum and "aux_loss" the aux, as in JAX.
    ``fused_ce`` takes the loss from ``make_fused_chunked_ce`` (the head's
    gradients made in the forward loop, no chunk recomputed)."""
    if fused_ce and kernel_mesh() is not None:
        raise NotImplementedError(
            "the fused CE on a mesh is not ported (ROADMAP A.11b): its "
            "autograd Function would meet DTensors")
    ce = (make_fused_chunked_ce(chunk_size, logits_dtype) if fused_ce
          else functools.partial(chunked_sft_loss, chunk_size=chunk_size,
                                 logits_dtype=logits_dtype))

    def loss_fn(params, batch):
        hidden = hidden_fn(params, batch)
        if aux_loss_coef:
            hidden, aux = hidden
        loss, metrics = ce(hidden, head_kernel_fn(params), batch["labels"])
        if aux_loss_coef:
            loss = loss + aux_loss_coef * aux
            metrics = {**metrics, "aux_loss": aux, "loss": loss}
        return loss, metrics

    return _make_step(loss_fn, optimizer, schedule)


def make_sft_step(forward_fn: Callable[[Any, dict], torch.Tensor], optimizer,
                  schedule=None):
    """The unchunked SFT step: ``forward_fn(params, batch) -> logits``
    [B, T, V] (a bundle's ``forward``), the masked CE of ``sft_loss`` over
    them, the update.  Metrics as ``make_chunked_sft_step``'s."""
    return _make_step(
        lambda params, batch: sft_loss(forward_fn(params, batch),
                                       batch["labels"]),
        optimizer, schedule)


class IterativeSFTTrainer:
    """Step-at-a-time SFT on samples the caller provides (trl's
    IterativeSFTTrainer): the caller drives the loop, generating, filtering
    or editing samples between steps, and hands ``step`` raw texts or
    token ids.  Masking a prompt is the caller's job (``labels``).

    With no ``state``, the parameters are ``bundle.init_params(seed=0)``
    on ``device`` (the card unless the caller names another)."""

    def __init__(self, bundle, tokenizer, optimizer, schedule=None,
                 state=None, max_length: int = 512, ce_chunk: int = 1024,
                 device=None):
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.max_length = max_length
        if state is None:
            state = create_train_state(
                bundle.init_params(seed=0, device=device), optimizer)
        self.state = state
        self.update = make_chunked_sft_step(
            bundle.hidden_fn, bundle.head_kernel_fn, optimizer, schedule,
            chunk_size=ce_chunk)
        self.metrics_history: list[dict] = []

    def _batch(self, input_ids=None, labels=None, texts=None) -> dict:
        """The padded batch ``step`` trains on: rows cut to
        ``max_length``, padded to the longest with the tokenizer's pad id
        (labels with IGNORE_INDEX), one segment a row, positions from 0."""
        if texts is not None:
            input_ids = [
                self.tokenizer.encode(t, add_special_tokens=False)[
                    :self.max_length]
                for t in texts]
        if input_ids is None:
            raise ValueError("provide texts or input_ids")
        if labels is None:
            labels = input_ids
        pad = self.tokenizer.pad_token_id or 0
        B = len(input_ids)
        T = min(self.max_length, max(len(x) for x in input_ids))
        ids = np.full((B, T), pad, np.int32)
        lab = np.full((B, T), IGNORE_INDEX, np.int32)
        segs = np.zeros((B, T), np.int32)
        for i, (x, y) in enumerate(zip(input_ids, labels)):
            x, y = list(x)[:T], list(y)[:T]
            ids[i, :len(x)] = x
            lab[i, :len(y)] = y
            segs[i, :len(x)] = 1
        return {"input_ids": ids, "labels": lab, "segment_ids": segs,
                "position_ids": np.broadcast_to(np.arange(T, dtype=np.int32),
                                                (B, T)).copy()}

    def step(self, input_ids=None, labels=None, texts=None) -> dict:
        """One optimization step on a list of samples: ``texts`` (list of
        str, tokenized here, every token labeled) or ``input_ids`` (lists
        of ids) with optional per-token ``labels`` (the inputs when
        absent), trl's two inputs.  Returns the step's metrics as floats
        and appends them to ``metrics_history``."""
        self.state, metrics = self.update(
            self.state, self._batch(input_ids, labels, texts))
        out = {k: float(v) for k, v in metrics.items()}
        self.metrics_history.append(out)
        return out
