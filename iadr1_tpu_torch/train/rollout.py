"""Rollout engine: batched sampling over a static KV cache (counterpart of
iadr1_tpu/train/rollout.py).

Prompts are left-padded into a [B, P] block and prefilled in one pass
(flash kernel), then decoded one token per step (ragged decode kernel).
Sequences freeze at EOS: the emitted token becomes pad and the cache
segment mask stops growing.  The loop stops once every row is done (the
JAX engine's default ``early_stop``; the tokens are the same either way).
Mixture sampling and LoRA serving are not ported yet (ROADMAP A.14, A.12).
"""

from __future__ import annotations

import dataclasses

import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.models import qwen2


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 512
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    eos_token_id: int = 0
    pad_token_id: int = 0
    # a TPU speed knob (approximate top-k) in the JAX package; the port
    # samples exactly and rejects it
    approx_top_k: bool = False

    def __post_init__(self):
        if self.approx_top_k:
            raise ValueError("approx_top_k is not supported: sampling is exact")


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """One sampling step over [B, V] logits -> [B] int64 token ids:
    greedy at temperature 0, else temperature, exact top-k, then top-p."""
    if cfg.temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / cfg.temperature
    V = logits.shape[-1]
    k = min(cfg.top_k if cfg.top_k > 0 else V, V)
    top_logits, top_idx = logits.topk(k, dim=-1)           # sorted, desc
    if cfg.top_p < 1.0:
        probs = top_logits.softmax(dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep tokens while the mass before them is < top_p
        keep = (cum - probs) < cfg.top_p
        top_logits = top_logits.masked_fill(~keep, float("-inf"))
    choice = torch.multinomial(top_logits.softmax(dim=-1), 1,
                               generator=generator)
    return top_idx.gather(-1, choice)[:, 0]


class RolloutEngine:
    """Batched ``generate`` over a model bundle with a KV cache."""

    def __init__(self, bundle, sampling: SamplingConfig, max_len: int,
                 cache_dtype=torch.bfloat16, device=None):
        self.bundle = bundle
        self.sampling = sampling
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)

    @torch.no_grad()
    def generate(self, params, batch: dict, generator=None,
                 group_size: int = 1) -> dict:
        """batch: left-padded prompt tensors on the engine's device
        ("input_ids", "attention_mask" [B, P]; "position_ids" [3, B, P] and
        "mrope_deltas" [B] for M-RoPE; the vision arrays).  ``group_size``
        G > 1 prefills each prompt once and fans its KV cache out G ways.
        Returns {"completion_ids" [B*G, N], "completion_mask",
        "prompt_ids", "prompt_mask"}, prompts repeated G times
        consecutively, and "num_decode_steps" (the decode steps run)."""
        sampling, bundle = self.sampling, self.bundle
        tcfg = getattr(bundle.cfg, "text", bundle.cfg)
        input_ids = batch["input_ids"]
        attn_mask = batch["attention_mask"]
        B, P = input_ids.shape
        if P + sampling.max_new_tokens > self.max_len:
            raise ValueError(f"prompt {P} + {sampling.max_new_tokens} new "
                             f"tokens exceed max_len {self.max_len}")
        mrope = tcfg.mrope_section is not None
        cache = qwen2.init_cache(tcfg, B, self.max_len, self.cache_dtype,
                                 self.device)

        segs = attn_mask.to(torch.int32)
        if mrope:
            position_ids = batch["position_ids"]
            deltas = batch["mrope_deltas"]
        else:
            position_ids = (attn_mask.cumsum(dim=1) - 1).clamp(min=0)
            deltas = position_ids[:, -1] + 1 - P
        hidden, cache = bundle.apply(
            params, {**batch, "position_ids": position_ids,
                     "segment_ids": segs},
            cache=cache, cache_mode="prefill")
        last_logits = bundle.logits_fn(params, hidden[:, -1:, :])[:, 0]

        if group_size > 1:
            G = group_size
            cache["k"] = cache["k"].repeat_interleave(G, dim=1)
            cache["v"] = cache["v"].repeat_interleave(G, dim=1)
            cache["segment_ids"] = cache["segment_ids"].repeat_interleave(
                G, dim=0)
            last_logits = last_logits.repeat_interleave(G, dim=0)
            deltas = deltas.repeat_interleave(G, dim=0)
            input_ids = input_ids.repeat_interleave(G, dim=0)
            attn_mask = attn_mask.repeat_interleave(G, dim=0)
            B = B * G

        eos, pad = sampling.eos_token_id, sampling.pad_token_id
        token = sample_token(last_logits, sampling, generator)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        N = sampling.max_new_tokens
        tokens = torch.full((N, B), pad, dtype=torch.int64, device=self.device)
        steps = 0
        for t in range(N):
            if bool(done.all()):        # every row has emitted EOS
                break
            steps += 1
            token_in = torch.where(done, pad, token)
            # all three M-RoPE axes advance together after the prompt
            pos = (P + deltas + t).to(torch.int64)[:, None]
            if mrope:
                pos = pos[None].expand(3, B, 1)
            seg = (~done).to(torch.int32)[:, None]
            hidden, cache = bundle.apply(
                params, {"input_ids": token_in[:, None], "position_ids": pos,
                         "segment_ids": seg},
                cache=cache, cache_mode="decode")
            next_token = sample_token(bundle.logits_fn(params, hidden)[:, 0],
                                      sampling, generator)
            tokens[t] = torch.where(done, pad, token)
            done = done | (token == eos)
            token = torch.where(done, pad, next_token)
        completion_ids = tokens.T.contiguous()

        # mask: tokens up to and including the first EOS
        is_eos = completion_ids == eos
        first_eos = torch.where(is_eos.any(dim=1),
                                is_eos.int().argmax(dim=1),
                                torch.full_like(is_eos[:, 0], N,
                                                dtype=torch.int64))
        idx = torch.arange(N, device=self.device)[None, :]
        return {
            "completion_ids": completion_ids,
            "completion_mask": (idx <= first_eos[:, None]).to(torch.int32),
            "prompt_ids": input_ids,
            "prompt_mask": attn_mask.to(torch.int32),
            "num_decode_steps": steps,
        }
