"""Rollout engine: batched sampling over a static KV cache (counterpart of
iadr1_tpu/train/rollout.py).

Prompts are left-padded into a [B, P] block and prefilled in one pass
(flash kernel), then decoded one token per step (ragged decode kernel).
Sequences freeze at EOS: the emitted token becomes pad and the cache
segment mask stops growing.  The loop stops once every row is done (the
JAX engine's default ``early_stop``; the tokens are the same either way).
``generate(..., lora=...)`` samples from a base plus factored adapters
(LoRA SC-GRPO) without merging them.  ``generate_mixture`` samples from
the geometric mixture of two models (Nash-MD's opponent): each keeps its
own KV cache, and each step's logits are (1 - c) log_softmax(policy) +
c log_softmax(mixture) before temperature, top-k and top-p.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.models import qwen2
from iadr1_tpu_torch.models.quant import is_quantized


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 512
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    eos_token_id: int = 0
    pad_token_id: int = 0
    # a TPU speed knob (approximate top-k) in the JAX package; the port
    # accepts it and samples exactly
    approx_top_k: bool = False

    def __post_init__(self):
        if self.approx_top_k:
            warnings.warn("approx_top_k is a TPU speed knob: the port samples "
                          "top-k exactly", stacklevel=3)


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


def cast_dense_params(params: dict, dtype) -> dict:
    """A copy of ``params`` (detached) whose dense layers' kernels and
    biases are stored in ``dtype``, for a rollout from f32 training
    parameters: ``dense`` casts just those to the activations' dtype at
    every call, so the generated tokens are the same, and a decode step
    reads 2-byte weights instead of casting every 4-byte one.  Everything
    the model reads in f32 (norm scales, the embedding table, which a tied
    LM head reads in the logits dtype, and an untied ``lm_head``) keeps its
    dtype, and so does a quant dict (``dense`` dequantizes it to the
    activations' dtype itself).  A LoRA tree casts the same way: its
    factors sit under "kernel" keys, and its None leaves stay None."""
    def keep(node):
        if isinstance(node, dict):
            return {k: keep(v) for k, v in node.items()}
        return None if node is None else node.detach()

    def cast(node):
        if node is None or is_quantized(node):
            return keep(node)
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.detach().to(dtype)

    def walk(node, name):
        if not isinstance(node, dict) or is_quantized(node):
            return keep(node)
        if "kernel" in node and name != "lm_head":      # a dense layer
            return {k: cast(v) for k, v in node.items()}
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params, "")


class RolloutEngine:
    """Batched ``generate`` over a model bundle with a KV cache."""

    def __init__(self, bundle, sampling: SamplingConfig, max_len: int,
                 cache_dtype=torch.bfloat16, device=None,
                 lora_scale: float = 1.0):
        self.bundle = bundle
        self.sampling = sampling
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.lora_scale = lora_scale

    @torch.no_grad()
    def generate(self, params, batch: dict, generator=None,
                 group_size: int = 1, lora=None) -> dict:
        """batch: left-padded prompt tensors on the engine's device
        ("input_ids", "attention_mask" [B, P]; "position_ids" [3, B, P] and
        "mrope_deltas" [B] for M-RoPE; the vision arrays).  ``group_size``
        G > 1 prefills each prompt once and fans its KV cache out G ways.
        Returns {"completion_ids" [B*G, N], "completion_mask",
        "prompt_ids", "prompt_mask"}, prompts repeated G times
        consecutively, and "num_decode_steps" (the decode steps run).
        ``lora``: an adapter tree applied factored on top of ``params``
        (with the engine's ``lora_scale``), prefill and decode alike."""
        return self._generate(params, batch, generator, group_size, lora)

    @torch.no_grad()
    def generate_mixture(self, params, mixture_params, mixture_coef: float,
                         batch: dict, generator=None) -> dict:
        """Samples from the geometric mixture of ``params`` and
        ``mixture_params`` with weight ``mixture_coef`` on the second
        (TRL's GeometricMixtureWrapper): both prefill the batch, each into
        its own KV cache, and decode the same tokens.  Returns what
        ``generate`` returns."""
        return self._generate(params, batch, generator, 1, None,
                              (mixture_params, float(mixture_coef)))

    def _positions(self, batch):
        """(position_ids, deltas) of a left-padded prompt batch: the next
        position of row b is P + deltas[b]."""
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        if tcfg.mrope_section is not None:
            return batch["position_ids"], batch["mrope_deltas"]
        P = batch["input_ids"].shape[1]
        position_ids = (batch["attention_mask"].cumsum(dim=1) - 1).clamp(
            min=0)
        return position_ids, position_ids[:, -1] + 1 - P

    def _lora_kw(self, lora) -> dict:
        return ({"lora": lora, "lora_scale": self.lora_scale}
                if lora is not None else {})

    @torch.no_grad()
    def prefill(self, params, batch: dict, lora=None):
        """(logits at the last prompt position [B, V], the KV cache): the
        prompts (and their vision arrays) prefilled into a fresh cache."""
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        cache = qwen2.init_cache(tcfg, batch["input_ids"].shape[0],
                                 self.max_len, self.cache_dtype, self.device)
        position_ids, _ = self._positions(batch)
        hidden, cache = self.bundle.apply(
            params, {**batch, "position_ids": position_ids,
                     "segment_ids": batch["attention_mask"].to(torch.int32)},
            cache=cache, cache_mode="prefill", **self._lora_kw(lora))
        return (self.bundle.logits_fn(params, hidden[:, -1:, :])[:, 0],
                cache)

    def _generate(self, params, batch, generator, group_size, lora,
                  mixture=None) -> dict:
        sampling, bundle = self.sampling, self.bundle
        if mixture is not None and group_size > 1:
            raise ValueError("mixture sampling does not support "
                             "group_size > 1")
        lora_kw = self._lora_kw(lora)
        tcfg = getattr(bundle.cfg, "text", bundle.cfg)
        input_ids = batch["input_ids"]
        attn_mask = batch["attention_mask"]
        B, P = input_ids.shape
        if P + sampling.max_new_tokens > self.max_len:
            raise ValueError(f"prompt {P} + {sampling.max_new_tokens} new "
                             f"tokens exceed max_len {self.max_len}")
        mrope = tcfg.mrope_section is not None
        _, deltas = self._positions(batch)
        last_logits, cache = self.prefill(params, batch, lora)
        if mixture is not None:
            mix_params, coef = mixture
            mix_logits, mix_cache = self.prefill(mix_params, batch)
            last_logits = mix_log_probs(last_logits, mix_logits, coef)

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
            step_batch = {"input_ids": token_in[:, None],
                          "position_ids": pos, "segment_ids": seg}
            hidden, cache = bundle.apply(
                params, step_batch, cache=cache, cache_mode="decode",
                **lora_kw)
            logits = bundle.logits_fn(params, hidden)[:, 0]
            if mixture is not None:
                mix_hidden, mix_cache = bundle.apply(
                    mix_params, step_batch, cache=mix_cache,
                    cache_mode="decode")
                logits = mix_log_probs(
                    logits, bundle.logits_fn(mix_params, mix_hidden)[:, 0],
                    coef)
            next_token = sample_token(logits, sampling, generator)
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


def mix_log_probs(logits, mix_logits, coef: float) -> torch.Tensor:
    """The geometric mixture's logits over [B, V]: (1 - coef) *
    log_softmax(logits) + coef * log_softmax(mix_logits), in f32."""
    return ((1.0 - coef) * torch.log_softmax(logits.float(), dim=-1)
            + coef * torch.log_softmax(mix_logits.float(), dim=-1))
