"""Qwen2 decoder (counterpart of iadr1_tpu/models/qwen2.py).

Parameters are a nested dict of tensors in the JAX package's layout:
layers stacked on axis 0, dense kernels [in, out].  The forward is a plain
function over that dict.  LoRA/DoRA, prefix-LM masks, remat, MoE layers and
RoPE scaling are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common
from iadr1_tpu_torch.models.common import (
    apply_rope,
    dense,
    make_attention_mask,
    mrope_cos_sin,
    rms_norm,
    rope_cos_sin,
    xla_attention,
)


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int | None = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = True
    mrope_section: tuple[int, ...] | None = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def init_params(gen: torch.Generator, cfg: Qwen2Config, dtype, device) -> dict:
    """Random init with the JAX package's structure (biases zero, norms
    one), drawn from ``gen`` on ``device``."""
    L = cfg.num_hidden_layers
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    hid, mlp = cfg.hidden_size, cfg.intermediate_size

    def stack(i, o):
        return torch.stack([common.dense_init(gen, i, o, dtype, device)
                            for _ in range(L)])

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    params = {
        "embed": {"weight": common.embed_init(gen, cfg.vocab_size, hid,
                                              dtype, device)},
        "layers": {
            "input_norm": full((L, hid), 1.0),
            "post_attn_norm": full((L, hid), 1.0),
            "attn": {
                "q": {"kernel": stack(hid, H * D)},
                "k": {"kernel": stack(hid, Hkv * D)},
                "v": {"kernel": stack(hid, Hkv * D)},
                "o": {"kernel": stack(H * D, hid)},
            },
            "mlp": {
                "gate": {"kernel": stack(hid, mlp)},
                "up": {"kernel": stack(hid, mlp)},
                "down": {"kernel": stack(mlp, hid)},
            },
        },
        "final_norm": full((hid,), 1.0),
    }
    if cfg.attention_bias:
        attn = params["layers"]["attn"]
        attn["q"]["bias"] = full((L, H * D), 0.0)
        attn["k"]["bias"] = full((L, Hkv * D), 0.0)
        attn["v"]["bias"] = full((L, Hkv * D), 0.0)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": common.dense_init(
            gen, hid, cfg.vocab_size, dtype, device)}
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype,
               device) -> dict:
    """Static KV cache, layout [L, B, Hkv, S, D]; ``write_idx`` (a host
    int, shared by the batch: prompts are left-padded) is the next slot.
    ``apply`` writes into it in place."""
    L = cfg.num_hidden_layers
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    return {
        "k": torch.zeros((L, batch, Hkv, max_len, D), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, Hkv, max_len, D), dtype=dtype, device=device),
        "segment_ids": torch.zeros((batch, max_len), dtype=torch.int32,
                                   device=device),
        "write_idx": 0,
    }


def _layer(cfg, h, lp, cos, sin, layer_cache, write_idx, attn,
           attend_fresh):
    B, T, _ = h.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    a = lp["attn"]
    x = rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
    q = dense(x, a["q"]["kernel"], a["q"].get("bias")).view(B, T, H, D)
    k = dense(x, a["k"]["kernel"], a["k"].get("bias")).view(B, T, Hkv, D)
    v = dense(x, a["v"]["kernel"], a["v"].get("bias")).view(B, T, Hkv, D)
    q, k = apply_rope(q, k, cos, sin)
    if layer_cache is not None:
        ck, cv = layer_cache                        # [B, Hkv, S, D] views
        # in place: the new K/V land in the caller's cache tensors
        ck[:, :, write_idx:write_idx + T] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, write_idx:write_idx + T] = v.transpose(1, 2).to(cv.dtype)
        if not attend_fresh:
            k, v = ck, cv                           # cache layout
    out = attn(q, k, v)
    h = h + dense(out.reshape(B, T, H * D), a["o"]["kernel"])
    x = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    m = lp["mlp"]
    gate = dense(x, m["gate"]["kernel"])
    up = dense(x, m["up"]["kernel"])
    return h + dense(F.silu(gate) * up, m["down"]["kernel"])


def apply(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor | None = None,
    *,
    inputs_embeds: torch.Tensor | None = None,
    position_ids: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    cache: dict | None = None,
    cache_mode: str = "extend",
    precision: Precision = DEFAULT_PRECISION,
    attention_fn: Callable | None = None,
    decode_attention_fn: Callable | None = None,
):
    """Run the decoder; returns (hidden [B, T, hid], cache).

    ``position_ids`` is [B, T], or [3, B, T] for M-RoPE.  ``segment_ids``
    [B, T] are packing segments (0 = padding).  Causality is by sequence /
    cache-slot order, never by position value (M-RoPE repeats positions,
    packed segments restart them).  With a cache, ``cache_mode`` is
    "prefill" (empty cache: attend the fresh block, through
    ``attention_fn``), "decode" (one token, through ``decode_attention_fn``
    over the valid prefix) or "extend" (dense mask over the whole cache).
    The cache is updated in place and returned.
    """
    if inputs_embeds is None:
        inputs_embeds = common.embed_lookup(params["embed"]["weight"], input_ids)
    h = inputs_embeds.to(precision.compute_dtype)
    B, T, _ = h.shape
    device = h.device

    if cfg.mrope_section is not None:
        if position_ids.dim() == 2:     # text only: all three axes agree
            position_ids = position_ids.expand(3, B, T)
        cos, sin = mrope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta,
                                 cfg.mrope_section)
    else:
        cos, sin = rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta)

    if segment_ids is None:
        segment_ids = torch.ones((B, T), dtype=torch.int32, device=device)
    segment_ids = segment_ids.to(torch.int32)
    q_index = torch.arange(T, device=device).expand(B, T)

    def fresh_attention():
        mask = make_attention_mask(segment_ids, segment_ids, q_index, q_index,
                                   causal=True)
        if attention_fn is None:
            return lambda q, k, v: xla_attention(q, k, v, mask)
        return functools.partial(attention_fn, mask=mask,
                                 q_segments=segment_ids,
                                 kv_segments=segment_ids, causal=True)

    write_idx, attend_fresh = None, False
    if cache is not None:
        write_idx = cache["write_idx"]
        S = cache["segment_ids"].shape[1]
        if write_idx + T > S:
            raise ValueError(f"cache overflow: {write_idx} + {T} > {S}")
        cache["segment_ids"][:, write_idx:write_idx + T] = segment_ids
        kv_segments = cache["segment_ids"]
        if cache_mode == "prefill":
            if write_idx != 0:
                raise ValueError("prefill needs an empty cache")
            attend_fresh = True
            attn = fresh_attention()
        elif cache_mode == "decode" and decode_attention_fn is not None:
            length = write_idx + T
            attn = lambda q, ck, cv: decode_attention_fn(
                q, ck, cv, kv_segments, length)
        else:
            kv_index = torch.arange(S, device=device).expand(B, S)
            mask = make_attention_mask(segment_ids, kv_segments,
                                       q_index + write_idx, kv_index,
                                       causal=True)
            attn = lambda q, ck, cv: xla_attention(
                q, ck.transpose(1, 2).to(q.dtype),
                cv.transpose(1, 2).to(q.dtype), mask)
    else:
        attn = fresh_attention()

    for i in range(cfg.num_hidden_layers):
        layer_cache = ((cache["k"][i], cache["v"][i]) if cache is not None
                       else None)
        h = _layer(cfg, h, layer_slice(params["layers"], i), cos, sin,
                   layer_cache, write_idx, attn, attend_fresh)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if cache is not None:
        cache["write_idx"] = write_idx + T
    return h, cache


def head_kernel(params: dict, cfg: Qwen2Config) -> torch.Tensor:
    """[hidden, vocab] LM-head kernel (tied or untied)."""
    if cfg.tie_word_embeddings:
        return params["embed"]["weight"].T
    return params["lm_head"]["kernel"]


def logits(params: dict, cfg: Qwen2Config, hidden: torch.Tensor,
           precision: Precision = DEFAULT_PRECISION) -> torch.Tensor:
    """LM head in ``precision.logits_dtype``: the inputs are upcast, so a
    bf16 model's logits carry the full f32 sum, as in the JAX head."""
    dt = precision.logits_dtype
    return torch.matmul(hidden.to(dt), head_kernel(params, cfg).to(dt))
