"""Qwen2 decoder (counterpart of iadr1_tpu/models/qwen2.py).

Parameters are a nested dict of tensors in the JAX package's layout:
layers stacked on axis 0, dense kernels [in, out].  The forward is a plain
function over that dict.  LoRA/DoRA, prefix-LM masks, MoE layers and
RoPE scaling are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def unstack_layers(tree, num_layers: int) -> list:
    """Every layer of a layer-stacked tree, as views from one ``unbind``
    per leaf: the backward then stacks each leaf's gradient once, where
    per-layer indexing would add a zero-padded full-size gradient per
    layer."""
    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        return t.unbind(0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    views = split(tree)
    return [pick(views, i) for i in range(num_layers)]


def ckpt(fn, *args):
    """``torch.utils.checkpoint`` as the remat modes use it: non-reentrant,
    and no RNG stash (nothing in the model draws random numbers)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def _qkv(cfg, x, a, cos, sin):
    """Normed hidden -> roped q, k and v [B, T, heads, D]."""
    B, T, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    q = dense(x, a["q"]["kernel"], a["q"].get("bias")).view(B, T, H, D)
    k = dense(x, a["k"]["kernel"], a["k"].get("bias")).view(B, T, Hkv, D)
    v = dense(x, a["v"]["kernel"], a["v"].get("bias")).view(B, T, Hkv, D)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _post_attention(cfg, h, out, lp):
    """Output projection, residual, then the MLP block."""
    B, T, _ = h.shape
    h = h + dense(out.reshape(B, T, -1), lp["attn"]["o"]["kernel"])
    x = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    m = lp["mlp"]
    gate = dense(x, m["gate"]["kernel"])
    up = dense(x, m["up"]["kernel"])
    return h + dense(F.silu(gate) * up, m["down"]["kernel"])


def _layer(cfg, h, lp, cos, sin, layer_cache, write_idx, attn,
           attend_fresh):
    x = rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, x, lp["attn"], cos, sin)
    if layer_cache is not None:
        T = h.shape[1]
        ck, cv = layer_cache                        # [B, Hkv, S, D] views
        # in place: the new K/V land in the caller's cache tensors
        ck[:, :, write_idx:write_idx + T] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, write_idx:write_idx + T] = v.transpose(1, 2).to(cv.dtype)
        if not attend_fresh:
            k, v = ck, cv                           # cache layout
    return _post_attention(cfg, h, attn(q, k, v), lp)


def _remat_layer(cfg, h, lp, cos, sin, attn, remat):
    """One training layer under a remat mode (no cache).

    "full" checkpoints the whole layer, so the backward re-runs the
    attention forward.  True / "save_flash" and "save_qkv" keep the
    attention call outside every checkpoint: the flash Function's saved
    (q, k, v, out, lse) survive and its forward never re-runs, the role of
    the JAX FLASH_REMAT_POLICY that saves "flash_out" and "flash_lse".
    The pieces before and after it are checkpointed apart.  "save_qkv"
    (the JAX FLASH_QKV_REMAT_POLICY, which also saves "act_qkv") keeps the
    q/k/v projections' outputs too, so the backward recomputes only the
    norm in front of them, not the three projections."""
    if remat == "full":
        return ckpt(lambda h: _layer(cfg, h, lp, cos, sin, None, None, attn,
                                     False), h)
    eps = cfg.rms_norm_eps
    if remat == "save_qkv":
        x = ckpt(lambda h: rms_norm(h, lp["input_norm"], eps), h)
        q, k, v = _qkv(cfg, x, lp["attn"], cos, sin)
    else:
        q, k, v = ckpt(lambda h: _qkv(cfg, rms_norm(h, lp["input_norm"], eps),
                                      lp["attn"], cos, sin), h)
    out = attn(q, k, v)
    return ckpt(lambda h, out: _post_attention(cfg, h, out, lp), h, out)


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
    remat=False,
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

    ``remat`` (training, no cache): False, True / "save_flash",
    "save_qkv" or "full", as in the JAX decoder; see ``_remat_layer``.
    """
    if remat and cache is not None:
        raise ValueError("remat is for training; it takes no cache")
    if remat not in (False, True, "save_flash", "save_qkv", "full"):
        raise ValueError(f"unknown remat mode {remat!r}")
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

    layers = unstack_layers(params["layers"], cfg.num_hidden_layers)
    for i, lp in enumerate(layers):
        if remat:
            h = _remat_layer(cfg, h, lp, cos, sin, attn, remat)
            continue
        layer_cache = ((cache["k"][i], cache["v"][i]) if cache is not None
                       else None)
        h = _layer(cfg, h, lp, cos, sin, layer_cache, write_idx, attn,
                   attend_fresh)
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
