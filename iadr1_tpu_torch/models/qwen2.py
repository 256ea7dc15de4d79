"""Qwen2 decoder (counterpart of iadr1_tpu/models/qwen2.py).

Parameters are a nested dict of tensors in the JAX package's layout:
layers stacked on axis 0, dense kernels [in, out].  The forward is a plain
function over that dict.  Any dense kernel may be a weight-only quant
dict (``models/quant.py``), and ``apply(..., lora=...)`` adds factored
LoRA / DoRA adapters (``lora_dense``) without ever forming the merged
weight.  The Gemma knobs (PaliGemma's decoder), the prefix-LM mask,
RoPE scaling and the MLP hook that the sparse-MoE decoder
(``models/qwen2_moe.py``) plugs into are here too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from iadr1_tpu_torch.core.mesh import compute_view, full
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.core.tensor_parallel import tp_group, tp_sum
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
from iadr1_tpu_torch.models.quant import dequantize_kernel


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Context-extension RoPE scaling (transformers' ``rope_scaling``
    dict; types linear, dynamic and llama3): the tables of
    ``common.scaled_rope_inv_freq``."""
    type: str = "linear"
    factor: float = 1.0
    original_max_position_embeddings: int = 32768
    low_freq_factor: float = 1.0      # llama3 only
    high_freq_factor: float = 4.0     # llama3 only


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
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True
    mrope_section: tuple[int, ...] | None = None
    rope_scaling: RopeScaling | None = None       # 1-D RoPE only
    # Gemma's knobs (PaliGemma's decoder, HF modeling_gemma): norms scale
    # by (offset + w) with zero-initialised weights, the MLP's gate takes
    # gelu_pytorch_tanh, and the input embeddings are scaled by
    # sqrt(hidden) inside the decoder
    rms_norm_offset: float = 0.0
    hidden_act: str = "silu"
    scale_embeds: bool = False

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

    # Gemma's norms add their offset, so their weights start at zero
    norm_fill = 0.0 if cfg.rms_norm_offset else 1.0
    params = {
        "embed": {"weight": common.embed_init(gen, cfg.vocab_size, hid,
                                              dtype, device)},
        "layers": {
            "input_norm": full((L, hid), norm_fill),
            "post_attn_norm": full((L, hid), norm_fill),
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
        "final_norm": full((hid,), norm_fill),
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
    layer.  Quant dicts and LoRA factors split field by field; the None
    leaves of a LoRA tree stay None."""
    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        return None if t is None else t.unbind(0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return None if t is None else t[i]

    views = split(tree)
    return [pick(views, i) for i in range(num_layers)]


def ckpt(fn, *args):
    """``torch.utils.checkpoint`` as the remat modes use it: non-reentrant,
    and no RNG stash (nothing in the model draws random numbers)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def init_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype,
               device, kv_heads: int | None = None) -> dict:
    """Static KV cache, layout [L, B, Hkv, S, D]; ``write_idx`` (a host
    int, shared by the batch: prompts are left-padded) is the next slot.
    ``apply`` writes into it in place.  ``kv_heads``: a tp rank's own KV
    heads (``train/rollout.py tp_local_params``), the config's count by
    default."""
    L = cfg.num_hidden_layers
    Hkv, D = kv_heads or cfg.num_key_value_heads, cfg.head_dim_
    return {
        "k": torch.zeros((L, batch, Hkv, max_len, D), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, Hkv, max_len, D), dtype=dtype, device=device),
        "segment_ids": torch.zeros((batch, max_len), dtype=torch.int32,
                                   device=device),
        "write_idx": 0,
    }


def lora_dense(x, kernel, bias, ab, scale: float):
    """``dense`` plus a factored LoRA delta: y += scale * (x @ A) @ B (the
    JAX ``_lora_dense``).  The merged [in, out] weight is never formed, so
    the backward's cotangents stay activation-shaped.

    DoRA (``ab["m"]`` present) rescales the output column by column by
    m / ||W + scale * A @ B||_col, the norms computed factored
    (||W_j||^2 + 2s (W^T A B)_jj + s^2 (B^T A^T A B)_jj) from an [out, r]
    and an [r, r] product, in f32.  The norm is detached, as peft and the
    JAX decoder detach it: gradients reach m, A and B through the
    numerator only.  The bias is added last."""
    y = dense(x, kernel)
    if ab is not None:
        xa = torch.matmul(x, ab["a"].to(x.dtype))
        y = y + scale * torch.matmul(xa, ab["b"].to(x.dtype))
        if "m" in ab:
            y = y * (ab["m"].float() / _dora_norm(kernel, ab, scale)
                     ).to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


@torch.no_grad()
def dora_norm_sums(kernel, ab, scale: float) -> torch.Tensor:
    """The three sums over the rows that ||W + scale * A @ B||^2 per
    output column is made of, [3, out] f32: ||W_j||^2, (W^T A B)_jj and
    (B^T A^T A B)_jj.  Additive over row shards: a tp rank's rows give its
    partial sums."""
    k32 = (dequantize_kernel(kernel) if isinstance(kernel, dict)
           else kernel.float())
    a32, b32 = ab["a"].float(), ab["b"].float()
    return torch.stack([(k32 * k32).sum(dim=-2),
                        ((k32.transpose(-1, -2) @ a32)
                         * b32.transpose(-1, -2)).sum(dim=-1),
                        ((a32.transpose(-1, -2) @ a32 @ b32) * b32).sum(
                            dim=-2)])


def dora_norm_from_sums(sums: torch.Tensor, scale: float) -> torch.Tensor:
    """||W + scale * A @ B|| per output column from ``dora_norm_sums``."""
    return torch.sqrt(sums[0] + 2.0 * scale * sums[1]
                      + scale * scale * sums[2] + 1e-12)


@torch.no_grad()
def _dora_norm(kernel, ab, scale: float) -> torch.Tensor:
    """||W + scale * A @ B|| per output column [out], f32, factored; a
    rollout copy's fixed norms where it has them (``train/rollout.py
    tp_local_lora``)."""
    if "norm" in ab:
        return ab["norm"]
    return dora_norm_from_sums(dora_norm_sums(kernel, ab, scale), scale)


def _ab(ll, *path):
    """The adapter at ``path`` of a layer's LoRA tree, or None."""
    for key in path:
        if ll is None:
            return None
        ll = ll.get(key)
    return ll


def _qkv(cfg, x, a, cos, sin, ll=None, scale: float = 1.0):
    """Normed hidden -> roped q, k and v [B, T, heads, D]; ``ll`` is the
    layer's LoRA tree (or None) and ``scale`` its scale."""
    B, T, _ = x.shape
    D = cfg.head_dim_

    def proj(name):
        # the heads this call holds: every head, or a tp rank's own
        y = lora_dense(x, a[name]["kernel"], a[name].get("bias"),
                       _ab(ll, "attn", name, "kernel"), scale)
        return y.view(B, T, y.shape[-1] // D, D)

    q, k, v = proj("q"), proj("k"), proj("v")
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


_ACTIVATIONS = {
    "silu": F.silu,
    # HF ACT2FN["gelu_pytorch_tanh"] (Gemma's MLPs)
    "gelu_pytorch_tanh": functools.partial(F.gelu, approximate="tanh"),
    "gelu": F.gelu,
}


def mlp_activation(cfg):
    try:
        return _ACTIVATIONS[cfg.hidden_act]
    except KeyError:
        raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}") from None


def norm(cfg, x, scale):
    """The decoder's RMSNorm, with Gemma's offset where the config has it."""
    return rms_norm(x, scale, cfg.rms_norm_eps, cfg.rms_norm_offset)


def dense_mlp(cfg, x, mp, ml, scale: float = 1.0):
    """The dense gated MLP over a layer's ``mp`` = params["mlp"] (and its
    LoRA subtree ``ml``); returns (out, None): no auxiliary output."""
    def proj(x, name):
        return lora_dense(x, mp[name]["kernel"], None,
                          _ab(ml, name, "kernel"), scale)

    return proj(mlp_activation(cfg)(proj(x, "gate")) * proj(x, "up"),
                "down"), None


def _attn_out_mlp(cfg, h, out, lp, ll, scale: float, mlp):
    """Output projection, residual, then the MLP block ``mlp(x, params,
    lora, scale) -> (out, aux)`` (``dense_mlp`` for None); returns (h,
    aux).  Under a tensor-parallel scope the two row-parallel products
    (o and the MLP's down) are partial sums, each completed by one
    all-reduce (``tp_sum``)."""
    B, T, _ = h.shape
    h = h + tp_sum(lora_dense(out.reshape(B, T, -1),
                              lp["attn"]["o"]["kernel"], None,
                              _ab(ll, "attn", "o", "kernel"), scale))
    x = norm(cfg, h, lp["post_attn_norm"])
    y, aux = (mlp or functools.partial(dense_mlp, cfg))(
        x, lp["mlp"], _ab(ll, "mlp"), scale)
    return h + tp_sum(y), aux


def _post_attention(cfg, h, out, lp, ll=None, scale: float = 1.0):
    """Output projection, residual, then the dense MLP block."""
    return _attn_out_mlp(cfg, h, out, lp, ll, scale, None)[0]


def _layer(cfg, h, lp, cos, sin, layer_cache, write_idx, attn,
           attend_fresh, ll=None, scale: float = 1.0, mlp=None):
    """One decoder layer; returns (h, the MLP hook's aux or None).  On a
    mesh ``lp`` and its adapters ``ll`` are the layer's shards, gathered
    here (``compute_view``)."""
    lp, ll = compute_view(lp), compute_view(ll)
    x = norm(cfg, h, lp["input_norm"])
    q, k, v = _qkv(cfg, x, lp["attn"], cos, sin, ll, scale)
    if layer_cache is not None:
        T = h.shape[1]
        ck, cv = layer_cache                        # [B, Hkv, S, D] views
        # in place: the new K/V land in the caller's cache tensors (whole
        # on each rank when they are DTensors: the decode wrapper reads a
        # rank's heads from it)
        ck[:, :, write_idx:write_idx + T] = full(k).transpose(1, 2).to(
            ck.dtype)
        cv[:, :, write_idx:write_idx + T] = full(v).transpose(1, 2).to(
            cv.dtype)
        if not attend_fresh:
            k, v = ck, cv                           # cache layout
    return _attn_out_mlp(cfg, h, attn(q, k, v), lp, ll, scale, mlp)


def _remat_layer(cfg, h, lp, cos, sin, attn, remat, ll=None,
                 scale: float = 1.0, mlp=None):
    """One training layer under a remat mode (no cache); returns (h, aux)
    as ``_layer``.

    "full" checkpoints the whole layer, so the backward re-runs the
    attention forward.  True / "save_flash" and "save_qkv" keep the
    attention call outside every checkpoint: the flash Function's saved
    (q, k, v, out, lse) survive and its forward never re-runs, the role of
    the JAX FLASH_REMAT_POLICY that saves "flash_out" and "flash_lse".
    The pieces before and after it are checkpointed apart.  "save_qkv"
    (the JAX FLASH_QKV_REMAT_POLICY, which also saves "act_qkv") keeps the
    q/k/v projections' outputs too, so the backward recomputes only the
    norm in front of them, not the three projections.

    On a mesh ``lp`` (and its adapters ``ll``) is the layer's shards: each
    checkpointed piece gathers what it reads (``compute_view``) inside its
    checkpoint, so a layer's whole weights live only while it runs,
    forward and replay (FSDP's per-layer gather); "save_qkv" keeps the
    q/k/v projections' gathered weights for their backward."""
    if remat == "full":
        return ckpt(lambda h: _layer(cfg, h, lp, cos, sin, None, None, attn,
                                     False, ll, scale, mlp), h)
    if remat == "save_qkv":
        x = ckpt(lambda h: norm(cfg, h, compute_view(lp["input_norm"])), h)
        q, k, v = _qkv(cfg, x, compute_view(lp["attn"]), cos, sin,
                       compute_view(ll), scale)
    else:
        q, k, v = ckpt(lambda h: _qkv(
            cfg, norm(cfg, h, compute_view(lp["input_norm"])),
            compute_view(lp["attn"]), cos, sin, compute_view(ll), scale), h)
    out = attn(q, k, v)
    return ckpt(lambda h, out: _attn_out_mlp(
        cfg, h, out, compute_view(lp), compute_view(ll), scale, mlp), h, out)


def _or_bidirectional(mask, q_segments, kv_segments, kv_bidir):
    """Unmask the [q, kv] pairs whose key slot carries a prefix-LM flag
    (same segment, not padding) on top of a [B, 1, T, S] causal mask (the
    JAX ``_or_bidirectional``)."""
    seg = ((q_segments[:, :, None] == kv_segments[:, None, :])
           & (kv_segments[:, None, :] != 0))
    return mask | (seg[:, None] & (kv_bidir[:, None, None, :] != 0))


def prefix_lm_attention(mask, remat=False):
    """PaliGemma's prefix-LM attention: the dense masked attention
    (``xla_attention``) over the [B, 1, T, S] mask, where the JAX decoder
    also runs its dense XLA attention (the flash kernels take segments and
    causality, not an arbitrary mask).  It runs one batch row at a time,
    so its f32 scores are one row's; in training under a remat mode each
    row sits in its own checkpoint, and the backward recomputes one row's
    scores at a time.  Chosen by the mask, never by a failure."""
    def attn(q, k, v):
        rows = []
        for b in range(q.shape[0]):
            args = (q[b:b + 1], k[b:b + 1], v[b:b + 1], mask[b:b + 1])
            if remat and torch.is_grad_enabled():
                rows.append(ckpt(xla_attention, *args))
            else:
                rows.append(xla_attention(*args))
        return torch.cat(rows)

    return attn


def apply(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor | None = None,
    *,
    inputs_embeds: torch.Tensor | None = None,
    position_ids: torch.Tensor,
    segment_ids: torch.Tensor | None = None,
    bidirectional_mask: torch.Tensor | None = None,
    cache: dict | None = None,
    cache_mode: str = "extend",
    precision: Precision = DEFAULT_PRECISION,
    attention_fn: Callable | None = None,
    decode_attention_fn: Callable | None = None,
    remat=False,
    lora: dict | None = None,
    lora_scale: float = 1.0,
    mlp_fn: Callable | None = None,
    return_aux: bool = False,
):
    """Run the decoder; returns (hidden [B, T, hid], cache), or (hidden,
    cache, aux) with ``return_aux``.

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

    ``lora``: an adapter tree parallel to ``params`` (``train/adapters.py
    init_lora_params``; its "layers" subtree is read), applied factored
    with ``lora_scale`` on every path, cached decoding included.

    ``bidirectional_mask`` [B, T]: prefix-LM flags of the fresh block
    (PaliGemma): every query may also attend a flagged key of its segment
    that lies ahead of it.  With no cache, in "prefill" and in "extend"
    (whose flags go into a fresh [B, S] row over the cache's slots at the
    block's place) such a mask runs ``prefix_lm_attention``; "decode"
    ignores it (a new token attends the valid cache prefix causally, which
    is exact) and keeps K4.

    ``mlp_fn(cfg, x, mlp_params, mlp_lora, scale, segment_ids) -> (out,
    aux)`` replaces every layer's dense MLP (the JAX ``layer_fn`` hook,
    taken at the MLP: the sparse-MoE block), in every cache mode and remat
    mode; ``aux`` is the sum of its per-layer aux over the layers (None
    for the dense MLP).

    RoPE scaling (``cfg.rope_scaling``) applies to 1-D RoPE.  A
    training-only attention (LongLoRA's, ``models/attention.py``) refuses
    a cache.
    """
    if cache is not None and getattr(attention_fn, "training_only", False):
        raise ValueError("LongLoRA's shift-short attention is for training "
                         "only: a cached prefill or decode takes the plain "
                         "attention")
    if remat and cache is not None:
        raise ValueError("remat is for training; it takes no cache")
    if remat not in (False, True, "save_flash", "save_qkv", "full"):
        raise ValueError(f"unknown remat mode {remat!r}")
    if inputs_embeds is None:
        inputs_embeds = common.embed_lookup(params["embed"]["weight"], input_ids)
    h = inputs_embeds.to(precision.compute_dtype)
    if cfg.scale_embeds:
        # Gemma scales the embeddings by sqrt(hidden) inside the decoder,
        # after any VLM feature merge; the factor is rounded to the compute
        # dtype first, as the JAX decoder's jnp.asarray(.., h.dtype)
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype)
    B, T, _ = h.shape
    device = h.device

    if cfg.mrope_section is not None:
        if position_ids.dim() == 2:     # text only: all three axes agree
            position_ids = position_ids.expand(3, B, T)
        cos, sin = mrope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta,
                                 cfg.mrope_section)
    else:
        cos, sin = rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta,
                                cfg.rope_scaling)

    if segment_ids is None:
        segment_ids = torch.ones((B, T), dtype=torch.int32, device=device)
    segment_ids = segment_ids.to(torch.int32)
    q_index = torch.arange(T, device=device).expand(B, T)

    def fresh_attention():
        mask = make_attention_mask(segment_ids, segment_ids, q_index, q_index,
                                   causal=True)
        if bidirectional_mask is not None:
            return prefix_lm_attention(_or_bidirectional(
                mask, segment_ids, segment_ids, bidirectional_mask), remat)
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
            dense = lambda q, k, v: xla_attention(q, k, v, mask)
            if bidirectional_mask is not None:
                kv_bidir = torch.zeros((B, S), dtype=torch.int32,
                                       device=device)
                kv_bidir[:, write_idx:write_idx + T] = bidirectional_mask
                dense = prefix_lm_attention(_or_bidirectional(
                    mask, segment_ids, kv_segments, kv_bidir))
            attn = lambda q, ck, cv: dense(
                q, ck.transpose(1, 2).to(q.dtype),
                cv.transpose(1, 2).to(q.dtype))
    else:
        attn = fresh_attention()

    L = cfg.num_hidden_layers
    layers = unstack_layers(params["layers"], L)
    layer_loras = (unstack_layers(lora.get("layers", lora), L)
                   if lora is not None else [None] * L)
    mlp = (functools.partial(mlp_fn, cfg, segment_ids=segment_ids)
           if mlp_fn is not None else None)
    aux_total = None
    for i, (lp, ll) in enumerate(zip(layers, layer_loras)):
        if remat:
            h, aux = _remat_layer(cfg, h, lp, cos, sin, attn, remat, ll,
                                  lora_scale, mlp)
        else:
            layer_cache = ((cache["k"][i], cache["v"][i])
                           if cache is not None else None)
            h, aux = _layer(cfg, h, lp, cos, sin, layer_cache, write_idx,
                            attn, attend_fresh, ll, lora_scale, mlp)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    h = norm(cfg, h, params["final_norm"])
    if cache is not None:
        cache["write_idx"] = write_idx + T
    if return_aux:
        return h, cache, aux_total
    return h, cache


def head_kernel(params: dict, cfg: Qwen2Config) -> torch.Tensor:
    """[hidden, vocab] LM-head kernel (tied or untied)."""
    if cfg.tie_word_embeddings:
        return params["embed"]["weight"].T
    return params["lm_head"]["kernel"]


def logits(params: dict, cfg: Qwen2Config, hidden: torch.Tensor,
           precision: Precision = DEFAULT_PRECISION) -> torch.Tensor:
    """LM head in ``precision.logits_dtype``: the kernel is cast to the
    hidden dtype first (the JAX einsum's operand cast), then both inputs
    are upcast, so a bf16 model's logits carry the full f32 sum of the
    bf16 products, as in the JAX head and the chunked CE's
    (``train/sft.py`` ``chunk_logits``)."""
    dt = precision.logits_dtype
    out = torch.matmul(hidden.to(dt),
                       head_kernel(params, cfg).to(hidden.dtype).to(dt))
    group = tp_group()
    if group is None:
        return out
    # a tp rank's head is its vocabulary share, padded to ceil(V / tp)
    # columns (``train/rollout.py tp_local_params``): the ranks' columns
    # joined, the padding trimmed
    out = group.all_gather(out, dim=-1)
    V = cfg.vocab_size
    if out.shape[-1] > V and out.shape[-1] == group.size * -(-V // group.size):
        out = out[..., :V]
    return out


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: Qwen2Config) -> dict:
    """Logical-axis tuples parallel to ``init_params`` (the JAX
    ``logical_axes``); stacked layer leaves carry a leading None (the
    layer axis is never sharded)."""
    axes = {
        "embed": {"weight": ("vocab", "embed")},
        "layers": {
            "input_norm": (None, "norm"),
            "post_attn_norm": (None, "norm"),
            "attn": {
                "q": {"kernel": (None, "embed", "heads")},
                "k": {"kernel": (None, "embed", "heads")},
                "v": {"kernel": (None, "embed", "heads")},
                "o": {"kernel": (None, "heads", "embed")},
            },
            "mlp": {
                "gate": {"kernel": (None, "embed", "mlp")},
                "up": {"kernel": (None, "embed", "mlp")},
                "down": {"kernel": (None, "mlp", "embed")},
            },
        },
        "final_norm": ("norm",),
    }
    if cfg.attention_bias:
        for name in ("q", "k", "v"):
            axes["layers"]["attn"][name]["bias"] = (None, "heads")
    if not cfg.tie_word_embeddings:
        axes["lm_head"] = {"kernel": ("embed", "vocab")}
    return axes
