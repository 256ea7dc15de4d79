"""Shared building blocks: norms, dense layers, RoPE, the attention oracle.

Counterpart of iadr1_tpu/models/common.py.  Kernels keep the JAX layout
[in, out]; matmuls take bf16 (or f32) inputs and accumulate in f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from iadr1_tpu_torch.core.tensor_parallel import tp_group
from iadr1_tpu_torch.models.quant import dequantize_kernel


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    scale = in_dim ** -0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    w.uniform_(-scale, scale, generator=gen)
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids``.  Under a tensor-parallel scope
    (``core/tensor_parallel.py``) ``table`` is this rank's slice of the
    vocabulary: the ids it holds are looked up, every other row is 0, and
    the all-reduce adds the ranks' rows (exactly one rank holds each)."""
    group = tp_group()
    if group is None:
        return table[ids]
    rows = table.shape[0]
    local = ids - group.rank * rows
    held = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * held[..., None].to(table.dtype)
    return group.all_reduce(out)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype (HF semantics).
    ``offset`` gives Gemma's norms: the scale is (offset + w), multiplied
    in f32 before the cast (GemmaRMSNorm's (1 + w), zero-initialised)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (scale.float() + offset)).to(dtype)


def dense(x: torch.Tensor, kernel,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel ([in, out]) in x's dtype.  A bf16 GEMM accumulates in
    f32 inside cuBLAS and rounds once to bf16, as the JAX einsum with
    ``preferred_element_type=f32`` followed by a cast does.

    ``kernel`` may be a weight-only quant dict (``models/quant.py``): it
    is dequantized to x's dtype first, in plain PyTorch, as the JAX dense
    does outside any Pallas kernel."""
    if isinstance(kernel, dict):
        kernel = dequantize_kernel(kernel, x.dtype)
    out = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def scaled_rope_inv_freq(head_dim: int, theta: float, scaling, device,
                         seq_len: torch.Tensor | None = None) -> torch.Tensor:
    """Context-extension inverse frequencies (the JAX
    ``scaled_rope_inv_freq``, transformers' ``ROPE_INIT_FUNCTIONS``):
    linear divides every frequency by the factor; dynamic NTK grows the
    base with the running length ``seq_len`` (a 0-d tensor, never below
    the original maximum); llama3 scales each frequency by its wavelength
    between the low and high bands.  ``scaling`` None: unscaled."""
    inv = rope_inv_freq(head_dim, theta, device)
    if scaling is None:
        return inv
    factor = scaling.factor
    if scaling.type == "linear":
        return inv / factor
    if scaling.type == "dynamic":
        orig = float(scaling.original_max_position_embeddings)
        eff = (torch.tensor(orig, device=device) if seq_len is None
               else seq_len.float().clamp(min=orig))
        base = theta * ((factor * eff / orig) - (factor - 1.0)) ** (
            head_dim / (head_dim - 2))
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        return 1.0 / (base ** exps)
    if scaling.type == "llama3":
        orig = scaling.original_max_position_embeddings
        low, high = scaling.low_freq_factor, scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv
        smooth = (orig / wavelen - low) / (high - low)
        mid = (1.0 - smooth) * inv / factor + smooth * inv
        return torch.where(wavelen > orig / low, inv / factor,
                           torch.where(wavelen < orig / high, inv, mid))
    raise ValueError(f"unknown rope scaling type {scaling.type!r}")


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                 scaling=None):
    """1-D RoPE tables: [..., T] -> cos/sin [..., T, head_dim] f32 in the
    rotate-half layout [f0..f_{d/2-1}, f0..f_{d/2-1}].  ``scaling`` (a
    ``qwen2.RopeScaling``) extends the context; dynamic NTK reads the
    running length as the largest position + 1, on the device."""
    seq_len = position_ids.max() + 1 if scaling is not None else None
    inv = scaled_rope_inv_freq(head_dim, theta, scaling, position_ids.device,
                               seq_len)
    freqs = position_ids.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]):
    """M-RoPE (Qwen2-VL): positions [3, B, T] -> cos/sin [B, T, head_dim];
    ``sections`` frequency pairs come from the t, h and w axes in turn."""
    inv = rope_inv_freq(head_dim, theta, position_ids.device)
    freqs = position_ids.float()[..., None] * inv          # [3, B, T, d/2]
    splits, start = [], 0
    for axis, sec in enumerate(sections):
        splits.append(freqs[axis, ..., start:start + sec])
        start += sec
    half = torch.cat(splits, dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q/k [B, T, H, D]; cos/sin [B, T, D] (cast to q's dtype first, as
    the JAX decoder does)."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def make_attention_mask(q_segment_ids, kv_segment_ids, q_positions,
                        kv_positions, causal: bool):
    """Boolean [B, 1, T, S] mask, True = attend; segment 0 is padding."""
    mask = None
    if q_segment_ids is not None:
        seg = ((q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
               & (kv_segment_ids[:, None, :] != 0))
        mask = seg[:, None]
    if causal:
        cm = (q_positions[:, :, None] >= kv_positions[:, None, :])[:, None]
        mask = cm if mask is None else (mask & cm)
    return mask


def xla_attention(q, k, v, mask, scale: float | None = None):
    """Plain masked attention with GQA: q [B,T,H,D], k/v [B,S,Hkv,D].

    The oracle the kernel twins are held to (softmax in f32).  Like the
    JAX oracle, a row with no valid key gets a uniform softmax."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = scores.softmax(-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)
