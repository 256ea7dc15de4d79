"""Shared building blocks: norms, dense layers, RoPE, the attention oracle.

Counterpart of iadr1_tpu/models/common.py.  Kernels keep the JAX layout
[in, out]; matmuls take bf16 (or f32) inputs and accumulate in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch


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
    return table[ids]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype (HF semantics)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel ([in, out]) in x's dtype.  A bf16 GEMM accumulates in
    f32 inside cuBLAS and rounds once to bf16, as the JAX einsum with
    ``preferred_element_type=f32`` followed by a cast does."""
    out = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float):
    """Unscaled 1-D RoPE tables: [..., T] -> cos/sin [..., T, head_dim] f32
    in the rotate-half layout [f0..f_{d/2-1}, f0..f_{d/2-1}]."""
    inv = rope_inv_freq(head_dim, theta, position_ids.device)
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
