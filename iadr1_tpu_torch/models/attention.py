"""Attention dispatch (counterpart of iadr1_tpu/models/attention.py).

All implementations share one signature:

    attn(q, k, v, *, mask, q_segments, kv_segments, causal) -> out

with q [B, T, H, D] and k/v [B, S, Hkv, D]; ``mask`` is the boolean
[B, 1, T, S] mask the oracle path reads, segments + causal feed the kernel.
The kernel wrappers pick by the tensors' device: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors.  ``flash_attn`` goes through
the flash autograd Function, so training gradients flow through K1's
backward (K2, K3) on the card.

A second dispatch returns the logsumexp too, for callers that compose
partial attentions (GRPO's shared-prompt update):

    attn(q, k, v, *, mask, q_segments, kv_segments, causal) -> (out, lse)

in the kernel layout, q/out [B, H, T, D], k/v [B, Hkv, S, D], lse
[B, H, T] f32, differentiable through both outputs.
"""

from __future__ import annotations

import torch

from iadr1_tpu_torch.kernels.decode_attention import decode_attention
from iadr1_tpu_torch.kernels.flash_attention import flash_attention
from iadr1_tpu_torch.models.common import make_attention_mask, xla_attention
from iadr1_tpu_torch.models.shared_prompt import attention_with_lse_xla


def xla_attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
             causal=True):
    return xla_attention(q, k, v, mask)


def flash_attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
               causal=True):
    out, _ = flash_attention(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        segment_ids=q_segments, kv_segment_ids=kv_segments, causal=causal,
    )
    return out.transpose(1, 2)


def make_longlora_attention(inner, group_size_ratio: float = 0.25):
    """LongLoRA's shift-short (S^2) attention over ``inner`` (the JAX
    ``make_longlora_attention``): the sequence splits into groups of g =
    T * ratio; the first half of the heads attends within each group, the
    second half within groups shifted by g / 2 (its q, k, v and segment
    ids rolled by -g / 2, its output rolled back), so that adjacent groups
    exchange information.  Each half is one call of ``inner`` on the
    [B * T / g, g, heads / 2, D] views, block-diagonal by construction;
    the KV heads split by halves too, so GQA is kept.  Over ``flash_attn``
    each half is a K1 call (K2 and K3 in the backward) through the flash
    Function, outside any checkpoint under every remat mode.  Training
    only (``training_only``): the decoder refuses it with a cache."""

    def grouped(x, g):
        B, T = x.shape[:2]
        return x.reshape((B * (T // g), g) + x.shape[2:])

    def attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
             causal=True):
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        g = int(T * group_size_ratio)
        if g <= 0 or T % g != 0 or H % 2 != 0 or Hkv % 2 != 0:
            raise ValueError(
                f"LongLoRA needs T divisible by group ({T} % {g}) and even "
                f"head counts (H={H}, Hkv={Hkv})")
        half, half_kv = H // 2, Hkv // 2
        segs = q_segments
        if segs is None:
            segs = torch.ones((B, T), dtype=torch.int32, device=q.device)

        def run(qh, kh, vh, sh):
            sg = grouped(sh, g)
            idx = torch.arange(g, device=q.device).expand(sg.shape)
            group_mask = make_attention_mask(sg, sg, idx, idx, causal=causal)
            return inner(grouped(qh, g), grouped(kh, g), grouped(vh, g),
                         mask=group_mask, q_segments=sg, kv_segments=sg,
                         causal=causal)

        def roll(x):
            return torch.roll(x, -(g // 2), dims=1)

        out1 = run(q[:, :, :half], k[:, :, :half_kv], v[:, :, :half_kv],
                   segs)
        out2 = run(roll(q[:, :, half:]), roll(k[:, :, half_kv:]),
                   roll(v[:, :, half_kv:]), roll(segs))
        out1 = out1.reshape((B, T) + out1.shape[2:])
        out2 = torch.roll(out2.reshape((B, T) + out2.shape[2:]), g // 2,
                          dims=1)
        return torch.cat([out1, out2], dim=2)

    attn.training_only = True
    return attn


def default_attention(kind: str = "auto"):
    """'flash' | 'auto' (the K1 wrapper: kernel on CUDA, twin on CPU),
    'xla' (the dense masked oracle), or 'longlora[_flash|_xla]' (LongLoRA's
    shift-short attention over the one named, training only)."""
    if kind in ("auto", "flash"):
        return flash_attn
    if kind == "xla":
        return xla_attn
    if kind.startswith("longlora"):
        _, _, inner = kind.partition("_")
        return make_longlora_attention(default_attention(inner or "auto"))
    raise ValueError(f"unknown attention kind {kind!r}")


def tower_attention(kind: str = "auto"):
    """The attention of a vision tower that the JAX package runs apart
    from the decoder's (LLaVA, LLaVA-OneVision, InternVL, PaliGemma,
    Pixtral): LongLoRA never reaches it, so 'longlora_<inner>' gives the
    inner kind's attention.  The Qwen2-VL and Qwen2.5-VL towers take the
    decoder's own, as in JAX."""
    if kind.startswith("longlora"):
        kind = kind.partition("_")[2] or "auto"
    return default_attention(kind)


def xla_attn_lse(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
                 causal=True):
    return attention_with_lse_xla(q, k, v, mask)


def flash_attn_lse(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
                   causal=True):
    """K1 with its lse (a row with no valid key: out = 0, lse = +inf)."""
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids=q_segments, kv_segment_ids=kv_segments, causal=causal)


def default_attention_with_lse(kind: str = "auto"):
    """The (out, lse) dispatch: 'flash' | 'auto' (the K1 wrapper: kernel on
    CUDA, twin on CPU) or 'xla' (the dense oracle with an lse output)."""
    if kind in ("auto", "flash"):
        return flash_attn_lse
    # LongLoRA is an SFT option: shared-prompt scoring under it takes the
    # dense path, as the JAX scoring does for every kind but flash/auto
    if kind == "xla" or kind.startswith("longlora"):
        return xla_attn_lse
    raise ValueError(f"unknown attention kind {kind!r}")


def flash_decode_attn(q, k_cache, v_cache, kv_segments, length: int):
    """Ragged single-token cached attention (K4): q [B, 1, H, D], k/v cache
    [B, Hkv, S, D]; cost scales with ``length``."""
    B, T, H, D = q.shape
    out = decode_attention(
        q.reshape(B, H, D), k_cache.to(q.dtype), v_cache.to(q.dtype),
        kv_segments, length,
    )
    return out.reshape(B, T, H, D)


def default_decode_attention(kind: str = "auto"):
    """Decode-path impl: the K4 wrapper for 'auto'/'flash', else None (the
    decoder then runs the dense masked path over the whole cache)."""
    if kind in ("auto", "flash"):
        return flash_decode_attn
    return None
