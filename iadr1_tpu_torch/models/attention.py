"""Attention dispatch (counterpart of iadr1_tpu/models/attention.py).

All implementations share one signature:

    attn(q, k, v, *, mask, q_segments, kv_segments, causal) -> out

with q [B, T, H, D] and k/v [B, S, Hkv, D]; ``mask`` is the boolean
[B, 1, T, S] mask the oracle path reads, segments + causal feed the kernel.
The kernel wrappers pick by the tensors' device: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors.  ``flash_attn`` goes through
the flash autograd Function, so training gradients flow through K1's
backward (K2, K3) on the card.
"""

from __future__ import annotations

from iadr1_tpu_torch.kernels.decode_attention import decode_attention
from iadr1_tpu_torch.kernels.flash_attention import flash_attention
from iadr1_tpu_torch.models.common import xla_attention


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


def default_attention(kind: str = "auto"):
    """'flash' | 'auto' (the K1 wrapper: kernel on CUDA, twin on CPU) or
    'xla' (the dense masked oracle)."""
    if kind in ("auto", "flash"):
        return flash_attn
    if kind == "xla":
        return xla_attn
    if kind.startswith("longlora"):
        raise NotImplementedError(
            "LongLoRA attention is not ported yet (ROADMAP A.13)")
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
