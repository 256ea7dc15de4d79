"""K1: fused attention forward returning (out, lse).

Counterpart of iadr1_tpu/kernels/flash_attention.py
``flash_attention_with_lse`` (forward only; the backward kernels K2/K3
come with the training slice).  For CUDA tensors ``flash_attention``
launches the hand-written kernel ``csrc/flash_fwd.cu``; for CPU tensors it
runs the plain PyTorch twin ``flash_attention_ref``, which computes the
same function.

Semantics, shared by kernel and twin: a key slot is valid for a query row
when ``q_seg == kv_seg and kv_seg != 0`` and, when causal, ``col <= row``
(both counted from 0: top-left alignment when T != S).  ``lse`` is the
natural-log logsumexp of the scaled logits, in f32.  A row with no valid
key gets ``out = 0`` and ``lse = +inf``.
"""

from __future__ import annotations

import ctypes

import torch

from iadr1_tpu_torch.kernels._build import CudaKernel, ptr, stream_of

SUPPORTED_HEAD_DIMS = (64, 80, 128)

KERNEL = CudaKernel(
    name="flash_fwd",
    source="flash_fwd.cu",
    symbol="iadr1_flash_fwd_bf16",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)


def _default_segments(q, k, segment_ids, kv_segment_ids):
    B, T, S = q.shape[0], q.shape[2], k.shape[2]
    if segment_ids is None:
        segment_ids = torch.ones((B, T), dtype=torch.int32, device=q.device)
    if kv_segment_ids is None:
        kv_segment_ids = (segment_ids if S == T else torch.ones(
            (B, S), dtype=torch.int32, device=q.device))
    return segment_ids, kv_segment_ids


def flash_attention_ref(q, k, v, segment_ids, kv_segment_ids, *,
                        causal: bool, scale: float):
    """The plain PyTorch twin: q [B,H,T,D], k/v [B,Hkv,S,D] ->
    (out [B,H,T,D] in q's dtype, lse [B,H,T] f32), softmax in f32."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = H // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * scale
    valid = ((segment_ids[:, :, None] == kv_segment_ids[:, None, :])
             & (kv_segment_ids[:, None, :] != 0))[:, None]
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        valid = valid & (cols <= rows)
    s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    empty = torch.isneginf(lse)
    p = torch.exp(s - lse.masked_fill(empty, 0.0)[..., None])
    out = torch.einsum("bhts,bhsd->bhtd", p, vf)
    return out.to(q.dtype), lse.masked_fill(empty, float("inf"))


def _check_cuda(q, k, v, q_seg, kv_seg):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16; {name} is {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"H={H} is not a multiple of Hkv={k.shape[1]}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if T == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    if q_seg.shape != (B, T) or kv_seg.shape != (B, k.shape[2]):
        raise ValueError("segment ids must be [B, T] and [B, S]")
    if q_seg.device != q.device or kv_seg.device != q.device:
        raise ValueError("segment ids must be on q's device")


def flash_attention(q, k, v, *, segment_ids=None, kv_segment_ids=None,
                    causal: bool = True, scale: float | None = None):
    """q [B,H,T,D], k/v [B,Hkv,S,D] -> (out [B,H,T,D], lse [B,H,T] f32).

    ``segment_ids`` [B,T] / ``kv_segment_ids`` [B,S] (0 = padding) default
    to all ones; ``kv_segment_ids`` defaults to ``segment_ids`` when S == T.
    CUDA tensors launch the kernel (bf16, D in 64/80/128) or raise; CPU
    tensors take the twin."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_seg, kv_seg = _default_segments(q, k, segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_seg, kv_seg, causal=causal,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, q_seg, kv_seg)
    q_seg = q_seg.to(torch.int32).contiguous()
    kv_seg = kv_seg.to(torch.int32).contiguous()
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(q_seg), ptr(kv_seg),
                      ptr(out), ptr(lse), B, H, Hkv, T, S, D, float(scale),
                      int(causal), stream_of(q))
    return out, lse
