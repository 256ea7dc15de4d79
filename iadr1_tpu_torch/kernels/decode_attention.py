"""K4: ragged single-token decode attention over a static KV cache.

Counterpart of iadr1_tpu/kernels/decode_attention.py ``decode_attention``.
For CUDA tensors ``decode_attention`` launches the hand-written kernel
``csrc/decode_attention.cu`` (split-K over 64-slot chunks of the cache,
then a merge pass; no slot at or past ``length`` is read); for CPU
tensors it runs the plain PyTorch twin ``decode_attention_ref``.

A cache slot is valid when its index < ``length`` and its segment id != 0
(``length`` is one host integer for the batch: prompts are left-padded and
decode steps are lockstep).  A row with no valid slot gets 0.
"""

from __future__ import annotations

import ctypes

import torch

from iadr1_tpu_torch.kernels._build import CudaKernel, ptr, stream_of

MAX_GROUP = 8
MAX_HEAD_DIM = 256
CHUNK = 64          # cache slots per block of the kernel's first pass

KERNEL = CudaKernel(
    name="decode_attention",
    source="decode_attention.cu",
    symbol="iadr1_decode_bf16",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)


def decode_attention_ref(q, k, v, kv_segment_ids, length: int, *,
                         scale: float):
    """The plain PyTorch twin: q [B,H,D], k/v [B,Hkv,S,D] -> [B,H,D] in
    q's dtype, softmax in f32."""
    B, H, D = q.shape
    if length == 0:
        return torch.zeros_like(q)
    group = H // k.shape[1]
    # only the valid prefix is read: slots past ``length`` never matter
    k, v = k[:, :, :length].float(), v[:, :, :length].float()
    qf = q.float().reshape(B, -1, group, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k) * scale
    valid = (kv_segment_ids[:, :length] != 0)[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = m.masked_fill(torch.isneginf(m), 0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v)
    out = out / l.masked_fill(l == 0, 1.0)
    return out.reshape(B, H, D).to(q.dtype)


def _check_cuda(q, k, v, seg, length):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode kernel takes bf16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B,H,D] and k/v [B,Hkv,S,D]")
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if H % Hkv != 0 or H // Hkv > MAX_GROUP:
        raise ValueError(f"GQA group H/Hkv={H}/{Hkv} must divide and be <= {MAX_GROUP}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if seg.shape != (B, S) or seg.device != q.device:
        raise ValueError("segment ids must be [B, S] on q's device")
    if not 0 <= length <= S:
        raise ValueError(f"length {length} outside [0, {S}]")


def decode_attention(q, k, v, kv_segment_ids, length: int, *,
                     scale: float | None = None):
    """q [B,H,D] one query per sequence; k/v [B,Hkv,S,D]; kv_segment_ids
    [B,S] (0 = padding / dead slot); valid slots are [0, length).
    CUDA tensors launch the kernel (bf16) or raise; CPU tensors take the
    twin."""
    length = int(length)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_segment_ids, length,
                                    scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, kv_segment_ids, length)
    seg = kv_segment_ids.to(torch.int32).contiguous()
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    # the chunks' f32 partials: acc [B, Hkv, chunks, G, D], then (m, l);
    # sized by the static S, so the launch shape never follows ``length``
    chunks = -(-S // CHUNK)
    workspace = torch.empty(B * H * chunks * (D + 2), dtype=torch.float32,
                            device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(seg), ptr(out),
                      ptr(workspace), B, H, Hkv, S, D, length, float(scale),
                      stream_of(q))
    return out
