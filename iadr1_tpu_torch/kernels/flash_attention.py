"""K1 (fused attention forward returning (out, lse)) and its backward K2
(dq) and K3 (dk, dv), behind one ``torch.autograd.Function``.

Counterpart of iadr1_tpu/kernels/flash_attention.py
``flash_attention_with_lse`` and its custom VJP (``_flash``).  For CUDA
tensors ``flash_attention`` launches the hand-written kernels
``csrc/flash_fwd.cu`` (forward) and ``csrc/flash_bwd.cu`` (backward); for
CPU tensors it runs the plain PyTorch versions ``flash_attention_ref`` and
``flash_attention_bwd_ref``, which compute the same functions.  Unlike the
JAX VJP, the backward takes the cotangent of ``lse`` too, so a caller that
differentiates through lse (GRPO's ``_merge_attention``) gets the right
gradients.

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
DQ_KERNEL = CudaKernel(
    name="flash_bwd_dq",
    source="flash_bwd.cu",
    symbol="iadr1_flash_bwd_dq_bf16",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
DKV_KERNEL = CudaKernel(
    name="flash_bwd_dkv",
    source="flash_bwd.cu",
    symbol="iadr1_flash_bwd_dkv_bf16",
    argtypes=[ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
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


def _valid_pairs(segment_ids, kv_segment_ids, causal: bool):
    """[B, 1, T, S] bool: key s is valid for query row t."""
    T, S = segment_ids.shape[1], kv_segment_ids.shape[1]
    valid = ((segment_ids[:, :, None] == kv_segment_ids[:, None, :])
             & (kv_segment_ids[:, None, :] != 0))[:, None]
    if causal:
        rows = torch.arange(T, device=segment_ids.device)[:, None]
        cols = torch.arange(S, device=segment_ids.device)[None, :]
        valid = valid & (cols <= rows)
    return valid


# K3's tiles (csrc/flash_bwd.cu): keys per block, query rows per tile
DKV_TILE_K, DKV_TILE_Q = 64, 64


def _tile_id_range(seg, tile: int):
    """[B, n_tiles] (lo, hi) of each tile's non-zero segment ids; lo > hi
    where a tile has none."""
    B, n = seg.shape
    n_tiles = -(-n // tile)
    pad = torch.zeros((B, n_tiles * tile - n), dtype=seg.dtype,
                      device=seg.device)
    tiles = torch.cat([seg, pad], dim=1).reshape(B, n_tiles, tile)
    big = torch.iinfo(torch.int64).max
    ids = tiles.long()
    lo = torch.where(ids != 0, ids, big).amin(-1)
    hi = torch.where(ids != 0, ids, -big).amax(-1)
    return lo, hi


def live_tiles(q_seg, kv_seg, causal: bool, tile_q: int = DKV_TILE_Q,
               tile_k: int = DKV_TILE_K):
    """[B, n_key_blocks, n_query_tiles] bool: the (key block, query tile)
    pairs K3 computes, by the kernel's own test.  A pair is live when the
    tile's and the block's ranges of non-zero segment ids overlap and,
    when causal, the tile's last row reaches the block's first key
    (top-left alignment).  Every valid pair of ``_valid_pairs`` lies in a
    live tile, whatever the ids' order."""
    q_lo, q_hi = _tile_id_range(q_seg, tile_q)           # [B, nq]
    k_lo, k_hi = _tile_id_range(kv_seg, tile_k)          # [B, nk]
    live = ((q_lo <= q_hi)[:, None, :] & (k_lo <= k_hi)[:, :, None]
            & (q_lo[:, None, :] <= k_hi[:, :, None])
            & (k_lo[:, :, None] <= q_hi[:, None, :]))
    if causal:
        last_row = torch.clamp(
            torch.arange(1, q_lo.shape[1] + 1, device=q_seg.device) * tile_q,
            max=q_seg.shape[1]) - 1
        first_key = torch.arange(k_lo.shape[1], device=q_seg.device) * tile_k
        live = live & (last_row[None, None, :] >= first_key[None, :, None])
    return live


# K1's and K2's tiles (csrc/flash_fwd.cu, csrc/flash_bwd.cu): stacked query
# rows per block, keys per tile
ROW_BLOCK, KEY_TILE = 64, 64


def live_key_tiles(q_seg, kv_seg, causal: bool, group: int):
    """(live, full), each [B, n_row_blocks, n_key_tiles] bool: the (row
    block, key tile) pairs K1 and K2 compute, and those whose every pair is
    valid (they skip the mask), by the kernels' own test.  A block holds
    64 stacked query rows, row r = g*T + t for the GQA group's ``group``
    heads, and every kv head's block of the same index has the same flags,
    so the kernels' grid is this times Hkv.  A block's rows may run from
    the end of one head into the start of the next when T is not a
    multiple of 64; the test reads each row's own t.

    A pair is live when the block's and the tile's ranges of non-zero
    segment ids overlap and, when causal, the tile's first key is at most
    the block's last t.  It is full when, besides, every row of the block
    and every key of the tile (64 of each, none past the end) hold one
    non-zero id and, when causal, the tile's last key is at most the
    block's first t."""
    B, T = q_seg.shape
    S = kv_seg.shape[1]
    rows_total = group * T
    n_blocks = -(-rows_total // ROW_BLOCK)
    rows = torch.arange(n_blocks * ROW_BLOCK, device=q_seg.device)
    present = rows < rows_total
    t = rows % T
    ids = torch.where(present, q_seg.long()[:, t], 0).reshape(
        B, n_blocks, ROW_BLOCK)
    big = torch.iinfo(torch.int64).max
    q_lo = torch.where(ids != 0, ids, big).amin(-1)              # [B, nb]
    q_hi = torch.where(ids != 0, ids, -big).amax(-1)
    q_gap = (ids == 0).any(-1)          # a missing row holds id 0 here
    t_blk = t.reshape(n_blocks, ROW_BLOCK)
    p_blk = present.reshape(n_blocks, ROW_BLOCK)
    t_hi = torch.where(p_blk, t_blk, -1).amax(-1)                # [nb]
    t_lo = torch.where(p_blk, t_blk, big).amin(-1)

    k_lo, k_hi = _tile_id_range(kv_seg, KEY_TILE)                # [B, nk]
    n_tiles = k_lo.shape[1]
    pad = torch.zeros((B, n_tiles * KEY_TILE - S), dtype=kv_seg.dtype,
                      device=kv_seg.device)
    k_gap = (torch.cat([kv_seg, pad], 1).reshape(B, n_tiles, KEY_TILE)
             == 0).any(-1)
    first = torch.arange(n_tiles, device=q_seg.device) * KEY_TILE
    last = torch.clamp(first + KEY_TILE, max=S) - 1

    live = ((q_lo <= q_hi)[:, :, None] & (k_lo <= k_hi)[:, None, :]
            & (q_lo[:, :, None] <= k_hi[:, None, :])
            & (k_lo[:, None, :] <= q_hi[:, :, None]))
    full = (live & ~q_gap[:, :, None] & ~k_gap[:, None, :]
            & (q_lo == q_hi)[:, :, None] & (k_lo == k_hi)[:, None, :]
            & (q_lo[:, :, None] == k_lo[:, None, :]))
    if causal:
        live = live & (first[None, None, :] <= t_hi[None, :, None])
        full = full & live & (last[None, None, :] <= t_lo[None, :, None])
    return live, full


def flash_attention_ref(q, k, v, segment_ids, kv_segment_ids, *,
                        causal: bool, scale: float):
    """The plain PyTorch twin: q [B,H,T,D], k/v [B,Hkv,S,D] ->
    (out [B,H,T,D] in q's dtype, lse [B,H,T] f32), softmax in f32."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * scale
    valid = _valid_pairs(segment_ids, kv_segment_ids, causal)
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


def _delta(out, do, dlse):
    """rowsum(out * do) - dlse in f32: the softmax backward's row term,
    with the lse cotangent folded in."""
    delta = (out.float() * do.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attention_bwd_ref(q, k, v, segment_ids, kv_segment_ids, out, lse,
                            do, dlse, *, causal: bool, scale: float):
    """The plain PyTorch backward, written out (not autograd of the twin):
    p = exp(s - lse) from the saved lse, ds = p * (do v^T - delta) * scale
    with delta = rowsum(out * do) - dlse; dq = ds k, dk = ds^T q and
    dv = p^T do summed over each GQA group.  Masked pairs are selected to
    0, so a row with lse = +inf gets dq = 0.  Sums in f32; dq, dk, dv come
    back in the q, k, v dtypes.  ``dlse`` may be None (zero)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = H // Hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    valid = _valid_pairs(segment_ids, kv_segment_ids, causal)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    delta = _delta(out, do, dlse)
    ds = torch.where(valid, p * (dp - delta[..., None]) * scale, 0.0)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dk = dk.reshape(B, Hkv, group, S, D).sum(2)
    dv = dv.reshape(B, Hkv, group, S, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_cuda(q, k, v, q_seg, kv_seg, causal, scale):
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(q_seg), ptr(kv_seg),
                      ptr(out), ptr(lse), B, H, Hkv, T, S, D, float(scale),
                      int(causal), stream_of(q))
    return out, lse


def flash_bwd_dq(q, k, v, q_seg, kv_seg, lse, delta, do, *, causal, scale):
    """K2 on CUDA tensors (as the Function's backward passes them:
    contiguous bf16, int32 segments, f32 lse and delta) -> dq."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        DQ_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                         ptr(delta), ptr(q_seg), ptr(kv_seg), ptr(dq), B, H,
                         Hkv, T, S, D, float(scale), int(causal),
                         stream_of(q))
    return dq


def flash_bwd_dkv(q, k, v, q_seg, kv_seg, lse, delta, do, *, causal, scale):
    """K3 on CUDA tensors (as ``flash_bwd_dq``) -> (dk, dv)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # one block per (key block, query head): a GQA group's heads write f32
    # parts that the kernel's second pass sums in head order
    part = (torch.empty((2, B, H, S, D), dtype=torch.float32, device=q.device)
            if H > Hkv else None)
    with torch.cuda.device(q.device):
        DKV_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                          ptr(delta), ptr(q_seg), ptr(kv_seg), ptr(dk),
                          ptr(dv), None if part is None else ptr(part), B,
                          H, Hkv, T, S, D, float(scale), int(causal),
                          stream_of(q))
    return dk, dv


def _bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do, dlse, causal, scale):
    if do.dtype != q.dtype:
        raise TypeError(f"flash backward takes a {q.dtype} cotangent; "
                        f"got {do.dtype}")
    do = do.contiguous()
    delta = _delta(out, do, dlse).contiguous()
    kw = dict(causal=causal, scale=scale)
    dq = flash_bwd_dq(q, k, v, q_seg, kv_seg, lse, delta, do, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, q_seg, kv_seg, lse, delta, do, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(q, k, v, q_seg, kv_seg, causal, scale) -> (out, lse): the role of
    the JAX ``_flash`` custom VJP.  Saves (q, k, v, segments, out, lse),
    so a remat that keeps them never re-runs the forward; the backward
    takes the cotangents of both outputs.  CUDA tensors launch K1 forward
    and K2 + K3 backward; CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, q_seg, kv_seg,
                                           causal=causal, scale=scale)
        else:
            out, lse = _fwd_cuda(q, k, v, q_seg, kv_seg, causal, scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(
                q, k, v, q_seg, kv_seg, out, lse, do, dlse,
                causal=ctx.causal, scale=ctx.scale)
        else:
            dq, dk, dv = _bwd_cuda(q, k, v, q_seg, kv_seg, out, lse, do,
                                   dlse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, segment_ids=None, kv_segment_ids=None,
                    causal: bool = True, scale: float | None = None):
    """q [B,H,T,D], k/v [B,Hkv,S,D] -> (out [B,H,T,D], lse [B,H,T] f32),
    differentiable in q, k, v through both outputs.

    ``segment_ids`` [B,T] / ``kv_segment_ids`` [B,S] (0 = padding) default
    to all ones; ``kv_segment_ids`` defaults to ``segment_ids`` when S == T.
    CUDA tensors launch the kernels (bf16, D in 64/80/128) or raise; CPU
    tensors take the plain versions."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_seg, kv_seg = _default_segments(q, k, segment_ids, kv_segment_ids)
    if q.device.type == "cuda":
        _check_cuda(q, k, v, q_seg, kv_seg)
        q_seg = q_seg.to(torch.int32).contiguous()
        kv_seg = kv_seg.to(torch.int32).contiguous()
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return FlashAttention.apply(q, k, v, q_seg, kv_seg, causal, float(scale))
