#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (iadr1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--max-new-tokens N] [--train-steps N]

Phases, a line each at least, then the kernel JSON line, the card line and the
result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel built from iadr1_tpu_torch/csrc/ for sm_90a;
3. kernels: K1 (flash forward) and K4 (ragged decode) held against their
   plain PyTorch twins on the card at the serving path's shapes (K4 also
   at its chunk edges, over dead spans and at GQA groups 1 and 8), and
   K2 (flash dq) and K3 (flash dk/dv) against the plain backward at the
   training path's shapes (plus partial-tile, T != S, dlse != 0 and
   unsorted-segment cases; K1's out and lse that feed them are held
   against the twin there too, and timed at the decoder's training
   shape), with their device times (torch.profiler, kernels only; K4 also
   cold over 28 caches and as one host call), the plain version's and
   the matching PyTorch call's (F.scaled_dot_product_attention, forward
   or backward) as a yardstick, and the kernels' shares of live tiles;
   K1 and K2 also on the edges of their dead-tile skipping (unsorted ids,
   all-padding rows, left padding, stacked query rows that run from one
   head into the next at GQA 6);
4. main path: Qwen2-VL-2B at full width (28 decoder and 32 tower layers,
   bf16, weights drawn on the card from a seeded generator) serves 4
   already-tokenized image requests through VLMGenerator._collate and
   RolloutEngine.generate (eval defaults: P=1024, greedy, patch budget
   4096); the launch counters must show that every attention call of the
   run went through K1 or K4, and the kernel path's prefill logits must
   agree with the twin path's;
5. profile: a short generate under torch.profiler (device busy share and
   the kernels that take the device time);
6. training: Qwen2-VL-2B at full width (f32 parameters drawn on the card,
   bf16 compute, AdamW) takes 8 PA-SFT steps through make_chunked_sft_step
   and run_sft_loop on 4 already-tokenized image examples packed into 2
   rows of 2048 (remat on, CE chunk 1024); the launch counters must show
   that every attention call of every step went through K1, K2 and K3,
   step 1 must agree with a step through the plain versions (loss, grad
   norm and the attention projections' per-layer grad norms), a control
   step with dq zeroed must not, and the loss must fall.

Exits non-zero, printing no result, without a CUDA card or when any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Qwen/Qwen2-VL-2B-Instruct config.json, at full width and depth
QWEN2_VL_2B = dict(
    architectures=["Qwen2VLForConditionalGeneration"],
    text_config=dict(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        rms_norm_eps=1e-6, rope_theta=1000000.0, tie_word_embeddings=True,
        max_position_embeddings=32768,
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]}),
    vision_config=dict(
        depth=32, embed_dim=1280, hidden_size=1536, num_heads=16,
        patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
        mlp_ratio=4.0),
    image_token_id=151655, video_token_id=151656,
    vision_start_token_id=151652, vision_end_token_id=151653,
)
IM_START, IM_END, ENDOFTEXT = 151644, 151645, 151643
VISION_START, IMAGE_PAD, VISION_END = 151652, 151655, 151653
# one image per request, two sizes (pixels, multiples of 28): 1024 + 960
# patches each, 3968 of the 4096 patch budget in all
IMAGE_HW = [(448, 448), (336, 560), (448, 448), (336, 560)]
PROMPT_LEN, BATCH, PATCH_BUDGET = 1024, 4, 4096
DEVICE = "cuda"
# training: the cli/train_sft.py defaults (cutoff 2048, CE chunk 1024,
# remat on, AdamW lr 1e-5 cosine with warmup ratio 0.1, clip 1.0)
CUTOFF_LEN, TRAIN_ROWS, CE_CHUNK, LEARNING_RATE = 2048, 2, 1024, 1e-5
ANSWER_LEN = (600, 720)
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_sft")

# tolerances, kernel vs twin on identical bf16 inputs.  out: the kernel
# rounds p to bf16 before p @ v and both round the output to bf16 (2^-8
# relative each).  lse: f32 statistics on the same logits; only the
# summation order differs.
OUT_TOL = dict(atol=2e-2, rtol=2e-2)
LSE_ATOL = 1e-3
# prefill logits, kernel path vs twin path, relative L2: each of the 60
# attention calls rounds at other places (2^-8 relative), and the residual
# stream carries those differences through the remaining layers
LOGITS_REL_L2 = 5e-2
# K2/K3 against the plain backward on identical bf16 inputs: the kernels
# round p and ds to bf16 before their products (2^-8 relative each) and
# the gradients to bf16; the gradients' scale depends on the softmax
# width, so the absolute part is a fraction of the reference's largest
# magnitude
BWD_RTOL, BWD_ATOL_FRAC = 2e-2, 1e-2
# training step 1, kernel path vs plain path from the same parameters and
# batch: every one of the 92 + 60 attention calls rounds p (and, in the
# backward, ds) to bf16 where the plain versions keep f32, and those
# differences ride the residual stream through 28 + 32 layers.  The
# limits sit a few times above the sound readings on an H100 (PERF.md):
# the loss, the global grad norm, and the largest relative difference of
# the per-layer grad norms of the attention's q, k and v projections
# (decoder and tower), which read the backward's dq, dk and dv directly.
# A control step through the plain path with dq zeroed must fail them.
STEP1_LOSS_REL, STEP1_GRAD_NORM_REL, STEP1_QKV_REL = 1e-4, 2e-3, 1.5e-2


def log(line: str) -> None:
    print(line, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_times(fns, iters: int = 10) -> dict:
    """Device time of one call, by kernel name: the kernels' own time
    under torch.profiler over ``iters`` passes through ``fns`` (each on
    inputs of its own, so a pass over more than the 50 MB L2 finds each
    input cold), per call.  Host time between launches is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    calls = iters * len(fns)
    times = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            times[e.key] = times.get(e.key, 0.0) + (
                e.self_device_time_total / 1e3 / calls)
    if not times:
        raise AssertionError("the profiler recorded no device time")
    return times


def device_ms(fns, iters: int = 10) -> float:
    return sum(device_times(fns, iters).values())


def split_text(times: dict) -> str:
    """'name ms, ...' for the kernels of one call, longest first."""
    def short(key):
        m = re.search(r"(\w+(<[^>]*>)?)\(", key)
        return (m.group(1) if m else key)[:40]
    return ", ".join(f"{short(k)} {v:.4f}"
                     for k, v in sorted(times.items(), key=lambda kv: -kv[1]))


def max_err(a, b, rows=None) -> float:
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, a, b, atol, rtol, rows=None) -> float:
    a, b = a.float(), b.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite values")
    bad = (a - b).abs() > atol + rtol * b.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max err "
            f"{max_err(a, b):.3e} (atol {atol}, rtol {rtol})")
    return max_err(a, b)


# ---------------------------------------------------------------------------
# requests: what VLMGenerator._encode_request would have produced
# ---------------------------------------------------------------------------


def make_requests(seed: int = 0):
    """Four chatml image requests as token ids, with seeded text ids and a
    seeded image each, patchified by the port's numpy patchify."""
    from iadr1_tpu_torch.vision.preprocess import patchify_image

    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    encoded = []
    for i, (h, w) in enumerate(IMAGE_HW):
        pixels = rng.random((h, w, 3), dtype=np.float32)
        flat, grid = patchify_image(pixels)
        n_img = int(np.prod(grid)) // 4
        ids = ([IM_START] + text(3) + [IM_END] + text(1)          # system
               + [IM_START] + text(2)                             # user\n
               + [VISION_START] + [IMAGE_PAD] * n_img + [VISION_END]
               + text(20 + 7 * i) + [IM_END] + text(1)            # question
               + [IM_START] + text(2))                            # assistant\n
        encoded.append((ids, [flat], [grid]))
    return encoded


def make_sft_rows(seed: int = 1):
    """Four synthetic IAD SFT examples in the qwen2_vl chatml form (a
    seeded image each, prompt masked, a labeled answer of 600-720 seeded
    tokens), packed by the port's pack_examples into 2 rows of 2048."""
    from iadr1_tpu_torch.data.packing import pack_examples
    from iadr1_tpu_torch.vision.preprocess import patchify_image

    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples = []
    for i, (h, w) in enumerate(IMAGE_HW):
        flat, grid = patchify_image(rng.random((h, w, 3), dtype=np.float32))
        n_img = int(np.prod(grid)) // 4
        prompt = ([IM_START] + text(3) + [IM_END] + text(1)
                  + [IM_START] + text(2)
                  + [VISION_START] + [IMAGE_PAD] * n_img + [VISION_END]
                  + text(8 + 4 * i) + [IM_END] + text(1)
                  + [IM_START] + text(2))
        answer = text(int(rng.integers(ANSWER_LEN[0], ANSWER_LEN[1] + 1)))
        answer += [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [flat], "grid_thw": [grid]}})
    rows = pack_examples(examples, CUTOFF_LEN, ENDOFTEXT)
    if len(rows) != TRAIN_ROWS or any(r["segment_ids"].max() != 2
                                      for r in rows):
        raise AssertionError("the examples did not pack into 2 rows of 2")
    return rows


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def _pairs(q_seg, kv_seg, causal):
    """Valid (query, key) pairs per batch row: the work the data needs."""
    ok = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
    if causal:
        T, S = q_seg.shape[1], kv_seg.shape[1]
        ok &= (torch.arange(S, device=ok.device)[None, :]
               <= torch.arange(T, device=ok.device)[:, None])
    return ok


def check_fwd(shape, out, lse, ref_out, ref_lse, q_seg, kv_seg, causal):
    """K1's (out, lse) against the twin's on the rows with a valid key;
    rows with none must come out 0 / +inf."""
    B, H, T = lse.shape
    rows = _pairs(q_seg, kv_seg, causal).any(-1)[:, None, :].expand(B, H, T)
    err = check_close("flash out", out, ref_out, rows=rows, **OUT_TOL)
    lse_err = check_close("flash lse", lse, ref_lse, LSE_ATOL, 0.0, rows=rows)
    if not (out[~rows] == 0).all() or not torch.isposinf(lse[~rows]).all():
        raise AssertionError("flash: a row with no valid key is not 0/+inf")
    return {"shape": shape, "max_abs_err": err, "lse_max_abs_err": lse_err}


def key_tile_shares(q_seg, kv_seg, causal, group) -> dict:
    """K1's and K2's shares of (row block, key tile) pairs computed, and of
    those computed without the mask."""
    from iadr1_tpu_torch.kernels.flash_attention import live_key_tiles

    live, full = live_key_tiles(q_seg, kv_seg, causal, group)
    return {"live_tile_share": float(live.float().mean()),
            "full_tile_share": float(full.float().mean())}


def flash_case(B, H, Hkv, T, S, D, causal, q_seg, kv_seg, seed, timed):
    from iadr1_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, H, T, D), generator=gen, **dev)
    k = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    v = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    scale = D ** -0.5
    out, lse = flash_attention(q, k, v, segment_ids=q_seg,
                               kv_segment_ids=kv_seg, causal=causal)
    ref_out, ref_lse = flash_attention_ref(q, k, v, q_seg, kv_seg,
                                           causal=causal, scale=scale)
    torch.cuda.synchronize()
    res = check_fwd(f"B={B} H={H} Hkv={Hkv} T={T} S={S} D={D} "
                    f"causal={causal}", out, lse, ref_out, ref_lse, q_seg,
                    kv_seg, causal)
    if not timed:
        return res
    res.update(key_tile_shares(q_seg, kv_seg, causal, H // Hkv))
    pairs = _pairs(q_seg, kv_seg, causal)                     # [B, T, S]
    flops = 4.0 * H * D * float(pairs.sum())
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
              + 4 * lse.numel() + 4 * (q_seg.numel() + kv_seg.numel()))
    bound_flops, bound_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    mask = pairs[:, None]
    kr = k.repeat_interleave(H // Hkv, dim=1)
    vr = v.repeat_interleave(H // Hkv, dim=1)
    res.update(
        ms=device_ms([lambda: flash_attention(q, k, v, segment_ids=q_seg,
                                              kv_segment_ids=kv_seg,
                                              causal=causal)]),
        plain_ms=device_ms([lambda: flash_attention_ref(
            q, k, v, q_seg, kv_seg, causal=causal, scale=scale)], iters=3),
        library_ms=device_ms([lambda: torch.nn.functional
                              .scaled_dot_product_attention(q, kr, vr,
                                                            attn_mask=mask)]),
        bound_ms=1e3 * max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
        gflop=flops / 1e9,
    )
    return res


def bwd_case(B, H, Hkv, T, S, D, causal, q_seg, kv_seg, seed, timed,
             with_dlse=False):
    """K2 and K3 against flash_attention_bwd_ref on the same bf16 inputs
    (out and lse from K1, which is held against its twin there first);
    returns a result for K2, K3 and K1."""
    from iadr1_tpu_torch.kernels.flash_attention import (
        _delta,
        flash_attention,
        flash_attention_bwd_ref,
        flash_attention_ref,
        flash_bwd_dkv,
        flash_bwd_dq,
        live_tiles,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, H, T, D), generator=gen, **dev)
    k = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    v = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    do = torch.randn((B, H, T, D), generator=gen, **dev)
    scale = D ** -0.5
    shape = (f"B={B} H={H} Hkv={Hkv} T={T} S={S} D={D} causal={causal}"
             + (" dlse!=0" if with_dlse else ""))
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, segment_ids=q_seg,
                                   kv_segment_ids=kv_seg, causal=causal)
        ref_out, ref_lse = flash_attention_ref(q, k, v, q_seg, kv_seg,
                                               causal=causal, scale=scale)
    torch.cuda.synchronize()
    res_fwd = check_fwd(shape + " (K1 feeding K2/K3)", out, lse, ref_out,
                        ref_lse, q_seg, kv_seg, causal)
    del ref_out, ref_lse
    finite = torch.isfinite(lse)
    dlse = None
    if with_dlse:
        dlse = torch.randn(lse.shape, generator=gen, device="cuda") * finite
    delta = _delta(out, do, dlse).contiguous()
    kw = dict(causal=causal, scale=scale)
    args = (q, k, v, q_seg, kv_seg, lse, delta, do)
    dq = flash_bwd_dq(*args, **kw)
    dk, dv = flash_bwd_dkv(*args, **kw)
    ref = flash_attention_bwd_ref(q, k, v, q_seg, kv_seg, out, lse, do, dlse,
                                  **kw)
    torch.cuda.synchronize()
    errs = []
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs.append(check_close(
            f"flash {name}", got, want,
            BWD_ATOL_FRAC * float(want.float().abs().max()), BWD_RTOL))
    if not (dq[~finite] == 0).all():
        raise AssertionError("flash dq: a row with no valid key is not 0")
    res_dq = {"shape": shape, "max_abs_err": errs[0],
              **key_tile_shares(q_seg, kv_seg, causal, H // Hkv)}
    res_dkv = {"shape": shape, "max_abs_err": max(errs[1:]),
               "live_tile_share": float(live_tiles(q_seg, kv_seg, causal)
                                        .float().mean())}
    if not timed:
        return res_dq, res_dkv, res_fwd
    pairs = float(_pairs(q_seg, kv_seg, causal).sum())
    segs = 4 * (q_seg.numel() + kv_seg.numel())
    stats = 4 * (lse.numel() + delta.numel())
    plain_ms = device_ms([lambda: flash_attention_bwd_ref(
        q, k, v, q_seg, kv_seg, out, lse, do, dlse, **kw)], iters=3)
    # the yardstick: SDPA's backward (dq, dk, dv together) on a saved
    # forward, with a boolean mask and K/V repeated for GQA
    mask = _pairs(q_seg, kv_seg, causal)[:, None]
    leaves = [t.detach().requires_grad_(True) for t in (
        q, k.repeat_interleave(H // Hkv, dim=1),
        v.repeat_interleave(H // Hkv, dim=1))]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=mask)
    library_ms = device_ms([lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True)])
    for res, fn, n_products, out_numel in (
            (res_dq, flash_bwd_dq, 3, dq.numel()),
            (res_dkv, flash_bwd_dkv, 4, dk.numel() + dv.numel())):
        flops = 2.0 * n_products * H * D * pairs
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + do.numel()
                       + out_numel) + stats + segs)
        bound_flops = flops / PEAK_BF16_FLOPS
        bound_bytes = nbytes / PEAK_HBM_BYTES
        times = device_times([lambda: fn(*args, **kw)])
        res.update(
            ms=sum(times.values()), split=split_text(times),
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=1e3 * max(bound_flops, bound_bytes),
            bound_by="operations" if bound_flops >= bound_bytes else "bytes",
            gflop=flops / 1e9)
    return res_dq, res_dkv, res_fwd


# a decode step runs K4 once per decoder layer, each on its own cache
DECODE_LAYERS = 28


def decode_case(B, H, Hkv, S, D, length, seg, seed, timed):
    from iadr1_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, H, D), generator=gen, **dev)
    k = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    v = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    scale = D ** -0.5
    out = decode_attention(q, k, v, seg, length)
    ref = decode_attention_ref(q, k, v, seg, length, scale=scale)
    torch.cuda.synchronize()
    err = check_close("decode out", out, ref, **OUT_TOL)
    res = {"shape": f"B={B} H={H} Hkv={Hkv} S={S} D={D} length={length}",
           "max_abs_err": err}
    if not timed:
        return res
    valid = int((seg[:, :length] != 0).sum())       # live slots, all rows
    nbytes = (2 * q.numel() * 2 + 2 * Hkv * D * 2 * valid
              + 4 * B * length)
    flops = 4.0 * (H // Hkv) * Hkv * D * valid
    bound_flops, bound_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    mask = ((torch.arange(S, device="cuda")[None, :] < length)
            & (seg != 0))[:, None, None, :]
    q4 = q[:, :, None, :]
    kr = k.repeat_interleave(H // Hkv, dim=1)
    vr = v.repeat_interleave(H // Hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k4 = lambda: decode_attention(q, k, v, seg, length)
    lib = lambda: sdpa(q4, kr, vr, attn_mask=mask)
    split = device_times([k4])
    res.update(
        ms=sum(split.values()), split=split_text(split),
        plain_ms=device_ms([lambda: decode_attention_ref(
            q, k, v, seg, length, scale=scale)]),
        library_ms=device_ms([lib]),
        # one call as the host sees it (CUDA events around the Python
        # call, launch overhead included)
        call_ms=time_ms(k4), library_call_ms=time_ms(lib),
        bound_ms=1e3 * max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )
    # cold: passes over DECODE_LAYERS distinct caches, as a decode step
    # makes (more than the 50 MB L2 holds at the serving shape)
    del kr, vr
    caches = [(torch.randn((B, Hkv, S, D), generator=gen, **dev),
               torch.randn((B, Hkv, S, D), generator=gen, **dev))
              for _ in range(DECODE_LAYERS)]
    res["ms_cold"] = device_ms(
        [lambda k=k, v=v: decode_attention(q, k, v, seg, length)
         for k, v in caches], iters=3)
    reps = [(k.repeat_interleave(H // Hkv, dim=1),
             v.repeat_interleave(H // Hkv, dim=1)) for k, v in caches]
    del caches
    res["library_ms_cold"] = device_ms(
        [lambda k=k, v=v: sdpa(q4, k, v, attn_mask=mask) for k, v in reps],
        iters=3)
    res["cold_caches_mb"] = DECODE_LAYERS * 2 * k.numel() * 2 / 1e6
    return res


def phase_kernels(encoded, max_new_tokens, train_rows):
    from iadr1_tpu_torch.vision.preprocess import vision_segment_ids

    cuda = dict(device="cuda", dtype=torch.int32)
    grids = [g for _, _, gs in encoded for g in gs]
    tower_seg = torch.as_tensor(
        vision_segment_ids(grids, pad_to=PATCH_BUDGET), **cuda)[None]
    left = torch.zeros((BATCH, PROMPT_LEN), **cuda)
    for b, (ids, _, _) in enumerate(encoded):
        left[b, PROMPT_LEN - len(ids):] = 1
    S_dec = PROMPT_LEN + max_new_tokens
    dec_seg = torch.ones((BATCH, S_dec), **cuda)
    dec_seg[:, :PROMPT_LEN] = left

    tower = flash_case(1, 16, 16, PATCH_BUDGET, PATCH_BUDGET, 80, False,
                       tower_seg, tower_seg, 1, timed=True)
    prefill = flash_case(BATCH, 12, 2, PROMPT_LEN, PROMPT_LEN, 128, True,
                         left, left, 2, timed=True)
    g = torch.Generator().manual_seed(3)
    packed = torch.randint(0, 3, (2, 77), generator=g).to(**cuda)
    extra = [
        # partial tiles, T != S (top-left causal), GQA 2, D=80
        flash_case(1, 4, 2, 200, 333, 80, True,
                   torch.ones((1, 200), **cuda), torch.ones((1, 333), **cuda),
                   4, timed=False),
        # T != S the other way, partial tiles, non-causal, D=128
        flash_case(2, 6, 2, 300, 130, 128, False,
                   torch.ones((2, 300), **cuda), torch.ones((2, 130), **cuda),
                   5, timed=False),
        # packed segments with padding (id 0), GQA 6, D=64
        flash_case(2, 6, 1, 77, 77, 64, True, packed, packed, 6, timed=False),
    ]
    dec = decode_case(BATCH, 12, 2, S_dec, 128, S_dec, dec_seg, 7,
                      timed=True)
    dead = dec_seg.clone()                  # dead slots inside the prefix
    dead[1, 1000:1013] = 0
    dead[2, 1030:1036] = 0
    span = dec_seg.clone()                  # a dead span of 2+ chunks
    span[:, 150:333] = 0
    dec_extra = [decode_case(BATCH, 12, 2, S_dec, 128, min(1037, S_dec),
                             dead, 8, timed=False),
                 decode_case(2, 8, 1, 100, 64, 0, dead[:2, :100], 9,
                             timed=False),
                 decode_case(BATCH, 12, 2, S_dec, 128, S_dec, span, 18,
                             timed=False),
                 # length inside the first chunk, and one not a multiple
                 # of it
                 decode_case(BATCH, 12, 2, S_dec, 128, 37,
                             torch.ones((BATCH, S_dec), **cuda), 19,
                             timed=False),
                 decode_case(BATCH, 12, 2, S_dec, 128, min(1000, S_dec),
                             dec_seg, 20, timed=False),
                 # GQA groups 1 and 8
                 decode_case(BATCH, 2, 2, S_dec, 128, S_dec, dec_seg, 21,
                             timed=False),
                 decode_case(BATCH, 16, 2, S_dec, 128, S_dec, dec_seg, 22,
                             timed=False)]
    # the training path's shapes: the packed rows' segments (two per row
    # plus padding) and the tower over their four images
    dec_train = torch.as_tensor(np.stack([r["segment_ids"] for r in train_rows]),
                                **cuda)
    train_grids = [g for r in train_rows for e in r["extras"]
                   for g in e["grid_thw"]]
    tower_train = torch.as_tensor(
        vision_segment_ids(train_grids, pad_to=PATCH_BUDGET), **cuda)[None]
    ones = lambda b, n: torch.ones((b, n), **cuda)
    part = torch.zeros((1, 200), **cuda)   # two segments, then padding
    part[0, :90], part[0, 90:181] = 1, 2
    # arbitrary, unsorted ids (0 = padding): the dead-tile test must stay
    # conservative for any order
    unsorted = torch.randint(0, 4, (2, 300), generator=g).to(**cuda)
    unsorted200 = torch.randint(0, 4, (2, 200), generator=g).to(**cuda)
    allpad = torch.zeros((2, 256), **cuda)  # row 0 all padding
    allpad[1, 150:] = 2
    bwd = [
        bwd_case(1, 16, 16, PATCH_BUDGET, PATCH_BUDGET, 80, False,
                 tower_train, tower_train, 11, timed=True),
        bwd_case(TRAIN_ROWS, 12, 2, CUTOFF_LEN, CUTOFF_LEN, 128, True,
                 dec_train, dec_train, 12, timed=True),
        # partial tiles with packed segments and padding, GQA 2, D=80
        bwd_case(1, 4, 2, 200, 200, 80, True, part, part, 13, timed=False),
        # T != S, partial tiles, non-causal, GQA 3, D=128
        bwd_case(2, 6, 2, 300, 130, 128, False, ones(2, 300), ones(2, 130),
                 14, timed=False),
        # the lse cotangent (GRPO's merge), top-left causal T < S, GQA 7
        bwd_case(1, 14, 2, 190, 333, 64, True, ones(1, 190), ones(1, 333),
                 15, timed=False, with_dlse=True),
        # unsorted ids: causal GQA 6 at D=128, non-causal GQA 1 at D=80
        bwd_case(2, 12, 2, 300, 300, 128, True, unsorted, unsorted, 16,
                 timed=False),
        bwd_case(2, 4, 4, 300, 300, 80, False, unsorted, unsorted, 17,
                 timed=False),
        # K1's and K2's dead-tile edges (K3 runs them too): the prefill's
        # left padding, all-padding rows and blocks, and stacked query
        # rows that run from the end of one head into the next (GQA 6,
        # T = 200), with ones and with unsorted ids
        bwd_case(BATCH, 12, 2, PROMPT_LEN, PROMPT_LEN, 128, True, left,
                 left, 24, timed=False),
        bwd_case(2, 6, 1, 256, 256, 64, False, allpad, allpad, 25,
                 timed=False),
        bwd_case(2, 12, 2, 200, 200, 128, True, ones(2, 200), ones(2, 200),
                 26, timed=False),
        bwd_case(2, 12, 2, 200, 200, 80, True, unsorted200, unsorted200, 27,
                 timed=False),
    ]
    # K1 at the decoder's training shape, timed; at the others as checked
    # where they feed K2 and K3
    train_fwd = flash_case(TRAIN_ROWS, 12, 2, CUTOFF_LEN, CUTOFF_LEN, 128,
                           True, dec_train, dec_train, 23, timed=True)
    extra = [train_fwd] + extra + [fwd for i, (_, _, fwd) in enumerate(bwd)
                                   if i != 1]
    for r in [tower, prefill, *extra]:
        log(f"kernels: flash_fwd {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, lse {r['lse_max_abs_err']:.3e}"
            + (f", live tiles {r['live_tile_share']:.3f} (unmasked "
               f"{r['full_tile_share']:.3f})" if "live_tile_share" in r
               else "")
            + (f"; {r['ms']:.4f} ms (twin {r['plain_ms']:.4f}, sdpa "
               f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
               f"{r['bound_by']}, {r['gflop']:.2f} GFLOP)" if "ms" in r
               else ""))
    for r in [dec, *dec_extra]:
        log(f"kernels: decode_attention {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}"
            + (f"; warm {r['ms']:.4f} ms (twin {r['plain_ms']:.4f}, sdpa "
               f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
               f"{r['bound_by']}); cold over {DECODE_LAYERS} caches "
               f"({r['cold_caches_mb']:.0f} MB) {r['ms_cold']:.4f} ms "
               f"(sdpa {r['library_ms_cold']:.4f}); one call with its "
               f"launch {r['call_ms']:.4f} ms (sdpa "
               f"{r['library_call_ms']:.4f}); kernels {r['split']}"
               if "ms" in r else ""))
    for rdq, rdkv, _ in bwd:
        for name, r in (("flash_bwd_dq", rdq), ("flash_bwd_dkv", rdkv)):
            log(f"kernels: {name} {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3e}"
                + (f", live tiles {r['live_tile_share']:.3f}"
                   if "live_tile_share" in r else "")
                + (f" (unmasked {r['full_tile_share']:.3f})"
                   if "full_tile_share" in r else "")
                + (f"; {r['ms']:.4f} ms (plain bwd {r['plain_ms']:.4f}, "
                   f"sdpa bwd {r['library_ms']:.4f}, bound "
                   f"{r['bound_ms']:.4f} {r['bound_by']}, "
                   f"{r['gflop']:.2f} GFLOP; kernels {r['split']})"
                   if "ms" in r else ""))
    return {"flash_fwd": [tower, prefill] + extra,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": [dec] + dec_extra}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def twin_attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
              causal=True):
    """The model-level attention signature over the K1 twin (no kernel)."""
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention_ref

    out, _ = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_segments, kv_segments, causal=causal, scale=q.shape[-1] ** -0.5)
    return out.transpose(1, 2)


def phase_main(encoded, max_new_tokens, card):
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models import qwen2, qwen2_vl
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    bundle = bundle_from_hf_config(QWEN2_VL_2B)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"main: Qwen2-VL-2B {n_params / 1e9:.3f}B params (bf16, seeded) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")

    tokenizer = types.SimpleNamespace(eos_token_id=IM_END,
                                      pad_token_id=ENDOFTEXT)
    gcfg = GeneratorConfig(max_prompt_length=PROMPT_LEN,
                           max_new_tokens=max_new_tokens, batch_size=BATCH,
                           patch_budget=PATCH_BUDGET)
    gen = VLMGenerator(bundle, params, tokenizer, get_template("qwen2_vl"),
                       gcfg, device=DEVICE)
    batch = gen._collate(encoded)

    # prefill logits: kernel path (the bundle) against the twin path
    def prefill(attn=None):
        cache = qwen2.init_cache(cfg.text, BATCH, PROMPT_LEN, torch.bfloat16,
                                 DEVICE)
        b = {**batch, "segment_ids": batch["attention_mask"].to(torch.int32)}
        with torch.no_grad():
            if attn is None:
                h, _ = bundle.apply(params, b, cache=cache,
                                    cache_mode="prefill")
            else:
                h, _ = qwen2_vl.apply(
                    params, cfg, b["input_ids"], b["position_ids"],
                    patches=b["patches"], rot_cos=b["rot_cos"],
                    rot_sin=b["rot_sin"],
                    vision_segments=b["vision_segments"],
                    scatter_rows=b["scatter_rows"],
                    scatter_cols=b["scatter_cols"],
                    segment_ids=b["segment_ids"], cache=cache,
                    cache_mode="prefill", attention_fn=attn,
                    vision_attention_fn=attn)
            return bundle.logits_fn(params, h[:, -1:])[:, 0]

    kernel_logits = prefill()
    twin_logits = prefill(twin_attn)
    torch.cuda.synchronize()
    if kernel_logits.shape != (BATCH, cfg.text.vocab_size):
        raise AssertionError(f"logits shape {tuple(kernel_logits.shape)}")
    if not torch.isfinite(kernel_logits).all():
        raise AssertionError("prefill logits are not finite")
    rel = float((kernel_logits - twin_logits).norm() / twin_logits.norm())
    agree = int((kernel_logits.argmax(-1) == twin_logits.argmax(-1)).sum())
    log(f"main: prefill logits kernel vs twin path: rel L2 {rel:.3e} "
        f"(limit {LOGITS_REL_L2}), argmax agree {agree}/{BATCH}")
    if not rel <= LOGITS_REL_L2:
        raise AssertionError(f"prefill logits differ: rel L2 {rel:.3e}")

    for _ in range(2):                       # the second one is warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)

    kernels = [k for k, _ in all_kernels()]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = gen.engine.generate(params, batch, gen.generator)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    steps = result["num_decode_steps"]

    ids = result["completion_ids"]
    if ids.shape != (BATCH, max_new_tokens):
        raise AssertionError(f"completion shape {tuple(ids.shape)}")
    if not ((ids >= 0) & (ids < cfg.text.vocab_size)).all():
        raise AssertionError("completion ids out of the vocabulary")
    want_flash = cfg.vision.depth + cfg.text.num_hidden_layers
    want_decode = cfg.text.num_hidden_layers * steps
    if launches["flash_fwd"] != want_flash or steps < 1:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} "
                             f"times, want {want_flash}")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: {launches}")
    if launches["decode_attention"] != want_decode:
        raise AssertionError(
            f"decode_attention launched {launches['decode_attention']} "
            f"times, want {want_decode} ({steps} steps)")
    n_tokens = int(result["completion_mask"].sum())
    decode_ms = (1e3 * total_s - prefill_ms) / steps
    log(f"main: generate {BATCH} requests, {steps} decode steps "
        f"(max_new_tokens {max_new_tokens}), {n_tokens} tokens in "
        f"{total_s:.3f} s; launches {launches}")
    log(f"main: prefill {prefill_ms:.2f} ms (tower + decoder), decode "
        f"{decode_ms:.3f} ms/step, {n_tokens / total_s:.1f} generated "
        f"tokens/s on {card}")
    return launches, gen, batch


def phase_profile(gen, batch, steps: int = 8) -> None:
    """Where a generate's time goes: a short generate (prefill + ``steps``
    decode steps) under torch.profiler; device busy time is the sum of the
    kernels' own device time on the one stream."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from iadr1_tpu_torch.train.rollout import RolloutEngine

    engine = RolloutEngine(
        gen.bundle, dataclasses.replace(gen.engine.sampling,
                                        max_new_tokens=steps),
        gen.engine.max_len, device=DEVICE)
    engine.generate(gen.params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(gen.params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log(f"profile: prefill + {steps} decode steps: "
        + device_time_summary(prof, wall_ms))


# device kernels by family, matched on the kernel's name in this order
KERNEL_FAMILIES = [
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel", "dkv_group_sum_kernel")),
    ("K4 decode", ("decode_chunk_kernel", "decode_merge_kernel")),
    ("f32 GEMM", ("f32f32", "sgemm")),
    ("bf16 GEMM", ("gemm", "nvjet", "cutlass")),
    ("elementwise", ("elementwise",)),
    ("reduction", ("reduce",)),
]


def device_time_summary(prof, wall_ms: float, top_n: int = 6,
                        ranges=()) -> str:
    """Device busy time (the sum of the kernels' own device time on the
    one stream), idle share and the top kernels of a profiler window, and
    the device time of the kernels launched inside each named range."""
    from torch.autograd import DeviceType

    # device-side kernel events only: the CPU ops that launched them carry
    # the same device time again, and a range's span on the device
    # timeline is no kernel
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        return (f"wall {wall_ms:.1f} ms; the profiler recorded no device "
                f"time, device busy share not measured")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:top_n]
    shares = {}
    for e in events:
        kind = next((label for label, keys in KERNEL_FAMILIES
                     if any(key in e.key for key in keys)), "other")
        shares[kind] = shares.get(kind, 0.0) + e.self_device_time_total / 1e3
    in_ranges = {e.key: e.device_time_total / 1e3 for e in averages
                 if e.key in ranges and e.device_type == DeviceType.CPU}
    outside = (f"outside them {busy_ms - sum(in_ranges.values()):.1f} ms; "
               if ranges else "")
    return (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
            f"share {1 - busy_ms / wall_ms:.3f}; "
            + "".join(f"in {name} {in_ranges.get(name, 0.0):.1f} ms, "
                      for name in ranges) + outside
            + "by family: " + ", ".join(
                f"{kind} {ms:.1f} ms" for kind, ms in sorted(
                    shares.items(), key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
                f"x{e.count}" for e in top))


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


class TwinFlash(torch.autograd.Function):
    """The flash Function over the plain versions only (forward twin,
    written-out backward): the reference path of the step-1 check."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        from iadr1_tpu_torch.kernels.flash_attention import flash_attention_ref

        ctx.scale = q.shape[-1] ** -0.5
        out, lse = flash_attention_ref(q, k, v, q_seg, kv_seg, causal=causal,
                                       scale=ctx.scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        from iadr1_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_ref,
        )

        dq, dk, dv = flash_attention_bwd_ref(
            *ctx.saved_tensors, do, dlse, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


class ZeroDqFlash(TwinFlash):
    """The control of the step-1 check: the plain backward with dq
    zeroed, a faulty backward its limits must catch."""

    @staticmethod
    def backward(ctx, do, dlse):
        dq, *rest = TwinFlash.backward(ctx, do, dlse)
        return (torch.zeros_like(dq), *rest)


def train_attn(flash):
    """The model-level attention signature over a flash Function."""
    def attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
             causal=True):
        out, _ = flash.apply(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), q_segments, kv_segments,
                             causal)
        return out.transpose(1, 2)
    return attn


class GradProbe:
    """The optimizer, wrapped: on its first call it keeps the per-layer
    gradient norms of the attention's q, k and v projections in the
    decoder and the tower (the step hands its gradients only to the
    optimizer)."""

    def __init__(self, optimizer, params):
        from iadr1_tpu_torch.train.state import tree_leaves

        leaves = tree_leaves(params)
        attn = params["text"]["layers"]["attn"]
        targets = [attn[n]["kernel"] for n in "qkv"]
        targets.append(params["vision"]["blocks"]["attn"]["qkv"]["kernel"])
        self.index = [next(i for i, p in enumerate(leaves) if p is t)
                      for t in targets]
        self.optimizer, self.norms = optimizer, None

    def init(self, params):
        return self.optimizer.init(params)

    def apply(self, params, grads, state, grad_norm=None):
        if self.norms is None:
            dq, dk, dv, tower = (grads[i].detach() for i in self.index)
            parts = dict(zip(("decoder q", "decoder k", "decoder v"),
                             (dq, dk, dv)))
            parts.update(zip(("tower q", "tower k", "tower v"),
                             tower.chunk(3, dim=-1)))
            self.norms = {n: g.float().flatten(1).norm(dim=1)
                          for n, g in parts.items()}
        return self.optimizer.apply(params, grads, state, grad_norm)


def step1_diffs(got, ref) -> dict:
    """Relative differences of step 1's loss, global grad norm and the
    worst per-layer q/k/v projection grad norm."""
    (m, norms), (m0, norms0) = got, ref
    return {
        "loss": abs(m["loss"] - m0["loss"]) / abs(m0["loss"]),
        "grad norm": abs(m["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"],
        "qkv grad norms": max(float(((norms[n] - norms0[n]).abs()
                                     / norms0[n]).max()) for n in norms0),
    }


STEP1_LIMITS = {"loss": STEP1_LOSS_REL, "grad norm": STEP1_GRAD_NORM_REL,
                "qkv grad norms": STEP1_QKV_REL}


def _within(diffs) -> bool:
    return all(diffs[k] <= STEP1_LIMITS[k] for k in STEP1_LIMITS)


def _diff_text(diffs) -> str:
    return ", ".join(f"{k} rel {v:.3e} (limit {STEP1_LIMITS[k]})"
                     for k, v in diffs.items())


def phase_train(rows, steps: int, card):
    """PA-SFT steps of Qwen2-VL-2B through the library's entry points, as
    cli/train_sft.py assembles them; returns the launch counts."""
    import gc

    from iadr1_tpu_torch.core.metrics import (
        ThroughputMeter,
        transformer_flops_per_token,
        vit_flops_per_patch,
    )
    from iadr1_tpu_torch.data.collator import VLMBatchBuilder
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models import qwen2_vl
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import STEP_RANGES, make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    bundle = bundle_from_hf_config(QWEN2_VL_2B)
    cfg = bundle.cfg
    builder = VLMBatchBuilder(bundle, PATCH_BUDGET)
    opt_cfg = OptimizerConfig(learning_rate=LEARNING_RATE, schedule="cosine",
                              warmup_ratio=0.1, total_steps=steps,
                              max_grad_norm=1.0)

    def fresh(hidden_fn):
        params = bundle.init_params(seed=0, dtype=torch.float32,
                                    device=DEVICE)
        opt, sched = make_optimizer(opt_cfg)
        probe = GradProbe(opt, params)
        step = make_chunked_sft_step(hidden_fn, bundle.head_kernel_fn, probe,
                                     sched, chunk_size=CE_CHUNK)
        return create_train_state(params, probe), step, probe

    # the plain path and its control first, from the same parameters and
    # first batch; each state is freed before the next allocates its own
    first = next(batch_iterator(rows, TRAIN_ROWS, 0, builder))

    def plain_hidden(flash):
        attn = train_attn(flash)

        def hidden(params, b):
            h, _ = qwen2_vl.apply(
                params, cfg, b["input_ids"], b["position_ids"],
                patches=b["patches"], rot_cos=b["rot_cos"],
                rot_sin=b["rot_sin"], vision_segments=b["vision_segments"],
                scatter_rows=b["scatter_rows"],
                scatter_cols=b["scatter_cols"], segment_ids=b["segment_ids"],
                attention_fn=attn, vision_attention_fn=attn, remat=True)
            return h
        return hidden

    def first_step(flash):
        state, plain_step, probe = fresh(plain_hidden(flash))
        _, m = plain_step(state, first)
        res = {k: float(v) for k, v in m.items()}, probe.norms
        del state, plain_step, probe, m
        gc.collect()
        torch.cuda.empty_cache()
        return res

    plain = first_step(TwinFlash)
    control = step1_diffs(first_step(ZeroDqFlash), plain)
    log(f"train: step 1 control (plain path with dq zeroed) vs plain path: "
        f"{_diff_text(control)}")
    if _within(control):
        raise AssertionError("the step-1 limits do not catch a zeroed dq")

    state, step, probe = fresh(
        lambda p, b: bundle.hidden_fn(p, b, remat=True))
    n_params = sum(p.numel() for p in _leaves(state.params))
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    kernels = [k for k, _ in all_kernels()]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    state, history = run_sft_loop(
        state, timed_step, batch_iterator(rows, TRAIN_ROWS, 0, builder),
        LoopConfig(output_dir=TRAIN_DIR, max_steps=steps,
                   batch_size=TRAIN_ROWS, logging_steps=1))
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # where a step's time goes: one more step under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, first)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log("profile: one training step: "
        + device_time_summary(prof, wall_ms, top_n=10, ranges=STEP_RANGES))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    L_dec, L_tower = cfg.text.num_hidden_layers, cfg.vision.depth
    # per step: K1 once per decoder layer (its residuals survive remat)
    # and twice per tower block (plain checkpoint: the backward replays
    # it); K2 and K3 once per attention call
    want = {"flash_fwd": steps * (L_dec + 2 * L_tower),
            "flash_bwd_dq": steps * (L_dec + L_tower),
            "flash_bwd_dkv": steps * (L_dec + L_tower),
            "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    diffs = step1_diffs(({"loss": losses[0], "grad_norm": norms[0]},
                         probe.norms), plain)
    log(f"train: step 1 kernel vs plain path: loss {losses[0]:.6f} vs "
        f"{plain[0]['loss']:.6f}, grad norm {norms[0]:.6f} vs "
        f"{plain[0]['grad_norm']:.6f}; {_diff_text(diffs)}")
    if not _within(diffs):
        raise AssertionError("step 1 differs between kernel and plain path")

    B, T = TRAIN_ROWS, CUTOFF_LEN
    step_s = statistics.median(times[3:] if len(times) > 3 else times[1:])
    n_label = history[0]["n_label_tokens"]
    patches = [int(np.prod(g)) for r in rows for e in r["extras"]
               for g in e["grid_thw"]]
    t = cfg.text
    dec_flops = B * T * transformer_flops_per_token(
        hidden=t.hidden_size, intermediate=t.intermediate_size,
        num_layers=t.num_hidden_layers, vocab=t.vocab_size, seq_len=T,
        num_heads=t.num_attention_heads, num_kv_heads=t.num_key_value_heads)
    v = cfg.vision
    vit_flops = sum(patches) * vit_flops_per_patch(
        hidden=v.embed_dim, intermediate=v.mlp_dim, num_layers=v.depth,
        attn_window=sum(n * n for n in patches) / sum(patches))
    meter = ThroughputMeter(flops_per_token_fwd=(dec_flops + vit_flops)
                            / (B * T), peak_flops=PEAK_BF16_FLOPS)
    meter.update(B * T, step_s)
    log(f"train: Qwen2-VL-2B {n_params / 1e9:.3f}B f32 params, {steps} "
        f"steps of {B}x{T} tokens ({int(n_label)} label tokens, "
        f"{sum(patches)} patches), lr {LEARNING_RATE} cosine; losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"train: step {1e3 * step_s:.1f} ms (median of steps "
        f"{'4-' if len(times) > 3 else '2-'}{steps}; all steps "
        f"{[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, {n_label / step_s:.0f} label "
        f"tokens/s, MFU {meter.mfu:.4f} (decoder + tower model FLOPs, "
        f"x3, against {PEAK_BF16_FLOPS:.3g}), peak memory {peak_gib:.2f} "
        f"GiB, launches {launches} on {card}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--train-steps", type=int, default=8)
    args = ap.parse_args()
    if args.train_steps < 2:
        ap.error("--train-steps must be at least 2")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels._build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    kernels = all_kernels()
    secs = build_all([k.source for k, _ in kernels])
    log(f"build: {len(kernels)} kernels from iadr1_tpu_torch/csrc for "
        f"sm_90a in {secs:.1f} s")
    encoded = make_requests()
    train_rows = make_sft_rows()
    measured = phase_kernels(encoded, args.max_new_tokens, train_rows)
    serve, gen, batch = phase_main(encoded, args.max_new_tokens, card)
    phase_profile(gen, batch)
    del gen, batch
    torch.cuda.empty_cache()
    train = phase_train(train_rows, args.train_steps, card)

    line = []
    for k, replaces in kernels:
        main_case, *others = measured[k.name]
        entry = {"name": k.name, "route": "cuda",
                 "source": f"iadr1_tpu_torch/csrc/{k.source}",
                 "replaces": replaces,
                 "launches": serve[k.name] + train[k.name],
                 "launches_by_path": {"serve": serve[k.name],
                                      "train": train[k.name]}}
        entry.update({key: main_case[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "live_tile_share", "ms_cold",
            "library_ms_cold", "call_ms", "library_call_ms")
            if key in main_case})
        if k.name.startswith("flash_bwd"):
            entry["plain_and_library_cover"] = (
                "dq, dk and dv together (K2 + K3): flash_attention_bwd_ref, "
                "and the backward of F.scaled_dot_product_attention")
        entry["max_abs_err"] = max(c["max_abs_err"] for c in measured[k.name])
        entry["other_shapes"] = others
        line.append(entry)
    for entry in line:
        for key, val in entry.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{entry['name']}.{key} = {val}")
    print(json.dumps({"kernels": line}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
