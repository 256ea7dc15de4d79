#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (iadr1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--max-new-tokens N] [--train-steps N]
                          [--grpo-steps N]

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
   head into the next at GQA 6); and all four at the SC-GRPO step's shapes
   (the completions' cross attention to the shared prompt, T != S and
   non-causal, and their causal self attention, both with rows that end
   early and dlse != 0; the unique prompts; the two-image tower; K4 over
   the fanned-out cache of 8 rows);
4. main path: Qwen2-VL-2B at full width (28 decoder and 32 tower layers,
   bf16, weights drawn on the card from a seeded generator) serves 4
   already-tokenized image requests through VLMGenerator._collate and
   RolloutEngine.generate (eval defaults: P=1024, greedy, patch budget
   4096; 128 new tokens unless asked otherwise); the launch counters must show that every attention call of the
   run went through K1 or K4, and the kernel path's prefill logits must
   agree with the twin path's;
5. profile: a short generate under torch.profiler (device busy share and
   the kernels that take the device time);
6. training: Qwen2-VL-2B at full width (f32 parameters drawn on the card,
   bf16 compute, AdamW) takes 4 PA-SFT steps through make_chunked_sft_step
   and run_sft_loop on 4 already-tokenized image examples packed into 2
   rows of 2048 (remat on, CE chunk 1024); the launch counters must show
   that every attention call of every step went through K1, K2 and K3,
   step 1 must agree with a step through the plain versions (loss, grad
   norm and the attention projections' per-layer grad norms), a control
   step with dq zeroed must not, and the loss must fall;
7. SC-GRPO: Qwen2-VL-2B at full width (f32 policy drawn on the card, a
   bf16 reference copy, bf16 compute, AdamW lr 1e-6) takes 3 steps of
   GRPOTrainer.step with cli/train_grpo.py's defaults (G=4, P=1024, N=512,
   temperature 0.9, top-p 0.9, top-k 50, beta 0.04, rewards accuracy +
   format, remat save_flash, shared-prompt scoring, logp chunk 1024) on 2
   already-tokenized image prompts through make_vlm_prompt_collator; the
   launch counters of each step must equal the counts the path implies
   (K4 per decode step and layer; K1 for the rollout prefill, the
   reference forward and the policy forward; K2 and K3 once per attention
   call of the policy), step 1 must agree with a step through the plain
   versions on the same recorded rollout, a control whose backward drops
   the lse cotangent must not, every group must carry a non-zero
   advantage, and every metric must be finite;
8. eval (right after phase 5, on phase 4's bf16 weights): the port's
   benchmark harness runs 8 synthetic Yes/No items (4 normal, 4 defective)
   through run_benchmark with the serving generator (P=1024, patch budget
   4096, B=4, the serving phase's new tokens), fed already-encoded image
   requests through VLMGenerator._generate_encoded, and a stand-in
   tokenizer whose canned answers fix the letters and the balanced
   accuracy in advance; the answers JSON, the accuracy CSV and each
   batch's launches (K1 once per tower and decoder layer, K4 once per
   decoder layer and decode step) must be as predicted, and a second call
   on the same file must launch nothing and change nothing;
9. chat (after 8): the port's ChatServer on 127.0.0.1 over a generator of
   batch 4 and 32 new tokens answers /v1/models, a text request with a
   system message (which must become the prompt's system block) and 4
   concurrent text requests, which must be coalesced into one generate
   with one batch's launches;
10. chain (after 7): the IAD-R1 recipe through one call of the port's
   run_pipeline at full Qwen2-VL-2B width, its entry points as a user
   calls them: a base checkpoint (the published config cut to 12 decoder
   layers and 12 tower blocks, so that the run writes 36 GB to disk and
   not 75, seeded bf16 weights written by save_pretrained, a WordLevel
   tokenizer over the
   head's 151936 ids with Qwen's specials at their published ids), seeded
   448x448 images, 8 IAD SFT rows, 4 RL rows and phase 8's benchmark;
   PA-SFT (2 steps of 2 x 2048, remat on, CE chunk 1024) -> HF export ->
   SC-GRPO warm-started from that export (2 steps of 2 prompts, G=4,
   P=1024, N=64, accuracy + format, a bf16 reference) -> export -> eval
   (B=4, P=1024, patch budget 4096, 32 new tokens) -> summary CSV.  Each
   stage's launches must be those its path implies, no plain twin may be
   called, nothing of a stage may stay allocated (1 GiB) after it returns,
   the SFT export must equal the SFT checkpoint bit for bit, and the
   answers, CSV, logs and manifest must be whole; the disk must hold the
   chain (checked first).  Prints each stage's wall time, peak and
   residual memory and launches, each checkpoint save, restore and HF
   export with its GB/s, and the SFT export's read back onto the card.

Before the phases, one line says which of the host libraries the port's
CLIs use import on this machine; no phase depends on it.

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

# SC-GRPO: cli/train_grpo.py's defaults (GRPOConfig's own), two prompts of
# one image each; data.patch_budget 8192 sizes the G-repeated collation, so
# the G = 1 collation the shared-prompt path uses holds 8192 / 4 = 2048
# patches: the two images' 1024 + 960
GRPO_PROMPTS, GRPO_PATCH_BUDGET, GRPO_LEARNING_RATE = 2, 8192, 1e-6
GRPO_REWARDS = ["accuracy", "format"]
# rollouts the smoke ends early (row, tokens kept): random weights hardly
# ever draw EOS, trained ones nearly always do, and every token after an
# EOS is a row with no valid key on both sides of the update's merge
GRPO_EARLY_EOS = ((1, 37), (3, 300), (6, 1))
# GRPO step 1, kernel path vs plain path on the same recorded rollout.
# On-policy the loss is -mean(advantage) + beta * kl: the advantages of a
# group sum to 0 and the policy starts as its reference (kl = 0), so loss
# and kl are held absolutely.  The gradient (the advantages' policy
# gradient) is held like the SFT step's, and besides by the distance
# between the q and k projections' gradient vectors: a backward that drops
# the lse cotangent turns them (0.17 on an H100) more than it changes
# their length (0.03).  The limits sit 2-3 times above the sound readings
# on an H100 (PERF.md: 5.9e-4, 7.8e-3, 3.1e-2); that control must fail
# them.
GRPO_STEP1_LIMITS = {"loss": 1e-5, "kl": 1e-5, "grad norm": 2e-3,
                     "qkv grad norms": 2e-2, "q/k grad vectors": 7e-2}
GRPO_KL_STEP1_MAX = 1e-3


def log(line: str) -> None:
    print(line, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


IMPORT_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        print(name, "yes")
    except Exception as e:      # a report line: any failure means "no"
        print(name, f"no ({type(e).__name__})")
"""


def importable(names) -> str:
    """Which of ``names`` import on this machine, tried in a child process
    so that what they load stays out of this one."""
    out = subprocess.run([sys.executable, "-c", IMPORT_PROBE, *names],
                         capture_output=True, text=True, timeout=300)
    return ", ".join(out.stdout.split("\n")[:-1]) or out.stderr[-200:]


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
    calls = iters * len(fns)
    # a window that recorded no device time is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not getattr(e, "is_user_annotation", False)):
                times[e.key] = times.get(e.key, 0.0) + (
                    e.self_device_time_total / 1e3 / calls)
        if times:
            return times
        log("profile: a window recorded no device time; taken again")
    raise AssertionError("the profiler recorded no device time")


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


GRPO_SOLUTIONS = [
    "<think>The weave is even.</think><answer>No</answer>",
    "<think>A thin bright line crosses the corner.</think>"
    "<location>top left</location><type>scratch</type><answer>Yes</answer>",
]
_THINK = "<think>The texture is regular except near one corner.</think>"
# eight responses in the reward grammar, which the accuracy and format
# rewards score differently.  Their order matters: any four consecutive
# ones (cyclically) differ in their summed reward against either solution
CANNED_RESPONSES = [
    _THINK + "<answer>No</answer>",                     # well-formed normal
    _THINK + "<location>top left</location><type>scratch</type>"
    "<answer>Yes</answer>",             # anomalous, right type and location
    _THINK + "<answer>Yes</answer>",                    # missing tags
    _THINK + "<location>top left</location><type>hole</type>"
    "<answer>Yes</answer>",                             # wrong type
    _THINK + "<location>top left</location><type>scratch</type>"
    "<answer>No</answer>",              # the answer contradicts the tags
    "The image shows a metal surface; I cannot tell.",  # free text
    _THINK + "<location>bottom right</location><type>crack</type>"
    "<answer>Yes</answer>",                     # wrong type and location
    "<answer>No</answer>",                              # no reasoning
]


class CannedTokenizer:
    """What GRPOTrainer needs of a tokenizer (no vocabulary is in the
    repository).  ``batch_decode`` picks each row's text from
    ``CANNED_RESPONSES`` by the token ids: row i of a call reads entry
    (sum of the call's ids + i) mod 8, so the rows of a group read four
    consecutive entries and never score alike."""

    eos_token_id, pad_token_id = IM_END, ENDOFTEXT

    def batch_decode(self, seqs, skip_special_tokens=True):
        base = sum(int(np.sum(s)) for s in seqs)
        return [CANNED_RESPONSES[(base + i) % len(CANNED_RESPONSES)]
                for i in range(len(seqs))]


class StandInTokenizer:
    """What VLMGenerator needs of a tokenizer, with no vocabulary in the
    repository: ``encode`` maps the chatml specials to their ids and every
    other character to its code point (all below the specials) and keeps
    the texts it encoded; ``batch_decode`` hands out ``responses`` in turn,
    one per row decoded, so what a run answers is known in advance."""

    eos_token_id, pad_token_id = IM_END, ENDOFTEXT
    SPECIALS = {"<|im_start|>": IM_START, "<|im_end|>": IM_END,
                "<|endoftext|>": ENDOFTEXT, "<|vision_start|>": VISION_START,
                "<|image_pad|>": IMAGE_PAD, "<|vision_end|>": VISION_END}

    def __init__(self, responses):
        self.responses = responses
        self.decoded = 0
        self.encoded = []
        self._split = re.compile(
            "(" + "|".join(map(re.escape, self.SPECIALS)) + ")")

    def encode(self, text, add_special_tokens=False):
        self.encoded.append(text)
        ids = []
        for piece in self._split.split(text):
            if piece in self.SPECIALS:
                ids.append(self.SPECIALS[piece])
            else:
                ids.extend(ord(c) for c in piece)
        return ids

    def batch_decode(self, seqs, skip_special_tokens=True):
        out = [self.responses[(self.decoded + i) % len(self.responses)]
               for i in range(len(seqs))]
        self.decoded += len(seqs)
        return out


# phase 8: one answer per item, in the benchmark's order (normal items are
# the even ones, whose right letter is B = "No."), and the letters
# extract_option_answer gives them.  Normal 3 of 4 right, defective 2 of
# 4: balanced accuracy (75 + 50) / 2 = 62.5
EVAL_RESPONSES = [
    "<answer>No</answer>",                               # B, right
    "<answer>Yes</answer>",                              # A, right
    "<answer>Yes</answer>",                              # A, overkill
    "The surface looks uneven; I cannot tell.",          # E, no tag
    _THINK + "<answer>No</answer>",                      # B, right
    "<answer>No</answer>",                               # B, miss
    "<answer>no</answer>",                               # B, right
    _THINK + "<answer>Yes.</answer>",                    # A, right
]
EVAL_LETTERS = "BAAEBBBA"
EVAL_CSV = (",Anomaly Detection,Average\nSynthAD,62.5,62.5\n"
            "Average,62.5,62.5\n")
CHAT_SYSTEM = "Answer in one word."
CHAT_RESPONSES = ["<answer>No</answer>", "<answer>Yes</answer>",
                  "There is a scratch near the top left corner.",
                  _THINK + "<answer>No</answer>", "A hole."]


def make_eval_benchmark(path: str) -> None:
    """A benchmark JSON in the test_*_format.json layout: 8 images of one
    dataset, every other one normal, one Yes/No question each."""
    data = {}
    for i in range(8):
        rel = f"SynthAD/cls/{'good' if i % 2 == 0 else 'defect'}/{i}.png"
        data[rel] = {"image_path": rel, "conversation": [{
            "Question": "Are there any defects in the query image?",
            "Answer": "B" if i % 2 == 0 else "A",
            "Options": {"A": "Yes.", "B": "No."},
            "type": "Anomaly Detection"}],
            "similar_templates": [], "random_templates": []}
    with open(path, "w") as f:
        json.dump(data, f)


def make_grpo_examples(seed: int = 2):
    """Two already-tokenized chatml image prompts (a seeded image each, the
    serving phase's two sizes) with a ``solution`` in the reward grammar:
    one normal, one anomalous."""
    from iadr1_tpu_torch.vision.preprocess import patchify_image

    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples = []
    for i, (h, w) in enumerate(IMAGE_HW[:GRPO_PROMPTS]):
        flat, grid = patchify_image(rng.random((h, w, 3), dtype=np.float32))
        n_img = int(np.prod(grid)) // 4
        ids = ([IM_START] + text(3) + [IM_END] + text(1)
               + [IM_START] + text(2)
               + [VISION_START] + [IMAGE_PAD] * n_img + [VISION_END]
               + text(40 + 25 * i) + [IM_END] + text(1)
               + [IM_START] + text(2))
        examples.append({"prompt_ids": ids, "patches": [flat],
                         "grid_thw": [grid], "solution": GRPO_SOLUTIONS[i]})
    return examples


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


def phase_kernels(encoded, max_new_tokens, train_rows, grpo_examples):
    from iadr1_tpu_torch.train.grpo import GRPOConfig
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

    # the SC-GRPO step's shapes (GRPOConfig's defaults): n unique prompts,
    # left-padded, their ids repeated over the group for the completions'
    # cross attention; completion ids with seeded trailing zeros (rollouts
    # that ended early: rows with no valid key on either side), one rollout
    # of a single token and one of full length among them
    gcfg = GRPOConfig()
    G, P, N = (gcfg.num_generations, gcfg.max_prompt_length,
               gcfg.max_completion_length)
    n = len(grpo_examples)
    p_seg = torch.zeros((n, P), **cuda)
    for b, ex in enumerate(grpo_examples):
        p_seg[b, P - len(ex["prompt_ids"]):] = 1
    p_rep = p_seg.repeat_interleave(G, dim=0)
    stops = torch.randint(2, N, (n * G,), generator=g)
    stops[0], stops[1] = N, 1
    c_seg = (torch.arange(N)[None, :] < stops[:, None]).to(**cuda)
    tower_grpo = torch.as_tensor(vision_segment_ids(
        [gr for ex in grpo_examples for gr in ex["grid_thw"]],
        pad_to=GRPO_PATCH_BUDGET // G), **cuda)[None]
    T_tower = tower_grpo.shape[1]
    grpo_shapes = [
        ("grpo cross", (n * G, 12, 2, N, P, 128, False, c_seg, p_rep), True),
        ("grpo self", (n * G, 12, 2, N, N, 128, True, c_seg, c_seg), True),
        ("grpo prompt", (n, 12, 2, P, P, 128, True, p_seg, p_seg), False),
        ("grpo tower", (1, 16, 16, T_tower, T_tower, 80, False, tower_grpo,
                        tower_grpo), False),
    ]
    grpo_bwd, grpo_fwd = [], []
    for i, (label, shape, dlse) in enumerate(grpo_shapes):
        results = (*bwd_case(*shape, 31 + i, timed=True, with_dlse=dlse),
                   flash_case(*shape, 41 + i, timed=True))
        for r in results:
            r["shape"] = f"{label}: {r['shape']}"
        grpo_bwd.append(results[:3])
        grpo_fwd.append(results[3])
    # K4 over the fanned-out cache: the group's rows share their prompt's
    # ids, then each has its own, frozen at 0 after its EOS; at the length
    # of the first, a middle and the last decode step
    fan_seg = torch.cat([p_rep, c_seg], dim=1)
    grpo_dec = [decode_case(n * G, 12, 2, P + N, 128, length, fan_seg, 51 + i,
                            timed=(length == P + N))
                for i, length in enumerate((P + 1, P + N // 2, P + N))]
    for r in grpo_dec:
        r["shape"] = f"grpo fan-out: {r['shape']}"
    bwd += grpo_bwd
    extra += grpo_fwd + [fwd for _, _, fwd in grpo_bwd]
    dec_extra += grpo_dec[::-1]             # the timed one first
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

    prefill_ms = time_prefill(gen, batch)

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


def time_prefill(gen, batch) -> float:
    """Host ms of one synchronised prefill (tower + decoder and the last
    position's logits) of a collated batch, warm (the second of two)."""
    from iadr1_tpu_torch.models import qwen2

    B, P = batch["input_ids"].shape
    b = {**batch, "segment_ids": batch["attention_mask"].to(torch.int32)}
    for _ in range(2):
        cache = qwen2.init_cache(gen.bundle.cfg.text, B, P, torch.bfloat16,
                                 DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            h, _ = gen.bundle.apply(gen.params, b, cache=cache,
                                    cache_mode="prefill")
            gen.bundle.logits_fn(gen.params, h[:, -1:])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return ms


class GenerateTap:
    """Stands in for ``engine.generate`` and records, for each call, its
    synchronised wall time, its decode steps and the kernels' launches
    during it."""

    def __init__(self, engine, kernels):
        self.kernels, self.calls = kernels, []
        self._generate = engine.generate
        engine.generate = self

    def __call__(self, *args, **kw):
        before = {k.name: k.launches for k in self.kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = self._generate(*args, **kw)
        torch.cuda.synchronize()
        self.calls.append({
            "s": time.perf_counter() - t0,
            "steps": result["num_decode_steps"],
            "launches": {k.name: k.launches - before[k.name]
                         for k in self.kernels}})
        return result


def host_timed(fn, times: list):
    """``fn`` with each call's host time appended to ``times`` (s)."""
    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times.append(time.perf_counter() - t0)
        return out
    return timed


def check_batch_launches(label, call, cfg) -> None:
    """One generate of one batch: K1 once per tower and decoder layer (the
    tower runs over the patch budget whether or not a request holds an
    image), K4 once per decoder layer and decode step, no backward."""
    want = {"flash_fwd": cfg.vision.depth + cfg.text.num_hidden_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": cfg.text.num_hidden_layers * call["steps"]}
    if call["launches"] != want or call["steps"] < 1:
        raise AssertionError(f"{label}: launches {call['launches']} over "
                             f"{call['steps']} decode steps, want {want}")


def phase_eval(gen, card) -> dict:
    """Phase 8: the benchmark harness on the serving generator."""
    import tempfile

    from iadr1_tpu_torch.eval.generator import VLMGenerator
    from iadr1_tpu_torch.eval.harness import (
        load_benchmark,
        run_benchmark,
        summarize,
    )
    from iadr1_tpu_torch.kernels import all_kernels

    cfg = gen.bundle.cfg
    tokenizer = StandInTokenizer(EVAL_RESPONSES)
    gen = VLMGenerator(gen.bundle, gen.params, tokenizer, gen.template,
                       gen.cfg, device=DEVICE)
    kernels = [k for k, _ in all_kernels()]
    tap = GenerateTap(gen.engine, kernels)
    collate_s, batch_s = [], []
    gen._collate = host_timed(gen._collate, collate_s)
    with tempfile.TemporaryDirectory() as tmp:
        bench = os.path.join(tmp, "test_SynthAD_format.json")
        make_eval_benchmark(bench)
        items = load_benchmark(bench)
        # already-encoded image requests in place of the images
        encoded = dict(zip([it.image for it in items],
                           make_requests(3) + make_requests(4)))

        def generate_fn(batch_items):
            t0 = time.perf_counter()
            texts = gen._generate_encoded([encoded[it.image]
                                           for it in batch_items])
            batch_s.append(time.perf_counter() - t0)
            return texts

        answers_path = os.path.join(tmp, "answers_0_shot.json")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        answers = run_benchmark(items, generate_fn, answers_path,
                                batch_size=gen.cfg.batch_size)
        total_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        table = summarize(answers_path)
        with open(answers_path.replace(".json", "_accuracy.csv")) as f:
            csv_text = f.read()
        with open(answers_path, "rb") as f:
            written = f.read()

        letters = "".join(a["gpt_answer"] for a in answers)
        if (len(answers) != len(items) or letters != EVAL_LETTERS
                or [a["response"] for a in answers] != EVAL_RESPONSES):
            raise AssertionError(f"eval: answers {letters!r}, want "
                                 f"{EVAL_LETTERS!r}: {answers}")
        if csv_text != EVAL_CSV:
            raise AssertionError(f"eval: accuracy CSV {csv_text!r}, want "
                                 f"{EVAL_CSV!r}")
        if len(tap.calls) != len(items) // gen.cfg.batch_size:
            raise AssertionError(f"eval: {len(tap.calls)} generates")
        for i, call in enumerate(tap.calls):
            check_batch_launches(f"eval batch {i}", call, cfg)

        # a second call over the same file resumes: nothing to generate
        again = run_benchmark(items, generate_fn, answers_path,
                              batch_size=gen.cfg.batch_size)
        with open(answers_path, "rb") as f:
            unchanged = f.read() == written
        resumed = {k.name: k.launches for k in kernels}
        if resumed != launches or len(tap.calls) != 2 or not unchanged or (
                again != answers):
            raise AssertionError(
                f"eval: the resumed call launched {resumed} against "
                f"{launches}, file unchanged {unchanged}")
        collate_ms = 1e3 * statistics.median(collate_s)
        prefill_ms = time_prefill(gen, gen._collate(list(encoded.values())[:4]))

    steps = [c["steps"] for c in tap.calls]
    engine_ms = [1e3 * c["s"] for c in tap.calls]
    decode_ms = statistics.median((ms - prefill_ms) / n
                                  for ms, n in zip(engine_ms, steps))
    log(f"eval: {len(items)} items (balanced accuracy "
        f"{table.at('SynthAD', 'Anomaly Detection')}, letters {letters}) in "
        f"{len(tap.calls)} batches of {gen.cfg.batch_size}, decode steps "
        f"{steps}; launches {launches}; the resumed call launched nothing "
        f"and left the answers file unchanged")
    log(f"eval: {len(items) / total_s:.3f} items/s, "
        f"{1e3 * statistics.median(batch_s):.1f} ms per batch (median; "
        f"{[round(1e3 * x, 1) for x in batch_s]}), of which collation "
        f"{collate_ms:.2f} ms on the host; prefill "
        f"{prefill_ms:.2f} ms measured apart, decode {decode_ms:.3f} ms/step "
        f"on {card}")
    return launches


def phase_chat(gen, card, max_new_tokens: int = 32) -> dict:
    """Phase 9: the OpenAI-compatible server over the serving weights."""
    import dataclasses
    import threading
    import urllib.request

    from iadr1_tpu_torch.eval.generator import VLMGenerator
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.serve.api import ChatServer

    cfg = gen.bundle.cfg
    tokenizer = StandInTokenizer(CHAT_RESPONSES)
    gen = VLMGenerator(gen.bundle, gen.params, tokenizer, gen.template,
                       dataclasses.replace(gen.cfg,
                                           max_new_tokens=max_new_tokens),
                       device=DEVICE)
    kernels = [k for k, _ in all_kernels()]
    tap = GenerateTap(gen.engine, kernels)
    generates, encode_s = [], []
    gen._encode_request = host_timed(gen._encode_request, encode_s)
    generate = gen.generate

    def counted_generate(requests):
        generates.append(len(requests))
        return generate(requests)

    gen.generate = counted_generate
    # a wait window far longer than 4 threads take to send their requests
    server = ChatServer(gen, host="127.0.0.1", port=0,
                        max_batch=gen.cfg.batch_size, batch_wait_ms=2000)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"

    def post(messages):
        req = urllib.request.Request(
            base + "/v1/chat/completions",
            data=json.dumps({"model": "qwen2-vl-2b",
                             "messages": messages}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = json.loads(resp.read())
        body["_s"] = time.perf_counter() - t0
        choice = body["choices"][0]
        if (resp.status != 200 or body["object"] != "chat.completion"
                or not body["id"].startswith("chatcmpl-")
                or body["model"] != "qwen2-vl-2b"
                or choice["message"]["role"] != "assistant"
                or choice["finish_reason"] != "stop"
                or choice["message"]["content"] not in CHAT_RESPONSES):
            raise AssertionError(f"chat: response {body}")
        return body

    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as resp:
            models = json.loads(resp.read())
        if models["object"] != "list" or models["data"][0]["object"] != "model":
            raise AssertionError(f"chat: /v1/models answered {models}")

        one = post([{"role": "system", "content": CHAT_SYSTEM},
                    {"role": "user", "content": "Are there any defects?"}])
        prompt = tokenizer.encoded[-1]
        if (f"<|im_start|>system\n{CHAT_SYSTEM}<|im_end|>" not in prompt
                or "helpful assistant" in prompt):
            raise AssertionError(f"chat: the system message did not become "
                                 f"the system block: {prompt!r}")

        for k in kernels:
            k.launches = 0
        n_calls = len(tap.calls)
        replies = [None] * gen.cfg.batch_size

        def ask(i):
            replies[i] = post([{"role": "user",
                                "content": f"Request {i}: any defects?"}])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(replies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    finally:
        server.shutdown()
    if any(t.is_alive() for t in threads) or None in replies:
        raise AssertionError("chat: a concurrent request did not finish")
    if generates != [1, len(replies)] or len(tap.calls) != n_calls + 1:
        raise AssertionError(f"chat: generate calls of sizes {generates}, "
                             f"want [1, {len(replies)}]")
    check_batch_launches("chat batch", tap.calls[-1], cfg)
    if sorted(r["choices"][0]["message"]["content"] for r in replies) != (
            sorted(CHAT_RESPONSES[(1 + i) % len(CHAT_RESPONSES)]
                   for i in range(len(replies)))):
        raise AssertionError("chat: the batch's rows reached the wrong "
                             "requests")
    log(f"chat: /v1/models, a request with a system message (its system "
        f"block in the prompt; {1e3 * one['_s']:.1f} ms, {tap.calls[0]['steps']} "
        f"decode steps) and {len(replies)} concurrent requests coalesced into "
        f"one generate of {tap.calls[-1]['steps']} decode steps "
        f"({1e3 * tap.calls[-1]['s']:.1f} ms), all answered in "
        f"{1e3 * wall_s:.1f} ms (requests {[round(1e3 * r['_s'], 1) for r in replies]} "
        f"ms); request encoding {1e3 * statistics.median(encode_s):.3f} ms "
        f"each on the host; launches {launches} on {card}")
    return launches


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
    optimizer) and, with ``keep_grads``, those gradients themselves."""

    def __init__(self, optimizer, params, keep_grads=False):
        from iadr1_tpu_torch.train.state import tree_leaves

        leaves = tree_leaves(params)
        attn = params["text"]["layers"]["attn"]
        targets = [attn[n]["kernel"] for n in "qkv"]
        targets.append(params["vision"]["blocks"]["attn"]["qkv"]["kernel"])
        self.index = [next(i for i, p in enumerate(leaves) if p is t)
                      for t in targets]
        self.optimizer, self.norms = optimizer, None
        self.keep_grads, self.grads = keep_grads, None

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
            if self.keep_grads:
                self.grads = {n: g.float().clone() for n, g in parts.items()}
        return self.optimizer.apply(params, grads, state, grad_norm)


def step1_diffs(got, ref) -> dict:
    """Relative differences of step 1's loss, global grad norm and the
    worst per-layer q/k/v projection grad norm."""
    (m, _), (m0, _) = got, ref
    return {"loss": abs(m["loss"] - m0["loss"]) / abs(m0["loss"]),
            **_grad_diffs(got, ref)}


def _grad_diffs(got, ref) -> dict:
    (m, norms), (m0, norms0) = got, ref
    return {
        "grad norm": abs(m["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"],
        "qkv grad norms": max(float(((norms[n] - norms0[n]).abs()
                                     / norms0[n]).max()) for n in norms0),
    }


STEP1_LIMITS = {"loss": STEP1_LOSS_REL, "grad norm": STEP1_GRAD_NORM_REL,
                "qkv grad norms": STEP1_QKV_REL}


def _within(diffs, limits=STEP1_LIMITS) -> bool:
    return all(diffs[k] <= limits[k] for k in limits)


def _diff_text(diffs, limits=STEP1_LIMITS, kind="rel") -> str:
    return ", ".join(f"{k} {kind} {v:.3e} (limit {limits[k]})"
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
    late = len(times) > 4           # the first three steps still warm up
    step_s = statistics.median(times[3:] if late else times[1:])
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
        f"{'4-' if late else '2-'}{steps}; all steps "
        f"{[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, {n_label / step_s:.0f} label "
        f"tokens/s, MFU {meter.mfu:.4f} (decoder + tower model FLOPs, "
        f"x3, against {PEAK_BF16_FLOPS:.3g}), peak memory {peak_gib:.2f} "
        f"GiB, launches {launches} on {card}")
    return launches



# ---------------------------------------------------------------------------
# phase 7: SC-GRPO
# ---------------------------------------------------------------------------


class DropDlseFlash(TwinFlash):
    """The control of the GRPO step-1 check: the plain backward without
    the lse cotangent (delta = rowsum(out * dO) alone, what a backward
    that ignores lse computes).  The shared-prompt merge weighs its two
    attentions by their lses, so its limits must catch this."""

    @staticmethod
    def backward(ctx, do, dlse):
        return TwinFlash.backward(ctx, do, None)


def lse_attn(flash):
    """The (out, lse) attention signature (kernel layout) over a flash
    Function."""
    def attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
             causal=True):
        return flash.apply(q, k, v, q_segments, kv_segments, causal)
    return attn


class RolloutTap:
    """Around the trainer's engine: times each ``generate``, keeps the
    first rollout, and ends the rollouts of ``GRPO_EARLY_EOS`` early (an
    EOS, then padding).  Given ``replay``, it returns that rollout instead
    of generating."""

    def __init__(self, engine, replay=None):
        self.engine, self.replay = engine, replay
        self.seconds, self.steps, self.tokens = [], [], []

    def generate(self, params, batch, generator=None, group_size=1):
        if self.replay is not None:
            return dict(self.replay)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.engine.generate(params, batch, generator,
                                   group_size=group_size)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.steps.append(out["num_decode_steps"])
        ids, mask = out["completion_ids"], out["completion_mask"]
        self.tokens.append(int(mask.sum()))
        sampling = self.engine.sampling
        for row, keep in GRPO_EARLY_EOS:
            if int(mask[row].sum()) > keep:
                ids[row, keep - 1] = sampling.eos_token_id
                ids[row, keep:] = sampling.pad_token_id
                mask[row, keep:] = 0
        if len(self.seconds) == 1:
            self.replay_of_first = {k: v.clone() if torch.is_tensor(v) else v
                                    for k, v in out.items()}
        return out


def grpo_step1_diffs(got, ref) -> dict:
    """Step 1 against the plain path: loss and kl absolutely (both start
    at 0); the global grad norm and the worst per-layer q/k/v projection
    grad norm relatively; and the worst per-layer relative distance
    |g - g0| / |g0| between the q and k projections' gradients, which
    reads a backward that turns them without changing their length (the
    v projection's never reads delta)."""
    (m, norms, grads), (m0, norms0, grads0) = got, ref
    return {"loss": abs(m["loss"] - m0["loss"]),
            "kl": abs(m["kl"] - m0["kl"]),
            **_grad_diffs((m, norms), (m0, norms0)),
            "q/k grad vectors": max(
                float(((grads[n] - grads0[n]).flatten(1).norm(dim=1)
                       / grads0[n].flatten(1).norm(dim=1)).max())
                for n in grads0 if n[-1] in "qk")}


def phase_grpo(examples, steps: int, card):
    """SC-GRPO steps of Qwen2-VL-2B through GRPOTrainer.step, assembled as
    cli/train_grpo.py assembles them; returns the launch counts."""
    import dataclasses
    import gc

    from torch.profiler import ProfilerActivity, profile

    from iadr1_tpu_torch.cli.train_grpo import (
        GRPODataSection,
        GRPOSection,
        make_vlm_prompt_collator,
    )
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models import qwen2, qwen2_vl
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.models.shared_prompt import shared_prompt_pred_hidden
    from iadr1_tpu_torch.rewards import get_reward_funcs
    from iadr1_tpu_torch.train.grpo import (
        UPDATE_RANGES,
        GRPOConfig,
        GRPOTrainer,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.rollout import cast_dense_params
    from iadr1_tpu_torch.train.sft import batch_to_device
    from iadr1_tpu_torch.train.state import create_train_state

    bundle = bundle_from_hf_config(QWEN2_VL_2B)
    cfg = bundle.cfg
    section = GRPOSection()                       # the launcher's defaults
    gcfg = GRPOConfig(
        num_generations=section.num_generations, beta=section.beta,
        temperature=section.temperature, top_p=section.top_p,
        top_k=section.top_k, max_prompt_length=section.max_prompt_length,
        max_completion_length=section.max_completion_length)
    G, P, N = (gcfg.num_generations, gcfg.max_prompt_length,
               gcfg.max_completion_length)
    n = len(examples)
    tokenizer = CannedTokenizer()
    collator = make_vlm_prompt_collator(
        bundle, tokenizer, None, GRPODataSection(
            patch_budget=GRPO_PATCH_BUDGET), P, num_generations=G)
    reward_s = []

    def timed(fn):
        def reward(**kw):
            t0 = time.perf_counter()
            out = fn(**kw)
            reward_s.append(time.perf_counter() - t0)
            return out
        reward.__name__ = fn.__name__
        return reward

    rewards = [timed(fn) for fn in get_reward_funcs(section.reward_funcs)]

    def plain_bundle(flash):
        """The bundle with its shared-prompt scoring over a flash Function
        of the plain versions (the tower and the three decoder calls)."""
        tower_attn, attn_lse = train_attn(flash), lse_attn(flash)

        def shared_pred(params, batch, group_size, remat=True):
            embeds = params["text"]["embed"]["weight"][
                batch["prompt_ids"]].to(torch.bfloat16)
            feats = qwen2_vl.apply_vision(
                params["vision"], cfg.vision, batch["patches"],
                batch["rot_cos"], batch["rot_sin"], batch["vision_segments"],
                attention_fn=tower_attn, remat=bool(remat))
            embeds = qwen2_vl.merge_image_features(
                embeds, feats, batch["scatter_rows"], batch["scatter_cols"])
            return shared_prompt_pred_hidden(
                params["text"], cfg.text, batch, group_size,
                attention_fn=attn_lse, remat=remat, prompt_embeds=embeds)

        return dataclasses.replace(bundle, shared_pred_fn=shared_pred)

    def fresh(used_bundle, replay=None):
        params = bundle.init_params(seed=0, dtype=torch.float32,
                                    device=DEVICE)
        ref = _tree_map(lambda p: p.detach().to(torch.bfloat16), params)
        opt, sched = make_optimizer(OptimizerConfig(
            learning_rate=GRPO_LEARNING_RATE, total_steps=100))
        probe = GradProbe(opt, params, keep_grads=True)
        trainer = GRPOTrainer(
            used_bundle, tokenizer, probe, gcfg, rewards,
            create_train_state(params, probe), ref, schedule=sched,
            prompt_collator=collator, device=DEVICE, seed=0)
        trainer.engine = RolloutTap(trainer.engine, replay)
        return trainer, probe

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # --- the kernel path: the steps, their counts and their times ----------
    trainer, probe = fresh(bundle)
    tap = trainer.engine
    n_params = sum(p.numel() for p in _leaves(trainer.state.params))
    update_s, update_batches = [], []
    inner_update = trainer.update_step

    def timed_update(state, ref_params, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_update(state, ref_params, batch)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        update_batches.append(batch)
        return out

    trainer.update_step = timed_update

    # the rollout's prefill alone (tower + decoder over the n prompts),
    # from the bf16 copy of the policy the trainer rolls out from
    prefill_batch = batch_to_device(collator(examples, 1), DEVICE)
    prefill_batch["segment_ids"] = prefill_batch["attention_mask"].to(
        torch.int32)
    policy = cast_dense_params(trainer.state.params, torch.bfloat16)
    for _ in range(2):                       # the second one is warm
        cache = qwen2.init_cache(cfg.text, n, P, torch.bfloat16, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            bundle.apply(policy, prefill_batch, cache=cache,
                         cache_mode="prefill")
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
    del policy, cache
    release()

    L, Lt = cfg.text.num_hidden_layers, cfg.vision.depth
    kernels = [k for k, _ in all_kernels()]
    step_s, per_step, total = [], [], {k.name: 0 for k in kernels}
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(examples)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        # K1: the rollout's prefill, the reference forward, and the policy
        # forward, whose tower blocks run again in the backward (a plain
        # checkpoint); the three decoder calls of a layer keep their
        # residuals.  K2 and K3: once per attention call of the policy.
        want = {"flash_fwd": (L + Lt) + (3 * L + Lt) + (3 * L + 2 * Lt),
                "flash_bwd_dq": 3 * L + Lt, "flash_bwd_dkv": 3 * L + Lt,
                "decode_attention": L * tap.steps[i]}
        if launches != want or tap.steps[i] < 1:
            raise AssertionError(f"grpo step {i + 1} launches {launches}, "
                                 f"want {want}")
        per_step.append(launches)
        for name, count in launches.items():
            total[name] += count
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainer.metrics_history
    first = (history[0], probe.norms, probe.grads)
    roll_s, roll_steps, roll_tokens = tap.seconds, tap.steps, tap.tokens

    adv = np.asarray(update_batches[0]["advantages"]).reshape(n, G)
    log(f"grpo: step 1 rewards mean {history[0]['reward']:.4f}, group std "
        f"{history[0]['reward_std']:.4f}, advantages "
        f"{[[round(float(a), 3) for a in row] for row in adv]}, completion "
        f"length {history[0]['completion_length']:.1f} (rollouts "
        f"{[r for r, _ in GRPO_EARLY_EOS]} ended early at "
        f"{[k for _, k in GRPO_EARLY_EOS]} tokens)")
    if not history[0]["reward_std"] > 0 or not (adv != 0).any(axis=1).all():
        raise AssertionError("a group of step 1 has no advantage")
    for i, m in enumerate(history):
        bad = {k: v for k, v in m.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"grpo step {i + 1}: non-finite {bad}")
    if not abs(history[0]["kl"]) < GRPO_KL_STEP1_MAX:
        raise AssertionError(f"kl at step 1 is {history[0]['kl']}")

    # where an update's time goes: one more update under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = inner_update(trainer.state, trainer.ref_params,
                                        update_batches[-1])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log("profile: one GRPO update (reference forward, policy forward and "
        "backward, AdamW): "
        + device_time_summary(prof, wall_ms, top_n=10, ranges=UPDATE_RANGES))
    recorded = tap.replay_of_first
    del trainer, probe, tap, inner_update, prof, update_batches
    release()

    # --- step 1 on the same rollout through the plain versions, and the
    # control that drops the lse cotangent --------------------------------
    def replayed_step(flash):
        trainer, probe = fresh(plain_bundle(flash), recorded)
        res = trainer.step(examples), probe.norms, probe.grads
        del trainer, probe
        release()
        return res

    plain = replayed_step(TwinFlash)
    control = grpo_step1_diffs(replayed_step(DropDlseFlash), plain)
    log("grpo: step 1 control (plain path without the lse cotangent) vs "
        "plain path: " + _diff_text(control, GRPO_STEP1_LIMITS, "diff"))
    diffs = grpo_step1_diffs(first, plain)
    log(f"grpo: step 1 kernel vs plain path on the recorded rollout: loss "
        f"{first[0]['loss']:.3e} vs {plain[0]['loss']:.3e}, kl "
        f"{first[0]['kl']:.3e} vs {plain[0]['kl']:.3e}, grad norm "
        f"{first[0]['grad_norm']:.6f} vs {plain[0]['grad_norm']:.6f}; "
        + _diff_text(diffs, GRPO_STEP1_LIMITS, "diff"))
    if _within(control, GRPO_STEP1_LIMITS):
        raise AssertionError(
            "the step-1 limits do not catch a dropped lse cotangent")
    if not _within(diffs, GRPO_STEP1_LIMITS):
        raise AssertionError("GRPO step 1 differs between kernel and plain "
                             "path")

    # --- the report -------------------------------------------------------
    late = slice(1, None) if steps > 1 else slice(None)

    def med(xs):
        return statistics.median(list(xs)[late])

    R = len(rewards)
    rollout_ms = med(1e3 * s for s in roll_s)
    decode_ms = med((1e3 * s - prefill_ms) / k
                    for s, k in zip(roll_s, roll_steps))
    tokens_s = med(t / s for t, s in zip(roll_tokens, roll_s))
    reward_ms = med(1e3 * sum(reward_s[i * R:(i + 1) * R])
                    for i in range(steps))
    update_ms, step_ms = med(1e3 * s for s in update_s), med(
        1e3 * s for s in step_s)
    log(f"grpo: Qwen2-VL-2B {n_params / 1e9:.3f}B f32 policy + bf16 "
        f"reference, {steps} steps of {n} prompts x G={G} (P={P}, N={N}, "
        f"{sum(int(np.prod(g)) for ex in examples for g in ex['grid_thw'])} "
        f"patches), lr {GRPO_LEARNING_RATE} cosine; loss "
        f"{[float(format(m['loss'], '.3e')) for m in history]}, kl "
        f"{[float(format(m['kl'], '.3e')) for m in history]}, grad norm "
        f"{[round(m['grad_norm'], 5) for m in history]}, reward "
        f"{[round(m['reward'], 4) for m in history]}, decode steps "
        f"{roll_steps}")
    log(f"grpo: step {step_ms:.1f} ms (median of steps "
        f"{'2-' + str(steps) if steps > 2 else min(steps, 2)}; all steps "
        f"{[round(1e3 * x, 1) for x in step_s]} ms), "
        f"{1e3 * n * G / step_ms:.3f} rollouts/s; rollout {rollout_ms:.1f} "
        f"ms (prefill {prefill_ms:.2f} ms measured apart, decode "
        f"{decode_ms:.3f} ms/step at B={n * G}, {tokens_s:.1f} generated "
        f"tokens/s), rewards {reward_ms:.2f} ms on the host, update "
        f"{update_ms:.1f} ms, peak memory {peak_gib:.2f} GiB, launches per "
        f"step {per_step[-1]} on {card}")
    return total


# ---------------------------------------------------------------------------
# phase 10: the IAD-R1 chain through run_pipeline
# ---------------------------------------------------------------------------

# Qwen's special tokens at their published ids (the config's token ids)
QWEN_SPECIALS = {"<|endoftext|>": ENDOFTEXT, "<|im_start|>": IM_START,
                 "<|im_end|>": IM_END, "<|vision_start|>": VISION_START,
                 "<|vision_end|>": VISION_END, "<|image_pad|>": IMAGE_PAD,
                 "<|video_pad|>": 151656}
CHAIN_IMAGE_HW = (448, 448)           # 1024 patches, 256 image tokens
CHAIN_SFT_ROWS, CHAIN_RL_ROWS = 8, 4
# the stages of one run_pipeline call: SFT (cli/train_sft.py's cutoff and
# CE chunk, remat on), GRPO warm-started from the SFT export (the
# launcher's G and P, N cut to 64: phase 7 covers N=512), and the eval
# (the infer CLI's P and patch budget, batch 4, 32 new tokens)
CHAIN_SFT_STEPS, CHAIN_GRPO_STEPS, CHAIN_NEW_TOKENS = 2, 2, 32
CHAIN_G, CHAIN_P, CHAIN_N = 4, 1024, 64
# the chain's model: the published widths, its depth cut to 12 of the 28
# decoder layers and 12 of the 32 tower blocks.  A run writes, per
# parameter, the bf16 base, two f32 TrainStates (parameters + two AdamW
# moments) and two f32 exports, 34 bytes: 75 GB at full depth, 36 GB at
# this one, so the whole smoke writes under CHAIN_WRITE_LIMIT to its disk
CHAIN_TEXT_LAYERS, CHAIN_TOWER_DEPTH = 12, 12
CHAIN_WRITE_BYTES_PER_PARAM = 2 + 2 * (12 + 4)
GIB = 2 ** 30
CHAIN_WRITE_LIMIT = 40 * GIB


def write_chain_tokenizer(path: str, vocab_size: int) -> None:
    """A tokenizer AutoTokenizer loads, with no vocabulary in the
    repository: one WordLevel entry per id of the head ("w<id>"), Qwen's
    specials at their published ids, so every id the head can draw
    decodes and the config's token ids stay the published ones."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {f"w{i}": i for i in range(vocab_size)}
    for token, i in QWEN_SPECIALS.items():
        del vocab[f"w{i}"]
        vocab[token] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(list(QWEN_SPECIALS))
    PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="w0", eos_token="<|im_end|>",
        pad_token="<|endoftext|>",
        additional_special_tokens=[t for t in QWEN_SPECIALS
                                   if t not in ("<|im_end|>",
                                                "<|endoftext|>")],
    ).save_pretrained(path)


def make_chain_data(root: str, seed: int = 5) -> dict:
    """Seeded 448x448 PNG images and the three datasets of the chain, in
    tests/helpers.py's formats: 8 IAD SFT rows in sharegpt form (answers
    of 600-720 seeded words, so the 8 pack two to a row of 2048 tokens,
    as phase 6's), 4 RL rows, and phase 8's MCQ benchmark of 8 items."""
    from PIL import Image

    rng = np.random.default_rng(seed)

    def image(rel):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (*CHAIN_IMAGE_HW, 3),
                                     np.uint8)).save(path)
        return rel

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(1, ENDOFTEXT, n))

    sft = []
    for i in range(CHAIN_SFT_ROWS):
        n = int(rng.integers(ANSWER_LEN[0], ANSWER_LEN[1] + 1))
        sft.append({"messages": [
            {"role": "user",
             "content": "<image>Are there any defects in the image?"},
            {"role": "assistant",
             "content": f"<think>{words(n)}</think>"
                        + GRPO_SOLUTIONS[i % 2].split("</think>")[-1]}],
            "images": [image(f"sft/img_{i}.png")]})
    rl = [{"image": image(f"rl/rl_{i}.png"),
           "problem": "Are there any defects in the image?",
           "solution": GRPO_SOLUTIONS[i % 2]} for i in range(CHAIN_RL_ROWS)]
    paths = {"sft": os.path.join(root, "sft.json"),
             "rl": os.path.join(root, "rl.json"),
             "bench": os.path.join(root, "test_SynthAD_format.json")}
    for key, rows in (("sft", sft), ("rl", rl)):
        with open(paths[key], "w") as f:
            json.dump(rows, f)
    make_eval_benchmark(paths["bench"])
    with open(paths["bench"]) as f:
        for rel in json.load(f):
            image(os.path.join("bench", rel))
    return paths


def _file_gb(path: str) -> float:
    return os.path.getsize(path) / 1e9


class ChainTap:
    """Wraps the chain's entry points for the length of phase 10: each
    stage (the CLIs' mains and the exports) with its wall time, peak
    memory, the memory still allocated when it returns and the kernels'
    launches during it; each checkpoint save, restore and export with its
    seconds and GB; each rollout or eval generate with its decode
    steps; and every call of a plain twin."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.stages, self.io, self.generates = [], [], []
        self.twin_calls = {}
        self._undo = []

    def _patch(self, owner, name, make):
        old = getattr(owner, name)
        setattr(owner, name, make(old))
        self._undo.append((owner, name, old))

    def _launches(self):
        return {k.name: k.launches for k in self.kernels}

    def stage(self, owner, name, label):
        """``label``: the stage's name, or a function of the call's
        arguments that gives it."""
        def make(fn):
            def run(*args, **kw):
                before, calls = self._launches(), len(self.generates)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.stages.append({
                    "stage": label(args, kw) if callable(label) else label,
                    "s": time.perf_counter() - t0,
                    "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                    "after_gib": torch.cuda.memory_allocated() / GIB,
                    "launches": {k: v - before[k]
                                 for k, v in self._launches().items()},
                    "generates": self.generates[calls:]})
                return out
            return run
        self._patch(owner, name, make)

    def timed_io(self, owner, name, label, path_of, gb_of=None):
        """``path_of``: the file the call wrote or read; ``gb_of``: the
        GB it moved, where that is not the whole file."""
        def make(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                path = path_of(args, kw, out)
                if path is not None:
                    gb = gb_of(out) if gb_of else _file_gb(path)
                    self.io.append({"what": label, "s": seconds, "gb": gb,
                                    "file": "/".join(path.split(os.sep)[-3:])})
                return out
            return run
        self._patch(owner, name, make)

    def generate(self, engine_cls):
        def make(fn):
            def run(engine, *args, **kw):
                out = fn(engine, *args, **kw)
                self.generates.append(int(out["num_decode_steps"]))
                return out
            return run
        self._patch(engine_cls, "generate", make)

    def twin(self, module, name):
        self.twin_calls[name] = 0

        def make(fn):
            def run(*args, **kw):
                self.twin_calls[name] += 1
                return fn(*args, **kw)
            return run
        self._patch(module, name, make)

    def close(self):
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)
        self._undo.clear()


def chain_stage_launches(stage, cfg) -> dict:
    """The launches a stage's path implies, as phases 6-8 count them."""
    L, Lt = cfg.text.num_hidden_layers, cfg.vision.depth
    steps, n = stage["generates"], len(stage["generates"])
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": 0}
    if stage["stage"] == "sft":
        # K1 once per decoder layer and twice per tower block (the tower's
        # plain checkpoint replays it); K2 and K3 once per attention call
        return {**zero, "flash_fwd": CHAIN_SFT_STEPS * (L + 2 * Lt),
                "flash_bwd_dq": CHAIN_SFT_STEPS * (L + Lt),
                "flash_bwd_dkv": CHAIN_SFT_STEPS * (L + Lt)}
    if stage["stage"] == "grpo":
        # per step: the rollout's prefill, the reference forward and the
        # policy forward (tower replayed); K2, K3 per policy attention
        # call; K4 per decode step and layer
        return {"flash_fwd": n * ((L + Lt) + (3 * L + Lt) + (3 * L + 2 * Lt)),
                "flash_bwd_dq": n * (3 * L + Lt),
                "flash_bwd_dkv": n * (3 * L + Lt),
                "decode_attention": L * sum(steps)}
    if stage["stage"] == "eval":
        # per batch: K1 per tower and decoder layer, K4 per decode step
        return {**zero, "flash_fwd": n * (L + Lt),
                "decode_attention": L * sum(steps)}
    return zero                                          # the exports


def phase_chain(card) -> dict:
    """Phase 10: the IAD-R1 chain at full Qwen2-VL-2B width through one
    call of the port's run_pipeline; returns the launch counts."""
    import shutil
    import tempfile

    from iadr1_tpu_torch.cli import infer, pipeline, train_grpo, train_sft
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels import decode_attention as decode_mod
    from iadr1_tpu_torch.kernels import flash_attention as flash_mod
    from iadr1_tpu_torch.models import params_export, params_io
    from iadr1_tpu_torch.models.registry import (
        bundle_from_hf_config,
        bundle_from_pretrained,
    )
    from iadr1_tpu_torch.train import checkpoint, rollout
    from iadr1_tpu_torch.train.state import TrainState

    kernels = [k for k, _ in all_kernels()]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_chain_", dir=build)
    tap = ChainTap(kernels)
    hf_config = dict(
        QWEN2_VL_2B,
        text_config=dict(QWEN2_VL_2B["text_config"],
                         num_hidden_layers=CHAIN_TEXT_LAYERS),
        vision_config=dict(QWEN2_VL_2B["vision_config"],
                           depth=CHAIN_TOWER_DEPTH))
    try:
        bundle = bundle_from_hf_config(hf_config)
        cfg = bundle.cfg
        # --- the base checkpoint: published widths, seeded bf16 weights,
        # a tokenizer that covers the head --------------------------------
        params = bundle.init_params(seed=0, dtype=torch.bfloat16,
                                    device=DEVICE)
        n_params = sum(p.numel() for p in _leaves(params))
        need = n_params * CHAIN_WRITE_BYTES_PER_PARAM * 1.02 + 1e9
        free = shutil.disk_usage(root).free
        log(f"chain: {n_params / 1e9:.3f}B parameters ({CHAIN_TEXT_LAYERS} "
            f"decoder layers, {CHAIN_TOWER_DEPTH} tower blocks); the chain "
            f"writes {need / 1e9:.1f} GB to disk, {free / 1e9:.1f} GB free "
            f"under {root}")
        if need > CHAIN_WRITE_LIMIT:
            raise AssertionError(
                f"phase 10 would write {need / 1e9:.1f} GB, over its limit "
                f"of {CHAIN_WRITE_LIMIT / 1e9:.1f} GB")
        if free < need:
            raise AssertionError(
                f"phase 10 needs {need / 1e9:.1f} GB on disk under {root} "
                f"and has {free / 1e9:.1f} GB: {(need - free) / 1e9:.1f} "
                "GB short")
        base = os.path.join(root, "base")
        os.makedirs(base)
        with open(os.path.join(base, "config.json"), "w") as f:
            json.dump(hf_config, f)
        write_chain_tokenizer(base, cfg.text.vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_export.save_pretrained(bundle, params, base)
        base_s = time.perf_counter() - t0
        del params
        data = make_chain_data(os.path.join(root, "data"))
        out = os.path.join(root, "run")
        image_kw = dict(min_pixels=3136, max_pixels=480000)
        pipe_cfg = pipeline.PipelineConfig(
            model_name_or_path=base, output_dir=out,
            sft={"data": {"dataset": data["sft"],
                          "image_dir": os.path.dirname(data["sft"]),
                          "template": "qwen2_vl", "cutoff_len": CUTOFF_LEN,
                          "patch_budget": PATCH_BUDGET, "ce_chunk": CE_CHUNK,
                          **image_kw},
                 "model": {"remat": "true"},
                 "train": {"max_steps": CHAIN_SFT_STEPS,
                           "batch_size": TRAIN_ROWS, "logging_steps": 1,
                           "keep_checkpoints": 1}},
            grpo={"model": {"ref_dtype": "bfloat16"},
                  "data": {"dataset_name": data["rl"],
                           "image_path": os.path.dirname(data["rl"]),
                           "template": "qwen2_vl",
                           "patch_budget": GRPO_PATCH_BUDGET, **image_kw},
                  "grpo": {"num_generations": CHAIN_G,
                           "max_prompt_length": CHAIN_P,
                           "max_completion_length": CHAIN_N,
                           "reward_funcs": GRPO_REWARDS},
                  "train": {"max_steps": CHAIN_GRPO_STEPS,
                            "batch_size": GRPO_PROMPTS, "logging_steps": 1,
                            "keep_checkpoints": 1}},
            eval=pipeline.PipelineEvalSection(
                benchmarks=[{"test_data": data["bench"],
                             "image_dir": os.path.join(
                                 os.path.dirname(data["bench"]), "bench")}],
                batch_size=BATCH, max_prompt_length=PROMPT_LEN,
                max_new_tokens=CHAIN_NEW_TOKENS, patch_budget=PATCH_BUDGET))

        # --- one call of run_pipeline, every entry point tapped -----------
        tap.stage(train_sft, "main", "sft")
        tap.stage(train_grpo, "main", "grpo")
        tap.stage(infer, "main", "eval")
        tap.stage(pipeline, "export_run",
                  lambda a, kw: os.path.basename(a[2]).replace("_", " "))
        tap.timed_io(checkpoint.CheckpointManager, "save", "checkpoint save",
                     lambda a, kw, ok: a[0].path(a[1]) if ok else None)
        tap.timed_io(checkpoint.CheckpointManager, "restore_params",
                     "checkpoint restore (parameters)",
                     lambda a, kw, o: a[0]._step_path(
                         a[1] if len(a) > 1 else kw.get("step")),
                     lambda params: sum(p.numel() * p.element_size()
                                        for p in _leaves(params)) / 1e9)
        tap.timed_io(params_export, "save_pretrained", "HF export",
                     lambda a, kw, o: os.path.join(a[2], "model.safetensors"))
        tap.generate(rollout.RolloutEngine)
        tap.twin(flash_mod, "flash_attention_ref")
        tap.twin(flash_mod, "flash_attention_bwd_ref")
        tap.twin(decode_mod, "decode_attention_ref")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        artifacts = pipeline.run_pipeline(pipe_cfg, device=DEVICE)
        chain_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        tap.close()
        log(f"chain: run_pipeline {chain_s:.1f} s (SFT {CHAIN_SFT_STEPS} "
            f"steps of {TRAIN_ROWS}x{CUTOFF_LEN} -> export -> GRPO "
            f"{CHAIN_GRPO_STEPS} steps of {GRPO_PROMPTS} prompts x "
            f"G={CHAIN_G}, P={CHAIN_P}, N={CHAIN_N} -> export -> eval of 8 "
            f"items, B={BATCH}, {CHAIN_NEW_TOKENS} new tokens); the bf16 "
            f"base written in {base_s:.2f} s; launches {launches} on {card}")
        for st in tap.stages:
            log(f"chain: stage {st['stage']}: {st['s']:.2f} s, peak "
                f"{st['peak_gib']:.2f} GiB, {st['after_gib']:.3f} GiB still "
                f"allocated after it returned, decode steps "
                f"{st['generates']}, launches {st['launches']}")
        for io in tap.io:
            log(f"chain: {io['what']} ({io['file']}): {io['gb']:.2f} GB in "
                f"{io['s']:.2f} s, {io['gb'] / io['s']:.2f} GB/s")

        # --- checks -------------------------------------------------------
        names = [s["stage"] for s in tap.stages]
        if names != ["sft", "sft export", "grpo", "grpo export", "eval"]:
            raise AssertionError(f"chain: stages ran {names}")
        for stage in tap.stages:
            want = chain_stage_launches(stage, cfg)
            if stage["launches"] != want:
                raise AssertionError(
                    f"chain {stage['stage']}: launches {stage['launches']} "
                    f"over decode steps {stage['generates']}, want {want}")
            if stage["after_gib"] >= 1.0:
                raise AssertionError(
                    f"chain {stage['stage']}: {stage['after_gib']:.2f} GiB "
                    "still allocated after it returned")
        if [len(s["generates"]) for s in tap.stages] != [
                0, 0, CHAIN_GRPO_STEPS, 0, 8 // BATCH]:
            raise AssertionError(f"chain: generates {tap.stages}")
        if any(tap.twin_calls.values()):
            raise AssertionError(f"chain: plain twins called on the card: "
                                 f"{tap.twin_calls}")
        total = {k: sum(s["launches"][k] for s in tap.stages)
                 for k in launches}
        if total != launches:
            raise AssertionError(f"chain: launches {launches} outside the "
                                 f"stages' {total}")
        for stage, steps in (("sft", CHAIN_SFT_STEPS),
                             ("grpo", CHAIN_GRPO_STEPS)):
            with open(os.path.join(out, stage, "trainer_log.jsonl")) as f:
                records = [json.loads(line) for line in f]
            values = [v for r in records for v in r.values()
                      if isinstance(v, float)]
            if len(records) != steps or not all(map(math.isfinite, values)):
                raise AssertionError(f"chain {stage}: trainer log {records}")
        sft_export = os.path.join(out, "sft_export")
        with open(os.path.join(out, "grpo_config.json")) as f:
            grpo_base = json.load(f)["model"]["model_name_or_path"]
        if grpo_base != sft_export:
            raise AssertionError(f"chain: GRPO started from {grpo_base}")
        with open(artifacts["results"]["SynthAD"]) as f:
            answers = json.load(f)
        letters = "".join(a["gpt_answer"] for a in answers)
        if len(answers) != 8 or not set(letters) <= set("ABE"):
            raise AssertionError(f"chain eval: answers {letters!r}")
        with open(artifacts["summary_csv"]) as f:
            rows = [line.split(",")[0] for line in f.read().splitlines()[1:]]
        if rows != ["SynthAD", "Average"]:
            raise AssertionError(f"chain: summary rows {rows}")
        with open(artifacts["manifest"]) as f:
            keys = set(json.load(f))
        want_keys = {"output_dir", "sft", "sft_export", "grpo",
                     "grpo_export", "results", "summary_csv"}
        if keys != want_keys:
            raise AssertionError(f"chain: manifest keys {sorted(keys)}")

        # the SFT export, read back as the next stage reads it, against the
        # SFT run's last checkpoint restored into a state of its shape
        t0 = time.perf_counter()
        exported = bundle_from_pretrained(sft_export).convert_hf(
            params_io.load_safetensors_path(sft_export), dtype=torch.float32,
            device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mgr = checkpoint.CheckpointManager(os.path.join(out, "sft",
                                                        "checkpoints"))
        t0 = time.perf_counter()
        restored = mgr.restore(TrainState(
            step=0, params=_tree_map(torch.empty_like, exported),
            opt_state=None))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        pairs = list(zip(_leaves(exported), _leaves(restored.params)))
        same = sum(bool(torch.equal(a, b)) for a, b in pairs)
        params_gb = sum(a.numel() * a.element_size() for a, _ in pairs) / 1e9
        if restored.step != CHAIN_SFT_STEPS or same != len(pairs):
            raise AssertionError(
                f"chain: the SFT export differs from the checkpoint of step "
                f"{restored.step} in {len(pairs) - same} of {len(pairs)} "
                "tensors")
        del exported, restored, pairs
        log(f"chain: all {same} parameter tensors of the SFT export equal "
            f"the SFT checkpoint's (step {CHAIN_SFT_STEPS}) bit for bit; "
            f"the export read back onto the card in {load_s:.2f} s, the "
            f"checkpoint's parameters restored in {restore_s:.2f} s "
            f"({params_gb:.2f} GB each)")
    finally:
        tap.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new-tokens", type=int, default=128,
                    help="new tokens of the serving phase's generate")
    ap.add_argument("--train-steps", type=int, default=4,
                    help="PA-SFT steps (at least 2)")
    ap.add_argument("--grpo-steps", type=int, default=3,
                    help="SC-GRPO steps (at least 1), each a rollout of "
                         "the recipe's 512 tokens")
    args = ap.parse_args()
    if args.train_steps < 2:
        ap.error("--train-steps must be at least 2")
    if args.grpo_steps < 1:
        ap.error("--grpo-steps must be at least 1")
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
    log("imports: " + importable(("tokenizers", "safetensors", "PIL",
                                  "pandas", "yaml", "transformers")))
    kernels = all_kernels()
    secs = build_all([k.source for k, _ in kernels])
    log(f"build: {len(kernels)} kernels from iadr1_tpu_torch/csrc for "
        f"sm_90a in {secs:.1f} s")
    encoded = make_requests()
    train_rows = make_sft_rows()
    grpo_examples = make_grpo_examples()
    measured = phase_kernels(encoded, args.max_new_tokens, train_rows,
                             grpo_examples)
    serve, gen, batch = phase_main(encoded, args.max_new_tokens, card)
    phase_profile(gen, batch)
    evaluated = phase_eval(gen, card)
    chat = phase_chat(gen, card)
    del gen, batch
    torch.cuda.empty_cache()
    train = phase_train(train_rows, args.train_steps, card)
    grpo = phase_grpo(grpo_examples, args.grpo_steps, card)
    chain = phase_chain(card)

    line = []
    for k, replaces in kernels:
        main_case, *others = measured[k.name]
        entry = {"name": k.name, "route": "cuda",
                 "source": f"iadr1_tpu_torch/csrc/{k.source}",
                 "replaces": replaces,
                 "launches_by_path": {"serve": serve[k.name],
                                      "eval": evaluated[k.name],
                                      "chat": chat[k.name],
                                      "train": train[k.name],
                                      "grpo": grpo[k.name],
                                      "chain": chain[k.name]}}
        entry["launches"] = sum(entry["launches_by_path"].values())
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
