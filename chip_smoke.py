#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (iadr1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--max-new-tokens N] [--train-steps N]
                          [--grpo-steps N] [--phases 3,29,30,31]

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
   shape), with their device times (torch.profiler, kernels only) and
   the kernels' shares of live tiles; at each kernel's first case (the
   kernel line's) also the yardsticks: the plain version's time and the
   matching PyTorch call's (F.scaled_dot_product_attention, forward or
   backward), K4's also cold over 28 caches and as one host call (every
   other case holds the kernel to its plain version untimed);
   K1 and K2 also on the edges of their dead-tile skipping (unsorted ids,
   all-padding rows, left padding, stacked query rows that run from one
   head into the next at GQA 6); and all four at the SC-GRPO step's shapes
   (the completions' cross attention to the shared prompt, T != S and
   non-causal, and their causal self attention, both with rows that end
   early and dlse != 0; the unique prompts; the two-image tower; K4 over
   the fanned-out cache of 8 rows); and at LLaVA-OneVision-0.5B's shapes:
   K1-K3 at the SigLIP tower's head dim 72 (22 tiles of 729 patches,
   non-causal; with --pad-compare also with q, k, v and dO padded to 80
   in the wrapper, the design the in-kernel padding was timed against),
   K1 at the prefill (P=4096, GQA 7), K1-K3 at the SFT decoder (4 rows of
   8192) and K4 at GQA 7; and at Qwen2.5-VL's shapes: K1-K3 over the
   window-ordered tower stream at D = 80 with window segments (windows on
   the 64-row blocks, and windows cut at an image's edge) and with image
   segments, K1 at the 7B prefill (GQA 7, D = 128), K1-K3 at the 3B SFT
   decoder (2 rows of 4096, GQA 8), K4 at GQA 7 and over the 3B SC-GRPO
   fan-out (GQA 8, 8 rows of 4608);
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
   bf16 reference copy, bf16 compute, AdamW lr 1e-6) takes 2 steps of
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
   calls them: a base checkpoint (the published config cut to 2 decoder
   layers and 2 tower blocks, so that the run writes about 15 GB to disk
   and not 75, seeded bf16 weights written by save_pretrained, a WordLevel
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

11. LLaVA-OneVision serving (after 10): LLaVA-OneVision-0.5B at full
   width (llava-hf/llava-onevision-qwen2-0.5b-si-hf's config: 24 decoder
   and 26 SigLIP layers, bf16 weights drawn on the card from a seed)
   serves 4 already-tokenized llava_next_qwen requests, images of 448x448
   and 336x560 pixels in turn (anyres: 16 tiles), through
   VLMGenerator._collate and RolloutEngine.generate (P=4096, patch budget
   16384 = 22 tiles, greedy, the serving phase's new tokens); K1 must run
   26 + 24 times a generate and K4 24 times a decode step, no plain twin
   may be called, and the kernel path's prefill logits must agree with
   the twin path's;
12. LLaVA-OneVision PA-SFT (after 11): the same model, its decoder cut
   to 6 of 24 layers, f32 parameters drawn on the card, takes the
   training steps through
   make_chunked_sft_step and run_sft_loop on
   configs/sft_llava_onevision_0_5b.yaml's settings, read by the port's
   config loader (4 rows of 8192, remat save_qkv, tower remat save_acts,
   CE chunk 4096 in bf16, AdamW lr 1e-5 cosine with a bf16 first moment),
   on 8 already-tokenized IAD examples, 4 with a 448x448 image; K1, K2
   and K3 must run 26 + 24 times each a step, step 1 must agree with a
   step through the plain versions, a control with dq zeroed must not,
   and the loss must fall.
13. Qwen2.5-VL serving (after 12): Qwen2.5-VL-7B at full width and depth
   (Qwen/Qwen2.5-VL-7B-Instruct's config: 28 decoder layers, GQA 7, and
   the windowed tower of 32 blocks, bf16 weights drawn on the card from a
   seed) serves 4 already-tokenized qwen2_vl requests, images of 448x448
   and 336x504 pixels in turn (the latter's last window column cut),
   through VLMGenerator._collate and RolloutEngine.generate (P=1024,
   patch budget 4096, greedy, the serving phase's new tokens); K1 must run
   32 + 28 times a generate and K4 28 times a decode step, no plain twin
   may be called, and the kernel path's prefill logits must agree with
   the twin path's;
14. Qwen2.5-VL PA-SFT (after 13): Qwen2.5-VL-3B at full width (its
   decoder cut to 9 of 36 layers, GQA 8, tied head; the tower whole; f32
   parameters drawn on the card)
   takes the training steps on configs/sft_qwen2_5_vl_7b.yaml's settings
   through the port's config loader (rows of 4096, patch budget 8192,
   remat save_qkv, CE chunk 4096 in bf16, AdamW lr 1e-5 cosine, weight
   decay 0.1, clip 1.0), its batch cut from 8 rows to 2, on 6 examples of
   one image each; K1, K2 and K3 must run 32 + 36 times each a step, step
   1 must agree with a step through the plain versions, a control with dq
   zeroed must not, and the loss must fall;
15. Qwen2.5-VL SC-GRPO (after 14): the same model, its decoder cut to 8
   of 36 layers (phase 25 runs the same Qwen2.5-3B decoder at full
   depth), takes 2 steps of
   GRPOTrainer.step on configs/grpo_qwen2_5_vl_7b.yaml's settings (G=4,
   P=4096, N=512, patch budget 8192, beta 0.04, temperature 0.9, top-p
   0.9, top-k 50, accuracy + format, a bf16 reference, lr 2e-7) on two
   one-image prompts, as phase 7 checks its steps; the update batch must
   hold full_segs and window_segs.
   Phases 7, 15 and 16 also hold step 1 by the lse cotangent's part of dq
   and dk at each merged attention call (K2 and K3 against the plain
   versions on the call's own inputs; a control given half the cotangent
   must fail that limit), and print each step-level control's margin to
   its limits.
16. LLaVA-OneVision SC-GRPO (after 15): LLaVA-OneVision-0.5B at full
   width and depth (24 decoder layers, the tower whole) takes 2
   steps of GRPOTrainer.step on the grpo section
   of configs/grpo_qwen2_5_vl_7b.yaml (the patch budget sized for tiles
   of 729) on a 448x448 and a 336x560 one-image prompt, 1-D positions,
   as phase 7 checks its steps; the update batch must hold tiles,
   tile_segments, pack_src, pack_weights and newline_mask; the step's
   readings against the plain path with p and ds unrounded are printed
   beside;
17. LLaVA-NeXT serving (after 16): LLaVA-NeXT-8B at full width (decoder
   cut to 16 of 32 layers)
   (llava-hf/llama3-llava-next-8b-hf's config: the LLaMA-3-8B decoder at
   GQA 4, the CLIP-L/336 tower of which 23 layers run, bf16 weights drawn
   on the card) serves 4 llava_next_llama3 requests (two 448x448 images
   of 5 tiles, two 336x560 of 3; P=4096, a patch budget of 16 tiles), as
   phase 11 checks its generate (K1 23 + 32 times, K4 32 times a step);
18. LLaVA-1.5 serving (after 17): LLaVA-1.5-7B at full width (decoder
   cut to 16 of 32 layers)
   (llava-hf/llava-1.5-7b-hf's config, whose sparse text_config is read
   with LlamaConfig's defaults: Vicuna-7B, GQA 1) serves 4 vicuna-form
   requests of one center-cropped tile each (P=1024), likewise;
19. LLaVA-NeXT PA-SFT (after 18): the same published config with the
   decoder cut to 4 of 32 layers, f32 parameters drawn on the card, takes
   the training steps on configs/sft_llava_onevision_0_5b.yaml's settings
   with rows cut to 2 x 4096 and the llava_next_llama3 template (4
   examples of one 336x560 image each; 12 image tiles in the recipe's
   28-tile budget, the rest at segment 0), as phase 12 checks its steps;
20. LoRA PA-SFT (after 19): Qwen2.5-VL-7B at full width and depth, a
   frozen bf16 base drawn on the card, TuningConfig's defaults (rank 8,
   alpha 16, q k v o gate up down), trained through the factored
   hidden_fn(base, batch, lora=...) on configs/sft_qwen2_5_vl_7b.yaml at
   its batch of 8 rows of 4096 (one image and one text example a row);
   K1 once per tower and decoder layer a step and K2 and K3 once per
   decoder layer (the frozen tower takes no gradient), step 1's loss and
   adapter gradients against the plain versions and a dq-zeroed control,
   a falling loss and a base unchanged bit for bit;
21. LoRA SC-GRPO with reference elision (after 20): the same model, its
   decoder cut to 8 of 28 layers for the smoke's time (phase 20 runs it at
   full depth), through cli/train_grpo.py's main (a seeded bf16 base
   written with a
   WordLevel tokenizer, the grpo section of configs/grpo_qwen2_5_vl_7b.yaml
   and the finetuning section of configs/grpo_llava_next_34b.yaml: rank
   16, alpha 32), 2 steps of 128 completion tokens (the recipe's 512 cut
   for the smoke's time): one base copy resident (the reference is the
   base), each step's launches, the lse-cotangent probe on the last
   update's batch; then export_run merges the adapters and the export,
   read back, must equal base + scale * A @ B within bf16 rounding;
22. quantized bases (after 21): (a) QLoRA PA-SFT of LLaVA-NeXT-8B at full
   depth (32 decoder layers) over an nf4 base quantized on the card layer
   by layer, on phase 19's rows and settings, checked as phase 20; (b)
   Qwen2.5-VL-7B serving phase 13's requests over int8 weights (the infer
   CLI's --quant int8), 32 new tokens, checked as phase 13, with its
   quantized_bytes ratio; (c) one nf4 generate of the same model, its decoder cut to 8
   of 28 layers for the smoke's time.
23. InternVL serving (after 22): InternVL-2.5-4B at full width and depth
   (OpenGVLab/InternVL2_5-4B's config: the InternViT-300M tower, 24
   layers, D = 64, 1025 tokens a tile; pixel shuffle; the Qwen2.5-3B
   decoder, 36 layers, GQA 8; 3.714 B parameters, bf16, seeded) serves 4
   already-tokenized intern_vl requests (images of 448x448, 336x560,
   448x448 and 600x800: 1 + 7 + 1 + 13 = 22 tiles in a budget of 24, the
   other 2 at segment 0; P=4096) through VLMGenerator._collate and
   RolloutEngine.generate, as phase 11 checks its generate (K1 24 + 36
   times, K4 36 times a step);
24. InternVL PA-SFT (after 23): the same model, its decoder cut to 9 of
   36 layers, f32 parameters drawn on the card, takes 3 steps on
   configs/sft_qwen2_5_vl_7b.yaml's settings with the intern_vl template,
   its batch cut from 8 rows to 2 of 4096 and its patch budget grown to
   16 tiles (one 336x560 image of 7 tiles a row), as phase 12 checks its
   steps (K1, K2 and K3 24 + 18 times each a step);
25. InternVL SC-GRPO (after 24): the same model, its decoder cut to 12
   of 36 layers for the smoke's time, takes 2 steps of
   GRPOTrainer.step on the grpo section of configs/grpo_qwen2_5_vl_7b.yaml
   (G=4, P=4096, N=512, a bf16 reference) on a 448x448 and a 336x560
   prompt, as phase 15 checks its steps (the per-call lse-cotangent probe
   and its half-weight control included); the update batch must hold
   tiles and tile_segments (C.R9) and the tower's launches are counted;
26. videos (after 25): (a) Qwen2-VL-2B PA-SFT at full width (f32, the
   decoder cut to 7 of 28 layers), 3
   steps on configs/sft_qwen2_5_vl_7b.yaml's settings (the tower's remat
   save_acts) on 2 rows of 4096, each with one video of 8 frames of
   336x448 (4 temporal patches of 768, one tower segment each) through
   VLMBatchBuilder, as phase 14 checks its steps; (b)
   LLaVA-NeXT-Video-7B (llava-hf/LLaVA-NeXT-Video-7B-hf's config, bf16)
   and (c) Video-LLaVA-7B (LanguageBind/Video-LLaVA-7B-hf's config, both
   224-px towers whole, the decoder cut to 4 of 32 layers) each take a
   greedy rollout of 2 video prompts of 8 frames collated by
   cli/train_grpo.py's prompt collator and run by RolloutEngine: K1 once
   per layer of the image tower, the video tower and the decoder, K4 once
   per decoder layer a step, the prefill logits against the twin path's.
27. PaliGemma-3B (after 26; google/paligemma-3b-pt-448's config: the
   Gemma-2B decoder, 18 layers of 8 heads over 1, D = 256, a prefix LM;
   SigLIP-So400m at 448 px, 27 layers, 1024 patches; 2.92 B parameters,
   seeded): (a) serves 4 paligemma requests (each image's 1024 tokens
   ahead of BOS; P=2048, 4 tiles in a budget of 6) as phase 11 checks its
   generate, K1 27 times a generate (the tower), the decoder's prefill 18
   dense prefix-LM calls and no K1, K4 18 times a decode step at D = 256;
   (b) takes 3 PA-SFT steps on configs/sft_qwen2_5_vl_7b.yaml with the
   paligemma template (f32 parameters, rows cut from 8 to 2 of 4096) as
   phase 12 checks its steps, K1-K3 27 times each a step and 18 dense
   calls; (c) takes 2 SC-GRPO steps on the grpo section of
   configs/grpo_qwen2_5_vl_7b.yaml (G=4, P=4096, N cut from 512 to 128,
   the decoder from 18 to 4 layers, f32 policy, bf16 reference): the
   dense update over the G-repeated batch (no shared path in either
   package), which must carry the tiles (C.R9), step 1 held to the plain
   path on the recorded rollout with a dq-zeroed control, K1 81 and K2/K3
   27 a step (the tower's), 27 dense calls (3 a decoder layer);
28. Pixtral-12B (after 27; mistral-community/pixtral-12b's config: the
   Mistral-NeMo decoder, 40 layers of 32 heads over 8, D = 128;
   Pixtral-ViT, 24 layers of 16 heads, D = 64; 12.68 B parameters, bf16,
   seeded): (a) serves 4 pixtral requests (512x512, 336x560 twice,
   1024x768: 5566 patches in one stream of 6144, P=4096) as phase 11
   checks its generate, K1 24 + 40 times a generate, K4 40 times a step;
   (b) LoRA PA-SFT over the bf16 base as phase 20 (rows cut from 8 to 4
   of 4096, the pixtral template); (c) LoRA SC-GRPO with reference
   elision (configs/grpo_llava_next_34b.yaml's finetuning over the grpo
   section of configs/grpo_qwen2_5_vl_7b.yaml, N cut to 128 and P to
   2048, the decoder cut to 8 of 40 layers): the dense update, one base
   copy, K1 and K2/K3 a step by the layers, step 1 against the plain
   path with a dq-zeroed control.
29. Qwen1.5-MoE-A2.7B (24 layers of 16 heads over 16, D = 128, 60
   experts of 1408, top 4, a shared expert of 5632; 14.3 B parameters,
   seeded): (a) serves 4 chatml text requests (P=1024, 128 new tokens,
   greedy) through RolloutEngine.generate, K1 24 a generate and K4 24 a
   step, the prefill's and the first decode step's logits against the
   plain path's with the kernel path's experts (the unpinned reading
   logged beside); (b) PA-SFT in full parameters (f32, AdamW) with the
   router's aux loss, the decoder cut to 4 of 24 layers (2.9 B), 3 steps
   of 2 x 4096 packed text rows, step 1 (loss, aux, grad norm, q/k/v and
   router grad norms) against the plain path, a control with the routing
   weights detached; (c) SC-GRPO of the same cut (f32 policy, bf16
   reference, G=4, P=1024, N=128, 2 text prompts, 2 steps), the dense
   update, a dq-zeroed control.
30. context extension: LoRA PA-SFT of LLaVA-NeXT-8B at full depth (bf16
   base, LoRA's defaults) on one row of 16384 (8 one-image examples),
   model.rope_scaling linear with model_max_length 16384 (factor 2 over
   8192, written into text_config) and model.shift_attn: two K1 calls a
   decoder layer on LongLoRA's grouped views, K2 and K3 as many; step 1
   against the plain path, a dq-zeroed control.
31. Mixture-of-Depths: convert_to_mod over Qwen2-VL-2B's decoder as a
   Qwen2 text model (28 layers, f32, routers drawn from a seed), capacity
   0.125 on 2 rows of 4096, 3 AdamW steps: K1-K3 once a layer a step on
   the 512 gathered rows; step 1 against the plain path with the kernel
   path's rows, a dq-zeroed control.
32. the preference stages: each through cli/train_pref.py's main from
   a config file (Qwen2-VL-2B from model.hf_config and a seed, f32
   policy, bf16 reference, the qwen2_vl template, cutoff_len 1024,
   batch 2, a WordLevel tokenizer written under build/): (a) DPO with
   its sigmoid loss and SimPO (reference-free) on ranking pairs of about
   1024 tokens a row, 28 layers; (b) KTO, BCO, RM and PRM on feedback,
   ranking and stepwise rows, the decoder cut to 14 layers; (c) PPO (28
   layers, completions of 128, 4 epochs of minibatches of 1), RLOO (G=4)
   and online DPO on one-text prompts with the default rewards (the
   completions decoded as CannedTokenizer does), RLOO and online DPO at
   14 layers.  2 steps a stage: each step's K1-K4 launches against the
   count the stage's path implies; step 1 against the same step through
   the plain versions from the same state and batch (the on-policy
   stages on the kernel path's first rollout), loss, grad norm and
   per-layer q/k/v grad norms, and a dq-zeroed control that must fail;
   step ms, tokens/s, peak memory, the rollout/update split.  The
   checkpoints are checked for their trees and not written.
33. the rest of the trainers and the optimizers: (a) XPO (28 layers; a
   policy and a reference rollout a step, one update over the 4 rows),
   (b) Nash-MD (14 layers; the policy's rollout and the geometric
   mixture's, two KV caches at each step; the mixture's first sampled
   distribution held to the plain path, a control attending the prompts'
   padding must fail) and (c) GKD (14 layers; a teacher of seed 1
   written in HF layout, read in f32; step 1 on-policy, step 2 the
   dataset's completions) through cli/train_pref.py as phase 32 runs its
   stages; (d) one PA-SFT step of Qwen2-VL-2B (4 of 28 decoder layers,
   the tower whole, phase 6's rows) with each optimizer make_optimizer
   builds (AdamW, GaLore, APOLLO, BAdam, Adam-mini, Muon, Adafactor,
   Lion, SGD) and LoRA+ over LoRA's defaults: step and optimizer ms
   (GaLore's projections apart), peak memory, the optimizer state's bytes, and
   two leaves' updates held to the same update on the CPU from the same
   gradients; each optimizer's control, the CPU's update with one piece
   of its arithmetic changed (Adam's bias correction dropped, one
   Newton-Schulz step fewer, Adafactor unfactored, Lion unsigned, SGD
   unclipped), must fail.
34. the SFT leftovers and the native packing plane: (a) the native plane
   (csrc/dataplane.cpp, built by the host's c++ beside nvcc) packs 2 rows
   of 4096 text examples, which keep the packed rows' invariants and equal
   the Python twin's rows, and the knapsack of 100 k seeded lengths and
   the packing of 1000 seeded examples are timed native against the twin
   (host ms); then Qwen2-VL-2B's decoder as a Qwen2 text model at full
   width and depth (phase 31's model, f32, drawn once; every step from a
   clone of that state, on those rows): (b) a make_chunked_sft_step with
   fused_ce=True against one with fused_ce=False (loss, grad norm, the
   updates of the head and layer 0's q, k and v kernels), two controls
   that change the fused CE's arithmetic (1 / n_tokens dropped; the label
   mask dropped) must fail; (c) make_sft_step over the full
   [2, 4096, 151936] f32 logits against the chunked step; (d)
   IterativeSFTTrainer, two steps from texts (the chain tokenizer) and one
   from input_ids with a masked prompt, its first step against
   make_chunked_sft_step on the same padded batch.  K1-K3 once a layer a
   step, counted; each step's ms and peak memory.
35. the mesh: the kernels' sharding rule on the card, and cli/train_sft.py
   and cli/train_grpo.py under a one-rank NCCL group against the runs
   with no group; (e) KTO, PPO, Nash-MD and GKD through cli/train_pref.py
   and the fused-CE step through cli/train_sft.py on that group, one step
   each (Qwen2-VL-2B's widths, the decoder cut to 4 layers), bitwise the
   runs with no group, DTensor states, heads and teacher, and K1-K4's
   launches as predicted.
36. the tools: (a) on phase 4's generator: eval/mmlu.py over 2 subjects
   of 4 items (1-shot, max_length 1024, batches of 4; K1 28 a batch, no
   K4), its f32 choice logits and letters against the plain path, a
   control one position early must fail; the bundle embedding backend
   over 10 texts in chunks of 8 x 128 (unit norms, repeated texts equal,
   against the plain path, a control of other texts' vectors must fail);
   cli/chat.py's chat_loop over 3 greedy turns of 32 new tokens (a text
   turn, /image on a seeded 448 x 448 image, /clear); the web board's
   /api/chat, / and /api/progress; a generate under core/profiling.py's
   device_trace (the trace names K1, K4 and the annotated region; the
   spans carry JAX's keys); eval/commercial.py over 2 items with an
   injected transport; (b) on phase 10's SFT export before the phase
   removes it: cli/chat.py's main over 2 scripted greedy turns, its
   replies against its generator's; the board's Runner launches
   cli/train_sft.py on the card (1 step, do_predict on 2 rows of 32 new
   tokens, the scores and the loss plot where jieba/nltk and matplotlib
   import), /api/progress polled to return code 0, its files checked.
37. tensor parallelism, the repo's two tp = 4 recipes (LLaVA-NeXT-34B
   SC-GRPO, Qwen2.5-VL-72B SFT): (a) K1-K3 at the Yi-34B and Qwen2.5-72B
   decoders' tp shards (14 / 2 and 16 / 2 heads of 128, one packed row
   of 4096, the lse cotangent given), CLIP-L/336's (4 heads of 64 over 5
   tiles of 577) and the Qwen2.5-VL tower's (4 heads of 80 over 8192
   patches in windows of 64), and K4 at both decoders' decode shards (8
   rows, 4608 slots): every rank's launch bitwise equal to its slice of
   the unsharded launch, each shard shape held to its plain version and
   timed (its rows in the kernel line); the control gives each rank the
   next rank's KV heads; (b) the tensor-parallel rollout
   (train/rollout.py tp_local_params, core/tensor_parallel.py) at tp = 4
   on LLaVA-NeXT-34B cut to 4 layers at full width, B = 8, its four ranks
   one after another on the card with the rank-ordered sum as the
   all-reduce: the first step's logits against the unsharded rollout's,
   the greedy tokens' agreement; the control drops one rank's partial
   sums; (c) one LoRA SC-GRPO step (the 34B recipe's finetuning) through
   cli/train_grpo.py under a one-rank NCCL group, bitwise the no-group
   step; the control reads the adapters before the step.  (a) also holds
   Qwen1.5-MoE-A2.7B's tp = 4 shards (K1-K3 at 4 heads over 4, K4 over
   1152 slots) and Qwen2.5-VL-7B's uneven tp = 8 shards (K1 and K4 at 4
   or 3 query heads over the KV heads they read); (d) the MoE at tp = 4
   (Qwen1.5-MoE-A2.7B cut to 4 layers, 15 experts a rank) and (e)
   uneven heads with DoRA at tp = 8 (Qwen2.5-VL-7B cut to 4 layers, DoRA
   rank 8), each as (b) with 4 prompts of 1024 and 16 greedy steps.

Phase 3 also holds K1-K3 at the CLIP tower (T = 577) over the serving
tiles and over the SFT budget with padding tiles, K1 at the LLaMA-3-8B
(GQA 4) and Vicuna-7B (GQA 1) prefills, K1-K3 at the 8B-cut SFT decoder
and at LLaVA-OneVision's SC-GRPO update, and K4 at GQA 4, GQA 1 and over
OneVision's fan-out; and at phases 23-26's shapes: K1 at the InternViT
tower (T = 1025, D = 64) over serving's 24 tiles and K1-K3 over the SFT
budget's 16, both with padding tiles at segment 0; K1 at the InternVL
prefill, K1-K3 at its SFT decoder and its SC-GRPO update (cross, self and
prompt calls, GQA 8, D = 128), K4 over its serving cache; K1 over the
video frames of CLIP-L/336 (T = 577) and LanguageBind (T = 257), and K1-K3
over Qwen2-VL's video stream (one segment a temporal patch, D = 80); and
at phases 27-28's: K4 at head dim 256, group 8, over PaliGemma's serving
cache and its SC-GRPO fan-out; K1 over the SigLIP-448 tower's serving
budget and K1-K3 over its SFT budget (tiles of 1024, D = 72, padding
tiles at segment 0); K1-K3 over Pixtral's packed patch stream (one row of
6144, D = 64, one segment an image); K1 at the Mistral-NeMo prefill,
K1-K3 at its LoRA SFT rows and its dense SC-GRPO update rows, K4 over its
serving cache; and at phases 29-31's: K1 at Qwen1.5-MoE's prefill (16
heads over 16), K4 over its serving cache and its SC-GRPO fan-out, K1-K3
at LongLoRA's grouped views of phase 30's row (each head half, the
rolled one with its wrapped segments) and at MoD's gathered rows; and at
phase 32's: K1-K3 at DPO's 4 ragged rows of 1024 and at PPO's minibatch
row of 1024 + 128, K4 over PPO's rollout cache and RLOO's fan-out; and at
phase 33's: K1-K3 at XPO's 4 update rows of 1024 + 128 (left-padded
prompts, completions ending early); and at phase 34's: K1-K3 over its 2
packed rows of 4096 (12 heads over 2, D = 128).

The kernels JSON line counts each kernel's launches by path (serve,
eval, chat, train, grpo, chain, llava_serve, llava_sft, q25_serve,
q25_sft, q25_grpo, llava_grpo, llava16_serve, llava15_serve,
llava16_sft, q25_lora_sft, q25_lora_grpo, llava16_qlora_sft,
q25_int8_serve, q25_nf4_serve, internvl_serve, internvl_sft,
internvl_grpo, q2vl_video_sft, lnv_video_rollout, vllava_video_rollout,
paligemma_serve, paligemma_sft, paligemma_grpo, pixtral_serve,
pixtral_lora_sft, pixtral_lora_grpo, moe_serve, moe_sft, moe_grpo,
longlora_sft, mod_train, pref, pref33, optimizers, sft_extras, mesh,
tools; the board's child process's launches are not counted).
``--phases 3,29,30,31`` runs a subset
and prints no kernel line.

Before the phases, one line says which of the host libraries the port's
CLIs use import on this machine (jieba, nltk, matplotlib, wandb and
requests among them); only phase 36b's host checks depend on it.

Exits non-zero, printing no result, without a CUDA card or when any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import signal
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
# llava-hf/llava-onevision-qwen2-0.5b-si-hf's published config, at full
# width and depth: the Qwen2-0.5B decoder (14 heads over 2 KV heads, D =
# 64; the vocabulary of bench.py:141, since llava-hf's own could not be
# read offline), the SigLIP so400m tower of transformers'
# LlavaOnevisionConfig (26 layers, 16 heads, D = 72), anyres_max_9 over
# its 36 grid pinpoints, 384 to 2304 pixels a side
LLAVA_OV_05B = dict(
    architectures=["LlavaOnevisionForConditionalGeneration"],
    text_config=dict(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
        rms_norm_eps=1e-6, rope_theta=1000000.0, tie_word_embeddings=True,
        max_position_embeddings=32768),
    vision_config=dict(
        hidden_size=1152, intermediate_size=4304, num_hidden_layers=26,
        num_attention_heads=16, image_size=384, patch_size=14,
        layer_norm_eps=1e-6),
    image_token_index=151646, vision_aspect_ratio="anyres_max_9",
    vision_feature_layer=-1, vision_feature_select_strategy="full",
    image_grid_pinpoints=[[384 * i, 384 * j] for i in range(1, 7)
                          for j in range(1, 7)],
)
# Qwen/Qwen2.5-VL-7B-Instruct's published config.json, at full width and
# depth: 28 decoder layers, 28 heads over 4 KV heads (GQA 7, D = 128), an
# untied head over 152064 ids; the windowed tower of 32 blocks (16 heads,
# D = 80), windows of 112 pixels, blocks 7, 15, 23 and 31 over whole images
QWEN2_5_VL_7B = dict(
    architectures=["Qwen2_5_VLForConditionalGeneration"],
    model_type="qwen2_5_vl",
    vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    rms_norm_eps=1e-6, rope_theta=1000000.0, tie_word_embeddings=False,
    max_position_embeddings=128000,
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    vision_config=dict(
        depth=32, hidden_size=1280, intermediate_size=3420, num_heads=16,
        in_chans=3, out_hidden_size=3584, patch_size=14,
        spatial_merge_size=2, temporal_patch_size=2, window_size=112,
        fullatt_block_indexes=[7, 15, 23, 31], tokens_per_second=2),
    image_token_id=151655, video_token_id=151656,
    vision_start_token_id=151652, vision_end_token_id=151653,
)
# Qwen/Qwen2.5-VL-3B-Instruct's published config.json: 36 decoder layers,
# 16 heads over 2 KV heads (GQA 8, D = 128), the head tied to the
# embedding over 151936 ids; the 7B's tower, its merger out to 2048
QWEN2_5_VL_3B = dict(
    QWEN2_5_VL_7B, vocab_size=151936, hidden_size=2048,
    intermediate_size=11008, num_hidden_layers=36, num_attention_heads=16,
    num_key_value_heads=2, tie_word_embeddings=True,
    vision_config=dict(QWEN2_5_VL_7B["vision_config"], out_hidden_size=2048),
)
# llava-hf/llama3-llava-next-8b-hf's published config: the LLaMA-3-8B
# decoder (32 layers, 32 heads over 8 KV heads: GQA 4, D = 128; rope_theta
# 5e5, an untied head over 128320 ids), the CLIP ViT-L/14-336 tower (24
# layers, 16 heads, D = 64, 23 of them run: vision_feature_layer -2), the
# projector, anyres over 5 grid pinpoints at 336 a tile
LLAVA_NEXT_8B = dict(
    architectures=["LlavaNextForConditionalGeneration"],
    model_type="llava_next",
    text_config=dict(
        model_type="llama", vocab_size=128320, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=False,
        max_position_embeddings=8192),
    vision_config=dict(
        model_type="clip_vision_model", hidden_size=1024,
        intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
        image_size=336, patch_size=14, projection_dim=768,
        layer_norm_eps=1e-5),
    image_token_index=128256, vision_feature_layer=-2,
    vision_feature_select_strategy="default",
    image_grid_pinpoints=[[336, 672], [672, 336], [672, 672], [1008, 336],
                          [336, 1008]],
)
# llava-hf/llava-1.5-7b-hf's published config: its text_config names only
# the fields that differ from transformers.LlamaConfig (Vicuna-7B: 32
# layers, 32 heads over 32 KV heads, D = 128, rope_theta 1e4, an untied
# head), which the port's reader fills from LlamaConfig's defaults (ROADMAP
# C.R10); its vision_config is CLIP-L/336's
LLAVA_15_7B = dict(
    architectures=["LlavaForConditionalGeneration"], model_type="llava",
    text_config=dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        max_position_embeddings=4096, rms_norm_eps=1e-5,
        torch_dtype="float16", vocab_size=32064),
    vision_config=dict(
        model_type="clip_vision_model", hidden_size=1024, image_size=336,
        intermediate_size=4096, num_attention_heads=16,
        num_hidden_layers=24, patch_size=14, projection_dim=768,
        vocab_size=32000),
    image_token_index=32000, pad_token_id=32001, projector_hidden_act="gelu",
    vision_feature_layer=-2, vision_feature_select_strategy="default",
)
# OpenGVLab/InternVL2_5-4B's published config, in the
# InternVLForConditionalGeneration layout the port reads: the
# InternViT-300M-448px-V2_5 tower (24 layers, 16 heads, D = 64, 448-px
# tiles of 1024 patches + CLS, no QK norm, layer_norm), pixel shuffle at
# 0.5, the Qwen2.5-3B-Instruct decoder (36 layers, 16 heads over 2 KV
# heads: GQA 8, D = 128; an untied head over 151674 ids: the model card's
# 3.7 B parameters), at most 12 tiles an image plus the thumbnail
INTERNVL_25_4B = dict(
    architectures=["InternVLForConditionalGeneration"], model_type="internvl",
    text_config=dict(
        model_type="qwen2", vocab_size=151674, hidden_size=2048,
        intermediate_size=11008, num_hidden_layers=36, num_attention_heads=16,
        num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=1000000.0,
        tie_word_embeddings=False, max_position_embeddings=32768),
    vision_config=dict(
        model_type="internvl_vision", hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=24, num_attention_heads=16, image_size=[448, 448],
        patch_size=[14, 14], layer_norm_eps=1e-6, attention_bias=True,
        use_qk_norm=False, norm_type="layer_norm"),
    image_token_id=151667, downsample_ratio=0.5, max_tiles=12,
    vision_feature_layer=-1, vision_feature_select_strategy="default",
    projector_hidden_act="gelu",
)
# llava-hf/LLaVA-NeXT-Video-7B-hf's published config: the Vicuna-7B
# decoder (a sparse LLaMA text config: 32 layers, 32 heads over 32, D =
# 128, vocab 32064), the CLIP ViT-L/14-336 tower (23 of 24 layers run),
# anyres images over NeXT's 5 pinpoints, video frames average-pooled at
# stride 2 (24 x 24 -> 144 features a frame)
LLAVA_NEXT_VIDEO_7B = dict(
    architectures=["LlavaNextVideoForConditionalGeneration"],
    model_type="llava_next_video",
    text_config=dict(model_type="llama", vocab_size=32064,
                     max_position_embeddings=4096, rms_norm_eps=1e-5),
    vision_config=dict(
        model_type="clip_vision_model", hidden_size=1024,
        intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
        image_size=336, patch_size=14, projection_dim=768),
    image_token_index=32001, video_token_index=32000,
    vision_feature_layer=-2, vision_feature_select_strategy="default",
    spatial_pool_mode="average", spatial_pool_stride=2,
    image_grid_pinpoints=[[336, 672], [672, 336], [672, 672], [1008, 336],
                          [336, 1008]],
)
# LanguageBind/Video-LLaVA-7B-hf's published config: the Vicuna-7B decoder
# and two LanguageBind CLIP ViT-L/14 towers at 224 px (an image tower and a
# video tower; 16 x 16 patches + CLS, 23 of 24 layers run, a frame keeps
# its CLS: 257 features)
VIDEO_LLAVA_7B = dict(
    architectures=["VideoLlavaForConditionalGeneration"],
    model_type="video_llava",
    text_config=dict(model_type="llama", vocab_size=32064,
                     max_position_embeddings=4096, rms_norm_eps=1e-5),
    vision_config=dict(
        model_type="clip_vision_model", hidden_size=1024,
        intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
        image_size=224, patch_size=14, projection_dim=768),
    image_token_index=32000, video_token_index=32001,
    vision_feature_layer=-2, vision_feature_select_strategy="default",
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

# LLaVA-OneVision serving (phase 11): the eval batch of 4 requests with
# IMAGE_HW's images, which anyres tiles as 5 + 3 + 5 + 3 = 16 tiles and
# 3699 or 1998 image tokens each, so the prompt is 4096 long; the recipe's
# patch budget, 16384 patches = 22 tiles of 729
LLAVA_PROMPT_LEN, LLAVA_PATCH_BUDGET, LLAVA_IMAGE = 4096, 16384, 151646
# LLaVA-OneVision PA-SFT (phase 12): configs/sft_llava_onevision_0_5b.yaml
# (B = 4 rows of 8192, remat save_qkv, tower remat save_acts, CE chunk
# 4096 in bf16, AdamW lr 1e-5 cosine with a bf16 first moment) on 8
# examples, 4 of them with one 448 x 448 image (5 tiles each)
LLAVA_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "sft_llava_onevision_0_5b.yaml")
LLAVA_SFT_EXAMPLES, LLAVA_SFT_IMAGE_HW = 8, (448, 448)
LLAVA_SFT_CUTOFF = 8192              # the recipe's data.cutoff_len
LLAVA_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke_llava_sft")
# Qwen2.5-VL (phases 13-15): two 448 x 448 images (1024 patches, whole
# windows of 8 x 8) and two of 336 x 504 (864 patches, the last window
# column cut to 8 x 4), 3776 of the 4096 patch budget
Q25_IMAGE_HW = [(448, 448), (336, 504), (448, 448), (336, 504)]
# PA-SFT (phase 14): configs/sft_qwen2_5_vl_7b.yaml (rows of 4096, packing,
# patch budget 8192, remat save_qkv, CE chunk 4096 in bf16, AdamW lr 1e-5
# cosine, weight decay 0.1, clip 1.0), its batch of 8 rows cut to 2: six
# examples of one image each, three to a row
Q25_SFT_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "sft_qwen2_5_vl_7b.yaml")
Q25_SFT_ROWS, Q25_SFT_EXAMPLES, Q25_ANSWER_LEN = 2, 6, (900, 1100)
Q25_SFT_CUTOFF = 4096                 # the recipe's data.cutoff_len
Q25_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_q25_sft")
# SC-GRPO (phase 15): configs/grpo_qwen2_5_vl_7b.yaml (G=4, P=4096, N=512,
# patch budget 8192, a bf16 reference, lr 2e-7) on two one-image prompts
Q25_GRPO_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "grpo_qwen2_5_vl_7b.yaml")
Q25_GRPO_STEPS = 2
# LLaVA-OneVision SC-GRPO (phase 16): configs/grpo_qwen2_5_vl_7b.yaml's
# grpo section (the repo has no OneVision GRPO recipe: G=4, P=4096, N=512,
# beta 0.04, temperature 0.9, top-p 0.9, top-k 50, accuracy + format, a
# bf16 reference) on a 448 x 448 and a 336 x 560 prompt (5 + 3 tiles); the
# patch budget sizes the G-repeated collation, so the G = 1 collation the
# rollout and the shared-prompt update use holds 8 tiles of 729
OV_GRPO_PATCH_BUDGET = 4 * 8 * 729
OV_GRPO_IMAGE_HW = [(448, 448), (336, 560)]
OV_GRPO_STEPS = 2
# phase 16's decoder at its full 24 layers (cut to 12 for the smoke's time
# before; its completions stay 512, which its dlse control reads)
OV_GRPO_LAYERS = 24
# LLaVA-NeXT-8B serving (phase 17): the llava_next_llama3 form, two 448 x
# 448 images (5 tiles, 2928 features) and two 336 x 560 (3 tiles, 1560
# features), P=4096, a patch budget of 16 tiles
NEXT_PROMPT_LEN, NEXT_PATCH_BUDGET = 4096, 16 * 576
LLAMA3_BOS, LLAMA3_END, LLAMA3_EOT = 128000, 128001, 128009
LLAMA3_HEADER_START, LLAMA3_HEADER_END = 128006, 128007
NEXT_IMAGE = 128256
# LLaVA-1.5-7B serving (phase 18): the vicuna form, one center-cropped
# tile of 576 features a request, P=1024, a patch budget of 4 tiles
V15_PROMPT_LEN, V15_PATCH_BUDGET = 1024, 4 * 576
# phases 17 and 18: the decoders cut to 16 of 32 layers (the smoke's
# time); phase 30 runs NeXT-8B's decoder at full depth
LLAVA_SERVE_LAYERS = 16
VICUNA_BOS, VICUNA_EOS, VICUNA_PAD, V15_IMAGE = 1, 2, 32001, 32000
# LLaVA-NeXT PA-SFT (phase 19): the published config with the decoder cut
# to 4 of its 32 layers (the smoke's time; the whole 8B would need ~134 GB
# of f32
# parameters, gradients and moments), on
# configs/sft_llava_onevision_0_5b.yaml's settings (the family's mm style:
# save_qkv, tower save_acts, bf16 CE chunks of 4096, AdamW with a bf16
# first moment) with the rows cut to 2 x 4096 and the llava_next_llama3
# template; 4 examples of one 336 x 560 image (3 tiles) each, two a row;
# the recipe's patch budget, 16384 patches = 28 tiles of 576
NEXT_SFT_LAYERS, NEXT_SFT_ROWS, NEXT_SFT_CUTOFF = 4, 2, 4096
NEXT_SFT_IMAGE_HW, NEXT_SFT_ANSWER_LEN = (336, 560), (300, 400)
NEXT_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke_next_sft")
# LoRA PA-SFT of Qwen2.5-VL-7B (phase 20): configs/sft_qwen2_5_vl_7b.yaml
# at its own batch of 8 rows of 4096, one image (Q25_IMAGE_HW's sizes in
# turn: 7552 of the 8192 patch budget) and one text-only example a row,
# answers of seeded tokens that fill the rows to ~4000
LORA_SFT_ROWS, LORA_SFT_STEPS = 8, 3
LORA_IMAGE_ANSWER_LEN, LORA_TEXT_ANSWER_LEN = (1900, 1950), (1600, 1750)
LORA_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke_lora_sft")
# LoRA SC-GRPO (phase 21): configs/grpo_qwen2_5_vl_7b.yaml's sections with
# configs/grpo_llava_next_34b.yaml's finetuning section, through the CLI
LLAVA_GRPO_RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "grpo_llava_next_34b.yaml")
LORA_GRPO_STEPS = 2
LORA_GRPO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_lora_grpo")
# the export's check: two steps at the recipe's lr of 2e-7 leave B near
# 4e-7, a delta near 3e-8 that f32 barely and bf16 never resolves beside
# the base, so the checkpoint's B factors are redrawn from the seed at this
# scale (a delta of ~8e-4) before the export; a merged leaf must then hold
# its delta within bf16's rounding of the adapters' product, which an
# export that skipped the merge misses by the whole delta (reads 1)
LORA_EXPORT_B_STD = 1e-2
LORA_EXPORT_DELTA_LIMIT = 2 ** -7
# QLoRA PA-SFT of LLaVA-NeXT-8B at full depth over an nf4 base (phase 22a),
# on phase 19's rows and settings
QLORA_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke_qlora_sft")
# the nf4 generate of phase 22c: new tokens, and its decoder cut to 8 of
# 28 layers for the smoke's time (22b serves the int8 7B whole)
NF4_NEW_TOKENS, NF4_LAYERS = 16, 8
# phase 22b's int8 serving: 32 new tokens (the smoke's time)
INT8_NEW_TOKENS = 32
# phases 12 and 26a: the decoders cut to a quarter of their depth (the
# smoke's time)
OV_SFT_LAYERS, VIDEO_SFT_LAYERS = 6, 7
# InternVL-2.5-4B (phases 23-25): InternVL's <img> and </img> around each
# image's run of <IMG_CONTEXT> tokens.  Serving (phase 23): two 448 x 448
# images (1 tile, 256 features each), a 336 x 560 one (a (3, 2) grid and
# the thumbnail: 7 tiles, 1792 features) and a 600 x 800 one ((4, 3) + 1:
# 13 tiles, 3328 features): 22 tiles in a budget of 24, P=4096
INTERNVL_IMG_START, INTERNVL_IMG_END, INTERNVL_IMAGE = 151665, 151666, 151667
INTERNVL_IMAGE_HW = [(448, 448), (336, 560), (448, 448), (600, 800)]
INTERNVL_PROMPT_LEN, INTERNVL_PATCH_BUDGET = 4096, 24 * 1024
# PA-SFT (phase 24): configs/sft_qwen2_5_vl_7b.yaml's settings with the
# intern_vl template, f32 parameters (~59 GB with gradients and moments),
# so the batch is cut from 8 rows to 2 of 4096, one 336 x 560 image (7
# tiles) an example, an example a row; the recipe's patch budget (8 tiles)
# grows to 16 tiles to hold the batch's two images, 2 tiles at segment 0
INTERNVL_SFT_ROWS, INTERNVL_SFT_IMAGE_HW = 2, (336, 560)
INTERNVL_SFT_ANSWER_LEN, INTERNVL_SFT_BUDGET = (1800, 2000), 16 * 1024
INTERNVL_SFT_STEPS = 3
# phases 14 and 24: the 36-layer decoders cut to 9 (the smoke's time)
SFT_DECODER_LAYERS = 9
INTERNVL_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "build", "chip_smoke_internvl_sft")
# SC-GRPO (phase 25): the grpo section of configs/grpo_qwen2_5_vl_7b.yaml,
# a 448 x 448 and a 336 x 560 prompt (1 + 7 tiles); the patch budget sizes
# the G-repeated collation, so the G = 1 collation holds the 8 tiles
INTERNVL_GRPO_IMAGE_HW = [(448, 448), (336, 560)]
INTERNVL_GRPO_PATCH_BUDGET = 4 * 8 * 1024
INTERNVL_GRPO_STEPS = 2
# phase 15 runs Qwen2.5-VL-3B's decoder cut to 8 of its 36 layers (the
# smoke's time; at 4 its dlse-dropped control failed its limits by 1.36x
# only): phase 25 runs the same Qwen2.5-3B decoder deeper
Q25_GRPO_LAYERS = 8
# phase 21's completions (the recipe's 512) and its decoder (8 of 28
# layers; phase 20 runs the 7B at full depth), cut for the smoke's time
LORA_GRPO_COMPLETION_LEN, LORA_GRPO_LAYERS = 128, 8
# phase 25's decoder (12 of 36 layers; phase 24 trains the 4B at full
# depth), cut for the smoke's time.  Its completions stay the recipe's 512:
# cut to 128 at full depth, the dlse-dropped control fails its limits by
# 12% only (q/k vectors 1.117 of the limit), against 145% at 512
INTERNVL_GRPO_LAYERS = 12
# videos (phase 26).  (a) Qwen2-VL-2B PA-SFT on
# configs/sft_qwen2_5_vl_7b.yaml's settings (qwen2_vl template, the tower's
# remat save_acts), 2 rows of 4096 with one video of 8 frames of 336 x 448
# each (t = 4 temporal patches of 24 x 32: 3072 patches, 768 tokens)
VIDEO_FRAMES, VIDEO_FRAME_HW = 8, (336, 448)
VIDEO_SFT_ROWS, VIDEO_SFT_ANSWER_LEN = 2, (2600, 2900)
VIDEO_SFT_BUDGET = 8192               # the recipe's data.patch_budget
VIDEO_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke_video_sft")
VIDEO_PAD = 151656
# (b) LLaVA-NeXT-Video-7B and (c) Video-LLaVA (the decoder cut to 4 of 32
# layers): greedy rollouts of 2 video prompts of 8 frames through the GRPO
# prompt collator and RolloutEngine; the frame budget holds the 16 frames
VIDEO_ROLLOUT_TOKENS, VLLAVA_LAYERS = 32, 4
LNV_PROMPT_LEN, VLLAVA_PROMPT_LEN = 2048, 3072

# google/paligemma-3b-pt-448's published config (2.92 B parameters): the
# Gemma-2B decoder (a sparse gemma text config: 18 layers, 8 heads over 1,
# D = 2048 / 8 = 256, rope_theta 1e4, tied head over 257216 ids) and the
# SigLIP-So400m tower at 448 px (27 layers, 16 heads of 72, 32 x 32 = 1024
# patches of 14)
PALIGEMMA_3B_448 = dict(
    architectures=["PaliGemmaForConditionalGeneration"],
    model_type="paligemma", bos_token_id=2, eos_token_id=1, pad_token_id=0,
    hidden_size=2048, image_token_index=257152, projection_dim=2048,
    text_config=dict(
        model_type="gemma", hidden_size=2048, intermediate_size=16384,
        num_attention_heads=8, num_hidden_layers=18, num_key_value_heads=1,
        num_image_tokens=1024, vocab_size=257216),
    vision_config=dict(
        model_type="siglip_vision_model", hidden_size=1152, image_size=448,
        intermediate_size=4304, num_attention_heads=16, num_hidden_layers=27,
        num_image_tokens=1024, patch_size=14, projection_dim=2048,
        projector_hidden_act="gelu_fast", vision_use_head=False),
)
# mistral-community/pixtral-12b's published config (12.68 B parameters):
# the Mistral-NeMo decoder (its sparse mistral text config leaves out the
# 32 heads, MistralConfig's default: 40 layers, 32 heads over 8, head_dim
# 128, rope_theta 1e9, untied head over 131072 ids) and Pixtral-ViT (its
# sparse vision config: 24 layers, 1024 wide, 16 heads of 64, patches of
# 16, images up to 1024 px)
PIXTRAL_12B = dict(
    architectures=["LlavaForConditionalGeneration"], model_type="llava",
    image_token_index=10, projector_hidden_act="gelu",
    vision_feature_layer=-1, vision_feature_select_strategy="full",
    text_config=dict(
        model_type="mistral", hidden_size=5120, head_dim=128,
        intermediate_size=14336, max_position_embeddings=1024000,
        num_hidden_layers=40, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=1000000000.0, sliding_window=None, vocab_size=131072),
    vision_config=dict(
        model_type="pixtral", head_dim=64, hidden_act="silu",
        image_size=1024, patch_size=16, rope_theta=10000.0,
        tie_word_embeddings=False),
)
# PaliGemma's token ids (Gemma's tokenizer): BOS, EOS, padding, the image
# token, <start_of_turn> and <end_of_turn>
PG_BOS, PG_EOS, PG_PAD, PG_IMAGE = 2, 1, 0, 257152
PG_TURN, PG_TURN_END = 106, 107
# phase 27: PaliGemma-3B at full depth.  (a) serving: 4 paligemma-form
# requests (each 1024 image tokens ahead of BOS and a Gemma user turn),
# P=2048, a budget of 6 tiles (2 at segment 0); (b) PA-SFT on
# configs/sft_qwen2_5_vl_7b.yaml with the paligemma template, f32
# parameters (47 GB of state), the batch cut from 8 rows to 2 of 4096, one
# image an example; (c) SC-GRPO on the grpo section of
# configs/grpo_qwen2_5_vl_7b.yaml (G=4, P=4096, N=512; its patch budget of
# 8192 holds the dense update's 2 x 4 tiles), two one-image prompts
PG_IMAGE_HW = [(448, 448), (336, 560), (448, 448), (600, 800)]
PG_PROMPT_LEN, PG_PATCH_BUDGET = 2048, 6 * 1024
PG_SFT_ROWS, PG_SFT_STEPS, PG_SFT_ANSWER_LEN = 2, 3, (2800, 2950)
PG_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_paligemma_sft")
PG_GRPO_IMAGE_HW = [(448, 448), (336, 560)]
PG_GRPO_STEPS, PG_GRPO_COMPLETION_LEN = 2, 128
# phase 27c's decoder cut to 4 of 18 layers (the smoke's time)
PG_GRPO_LAYERS = 4
# Pixtral's token ids (its Tekken tokenizer): BOS, EOS, <pad>, [INST],
# [/INST], [IMG], [IMG_BREAK], [IMG_END]
PX_BOS, PX_EOS, PX_PAD, PX_INST, PX_INST_END = 1, 2, 11, 3, 4
PX_IMAGE, PX_BREAK, PX_END = 10, 12, 13
# phase 28: Pixtral-12B at full depth.  (a) serving: 4 pixtral-form
# requests of 512x512 (32 x 32 patches), 336x560 (21 x 35) twice and
# 1024x768 (64 x 48): 5566 patches in one stream of 6144, P=4096; (b)
# LoRA PA-SFT over a bf16 base on configs/sft_qwen2_5_vl_7b.yaml with the
# pixtral template, TuningConfig's defaults, the batch cut from 8 rows to
# 4 of 4096 (the 25.4 GB base and 8 rows' saved activations would pass
# the card's 80 GB), one 336x560 image an example; (c) LoRA SC-GRPO with
# reference elision: configs/grpo_llava_next_34b.yaml's finetuning (rank
# 16, alpha 32) over the grpo section of configs/grpo_qwen2_5_vl_7b.yaml,
# N cut from 512 to 128 for the smoke's time and P from 4096 to 2048 (8
# rows of P + N and the base: the policy's saved activations at 4224
# would leave under 10 GB of the card), a 512x512 and a 336x560 prompt
PX_IMAGE_HW = [(512, 512), (336, 560), (336, 560), (1024, 768)]
PX_PROMPT_LEN, PX_PATCH_BUDGET = 4096, 6144
PX_SFT_ROWS, PX_SFT_STEPS, PX_SFT_ANSWER_LEN = 4, 2, (3000, 3200)
PX_SFT_IMAGE_HW = (336, 560)
PX_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_pixtral_lora_sft")
PX_GRPO_IMAGE_HW = [(512, 512), (336, 560)]
PX_GRPO_STEPS, PX_GRPO_PROMPT_LEN, PX_GRPO_COMPLETION_LEN = 2, 2048, 128
# phase 28c's decoder cut to 8 of 40 layers (the smoke's time)
PX_GRPO_LAYERS = 8

# the plain versions run one batch row, and within a row one slice of KV
# heads (with their query heads), at a time where the [B, H, T, S] f32
# scores would pass this: the LLaVA-OneVision decoder's 4 x 14 x 8192^2
# would hold 15 GB a tensor and Qwen2.5-VL-3B's SFT tower 16 x 8192^2 4 GB,
# the plain backward holds several, and the 3B's SFT state is 60 GB
PLAIN_WHOLE_BYTES = 2 ** 30

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
# phase 16 besides: at each of step 1's merged attention calls, the lse
# cotangent's part of dq and dk (given it, less without it) from K2 and K3
# against the plain versions' on the same inputs (LseProbeFlash), as a
# relative L2 distance over all the calls.  The limit sits between the
# rounding (a few percent predicted, PERF.md) and a cotangent at half
# weight (0.5); a backward that ignores it reads 1
GRPO_LSE_COTANGENT_LIMIT = 0.25


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


def importable(names):
    """Which of ``names`` import on this machine, tried in a child process
    so that what they load stays out of this one: started here, read by
    the function returned (the report line)."""
    child = subprocess.Popen([sys.executable, "-c", IMPORT_PROBE, *names],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)

    def read() -> str:
        out, err = child.communicate(timeout=300)
        return ", ".join(out.split("\n")[:-1]) or err[-200:]
    return read


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


def _record_window(fns, iters: int, host: bool):
    """A torch.profiler window over ``iters`` passes through ``fns``: the
    device's activity alone, or the host's too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    return prof


def _kernel_times(prof, calls: int) -> dict:
    """{kernel name: its device ms a call} of a window, read from the
    profiler's own kernel records: ``key_averages`` builds an event object
    and a parent tree for every record first, which was most of phase 3's
    host time (ROADMAP B.3), and a kernel's self time is its duration."""
    from torch.autograd import DeviceType

    times = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.duration_ns() <= 0):
            continue
        times[e.name()] = times.get(e.name(), 0.0) + (
            e.duration_ns() / 1e6 / calls)
    return times


def device_times(fns, iters: int = 10) -> dict:
    """Device time of one call, by kernel name: the kernels' own time
    under torch.profiler over ``iters`` passes through ``fns`` (each on
    inputs of its own, so a pass over more than the 50 MB L2 finds each
    input cold), per call.  Host time between launches is not counted."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    calls = iters * len(fns)
    # the window records the device's activity alone: the host operators'
    # records, which nothing here reads, would only lengthen the read.  A
    # window that recorded no device time is taken again with the host's
    # too, four times at most: after phase 35 every device-only window of
    # phase 37 records nothing, and now and then a host one too (three
    # empty windows in a row have failed a whole smoke)
    for attempt in range(5):
        times = _kernel_times(_record_window(fns, iters, host=attempt > 0),
                              calls)
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


def plain(fn, q, k, *rest, **kw):
    """``fn`` (flash_attention_ref or flash_attention_bwd_ref, whose
    arguments all lead with the batch and, but for the segment ids, the
    heads) on the whole batch, or in pieces (a batch row, a slice of its
    KV heads with their query heads) whose f32 scores stay within
    PLAIN_WHOLE_BYTES; the outputs concatenated along heads and batch."""
    B, H, T = q.shape[:3]
    Hkv, S = k.shape[1], k.shape[2]
    if 4 * B * H * T * S <= PLAIN_WHOLE_BYTES:
        return fn(q, k, *rest, **kw)
    step = max(1, min(Hkv, PLAIN_WHOLE_BYTES // (4 * (H // Hkv) * T * S)))

    def piece(a, b, h0):
        if a is None:
            return None
        a = a[b:b + 1]
        if a.dim() < 3:                          # segment ids [B, T]
            return a
        per_kv = a.shape[1] // Hkv
        return a[:, h0 * per_kv:(h0 + step) * per_kv]

    rows = []
    for b in range(B):
        parts = [fn(*(piece(a, b, h0) for a in (q, k, *rest)), **kw)
                 for h0 in range(0, Hkv, step)]
        rows.append(tuple(torch.cat(p, dim=1) for p in zip(*parts)))
    return tuple(torch.cat(parts) for parts in zip(*rows))


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

    def __init__(self, eos_token_id=IM_END, pad_token_id=ENDOFTEXT):
        self.eos_token_id, self.pad_token_id = eos_token_id, pad_token_id

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


def _seeded_image(rng, h, w):
    from PIL import Image

    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def make_llava_requests(bundle, seed: int = 10):
    """Four llava_next_qwen requests as token ids (the chatml of
    make_requests with each image a run of <image> tokens, as the port's
    VLMGenerator._encode_request writes it), a seeded image of IMAGE_HW
    each through the bundle's anyres preprocessing (PIL resizes)."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    encoded = []
    for i, (h, w) in enumerate(IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        ids = ([IM_START] + text(3) + [IM_END] + text(1)
               + [IM_START] + text(2) + [LLAVA_IMAGE] * n_img
               + text(20 + 7 * i) + [IM_END] + text(1)
               + [IM_START] + text(2))
        encoded.append((ids, [patches], [grid]))
    if sum(p[0].shape[0] for _, p, _ in encoded) != 16:
        raise AssertionError("the requests' images are not 16 tiles")
    return encoded


def make_llava_sft_rows(bundle, cutoff: int, seed: int = 11):
    """Eight synthetic IAD SFT examples in the llava_next_qwen chatml form
    (prompt masked, a labeled answer of 600-720 seeded tokens), the even
    ones with a seeded 448 x 448 image (5 tiles, 3699 image tokens),
    packed by pack_examples into rows of ``cutoff``: 4 rows, one image
    each."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples = []
    for i in range(LLAVA_SFT_EXAMPLES):
        image, extras = [], {}
        if i % 2 == 0:
            patches, grid, n_img = bundle.preprocess_image(
                _seeded_image(rng, *LLAVA_SFT_IMAGE_HW))
            image = [LLAVA_IMAGE] * n_img
            extras = {"extras": {"patches": [patches], "grid_thw": [grid]}}
        prompt = ([IM_START] + text(3) + [IM_END] + text(1)
                  + [IM_START] + text(2) + image + text(8 + 4 * i)
                  + [IM_END] + text(1) + [IM_START] + text(2))
        answer = text(int(rng.integers(ANSWER_LEN[0], ANSWER_LEN[1] + 1)))
        answer += [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer, **extras})
    rows = pack_examples(examples, cutoff, ENDOFTEXT)
    if len(rows) != 4 or any(len(r["extras"]) != 1 for r in rows):
        raise AssertionError("the examples did not pack into 4 rows of one "
                             "image each")
    return rows


def _q25_prompt(rng, h, w, extra):
    """A chatml prompt around one seeded h x w image, patchified by the
    port's numpy patchify: (ids, patches, grid)."""
    from iadr1_tpu_torch.vision.preprocess import patchify_image

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    flat, grid = patchify_image(rng.random((h, w, 3), dtype=np.float32))
    n_img = int(np.prod(grid)) // 4
    ids = ([IM_START] + text(3) + [IM_END] + text(1)
           + [IM_START] + text(2)
           + [VISION_START] + [IMAGE_PAD] * n_img + [VISION_END]
           + text(extra) + [IM_END] + text(1) + [IM_START] + text(2))
    return ids, flat, grid


def make_q25_requests(seed: int = 12):
    """Four chatml image requests for Qwen2.5-VL as token ids, images of
    Q25_IMAGE_HW (1024 and 864 patches)."""
    rng = np.random.default_rng(seed)
    encoded = []
    for i, (h, w) in enumerate(Q25_IMAGE_HW):
        ids, flat, grid = _q25_prompt(rng, h, w, 20 + 7 * i)
        encoded.append((ids, [flat], [grid]))
    return encoded


def make_q25_sft_rows(cutoff: int, seed: int = 13):
    """Six synthetic IAD SFT examples (an image of Q25_IMAGE_HW each, the
    prompt masked, a labeled answer of 900-1100 seeded tokens) packed by
    pack_examples into 2 rows of ``cutoff``, three images a row."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(Q25_SFT_EXAMPLES):
        prompt, flat, grid = _q25_prompt(rng, *Q25_IMAGE_HW[i % 4], 8 + 4 * i)
        answer = rng.integers(0, ENDOFTEXT, int(rng.integers(
            Q25_ANSWER_LEN[0], Q25_ANSWER_LEN[1] + 1))).tolist() + [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [flat], "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, ENDOFTEXT)
    if len(rows) != Q25_SFT_ROWS or any(len(r["extras"]) != 3 for r in rows):
        raise AssertionError("the examples did not pack into 2 rows of 3")
    return rows


def make_q25_grpo_examples(seed: int = 14):
    """Two one-image prompts for Qwen2.5-VL (336 x 504, whose last window
    column is cut, and 448 x 448) with a ``solution`` in the reward
    grammar: one normal, one anomalous."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate((Q25_IMAGE_HW[1], Q25_IMAGE_HW[0])):
        ids, flat, grid = _q25_prompt(rng, h, w, 40 + 25 * i)
        examples.append({"prompt_ids": ids, "patches": [flat],
                         "grid_thw": [grid], "solution": GRPO_SOLUTIONS[i]})
    return examples


def make_ov_grpo_examples(bundle, seed: int = 15):
    """Two llava_next_qwen prompts for LLaVA-OneVision (the chatml of
    make_llava_requests), one image each of OV_GRPO_IMAGE_HW through the
    bundle's anyres preprocessing, with a ``solution`` in the reward
    grammar: one anomalous, one normal."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples = []
    for i, (h, w) in enumerate(OV_GRPO_IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        ids = ([IM_START] + text(3) + [IM_END] + text(1)
               + [IM_START] + text(2) + [LLAVA_IMAGE] * n_img
               + text(40 + 25 * i) + [IM_END] + text(1)
               + [IM_START] + text(2))
        examples.append({"prompt_ids": ids, "patches": [patches],
                         "grid_thw": [grid], "solution": GRPO_SOLUTIONS[i]})
    return examples


def _llama3_prompt(rng, image_ids, extra):
    """A llava_next_llama3 user turn as token ids: BOS, the user header,
    the image run and seeded text, EOT, the assistant header."""
    def text(n):
        return rng.integers(0, LLAMA3_BOS, n).tolist()

    return ([LLAMA3_BOS, LLAMA3_HEADER_START] + text(1)
            + [LLAMA3_HEADER_END] + text(1) + image_ids + text(extra)
            + [LLAMA3_EOT, LLAMA3_HEADER_START] + text(1)
            + [LLAMA3_HEADER_END] + text(1))


def make_next_requests(bundle, seed: int = 16):
    """Four llava_next_llama3 requests for LLaVA-NeXT-8B as token ids, a
    seeded image of IMAGE_HW each through the bundle's anyres
    preprocessing (5 + 3 + 5 + 3 = 16 tiles)."""
    from iadr1_tpu_torch.vision.anyres import onevision_feature_len

    rng = np.random.default_rng(seed)
    encoded, lens = [], []
    for i, (h, w) in enumerate(IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        if n_img != onevision_feature_len((h, w), grid[:2], 24, None):
            raise AssertionError("the feature count is not onevision's")
        lens.append(n_img)
        encoded.append((_llama3_prompt(rng, [NEXT_IMAGE] * n_img,
                                       20 + 7 * i), [patches], [grid]))
    if sum(p[0].shape[0] for _, p, _ in encoded) != 16:
        raise AssertionError("the requests' images are not 16 tiles")
    return encoded, lens


def make_v15_requests(bundle, seed: int = 17):
    """Four vicuna-form requests for LLaVA-1.5-7B as token ids (BOS, the
    system text, "USER:", 576 image tokens, seeded text, "ASSISTANT:"), a
    seeded image of IMAGE_HW each, resized and center-cropped to one
    tile."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(3, V15_IMAGE, n).tolist()

    encoded = []
    for i, (h, w) in enumerate(IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        if patches.shape != (1, 576, 588) or n_img != 576:
            raise AssertionError(f"a 1.5 image is {patches.shape}")
        encoded.append(([VICUNA_BOS] + text(40) + [V15_IMAGE] * n_img
                        + text(20 + 7 * i) + text(5), [patches], [grid]))
    return encoded


def make_next_sft_rows(bundle, cutoff: int, seed: int = 18,
                       n_rows: int = NEXT_SFT_ROWS, per_row: int = 2):
    """``n_rows * per_row`` synthetic IAD SFT examples in the
    llava_next_llama3 form, a seeded 336 x 560 image each (3 tiles, 1560
    features), the prompt masked and a labeled answer of 300-400 seeded
    tokens ending in EOT, packed by pack_examples into ``n_rows`` rows of
    ``cutoff``: ``per_row`` examples a row."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(n_rows * per_row):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, *NEXT_SFT_IMAGE_HW))
        prompt = _llama3_prompt(rng, [NEXT_IMAGE] * n_img, 8 + 4 * i)
        answer = rng.integers(0, LLAMA3_BOS, int(rng.integers(
            NEXT_SFT_ANSWER_LEN[0], NEXT_SFT_ANSWER_LEN[1] + 1))).tolist()
        answer += [LLAMA3_EOT]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [patches],
                                    "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, LLAMA3_END)
    if len(rows) != n_rows or any(len(r["extras"]) != per_row
                                  for r in rows):
        raise AssertionError(f"the examples did not pack into {n_rows} "
                             f"rows of {per_row}")
    return rows


def _internvl_prompt(rng, n_img, extra):
    """An intern_vl user turn as token ids (the template's chatml, the
    Qwen2.5 tokenizer having no BOS): <img> + <IMG_CONTEXT> x n_img +
    </img> inside the user message, then seeded text."""
    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    return ([IM_START] + text(3) + [IM_END] + text(1) + [IM_START] + text(2)
            + [INTERNVL_IMG_START] + [INTERNVL_IMAGE] * n_img
            + [INTERNVL_IMG_END] + text(extra) + [IM_END] + text(1)
            + [IM_START] + text(2))


def make_internvl_requests(bundle, seed: int = 19):
    """Four intern_vl requests for InternVL-2.5-4B as token ids, a seeded
    image of INTERNVL_IMAGE_HW each through the bundle's tiling (1, 7, 1
    and 13 tiles)."""
    rng = np.random.default_rng(seed)
    encoded = []
    for i, (h, w) in enumerate(INTERNVL_IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        encoded.append((_internvl_prompt(rng, n_img, 20 + 7 * i), [patches],
                        [grid]))
    tiles = [p[0].shape[0] for _, p, _ in encoded]
    if tiles != [1, 7, 1, 13]:
        raise AssertionError(f"the requests' images are {tiles} tiles")
    return encoded


def make_internvl_sft_rows(bundle, cutoff: int, seed: int = 20):
    """INTERNVL_SFT_ROWS synthetic IAD SFT examples in the intern_vl form,
    a seeded 336 x 560 image each (7 tiles, 1792 features), the prompt
    masked and a labeled answer of 1800-2000 seeded tokens ending in
    <|im_end|>, packed by pack_examples into rows of ``cutoff``: one
    example a row."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(INTERNVL_SFT_ROWS):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, *INTERNVL_SFT_IMAGE_HW))
        prompt = _internvl_prompt(rng, n_img, 8 + 4 * i)
        answer = rng.integers(0, ENDOFTEXT, int(rng.integers(
            INTERNVL_SFT_ANSWER_LEN[0], INTERNVL_SFT_ANSWER_LEN[1] + 1))
        ).tolist() + [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [patches],
                                    "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, ENDOFTEXT)
    if len(rows) != INTERNVL_SFT_ROWS or any(len(r["extras"]) != 1
                                             for r in rows):
        raise AssertionError("the examples did not pack into 2 rows of one")
    return rows


def make_internvl_grpo_examples(bundle, seed: int = 21):
    """Two intern_vl prompts (INTERNVL_GRPO_IMAGE_HW: 1 and 7 tiles) with
    a ``solution`` in the reward grammar: one normal, one anomalous."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(INTERNVL_GRPO_IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        examples.append({"prompt_ids": _internvl_prompt(rng, n_img,
                                                        40 + 25 * i),
                         "patches": [patches], "grid_thw": [grid],
                         "solution": GRPO_SOLUTIONS[i]})
    return examples


def _seeded_frames(rng, n, h, w):
    return [_seeded_image(rng, h, w) for _ in range(n)]


def make_video_sft_rows(cutoff: int, seed: int = 22):
    """VIDEO_SFT_ROWS synthetic SFT examples for Qwen2-VL, one video of 8
    seeded 336 x 448 frames each through the port's
    qwen2vl_preprocess_video (t = 4, 3072 patches, 768 video tokens
    between <|vision_start|> and <|vision_end|>), the prompt masked and a
    labeled answer of 2600-2900 seeded tokens, packed into rows of
    ``cutoff``: one example a row."""
    from iadr1_tpu_torch.data.packing import pack_examples
    from iadr1_tpu_torch.vision.preprocess import qwen2vl_preprocess_video

    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples = []
    for i in range(VIDEO_SFT_ROWS):
        flat, grid = qwen2vl_preprocess_video(
            _seeded_frames(rng, VIDEO_FRAMES, *VIDEO_FRAME_HW))
        n_vid = int(np.prod(grid)) // 4
        prompt = ([IM_START] + text(3) + [IM_END] + text(1) + [IM_START]
                  + text(2) + [VISION_START] + [VIDEO_PAD] * n_vid
                  + [VISION_END] + text(8 + 4 * i) + [IM_END] + text(1)
                  + [IM_START] + text(2))
        answer = text(int(rng.integers(VIDEO_SFT_ANSWER_LEN[0],
                                       VIDEO_SFT_ANSWER_LEN[1] + 1)))
        answer += [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [flat], "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, ENDOFTEXT)
    if len(rows) != VIDEO_SFT_ROWS or any(len(r["extras"]) != 1
                                          for r in rows):
        raise AssertionError("the video examples did not pack one a row")
    return rows


def make_video_examples(bundle, seed: int):
    """Two vicuna-form video prompts (BOS, seeded text, the video's run of
    video tokens, seeded text), 8 seeded 336 x 448 frames each through the
    bundle's preprocess_video, as the GRPO prompt collator takes them."""
    rng = np.random.default_rng(seed)
    vid = bundle.cfg.video_token_id
    examples = []
    for i in range(2):
        patches, _, n_vid = bundle.preprocess_video(
            _seeded_frames(rng, VIDEO_FRAMES, *VIDEO_FRAME_HW))
        ids = ([VICUNA_BOS] + rng.integers(3, 32000, 40).tolist()
               + [vid] * n_vid + rng.integers(3, 32000, 20 + 7 * i).tolist())
        examples.append({"prompt_ids": ids, "video_patches": [patches],
                         "solution": GRPO_SOLUTIONS[i]})
    return examples


def _paligemma_prompt(rng, n_img, extra):
    """A paligemma prompt as token ids: the image run ahead of BOS, then a
    Gemma user turn of seeded text and the model turn's opening."""
    def text(n):
        return rng.integers(1000, 256000, n).tolist()

    return ([PG_IMAGE] * n_img + [PG_BOS, PG_TURN] + text(2) + text(extra)
            + [PG_TURN_END] + text(1) + [PG_TURN] + text(2))


def make_paligemma_requests(bundle, seed: int = 25):
    """Four paligemma requests for PaliGemma-3B as token ids, a seeded
    image of PG_IMAGE_HW each, resized to one 448 x 448 tile."""
    rng = np.random.default_rng(seed)
    encoded = []
    for i, (h, w) in enumerate(PG_IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        encoded.append((_paligemma_prompt(rng, n_img, 20 + 9 * i), [patches],
                        [grid]))
    if any(p[0].shape != (1, 1024, 588) for _, p, _ in encoded):
        raise AssertionError("a request's image is not one tile of 1024")
    return encoded


def make_paligemma_sft_rows(bundle, cutoff: int, seed: int = 26):
    """PG_SFT_ROWS synthetic IAD SFT examples in the paligemma form, a
    seeded 336 x 560 image each (its 1024 tokens prepended), the prompt
    masked and a labeled answer of PG_SFT_ANSWER_LEN seeded tokens ending
    in <end_of_turn>, packed into rows of ``cutoff``: one example a row."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(PG_SFT_ROWS):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, 336, 560))
        prompt = _paligemma_prompt(rng, n_img, 8 + 4 * i)
        answer = rng.integers(1000, 256000, int(rng.integers(
            PG_SFT_ANSWER_LEN[0], PG_SFT_ANSWER_LEN[1] + 1))).tolist()
        answer += [PG_TURN_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [patches],
                                    "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, PG_PAD)
    if len(rows) != PG_SFT_ROWS or any(len(r["extras"]) != 1 for r in rows):
        raise AssertionError("the examples did not pack one to a row")
    return rows


def make_paligemma_grpo_examples(bundle, seed: int = 27):
    """Two paligemma prompts (one tile each) with a ``solution`` in the
    reward grammar: one normal, one anomalous."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(PG_GRPO_IMAGE_HW):
        patches, grid, n_img = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        examples.append({"prompt_ids": _paligemma_prompt(rng, n_img,
                                                         40 + 25 * i),
                         "patches": [patches], "grid_thw": [grid],
                         "solution": GRPO_SOLUTIONS[i]})
    return examples


def _pixtral_prompt(rng, grid, extra):
    """A pixtral prompt as token ids: BOS, [INST], seeded text, the image
    as rows of [IMG] each ending [IMG_BREAK] (the last [IMG_END]), seeded
    text, [/INST]."""
    def text(n):
        return rng.integers(1000, 131072, n).tolist()

    rows, cols = grid
    run = ([PX_IMAGE] * cols + [PX_BREAK]) * rows
    run[-1] = PX_END
    return [PX_BOS, PX_INST] + text(6) + run + text(extra) + [PX_INST_END]


def make_pixtral_requests(bundle, seed: int = 28):
    """Four pixtral requests for Pixtral-12B as token ids, a seeded image
    of PX_IMAGE_HW each (1024, 735, 735 and 3072 patches)."""
    rng = np.random.default_rng(seed)
    encoded = []
    for i, (h, w) in enumerate(PX_IMAGE_HW):
        patches, grid, seqlen = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        encoded.append((_pixtral_prompt(rng, seqlen, 20 + 9 * i), [patches],
                        [grid]))
    n = [p[0].shape[0] for _, p, _ in encoded]
    if n != [1024, 735, 735, 3072]:
        raise AssertionError(f"the requests' images are {n} patches")
    return encoded


def make_pixtral_sft_rows(bundle, cutoff: int, seed: int = 29):
    """PX_SFT_ROWS synthetic IAD SFT examples in the pixtral form, a seeded
    336 x 560 image each (735 patches, 756 tokens with the breaks), the
    prompt masked and a labeled answer ending in EOS, one example a row."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)
    examples = []
    for i in range(PX_SFT_ROWS):
        patches, grid, seqlen = bundle.preprocess_image(
            _seeded_image(rng, *PX_SFT_IMAGE_HW))
        prompt = _pixtral_prompt(rng, seqlen, 8 + 4 * i)
        answer = rng.integers(1000, 131072, int(rng.integers(
            PX_SFT_ANSWER_LEN[0], PX_SFT_ANSWER_LEN[1] + 1))).tolist()
        answer += [PX_EOS]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer,
                         "extras": {"patches": [patches],
                                    "grid_thw": [grid]}})
    rows = pack_examples(examples, cutoff, PX_PAD)
    if len(rows) != PX_SFT_ROWS or any(len(r["extras"]) != 1 for r in rows):
        raise AssertionError("the examples did not pack one to a row")
    return rows


def make_pixtral_grpo_examples(bundle, seed: int = 30):
    """Two pixtral prompts (1024 and 735 patches) with a ``solution``."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(PX_GRPO_IMAGE_HW):
        patches, grid, seqlen = bundle.preprocess_image(
            _seeded_image(rng, h, w))
        examples.append({"prompt_ids": _pixtral_prompt(rng, seqlen,
                                                       40 + 25 * i),
                         "patches": [patches], "grid_thw": [grid],
                         "solution": GRPO_SOLUTIONS[i]})
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


def _live_rows(pairs) -> tuple[float, float]:
    """The query rows and the key rows, over the batch, that take part in
    a valid pair: the rows of q (and of dO, lse and delta) and of k and v
    a kernel must read.  A row with none is only written (0, or +inf in
    the lse)."""
    return float(pairs.any(-1).sum()), float(pairs.any(1).sum())


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


def flash_case(B, H, Hkv, T, S, D, causal, q_seg, kv_seg, seed, timed,
               yardsticks=False, library=False):
    """K1 against its twin on the same bf16 inputs; when ``timed`` its
    device time and bound, where ``yardsticks`` (each kernel's first case
    in phase 3, the kernel line's) the twin's and SDPA's times, and where
    ``library`` (a row that ROADMAP's D.2-D.5 hold against SDPA) SDPA's."""
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
    ref_out, ref_lse = plain(flash_attention_ref, q, k, v, q_seg, kv_seg,
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
    q_rows, k_rows = _live_rows(pairs)
    nbytes = (2 * D * (H * q_rows + 2 * Hkv * k_rows) + 2 * out.numel()
              + 4 * lse.numel() + 4 * (q_seg.numel() + kv_seg.numel()))
    bound_flops, bound_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    if yardsticks:
        res["plain_ms"] = device_ms([lambda: plain(
            flash_attention_ref, q, k, v, q_seg, kv_seg, causal=causal,
            scale=scale)], iters=3)
    if yardsticks or library:
        mask = pairs[:, None]
        kr = k.repeat_interleave(H // Hkv, dim=1)
        vr = v.repeat_interleave(H // Hkv, dim=1)
        res["library_ms"] = device_ms([lambda: torch.nn.functional
                                       .scaled_dot_product_attention(
                                           q, kr, vr, attn_mask=mask)])
    res.update(
        ms=device_ms([lambda: flash_attention(q, k, v, segment_ids=q_seg,
                                              kv_segment_ids=kv_seg,
                                              causal=causal)]),
        bound_ms=1e3 * max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
        gflop=flops / 1e9,
    )
    return res


def bwd_case(B, H, Hkv, T, S, D, causal, q_seg, kv_seg, seed, timed,
             with_dlse=False, yardsticks=False, library=False):
    """K2 and K3 against flash_attention_bwd_ref on the same bf16 inputs
    (out and lse from K1, which is held against its twin there first);
    returns a result for K2, K3 and K1.  The plain backward's and SDPA's
    backward times are taken only where ``yardsticks`` (each kernel's
    first case in phase 3, which the kernel line reports), SDPA's alone
    where ``library`` (a row that ROADMAP's D.2-D.5 hold against SDPA)."""
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
        ref_out, ref_lse = plain(flash_attention_ref, q, k, v, q_seg,
                                 kv_seg, causal=causal, scale=scale)
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
    ref = plain(flash_attention_bwd_ref, q, k, v, q_seg, kv_seg, out, lse,
                do, dlse, **kw)
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
    live = _pairs(q_seg, kv_seg, causal)
    pairs = float(live.sum())
    q_rows, k_rows = _live_rows(live)
    # q, dO, lse and delta over the live query rows, k and v over the
    # live key rows, the segment ids whole
    reads = (2 * D * (2 * H * q_rows + 2 * Hkv * k_rows) + 4 * 2 * H * q_rows
             + 4 * (q_seg.numel() + kv_seg.numel()))
    yards = {}
    if yardsticks:
        yards["plain_ms"] = device_ms([lambda: plain(
            flash_attention_bwd_ref, q, k, v, q_seg, kv_seg, out, lse, do,
            dlse, **kw)], iters=3)
    if yardsticks or library:
        # SDPA's backward (dq, dk, dv together) on a saved forward, with
        # a boolean mask and K/V repeated for GQA
        mask = live[:, None]
        leaves = [t.detach().requires_grad_(True) for t in (
            q, k.repeat_interleave(H // Hkv, dim=1),
            v.repeat_interleave(H // Hkv, dim=1))]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask)
        yards["library_ms"] = device_ms([lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True)])
    for res, fn, n_products, out_numel in (
            (res_dq, flash_bwd_dq, 3, dq.numel()),
            (res_dkv, flash_bwd_dkv, 4, dk.numel() + dv.numel())):
        flops = 2.0 * n_products * H * D * pairs
        nbytes = reads + 2 * out_numel          # every row written
        bound_flops = flops / PEAK_BF16_FLOPS
        bound_bytes = nbytes / PEAK_HBM_BYTES
        times = device_times([lambda: fn(*args, **kw)])
        res.update(
            ms=sum(times.values()), split=split_text(times),
            **yards,
            bound_ms=1e3 * max(bound_flops, bound_bytes),
            bound_by="operations" if bound_flops >= bound_bytes else "bytes",
            gflop=flops / 1e9)
    return res_dq, res_dkv, res_fwd


# a decode step runs K4 once per decoder layer, each on its own cache
DECODE_LAYERS = 28


def decode_case(B, H, Hkv, S, D, length, seg, seed, timed,
                yardsticks=False, library=False):
    """K4 against its twin; when ``timed`` its warm device time and bound,
    where ``yardsticks`` (phase 3's first case, the kernel line's) the
    twin's and SDPA's times, both cold over DECODE_LAYERS caches, and one
    host call of each, and where ``library`` (a row that ROADMAP's D.5
    holds against SDPA) SDPA's warm time."""
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
    k4 = lambda: decode_attention(q, k, v, seg, length)
    split = device_times([k4])
    res.update(
        ms=sum(split.values()), split=split_text(split),
        bound_ms=1e3 * max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )
    if not (yardsticks or library):
        return res
    mask = ((torch.arange(S, device="cuda")[None, :] < length)
            & (seg != 0))[:, None, None, :]
    q4 = q[:, :, None, :]
    kr = k.repeat_interleave(H // Hkv, dim=1)
    vr = v.repeat_interleave(H // Hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q4, kr, vr, attn_mask=mask)
    res["library_ms"] = device_ms([lib])
    if not yardsticks:
        return res
    res.update(
        plain_ms=device_ms([lambda: decode_attention_ref(
            q, k, v, seg, length, scale=scale)]),
        # one call as the host sees it (CUDA events around the Python
        # call, launch overhead included)
        call_ms=time_ms(k4), library_call_ms=time_ms(lib))
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


def _yard_text(r: dict, twin: str, library: str) -> str:
    """The yardsticks' times of a timed case, where it took them."""
    if "library_ms" not in r:
        return "yardsticks not timed"
    if "plain_ms" not in r:
        return f"{twin} not timed, {library} {r['library_ms']:.4f}"
    return f"{twin} {r['plain_ms']:.4f}, {library} {r['library_ms']:.4f}"


def log_kernel_results(fwd, dec, bwd) -> None:
    """A line for each case of phase 3: K1's results ``fwd``, K4's ``dec``
    and (K2, K3, K1) triples ``bwd``."""
    for r in fwd:
        log(f"kernels: flash_fwd {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, lse {r['lse_max_abs_err']:.3e}"
            + (f", live tiles {r['live_tile_share']:.3f} (unmasked "
               f"{r['full_tile_share']:.3f})" if "live_tile_share" in r
               else "")
            + (f"; {r['ms']:.4f} ms ({_yard_text(r, 'twin', 'sdpa')}, "
               f"bound {r['bound_ms']:.4f} {r['bound_by']}, "
               f"{r['gflop']:.2f} GFLOP)" if "ms" in r else "")
            + (f"; padded to 80 in the wrapper {r['wrapper_pad_ms']:.4f} "
               f"ms, max_abs_err {r['wrapper_pad_err']:.3e}"
               if "wrapper_pad_ms" in r else ""))
    for r in dec:
        log(f"kernels: decode_attention {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}"
            + (f"; warm {r['ms']:.4f} ms ({_yard_text(r, 'twin', 'sdpa')}, "
               f"bound {r['bound_ms']:.4f} {r['bound_by']})"
               if "ms" in r else "")
            + (f"; cold over {DECODE_LAYERS} caches "
               f"({r['cold_caches_mb']:.0f} MB) {r['ms_cold']:.4f} ms "
               f"(sdpa {r['library_ms_cold']:.4f}); one call with its "
               f"launch {r['call_ms']:.4f} ms (sdpa "
               f"{r['library_call_ms']:.4f})" if "ms_cold" in r else "")
            + (f"; kernels {r['split']}" if "ms" in r else ""))
    for rdq, rdkv, _ in bwd:
        for name, r in (("flash_bwd_dq", rdq), ("flash_bwd_dkv", rdkv)):
            log(f"kernels: {name} {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3e}"
                + (f", live tiles {r['live_tile_share']:.3f}"
                   if "live_tile_share" in r else "")
                + (f" (unmasked {r['full_tile_share']:.3f})"
                   if "full_tile_share" in r else "")
                + (f"; {r['ms']:.4f} ms "
                   f"({_yard_text(r, 'plain bwd', 'sdpa bwd')}, bound "
                   f"{r['bound_ms']:.4f} {r['bound_by']}, "
                   f"{r['gflop']:.2f} GFLOP; kernels {r['split']})"
                   if "ms" in r else "")
                + (f"; padded to 80 in the wrapper {r['wrapper_pad_ms']:.4f}"
                   f" ms, max_abs_err {r['wrapper_pad_err']:.3e}"
                   if "wrapper_pad_ms" in r else ""))


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
                       tower_seg, tower_seg, 1, timed=True, yardsticks=True)
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
                      timed=True, yardsticks=True)
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
                 tower_train, tower_train, 11, timed=True, yardsticks=True),
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
    log_kernel_results([tower, prefill, *extra], [dec, *dec_extra], bwd)
    return {"flash_fwd": [tower, prefill] + extra,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": [dec] + dec_extra}


def wrapper_pad_case(tower_results, B, H, T, seed):
    """K1-K3 at D = 72 the other way: q, k, v and dO zero-padded to 80
    columns in the wrapper, the D = 80 kernels at 72's scale, the outputs
    cut back to 72.  Held to the plain versions with the limits the
    in-kernel padding meets, and timed by device time, pads and cuts
    included; the times and errors go into the tower's results
    ``tower_results`` (K1, K2, K3)."""
    import torch.nn.functional as F

    from iadr1_tpu_torch.kernels.flash_attention import (
        _delta,
        flash_attention,
        flash_attention_bwd_ref,
        flash_attention_ref,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.bfloat16)
    q, do = (torch.randn((B, H, T, 72), generator=gen, **dev)
             for _ in range(2))
    k, v = (torch.randn((B, H, T, 72), generator=gen, **dev)
            for _ in range(2))
    ones = torch.ones((B, T), device="cuda", dtype=torch.int32)
    scale = 72 ** -0.5
    kw = dict(causal=False, scale=scale)

    def widen(t):
        return F.pad(t, (0, 8))

    def fwd():
        out, lse = flash_attention(widen(q), widen(k), widen(v), **kw)
        return out[..., :72].contiguous(), lse

    with torch.no_grad():
        out, lse = fwd()
    ref_out, ref_lse = plain(flash_attention_ref, q, k, v, ones, ones, **kw)
    torch.cuda.synchronize()
    fwd_res = check_fwd("wrapper pad", out, lse, ref_out, ref_lse, ones,
                        ones, False)
    del ref_out, ref_lse
    # the backward's inputs: the forward's padded q, k, v; dO padded once,
    # in K2's time
    delta = _delta(out, do, None).contiguous()
    qkv80 = (widen(q), widen(k), widen(v))
    do80 = widen(do)

    def dq():
        return flash_bwd_dq(*qkv80, ones, ones, lse, delta, widen(do),
                            **kw)[..., :72].contiguous()

    def dkv():
        dk, dv = flash_bwd_dkv(*qkv80, ones, ones, lse, delta, do80, **kw)
        return dk[..., :72].contiguous(), dv[..., :72].contiguous()

    got = (dq(), *dkv())
    ref = plain(flash_attention_bwd_ref, q, k, v, ones, ones, out, lse, do,
                None, **kw)
    torch.cuda.synchronize()
    errs = [check_close(f"wrapper pad {name}", g, w,
                        BWD_ATOL_FRAC * float(w.float().abs().max()),
                        BWD_RTOL)
            for name, g, w in zip(("dq", "dk", "dv"), got, ref)]
    del got, ref
    for res, fn, err in ((tower_results[0], fwd, fwd_res["max_abs_err"]),
                         (tower_results[1], dq, errs[0]),
                         (tower_results[2], dkv, max(errs[1:]))):
        res["wrapper_pad_ms"] = device_ms([fn])
        res["wrapper_pad_err"] = err


def phase_kernels_llava(encoded, rows, max_new_tokens, pad_compare=False):
    """Phase 3 at LLaVA-OneVision-0.5B's shapes: K1-K3 at the SigLIP
    tower's D = 72 (22 tiles of 729, 16 heads, non-causal, all-ones ids
    per tile), with the wrapper-padding design beside them when
    ``pad_compare``; K1 at the prefill (P = 4096, GQA 7, left padding)
    and at the SFT decoder (4 rows of 8192, packed segments), K2 and K3
    there too; K4 at GQA 7 over the serving cache.  Returns the results by kernel, the tower's first."""
    cuda = dict(device="cuda", dtype=torch.int32)
    tiles = LLAVA_PATCH_BUDGET // 729
    P, B = LLAVA_PROMPT_LEN, BATCH
    left = torch.zeros((B, P), **cuda)
    for b, (ids, _, _) in enumerate(encoded):
        left[b, P - len(ids):] = 1
    S_dec = P + max_new_tokens
    dec_seg = torch.ones((B, S_dec), **cuda)
    dec_seg[:, :P] = left
    train_seg = torch.as_tensor(np.stack([r["segment_ids"] for r in rows]),
                                **cuda)
    T = train_seg.shape[1]
    ones = torch.ones((tiles, 729), **cuda)
    tower = (22, 16, 16, 729, 729, 72, False, ones, ones)
    assert tiles == tower[0]
    tower_bwd = bwd_case(*tower, 61, timed=True)
    tower_fwd = flash_case(*tower, 62, timed=True)
    if pad_compare:
        wrapper_pad_case((tower_fwd, *tower_bwd[:2]), tiles, 16, 729, 63)
    prefill = flash_case(B, 14, 2, P, P, 64, True, left, left, 64,
                         timed=True)
    train_bwd = bwd_case(B, 14, 2, T, T, 64, True, train_seg, train_seg, 65,
                         timed=True)
    train_fwd = flash_case(B, 14, 2, T, T, 64, True, train_seg, train_seg,
                           66, timed=True)
    dec = decode_case(B, 14, 2, S_dec, 64, S_dec, dec_seg, 67, timed=True)
    for r in (tower_fwd, *tower_bwd, prefill, *train_bwd, train_fwd, dec):
        r["shape"] = "llava-ov: " + r["shape"]
    fwd = [tower_fwd, prefill, train_fwd, tower_bwd[2], train_bwd[2]]
    log_kernel_results(fwd, [dec], [tower_bwd, train_bwd])
    return {"flash_fwd": fwd, "flash_bwd_dq": [tower_bwd[0], train_bwd[0]],
            "flash_bwd_dkv": [tower_bwd[1], train_bwd[1]],
            "decode_attention": [dec]}


def phase_kernels_q25(encoded, rows, grpo_examples, max_new_tokens,
                      lora_rows):
    """Phase 3 at Qwen2.5-VL's shapes: K1-K3 over the window-ordered tower
    stream (16 heads, D = 80, non-causal) of the 7B serving batch (two
    448 x 448 and two 336 x 504 images in 4096 patches) with its window
    segments, whose cut windows put two windows in one 64-row block, and
    its image segments, and of four 448 x 448 images, whose windows of 64
    patches line up with the blocks; K1 at the 7B prefill (P = 1024, GQA
    7, D = 128, left padding); K1-K3 at the 3B SFT decoder (2 rows of
    4096, GQA 8, packed) and at phase 20's 7B LoRA SFT decoder (8 rows of
    4096, GQA 7, one image and one text example a row); K4 at GQA 7 over
    the 7B serving cache and at GQA 8 over the 3B SC-GRPO fan-out (8
    rows, P + N = 4608).  Returns the results by kernel, the aligned
    tower's first."""
    from iadr1_tpu_torch.models.qwen25_vl import (
        Qwen25VLVisionConfig,
        qwen25vl_vision_arrays,
    )

    cuda = dict(device="cuda", dtype=torch.int32)

    def tower_segs(grids, key):
        arrs = qwen25vl_vision_arrays(np.asarray(grids),
                                      Qwen25VLVisionConfig(),
                                      pad_to=PATCH_BUDGET)
        return torch.as_tensor(arrs[key], **cuda)[None]

    serve_grids = [g for _, _, gs in encoded for g in gs]
    aligned = [(1, 32, 32)] * 4
    towers = [("q25 tower windows aligned", tower_segs(aligned,
                                                       "window_segs")),
              ("q25 tower windows cut", tower_segs(serve_grids,
                                                   "window_segs")),
              ("q25 tower full images", tower_segs(serve_grids, "full_segs"))]
    fwd, bwd = [], []
    for i, (label, seg) in enumerate(towers):
        shape = (1, 16, 16, PATCH_BUDGET, PATCH_BUDGET, 80, False, seg, seg)
        results = (*bwd_case(*shape, 71 + i, timed=True),
                   flash_case(*shape, 74 + i, timed=True))
        for r in results:
            r["shape"] = f"{label}: {r['shape']}"
        bwd.append(results[:3])
        fwd.append(results[3])
    left = torch.zeros((BATCH, PROMPT_LEN), **cuda)
    for b, (ids, _, _) in enumerate(encoded):
        left[b, PROMPT_LEN - len(ids):] = 1
    prefill = flash_case(BATCH, 28, 4, PROMPT_LEN, PROMPT_LEN, 128, True,
                         left, left, 77, timed=True)
    train_seg = torch.as_tensor(np.stack([r["segment_ids"] for r in rows]),
                                **cuda)
    T = train_seg.shape[1]
    train = (Q25_SFT_ROWS, 16, 2, T, T, 128, True, train_seg, train_seg)
    train_bwd = bwd_case(*train, 78, timed=True)
    train_fwd = flash_case(*train, 79, timed=True)
    lora_seg = torch.as_tensor(
        np.stack([r["segment_ids"] for r in lora_rows]), **cuda)
    lora = (LORA_SFT_ROWS, 28, 4, T, T, 128, True, lora_seg, lora_seg)
    lora_bwd = bwd_case(*lora, 82, timed=True)
    lora_fwd = flash_case(*lora, 83, timed=True)
    S_dec = PROMPT_LEN + max_new_tokens
    dec_seg = torch.ones((BATCH, S_dec), **cuda)
    dec_seg[:, :PROMPT_LEN] = left
    dec = decode_case(BATCH, 28, 4, S_dec, 128, S_dec, dec_seg, 80,
                      timed=True)
    # the fan-out: each prompt's rows share its left padding, then G
    # completions of N = 512 each
    P, G, N = 4096, 4, 512
    fan = torch.ones((len(grpo_examples) * G, P + N), **cuda)
    for b, ex in enumerate(grpo_examples):
        fan[b * G:(b + 1) * G, :P - len(ex["prompt_ids"])] = 0
    fan_dec = decode_case(len(grpo_examples) * G, 16, 2, P + N, 128, P + N,
                          fan, 81, timed=True)
    for r, label in ((prefill, "q25 7B prefill"), (train_fwd, "q25 3B sft"),
                     (train_bwd[0], "q25 3B sft"),
                     (train_bwd[1], "q25 3B sft"),
                     (train_bwd[2], "q25 3B sft"), (dec, "q25 7B decode"),
                     (fan_dec, "q25 3B grpo fan-out"),
                     (lora_fwd, "q25 7B lora sft"),
                     *((r, "q25 7B lora sft") for r in lora_bwd)):
        r["shape"] = f"{label}: {r['shape']}"
    fwd += ([prefill, train_fwd, train_bwd[2], lora_fwd, lora_bwd[2]]
            + [f for _, _, f in bwd])
    bwd += [train_bwd, lora_bwd]
    log_kernel_results(fwd, [dec, fan_dec], bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": [dec, fan_dec]}


def _left_segments(encoded, P):
    """[B, P] segment ids of left-padded prompts."""
    seg = torch.zeros((len(encoded), P), device="cuda", dtype=torch.int32)
    for b, (ids, _, _) in enumerate(encoded):
        seg[b, P - len(ids):] = 1
    return seg


def phase_kernels_llava_families(next_encoded, v15_encoded, next_rows,
                                 ov_examples, max_new_tokens):
    """Phase 3 at the shapes of phases 16-19: K1-K3 at the CLIP-L tower
    (16 heads, D = 64, non-causal, each tile its own 577 tokens) over
    LLaVA-NeXT serving's 16 tiles and over the SFT batch's budget of 28
    tiles, 16 of them padding at segment 0; K1 at the LLaMA-3-8B prefill
    (P = 4096, GQA 4) and the Vicuna-7B prefill (P = 1024, GQA 1); K1-K3 at
    the 8B-cut SFT decoder (2 rows of 4096, GQA 4, packed); K1-K3 at
    LLaVA-OneVision's SC-GRPO update (H = 14 over 2, D = 64: the
    completions' cross attention to the shared prompt and their self
    attention, both with dlse != 0, and the unique prompts) and K4 over
    its fanned-out cache; K4 at GQA 4 and GQA 1 over the serving caches.
    Returns the results by kernel."""
    cuda = dict(device="cuda", dtype=torch.int32)
    n_serve = sum(p[0].shape[0] for _, p, _ in next_encoded)
    serve_seg = torch.ones((n_serve, 577), **cuda)
    sft_tiles = 16384 // 576
    n_sft = sum(e["patches"][0].shape[0] for r in next_rows
                for e in r["extras"])
    sft_seg = torch.zeros((sft_tiles, 577), **cuda)
    sft_seg[:n_sft] = 1
    towers = [("clip tower serve", serve_seg), ("clip tower sft", sft_seg)]
    fwd, bwd, dec = [], [], []
    for i, (label, seg) in enumerate(towers):
        shape = (seg.shape[0], 16, 16, 577, 577, 64, False, seg, seg)
        results = (*bwd_case(*shape, 101 + i, timed=True, library=True),
                   flash_case(*shape, 103 + i, timed=True))
        for r in results:
            r["shape"] = f"{label}: {r['shape']}"
        bwd.append(results[:3])
        fwd.append(results[3])
    l3 = _left_segments(next_encoded, NEXT_PROMPT_LEN)
    v15 = _left_segments(v15_encoded, V15_PROMPT_LEN)
    fwd.append(flash_case(BATCH, 32, 8, NEXT_PROMPT_LEN, NEXT_PROMPT_LEN,
                          128, True, l3, l3, 105, timed=True))
    fwd.append(flash_case(BATCH, 32, 32, V15_PROMPT_LEN, V15_PROMPT_LEN,
                          128, True, v15, v15, 106, timed=True))
    fwd[-2]["shape"] = "llava-next-8b prefill: " + fwd[-2]["shape"]
    fwd[-1]["shape"] = "llava-1.5-7b prefill: " + fwd[-1]["shape"]
    train_seg = torch.as_tensor(
        np.stack([r["segment_ids"] for r in next_rows]), **cuda)
    T = train_seg.shape[1]
    train = (NEXT_SFT_ROWS, 32, 8, T, T, 128, True, train_seg, train_seg)
    results = (*bwd_case(*train, 107, timed=True),
               flash_case(*train, 108, timed=True))
    for r in results:
        r["shape"] = f"llava-next sft: {r['shape']}"
    bwd.append(results[:3])
    fwd.append(results[3])
    # LLaVA-OneVision's SC-GRPO update: the unique prompts, left-padded,
    # repeated over the group for the cross attention; completions with
    # seeded ends (rollouts that ended early), one of one token, one whole
    G, P, N = 4, 4096, 512
    n = len(ov_examples)
    p_seg = torch.zeros((n, P), **cuda)
    for b, ex in enumerate(ov_examples):
        p_seg[b, P - len(ex["prompt_ids"]):] = 1
    p_rep = p_seg.repeat_interleave(G, dim=0)
    g = torch.Generator().manual_seed(109)
    stops = torch.randint(2, N, (n * G,), generator=g)
    stops[0], stops[1] = N, 1
    c_seg = (torch.arange(N)[None, :] < stops[:, None]).to(**cuda)
    for i, (label, shape, dlse) in enumerate((
            ("ov grpo cross", (n * G, 14, 2, N, P, 64, False, c_seg, p_rep),
             True),
            ("ov grpo self", (n * G, 14, 2, N, N, 64, True, c_seg, c_seg),
             True),
            ("ov grpo prompt", (n, 14, 2, P, P, 64, True, p_seg, p_seg),
             False))):
        # SDPA at the cross and self calls (ROADMAP D.2-D.4)
        results = (*bwd_case(*shape, 110 + i, timed=True, with_dlse=dlse,
                             library=i < 2),
                   flash_case(*shape, 113 + i, timed=True, library=i == 0))
        for r in results:
            r["shape"] = f"{label}: {r['shape']}"
        bwd.append(results[:3])
        fwd.append(results[3])
    fan = torch.cat([p_rep, c_seg], dim=1)
    S_l3 = NEXT_PROMPT_LEN + max_new_tokens
    S_v15 = V15_PROMPT_LEN + max_new_tokens
    l3_dec = torch.ones((BATCH, S_l3), **cuda)
    l3_dec[:, :NEXT_PROMPT_LEN] = l3
    v15_dec = torch.ones((BATCH, S_v15), **cuda)
    v15_dec[:, :V15_PROMPT_LEN] = v15
    for label, args in (
            ("llava-next-8b decode", (BATCH, 32, 8, S_l3, 128, S_l3, l3_dec,
                                      116)),
            ("llava-1.5-7b decode", (BATCH, 32, 32, S_v15, 128, S_v15,
                                     v15_dec, 117)),
            ("ov grpo fan-out", (n * G, 14, 2, P + N, 64, P + N, fan, 118))):
        dec.append(decode_case(*args, timed=True))
        dec[-1]["shape"] = f"{label}: {dec[-1]['shape']}"
    fwd += [f for _, _, f in bwd]
    log_kernel_results(fwd, dec, bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": dec}


def _labelled(results, label):
    for r in results:
        r["shape"] = f"{label}: {r['shape']}"
    return results


def phase_kernels_internvl_video(intern_encoded, intern_rows, intern_grpo,
                                 video_rows, video_budget, max_new_tokens):
    """Phase 3 at the shapes of phases 23-26: K1 at the InternViT tower
    (16 heads, D = 64, non-causal, each tile its own 1025 tokens) over
    serving's budget of 24 tiles (22 of them images', 2 at segment 0) and
    K1-K3 over the SFT batch's 16 (14 images'); K1 at the Qwen2.5-3B
    prefill (P = 4096, GQA 8, D = 128), K1-K3 at its SFT decoder (2 rows
    of 4096) and at its SC-GRPO update (the completions' cross attention to
    the shared prompt and their self attention, both with dlse != 0, and
    the unique prompts), K4 over the serving cache; K1 over the video
    frames of CLIP-L/336 (16 frames of 577) and of LanguageBind's 224 px
    tower (16 frames of 257), and K1-K3 over Qwen2-VL's video stream (each
    temporal patch of 768 its own segment, D = 80).  Returns the results
    by kernel."""
    cuda = dict(device="cuda", dtype=torch.int32)
    fwd, bwd, dec = [], [], []
    n_serve = sum(p[0].shape[0] for _, p, _ in intern_encoded)
    serve_seg = torch.zeros((INTERNVL_PATCH_BUDGET // 1024, 1025), **cuda)
    serve_seg[:n_serve] = 1
    fwd.append(_labelled([flash_case(serve_seg.shape[0], 16, 16, 1025, 1025,
                                     64, False, serve_seg, serve_seg, 121,
                                     timed=True)], "internvit serve")[0])
    n_sft = sum(e["patches"][0].shape[0] for r in intern_rows
                for e in r["extras"])
    sft_seg = torch.zeros((INTERNVL_SFT_BUDGET // 1024, 1025), **cuda)
    sft_seg[:n_sft] = 1
    shape = (sft_seg.shape[0], 16, 16, 1025, 1025, 64, False, sft_seg,
             sft_seg)
    results = _labelled((*bwd_case(*shape, 122, timed=True, library=True),
                         flash_case(*shape, 123, timed=True)),
                        "internvit sft")
    bwd.append(results[:3])
    fwd.append(results[3])
    pre = _left_segments(intern_encoded, INTERNVL_PROMPT_LEN)
    fwd.append(_labelled([flash_case(
        BATCH, 16, 2, INTERNVL_PROMPT_LEN, INTERNVL_PROMPT_LEN, 128, True,
        pre, pre, 124, timed=True)], "internvl prefill")[0])
    train_seg = torch.as_tensor(
        np.stack([r["segment_ids"] for r in intern_rows]), **cuda)
    T = train_seg.shape[1]
    train = (train_seg.shape[0], 16, 2, T, T, 128, True, train_seg,
             train_seg)
    results = _labelled((*bwd_case(*train, 125, timed=True),
                         flash_case(*train, 126, timed=True, library=True)),
                        "internvl sft decoder")
    bwd.append(results[:3])
    fwd.append(results[3])
    # the SC-GRPO update: the unique prompts, left-padded, repeated over
    # the group for the cross attention; completions with seeded ends
    G, P, N = 4, 4096, 512
    n = len(intern_grpo)
    p_seg = torch.zeros((n, P), **cuda)
    for b, ex in enumerate(intern_grpo):
        p_seg[b, P - len(ex["prompt_ids"]):] = 1
    p_rep = p_seg.repeat_interleave(G, dim=0)
    g = torch.Generator().manual_seed(127)
    stops = torch.randint(2, N, (n * G,), generator=g)
    stops[0], stops[1] = N, 1
    c_seg = (torch.arange(N)[None, :] < stops[:, None]).to(**cuda)
    for i, (label, shape, dlse) in enumerate((
            ("internvl grpo cross", (n * G, 16, 2, N, P, 128, False, c_seg,
                                     p_rep), True),
            ("internvl grpo self", (n * G, 16, 2, N, N, 128, True, c_seg,
                                    c_seg), True),
            ("internvl grpo prompt", (n, 16, 2, P, P, 128, True, p_seg,
                                      p_seg), False))):
        results = _labelled((*bwd_case(*shape, 128 + i, timed=True,
                                       with_dlse=dlse),
                             flash_case(*shape, 131 + i, timed=True)), label)
        bwd.append(results[:3])
        fwd.append(results[3])
    S = INTERNVL_PROMPT_LEN + max_new_tokens
    cache_seg = torch.ones((BATCH, S), **cuda)
    cache_seg[:, :INTERNVL_PROMPT_LEN] = pre
    dec.append(decode_case(BATCH, 16, 2, S, 128, S, cache_seg, 134,
                           timed=True))
    dec[-1]["shape"] = f"internvl decode: {dec[-1]['shape']}"
    # video frames through the CLIP towers, each frame its own sequence
    for i, (label, T) in enumerate((("llava-next-video frames", 577),
                                    ("video-llava frames", 257))):
        seg = torch.ones((2 * VIDEO_FRAMES, T), **cuda)
        fwd.append(_labelled([flash_case(2 * VIDEO_FRAMES, 16, 16, T, T, 64,
                                         False, seg, seg, 135 + i,
                                         timed=True)], label)[0])
    # Qwen2-VL's tower over the video batch's patch stream: one segment a
    # temporal patch, the budget's padding at segment 0
    from iadr1_tpu_torch.vision.preprocess import vision_segment_ids

    grids = [gr for r in video_rows for e in r["extras"]
             for gr in e["grid_thw"]]
    vseg = torch.as_tensor(vision_segment_ids(grids, pad_to=video_budget),
                           **cuda)[None]
    shape = (1, 16, 16, video_budget, video_budget, 80, False, vseg, vseg)
    results = _labelled((*bwd_case(*shape, 137, timed=True),
                         flash_case(*shape, 138, timed=True)),
                        "qwen2-vl video tower")
    bwd.append(results[:3])
    fwd.append(results[3])
    fwd += [f for _, _, f in bwd]
    log_kernel_results(fwd, dec, bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": dec}


def phase_kernels_paligemma_pixtral(pg_encoded, pg_grpo, px_encoded,
                                    px_rows, px_grpo, max_new_tokens):
    """Phase 3 at the shapes of phases 27-28: K4 at head dim 256, group 8
    (8 heads over 1) over PaliGemma-3B's serving cache and its SC-GRPO
    fan-out; K1-K3 at the SigLIP-448 tower (16 heads, D = 72, each tile
    its own 1024 tokens) over the SFT batch's budget of 8 tiles (2 of
    them images') and K1 over serving's 6 (4 images'); K1-K3 over
    Pixtral's packed patch stream (one row of 6144, D = 64, one segment an
    image, the tail at 0); K1 at the Mistral-NeMo prefill (P = 4096, 32
    heads over 8, D = 128), K1-K3 at its LoRA SFT rows (4 of 4096) and at
    the dense SC-GRPO update's rows (8 of P + N = 2176, causal, left
    padding and completions that end early); K4 over Pixtral's serving
    cache.  PaliGemma's decoder takes no K1-K3: its prefill, training and
    scoring attention is prefix-LM, dense.  Returns the results by
    kernel."""
    cuda = dict(device="cuda", dtype=torch.int32)
    fwd, bwd, dec = [], [], []
    # PaliGemma: K4 at D = 256 over the serving cache and the fan-out
    pre = _left_segments(pg_encoded, PG_PROMPT_LEN)
    S = PG_PROMPT_LEN + max_new_tokens
    cache_seg = torch.ones((BATCH, S), **cuda)
    cache_seg[:, :PG_PROMPT_LEN] = pre
    dec.append(decode_case(BATCH, 8, 1, S, 256, S, cache_seg, 141,
                           timed=True))
    dec[-1]["shape"] = f"paligemma decode: {dec[-1]['shape']}"
    G, P, N = 4, 4096, PG_GRPO_COMPLETION_LEN
    n = len(pg_grpo)
    p_seg = torch.zeros((n, P), **cuda)
    for b, ex in enumerate(pg_grpo):
        p_seg[b, P - len(ex["prompt_ids"]):] = 1
    fan = torch.cat([p_seg.repeat_interleave(G, dim=0),
                     torch.ones((n * G, N), **cuda)], dim=1)
    dec.append(decode_case(n * G, 8, 1, P + N, 256, P + N, fan, 142,
                           timed=True))
    dec[-1]["shape"] = f"paligemma grpo fan-out: {dec[-1]['shape']}"
    # the SigLIP-448 tower: serving's 6 tiles (4 live), SFT's 8 (2 live)
    for i, (label, budget, live, train) in enumerate((
            ("siglip-448 serve", PG_PATCH_BUDGET // 1024, len(pg_encoded),
             False),
            ("siglip-448 sft", 8192 // 1024, PG_SFT_ROWS, True))):
        seg = torch.zeros((budget, 1024), **cuda)
        seg[:live] = 1
        shape = (budget, 16, 16, 1024, 1024, 72, False, seg, seg)
        if train:
            results = _labelled((*bwd_case(*shape, 143, timed=True),
                                 flash_case(*shape, 144, timed=True)), label)
            bwd.append(results[:3])
            fwd.append(results[3])
        else:
            fwd.append(_labelled([flash_case(*shape, 145, timed=True)],
                                 label)[0])
    # Pixtral's tower: the serving batch's packed stream
    seg = torch.zeros((1, PX_PATCH_BUDGET), **cuda)
    off = 0
    for i, (_, patches, _) in enumerate(px_encoded):
        m = patches[0].shape[0]
        seg[0, off:off + m] = i + 1
        off += m
    shape = (1, 16, 16, PX_PATCH_BUDGET, PX_PATCH_BUDGET, 64, False, seg,
             seg)
    results = _labelled((*bwd_case(*shape, 146, timed=True),
                         flash_case(*shape, 147, timed=True)),
                        "pixtral patch stream")
    bwd.append(results[:3])
    fwd.append(results[3])
    # Mistral-NeMo: the prefill, the LoRA SFT rows, the dense update rows
    pre = _left_segments(px_encoded, PX_PROMPT_LEN)
    fwd.append(_labelled([flash_case(
        BATCH, 32, 8, PX_PROMPT_LEN, PX_PROMPT_LEN, 128, True, pre, pre, 148,
        timed=True)], "pixtral prefill")[0])
    train_seg = torch.as_tensor(
        np.stack([r["segment_ids"] for r in px_rows]), **cuda)
    T = train_seg.shape[1]
    shape = (train_seg.shape[0], 32, 8, T, T, 128, True, train_seg,
             train_seg)
    results = _labelled((*bwd_case(*shape, 149, timed=True),
                         flash_case(*shape, 150, timed=True, library=True)),
                        "pixtral sft decoder")
    bwd.append(results[:3])
    fwd.append(results[3])
    P, N = PX_GRPO_PROMPT_LEN, PX_GRPO_COMPLETION_LEN
    n = len(px_grpo)
    p_seg = torch.zeros((n, P), **cuda)
    for b, ex in enumerate(px_grpo):
        p_seg[b, P - len(ex["prompt_ids"]):] = 1
    g = torch.Generator().manual_seed(151)
    stops = torch.randint(2, N, (n * G,), generator=g)
    stops[0], stops[1] = N, 1
    c_seg = (torch.arange(N)[None, :] < stops[:, None]).to(**cuda)
    full = torch.cat([p_seg.repeat_interleave(G, dim=0), c_seg], dim=1)
    shape = (n * G, 32, 8, P + N, P + N, 128, True, full, full)
    results = _labelled((*bwd_case(*shape, 152, timed=True),
                         flash_case(*shape, 153, timed=True)),
                        "pixtral dense grpo update")
    bwd.append(results[:3])
    fwd.append(results[3])
    S = PX_PROMPT_LEN + max_new_tokens
    cache_seg = torch.ones((BATCH, S), **cuda)
    cache_seg[:, :PX_PROMPT_LEN] = pre
    dec.append(decode_case(BATCH, 32, 8, S, 128, S, cache_seg, 154,
                           timed=True))
    dec[-1]["shape"] = f"pixtral decode: {dec[-1]['shape']}"
    fwd += [f for _, _, f in bwd]
    log_kernel_results(fwd, dec, bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": dec}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def twin_attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
              causal=True):
    """The model-level attention signature over the K1 twin (no kernel);
    no segment ids (the SigLIP tower's tiles) are all ones."""
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention_ref

    if q_segments is None:
        q_segments = kv_segments = torch.ones(
            q.shape[:2], dtype=torch.int32, device=q.device)
    out, _ = plain(
        flash_attention_ref, q.transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), q_segments, kv_segments, causal=causal,
        scale=q.shape[-1] ** -0.5)
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


def phase_profile(label, gen, batch, steps: int = 8) -> None:
    """Where a generate's time goes: a short generate (prefill + ``steps``
    decode steps) under torch.profiler; device busy time is the sum of the
    kernels' own device time on the one stream."""
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
    log_profile(f"profile: {label}: prefill + {steps} decode steps: ", prof,
                wall_ms)


def time_prefill(gen, batch) -> float:
    """Host ms of one synchronised prefill (tower + decoder and the last
    position's logits) of a collated batch, warm (the second of two)."""
    from iadr1_tpu_torch.models import qwen2

    B, P = batch["input_ids"].shape
    b = {**batch, "segment_ids": batch["attention_mask"].to(torch.int32)}
    if "position_ids" not in b:          # 1-D positions, as the engine's
        b["position_ids"] = (b["attention_mask"].cumsum(1) - 1).clamp(min=0)
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


# the summaries of log_profile's children not yet logged: (pid, pipe)
_PROFILES: list = []
PROFILE_WAIT_S = 120


def log_profile(prefix: str, prof, wall_ms: float, **kw) -> None:
    """Logs ``prefix + device_time_summary(prof, wall_ms, **kw)`` later:
    the summary is computed in a forked child (the profiler's events
    turned into Python objects and averaged: up to ten seconds a training
    step on the host, while this process goes on to the next work) and
    logged by ``read_profiles``.  The child touches no CUDA; it writes
    the line down a pipe and exits."""
    import gc

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        # no collection frees a CUDA tensor here; a child that hangs ends
        gc.disable()
        signal.alarm(2 * PROFILE_WAIT_S)
        try:
            text = prefix + device_time_summary(prof, wall_ms, **kw)
        except BaseException as e:       # the line says what went wrong
            text = f"{prefix}not measured ({type(e).__name__}: {e})"
        with os.fdopen(w, "w") as f:
            f.write(text)
        os._exit(0)
    os.close(w)
    _PROFILES.append((pid, r, prefix))


def read_profiles(wait: bool) -> None:
    """Logs the summaries of log_profile's children that have finished,
    or (``wait``) of all of them, each given PROFILE_WAIT_S seconds at
    most before it is stopped and its line logged as not measured."""
    import select

    for pid, r, prefix in list(_PROFILES):
        done, _ = os.waitpid(pid, os.WNOHANG)
        if not done and not wait:
            continue
        ready = done or select.select([r], [], [], PROFILE_WAIT_S)[0]
        if ready:
            with os.fdopen(r) as f:
                text = f.read() or f"{prefix}not measured (no summary)"
        else:
            os.close(r)
            os.kill(pid, signal.SIGKILL)
            text = (f"{prefix}not measured (the summary took over "
                    f"{PROFILE_WAIT_S} s)")
        if not done:
            os.waitpid(pid, 0)
        _PROFILES.remove((pid, r, prefix))
        log(text)


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
        out, lse = plain(flash_attention_ref, q, k, v, q_seg, kv_seg,
                         causal=causal, scale=ctx.scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        from iadr1_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_ref,
        )

        dq, dk, dv = plain(flash_attention_bwd_ref, *ctx.saved_tensors, do,
                           dlse, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


class ZeroDqFlash(TwinFlash):
    """The control of the step-1 check: the plain backward with dq
    zeroed, a faulty backward its limits must catch."""

    @staticmethod
    def backward(ctx, do, dlse):
        dq, *rest = TwinFlash.backward(ctx, do, dlse)
        return (torch.zeros_like(dq), *rest)


def train_attn(flash):
    """The model-level attention signature over a flash Function; no
    segment ids (the SigLIP tower's tiles) are all ones, as the K1 wrapper
    takes them."""
    def attn(q, k, v, *, mask=None, q_segments=None, kv_segments=None,
             causal=True):
        if q_segments is None:
            q_segments = kv_segments = torch.ones(
                q.shape[:2], dtype=torch.int32, device=q.device)
        out, _ = flash.apply(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), q_segments, kv_segments,
                             causal)
        return out.transpose(1, 2)
    return attn


class GradProbe:
    """The optimizer, wrapped: on its first call it keeps the per-layer
    gradient norms of the attention's q, k and v projections in the
    decoder and the tower (a text model has none), and of a MoE decoder's
    router (the step hands its gradients only to the optimizer) and, with
    ``keep_grads``, those gradients themselves."""

    def __init__(self, optimizer, params, keep_grads=False):
        from iadr1_tpu_torch.train.state import tree_leaves

        leaves = tree_leaves(params)
        layers = params.get("text", params)["layers"]
        targets = [layers["attn"][n]["kernel"] for n in "qkv"]
        self.names = ["decoder q", "decoder k", "decoder v"]
        vision = params.get("vision", {})     # a text model has none
        if "blocks" in vision:                 # Qwen2-VL: one qkv kernel
            targets.append(vision["blocks"]["attn"]["qkv"]["kernel"])
            self.names.append("tower qkv")
        elif "layers" in vision:               # SigLIP: q, k, v apart
            targets += [vision["layers"]["attn"][n]["kernel"] for n in "qkv"]
            self.names += ["tower q", "tower k", "tower v"]
        if "router" in layers["mlp"]:          # Qwen2-MoE
            targets.append(layers["mlp"]["router"]["kernel"])
            self.names.append("router")
        self.index = [next(i for i, p in enumerate(leaves) if p is t)
                      for t in targets]
        self.optimizer, self.norms = optimizer, None
        self.keep_grads, self.grads = keep_grads, None

    def init(self, params, paths=None):
        return self.optimizer.init(params, paths)

    def apply(self, params, grads, state, grad_norm=None):
        if self.norms is None:
            parts = {}
            for name, i in zip(self.names, self.index):
                g = grads[i].detach()
                if name == "tower qkv":
                    parts.update(zip(("tower q", "tower k", "tower v"),
                                     g.chunk(3, dim=-1)))
                else:
                    parts[name] = g
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

    def rel(a, b):
        # a layer no gradient reaches (CLIP's last, which LLaVA does not
        # run) must stay at 0: its difference is taken absolutely
        d = (a - b).abs()
        return float(torch.where(b > 0, d / b.clamp(min=1e-30), d).max())

    return {
        "grad norm": abs(m["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"],
        "qkv grad norms": max(rel(norms[n], norms0[n]) for n in norms0),
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
    log_profile("profile: one training step: ", prof, wall_ms, top_n=10,
                ranges=STEP_RANGES)
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


class F32TwinFlash(torch.autograd.Function):
    """The plain path with p and ds unrounded: the plain versions on f32
    copies of q, k and v (out and the gradients back in their dtype), the
    function they computed before they took p and ds into their products
    in bf16, as the kernels do."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        from iadr1_tpu_torch.kernels.flash_attention import flash_attention_ref

        ctx.scale = q.shape[-1] ** -0.5
        out, lse = plain(flash_attention_ref, q.float(), k.float(),
                         v.float(), q_seg, kv_seg, causal=causal,
                         scale=ctx.scale)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        from iadr1_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_ref,
        )

        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        grads = plain(flash_attention_bwd_ref, q.float(), k.float(),
                      v.float(), q_seg, kv_seg, out, lse, do.float(), dlse,
                      causal=ctx.causal, scale=ctx.scale)
        return (*(g.to(q.dtype) for g in grads), None, None, None)


class F32DropDlseFlash(F32TwinFlash):
    @staticmethod
    def backward(ctx, do, dlse):
        return F32TwinFlash.backward(ctx, do, None)


class KernelFlash(torch.autograd.Function):
    """The port's flash Function (K1 forward, K2 + K3 backward on the
    card) in TwinFlash's signature, so that a subclass can hand the
    kernels' backward another lse cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        from iadr1_tpu_torch.kernels.flash_attention import FlashAttention

        segs = (s.to(torch.int32).contiguous() for s in (q_seg, kv_seg))
        return FlashAttention.forward(ctx, q.contiguous(), k.contiguous(),
                                      v.contiguous(), *segs, causal,
                                      q.shape[-1] ** -0.5)

    @staticmethod
    def backward(ctx, do, dlse):
        from iadr1_tpu_torch.kernels.flash_attention import FlashAttention

        return FlashAttention.backward(ctx, do, dlse)[:6]


class LseProbeFlash(KernelFlash):
    """The kernels' Function, whose backward also measures, at each call
    that receives a non-zero lse cotangent (the decoder's merged
    attentions), that cotangent's part of dq and dk on the call's own
    inputs: the kernels' (K2 and K3 given it, less K2 and K3 without it)
    against the plain versions', and as the control a plain backward given
    half of it.  ``sums`` gathers the squared norms over the calls; the
    step's gradients are the kernels'."""

    sums: dict = {}

    @staticmethod
    def backward(ctx, do, dlse):
        from iadr1_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_ref,
        )

        grads = KernelFlash.backward(ctx, do, dlse)
        if dlse is None or not bool((dlse != 0).any()):
            return grads
        without = KernelFlash.backward(ctx, do, None)
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors

        def ref(d):
            return plain(flash_attention_bwd_ref, q, k, v, q_seg, kv_seg,
                         out, lse, do, d, causal=ctx.causal, scale=ctx.scale)

        ref_with, ref_without, ref_half = ref(dlse), ref(None), ref(0.5 * dlse)
        sums = LseProbeFlash.sums
        for i in (0, 1):                                     # dq, dk
            part = ref_with[i].float() - ref_without[i].float()
            for key, got in (("kernels", grads[i].float()
                              - without[i].float()),
                             ("half", ref_half[i].float()
                              - ref_without[i].float())):
                sums[key] = sums.get(key, 0.0) + float(
                    (got - part).norm()) ** 2
            sums["part"] = sums.get("part", 0.0) + float(part.norm()) ** 2
            sums["whole"] = sums.get("whole", 0.0) + float(
                ref_with[i].float().norm()) ** 2
        sums["calls"] = sums.get("calls", 0) + 1
        return grads


def lse_probe_summary(label, what) -> dict:
    """Logs what ``LseProbeFlash`` gathered over a step's merged attention
    calls; returns the kernels' and the half-weight control's relative
    distances from the plain versions' lse-cotangent part."""
    sums = LseProbeFlash.sums
    if not sums.get("calls"):
        raise AssertionError(f"{label}: no attention call received an lse "
                             "cotangent")
    lse = {k: math.sqrt(sums[k] / sums["part"]) for k in ("kernels", "half")}
    log(f"{label}: {what} lse cotangent over {sums['calls']} merged "
        f"attention calls: its part of their dq and dk "
        f"{math.sqrt(sums['part'] / sums['whole']):.3e} of the whole; "
        f"kernels vs plain versions {lse['kernels']:.3e}, control (the "
        f"plain backward given half of it) {lse['half']:.3e} (limit "
        f"{GRPO_LSE_COTANGENT_LIMIT}; a backward without it reads 1)")
    return lse


def check_lse_probe(lse) -> None:
    if lse["kernels"] > GRPO_LSE_COTANGENT_LIMIT:
        raise AssertionError("the kernels' lse cotangent part differs from "
                             "the plain versions'")
    if lse["half"] <= GRPO_LSE_COTANGENT_LIMIT:
        raise AssertionError("the lse-cotangent limit does not catch a "
                             "halved lse cotangent")


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

    def generate(self, params, batch, generator=None, group_size=1, **kw):
        if self.replay is not None:
            return dict(self.replay)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.engine.generate(params, batch, generator,
                                   group_size=group_size, **kw)
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


# the step-1 check's controls: the plain path with a faulty backward,
# which the limits must catch (phases 7 and 15 take the first)
GRPO_CONTROLS = (("without the lse cotangent", DropDlseFlash),
                 ("with dq zeroed", ZeroDqFlash))


def grpo_step1_diffs(got, ref) -> dict:
    """Step 1 against the plain path: loss and kl absolutely (both start
    at 0); the global grad norm and the worst per-layer q/k/v projection
    grad norm relatively; and the worst per-layer relative distance
    |g - g0| / |g0| between the q and k projections' gradients, which
    reads a backward that turns them without changing their length (the
    v projection's never reads delta)."""
    (m, norms, grads), (m0, norms0, grads0) = got, ref

    def distance(n):
        # a layer whose gradient is 0 (a LoRA A at step 1, where B = 0)
        # must stay at 0: its distance is taken absolutely
        d = (grads[n] - grads0[n]).flatten(1).norm(dim=1)
        g0 = grads0[n].flatten(1).norm(dim=1)
        return float(torch.where(g0 > 0, d / g0.clamp(min=1e-30), d).max())

    return {"loss": abs(m["loss"] - m0["loss"]),
            "kl": abs(m["kl"] - m0["kl"]),
            **_grad_diffs((m, norms), (m0, norms0)),
            "q/k grad vectors": max(distance(n) for n in grads0
                                    if n.split(".")[0][-1] in "qk")}


def qwen_embeds(tower):
    """The prompts' input embeddings of a Qwen VLM: ``tower(params, cfg,
    batch, attn, remat)`` -> features, scattered onto the image tokens."""
    def embeds(params, cfg, batch, attn, remat):
        from iadr1_tpu_torch.models import qwen2_vl

        e = params["text"]["embed"]["weight"][batch["prompt_ids"]].to(
            torch.bfloat16)
        feats = tower(params, cfg, batch, attn, remat)
        return qwen2_vl.merge_image_features(
            e, feats, batch["scatter_rows"], batch["scatter_cols"])
    return embeds


def grpo_case_qwen2_vl() -> types.SimpleNamespace:
    """Phase 7's setting: Qwen2-VL-2B on cli/train_grpo.py's defaults
    (GRPOConfig's own), lr GRPO_LEARNING_RATE cosine."""
    from iadr1_tpu_torch.cli.train_grpo import GRPODataSection, GRPOSection
    from iadr1_tpu_torch.models import qwen2_vl
    from iadr1_tpu_torch.train.grpo import GRPOConfig
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig

    section = GRPOSection()                       # the launcher's defaults

    def tower(params, cfg, batch, attn, remat):
        return qwen2_vl.apply_vision(
            params["vision"], cfg.vision, batch["patches"], batch["rot_cos"],
            batch["rot_sin"], batch["vision_segments"], attention_fn=attn,
            remat=remat)

    return types.SimpleNamespace(
        label="grpo", name="Qwen2-VL-2B", hf=QWEN2_VL_2B,
        gcfg=GRPOConfig(
            num_generations=section.num_generations, beta=section.beta,
            temperature=section.temperature, top_p=section.top_p,
            top_k=section.top_k, max_prompt_length=section.max_prompt_length,
            max_completion_length=section.max_completion_length),
        sampling_overrides=None, reward_funcs=section.reward_funcs,
        data=GRPODataSection(patch_budget=GRPO_PATCH_BUDGET),
        opt_cfg=OptimizerConfig(learning_rate=GRPO_LEARNING_RATE,
                                total_steps=100),
        ref_dtype=torch.bfloat16, embeds=qwen_embeds(tower),
        # the tower blocks are plain checkpoints: the policy's backward
        # replays each one's attention forward
        tower_replays=1, vision_keys=("vision_segments",),
        controls=GRPO_CONTROLS[:1], lse_check=True, f32_check=False)


def grpo_case_q25(steps: int, label="q25 grpo", name="Qwen2.5-VL-3B",
                  hf=QWEN2_5_VL_3B) -> types.SimpleNamespace:
    """Phase 15's setting: Qwen2.5-VL-3B on configs/grpo_qwen2_5_vl_7b.yaml
    through the port's config loader, assembled as cli/train_grpo.py
    assembles it (approx_top_k becomes a sampling override, which warns
    and samples exactly)."""
    from iadr1_tpu_torch.cli.train_grpo import GRPOJobConfig
    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.train.grpo import GRPOConfig
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig

    job = load_config(GRPOJobConfig, Q25_GRPO_RECIPE)
    g = job.grpo
    return types.SimpleNamespace(
        label=label, name=name, hf=hf,
        gcfg=GRPOConfig(
            num_generations=g.num_generations, beta=g.beta,
            temperature=g.temperature, top_p=g.top_p, top_k=g.top_k,
            max_prompt_length=g.max_prompt_length,
            max_completion_length=g.max_completion_length),
        sampling_overrides={"approx_top_k": True} if g.approx_top_k else None,
        reward_funcs=g.reward_funcs, data=job.data,
        opt_cfg=dataclasses.replace(
            dataclass_from_dict(OptimizerConfig, job.optim),
            total_steps=steps),
        ref_dtype=getattr(torch, job.model.ref_dtype),
        embeds=qwen_embeds(q25_twin_tower),
        # every tower block keeps its attention outside the checkpoints;
        # the update batch must carry both segment arrays (C.R7)
        tower_replays=0, vision_keys=("full_segs", "window_segs"),
        controls=GRPO_CONTROLS[:1], lse_check=True, f32_check=False)


def grpo_case_ov(steps: int) -> types.SimpleNamespace:
    """Phase 16's setting: LLaVA-OneVision-0.5B on the grpo section of
    configs/grpo_qwen2_5_vl_7b.yaml (phase 15's), the patch budget sized
    for OneVision's tiles of 729 (OV_GRPO_PATCH_BUDGET), the decoder at
    OV_GRPO_LAYERS layers; the update batch must carry the anyres
    arrays (C.R9)."""
    from iadr1_tpu_torch.models import llava_onevision

    def embeds(params, cfg, batch, attn, remat):
        return llava_onevision.compute_embeds(
            params, cfg, batch["prompt_ids"], tiles=batch["tiles"],
            pack_src=batch["pack_src"], pack_weights=batch["pack_weights"],
            newline_mask=batch["newline_mask"],
            scatter_rows=batch["scatter_rows"],
            scatter_cols=batch["scatter_cols"],
            tile_segments=batch["tile_segments"], tower_attention_fn=attn,
            tower_remat=remat)

    cut = dict(LLAVA_OV_05B, text_config=dict(
        LLAVA_OV_05B["text_config"], num_hidden_layers=OV_GRPO_LAYERS))
    case = grpo_case_q25(steps, "ov grpo", f"LLaVA-OneVision-0.5B at "
                         f"{OV_GRPO_LAYERS} decoder layers", cut)
    case.data = dataclasses.replace(case.data,
                                    patch_budget=OV_GRPO_PATCH_BUDGET)
    case.embeds = embeds
    case.vision_keys = ("tiles", "tile_segments", "pack_src", "pack_weights",
                        "newline_mask")
    case.controls, case.f32_check = GRPO_CONTROLS, True
    return case


def phase_grpo(examples, steps: int, card, case):
    """SC-GRPO steps through GRPOTrainer.step in the setting ``case``
    (``grpo_case_*``), assembled as cli/train_grpo.py assembles them;
    returns the launch counts.  A family with no shared-prompt path
    (PaliGemma, Pixtral) takes the dense update over the G-repeated batch,
    whose plain path is ``case.plain_apply``; ``case.lora`` (a
    TuningConfig) runs LoRA with reference elision over a bf16 base;
    ``case.decoder_flash`` False: a prefix-LM decoder (dense, no K1-K3)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from iadr1_tpu_torch.cli.train_grpo import make_vlm_prompt_collator
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models import qwen2
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.models.shared_prompt import shared_prompt_pred_hidden
    from iadr1_tpu_torch.rewards import get_reward_funcs
    from iadr1_tpu_torch.train.adapters import count_params, init_lora_params
    from iadr1_tpu_torch.train.grpo import UPDATE_RANGES, GRPOTrainer
    from iadr1_tpu_torch.train.optimizers import make_optimizer
    from iadr1_tpu_torch.train.rollout import cast_dense_params
    from iadr1_tpu_torch.train.sft import batch_to_device
    from iadr1_tpu_torch.train.state import create_train_state

    bundle = bundle_from_hf_config(case.hf)
    cfg, gcfg, label = bundle.cfg, case.gcfg, case.label
    G, P, N = (gcfg.num_generations, gcfg.max_prompt_length,
               gcfg.max_completion_length)
    n = len(examples)
    dense = bundle.shared_pred_fn is None
    lora = getattr(case, "lora", None)
    decoder_flash = getattr(case, "decoder_flash", True)
    tokenizer = getattr(case, "tokenizer", None) or CannedTokenizer()
    # a text model (Qwen2-MoE) takes the trainer's own prompt collation
    collator = (make_vlm_prompt_collator(bundle, tokenizer, None, case.data,
                                         P, num_generations=G)
                if bundle.multimodal else None)
    tcfg = getattr(cfg, "text", cfg)
    reward_s = []

    def timed(fn):
        def reward(**kw):
            t0 = time.perf_counter()
            out = fn(**kw)
            reward_s.append(time.perf_counter() - t0)
            return out
        reward.__name__ = fn.__name__
        return reward

    rewards = [timed(fn) for fn in get_reward_funcs(case.reward_funcs)]

    def plain_bundle(flash):
        """The bundle with its shared-prompt scoring over a flash Function
        of the plain versions (the tower and the three decoder calls), or
        with its dense forward over it (``case.plain_apply``)."""
        tower_attn, attn_lse = train_attn(flash), lse_attn(flash)
        if dense:
            def apply(params, batch, cache=None, cache_mode="extend",
                      remat=False, tower_remat=None, lora=None,
                      lora_scale=1.0):
                return case.plain_apply(params, cfg, batch, tower_attn,
                                        remat, tower_remat, lora=lora,
                                        lora_scale=lora_scale), None

            return dataclasses.replace(bundle, apply=apply)

        def shared_pred(params, batch, group_size, remat=True):
            embeds = case.embeds(params, cfg, batch, tower_attn, bool(remat))
            return shared_prompt_pred_hidden(
                params["text"], cfg.text, batch, group_size,
                attention_fn=attn_lse, remat=remat, prompt_embeds=embeds)

        return dataclasses.replace(bundle, shared_pred_fn=shared_pred)

    base = None
    if lora is not None:
        # one bf16 base, drawn once: the policy is base + adapters, the
        # reference the base itself
        base = bundle.init_params(seed=0, dtype=torch.bfloat16,
                                  device=DEVICE)

    def fresh(used_bundle, replay=None):
        opt, sched = make_optimizer(case.opt_cfg)
        kw = dict(sampling_overrides=case.sampling_overrides, schedule=sched,
                  prompt_collator=collator, device=DEVICE, seed=0)
        if lora is not None:
            adapters = init_lora_params(
                torch.Generator(device=DEVICE).manual_seed(1), base, lora)
            probe = LoraGradProbe(opt, adapters, keep_grads=True)
            trainer = GRPOTrainer(
                used_bundle, tokenizer, probe, gcfg, rewards,
                create_train_state(adapters, probe), None, base_params=base,
                tuning_cfg=lora, **kw)
        else:
            params = bundle.init_params(seed=0, dtype=torch.float32,
                                        device=DEVICE)
            ref = _tree_map(lambda p: p.detach().to(case.ref_dtype), params)
            probe = GradProbe(opt, params, keep_grads=True)
            trainer = GRPOTrainer(
                used_bundle, tokenizer, probe, gcfg, rewards,
                create_train_state(params, probe), ref, **kw)
        trainer.engine = RolloutTap(trainer.engine, replay)
        return trainer, probe

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # --- the kernel path: the steps, their counts and their times ----------
    trainer, probe = fresh(bundle)
    tap = trainer.engine
    n_params = count_params(trainer.state.params)
    n_base = count_params(base) if lora is not None else n_params
    if getattr(case, "n_params_range", None) and not (
            case.n_params_range[0] < n_base < case.n_params_range[1]):
        raise AssertionError(f"{case.name} has {n_base / 1e9:.3f}B params, "
                             f"not in {case.n_params_range}")
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
    prefill_batch = batch_to_device(
        collator(examples, 1) if collator is not None
        else trainer._collate_prompts(examples), DEVICE)
    prefill_batch["segment_ids"] = prefill_batch["attention_mask"].to(
        torch.int32)
    if "position_ids" not in prefill_batch:     # 1-D, as the engine's
        prefill_batch["position_ids"] = llava_positions(
            prefill_batch["attention_mask"])
    if lora is not None:
        policy, lora_kw = base, {
            "lora": cast_dense_params(trainer.state.params, torch.bfloat16),
            "lora_scale": lora.lora_scale}
    else:
        policy = cast_dense_params(trainer.state.params, torch.bfloat16)
        lora_kw = {}
    for _ in range(2):                       # the second one is warm
        cache = qwen2.init_cache(tcfg, n, P, torch.bfloat16, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            bundle.apply(policy, prefill_batch, cache=cache,
                         cache_mode="prefill", **lora_kw)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
    del policy, cache, lora_kw
    release()

    L, Lt = tcfg.num_hidden_layers, tower_depth(cfg)
    Lf = L if decoder_flash else 0
    replays = case.tower_replays
    kernels = [k for k, _ in all_kernels()]
    step_s, per_step, total = [], [], {k.name: 0 for k in kernels}
    dense_calls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        for k in kernels:
            k.launches = 0
        prefix_lm = PrefixLmTap()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            trainer.step(examples)
            torch.cuda.synchronize()
        finally:
            prefix_lm.close()
        step_s.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        if dense:
            # K1: the rollout's prefill, the reference forward and the
            # policy forward, each over the tower and the decoder (a
            # prefix-LM decoder takes one dense call a layer instead).
            # K2 and K3: the policy's backward, the tower's layers too
            # unless it is frozen (LoRA).
            bwd = Lf + (0 if lora is not None else Lt)
            want = {"flash_fwd": 3 * (Lf + Lt) + replays * Lt,
                    "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
                    "decode_attention": L * tap.steps[i]}
        else:
            # K1: the rollout's prefill, the reference forward, and the
            # policy forward, whose tower blocks run again in the backward
            # where they are plain checkpoints; the three decoder calls of
            # a layer keep their residuals.  K2 and K3: once per attention
            # call of the policy.
            want = {"flash_fwd": ((L + Lt) + (3 * L + Lt)
                                  + (3 * L + (1 + replays) * Lt)),
                    "flash_bwd_dq": 3 * L + Lt, "flash_bwd_dkv": 3 * L + Lt,
                    "decode_attention": L * tap.steps[i]}
        if launches != want or tap.steps[i] < 1:
            raise AssertionError(f"{label} step {i + 1} launches "
                                 f"{launches}, want {want}")
        # the prefix-LM decoder: the rollout's prefill, the reference's
        # forward and the policy's, a dense call a layer each
        dense_calls.append(prefix_lm.calls)
        if prefix_lm.calls != 3 * (L - Lf):
            raise AssertionError(f"{label} step {i + 1}: {prefix_lm.calls} "
                                 "dense prefix-LM calls")
        per_step.append(launches)
        for name, count in launches.items():
            total[name] += count
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trainer.metrics_history
    first = (history[0], probe.norms, probe.grads)
    roll_s, roll_steps, roll_tokens = tap.seconds, tap.steps, tap.tokens

    missing = set(case.vision_keys) - set(update_batches[0])
    if missing:
        raise AssertionError(f"the update batch lacks {sorted(missing)}")
    adv = np.asarray(update_batches[0]["advantages"]).reshape(n, G)
    log(f"{label}: step 1 rewards mean {history[0]['reward']:.4f}, group std "
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
            raise AssertionError(f"{label} step {i + 1}: non-finite {bad}")
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
    log_profile(f"profile: one {case.name} GRPO update (reference forward, "
                "policy forward and backward, AdamW): ", prof, wall_ms,
                top_n=10, ranges=UPDATE_RANGES)
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
    runs, controls = {}, []
    for what, flash in case.controls:
        runs[flash] = replayed_step(flash)
        controls.append(grpo_step1_diffs(runs[flash], plain))
        log(f"{label}: step 1 control (plain path {what}) vs plain path: "
            + _diff_text(controls[-1], GRPO_STEP1_LIMITS, "diff"))
    lse = None
    if case.lse_check:
        # the lse cotangent's part of dq and dk at each merged attention,
        # on the kernels against the plain versions, from the calls' own
        # inputs
        LseProbeFlash.sums = {}
        probed = grpo_step1_diffs(replayed_step(LseProbeFlash), plain)
        lse = lse_probe_summary(label, "step 1")
        log(f"{label}: the probed step vs plain path "
            + _diff_text(probed, GRPO_STEP1_LIMITS, "diff"))
    if case.f32_check:
        # the step against the plain versions with p and ds unrounded
        f32 = replayed_step(F32TwinFlash)
        log(f"{label}: step 1 against the plain path with p and ds "
            f"unrounded: kernels "
            + _diff_text(grpo_step1_diffs(first, f32), GRPO_STEP1_LIMITS,
                         "diff")
            + "; control (without the lse cotangent) "
            + _diff_text(grpo_step1_diffs(replayed_step(F32DropDlseFlash),
                                          f32), GRPO_STEP1_LIMITS, "diff"))
        del f32
    del runs
    diffs = grpo_step1_diffs(first, plain)
    log(f"{label}: step 1 kernel vs plain path on the recorded rollout: "
        f"update batch holds {', '.join(case.vision_keys) or 'text only'}; "
        f"loss "
        f"{first[0]['loss']:.3e} vs {plain[0]['loss']:.3e}, kl "
        f"{first[0]['kl']:.3e} vs {plain[0]['kl']:.3e}, grad norm "
        f"{first[0]['grad_norm']:.6f} vs {plain[0]['grad_norm']:.6f}; "
        + _diff_text(diffs, GRPO_STEP1_LIMITS, "diff"))
    if lse is not None:
        check_lse_probe(lse)
    for (what, _), control in zip(case.controls, controls):
        log(f"{label}: step 1 control (plain path {what}) margins to the "
            "limits (reading / limit, above 1 fails): " + ", ".join(
                f"{k} {control[k] / GRPO_STEP1_LIMITS[k]:.3f}"
                for k in GRPO_STEP1_LIMITS))
        if _within(control, GRPO_STEP1_LIMITS):
            raise AssertionError(f"the step-1 limits do not catch the "
                                 f"plain path {what}")
    if not _within(diffs, GRPO_STEP1_LIMITS):
        raise AssertionError("GRPO step 1 differs between kernel and plain "
                             "path")

    # --- the report -------------------------------------------------------
    late = slice(1, None) if steps > 1 else slice(None)

    def med(xs):
        return statistics.median(list(xs)[late])

    R = len(rewards)
    # patches: [n, patch_dim] (Qwen) or tiles [n, g*g, patch_dim] (LLaVA)
    n_patches = sum(p.shape[0] * (p.shape[1] if p.ndim == 3 else 1)
                    for ex in examples for p in ex.get("patches", ()))
    rollout_ms = med(1e3 * s for s in roll_s)
    decode_ms = med((1e3 * s - prefill_ms) / k
                    for s, k in zip(roll_s, roll_steps))
    tokens_s = med(t / s for t, s in zip(roll_tokens, roll_s))
    reward_ms = med(1e3 * sum(reward_s[i * R:(i + 1) * R])
                    for i in range(steps))
    update_ms, step_ms = med(1e3 * s for s in update_s), med(
        1e3 * s for s in step_s)
    if lora is not None:
        what = (f"{n_base / 1e9:.3f}B bf16 base (the reference) + "
                f"{n_params / 1e6:.2f}M LoRA adapters (rank "
                f"{lora.lora_rank}, alpha {lora.lora_alpha})")
    else:
        what = (f"{n_params / 1e9:.3f}B f32 policy + "
                f"{str(case.ref_dtype)[6:]} reference")
    log(f"{label}: {case.name} {what}, "
        f"{'dense' if dense else 'shared-prompt'} update, {steps} steps of "
        f"{n} prompts x G={G} (P={P}, N={N}, "
        f"{n_patches} patches), lr {case.opt_cfg.learning_rate} "
        f"{case.opt_cfg.schedule}; loss "
        f"{[float(format(m['loss'], '.3e')) for m in history]}, kl "
        f"{[float(format(m['kl'], '.3e')) for m in history]}, grad norm "
        f"{[round(m['grad_norm'], 5) for m in history]}, reward "
        f"{[round(m['reward'], 4) for m in history]}, decode steps "
        f"{roll_steps}")
    log(f"{label}: step {step_ms:.1f} ms (median of steps "
        f"{'2-' + str(steps) if steps > 2 else min(steps, 2)}; all steps "
        f"{[round(1e3 * x, 1) for x in step_s]} ms), "
        f"{1e3 * n * G / step_ms:.3f} rollouts/s; rollout {rollout_ms:.1f} "
        f"ms (prefill {prefill_ms:.2f} ms measured apart, decode "
        f"{decode_ms:.3f} ms/step at B={n * G}, {tokens_s:.1f} generated "
        f"tokens/s), rewards {reward_ms:.2f} ms on the host, update "
        f"{update_ms:.1f} ms, peak memory {peak_gib:.2f} GiB, launches per "
        f"step {per_step[-1]}, dense prefix-LM calls per step {dense_calls} "
        f"on {card}")
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
# the chain's model: the published widths, its depth cut to 2 of the 28
# decoder layers and 2 of the 32 tower blocks (cut for the smoke's
# time).  A run writes, per parameter, the bf16 base, two f32
# TrainStates (parameters + two AdamW moments) and two f32 exports, 34
# bytes: 75 GB at full depth, about 15 GB at this one, under
# CHAIN_WRITE_LIMIT
CHAIN_TEXT_LAYERS, CHAIN_TOWER_DEPTH = 2, 2
CHAIN_WRITE_BYTES_PER_PARAM = 2 + 2 * (12 + 4)
GIB = 2 ** 30
CHAIN_WRITE_LIMIT = 40 * GIB


TOKENIZER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_tokenizers")
_TOKENIZERS_WRITTEN: set = set()


def write_chain_tokenizer(path: str, vocab_size: int) -> None:
    """A tokenizer AutoTokenizer loads, with no vocabulary in the
    repository: one WordLevel entry per id of the head ("w<id>"), Qwen's
    specials at their published ids, so every id the head can draw
    decodes and the config's token ids stay the published ones.  Built
    once a run for each vocabulary size (phases 10, 32 and 33 share
    151936's) and copied to ``path``."""
    import shutil

    source = os.path.join(TOKENIZER_DIR, str(vocab_size))
    if vocab_size not in _TOKENIZERS_WRITTEN:
        shutil.rmtree(source, ignore_errors=True)
        _build_chain_tokenizer(source, vocab_size)
        _TOKENIZERS_WRITTEN.add(vocab_size)
    shutil.copytree(source, path, dirs_exist_ok=True)


def _build_chain_tokenizer(path: str, vocab_size: int) -> None:
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


def phase_chain(card, tools=None) -> dict:
    """Phase 10: the IAD-R1 chain at full Qwen2-VL-2B width through one
    call of the port's run_pipeline; returns the launch counts.  ``tools``
    (phase 36b) is called with the chain's directory, its SFT export and
    its data after the checks, before the directory is removed."""
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
        if tools is not None:
            tools(root, sft_export, data, card)
    finally:
        tap.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phases 11 and 12: LLaVA-OneVision-0.5B
# ---------------------------------------------------------------------------


def llava_positions(mask):
    """The rollout engine's 1-D positions of a left-padded batch."""
    return (mask.cumsum(dim=1) - 1).clamp(min=0)


def tower_depth(cfg) -> int:
    """The tower layers that run (one K1 call each): LLaVA-1.5/NeXT run
    the first ``tower_layers`` of CLIP's."""
    v = getattr(cfg, "vision", None)
    if v is None:                          # a text model
        return 0
    return (getattr(cfg, "tower_layers", None) or getattr(v, "depth", None)
            or v.num_hidden_layers)


def phase_vlm_serve(label, name, hf, encoded, prompt_len, patch_budget,
                    max_new_tokens, card, twin_apply, describe,
                    eos_pad=(IM_END, ENDOFTEXT), quant=None,
                    n_params_range=None, decoder_flash=True):
    """Phases 11 and 13: a VLM at full width (bf16 weights drawn on the
    card from a seed) serves 4 already-tokenized image requests through
    VLMGenerator._collate and RolloutEngine.generate, greedy.  K1 must run
    once per tower and decoder layer a generate and K4 once per decoder
    layer a decode step, no plain twin may be called, and the kernel
    path's prefill logits must agree with the twin path's
    (``twin_apply(params, cfg, batch, cache, attn)`` -> hidden).
    ``describe(batch)`` checks the collated vision arrays and says what
    they hold; ``eos_pad`` the tokenizer's end and padding ids; ``quant``
    a weight-only format the bf16 weights are quantized to on the card
    first, as the infer CLI's ``--quant`` does; ``n_params_range`` the
    (low, high) the parameter count must fall in (a published count);
    ``decoder_flash`` False: a prefix-LM decoder (PaliGemma), whose
    prefill is one dense call a layer and no K1.  Returns the launch
    counts."""
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels import decode_attention as decode_mod
    from iadr1_tpu_torch.kernels import flash_attention as flash_mod
    from iadr1_tpu_torch.models import qwen2
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    bundle = bundle_from_hf_config(hf)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: {name} {n_params / 1e9:.3f}B params (bf16, seeded) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    if n_params_range and not (n_params_range[0] < n_params
                               < n_params_range[1]):
        raise AssertionError(f"{name} has {n_params / 1e9:.3f}B params, "
                             f"not in {n_params_range}")
    if quant is not None:
        from iadr1_tpu_torch.models.quant import (
            quantize_tree,
            quantized_bytes,
        )

        t0 = time.perf_counter()
        params = quantize_tree(params, fmt=quant)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        now, bf16 = quantized_bytes(params)
        log(f"{label}: quantized to {quant} on the card in "
            f"{time.perf_counter() - t0:.1f} s: {now / 2 ** 30:.2f} GiB, "
            f"{now / bf16:.4f} of bf16's {bf16 / 2 ** 30:.2f} GiB "
            f"(quantized_bytes)")
    tokenizer = types.SimpleNamespace(eos_token_id=eos_pad[0],
                                      pad_token_id=eos_pad[1])
    gcfg = GeneratorConfig(max_prompt_length=prompt_len,
                           max_new_tokens=max_new_tokens, batch_size=BATCH,
                           patch_budget=patch_budget)
    gen = VLMGenerator(bundle, params, tokenizer,
                       get_template(bundle.template), gcfg, device=DEVICE)
    t0 = time.perf_counter()
    batch = gen._collate(encoded)
    collate_ms = 1e3 * (time.perf_counter() - t0)
    holds = describe(batch)

    def prefill(attn=None):
        cache = qwen2.init_cache(cfg.text, BATCH, prompt_len, torch.bfloat16,
                                 DEVICE)
        b = {**batch, "segment_ids": batch["attention_mask"].to(torch.int32)}
        if "position_ids" not in b:          # 1-D positions, as the engine's
            b["position_ids"] = llava_positions(batch["attention_mask"])
        with torch.no_grad():
            if attn is None:
                h, _ = bundle.apply(params, b, cache=cache,
                                    cache_mode="prefill")
            else:
                h = twin_apply(params, cfg, b, cache, attn)
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
    log(f"{label}: prefill logits kernel vs twin path: rel L2 {rel:.3e} "
        f"(limit {LOGITS_REL_L2}), argmax agree {agree}/{BATCH}")
    if not rel <= LOGITS_REL_L2:
        raise AssertionError(f"prefill logits differ: rel L2 {rel:.3e}")
    del kernel_logits, twin_logits
    prefill_ms = time_prefill(gen, batch)

    kernels = [k for k, _ in all_kernels()]
    tap = ChainTap(kernels)
    for module, fn_name in ((flash_mod, "flash_attention_ref"),
                            (flash_mod, "flash_attention_bwd_ref"),
                            (decode_mod, "decode_attention_ref")):
        tap.twin(module, fn_name)
    for k in kernels:
        k.launches = 0
    dense = PrefixLmTap()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = gen.engine.generate(params, batch, gen.generator)
        torch.cuda.synchronize()
    finally:
        tap.close()
        dense.close()
    total_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k.name: k.launches for k in kernels}
    steps = result["num_decode_steps"]
    ids = result["completion_ids"]
    if ids.shape != (BATCH, max_new_tokens):
        raise AssertionError(f"completion shape {tuple(ids.shape)}")
    if not ((ids >= 0) & (ids < cfg.text.vocab_size)).all():
        raise AssertionError("completion ids out of the vocabulary")
    L, Lt = cfg.text.num_hidden_layers, tower_depth(cfg)
    want = {"flash_fwd": Lt + (L if decoder_flash else 0), "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "decode_attention": L * steps}
    if launches != want or steps < 1:
        raise AssertionError(f"{label}: launches {launches} over {steps} "
                             f"decode steps, want {want}")
    # the prefix-LM prefill: one dense call a decoder layer
    if dense.calls != (0 if decoder_flash else L):
        raise AssertionError(f"{label}: {dense.calls} dense prefix-LM "
                             "calls")
    if any(tap.twin_calls.values()):
        raise AssertionError(f"{label}: plain twins called on the card: "
                             f"{tap.twin_calls}")
    n_tokens = int(result["completion_mask"].sum())
    decode_ms = (1e3 * total_s - prefill_ms) / steps
    log(f"{label}: generate {BATCH} requests ({holds}, prompt {prompt_len}, "
        f"patch budget {patch_budget}), {steps} decode steps, {n_tokens} "
        f"tokens in {total_s:.3f} s; launches {launches}; dense prefix-LM "
        f"calls {dense.calls}; twin calls {tap.twin_calls}")
    log(f"{label}: collation {collate_ms:.2f} ms (host), prefill "
        f"{prefill_ms:.2f} ms (tower + decoder), decode {decode_ms:.3f} "
        f"ms/step, {n_tokens / total_s:.1f} generated tokens/s, "
        f"{BATCH / total_s:.3f} items/s, peak memory {peak_gib:.2f} GiB on "
        f"{card}")
    phase_profile(label, gen, batch)
    del gen, batch, params
    torch.cuda.empty_cache()
    return launches


def phase_llava_serve(encoded, max_new_tokens, card):
    """Phase 11: LLaVA-OneVision-0.5B at full width serves 4 image requests
    (16 anyres tiles in a budget of 22); returns the launch counts."""
    from iadr1_tpu_torch.models import llava_onevision

    def twin_apply(params, cfg, b, cache, attn):
        h, _ = llava_onevision.apply(
            params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
            tile_segments=b["tile_segments"], pack_src=b["pack_src"],
            pack_weights=b["pack_weights"], newline_mask=b["newline_mask"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], cache=cache, cache_mode="prefill",
            attention_fn=attn, tower_attention_fn=attn)
        return h

    def describe(batch):
        n_tiles = int(batch["tile_segments"].sum())
        if batch["tiles"].shape[0] != 22 or n_tiles != 16:
            raise AssertionError(f"tiles {tuple(batch['tiles'].shape)}, "
                                 f"{n_tiles} of them images'")
        return "16 tiles"

    return phase_vlm_serve("llava serve", "LLaVA-OneVision-0.5B",
                           LLAVA_OV_05B, encoded, LLAVA_PROMPT_LEN,
                           LLAVA_PATCH_BUDGET, max_new_tokens, card,
                           twin_apply, describe)


def q25_twin_tower(params, cfg, b, attn, remat=False):
    """The Qwen2.5-VL tower of a batch over ``attn``."""
    from iadr1_tpu_torch.models import qwen25_vl

    return qwen25_vl.apply_vision(
        params["vision"], cfg.vision, b["patches"], b["rot_cos"],
        b["rot_sin"], b["full_segs"], b["window_segs"], attention_fn=attn,
        remat=remat)


def phase_q25_serve(encoded, max_new_tokens, card):
    """Phase 13: Qwen2.5-VL-7B at full width and depth serves 4 image
    requests (window-ordered tower stream); returns the launch counts."""
    from iadr1_tpu_torch.models import qwen25_vl

    def twin_apply(params, cfg, b, cache, attn):
        h, _ = qwen25_vl.apply(
            params, cfg, b["input_ids"], b["position_ids"],
            patches=b["patches"], rot_cos=b["rot_cos"], rot_sin=b["rot_sin"],
            full_segs=b["full_segs"], window_segs=b["window_segs"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], cache=cache, cache_mode="prefill",
            attention_fn=attn, vision_attention_fn=attn)
        return h

    def describe(batch):
        n = int((batch["full_segs"] != 0).sum())
        windows = int(batch["window_segs"].max())
        want = sum(h * w // 196 for h, w in Q25_IMAGE_HW)
        if n != want or batch["patches"].shape[0] != PATCH_BUDGET:
            raise AssertionError(f"{n} image patches, want {want}")
        return f"{n} patches in {windows} windows"

    return phase_vlm_serve("q25 serve", "Qwen2.5-VL-7B", QWEN2_5_VL_7B,
                           encoded, PROMPT_LEN, PATCH_BUDGET, max_new_tokens,
                           card, twin_apply, describe)


def phase_quant_serve(encoded, max_new_tokens, card, quant, layers=None):
    """Phase 22b and 22c: Qwen2.5-VL-7B at full width (and depth, unless
    ``layers`` cuts its decoder) serves phase 13's 4 requests over weights
    quantized to ``quant`` (int8: the infer and serve CLIs' ``--quant
    int8``; nf4: a generate to show it runs); returns the launch
    counts."""
    from iadr1_tpu_torch.models import qwen25_vl

    def twin_apply(params, cfg, b, cache, attn):
        h, _ = qwen25_vl.apply(
            params, cfg, b["input_ids"], b["position_ids"],
            patches=b["patches"], rot_cos=b["rot_cos"], rot_sin=b["rot_sin"],
            full_segs=b["full_segs"], window_segs=b["window_segs"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], cache=cache, cache_mode="prefill",
            attention_fn=attn, vision_attention_fn=attn)
        return h

    def describe(batch):
        n = int((batch["full_segs"] != 0).sum())
        return f"{n} patches in {int(batch['window_segs'].max())} windows"

    hf, name = QWEN2_5_VL_7B, "Qwen2.5-VL-7B"
    if layers is not None:
        hf = dict(hf, num_hidden_layers=layers)
        name += f" cut to {layers} decoder layers"
    return phase_vlm_serve(f"q25 {quant} serve", name, hf, encoded,
                           PROMPT_LEN, PATCH_BUDGET, max_new_tokens, card,
                           twin_apply, describe, quant=quant)


def phase_vlm_sft(label, name, hf, recipe, rows, steps, card, train_dir,
                  plain_apply, tower_flops, batch_rows=None, overrides=(),
                  decoder_flash=True):
    """Phases 12 and 14: PA-SFT steps of a VLM at full width on a recipe's
    settings (``recipe`` through the port's config loader), assembled as
    cli/train_sft.py assembles them, f32 parameters drawn on the card;
    ``batch_rows`` cuts the recipe's batch.  K1, K2 and K3 must run once
    per decoder and tower layer a step, step 1 must agree with a step
    through the plain versions (``plain_apply(params, cfg, batch, attn,
    remat, tower_remat)`` -> hidden), a control with dq zeroed must not,
    and the loss must fall.  ``tower_flops(batch)`` -> (the tower's
    forward FLOPs, what it ran over); ``overrides`` change the recipe's
    keys as a command line would; ``decoder_flash`` False: a prefix-LM
    decoder (PaliGemma), one dense call a layer a step and no K1-K3.
    Returns the launch counts."""
    import gc

    from iadr1_tpu_torch.cli.train_sft import SFTJobConfig, _remat
    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.core.metrics import (
        ThroughputMeter,
        transformer_flops_per_token,
    )
    from iadr1_tpu_torch.data.collator import VLMBatchBuilder
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import STEP_RANGES, make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    job = load_config(SFTJobConfig, recipe, list(overrides))
    bundle = bundle_from_hf_config(hf, attention=job.model.attention)
    cfg = bundle.cfg
    recipe_rows = int(job.train["batch_size"])
    B, T = batch_rows or recipe_rows, job.data.cutoff_len
    remat, tower_remat = _remat(job.model.remat), _remat(job.model.tower_remat)
    tower_kw = ({} if tower_remat == "default"
                else {"tower_remat": tower_remat})
    # the recipe's schedule over this run: cosine to 0 over its steps, its
    # warmup (100 of 1000 steps) a tenth of them, none of 4
    opt_cfg = dataclasses.replace(
        dataclass_from_dict(OptimizerConfig, job.optim), total_steps=steps,
        warmup_steps=steps // 10)
    logits_dtype = getattr(torch, job.data.ce_logits_dtype)
    builder = VLMBatchBuilder(bundle, job.data.patch_budget)
    if len(rows) != B or any(len(r["input_ids"]) != T for r in rows):
        raise AssertionError(f"the rows are not {B} x {T}")
    log(f"{label}: the recipe: B={B}"
        + (f" (the recipe's {recipe_rows} rows cut to {B})"
           if B != recipe_rows else "")
        + f" T={T}" + (f" ({', '.join(overrides)})" if overrides else "")
        + f", remat {remat}, tower remat {tower_remat}, CE chunk "
        f"{job.data.ce_chunk} in {job.data.ce_logits_dtype}, patch budget "
        f"{job.data.patch_budget}, AdamW lr {opt_cfg.learning_rate} "
        f"{opt_cfg.schedule} (weight decay {opt_cfg.weight_decay}, clip "
        f"{opt_cfg.max_grad_norm}, first moment {opt_cfg.mu_dtype}); f32 "
        f"parameters (the recipe's own dtype is {job.model.dtype})")

    def fresh(hidden_fn):
        params = bundle.init_params(seed=0, dtype=torch.float32,
                                    device=DEVICE)
        opt, sched = make_optimizer(opt_cfg)
        probe = GradProbe(opt, params)
        step = make_chunked_sft_step(hidden_fn, bundle.head_kernel_fn, probe,
                                     sched, chunk_size=job.data.ce_chunk,
                                     logits_dtype=logits_dtype)
        return create_train_state(params, probe), step, probe

    first = next(batch_iterator(rows, B, 0, builder))

    def first_step(flash):
        attn = train_attn(flash)
        state, plain_step, probe = fresh(lambda p, b: plain_apply(
            p, cfg, b, attn, remat, tower_kw.get("tower_remat")))
        _, m = plain_step(state, first)
        res = {k: float(v) for k, v in m.items()}, probe.norms
        del state, plain_step, probe, m
        gc.collect()
        torch.cuda.empty_cache()
        return res

    plain_ref = first_step(TwinFlash)
    control = step1_diffs(first_step(ZeroDqFlash), plain_ref)
    log(f"{label}: step 1 control (plain path with dq zeroed) vs plain "
        f"path: {_diff_text(control)}")
    if _within(control):
        raise AssertionError("the step-1 limits do not catch a zeroed dq")

    state, step, probe = fresh(lambda p, b: bundle.hidden_fn(
        p, b, remat=remat, **tower_kw))
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
    dense = PrefixLmTap()
    try:
        state, history = run_sft_loop(
            state, timed_step, batch_iterator(rows, B, 0, builder),
            LoopConfig(output_dir=train_dir, max_steps=steps, batch_size=B,
                       logging_steps=1))
    finally:
        dense.close()
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, first)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(f"profile: one {name} training step: ", prof, wall_ms,
                top_n=10, ranges=STEP_RANGES)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    L, Lt = cfg.text.num_hidden_layers, tower_depth(cfg)
    # per step: each of K1, K2 and K3 once per decoder layer and tower
    # layer (the recipes' remat modes keep every attention call outside
    # the checkpoints); a prefix-LM decoder's layers take one dense call
    # each a step instead (its backward replays it inside a checkpoint)
    Lf = L if decoder_flash else 0
    want = {"flash_fwd": steps * (Lf + Lt), "flash_bwd_dq": steps * (Lf + Lt),
            "flash_bwd_dkv": steps * (Lf + Lt), "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, want {want}")
    if dense.calls != steps * (L - Lf):
        raise AssertionError(f"{label}: {dense.calls} dense prefix-LM calls")
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    diffs = step1_diffs(({"loss": losses[0], "grad_norm": norms[0]},
                         probe.norms), plain_ref)
    log(f"{label}: step 1 kernel vs plain path: loss {losses[0]:.6f} vs "
        f"{plain_ref[0]['loss']:.6f}, grad norm {norms[0]:.6f} vs "
        f"{plain_ref[0]['grad_norm']:.6f}; {_diff_text(diffs)}")
    if not _within(diffs):
        raise AssertionError("step 1 differs between kernel and plain path")

    late = len(times) > 4
    step_s = statistics.median(times[3:] if late else times[1:])
    n_label = history[0]["n_label_tokens"]
    t = cfg.text
    dec_flops = B * T * transformer_flops_per_token(
        hidden=t.hidden_size, intermediate=t.intermediate_size,
        num_layers=t.num_hidden_layers, vocab=t.vocab_size, seq_len=T,
        num_heads=t.num_attention_heads, num_kv_heads=t.num_key_value_heads)
    vit_flops, ran_over = tower_flops(first)
    meter = ThroughputMeter(flops_per_token_fwd=(dec_flops + vit_flops)
                            / (B * T), peak_flops=PEAK_BF16_FLOPS)
    meter.update(B * T, step_s)
    log(f"{label}: {name} {n_params / 1e9:.3f}B f32 params, {steps} steps "
        f"of {B}x{T} tokens ({int(n_label)} label tokens, {ran_over}); "
        f"losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"{label}: step {1e3 * step_s:.1f} ms (median of steps "
        f"{'4-' if late else '2-'}{steps}; all steps "
        f"{[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, {n_label / step_s:.0f} label "
        f"tokens/s, MFU {meter.mfu:.4f} (decoder + tower model FLOPs, x3, "
        f"against {PEAK_BF16_FLOPS:.3g}), peak memory {peak_gib:.2f} GiB, "
        f"launches {launches}, dense prefix-LM calls {dense.calls} on {card}")
    return launches


def phase_llava_sft(rows, steps: int, card):
    """Phase 12: LLaVA-OneVision-0.5B PA-SFT (the decoder cut to
    OV_SFT_LAYERS layers, the tower whole) on
    configs/sft_llava_onevision_0_5b.yaml; returns the launch counts."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch
    from iadr1_tpu_torch.models import llava_onevision

    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        h, _ = llava_onevision.apply(
            params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
            tile_segments=b["tile_segments"], pack_src=b["pack_src"],
            pack_weights=b["pack_weights"], newline_mask=b["newline_mask"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], attention_fn=attn,
            tower_attention_fn=attn, remat=remat, tower_remat=tower_remat)
        return h

    def tower_flops(first):
        # model FLOPs count the tiles that hold images, not the zero
        # padding that fills the budget
        n_tiles = first["tiles"].shape[0]        # the tower runs the budget
        n_images = int(first["tile_segments"].sum())
        v = LLAVA_OV_05B["vision_config"]
        flops = n_images * 729 * vit_flops_per_patch(
            hidden=v["hidden_size"], intermediate=v["intermediate_size"],
            num_layers=v["num_hidden_layers"], attn_window=729)
        return flops, f"4 images in {n_images} of the {n_tiles} tiles"

    cut = dict(LLAVA_OV_05B, text_config=dict(
        LLAVA_OV_05B["text_config"], num_hidden_layers=OV_SFT_LAYERS))
    return phase_vlm_sft("llava sft", f"LLaVA-OneVision-0.5B cut to "
                         f"{OV_SFT_LAYERS} decoder layers", cut,
                         LLAVA_RECIPE, rows, steps, card, LLAVA_TRAIN_DIR,
                         plain_apply, tower_flops)


def q25_tower_flops(grids):
    """The Qwen2.5-VL tower's forward FLOPs over the patches of ``grids``
    (SwiGLU's three matmuls; the window blocks attend within their
    windows, the full blocks within their images), and what it ran
    over."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch
    from iadr1_tpu_torch.models.qwen25_vl import (
        Qwen25VLVisionConfig,
        window_partition,
    )

    v = QWEN2_5_VL_3B["vision_config"]
    vcfg = Qwen25VLVisionConfig()
    n = [int(np.prod(g)) for g in grids]
    _, wsegs, _ = window_partition(np.asarray(grids), vcfg)
    w = np.bincount(wsegs)[1:]
    full = len(v["fullatt_block_indexes"])
    window_keys = (v["depth"] - full) * float((w ** 2).sum()) / sum(n)
    image_keys = full * sum(x * x for x in n) / sum(n)
    flops = sum(n) * vit_flops_per_patch(
        hidden=v["hidden_size"], intermediate=3 * v["intermediate_size"] // 2,
        num_layers=v["depth"],
        attn_window=(window_keys + image_keys) / v["depth"])
    return flops, f"{len(n)} images, {sum(n)} patches in {len(w)} windows"


def phase_q25_sft(rows, steps: int, card):
    """Phase 14: Qwen2.5-VL-3B PA-SFT at full width, the decoder cut to
    SFT_DECODER_LAYERS layers (the tower whole), on
    configs/sft_qwen2_5_vl_7b.yaml, the batch cut to Q25_SFT_ROWS rows;
    returns the launch counts."""
    from iadr1_tpu_torch.models import qwen25_vl

    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        h, _ = qwen25_vl.apply(
            params, cfg, b["input_ids"], b["position_ids"],
            patches=b["patches"], rot_cos=b["rot_cos"], rot_sin=b["rot_sin"],
            full_segs=b["full_segs"], window_segs=b["window_segs"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], attention_fn=attn,
            vision_attention_fn=attn, remat=remat, tower_remat=tower_remat)
        return h

    grids = [g for r in rows for e in r["extras"] for g in e["grid_thw"]]
    cut = dict(QWEN2_5_VL_3B, num_hidden_layers=SFT_DECODER_LAYERS)
    return phase_vlm_sft("q25 sft", f"Qwen2.5-VL-3B cut to "
                         f"{SFT_DECODER_LAYERS} decoder layers", cut,
                         Q25_SFT_RECIPE, rows, steps, card, Q25_TRAIN_DIR,
                         plain_apply, lambda first: q25_tower_flops(grids),
                         batch_rows=Q25_SFT_ROWS)


def llava_twin_apply(params, cfg, b, cache, attn):
    """A LLaVA-1.5/NeXT prefill over ``attn`` (tower and decoder)."""
    from iadr1_tpu_torch.models import llava

    h, _ = llava.apply(
        params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
        tile_segments=b["tile_segments"], pack_src=b.get("pack_src"),
        pack_weights=b.get("pack_weights"),
        newline_mask=b.get("newline_mask"), scatter_rows=b["scatter_rows"],
        scatter_cols=b["scatter_cols"], segment_ids=b["segment_ids"],
        cache=cache, cache_mode="prefill", attention_fn=attn,
        tower_attention_fn=attn)
    return h


def llava_serve_cut(hf: dict) -> dict:
    """A LLaVA config with its decoder cut to LLAVA_SERVE_LAYERS."""
    return dict(hf, text_config=dict(hf["text_config"],
                                     num_hidden_layers=LLAVA_SERVE_LAYERS))


def phase_next_serve(encoded, feature_lens, max_new_tokens, card):
    """Phase 17: LLaVA-NeXT-8B at full width, its decoder cut to
    LLAVA_SERVE_LAYERS, serves 4 image requests (16 anyres tiles, the
    patch budget's 16); returns the launch counts."""
    def describe(batch):
        n_tiles = int(batch["tile_segments"].sum())
        if batch["tiles"].shape[0] != 16 or n_tiles != 16:
            raise AssertionError(f"tiles {tuple(batch['tiles'].shape)}, "
                                 f"{n_tiles} of them images'")
        return f"16 tiles, image features {feature_lens}"

    return phase_vlm_serve("llava16 serve", f"LLaVA-NeXT-8B cut to "
                           f"{LLAVA_SERVE_LAYERS} decoder layers",
                           llava_serve_cut(LLAVA_NEXT_8B),
                           encoded, NEXT_PROMPT_LEN, NEXT_PATCH_BUDGET,
                           max_new_tokens, card, llava_twin_apply, describe,
                           eos_pad=(LLAMA3_EOT, LLAMA3_END))


def phase_v15_serve(encoded, max_new_tokens, card):
    """Phase 18: LLaVA-1.5-7B at full width, its decoder cut to
    LLAVA_SERVE_LAYERS, serves 4 image requests (one center-cropped tile
    each); returns the launch counts."""
    def describe(batch):
        n_tiles = int(batch["tile_segments"].sum())
        if batch["tiles"].shape[0] != 4 or n_tiles != 4:
            raise AssertionError(f"tiles {tuple(batch['tiles'].shape)}")
        return "4 tiles of 576 features"

    return phase_vlm_serve("llava15 serve", f"LLaVA-1.5-7B cut to "
                           f"{LLAVA_SERVE_LAYERS} decoder layers",
                           llava_serve_cut(LLAVA_15_7B),
                           encoded, V15_PROMPT_LEN, V15_PATCH_BUDGET,
                           max_new_tokens, card, llava_twin_apply, describe,
                           eos_pad=(VICUNA_EOS, VICUNA_PAD))


def phase_next_sft(rows, steps: int, card):
    """Phase 19: LLaVA-NeXT PA-SFT at full width, the decoder cut to
    NEXT_SFT_LAYERS layers, on configs/sft_llava_onevision_0_5b.yaml's
    settings with rows of NEXT_SFT_CUTOFF; returns the launch counts."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch
    from iadr1_tpu_torch.models import llava

    hf = dict(LLAVA_NEXT_8B, text_config=dict(
        LLAVA_NEXT_8B["text_config"], num_hidden_layers=NEXT_SFT_LAYERS))

    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        h, _ = llava.apply(
            params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
            tile_segments=b["tile_segments"], pack_src=b["pack_src"],
            pack_weights=b["pack_weights"], newline_mask=b["newline_mask"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], attention_fn=attn,
            tower_attention_fn=attn, remat=remat, tower_remat=tower_remat)
        return h

    def tower_flops(first):
        # model FLOPs count the tiles that hold images, over the 23
        # layers that run; the padding tiles' attention is skipped, their
        # projections and MLPs are not
        n_tiles = first["tiles"].shape[0]
        n_images = int(first["tile_segments"].sum())
        v = LLAVA_NEXT_8B["vision_config"]
        flops = n_images * 577 * vit_flops_per_patch(
            hidden=v["hidden_size"], intermediate=v["intermediate_size"],
            num_layers=v["num_hidden_layers"] - 1, attn_window=577)
        return flops, (f"4 images in {n_images} of the {n_tiles} tiles, "
                       "the rest at segment 0")

    return phase_vlm_sft(
        "llava16 sft", f"LLaVA-NeXT-8B cut to {NEXT_SFT_LAYERS} decoder "
        "layers", hf, LLAVA_RECIPE, rows, steps, card, NEXT_TRAIN_DIR,
        plain_apply, tower_flops, batch_rows=NEXT_SFT_ROWS,
        overrides=[f"data.cutoff_len={NEXT_SFT_CUTOFF}",
                   "data.template=llava_next_llama3"])


# ---------------------------------------------------------------------------
# phases 23-25: InternVL-2.5-4B
# ---------------------------------------------------------------------------


def internvl_plain_apply(params, cfg, b, attn, remat=False, tower_remat=None,
                         cache=None):
    """An InternVL forward over ``attn`` (tower and decoder)."""
    from iadr1_tpu_torch.models import internvl

    h, _ = internvl.apply(
        params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
        tile_segments=b["tile_segments"], scatter_rows=b["scatter_rows"],
        scatter_cols=b["scatter_cols"], segment_ids=b["segment_ids"],
        cache=cache, cache_mode="prefill" if cache is not None else "extend",
        attention_fn=attn, tower_attention_fn=attn, remat=remat,
        tower_remat=tower_remat)
    return h


def phase_internvl_serve(encoded, max_new_tokens, card):
    """Phase 23: InternVL-2.5-4B at full width and depth serves 4 intern_vl
    requests (22 tiles in a budget of 24, 2 at segment 0); its parameter
    count must be the model card's 3.7 B (3.714 B with the untied head;
    a tied one would make it 3.404 B); returns the launch counts."""
    def twin_apply(params, cfg, b, cache, attn):
        return internvl_plain_apply(params, cfg, b, attn, cache=cache)

    def describe(batch):
        n_tiles = int(batch["tile_segments"].sum())
        if batch["tiles"].shape[0] != 24 or n_tiles != 22:
            raise AssertionError(f"tiles {tuple(batch['tiles'].shape)}, "
                                 f"{n_tiles} of them images'")
        return (f"22 tiles of 1025 tokens in a budget of 24, "
                f"{int((batch['scatter_rows'] < BATCH).sum())} features")

    return phase_vlm_serve("internvl serve", "InternVL-2.5-4B",
                           INTERNVL_25_4B, encoded, INTERNVL_PROMPT_LEN,
                           INTERNVL_PATCH_BUDGET, max_new_tokens, card,
                           twin_apply, describe,
                           n_params_range=(3.65e9, 3.75e9))


def internvit_flops(n_tiles: int) -> float:
    """The InternViT tower's forward FLOPs over ``n_tiles`` tiles."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch

    v = INTERNVL_25_4B["vision_config"]
    return n_tiles * 1025 * vit_flops_per_patch(
        hidden=v["hidden_size"], intermediate=v["intermediate_size"],
        num_layers=v["num_hidden_layers"], attn_window=1025)


def phase_internvl_sft(rows, steps: int, card):
    """Phase 24: InternVL-2.5-4B PA-SFT at full width (the decoder cut to
    SFT_DECODER_LAYERS layers, the tower whole) on
    configs/sft_qwen2_5_vl_7b.yaml's settings with the intern_vl template,
    the batch cut to INTERNVL_SFT_ROWS rows and the patch budget grown to
    INTERNVL_SFT_BUDGET; returns the launch counts."""
    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        return internvl_plain_apply(params, cfg, b, attn, remat, tower_remat)

    def tower_flops(first):
        # model FLOPs count the tiles that hold images, not the padding
        n_tiles = first["tiles"].shape[0]
        n_images = int(first["tile_segments"].sum())
        return internvit_flops(n_images), (
            f"{len(rows)} images in {n_images} of the {n_tiles} tiles, the "
            "rest at segment 0")

    cut = dict(INTERNVL_25_4B, text_config=dict(
        INTERNVL_25_4B["text_config"], num_hidden_layers=SFT_DECODER_LAYERS))
    return phase_vlm_sft(
        "internvl sft", f"InternVL-2.5-4B cut to {SFT_DECODER_LAYERS} "
        "decoder layers", cut, Q25_SFT_RECIPE,
        rows, steps, card, INTERNVL_TRAIN_DIR, plain_apply, tower_flops,
        batch_rows=INTERNVL_SFT_ROWS,
        overrides=["data.template=intern_vl",
                   f"data.patch_budget={INTERNVL_SFT_BUDGET}"])


def grpo_case_internvl(steps: int) -> types.SimpleNamespace:
    """Phase 25's setting: InternVL-2.5-4B on the grpo section of
    configs/grpo_qwen2_5_vl_7b.yaml (phase 15's), its decoder cut to
    INTERNVL_GRPO_LAYERS, the patch budget sized for 1025-token tiles
    (INTERNVL_GRPO_PATCH_BUDGET); the update batch must carry the tiles
    and their segments (C.R9)."""
    from iadr1_tpu_torch.models import internvl

    def embeds(params, cfg, batch, attn, remat):
        return internvl.compute_embeds(
            params, cfg, batch["prompt_ids"], tiles=batch["tiles"],
            tile_segments=batch["tile_segments"],
            scatter_rows=batch["scatter_rows"],
            scatter_cols=batch["scatter_cols"], tower_attention_fn=attn,
            tower_remat=remat)

    hf = dict(INTERNVL_25_4B, text_config=dict(
        INTERNVL_25_4B["text_config"], num_hidden_layers=INTERNVL_GRPO_LAYERS))
    case = grpo_case_q25(steps, "internvl grpo", "InternVL-2.5-4B cut to "
                         f"{INTERNVL_GRPO_LAYERS} decoder layers", hf)
    case.data = dataclasses.replace(case.data,
                                    patch_budget=INTERNVL_GRPO_PATCH_BUDGET)
    case.embeds = embeds
    case.vision_keys = ("tiles", "tile_segments")
    return case


# ---------------------------------------------------------------------------
# phase 26: videos
# ---------------------------------------------------------------------------


def phase_video_sft(rows, steps: int, card):
    """Phase 26a: Qwen2-VL-2B PA-SFT at full width (the decoder cut to
    VIDEO_SFT_LAYERS layers, the tower whole) on
    configs/sft_qwen2_5_vl_7b.yaml's settings (the qwen2_vl template, the
    tower's remat save_acts so its attention stays outside the
    checkpoints), 2 rows of one 8-frame video each through VLMBatchBuilder;
    returns the launch counts."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch
    from iadr1_tpu_torch.models import qwen2_vl

    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        h, _ = qwen2_vl.apply(
            params, cfg, b["input_ids"], b["position_ids"],
            patches=b["patches"], rot_cos=b["rot_cos"], rot_sin=b["rot_sin"],
            vision_segments=b["vision_segments"],
            scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
            segment_ids=b["segment_ids"], attention_fn=attn,
            vision_attention_fn=attn, remat=remat, tower_remat=tower_remat)
        return h

    def tower_flops(first):
        segs = first["vision_segments"]
        n = int((segs != 0).sum())
        per = int(np.bincount(segs[segs != 0]).max())
        v = QWEN2_VL_2B["vision_config"]
        return n * vit_flops_per_patch(
            hidden=v["embed_dim"], intermediate=4 * v["embed_dim"],
            num_layers=v["depth"], attn_window=per), (
            f"{len(rows)} videos of {VIDEO_FRAMES} frames, {n} patches, "
            f"{int(segs.max())} temporal patches of {per}")

    if not all((r["input_ids"] == VIDEO_PAD).any() for r in rows):
        raise AssertionError("a row holds no video")
    cut = dict(QWEN2_VL_2B, text_config=dict(
        QWEN2_VL_2B["text_config"], num_hidden_layers=VIDEO_SFT_LAYERS))
    return phase_vlm_sft(
        "q2vl video sft", f"Qwen2-VL-2B cut to {VIDEO_SFT_LAYERS} decoder "
        "layers", cut, Q25_SFT_RECIPE, rows,
        steps, card, VIDEO_TRAIN_DIR, plain_apply, tower_flops,
        batch_rows=VIDEO_SFT_ROWS,
        overrides=["data.template=qwen2_vl", "model.tower_remat=save_acts"])


def phase_video_rollout(label, name, hf, examples, prompt_len, card):
    """Phases 26b and 26c: a LLaVA video family at full width (bf16
    weights drawn on the card from a seed) takes a greedy rollout of
    ``examples`` (video prompts) collated by cli/train_grpo.py's prompt
    collator (G = 1) and run by RolloutEngine: K1 once per layer of the
    image tower (over the budget's zero tiles, all at segment 0), of the
    video tower (over the frames) and of the decoder, K4 once per decoder
    layer a decode step, no plain twin called; the kernel path's prefill
    logits must agree with the twin path's.  Returns the launch counts."""
    from iadr1_tpu_torch.cli.train_grpo import (
        GRPODataSection,
        make_vlm_prompt_collator,
    )
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels import decode_attention as decode_mod
    from iadr1_tpu_torch.kernels import flash_attention as flash_mod
    from iadr1_tpu_torch.models import qwen2
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
    from iadr1_tpu_torch.train.sft import batch_to_device

    bundle = bundle_from_hf_config(hf)
    cfg = bundle.cfg
    g = cfg.vision.grid
    n_frames = sum(p.shape[0] for ex in examples
                   for p in ex["video_patches"])
    budget = n_frames * g * g
    t0 = time.perf_counter()
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: {name} {n_params / 1e9:.3f}B params (bf16, seeded) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    # the video checkpoints' tokenizers hold <image> and <video> at 32000
    # and 32001, and pad with <unk> (0), which the collator replaces by EOS
    tok = types.SimpleNamespace(eos_token_id=VICUNA_EOS, pad_token_id=0)
    collate = make_vlm_prompt_collator(
        bundle, tok, None, GRPODataSection(patch_budget=budget), prompt_len,
        num_generations=1)
    t0 = time.perf_counter()
    batch = batch_to_device(collate(examples, 1), DEVICE)
    collate_ms = 1e3 * (time.perf_counter() - t0)
    B = len(examples)
    if (int(batch["video_tile_segments"].sum()) != n_frames
            or int(batch["tile_segments"].sum()) != 0):
        raise AssertionError("the frame stream is not the videos' frames")
    n_feats = int((batch["video_scatter_rows"] < B).sum())

    def prefill(attn=None):
        from iadr1_tpu_torch.models import llava

        cache = qwen2.init_cache(cfg.text, B, prompt_len, torch.bfloat16,
                                 DEVICE)
        b = {**batch, "segment_ids": batch["attention_mask"].to(torch.int32),
             "position_ids": llava_positions(batch["attention_mask"])}
        with torch.no_grad():
            if attn is None:
                h, _ = bundle.apply(params, b, cache=cache,
                                    cache_mode="prefill")
            else:
                h, _ = llava.apply(
                    params, cfg, b["input_ids"], b["position_ids"],
                    **{k: b[k] for k in (
                        "tiles", "tile_segments", "pack_src", "pack_weights",
                        "newline_mask", "scatter_rows", "scatter_cols",
                        "video_tiles", "video_tile_segments",
                        "video_scatter_rows", "video_scatter_cols")
                       if k in b},
                    segment_ids=b["segment_ids"], cache=cache,
                    cache_mode="prefill", attention_fn=attn,
                    tower_attention_fn=attn)
            return bundle.logits_fn(params, h[:, -1:])[:, 0]

    kernel_logits, twin_logits = prefill(), prefill(twin_attn)
    torch.cuda.synchronize()
    if not torch.isfinite(kernel_logits).all():
        raise AssertionError("prefill logits are not finite")
    rel = float((kernel_logits - twin_logits).norm() / twin_logits.norm())
    log(f"{label}: prefill logits kernel vs twin path: rel L2 {rel:.3e} "
        f"(limit {LOGITS_REL_L2}), argmax agree "
        f"{int((kernel_logits.argmax(-1) == twin_logits.argmax(-1)).sum())}"
        f"/{B}")
    if not rel <= LOGITS_REL_L2:
        raise AssertionError(f"prefill logits differ: rel L2 {rel:.3e}")
    del kernel_logits, twin_logits

    engine = RolloutEngine(
        bundle, SamplingConfig(max_new_tokens=VIDEO_ROLLOUT_TOKENS,
                               temperature=0.0, eos_token_id=VICUNA_EOS,
                               pad_token_id=0),
        max_len=prompt_len + VIDEO_ROLLOUT_TOKENS, device=DEVICE)
    kernels = [k for k, _ in all_kernels()]
    tap = ChainTap(kernels)
    for module, fn_name in ((flash_mod, "flash_attention_ref"),
                            (flash_mod, "flash_attention_bwd_ref"),
                            (decode_mod, "decode_attention_ref")):
        tap.twin(module, fn_name)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = engine.generate(params, batch)
        torch.cuda.synchronize()
    finally:
        tap.close()
    total_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    steps = out["num_decode_steps"]
    L, Lt = cfg.text.num_hidden_layers, cfg.tower_layers
    want = {"flash_fwd": 2 * Lt + L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": L * steps}
    if launches != want or steps < 1:
        raise AssertionError(f"{label}: launches {launches} over {steps} "
                             f"decode steps, want {want}")
    if any(tap.twin_calls.values()):
        raise AssertionError(f"{label}: plain twins called on the card: "
                             f"{tap.twin_calls}")
    ids = out["completion_ids"]
    if not ((ids >= 0) & (ids < cfg.text.vocab_size)).all():
        raise AssertionError("completion ids out of the vocabulary")
    log(f"{label}: {name} greedy rollout of {B} video prompts of "
        f"{VIDEO_FRAMES} frames ({n_feats} video features: frames of "
        f"{g * g + 1} tokens through the "
        f"{'video tower' if cfg.separate_video_tower else 'shared tower'}, "
        f"{n_feats // n_frames} features each; P={prompt_len}) in "
        f"{total_s:.3f} s, {steps} decode steps, "
        f"collation {collate_ms:.1f} ms (host), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
        f"{launches} on {card}")
    del params, batch, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 20-22: adapters and quantized bases
# ---------------------------------------------------------------------------


def base_fingerprint(tree) -> list:
    """Per-leaf exact fingerprints of a frozen base (quant dicts too): the
    sums of each leaf's raw bits and of their squares, in int64, a slice
    at a time.  A changed element changes them."""
    out = []
    for leaf in _leaves(tree):
        if leaf is None:
            continue
        bits = leaf.detach().reshape(-1)
        bits = bits.view(torch.int16) if bits.element_size() == 2 else (
            bits.view(torch.int32) if bits.element_size() == 4 else bits)
        total = torch.zeros(2, dtype=torch.int64, device=bits.device)
        for i in range(0, bits.numel(), 1 << 26):
            x = bits[i:i + (1 << 26)].to(torch.int64)
            total += torch.stack([x.sum(), (x * x).sum()])
        out.append(total.cpu())
    return out


class LoraGradProbe(GradProbe):
    """GradProbe over an adapter tree: on the optimizer's first call it
    keeps the per-layer gradient norms of the decoder's q, k and v
    adapters, A and B apart (A's are 0 at step 1, where B = 0)."""

    def __init__(self, optimizer, lora, keep_grads=False):
        from iadr1_tpu_torch.train.state import tree_leaves

        leaves = tree_leaves(lora)
        attn = lora["text"]["layers"]["attn"]
        self.names = [f"decoder {n}.{f}" for n in "qkv" for f in "ab"]
        targets = [attn[n]["kernel"][f] for n in "qkv" for f in "ab"]
        self.index = [next(i for i, p in enumerate(leaves) if p is t)
                      for t in targets]
        self.optimizer, self.norms = optimizer, None
        self.keep_grads, self.grads = keep_grads, None

    def apply(self, params, grads, state, grad_norm=None):
        if self.norms is None:
            parts = {n: grads[i].detach() for n, i in zip(self.names,
                                                          self.index)}
            self.norms = {n: g.float().flatten(1).norm(dim=1)
                          for n, g in parts.items()}
            if self.keep_grads:
                self.grads = {n: g.float().clone() for n, g in parts.items()}
        return self.optimizer.apply(params, grads, state, grad_norm)


def lora_train_flops(t, B, T, vit_flops):
    """Model FLOPs of one LoRA step: the decoder's forward, its backward
    to the activations alone (the frozen base's weight-gradient GEMMs are
    not run, the adapters' are a rounding error), the attention's
    backward (twice its forward) and the tower's forward (no gradient
    reaches the frozen tower)."""
    from iadr1_tpu_torch.core.metrics import transformer_flops_per_token

    fwd = transformer_flops_per_token(
        hidden=t.hidden_size, intermediate=t.intermediate_size,
        num_layers=t.num_hidden_layers, vocab=t.vocab_size, seq_len=T,
        num_heads=t.num_attention_heads, num_kv_heads=t.num_key_value_heads)
    attn = t.num_hidden_layers * 2 * 2 * t.num_attention_heads * t.head_dim_ \
        * (T / 2)
    return B * T * (2 * fwd + attn) + vit_flops


def phase_lora_sft(label, name, hf, recipe, rows, steps, card, train_dir,
                   plain_apply, tower_flops, batch_rows=None, overrides=(),
                   quant=None, decoder_calls=1):
    """Phases 20 and 22a: LoRA (TuningConfig's defaults: rank 8, alpha 16,
    the seven targets) PA-SFT of a VLM at full width and depth over a
    frozen bf16 base drawn on the card from a seed, quantized on the card
    layer by layer when ``quant`` names a format (QLoRA), trained through
    the factored ``hidden_fn(base, batch, lora=...)`` on a recipe's
    settings, as phase_vlm_sft.  K1 must run once per decoder and tower
    layer a step and K2 and K3 once per decoder layer (no gradient
    reaches the frozen tower); step 1's loss, grad norm and the decoder's
    per-layer q/k/v adapter grad norms must agree with a step through the
    plain versions and a dq-zeroed control must not; the loss must fall
    and the base must be unchanged bit for bit.  The recipe's context
    extension (``model.rope_scaling``, ``model.shift_attn``) applies as
    in cli/train_sft.py; ``decoder_calls`` is the K1 calls a decoder
    layer makes (2 under LongLoRA, one a head half).  Returns the launch
    counts."""
    import gc

    from iadr1_tpu_torch.cli.train_sft import (
        SFTJobConfig,
        _remat,
        context_extension,
    )
    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.data.collator import VLMBatchBuilder
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.quant import quantize_tree, quantized_bytes
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.adapters import (
        TuningConfig,
        count_params,
        init_lora_params,
    )
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import STEP_RANGES, make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    job = load_config(SFTJobConfig, recipe, list(overrides))
    hf, attention = context_extension(job.model, hf)
    bundle = bundle_from_hf_config(hf, attention=attention)
    cfg = bundle.cfg
    recipe_rows = int(job.train["batch_size"])
    B, T = batch_rows or recipe_rows, job.data.cutoff_len
    remat, tower_remat = _remat(job.model.remat), _remat(job.model.tower_remat)
    tower_kw = ({} if tower_remat == "default"
                else {"tower_remat": tower_remat})
    opt_cfg = dataclasses.replace(
        dataclass_from_dict(OptimizerConfig, job.optim), total_steps=steps,
        warmup_steps=steps // 10)
    logits_dtype = getattr(torch, job.data.ce_logits_dtype)
    builder = VLMBatchBuilder(bundle, job.data.patch_budget)
    if len(rows) != B or any(len(r["input_ids"]) != T for r in rows):
        raise AssertionError(f"the rows are not {B} x {T}")
    tuning = TuningConfig(finetuning_type="lora")
    scale = tuning.lora_scale

    t0 = time.perf_counter()
    base = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    n_base = count_params(base)
    if quant is not None:
        base = quantize_tree(base, fmt=quant)
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    now_bytes, bf16_bytes = quantized_bytes(base)
    fingerprint = base_fingerprint(base)
    log(f"{label}: {name} {n_base / 1e9:.3f}B bf16 base drawn on the card"
        + (f", quantized to {quant} layer by layer" if quant else "")
        + f" in {time.perf_counter() - t0:.1f} s: {now_bytes / 2 ** 30:.2f} "
        f"GiB resident ({now_bytes / bf16_bytes:.4f} of bf16's "
        f"{bf16_bytes / 2 ** 30:.2f} GiB); the recipe: B={B}"
        + (f" (the recipe's {recipe_rows} rows cut to {B})"
           if B != recipe_rows else "")
        + f" T={T}" + (f" ({', '.join(overrides)})" if overrides else "")
        + f", remat {remat}, tower remat {tower_remat}, CE chunk "
        f"{job.data.ce_chunk} in {job.data.ce_logits_dtype}, patch budget "
        f"{job.data.patch_budget}, AdamW lr {opt_cfg.learning_rate} "
        f"{opt_cfg.schedule}; LoRA rank {tuning.lora_rank} alpha "
        f"{tuning.lora_alpha} on {', '.join(tuning.lora_target)}")

    def fresh(hidden_fn):
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        lora = init_lora_params(gen, base, tuning)
        opt, sched = make_optimizer(opt_cfg)
        probe = LoraGradProbe(opt, lora)
        step = make_chunked_sft_step(
            hidden_fn, lambda _: bundle.head_kernel_fn(base), probe, sched,
            chunk_size=job.data.ce_chunk, logits_dtype=logits_dtype)
        return create_train_state(lora, probe), step, probe

    first = next(batch_iterator(rows, B, 0, builder))

    def first_step(flash):
        attn = train_attn(flash)
        state, plain_step, probe = fresh(lambda lo, b: plain_apply(
            base, cfg, b, attn, remat, tower_kw.get("tower_remat"),
            lora=lo, lora_scale=scale))
        _, m = plain_step(state, first)
        res = {k: float(v) for k, v in m.items()}, probe.norms
        del state, plain_step, probe, m
        gc.collect()
        torch.cuda.empty_cache()
        return res

    plain_ref = first_step(TwinFlash)
    control = step1_diffs(first_step(ZeroDqFlash), plain_ref)
    log(f"{label}: step 1 control (plain path with dq zeroed) vs plain "
        f"path: {_diff_text(control)}")
    if _within(control):
        raise AssertionError("the step-1 limits do not catch a zeroed dq")

    state, step, probe = fresh(lambda lo, b: bundle.hidden_fn(
        base, b, remat=remat, lora=lo, lora_scale=scale, **tower_kw))
    n_lora = count_params(state.params)
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
        state, timed_step, batch_iterator(rows, B, 0, builder),
        LoopConfig(output_dir=train_dir, max_steps=steps, batch_size=B,
                   logging_steps=1))
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, first)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(f"profile: one {name} LoRA training step: ", prof, wall_ms,
                top_n=10, ranges=STEP_RANGES)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        base_fingerprint(base), fingerprint))
    del state, base
    gc.collect()
    torch.cuda.empty_cache()

    L = cfg.text.num_hidden_layers * decoder_calls
    Lt = tower_depth(cfg)
    # per step: K1 once per decoder call and tower layer; K2 and K3 once
    # per decoder call: the frozen tower takes no adapters and no gradient
    want = {"flash_fwd": steps * (L + Lt), "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, want {want}")
    if not unchanged:
        raise AssertionError(f"{label}: the frozen base changed")
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    diffs = step1_diffs(({"loss": losses[0], "grad_norm": norms[0]},
                         probe.norms), plain_ref)
    log(f"{label}: step 1 kernel vs plain path: loss {losses[0]:.6f} vs "
        f"{plain_ref[0]['loss']:.6f}, grad norm {norms[0]:.6f} vs "
        f"{plain_ref[0]['grad_norm']:.6f}; {_diff_text(diffs)}; the control's "
        "margins (reading / limit, above 1 fails): " + ", ".join(
            f"{k} {control[k] / STEP1_LIMITS[k]:.3f}" for k in STEP1_LIMITS))
    if not _within(diffs):
        raise AssertionError("step 1 differs between kernel and plain path")

    step_s = statistics.median(times[1:])
    n_label = history[0]["n_label_tokens"]
    vit_flops, ran_over = tower_flops(first)
    flops = lora_train_flops(cfg.text, B, T, vit_flops)
    log(f"{label}: {name} {n_lora / 1e6:.2f}M adapter params over the "
        f"frozen base (bf16 adapters and moments where the base is bf16, "
        f"f32 over a quantized one), {steps} steps of {B}x{T} tokens "
        f"({int(n_label)} label tokens, {ran_over}); losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}; base unchanged bit for bit")
    log(f"{label}: step {1e3 * step_s:.1f} ms (median of steps 2-{steps}; "
        f"all steps {[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, MFU "
        f"{flops / step_s / PEAK_BF16_FLOPS:.4f} ({flops:.4g} model FLOPs a "
        f"step: decoder forward, its backward to the activations only and "
        f"the attention's backward, the tower's forward; no weight-gradient "
        f"GEMMs for the frozen base; against {PEAK_BF16_FLOPS:.3g}), peak "
        f"memory {peak_gib:.2f} GiB, launches {launches} on {card}")
    return launches


def q25_plain_apply(params, cfg, b, attn, remat, tower_remat, lora=None,
                    lora_scale=1.0):
    """A Qwen2.5-VL training forward over ``attn`` (tower and decoder),
    ``lora`` a whole-model adapter tree."""
    from iadr1_tpu_torch.models import qwen25_vl

    h, _ = qwen25_vl.apply(
        params, cfg, b["input_ids"], b["position_ids"],
        patches=b["patches"], rot_cos=b["rot_cos"], rot_sin=b["rot_sin"],
        full_segs=b["full_segs"], window_segs=b["window_segs"],
        scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
        segment_ids=b["segment_ids"], attention_fn=attn,
        vision_attention_fn=attn, remat=remat, tower_remat=tower_remat,
        lora=lora["text"], lora_scale=lora_scale)
    return h


def llava_plain_apply(params, cfg, b, attn, remat, tower_remat, lora=None,
                      lora_scale=1.0):
    """A LLaVA-1.5/NeXT training forward over ``attn``, ``lora`` a
    whole-model adapter tree."""
    from iadr1_tpu_torch.models import llava

    h, _ = llava.apply(
        params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
        tile_segments=b["tile_segments"], pack_src=b["pack_src"],
        pack_weights=b["pack_weights"], newline_mask=b["newline_mask"],
        scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
        segment_ids=b["segment_ids"], attention_fn=attn,
        tower_attention_fn=attn, remat=remat, tower_remat=tower_remat,
        lora=lora["text"], lora_scale=lora_scale)
    return h


def make_q25_lora_sft_rows(cutoff: int, seed: int = 19):
    """LORA_SFT_ROWS rows of ``cutoff`` for phase 20: as many one-image
    IAD examples (Q25_IMAGE_HW's sizes in turn, answers of
    LORA_IMAGE_ANSWER_LEN seeded tokens) and as many text-only ones
    (answers of LORA_TEXT_ANSWER_LEN), packed by pack_examples one of
    each to a row, so the images (1024 or 864 patches) fill the recipe's
    patch budget."""
    from iadr1_tpu_torch.data.packing import pack_examples

    rng = np.random.default_rng(seed)

    def answer(lo_hi):
        return rng.integers(0, ENDOFTEXT, int(rng.integers(
            lo_hi[0], lo_hi[1] + 1))).tolist() + [IM_END]

    examples = []
    for i in range(LORA_SFT_ROWS):
        prompt, flat, grid = _q25_prompt(rng, *Q25_IMAGE_HW[i % 4], 8 + i)
        ans = answer(LORA_IMAGE_ANSWER_LEN)
        examples.append({"input_ids": prompt + ans,
                         "labels": [-100] * len(prompt) + ans,
                         "extras": {"patches": [flat], "grid_thw": [grid]}})
        prompt = ([IM_START] + rng.integers(0, ENDOFTEXT, 12).tolist()
                  + [IM_END, IM_START] + rng.integers(0, ENDOFTEXT, 2).tolist())
        ans = answer(LORA_TEXT_ANSWER_LEN)
        examples.append({"input_ids": prompt + ans,
                         "labels": [-100] * len(prompt) + ans})
    rows = pack_examples(examples, cutoff, ENDOFTEXT)
    if len(rows) != LORA_SFT_ROWS or any(len(r["extras"]) != 1
                                         for r in rows):
        raise AssertionError("the examples did not pack into rows of one "
                             "image each")
    return rows


def phase_lora_sft_q25(rows, steps: int, card):
    """Phase 20: LoRA PA-SFT of Qwen2.5-VL-7B at full width and depth on
    configs/sft_qwen2_5_vl_7b.yaml (its batch of 8 rows of 4096)."""
    grids = [g for r in rows for e in r["extras"] for g in e["grid_thw"]]
    return phase_lora_sft("q25 lora sft", "Qwen2.5-VL-7B", QWEN2_5_VL_7B,
                          Q25_SFT_RECIPE, rows, steps, card,
                          LORA_TRAIN_DIR, q25_plain_apply,
                          lambda first: q25_tower_flops(grids))


def phase_qlora_sft_next(rows, steps: int, card):
    """Phase 22a: QLoRA PA-SFT of LLaVA-NeXT-8B at full depth (32 decoder
    layers) over an nf4 base, on phase 19's rows and recipe."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch

    def tower_flops(first):
        n_tiles = first["tiles"].shape[0]
        n_images = int(first["tile_segments"].sum())
        v = LLAVA_NEXT_8B["vision_config"]
        flops = n_images * 577 * vit_flops_per_patch(
            hidden=v["hidden_size"], intermediate=v["intermediate_size"],
            num_layers=v["num_hidden_layers"] - 1, attn_window=577)
        return flops, (f"4 images in {n_images} of the {n_tiles} tiles, "
                       "the rest at segment 0")

    return phase_lora_sft(
        "next qlora sft", "LLaVA-NeXT-8B", LLAVA_NEXT_8B, LLAVA_RECIPE,
        rows, steps, card, QLORA_TRAIN_DIR, llava_plain_apply, tower_flops,
        batch_rows=NEXT_SFT_ROWS,
        overrides=[f"data.cutoff_len={NEXT_SFT_CUTOFF}",
                   "data.template=llava_next_llama3"], quant="nf4")


class LoraGrpoTap:
    """Phase 21's taps around cli/train_grpo.py's main: each rollout
    (time, decode steps, GRPO_EARLY_EOS applied as phase 7's RolloutTap
    does), each update (time, its batch, the memory allocated when it
    starts), each trainer step (time; CannedTokenizer decodes the
    completions for the rewards, since random weights write no
    parseable answer) and each reward call (time); the trainer itself is
    kept for the probe."""

    def __init__(self):
        self.undo, self.trainer = [], None
        self.roll_s, self.roll_steps, self.step_s = [], [], []
        self.update_s, self.update_batches, self.reward_s = [], [], []
        self.allocated = []

    def patch(self, owner, name, make):
        old = getattr(owner, name)
        setattr(owner, name, make(old))
        self.undo.append((owner, name, old))

    def close(self):
        for owner, name, old in reversed(self.undo):
            setattr(owner, name, old)

    def install(self):
        from iadr1_tpu_torch.train import grpo as tgrpo
        from iadr1_tpu_torch.train.rollout import RolloutEngine

        tap = self

        def generate(old):
            def run(engine, *args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = old(engine, *args, **kw)
                torch.cuda.synchronize()
                tap.roll_s.append(time.perf_counter() - t0)
                tap.roll_steps.append(out["num_decode_steps"])
                ids, mask = out["completion_ids"], out["completion_mask"]
                s = engine.sampling
                for row, keep in GRPO_EARLY_EOS:
                    if row < ids.shape[0] and int(mask[row].sum()) > keep:
                        ids[row, keep - 1] = s.eos_token_id
                        ids[row, keep:] = s.pad_token_id
                        mask[row, keep:] = 0
                return out
            return run

        def step(old):
            def run(trainer, examples):
                if tap.trainer is None:
                    tap.trainer = trainer
                    trainer.tokenizer = CannedTokenizer()
                    inner = trainer.update_step

                    def update(state, ref, batch):
                        tap.allocated.append(torch.cuda.memory_allocated())
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = inner(state, ref, batch)
                        torch.cuda.synchronize()
                        tap.update_s.append(time.perf_counter() - t0)
                        tap.update_batches.append(batch)
                        return res

                    trainer.update_step = update
                    funcs = []
                    for fn in trainer.reward_funcs:
                        def timed(*a, _fn=fn, **kw):
                            t0 = time.perf_counter()
                            out = _fn(*a, **kw)
                            tap.reward_s.append(time.perf_counter() - t0)
                            return out
                        timed.__name__ = fn.__name__
                        funcs.append(timed)
                    trainer.reward_funcs = funcs
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = old(trainer, examples)
                torch.cuda.synchronize()
                tap.step_s.append(time.perf_counter() - t0)
                return out
            return run

        self.patch(RolloutEngine, "generate", generate)
        self.patch(tgrpo.GRPOTrainer, "step", step)


def phase_lora_grpo(card):
    """Phase 21: LoRA SC-GRPO with reference elision on Qwen2.5-VL-7B at
    full width and depth, through cli/train_grpo.py's main as a user runs
    it: a seeded bf16 base written by save_pretrained with a WordLevel
    tokenizer, seeded 448x448 images and RL rows, the grpo section of
    configs/grpo_qwen2_5_vl_7b.yaml (its completions cut to
    LORA_GRPO_COMPLETION_LEN) with the finetuning section of
    configs/grpo_llava_next_34b.yaml (LoRA rank 16, alpha 32), the base in
    bf16, LORA_GRPO_STEPS steps.  One copy of the base must be resident
    (the reference is the base), each step's launches must be those the
    path implies, the lse-cotangent probe must hold on the last update's
    batch, and export_run, called as run_pipeline calls it (the base read
    in f32), must merge the adapters into the base: with the checkpoint's
    B redrawn at LORA_EXPORT_B_STD, each checked leaf of the export, read
    back, less the base must equal scale * A @ B within bf16's rounding of
    the product, relative to the delta's own size.  Returns the launch
    counts."""
    import gc
    import shutil

    import yaml

    from iadr1_tpu_torch.cli import train_grpo
    from iadr1_tpu_torch.cli.pipeline import export_run
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.params_export import save_pretrained
    from iadr1_tpu_torch.models.quant import quantized_bytes
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.adapters import TuningConfig, count_params
    from iadr1_tpu_torch.train.grpo import GRPOTrainer
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    label = "q25 lora grpo"
    hf = dict(QWEN2_5_VL_7B, num_hidden_layers=LORA_GRPO_LAYERS)
    root = LORA_GRPO_DIR
    shutil.rmtree(root, ignore_errors=True)
    base_dir, out_dir = os.path.join(root, "base"), os.path.join(root, "run")
    export_dir = os.path.join(root, "export")
    bundle = bundle_from_hf_config(hf)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    base_bytes = quantized_bytes(params)[0]
    # the bf16 base and its f32 merged export lie on disk together
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 3 * base_bytes + GIB:
        raise AssertionError(f"phase 21 needs {3 * base_bytes / 1e9:.1f} GB "
                             f"on disk, {free / 1e9:.1f} GB free")
    save_pretrained(bundle, params, base_dir)
    del params
    torch.cuda.empty_cache()
    with open(os.path.join(base_dir, "config.json"), "w") as f:
        json.dump(hf, f)
    write_chain_tokenizer(base_dir, cfg.text.vocab_size)
    data = make_chain_data(os.path.join(root, "data"))
    log(f"{label}: a seeded bf16 base of {base_bytes / 1e9:.2f} GB written "
        f"in {time.perf_counter() - t0:.1f} s")

    with open(Q25_GRPO_RECIPE) as f:
        recipe = yaml.safe_load(f)
    with open(LLAVA_GRPO_RECIPE) as f:
        lora_recipe = yaml.safe_load(f)
    job = {
        "model": {"model_name_or_path": base_dir, "dtype": "bfloat16",
                  "attention": "auto"},
        "data": dict(recipe["data"], dataset_name=data["rl"],
                     image_path=os.path.dirname(data["rl"])),
        "grpo": dict(recipe["grpo"],
                     max_completion_length=LORA_GRPO_COMPLETION_LEN),
        "finetuning": lora_recipe["finetuning"],
        "optim": recipe["optim"],
        "train": dict(recipe["train"], output_dir=out_dir,
                      max_steps=LORA_GRPO_STEPS, save_steps=0),
    }
    job_path = os.path.join(root, "grpo.yaml")
    with open(job_path, "w") as f:
        yaml.safe_dump(job, f)
    G = job["grpo"]["num_generations"]
    n = int(job["train"]["batch_size"])

    kernels = [k for k, _ in all_kernels()]
    tap = LoraGrpoTap()
    tap.install()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = train_grpo.main(["--config", job_path, "--device", DEVICE])
    finally:
        tap.close()
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if rc != 0:
        raise AssertionError(f"{label}: main returned {rc}")
    trainer = tap.trainer
    L, Lt = cfg.text.num_hidden_layers, tower_depth(cfg)
    steps = LORA_GRPO_STEPS
    # K1: the rollout's prefill, the reference's forward and the policy's
    # (tower and the three decoder calls of a layer); K2 and K3: the
    # policy's three decoder calls a layer (the frozen tower takes no
    # gradient); K4: a decoder layer a decode step
    want = {"flash_fwd": steps * (3 * (L + Lt) + 4 * L),
            "flash_bwd_dq": steps * 3 * L, "flash_bwd_dkv": steps * 3 * L,
            "decode_attention": L * sum(tap.roll_steps)}
    if launches != want or len(tap.roll_steps) != steps:
        raise AssertionError(f"{label}: launches {launches} over decode "
                             f"steps {tap.roll_steps}, want {want}")
    # one copy of the base: the reference slot holds the very tensors the
    # policy reads, and what is allocated when an update starts is that
    # copy, the adapters, their moments and the batch, never a second base
    lora_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(trainer.state.params))
    ref_bytes = quantized_bytes(trainer.ref_params)[0]
    if not trainer._lora_mode or ref_bytes != base_bytes:
        raise AssertionError(f"{label}: the reference holds {ref_bytes} "
                             f"bytes, the base {base_bytes}")
    if max(tap.allocated) > base_bytes + 3 * lora_bytes + 4 * 2 ** 30:
        raise AssertionError(f"{label}: {max(tap.allocated) / 2 ** 30:.2f} "
                             "GiB allocated at an update: a second base?")
    history = trainer.metrics_history
    for i, m in enumerate(history):
        bad = {k: v for k, v in m.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{label} step {i + 1}: non-finite {bad}")
    if not abs(history[0]["kl"]) < GRPO_KL_STEP1_MAX:
        raise AssertionError(f"kl at step 1 is {history[0]['kl']}")

    # the lse cotangent's part of dq and dk at each merged attention call
    # of one more update on the last batch, kernels against the plain
    # versions on each call's own inputs
    attn_lse, tower_attn = lse_attn(LseProbeFlash), train_attn(KernelFlash)
    embeds = qwen_embeds(q25_twin_tower)

    def shared_pred(params, batch, group_size, remat=True, lora=None,
                    lora_scale=1.0):
        from iadr1_tpu_torch.models.shared_prompt import (
            shared_prompt_pred_hidden,
        )

        e = embeds(params, cfg, batch, tower_attn, bool(remat))
        return shared_prompt_pred_hidden(
            params["text"], cfg.text, batch, group_size,
            attention_fn=attn_lse, remat=remat, prompt_embeds=e,
            lora=lora.get("text") if lora else None, lora_scale=lora_scale)

    opt, _ = make_optimizer(OptimizerConfig(learning_rate=0.0))
    ft = job["finetuning"]
    probe_trainer = GRPOTrainer(
        dataclasses.replace(bundle, shared_pred_fn=shared_pred),
        CannedTokenizer(), opt, trainer.cfg, [],
        create_train_state(_tree_map(lambda t: None if t is None else
                                     t.detach().clone(),
                                     trainer.state.params), opt),
        None, base_params=trainer.ref_params,
        tuning_cfg=TuningConfig(finetuning_type="lora",
                                lora_rank=ft["lora_rank"],
                                lora_alpha=ft["lora_alpha"]),
        device=DEVICE)
    LseProbeFlash.sums = {}
    probe_trainer.update_step(probe_trainer.state, trainer.ref_params,
                              tap.update_batches[-1])
    lse = lse_probe_summary(label, f"step {steps + 1} (the last batch)")
    check_lse_probe(lse)
    n_lora = count_params(trainer.state.params)
    del probe_trainer, trainer
    tap.trainer = None
    gc.collect()
    torch.cuda.empty_cache()

    # the export: the adapters merged into the base
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    redraw_lora_b(os.path.join(ckpt_dir, f"{steps}.safetensors"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    export_run(base_dir, ckpt_dir, export_dir, finetuning=ft, device=DEVICE)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    export_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    export_gb = _file_gb(os.path.join(export_dir, "model.safetensors"))
    export = check_lora_export(
        base_dir, export_dir, os.path.join(ckpt_dir, f"{steps}.safetensors"),
        ft["lora_alpha"] / ft["lora_rank"],
        ((0, "self_attn.q_proj", "attn.q"),
         (L - 1, "mlp.down_proj", "mlp.down")),
        "model.language_model.layers", "params.text.layers")
    if export["worst"] > LORA_EXPORT_DELTA_LIMIT or export["changed"] < 0.5:
        raise AssertionError(f"{label}: export off: {export}")
    shutil.rmtree(root, ignore_errors=True)

    R = len(job["grpo"]["reward_funcs"])
    log(f"{label}: Qwen2.5-VL-7B cut to {LORA_GRPO_LAYERS} decoder layers "
        f"{n_lora / 1e6:.2f}M LoRA params (rank "
        f"{ft['lora_rank']}, alpha {ft['lora_alpha']}) over one bf16 base "
        f"copy of {base_bytes / 2 ** 30:.2f} GiB that is also the reference "
        f"(allocated at an update: {max(tap.allocated) / 2 ** 30:.2f} GiB), "
        f"{steps} steps of {n} prompt x G={G} through cli/train_grpo.py main "
        f"in {main_s:.1f} s; loss "
        f"{[float(format(m['loss'], '.3e')) for m in history]}, kl "
        f"{[float(format(m['kl'], '.3e')) for m in history]}, grad norm "
        f"{[round(m['grad_norm'], 5) for m in history]}, reward "
        f"{[round(m['reward'], 4) for m in history]}, decode steps "
        f"{tap.roll_steps}, launches {launches}")
    late = slice(1, None) if steps > 1 else slice(None)
    med = lambda xs: statistics.median(list(xs)[late])
    log(f"{label}: step {1e3 * med(tap.step_s):.1f} ms (all steps "
        f"{[round(1e3 * x, 1) for x in tap.step_s]} ms): rollout "
        f"{1e3 * med(tap.roll_s):.1f} ms ({1e3 * med(s / k for s, k in zip(tap.roll_s, tap.roll_steps)):.3f} "
        f"ms a decode step with its prefill), rewards "
        f"{1e3 * med(sum(tap.reward_s[i * R:(i + 1) * R]) for i in range(steps)):.2f} "
        f"ms on the host, update {1e3 * med(tap.update_s):.1f} ms; "
        f"{n * G / med(tap.step_s):.3f} rollouts/s, peak memory "
        f"{peak_gib:.2f} GiB; export {export_gb:.2f} GB in {export_s:.1f} s "
        f"({export_gb / export_s:.3f} GB/s, f32 base read and merge "
        f"included, peak {export_peak_gib:.2f} GiB), merged - base vs scale*A@B: worst {export['worst']:.3e} "
        f"of the delta (limit {LORA_EXPORT_DELTA_LIMIT:.3e}; a skipped merge "
        f"reads 1), delta rms {export['delta_rms']:.3e}, "
        f"{export['changed']:.4f} of the checked elements changed, on {card}")
    return launches


def redraw_lora_b(path: str, seed: int = 0) -> None:
    """Overwrite the B factors of a LoRA checkpoint's parameters (keys
    ``params....kernel.b``) with a seeded draw of LORA_EXPORT_B_STD, in
    each factor's dtype, keeping every other tensor and the metadata."""
    from safetensors import safe_open

    from iadr1_tpu_torch.models.params_io import save_safetensors

    gen = torch.Generator().manual_seed(seed)
    with safe_open(path, "pt") as f:
        meta = f.metadata()
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    for k, t in tensors.items():
        if k.startswith("params.") and k.endswith(".kernel.b"):
            tensors[k] = (torch.randn(t.shape, generator=gen)
                          * LORA_EXPORT_B_STD).to(t.dtype)
    save_safetensors(path, tensors, meta)


def check_lora_export(base_path: str, export_path: str, ckpt_path: str,
                      scale: float, leaves, hf_prefix: str,
                      ckpt_prefix: str) -> dict:
    """Reads back ``leaves`` ((layer, HF module, parameter path), ...) of
    a merged export and holds export - base to scale * A @ B, the factors
    read from the run's checkpoint and multiplied in f32: ``worst`` is the
    larger, over the leaves, of the error's norm over the delta's and its
    largest element over the delta's largest (bf16 adapters round their
    product once, 2^-9 relative; a skipped merge reads 1); ``changed`` is
    the share of the checked elements where the export differs from the
    base."""
    from safetensors import safe_open

    worst, changed, n, sq = 0.0, 0, 0, 0.0
    with safe_open(os.path.join(base_path, "model.safetensors"), "pt",
                   device=DEVICE) as fb, safe_open(
            os.path.join(export_path, "model.safetensors"), "pt",
            device=DEVICE) as fe, safe_open(ckpt_path, "pt",
                                            device=DEVICE) as fc:
        for layer, hf_name, path in leaves:
            key = f"{hf_prefix}.{layer}.{hf_name}.weight"
            w = fb.get_tensor(key).float().T
            got = fe.get_tensor(key).float().T
            a = fc.get_tensor(f"{ckpt_prefix}.{path}.kernel.a")[layer]
            b = fc.get_tensor(f"{ckpt_prefix}.{path}.kernel.b")[layer]
            delta = scale * (a.float() @ b.float())
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"export {key} is not finite")
            err = got - w - delta
            worst = max(worst,
                        float(err.norm() / delta.norm()),
                        float(err.abs().max() / delta.abs().max()))
            changed += int((got != w).sum())
            n += got.numel()
            sq += float(delta.square().sum())
    return {"worst": worst, "changed": changed / n,
            "delta_rms": math.sqrt(sq / n)}


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


# ---------------------------------------------------------------------------
# phases 27 and 28: PaliGemma-3B and Pixtral-12B
# ---------------------------------------------------------------------------


class PrefixLmTap:
    """Counts the decoder's dense prefix-LM attention calls (PaliGemma's
    prefill, training and scoring; ``qwen2.prefix_lm_attention``, wrapped
    while the tap is open): one a decoder layer a forward."""

    def __init__(self):
        from iadr1_tpu_torch.models import qwen2

        self.module, self.inner, self.calls = qwen2, \
            qwen2.prefix_lm_attention, 0

        def wrapped(mask, remat=False):
            attn = self.inner(mask, remat)

            def counted(q, k, v):
                self.calls += 1
                return attn(q, k, v)
            return counted

        qwen2.prefix_lm_attention = wrapped

    def close(self):
        self.module.prefix_lm_attention = self.inner


def paligemma_plain_apply(params, cfg, b, attn, remat=False,
                          tower_remat=None, cache=None, lora=None,
                          lora_scale=1.0):
    """A PaliGemma forward with its tower over ``attn`` (the decoder's
    prefix-LM attention is dense on either path)."""
    from iadr1_tpu_torch.models import paligemma

    h, _ = paligemma.apply(
        params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
        tile_segments=b["tile_segments"], scatter_rows=b["scatter_rows"],
        scatter_cols=b["scatter_cols"], segment_ids=b["segment_ids"],
        cache=cache, cache_mode="prefill" if cache is not None else "extend",
        tower_attention_fn=attn, remat=remat, tower_remat=tower_remat,
        lora=None if lora is None else lora["text"], lora_scale=lora_scale)
    return h


def pixtral_plain_apply(params, cfg, b, attn, remat=False, tower_remat=None,
                        cache=None, lora=None, lora_scale=1.0):
    """A Pixtral forward over ``attn`` (tower and decoder), ``lora`` a
    whole-model adapter tree."""
    from iadr1_tpu_torch.models import pixtral

    h, _ = pixtral.apply(
        params, cfg, b["input_ids"], b["position_ids"],
        patch_stream=b["patch_stream"], patch_pos_ids=b["patch_pos_ids"],
        patch_segments=b["patch_segments"], scatter_rows=b["scatter_rows"],
        scatter_cols=b["scatter_cols"], segment_ids=b["segment_ids"],
        cache=cache, cache_mode="prefill" if cache is not None else "extend",
        attention_fn=attn, tower_attention_fn=attn, remat=remat,
        tower_remat=tower_remat,
        lora=None if lora is None else lora["text"], lora_scale=lora_scale)
    return h


def siglip_448_flops(n_tiles: int) -> float:
    """The SigLIP-448 tower's forward FLOPs over ``n_tiles`` tiles."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch

    v = PALIGEMMA_3B_448["vision_config"]
    return n_tiles * 1024 * vit_flops_per_patch(
        hidden=v["hidden_size"], intermediate=v["intermediate_size"],
        num_layers=v["num_hidden_layers"], attn_window=1024)


def phase_paligemma_serve(encoded, max_new_tokens, card):
    """Phase 27a: PaliGemma-3B at full width and depth serves 4 paligemma
    requests (4 tiles in a budget of 6); K1 27 times a generate (the
    tower), the decoder's prefill 18 dense prefix-LM calls, K4 18 times a
    decode step at D = 256; returns the launch counts."""
    def twin_apply(params, cfg, b, cache, attn):
        return paligemma_plain_apply(params, cfg, b, attn, cache=cache)

    def describe(batch):
        n_tiles = int(batch["tile_segments"].sum())
        if batch["tiles"].shape[0] != 6 or n_tiles != 4:
            raise AssertionError(f"tiles {tuple(batch['tiles'].shape)}, "
                                 f"{n_tiles} of them images'")
        first = batch["input_ids"][:, -1].new_tensor(
            [len(ids) for ids, _, _ in encoded])
        runs = (batch["input_ids"] == PG_IMAGE).sum(dim=1)
        if not (runs == 1024).all() or int(first.max()) > PG_PROMPT_LEN:
            raise AssertionError(f"image runs {runs.tolist()}")
        return "4 tiles of 1024 tokens in a budget of 6, runs ahead of BOS"

    return phase_vlm_serve("paligemma serve", "PaliGemma-3B",
                           PALIGEMMA_3B_448, encoded, PG_PROMPT_LEN,
                           PG_PATCH_BUDGET, max_new_tokens, card, twin_apply,
                           describe, eos_pad=(PG_EOS, PG_PAD),
                           n_params_range=(2.90e9, 2.95e9),
                           decoder_flash=False)


def phase_paligemma_sft(rows, steps: int, card):
    """Phase 27b: PaliGemma-3B PA-SFT at full width and depth on
    configs/sft_qwen2_5_vl_7b.yaml's settings with the paligemma template,
    f32 parameters, the batch cut to PG_SFT_ROWS; K1, K2 and K3 27 times
    each a step (the tower), the decoder's 18 layers dense prefix-LM;
    returns the launch counts."""
    def plain_apply(params, cfg, b, attn, remat, tower_remat):
        return paligemma_plain_apply(params, cfg, b, attn, remat,
                                     tower_remat)

    def tower_flops(first):
        n_tiles = first["tiles"].shape[0]
        n_images = int(first["tile_segments"].sum())
        return siglip_448_flops(n_images), (
            f"{n_images} images in {n_images} of the {n_tiles} tiles, the "
            "rest at segment 0")

    return phase_vlm_sft(
        "paligemma sft", "PaliGemma-3B", PALIGEMMA_3B_448, Q25_SFT_RECIPE,
        rows, steps, card, PG_TRAIN_DIR, plain_apply, tower_flops,
        batch_rows=PG_SFT_ROWS, overrides=["data.template=paligemma"],
        decoder_flash=False)


def grpo_case_paligemma(steps: int) -> types.SimpleNamespace:
    """Phase 27c's setting: PaliGemma-3B on the grpo section of
    configs/grpo_qwen2_5_vl_7b.yaml (its patch budget of 8192 holds the 8
    tiles of the dense update); no shared path in either package, so the
    update is the dense one over the G-repeated batch; the step-1 control
    zeroes dq (the dense update has no lse cotangent to drop).  N cut
    from the recipe's 512 to PG_GRPO_COMPLETION_LEN (the smoke's time;
    phases 25 and 28c run 128 too), and the decoder to
    PG_GRPO_LAYERS layers."""
    cut = dict(PALIGEMMA_3B_448, text_config=dict(
        PALIGEMMA_3B_448["text_config"], num_hidden_layers=PG_GRPO_LAYERS))
    case = grpo_case_q25(steps, "paligemma grpo",
                         f"PaliGemma-3B cut to {PG_GRPO_LAYERS} decoder "
                         "layers", cut)
    case.gcfg = dataclasses.replace(
        case.gcfg, max_completion_length=PG_GRPO_COMPLETION_LEN)
    case.plain_apply = paligemma_plain_apply
    case.vision_keys = ("tiles", "tile_segments")
    case.controls, case.lse_check = GRPO_CONTROLS[1:], False
    case.decoder_flash = False
    case.tokenizer = CannedTokenizer(PG_EOS, PG_PAD)
    case.n_params_range = (1.35e9, 1.42e9)
    return case


def phase_pixtral_serve(encoded, max_new_tokens, card):
    """Phase 28a: Pixtral-12B at full width and depth serves 4 pixtral
    requests (5566 patches in one stream of 6144); K1 24 + 40 times a
    generate, K4 40 times a decode step; returns the launch counts."""
    def twin_apply(params, cfg, b, cache, attn):
        return pixtral_plain_apply(params, cfg, b, attn, cache=cache)

    def describe(batch):
        segs = batch["patch_segments"]
        n = int((segs != 0).sum())
        if n != 5566 or int(segs.max()) != 4 or segs.shape[0] != 6144:
            raise AssertionError(f"{n} patches in {int(segs.max())} images")
        return (f"{n} patches of 4 images in one stream of "
                f"{segs.shape[0]}, {int((batch['input_ids'] == PX_IMAGE).sum())}"
                " [IMG] tokens")

    return phase_vlm_serve("pixtral serve", "Pixtral-12B", PIXTRAL_12B,
                           encoded, PX_PROMPT_LEN, PX_PATCH_BUDGET,
                           max_new_tokens, card, twin_apply, describe,
                           eos_pad=(PX_EOS, PX_PAD),
                           n_params_range=(12.6e9, 12.75e9))


def phase_pixtral_lora_sft(rows, steps: int, card):
    """Phase 28b: LoRA PA-SFT of Pixtral-12B at full depth over a bf16
    base on configs/sft_qwen2_5_vl_7b.yaml with the pixtral template, the
    batch cut to PX_SFT_ROWS; returns the launch counts."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch

    def tower_flops(first):
        n = int((first["patch_segments"] != 0).sum())
        v = pixtral_vision_widths()
        return n * vit_flops_per_patch(
            hidden=v["hidden_size"], intermediate=v["intermediate_size"],
            num_layers=v["num_hidden_layers"], attn_window=735), (
            f"{n} patches of {int(first['patch_segments'].max())} images in "
            f"a stream of {first['patch_segments'].shape[0]}")

    return phase_lora_sft(
        "pixtral lora sft", "Pixtral-12B", PIXTRAL_12B, Q25_SFT_RECIPE, rows,
        steps, card, PX_TRAIN_DIR, pixtral_plain_apply, tower_flops,
        batch_rows=PX_SFT_ROWS, overrides=["data.template=pixtral"])


def pixtral_vision_widths() -> dict:
    """Pixtral-ViT's widths as the bundle reads them (the published
    vision config is sparse)."""
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    v = bundle_from_hf_config(PIXTRAL_12B).cfg.vision
    return dict(hidden_size=v.hidden_size,
                intermediate_size=v.intermediate_size,
                num_hidden_layers=v.num_hidden_layers)


def grpo_case_pixtral(steps: int) -> types.SimpleNamespace:
    """Phase 28c's setting: LoRA SC-GRPO of Pixtral-12B with reference
    elision: configs/grpo_llava_next_34b.yaml's finetuning (rank 16,
    alpha 32) over the grpo section of configs/grpo_qwen2_5_vl_7b.yaml,
    its completions and prompts cut (PX_GRPO_COMPLETION_LEN,
    PX_GRPO_PROMPT_LEN), a bf16 base; the dense update (no shared path in
    either package), K2 and K3 in the decoder only (the frozen tower
    takes no gradient); the decoder cut to PX_GRPO_LAYERS layers."""
    import yaml

    from iadr1_tpu_torch.train.adapters import TuningConfig

    cut = dict(PIXTRAL_12B, text_config=dict(
        PIXTRAL_12B["text_config"], num_hidden_layers=PX_GRPO_LAYERS))
    case = grpo_case_q25(steps, "pixtral lora grpo",
                         f"Pixtral-12B cut to {PX_GRPO_LAYERS} decoder "
                         "layers", cut)
    case.gcfg = dataclasses.replace(
        case.gcfg, max_prompt_length=PX_GRPO_PROMPT_LEN,
        max_completion_length=PX_GRPO_COMPLETION_LEN)
    with open(LLAVA_GRPO_RECIPE) as f:
        ft = yaml.safe_load(f)["finetuning"]
    case.lora = TuningConfig(finetuning_type=ft["finetuning_type"],
                             lora_rank=ft["lora_rank"],
                             lora_alpha=ft["lora_alpha"])
    case.plain_apply = pixtral_plain_apply
    case.vision_keys = ("patch_stream", "patch_pos_ids", "patch_segments")
    case.controls, case.lse_check = GRPO_CONTROLS[1:], False
    case.tokenizer = CannedTokenizer(PX_EOS, PX_PAD)
    case.n_params_range = (3.90e9, 4.02e9)
    return case


# ---------------------------------------------------------------------------
# phases 29-31: Qwen1.5-MoE-A2.7B, context extension, Mixture-of-Depths
# ---------------------------------------------------------------------------

# Qwen/Qwen1.5-MoE-A2.7B's published config: 24 layers of 16 heads over
# 16 (D = 128), 60 experts of width 1408, top 4 (not renormalised), a
# shared expert of 5632 behind a sigmoid gate, qkv biases, an untied head
# over 151936 ids, rope_theta 1e6; 14.3 B parameters
QWEN15_MOE_A27B = dict(
    architectures=["Qwen2MoeForCausalLM"], model_type="qwen2_moe",
    vocab_size=151936, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
    max_position_embeddings=8192, rope_theta=1000000.0, rms_norm_eps=1e-6,
    tie_word_embeddings=False, num_experts=60, num_experts_per_tok=4,
    moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
    norm_topk_prob=False, router_aux_loss_coef=0.001, decoder_sparse_step=1,
    mlp_only_layers=[], use_sliding_window=False, bos_token_id=151643,
    eos_token_id=151643)
MOE_PROMPT_LENS = (1024, 937, 768, 1003)      # 4 chatml text requests
MOE_N_PARAMS_RANGE = (14.2e9, 14.4e9)
# phases 29b-c: the decoder cut to 4 of 24 layers (2.9 B parameters, 46 GB
# of f32 state with AdamW; the whole model's would be 229 GB: A.11)
MOE_TRAIN_LAYERS, MOE_SFT_ROWS, MOE_SFT_CUTOFF, MOE_SFT_STEPS = 4, 2, 4096, 3
MOE_GRPO_STEPS, MOE_GRPO_PROMPT_LEN, MOE_GRPO_COMPLETION_LEN = 2, 1024, 128
MOE_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_moe_sft")
# the step-1 check's extra reading: the router's aux loss, relatively
MOE_AUX_REL = STEP1_LOSS_REL
# phase 30: LoRA PA-SFT of LLaVA-NeXT-8B's decoder at full depth over a
# bf16 base, rows of 16384 (model_max_length) over LLaMA-3's 8192
# positions: rope_scaling linear, factor 2, and LongLoRA's shift_attn
LONGLORA_CUTOFF, LONGLORA_ROWS, LONGLORA_PER_ROW, LONGLORA_STEPS = (
    16384, 1, 8, 2)
LONGLORA_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "build", "chip_smoke_longlora")
# phase 31: convert_to_mod over Qwen2-VL-2B's decoder as a qwen2 text
# model, f32, capacity 0.125 (k = 512 of 4096)
MOD_CAPACITY, MOD_ROWS, MOD_CUTOFF, MOD_STEPS = 0.125, 2, 4096, 3
MOD_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_mod")


def qwen2_vl_text_hf() -> dict:
    """Qwen2-VL-2B's decoder as a Qwen2 text config (1-D RoPE)."""
    text = {k: v for k, v in QWEN2_VL_2B["text_config"].items()
            if k != "rope_scaling"}
    return dict(text, architectures=["Qwen2ForCausalLM"], model_type="qwen2")


def make_moe_requests(seed: int = 31):
    """Four chatml text requests as token ids (MOE_PROMPT_LENS long)."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    out = []
    for n in MOE_PROMPT_LENS:
        head = [IM_START] + text(3) + [IM_END] + text(1) + [IM_START] + text(2)
        tail = [IM_END] + text(1) + [IM_START] + text(2)
        out.append(head + text(n - len(head) - len(tail)) + tail)
    return out


def make_text_sft_rows(n_rows: int, cutoff: int, seed: int):
    """Synthetic chatml text SFT examples (``make_text_sft_examples``),
    packed by pack_examples (the native plane) into ``n_rows`` rows of
    ``cutoff``; the examples that do not fit are dropped."""
    from iadr1_tpu_torch.data.packing import pack_examples

    examples = make_text_sft_examples(n_rows, cutoff, seed)
    rows = pack_examples(examples, cutoff, ENDOFTEXT)[:n_rows]
    if len(rows) != n_rows or any(r["segment_ids"].max() < 2 for r in rows):
        raise AssertionError(f"the examples did not pack into {n_rows} "
                             "rows of several")
    return rows


def make_text_sft_examples(n_rows: int, cutoff: int, seed: int):
    """Synthetic chatml text SFT examples, ``n_rows * cutoff`` tokens in
    all: a prompt of 60-200 seeded tokens, masked, and a labeled answer of
    600-1500 ending in <|im_end|>."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    examples, total = [], 0
    while total < n_rows * cutoff:
        prompt = ([IM_START] + text(3) + [IM_END] + text(1) + [IM_START]
                  + text(int(rng.integers(60, 200))) + [IM_END] + text(1)
                  + [IM_START] + text(2))
        answer = text(int(rng.integers(600, 1500))) + [IM_END]
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer})
        total += len(prompt) + len(answer)
    return examples


def make_moe_grpo_examples(seed: int = 33):
    """Two chatml text prompts with a ``solution`` each."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(0, ENDOFTEXT, n).tolist()

    return [{"prompt_ids": ([IM_START] + text(3) + [IM_END] + text(1)
                            + [IM_START] + text(300 + 200 * i) + [IM_END]
                            + text(1) + [IM_START] + text(2)),
             "solution": GRPO_SOLUTIONS[i]} for i in range(2)]


def _left_text_segments(prompts, P):
    seg = torch.zeros((len(prompts), P), device="cuda", dtype=torch.int32)
    for b, ids in enumerate(prompts):
        seg[b, P - len(ids):] = 1
    return seg


class RoutingTape:
    """The discrete routing choices of one pass (the MoE dispatch's
    experts a token, ``qwen2_moe.route``; MoD's rows a layer,
    ``mod.top_rows``), recorded in order and replayed in another pass:
    a kernel-path-against-plain-path check then reads the attention's
    rounding, not the expert or row choices that a rounding difference
    tips.  ``limit`` calls are recorded (one forward's); a replay takes
    them in turn, from the first again at each forward."""

    def __init__(self, limit: int):
        self.limit, self.choices, self.at = limit, [], 0

    def _next(self):
        choice = self.choices[self.at % len(self.choices)]
        self.at += 1
        return choice

    def _swap(self, module, name, fn):
        real = getattr(module, name)

        class Swap:
            def __enter__(self_):
                setattr(module, name, fn(real))

            def __exit__(self_, *exc):
                setattr(module, name, real)

        return Swap()

    def moe(self, replay: bool):
        from iadr1_tpu_torch.models import qwen2_moe

        def make(real):
            def route(cfg, xf, kernel):
                probs, weights, selected = real(cfg, xf, kernel)
                if not replay:
                    if len(self.choices) < self.limit:
                        self.choices.append(selected)
                    return probs, weights, selected
                selected = self._next()
                weights = probs.gather(1, selected)
                if cfg.norm_topk_prob:
                    weights = weights / weights.sum(-1, keepdim=True)
                return probs, weights, selected
            return route

        return self._swap(qwen2_moe, "route", make)

    def mod(self, replay: bool):
        from iadr1_tpu_torch.models import mod

        def make(real):
            def top_rows(scores, k):
                if replay:
                    return self._next()
                rows = real(scores, k)
                if len(self.choices) < self.limit:
                    self.choices.append(rows)
                return rows
            return top_rows

        return self._swap(mod, "top_rows", make)


def phase_kernels_moe_context(moe_requests, moe_grpo, longlora_rows,
                              mod_rows, max_new_tokens):
    """Phase 3 at the shapes of phases 29-31: K1 at Qwen1.5-MoE's prefill
    (16 heads over 16, D = 128, P = 1024, left padding); K4 over its
    serving cache and its SC-GRPO fan-out; K1-K3 at LongLoRA's grouped
    views of phase 30's row (16 heads over 4 a head half, g = 4096, D =
    128): the first half in place, the second rolled by g / 2 with its
    segment ids, the last group wrapping into the first; K1-K3 at MoD's
    gathered rows (k = 512 of phase 31's 4096, 12 heads over 2).  Returns
    the results by kernel."""
    cuda = dict(device="cuda", dtype=torch.int32)
    fwd, bwd, dec = [], [], []
    P = MOE_PROMPT_LENS[0]
    pre = _left_text_segments(moe_requests, P)
    fwd.append(_labelled([flash_case(BATCH, 16, 16, P, P, 128, True, pre,
                                     pre, 161, timed=True, library=True)],
                         "qwen1.5-moe prefill")[0])
    S = P + max_new_tokens
    cache_seg = torch.ones((BATCH, S), **cuda)
    cache_seg[:, :P] = pre
    dec.append(decode_case(BATCH, 16, 16, S, 128, S, cache_seg, 162,
                           timed=True, library=True))
    dec[-1]["shape"] = f"qwen1.5-moe decode: {dec[-1]['shape']}"
    G, P, N = 4, MOE_GRPO_PROMPT_LEN, MOE_GRPO_COMPLETION_LEN
    p_seg = _left_text_segments([ex["prompt_ids"] for ex in moe_grpo], P)
    fan = torch.cat([p_seg.repeat_interleave(G, dim=0),
                     torch.ones((len(moe_grpo) * G, N), **cuda)], dim=1)
    dec.append(decode_case(len(moe_grpo) * G, 16, 16, P + N, 128, P + N,
                           fan, 163, timed=True))
    dec[-1]["shape"] = f"qwen1.5-moe grpo fan-out: {dec[-1]['shape']}"
    # LongLoRA: the two head halves' grouped views of the 16384 row
    segs = torch.as_tensor(longlora_rows[0]["segment_ids"], **cuda)[None]
    T = segs.shape[1]
    g = T // 4
    for label, s in (("longlora half 1", segs),
                     ("longlora half 2 (rolled)",
                      torch.roll(segs, -(g // 2), dims=1))):
        grouped = s.reshape(T // g, g)
        shape = (T // g, 16, 4, g, g, 128, True, grouped, grouped)
        results = _labelled((*bwd_case(*shape, 164, timed=True),
                             flash_case(*shape, 165, timed=True)), label)
        bwd.append(results[:3])
        fwd.append(results[3])
    # MoD: k = capacity * T rows a layer, picked by a seeded score, sorted
    segs = torch.as_tensor(np.stack([r["segment_ids"] for r in mod_rows]),
                           **cuda)
    T = segs.shape[1]
    k = int(T * MOD_CAPACITY)
    gen = torch.Generator(device="cuda").manual_seed(166)
    scores = torch.rand(segs.shape, generator=gen, device="cuda")
    scores = torch.where(segs > 0, scores, -1.0)
    picked = scores.sort(dim=1, descending=True, stable=True).indices[
        :, :k].sort(dim=1).values
    gathered = segs.gather(1, picked)
    shape = (len(mod_rows), 12, 2, k, k, 128, True, gathered, gathered)
    results = _labelled((*bwd_case(*shape, 167, timed=True, library=True),
                         flash_case(*shape, 168, timed=True)),
                        "mod gathered rows")
    bwd.append(results[:3])
    fwd.append(results[3])
    fwd += [f for _, _, f in bwd]
    log_kernel_results(fwd, dec, bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": dec}


def twin_decode_attn(q, k_cache, v_cache, kv_segments, length):
    """The decode-attention signature over K4's plain version."""
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention_ref

    B, T, H, D = q.shape
    out = decode_attention_ref(q.reshape(B, H, D), k_cache.to(q.dtype),
                               v_cache.to(q.dtype), kv_segments, length,
                               scale=D ** -0.5)
    return out.reshape(B, T, H, D)


def phase_moe_serve(requests, max_new_tokens, card):
    """Phase 29a: Qwen1.5-MoE-A2.7B at full width and depth (bf16, drawn
    on the card from a seed) serves 4 chatml text requests through
    RolloutEngine.generate, greedy: K1 once per layer a generate, K4 once
    per layer a decode step, no plain twin called; the prefill's last
    logits and the first decode step's, against the same steps over the
    plain versions on the same weights.  Returns the launch counts."""
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels import decode_attention as decode_mod
    from iadr1_tpu_torch.kernels import flash_attention as flash_mod
    from iadr1_tpu_torch.models import qwen2_moe
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig

    bundle = bundle_from_hf_config(QWEN15_MOE_A27B)
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"moe serve: Qwen1.5-MoE-A2.7B {n_params / 1e9:.3f}B params (bf16, "
        f"seeded; {cfg.num_experts} experts, top {cfg.num_experts_per_tok},"
        f" a shared expert) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    if not MOE_N_PARAMS_RANGE[0] < n_params < MOE_N_PARAMS_RANGE[1]:
        raise AssertionError(f"{n_params / 1e9:.3f}B params, not in "
                             f"{MOE_N_PARAMS_RANGE}")
    P, B = max(len(r) for r in requests), len(requests)
    ids = torch.full((B, P), ENDOFTEXT, dtype=torch.int64)
    mask = torch.zeros((B, P), dtype=torch.int64)
    for b, r in enumerate(requests):
        ids[b, P - len(r):] = torch.as_tensor(r)
        mask[b, P - len(r):] = 1
    batch = {"input_ids": ids.to(DEVICE), "attention_mask": mask.to(DEVICE)}
    pos = llava_positions(batch["attention_mask"])
    segs = batch["attention_mask"].to(torch.int32)

    def two_steps(kernels):
        """The prefill's last logits, then one decode step's from the
        kernel path's greedy token; ``kernels`` False: the plain versions."""
        cache = qwen2_moe.init_cache(cfg, B, P + 1, torch.bfloat16, DEVICE)
        kw = ({} if kernels else {"attention_fn": twin_attn,
                                  "decode_attention_fn": twin_decode_attn})
        with torch.no_grad():
            if kernels:
                h, _ = bundle.apply(params, {"input_ids": batch["input_ids"],
                                             "position_ids": pos,
                                             "segment_ids": segs},
                                    cache=cache, cache_mode="prefill")
            else:
                h, _ = qwen2_moe.apply(params, cfg, batch["input_ids"],
                                       position_ids=pos, segment_ids=segs,
                                       cache=cache, cache_mode="prefill",
                                       **kw)
            first = bundle.logits_fn(params, h[:, -1:])[:, 0]
            step = {"input_ids": tokens[:, None], "position_ids":
                    pos[:, -1:] + 1, "segment_ids": torch.ones_like(
                        segs[:, :1])}
            if kernels:
                h, _ = bundle.apply(params, step, cache=cache,
                                    cache_mode="decode")
            else:
                h, _ = qwen2_moe.apply(params, cfg, step["input_ids"],
                                       position_ids=step["position_ids"],
                                       segment_ids=step["segment_ids"],
                                       cache=cache, cache_mode="decode", **kw)
            return first, bundle.logits_fn(params, h)[:, 0]

    tokens = torch.zeros(B, dtype=torch.int64, device=DEVICE)
    first, _ = two_steps(True)
    tokens = first.argmax(-1)
    # the plain path takes the kernel path's experts (RoutingTape); the
    # unpinned plain path's logits are logged beside
    tape = RoutingTape(2 * cfg.num_hidden_layers)
    with tape.moe(replay=False):
        got = two_steps(True)
    with tape.moe(replay=True):
        want = two_steps(False)
    free = two_steps(False)
    torch.cuda.synchronize()
    for what, a, b, c in zip(("prefill", "first decode step"), got, want,
                             free):
        log(f"moe serve: {what} logits kernel vs plain path with its own "
            f"routing: rel L2 "
            f"{float((a - c).float().norm() / c.float().norm()):.3e}")
        if a.shape != (B, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{what} logits {tuple(a.shape)}, finite "
                                 f"{bool(torch.isfinite(a).all())}")
        rel = float((a - b).float().norm() / b.float().norm())
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        log(f"moe serve: {what} logits kernel vs plain path (the kernel "
            f"path's experts): rel L2 {rel:.3e} (limit {LOGITS_REL_L2}), "
            f"argmax agree {agree}/{B}")
        if not rel <= LOGITS_REL_L2:
            raise AssertionError(f"{what} logits differ: rel L2 {rel:.3e}")
    del got, want, free, first

    engine = RolloutEngine(bundle, SamplingConfig(
        max_new_tokens=max_new_tokens, temperature=0.0,
        eos_token_id=IM_END, pad_token_id=ENDOFTEXT),
        max_len=P + max_new_tokens, device=DEVICE)
    prefill_s = []
    for _ in range(2):                        # the second one is warm
        cache = qwen2_moe.init_cache(cfg, B, P, torch.bfloat16, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            bundle.apply(params, {"input_ids": batch["input_ids"],
                                  "position_ids": pos, "segment_ids": segs},
                         cache=cache, cache_mode="prefill")
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    del cache
    prefill_ms = 1e3 * prefill_s[-1]
    kernels = [k for k, _ in all_kernels()]
    tap = ChainTap(kernels)
    for module, fn_name in ((flash_mod, "flash_attention_ref"),
                            (flash_mod, "flash_attention_bwd_ref"),
                            (decode_mod, "decode_attention_ref")):
        tap.twin(module, fn_name)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = engine.generate(params, batch)
        torch.cuda.synchronize()
    finally:
        tap.close()
    total_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k.name: k.launches for k in kernels}
    steps = result["num_decode_steps"]
    out = result["completion_ids"]
    if out.shape != (B, max_new_tokens) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"completion {tuple(out.shape)}")
    L = cfg.num_hidden_layers
    want = {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attention": L * steps}
    if launches != want or steps < 1:
        raise AssertionError(f"moe serve: launches {launches} over {steps} "
                             f"decode steps, want {want}")
    if any(tap.twin_calls.values()):
        raise AssertionError(f"moe serve: plain twins called on the card: "
                             f"{tap.twin_calls}")
    n_tokens = int(result["completion_mask"].sum())
    decode_ms = (1e3 * total_s - prefill_ms) / steps
    log(f"moe serve: generate {B} requests (prompts {list(MOE_PROMPT_LENS)}"
        f", P={P}), {steps} decode steps, {n_tokens} tokens in "
        f"{total_s:.3f} s; launches {launches}; twin calls "
        f"{tap.twin_calls}; the dispatch syncs with the host once a layer "
        f"({L} a prefill, {L} a decode step)")
    log(f"moe serve: prefill {prefill_ms:.2f} ms (cold "
        f"{1e3 * prefill_s[0]:.2f}), decode {decode_ms:.3f} ms/step, "
        f"{n_tokens / total_s:.1f} generated tokens/s, {B / total_s:.3f} "
        f"items/s, peak memory {peak_gib:.2f} GiB on {card}")
    del params, engine, result
    torch.cuda.empty_cache()
    return launches


def moe_train_hf() -> dict:
    return dict(QWEN15_MOE_A27B, num_hidden_layers=MOE_TRAIN_LAYERS)


def moe_plain_apply(params, cfg, b, attn, remat, tower_remat=None, lora=None,
                    lora_scale=1.0, return_aux=False):
    """A Qwen2-MoE training forward over ``attn``."""
    from iadr1_tpu_torch.models import qwen2_moe

    out = qwen2_moe.apply(params, cfg, b["input_ids"],
                          position_ids=b["position_ids"],
                          segment_ids=b["segment_ids"], attention_fn=attn,
                          remat=remat, lora=lora, lora_scale=lora_scale,
                          return_aux=return_aux)
    return (out[0], out[2]) if return_aux else out[0]


def detached_routing():
    """The MoE step-1 control: the dispatch's routing weights detached, so
    the router's gradient reaches it through the aux loss only."""
    from iadr1_tpu_torch.models import qwen2_moe

    real = qwen2_moe.route

    def route(cfg, xf, kernel):
        probs, weights, selected = real(cfg, xf, kernel)
        return probs, weights.detach(), selected

    class Undo:
        def __enter__(self):
            qwen2_moe.route = route

        def __exit__(self, *exc):
            qwen2_moe.route = real

    return Undo()


def moe_flops_per_token(cfg, T: int) -> float:
    """Forward model FLOPs a token over the ACTIVE parameters: the
    attention, the K routed experts, the shared expert, the router and
    the head (transformer_flops_per_token at an MLP as wide as the
    active ones)."""
    from iadr1_tpu_torch.core.metrics import transformer_flops_per_token

    active = (cfg.num_experts_per_tok * cfg.moe_intermediate_size
              + cfg.shared_expert_intermediate_size)
    return (transformer_flops_per_token(
        hidden=cfg.hidden_size, intermediate=active,
        num_layers=cfg.num_hidden_layers, vocab=cfg.vocab_size, seq_len=T,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads)
        + 2 * cfg.num_hidden_layers * cfg.hidden_size * cfg.num_experts)


def phase_moe_sft(rows, steps: int, card):
    """Phase 29b: full-parameter PA-SFT of Qwen1.5-MoE-A2.7B's config cut
    to MOE_TRAIN_LAYERS decoder layers (f32 parameters, bf16 compute,
    AdamW, remat on) with the router's aux loss (router_aux_loss_coef), as
    cli/train_sft.py assembles it.  K1-K3 once per layer a step; step 1's
    loss, aux, grad norm and the per-layer q/k/v and router grad norms
    against a step over the plain versions, and a control with the
    routing weights detached must fail them.  Returns the launch
    counts."""
    import gc

    from iadr1_tpu_torch.data.collator import text_batch
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import STEP_RANGES, make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    bundle = bundle_from_hf_config(moe_train_hf())
    cfg = bundle.cfg
    coef = cfg.router_aux_loss_coef
    opt_cfg = OptimizerConfig(learning_rate=LEARNING_RATE, schedule="cosine",
                              warmup_ratio=0.1, total_steps=steps,
                              max_grad_norm=1.0)
    B, T = MOE_SFT_ROWS, MOE_SFT_CUTOFF
    first = next(batch_iterator(rows, B, 0, text_batch))

    def fresh(hidden_fn):
        params = bundle.init_params(seed=0, dtype=torch.float32,
                                    device=DEVICE)
        opt, sched = make_optimizer(opt_cfg)
        probe = GradProbe(opt, params)
        step = make_chunked_sft_step(hidden_fn, bundle.head_kernel_fn, probe,
                                     sched, chunk_size=CE_CHUNK,
                                     aux_loss_coef=coef)
        return create_train_state(params, probe), step, probe

    def first_step(flash):
        attn = train_attn(flash)
        state, plain_step, probe = fresh(lambda p, b: moe_plain_apply(
            p, cfg, b, attn, True, return_aux=True))
        _, m = plain_step(state, first)
        res = {k: float(v) for k, v in m.items()}, probe.norms
        del state, plain_step, probe, m
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def diffs_of(got, ref):
        d = step1_diffs(got, ref)
        d["aux"] = abs(got[0]["aux_loss"] - ref[0]["aux_loss"]) / abs(
            ref[0]["aux_loss"])
        return d

    limits = dict(STEP1_LIMITS, aux=MOE_AUX_REL)
    plain_ref = first_step(TwinFlash)
    with detached_routing():
        control = diffs_of(first_step(TwinFlash), plain_ref)
    log(f"moe sft: step 1 control (plain path, routing weights detached) "
        f"vs plain path: {_diff_text(control, limits)}")
    if _within(control, limits):
        raise AssertionError("the step-1 limits do not catch detached "
                             "routing weights")

    def hidden_fn(params, b):
        h, _, aux = bundle.apply(params, b, remat=True, return_aux=True)
        return h, aux

    state, step, probe = fresh(hidden_fn)
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
        state, timed_step, batch_iterator(rows, B, 0, text_batch),
        LoopConfig(output_dir=MOE_TRAIN_DIR, max_steps=steps, batch_size=B,
                   logging_steps=1))
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, first)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile("profile: one Qwen1.5-MoE training step: ", prof, wall_ms,
                top_n=10, ranges=STEP_RANGES)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    L = cfg.num_hidden_layers
    want = {"flash_fwd": steps * L, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"moe sft launches {launches}, want {want}")
    losses = [h["loss"] for h in history]
    auxes = [h["aux_loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite,
                                           losses + auxes + norms)):
        raise AssertionError(f"losses {losses}, aux {auxes}, norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    diffs = diffs_of(({"loss": losses[0], "aux_loss": auxes[0],
                       "grad_norm": norms[0]}, probe.norms), plain_ref)
    log(f"moe sft: step 1 kernel vs plain path: loss {losses[0]:.6f} vs "
        f"{plain_ref[0]['loss']:.6f}, aux {auxes[0]:.6f} vs "
        f"{plain_ref[0]['aux_loss']:.6f}, grad norm {norms[0]:.6f} vs "
        f"{plain_ref[0]['grad_norm']:.6f}; {_diff_text(diffs, limits)}; "
        "the control's margins (reading / limit, above 1 fails): "
        + ", ".join(f"{k} {control[k] / limits[k]:.3f}" for k in limits))
    if not _within(diffs, limits):
        raise AssertionError("step 1 differs between kernel and plain path")
    step_s = statistics.median(times[1:])
    flops = 3 * B * T * moe_flops_per_token(cfg, T)
    log(f"moe sft: Qwen1.5-MoE-A2.7B cut to {L} of 24 layers, "
        f"{n_params / 1e9:.3f}B f32 params, {steps} steps of {B}x{T} tokens "
        f"({int(history[0]['n_label_tokens'])} label tokens), aux coef "
        f"{coef}; losses {[round(x, 4) for x in losses]}; aux "
        f"{[round(x, 4) for x in auxes]}; grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"moe sft: step {1e3 * step_s:.1f} ms (median of steps 2-{steps}; "
        f"all steps {[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, MFU "
        f"{flops / step_s / PEAK_BF16_FLOPS:.4f} (active-parameter model "
        f"FLOPs x3, against {PEAK_BF16_FLOPS:.3g}), peak memory "
        f"{peak_gib:.2f} GiB, launches {launches} on {card}")
    return launches


def grpo_case_moe(steps: int) -> types.SimpleNamespace:
    """Phase 29c's setting: SC-GRPO of the cut Qwen1.5-MoE (f32 policy,
    bf16 reference) on the grpo section of configs/grpo_qwen2_5_vl_7b.yaml
    with P and N cut (MOE_GRPO_PROMPT_LEN, MOE_GRPO_COMPLETION_LEN), 2
    text prompts; the dense update (no shared path in either package, and
    no aux loss in the GRPO loss, as in JAX), a dq-zeroed control."""
    case = grpo_case_q25(steps, "moe grpo",
                         f"Qwen1.5-MoE-A2.7B cut to {MOE_TRAIN_LAYERS} "
                         "decoder layers", moe_train_hf())
    case.gcfg = dataclasses.replace(
        case.gcfg, max_prompt_length=MOE_GRPO_PROMPT_LEN,
        max_completion_length=MOE_GRPO_COMPLETION_LEN)
    case.plain_apply = moe_plain_apply
    case.vision_keys = ()
    case.controls, case.lse_check = GRPO_CONTROLS[1:], False
    case.n_params_range = (2.85e9, 2.95e9)
    return case


def longlora_llava_plain_apply(params, cfg, b, attn, remat, tower_remat,
                               lora=None, lora_scale=1.0):
    """Phase 30's plain path: the LLaVA-NeXT forward with LongLoRA's
    shift-short attention over ``attn`` in the decoder, ``attn`` itself
    in the tower."""
    from iadr1_tpu_torch.models import llava
    from iadr1_tpu_torch.models.attention import make_longlora_attention

    h, _ = llava.apply(
        params, cfg, b["input_ids"], b["position_ids"], tiles=b["tiles"],
        tile_segments=b["tile_segments"], pack_src=b["pack_src"],
        pack_weights=b["pack_weights"], newline_mask=b["newline_mask"],
        scatter_rows=b["scatter_rows"], scatter_cols=b["scatter_cols"],
        segment_ids=b["segment_ids"],
        attention_fn=make_longlora_attention(attn), tower_attention_fn=attn,
        remat=remat, tower_remat=tower_remat, lora=lora["text"],
        lora_scale=lora_scale)
    return h


def phase_longlora_sft(rows, steps: int, card):
    """Phase 30: context extension.  LoRA PA-SFT of LLaVA-NeXT-8B at full
    depth (32 decoder layers, bf16 base, LoRA's defaults) on phase 19's
    recipe and examples in one row of 16384, with ``model.rope_scaling:
    linear`` and ``model.model_max_length`` 16384 over the decoder's 8192
    positions (factor 2, written into text_config: C.R18) and
    ``model.shift_attn``: each decoder layer two K1 calls on LongLoRA's
    grouped views (K2 and K3 in the backward), the CLIP tower's K1 calls
    plain; step 1 against the plain path."""
    from iadr1_tpu_torch.core.metrics import vit_flops_per_patch
    from iadr1_tpu_torch.models.registry import (
        bundle_from_hf_config,
        configure_rope_scaling,
    )

    text = bundle_from_hf_config(configure_rope_scaling(
        LLAVA_NEXT_8B, "linear", LONGLORA_CUTOFF)).cfg.text
    log(f"longlora sft: the decoder's RoPE after configure_rope_scaling: "
        f"{text.rope_scaling}, max_position_embeddings "
        f"{text.max_position_embeddings}")
    if (text.rope_scaling is None or text.rope_scaling.factor != 2.0
            or text.max_position_embeddings != LONGLORA_CUTOFF):
        raise AssertionError("the scaling did not reach the decoder")

    def tower_flops(first):
        n_tiles = first["tiles"].shape[0]
        n_images = int(first["tile_segments"].sum())
        v = LLAVA_NEXT_8B["vision_config"]
        flops = n_images * 577 * vit_flops_per_patch(
            hidden=v["hidden_size"], intermediate=v["intermediate_size"],
            num_layers=v["num_hidden_layers"] - 1, attn_window=577)
        return flops, (f"{LONGLORA_PER_ROW} images in {n_images} of the "
                       f"{n_tiles} tiles")

    return phase_lora_sft(
        "longlora sft", "LLaVA-NeXT-8B", LLAVA_NEXT_8B, LLAVA_RECIPE, rows,
        steps, card, LONGLORA_TRAIN_DIR, longlora_llava_plain_apply,
        tower_flops, batch_rows=LONGLORA_ROWS,
        overrides=[f"data.cutoff_len={LONGLORA_CUTOFF}",
                   "data.template=llava_next_llama3",
                   "model.rope_scaling=linear",
                   f"model.model_max_length={LONGLORA_CUTOFF}",
                   "model.shift_attn=true"], decoder_calls=2)


def phase_mod_train(rows, steps: int, card):
    """Phase 31: Mixture-of-Depths.  ``convert_to_mod`` over Qwen2-VL-2B's
    decoder as a Qwen2 text model (28 layers, f32 parameters, bf16
    compute), its routers then drawn from the seed (zero routers tie every
    score), ``apply_mod`` at capacity MOD_CAPACITY as the SFT step's
    hidden_fn, AdamW: K1-K3 once per layer a step on the gathered rows;
    step 1 against the plain path, which takes the kernel path's rows
    (RoutingTape), and a dq-zeroed control.  Returns the launch counts."""
    import gc

    from iadr1_tpu_torch.data.collator import text_batch
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.attention import default_attention
    from iadr1_tpu_torch.models.mod import apply_mod, convert_to_mod
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.loop import (
        LoopConfig,
        batch_iterator,
        run_sft_loop,
    )
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    bundle = bundle_from_hf_config(qwen2_vl_text_hf())
    cfg = bundle.cfg
    opt_cfg = OptimizerConfig(learning_rate=LEARNING_RATE, schedule="cosine",
                              warmup_ratio=0.1, total_steps=steps,
                              max_grad_norm=1.0)
    B, T = MOD_ROWS, MOD_CUTOFF
    first = next(batch_iterator(rows, B, 0, text_batch))

    def hidden(attn):
        return lambda p, b: apply_mod(
            p, cfg, b["input_ids"], position_ids=b["position_ids"],
            segment_ids=b["segment_ids"], capacity=MOD_CAPACITY,
            attention_fn=attn, remat=True)

    def fresh(hidden_fn):
        params = convert_to_mod(bundle.init_params(
            seed=0, dtype=torch.float32, device=DEVICE), cfg)
        router = params["layers"]["mod_router"]["kernel"]
        router.normal_(0.0, cfg.hidden_size ** -0.5,
                       generator=torch.Generator(device=DEVICE).manual_seed(3))
        opt, sched = make_optimizer(opt_cfg)
        probe = GradProbe(opt, params)
        step = make_chunked_sft_step(hidden_fn, bundle.head_kernel_fn, probe,
                                     sched, chunk_size=CE_CHUNK)
        return create_train_state(params, probe), step, probe

    def first_step(flash):
        state, plain_step, probe = fresh(hidden(train_attn(flash)))
        _, m = plain_step(state, first)
        res = {k: float(v) for k, v in m.items()}, probe.norms
        del state, plain_step, probe, m
        gc.collect()
        torch.cuda.empty_cache()
        return res

    tape = RoutingTape(cfg.num_hidden_layers)
    state, step, probe = fresh(hidden(default_attention("flash")))
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
    with tape.mod(replay=False):
        state, history = run_sft_loop(
            state, timed_step, batch_iterator(rows, B, 0, text_batch),
            LoopConfig(output_dir=MOD_TRAIN_DIR, max_steps=steps,
                       batch_size=B, logging_steps=1))
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    with tape.mod(replay=True):
        plain_ref = first_step(TwinFlash)
        control = step1_diffs(first_step(ZeroDqFlash), plain_ref)
    log(f"mod train: step 1 control (plain path with dq zeroed) vs plain "
        f"path: {_diff_text(control)}")
    if _within(control):
        raise AssertionError("the step-1 limits do not catch a zeroed dq")
    L = cfg.num_hidden_layers
    want = {"flash_fwd": steps * L, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"mod train launches {launches}, want {want}")
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    diffs = step1_diffs(({"loss": losses[0], "grad_norm": norms[0]},
                         probe.norms), plain_ref)
    log(f"mod train: step 1 kernel vs plain path (the kernel path's rows): "
        f"loss {losses[0]:.6f} vs "
        f"{plain_ref[0]['loss']:.6f}, grad norm {norms[0]:.6f} vs "
        f"{plain_ref[0]['grad_norm']:.6f}; {_diff_text(diffs)}; the "
        "control's margins (reading / limit, above 1 fails): " + ", ".join(
            f"{k} {control[k] / STEP1_LIMITS[k]:.3f}" for k in STEP1_LIMITS))
    if not _within(diffs):
        raise AssertionError("step 1 differs between kernel and plain path")
    step_s = statistics.median(times[1:])
    k = int(T * MOD_CAPACITY)
    log(f"mod train: Qwen2-VL-2B's decoder with MoD routers, "
        f"{n_params / 1e9:.3f}B f32 params, capacity {MOD_CAPACITY} (k = "
        f"{k} of {T} a layer), {steps} steps of {B}x{T} tokens; losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"mod train: step {1e3 * step_s:.1f} ms (median of steps "
        f"2-{steps}; all steps {[round(1e3 * x, 1) for x in times]} ms), "
        f"{B * T / step_s:.0f} tokens/s, peak memory {peak_gib:.2f} GiB, "
        f"launches {launches} on {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 32: the preference stages through cli/train_pref.py
# ---------------------------------------------------------------------------

# the launcher's setting: Qwen2-VL-2B from model.hf_config and a seed (f32
# policy, the bf16 reference of pref.ref_dtype), the qwen2_vl template,
# data.cutoff_len 1024, train.batch_size 2, 2 steps a stage
PREF_CUTOFF, PREF_BATCH, PREF_STEPS, PREF_LEARNING_RATE = 1024, 2, 2, 1e-6
PREF_ROWS = 4                         # examples in each dataset
# 32c: completions cut from PPOConfig's 512 to 128 (the smoke's time)
PREF_COMPLETION_LEN, PREF_RLOO_G = 128, 4
# stages run at a cut depth for the smoke's time (32a and ppo run all 28
# decoder layers)
PREF_CUT_LAYERS = 14
PREF_CUT_STAGES = ("kto", "bco", "rm", "prm", "rloo", "online_dpo")
PREF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_pref")
# (stage label, stage, pref overrides, phase) in run order
PREF_STAGES = (
    ("dpo", "dpo", {}, "32a"),
    ("simpo", "dpo", {"loss_type": "simpo"}, "32a"),
    ("kto", "kto", {}, "32b"),
    ("bco", "bco", {}, "32b"),
    ("rm", "rm", {}, "32b"),
    ("prm", "prm", {}, "32b"),
    ("ppo", "ppo", {}, "32c"),
    ("rloo", "rloo", {"num_generations": PREF_RLOO_G,
                      "max_completion_length": PREF_COMPLETION_LEN}, "32c"),
    ("online_dpo", "online_dpo",
     {"max_completion_length": PREF_COMPLETION_LEN}, "32c"),
)
# phase 3's kernel cases at these shapes: the ranking rows' lengths as
# the launcher encodes them (prompt, template and response; the pair's
# longer row cut at 1024), and a rollout prompt's length
PREF_DPO_ROW_LENS, PREF_PPO_PROMPT_LEN = (960, 1010, 1024, 1024), 420
# step 1 of each stage (PPO's first minibatch update), kernel path vs
# plain path from the same state and batch (the on-policy stages on the
# kernel path's own first rollout): the loss (relatively; RLOO's, which
# starts at beta * kl = 0, absolutely), the grad norm of the first
# optimizer step and the worst per-layer q/k/v projection grad norm.  The
# limits sit about 3x above the largest sound readings on an H100
# (PERF.md: loss 3.7e-3 RM's, grad norm 3.4e-3 and q/k/v 1.28e-2 PPO's);
# the dq-zeroed control must fail them (it reads 1 on q/k/v)
PREF_STEP1_LIMITS = {"loss": 1e-2, "grad norm": 1e-2,
                     "qkv grad norms": 4e-2}
PREF_RLOO_LOSS_ABS = 1e-4


def make_pref_data(root: str, seed: int = 36) -> dict:
    """The launcher's datasets, written under ``root``: ranking pairs (a
    prompt of 300-340 seeded words, responses of 560-700, so that a pair's
    rows fill most of 1024 and the cutoff cuts some), feedback
    conversations (300 + 600 words, alternating labels), stepwise PRM rows
    (a prompt of 200 words, 4 steps of 170) and one-text prompts (300-500
    words, a solution each)."""
    rng = np.random.default_rng(seed)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(1, ENDOFTEXT, n))

    def between(lo, hi):
        return words(int(rng.integers(lo, hi + 1)))

    user = lambda text: {"role": "user", "content": text}
    data = {
        "ranking": [{"messages": [user(between(300, 340))],
                     "chosen": between(560, 640),
                     "rejected": between(620, 700)}
                    for _ in range(PREF_ROWS)],
        "feedback": [{"messages": [user(between(280, 320)),
                                   {"role": "assistant",
                                    "content": between(580, 620)}],
                      "label": bool(i % 2)} for i in range(PREF_ROWS)],
        "prm": [{"prompt": words(200),
                 "completions": [words(170) for _ in range(4)],
                 "labels": [True, bool(i % 2), True, False]}
                for i in range(PREF_ROWS)],
        "prompts": [{"messages": [user(between(300, 500))],
                     "solution": GRPO_SOLUTIONS[i % 2]}
                    for i in range(PREF_ROWS)],
    }
    paths = {}
    for name, rows in data.items():
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(rows, f)
    return paths


PREF_DATA = {"dpo": "ranking", "rm": "ranking", "kto": "feedback",
             "bco": "feedback", "prm": "prm", "ppo": "prompts",
             "rloo": "prompts", "online_dpo": "prompts", "xpo": "prompts",
             "nash_md": "prompts", "gkd": "feedback"}


class PrefProbe(GradProbe):
    """GradProbe for a launcher that makes its own optimizer: bound to the
    parameters when the launcher makes its state (the model's own, under
    a head's tree); keeps the first optimizer step's grad norm too."""

    def __init__(self, optimizer):
        self.optimizer, self.norms = optimizer, None
        self.keep_grads, self.grads, self.grad_norm = False, None, None

    def bind(self, params):
        GradProbe.__init__(self, self.optimizer, params.get("model", params))

    def apply(self, params, grads, state, grad_norm=None):
        if self.grad_norm is None:
            from iadr1_tpu_torch.train.optimizers import global_norm

            self.grad_norm = float(grad_norm if grad_norm is not None
                                   else global_norm(grads))
        return GradProbe.apply(self, params, grads, state, grad_norm)


def all_dtensors(tree) -> bool:
    """Whether every leaf of ``tree`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    from iadr1_tpu_torch.train.state import tree_leaves

    return all(isinstance(t, DTensor) for t in tree_leaves(tree))


class PrefTap:
    """Taps around one call of cli/train_pref.py's ``main`` (phases 32 and
    33).

    Always: the optimizer the launcher makes is wrapped in a PrefProbe;
    each logged step's metrics are kept unrounded with the seconds since
    the last log, the kernels' launches in between (every counter is 0
    when the tap opens, and the launcher logs every step) and the
    rollouts the step ran; the first PPO minibatch update's metrics are
    kept (a PPO step's logged loss averages ppo_epochs x minibatches
    updates, and every update after the first starts from parameters
    that step 1's rounding moved: AdamW's first step moves every
    parameter by about the learning rate whatever its gradient's size);
    the checkpoint saves record the tree they were given and write
    nothing (a chip call may write 45 GiB: 26 GB a save at this width;
    phase 10 measures checkpoint I/O); each rollout (``RolloutEngine.
    _generate``, a mixture's too) is timed, its decode steps, completion
    tokens and models (2 for a mixture: two caches) kept, the first
    step's cloned.  The launcher's tokenizer is loaded once for the
    phase (each load parses the 151936-entry vocabulary) and decodes
    completions as CannedTokenizer does, so that the default rewards
    differ between rollouts (only the rollout stages decode).
    ``flash``: the bundle's attention is that flash Function over the
    plain versions (train_attn, lse_attn), the plain path of the step-1
    check.  ``replay``: the rollouts return those recorded ones, in turn.
    ``mixture_hf``: at the first mixture rollout, the geometric mixture's
    first sampled distribution (the prefill's last position) is kept
    from the run and recomputed on the plain path (a bundle of that
    config over TwinFlash), and on the plain path with the prompts'
    left padding attended (the control)."""

    tokenizers: dict = {}

    def __init__(self, kernels, flash=None, replay=None, mixture_hf=None,
                 probe=True):
        from transformers import AutoTokenizer

        from iadr1_tpu_torch.models import registry
        from iadr1_tpu_torch.train import checkpoint, gkd, loop, optimizers
        from iadr1_tpu_torch.train import ppo, rollout
        from iadr1_tpu_torch.train import state as state_mod

        self.kernels = kernels
        self.records, self.saved, self.rollouts = [], [], []
        # whether every leaf of each state made, and of a GKD teacher, is
        # a DTensor
        self.leaf_kinds = {"state": [], "teacher": []}
        self.first_rollouts, self.probe, self.first_update = [], None, None
        self.mixture = {}
        self._logged = 0
        mix = rollout.mix_log_probs
        self._undo = []
        replay = list(replay) if replay is not None else None
        tap = self

        def make_optimizer(fn):
            def run(cfg):
                opt, sched = fn(cfg)
                if not probe:
                    return opt, sched
                tap.probe = PrefProbe(opt)
                return tap.probe, sched
            return run

        def create_train_state(fn):
            def run(params, optimizer):
                if isinstance(optimizer, PrefProbe):
                    optimizer.bind(params)
                tap.leaf_kinds["state"].append(all_dtensors(params))
                return fn(params, optimizer)
            return run

        def gkd_init(fn):
            def run(trainer, *args, **kw):
                fn(trainer, *args, **kw)
                tap.leaf_kinds["teacher"].append(
                    all_dtensors(trainer.teacher_params))
            return run

        class Logger(loop.JsonlLogger):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                torch.cuda.synchronize()
                tap._last = time.perf_counter()

            def log(self, step, metrics):
                torch.cuda.synchronize()
                now = time.perf_counter()
                counts = {k.name: k.launches for k in tap.kernels}
                before = (tap.records[-1]["counts"] if tap.records
                          else {k: 0 for k in counts})
                tap.records.append({
                    "step": step, "metrics": dict(metrics),
                    "s": now - tap._last, "counts": counts,
                    "launches": {k: counts[k] - before[k] for k in counts},
                    "rollouts": tap.rollouts[tap._logged:]})
                tap._logged = len(tap.rollouts)
                tap._last = now
                super().log(step, metrics)

        def save(fn):
            def run(manager, step, state, metadata=None):
                tap.saved.append((step, sorted(state.params)))
                return True
            return run

        def clone(out):
            return {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in out.items()}

        def generate(fn):
            def run(engine, params, batch, generator, group_size, lora,
                    mixture=None):
                if replay is not None:
                    return clone(replay.pop(0))
                if mixture is not None and mixture_hf is not None and (
                        not tap.mixture):
                    tap.mixture["plain"], tap.mixture["control"] = (
                        plain_mixture(engine, params, batch, mixture,
                                      mixture_hf, mix))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(engine, params, batch, generator, group_size, lora,
                         mixture)
                torch.cuda.synchronize()
                tap.rollouts.append({
                    "s": time.perf_counter() - t0,
                    "decode_steps": int(out["num_decode_steps"]),
                    "rows": int(out["completion_ids"].shape[0]),
                    "tokens": int(out["completion_mask"].sum()),
                    "models": 1 if mixture is None else 2})
                if not tap.records:
                    tap.first_rollouts.append(clone(out))
                return out
            return run

        def mix_log_probs(fn):
            def run(*args, **kw):
                out = fn(*args, **kw)
                tap.mixture.setdefault("kernel", out.detach().clone())
                return out
            return run

        def make_ppo_update_step(fn):
            def run(*args, **kw):
                step = fn(*args, **kw)

                def first(state, ref_params, batch):
                    state, metrics = step(state, ref_params, batch)
                    if tap.first_update is None:
                        tap.first_update = {k: float(v)
                                            for k, v in metrics.items()}
                    return state, metrics
                return first
            return run

        def from_pretrained(fn):
            def run(path, *args, **kw):
                if path not in PrefTap.tokenizers:
                    tok = fn(path, *args, **kw)
                    tok.batch_decode = CannedTokenizer(
                        tok.eos_token_id, tok.pad_token_id).batch_decode
                    PrefTap.tokenizers[path] = tok
                return PrefTap.tokenizers[path]
            return run

        self._patch(optimizers, "make_optimizer", make_optimizer)
        self._patch(state_mod, "create_train_state", create_train_state)
        self._patch(loop, "JsonlLogger", lambda _: Logger)
        self._patch(checkpoint.CheckpointManager, "save", save)
        self._patch(rollout.RolloutEngine, "_generate", generate)
        self._patch(rollout, "mix_log_probs", mix_log_probs)
        self._patch(ppo, "make_ppo_update_step", make_ppo_update_step)
        self._patch(gkd.GKDTrainer, "__init__", gkd_init)
        self._patch(AutoTokenizer, "from_pretrained", from_pretrained)
        if flash is not None:
            self._patch(registry, "default_attention",
                        lambda _: lambda kind="auto": train_attn(flash))
            self._patch(registry, "default_attention_with_lse",
                        lambda _: lambda kind="auto": lse_attn(flash))
        for k in kernels:
            k.launches = 0

    def step1(self) -> dict:
        """What the step-1 check reads: the first PPO update's metrics,
        else step 1's."""
        return self.first_update or self.records[0]["metrics"]

    def _patch(self, owner, name, make):
        old = owner.__dict__[name] if isinstance(owner, type) else getattr(
            owner, name)
        setattr(owner, name, make(getattr(owner, name)))
        self._undo.append((owner, name, old))

    def close(self):
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)
        self._undo.clear()


@torch.no_grad()
def plain_mixture(engine, params, batch, mixture, hf, mix_log_probs):
    """The geometric mixture's first sampled distribution [B, V] (log
    probabilities at the prefill's last position) on the plain path: the
    engine's prefill through a bundle of ``hf`` over TwinFlash, for both
    models; and the control, the same with every prompt position attended
    (the left padding included)."""
    from iadr1_tpu_torch.models import registry
    from iadr1_tpu_torch.train.rollout import RolloutEngine

    default = registry.default_attention
    registry.default_attention = lambda kind="auto": train_attn(TwinFlash)
    try:
        plain_engine = RolloutEngine(registry.bundle_from_hf_config(hf),
                                     engine.sampling, engine.max_len,
                                     engine.cache_dtype, engine.device)
    finally:
        registry.default_attention = default
    mix_params, coef = mixture
    out = []
    for b in (batch, {**batch, "attention_mask": torch.ones_like(
            batch["attention_mask"])}):
        logits = [plain_engine.prefill(p, b)[0] for p in (params, mix_params)]
        out.append(mix_log_probs(*logits, coef))
    return out


def pref_launches(stage, L, rollouts, fwd_bwd=None) -> dict:
    """The launches one step of ``stage`` implies at L decoder layers
    (text rows: no tower) given the step's rollouts, as phases 6-7 count
    them.  K1 runs once a layer a forward (its residuals survive remat),
    K2 and K3 once a layer a backward; the reference and every forward
    without a graph are K1 only.  A rollout prefills once a model (a
    mixture's two) and runs K4 once a layer a model a decode step.
    ``fwd_bwd``: the step's forwards and backwards, where its setting
    differs from phase 32's (PPO's epochs and minibatches)."""
    fwd_bwd = fwd_bwd or {"dpo": (2, 1), "simpo": (1, 1), "kto": (4, 1), "bco": (2, 1),
               "rm": (1, 1), "prm": (1, 1),
               # the experience pass (policy and reference), then
               # ppo_epochs x 2 minibatch updates
               "ppo": (2 + 8, 8),
               # the shared-prompt update's three attention calls a layer
               # (prompt, completions' self and cross), for the reference
               # and the policy
               "rloo": (3 + 3, 3),
               # the reference (or teacher) and the policy: online DPO,
               # XPO, Nash-MD, GKD
               "online_dpo": (2, 1), "xpo": (2, 1), "nash_md": (2, 1),
               "gkd": (2, 1)}[stage]
    prefills = sum(r["models"] for r in rollouts)
    return {"flash_fwd": (fwd_bwd[0] + prefills) * L,
            "flash_bwd_dq": fwd_bwd[1] * L,
            "flash_bwd_dkv": fwd_bwd[1] * L,
            "decode_attention": L * sum(r["decode_steps"] * r["models"]
                                        for r in rollouts)}


def pref_step1_diffs(stage, got, ref) -> dict:
    (m, probe), (m0, probe0) = got, ref
    diffs = _grad_diffs(({"grad_norm": probe.grad_norm}, probe.norms),
                        ({"grad_norm": probe0.grad_norm}, probe0.norms))
    d = abs(m["loss"] - m0["loss"])
    diffs["loss"] = d if stage == "rloo" else d / abs(m0["loss"])
    return diffs


def pref_limits(stage) -> dict:
    if stage == "rloo":
        return dict(PREF_STEP1_LIMITS, loss=PREF_RLOO_LOSS_ABS)
    return PREF_STEP1_LIMITS


def phase_kernels_pref():
    """Phase 3 at phases 32's and 33's shapes (Qwen2-VL-2B's decoder, 12
    heads over 2, D = 128): K1-K3 at DPO's 4 rows of 1024 (2 pairs,
    right-padded to their lengths; the rows' ragged ends as the launcher
    pads them), at PPO's minibatch row of P + N = 1024 + 128 (a
    left-padded prompt, a completion that ends early) and at XPO's update
    rows (4 of P + 64, the policy's and the reference's completions to 2
    prompts, each left-padded and ending early); K4 over PPO's cache (2
    prompts), RLOO's fan-out (2 prompts x 4) and phase 33's rollout cache
    (2 prompts, P + 64; the mixture decodes two of them).  Returns the
    results by kernel."""
    cuda = dict(device="cuda", dtype=torch.int32)
    fwd, bwd, dec = [], [], []
    T = PREF_CUTOFF
    rows = torch.zeros((2 * PREF_BATCH, T), **cuda)
    for i, n in enumerate(PREF_DPO_ROW_LENS):
        rows[i, :n] = 1
    shape = (2 * PREF_BATCH, 12, 2, T, T, 128, True, rows, rows)
    results = _labelled((*bwd_case(*shape, 171, timed=True, library=True),
                         flash_case(*shape, 172, timed=True, library=True)),
                        "dpo rows")
    bwd.append(results[:3])
    fwd.append(results[3])
    P, N = PREF_CUTOFF, PREF_COMPLETION_LEN
    row = torch.zeros((1, P + N), **cuda)
    row[0, P - PREF_PPO_PROMPT_LEN:P + N - 40] = 1
    shape = (1, 12, 2, P + N, P + N, 128, True, row, row)
    results = _labelled((*bwd_case(*shape, 173, timed=True),
                         flash_case(*shape, 174, timed=True)),
                        "ppo minibatch row")
    bwd.append(results[:3])
    fwd.append(results[3])
    N33 = PREF33_COMPLETION_LEN
    t33 = time.perf_counter()
    xpo = torch.zeros((2 * PREF_BATCH, P + N33), **cuda)
    for i, (prompt, completion) in enumerate(XPO_ROW_LENS):
        xpo[i, P - prompt:P + completion] = 1
    shape = (2 * PREF_BATCH, 12, 2, P + N33, P + N33, 128, True, xpo, xpo)
    results = _labelled((*bwd_case(*shape, 177, timed=True),
                         flash_case(*shape, 178, timed=True)),
                        "xpo update rows")
    bwd.append(results[:3])
    fwd.append(results[3])
    t33 = time.perf_counter() - t33
    for label, B, S, seed in (
            ("ppo rollout", PREF_BATCH, P + N, 175),
            ("rloo fan-out", PREF_BATCH * PREF_RLOO_G, P + N, 176),
            ("xpo, nash_md and gkd rollouts", PREF_BATCH, P + N33, 179)):
        t_case = time.perf_counter()
        seg = torch.ones((B, S), **cuda)
        seg[:, :P - PREF_PPO_PROMPT_LEN] = 0
        dec.append(decode_case(B, 12, 2, S, 128, S, seg, seed, timed=True))
        dec[-1]["shape"] = f"{label}: {dec[-1]['shape']}"
        if S == P + N33:
            t33 += time.perf_counter() - t_case
    log(f"kernels: the cases at phase 33's shapes (XPO's update rows, the "
        f"paired rollouts' K4 cache) took {t33:.1f} s")
    fwd += [f for _, _, f in bwd]
    log_kernel_results(fwd, dec, bwd)
    return {"flash_fwd": fwd,
            "flash_bwd_dq": [dq for dq, _, _ in bwd],
            "flash_bwd_dkv": [dkv for _, dkv, _ in bwd],
            "decode_attention": dec}


_PREF_ASSETS: list = []


def pref_assets() -> tuple:
    """(tokenizer dir, {dataset: path}) of phases 32 and 33: the tokenizer
    (write_chain_tokenizer's) and the datasets, written once a run."""
    import shutil

    if not _PREF_ASSETS:
        shutil.rmtree(PREF_DIR, ignore_errors=True)
        os.makedirs(PREF_DIR)
        t0 = time.perf_counter()
        tok_dir = os.path.join(PREF_DIR, "tokenizer")
        write_chain_tokenizer(tok_dir,
                              QWEN2_VL_2B["text_config"]["vocab_size"])
        os.makedirs(os.path.join(PREF_DIR, "data"))
        data = make_pref_data(os.path.join(PREF_DIR, "data"))
        log(f"pref: tokenizer and datasets written in "
            f"{time.perf_counter() - t0:.1f} s")
        _PREF_ASSETS.extend([tok_dir, data])
    return tuple(_PREF_ASSETS)


def pref_hf(layers: int) -> dict:
    return dict(QWEN2_VL_2B, text_config=dict(
        QWEN2_VL_2B["text_config"], num_hidden_layers=layers))


def pref_config(label, stage, over, steps, layers, train=None) -> str:
    """A launcher config file for ``stage`` (Qwen2-VL-2B at ``layers``
    decoder layers from model.hf_config and seed 0, an f32 policy, the
    bf16 reference); returns its path."""
    tok_dir, data = pref_assets()
    cfg = {"stage": stage,
           "model": {"model_name_or_path": tok_dir, "hf_config": pref_hf(
               layers), "seed": 0, "dtype": "float32"},
           "data": {"dataset_name": data[PREF_DATA[stage]],
                    "template": "qwen2_vl", "cutoff_len": PREF_CUTOFF},
           "pref": {"ref_dtype": "bfloat16", **over},
           # one schedule for the kernel run and the one-step plain runs
           # (PPO's step takes 8 optimizer steps)
           "optim": {"learning_rate": PREF_LEARNING_RATE,
                     "warmup_ratio": 0.0, "total_steps": 100},
           "train": {"output_dir": os.path.join(PREF_DIR, label),
                     "max_steps": steps, "batch_size": PREF_BATCH,
                     "logging_steps": 1, "save_steps": 0, "seed": 0,
                     **(train or {})}}
    if stage == "ppo":
        cfg["ppo"] = {"max_completion_length": PREF_COMPLETION_LEN,
                      "ppo_epochs": 4, "mini_batch_size": 1}
    path = os.path.join(PREF_DIR, f"{label}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_pref(path, kernels, **tap_kw) -> PrefTap:
    """One call of the launcher's ``main`` under a PrefTap."""
    import gc

    from iadr1_tpu_torch.cli import train_pref

    tap = PrefTap(kernels, **tap_kw)
    try:
        code = train_pref.main(["--config", path, "--device", DEVICE])
    finally:
        tap.close()
        gc.collect()
        torch.cuda.empty_cache()
    if code != 0:
        raise AssertionError(f"train_pref exited with {code}")
    return tap


def pref_stage(label, stage, over, phase, L, kernels, total, card,
               train=None, mixture_hf=None) -> PrefTap:
    """One stage through the launcher: its steps on the kernels with their
    launches checked a step, step 1 against the plain path (on the kernel
    path's own first rollouts) and a dq-zeroed control, the readings.
    Adds its launches to ``total``; returns the kernel run's tap."""
    t_stage = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tap = run_pref(pref_config(label, stage, over, PREF_STEPS, L, train),
                   kernels, mixture_hf=mixture_hf)
    peak_gib = torch.cuda.max_memory_allocated() / GIB
    recs = tap.records
    if [r["step"] for r in recs] != list(range(1, PREF_STEPS + 1)):
        raise AssertionError(f"pref {label}: logged steps "
                             f"{[r['step'] for r in recs]}")
    for r in recs:
        if not all(map(math.isfinite, r["metrics"].values())):
            raise AssertionError(f"pref {label}: step {r['step']} "
                                 f"metrics {r['metrics']}")
    # the launches of each step against the path's count
    for r in recs:
        want = pref_launches(label, L, r["rollouts"])
        if r["launches"] != want:
            raise AssertionError(f"pref {label} step {r['step']}: "
                                 f"launches {r['launches']}, want {want}")
        for k, v in r["launches"].items():
            total[k] += v
    heads = {"ppo": ["model", "vhead"], "rm": ["model", "value_head"],
             "prm": ["model", "prm_head"]}
    want_keys = heads.get(stage, ["text", "vision"])
    if tap.saved != [(PREF_STEPS, want_keys)]:
        raise AssertionError(f"pref {label}: checkpoint saves {tap.saved}, "
                             f"want {[(PREF_STEPS, want_keys)]}")
    kernel = (tap.step1(), tap.probe)
    # the plain path and its control: step 1 from the same state and
    # batch (and the kernel path's first rollouts)
    t_plain = time.perf_counter()
    plain_tap = run_pref(pref_config(f"{label}_plain", stage, over, 1, L,
                                     train), kernels, flash=TwinFlash,
                         replay=tap.first_rollouts)
    if any(plain_tap.records[0]["launches"].values()):
        raise AssertionError(f"pref {label}: the plain path launched "
                             f"{plain_tap.records[0]['launches']}")
    plain_ref = (plain_tap.step1(), plain_tap.probe)
    control_tap = run_pref(pref_config(f"{label}_control", stage, over, 1,
                                       L, train), kernels, flash=ZeroDqFlash,
                           replay=tap.first_rollouts)
    control = pref_step1_diffs(
        label, (control_tap.step1(), control_tap.probe), plain_ref)
    del plain_tap, control_tap
    tap.first_rollouts = []
    plain_s = time.perf_counter() - t_plain
    limits = pref_limits(label)
    diffs = pref_step1_diffs(label, kernel, plain_ref)

    def text_of(d):
        return ", ".join(
            f"{k} {'abs' if label == 'rloo' and k == 'loss' else 'rel'}"
            f" {v:.3e} (limit {limits[k]})" for k, v in d.items())

    what = "the first minibatch update" if stage == "ppo" else "step 1"
    log(f"pref {label} ({phase}): {what} kernel vs plain path: loss "
        f"{kernel[0]['loss']:.6f} vs {plain_ref[0]['loss']:.6f}, grad "
        f"norm {kernel[1].grad_norm:.6f} vs {plain_ref[1].grad_norm:.6f}"
        f"; {text_of(diffs)}; the control (dq zeroed): "
        f"{text_of(control)}, margins (reading / limit, above 1 "
        "fails): " + ", ".join(f"{k} {control[k] / limits[k]:.3f}"
                               for k in limits))
    if _within(control, limits):
        raise AssertionError(f"pref {label}: the step-1 limits do not "
                             "catch a zeroed dq")
    if not _within(diffs, limits):
        raise AssertionError(f"pref {label}: step 1 differs between "
                             "kernel and plain path")
    step_s = recs[-1]["s"]
    other = ("an f32 teacher of seed 1" if stage == "gkd"
             else "bf16 reference")
    text = (f"pref {label} ({phase}): Qwen2-VL-2B, {L} decoder layers, "
            f"f32 policy, {other}; losses "
            f"{[round(r['metrics']['loss'], 6) for r in recs]}; step "
            f"{1e3 * step_s:.1f} ms (step {PREF_STEPS}; all steps "
            f"{[round(1e3 * r['s'], 1) for r in recs]} ms, from the "
            f"launcher's logs), peak memory {peak_gib:.2f} GiB")
    last = [r for r in recs if r["rollouts"]]
    if last:
        rec = last[-1]
        roll_s = sum(r["s"] for r in rec["rollouts"])
        parts = "; ".join(
            f"{1e3 * r['s']:.1f} ms ({r['rows']} rows, {r['models']} "
            f"model{'s' if r['models'] > 1 else ''}, {r['decode_steps']} "
            f"decode steps, {1e3 * r['s'] / max(r['decode_steps'], 1):.3f}"
            f" ms/step, {r['tokens']} tokens)" for r in rec["rollouts"])
        text += (f"; step {rec['step']}'s rollouts {parts}, the rest of "
                 f"that step (rewards, scoring, updates) "
                 f"{1e3 * (rec['s'] - roll_s):.1f} ms, "
                 f"{sum(r['rows'] for r in rec['rollouts']) / rec['s']:.2f}"
                 " rollouts/s")
    else:
        rows = PREF_BATCH * {"dpo": 2, "rm": 2, "kto": 2}.get(stage, 1)
        text += (f"; {rows} rows of {PREF_CUTOFF} a step"
                 + (" (the KL rows among them)" if stage == "kto" else "")
                 + f", {rows * PREF_CUTOFF / step_s:.0f} tokens/s")
    log(text + f"; launches a step {recs[-1]['launches']} on {card}")
    log(f"phase {phase} ({label}): {time.perf_counter() - t_stage:.1f} s "
        f"(the plain path and its control {plain_s:.1f} s)")
    return tap


def phase_pref(card) -> dict:
    """Phase 32: each preference stage through cli/train_pref.py's
    ``main`` from a config file (Qwen2-VL-2B from model.hf_config and a
    seed, write_chain_tokenizer's tokenizer): ``pref_stage`` for each.
    Returns the launch counts summed over the stages' kernel runs."""
    from iadr1_tpu_torch.kernels import all_kernels

    kernels = [k for k, _ in all_kernels()]
    pref_assets()
    total = {k.name: 0 for k in kernels}
    for label, stage, over, phase in PREF_STAGES:
        L = (PREF_CUT_LAYERS if label in PREF_CUT_STAGES
             else QWEN2_VL_2B["text_config"]["num_hidden_layers"])
        pref_stage(label, stage, over, phase, L, kernels, total, card)
    return total


# ---------------------------------------------------------------------------
# phase 33: XPO, Nash-MD and GKD through cli/train_pref.py; the optimizers
# ---------------------------------------------------------------------------

# phase 32's setting and data, the completions cut to 64 (the smoke's
# time); the teacher of 33c is a Qwen2-VL-2B-config
# checkpoint from seed 1 at the student's depth, written in HF layout (bf16)
# and read in the student's dtype (f32).  train.seed 8 with gkd_lmbda 0.5:
# the host draws 0.327 then 0.987, so step 1 rolls out on-policy and step
# 2 takes the dataset completions
PREF33_COMPLETION_LEN = 64
PREF33_STAGES = (
    ("xpo", "xpo", {"max_completion_length": PREF33_COMPLETION_LEN}, "33a",
     None),
    ("nash_md", "nash_md", {"max_completion_length": PREF33_COMPLETION_LEN,
                            "mixture_coef": 0.5}, "33b", None),
    ("gkd", "gkd", {"max_completion_length": PREF33_COMPLETION_LEN,
                    "gkd_lmbda": 0.5}, "33c", {"seed": 8}),
)
# 33b and 33c at a cut depth for the smoke's time (33a runs all 28 layers)
PREF33_CUT_LAYERS = 14
PREF33_CUT = ("nash_md", "gkd")
# XPO's update rows as phase 3 times them: (prompt, completion) lengths of
# the policy's two rows, then the reference's (left-padded prompts of the
# 300-500-word range, completions ending before N = 64)
XPO_ROW_LENS = ((420, 45), (500, 64), (420, 30), (500, 55))
# the mixture's first sampled distribution, kernel path against the plain
# path: the total variation distance between the two [B, V] distributions
MIXTURE_TV_LIMIT = 1e-2
# 33d: one SFT step of each optimizer on Qwen2-VL-2B with its decoder cut
# to 4 of 28 layers (the tower whole), phase 6's rows, on DTensor leaves
# under a one-rank NCCL group; the check's leaves
OPT_LAYERS = 4
OPT_NAMES = ("loraplus", "adamw", "galore", "apollo", "badam", "adam_mini",
             "muon", "adafactor", "lion", "sgd")
OPT_LEAVES = ("text/layers/attn/k/kernel", "text/embed/weight")
OPT_LORA_LEAVES = ("text/layers/attn/k/kernel/a",
                   "text/layers/attn/k/kernel/b")
# Adafactor's update of the embedding reads every row (its factored
# moments and block RMS), and the CPU's over all 151936 rows took 9.1 s:
# it is checked on the tower merger's 5120 x 5120 kernel, factored too
OPT_ADAFACTOR_LEAVES = ("text/layers/attn/k/kernel",
                        "vision/merger/fc1/kernel")
# the update of each checked leaf on the card against the CPU's from the
# same gradients: ||card - cpu|| / ||cpu||.  The limits sit about 4x above
# the largest sound readings on an H100 (PERF.md: Adafactor's 2.68e-5;
# Muon's Newton-Schulz 2.07e-4); each optimizer's control, the CPU's
# update with one piece of its arithmetic changed, must fail them
OPT_UPDATE_LIMIT = 1e-4
OPT_UPDATE_LIMITS = {"muon": 1e-3}
# each optimizer's own ms and state GB in this phase on PR 22's tree, which
# ran it on plain leaves with no group (this script on one H100 80GB HBM3
# at 700 W), beside which 33d prints its own; ``--opt-plain-leaves`` runs
# 33d on plain leaves again
OPT_PLAIN_LEAVES = {"loraplus": (6.2, 0.011), "adamw": (63.7, 8.687),
                  "galore": (2977.8, 1.966), "apollo": (88.0, 1.953),
                  "badam": (101.0, 8.687), "adam_mini": (42.3, 4.346),
                  "muon": (724.5, 5.283), "adafactor": (51.1, 0.006),
                  "lion": (43.6, 4.343), "sgd": (17.1, 0.000)}
OPT_CONTROLS = {
    **dict.fromkeys(("loraplus", "adamw", "galore", "apollo", "badam",
                     "adam_mini"), "Adam's bias correction dropped"),
    "muon": "the bias correction dropped and one Newton-Schulz step fewer",
    "adafactor": "the second moment unfactored",
    "lion": "the sign dropped",
    "sgd": "the gradient clipping dropped",
}


def write_teacher(path: str, layers: int, seed: int = 1) -> float:
    """GKD's teacher: Qwen2-VL-2B's config at ``layers`` decoder layers,
    bf16 weights from ``seed``, written in HF layout (config.json and
    model.safetensors); returns the seconds it took."""
    from iadr1_tpu_torch.models import params_export
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    hf = pref_hf(layers)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    bundle = bundle_from_hf_config(hf)
    params = bundle.init_params(seed=seed, dtype=torch.bfloat16,
                                device=DEVICE)
    params_export.save_pretrained(bundle, params, path)
    del params
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def phase_pref33(card) -> dict:
    """Phase 33a-c: XPO, Nash-MD and GKD through cli/train_pref.py's
    ``main`` as phase 32 runs its stages (``pref_stage``); 33b also holds
    the mixture's first sampled distribution to the plain path.  Returns
    the launch counts summed over the stages' kernel runs."""
    import shutil

    from iadr1_tpu_torch.kernels import all_kernels

    kernels = [k for k, _ in all_kernels()]
    pref_assets()
    total = {k.name: 0 for k in kernels}
    full = QWEN2_VL_2B["text_config"]["num_hidden_layers"]
    teacher = os.path.join(PREF_DIR, "teacher")
    for label, stage, over, phase, train in PREF33_STAGES:
        L = PREF33_CUT_LAYERS if label in PREF33_CUT else full
        if stage == "gkd":
            secs = write_teacher(teacher, L)
            log(f"pref gkd (33c): the teacher (seed 1, {L} decoder layers, "
                f"bf16 in HF layout) written in {secs:.1f} s")
            over = dict(over, teacher_model_name_or_path=teacher)
        tap = pref_stage(label, stage, over, phase, L, kernels, total, card,
                         train=train,
                         mixture_hf=pref_hf(L) if stage == "nash_md" else None)
        if stage == "nash_md":
            check_mixture(tap.mixture, card)
        if stage == "gkd":
            branches = [r["metrics"]["on_policy"] for r in tap.records]
            if branches != [1.0, 0.0]:
                raise AssertionError(f"gkd: on_policy {branches}, want "
                                     "[1.0, 0.0]")
            shutil.rmtree(teacher)
        del tap
    return total


def check_mixture(mixture: dict, card) -> None:
    """33b: the first sampled distribution of the geometric mixture on the
    kernels against the plain path, and the control's."""
    if set(mixture) != {"kernel", "plain", "control"}:
        raise AssertionError(f"nash_md: mixture readings {sorted(mixture)}")

    def tv(a, b):
        return float(0.5 * (a.float().exp() - b.float().exp()).abs().sum(
            -1).max())

    got = tv(mixture["kernel"], mixture["plain"])
    control = tv(mixture["control"], mixture["plain"])
    top = mixture["plain"].float().max(-1).values.exp()
    log(f"pref nash_md (33b): the mixture's first sampled distribution "
        f"(B={mixture['plain'].shape[0]}, V={mixture['plain'].shape[1]}), "
        f"kernel vs plain path: total variation {got:.3e}, max |d log p| "
        f"{float((mixture['kernel'] - mixture['plain']).abs().max()):.3e} "
        f"(limit {MIXTURE_TV_LIMIT} on the first); the control (the left "
        f"padding attended) {control:.3e}; top probability "
        f"{[round(float(x), 6) for x in top]} on {card}")
    if control <= MIXTURE_TV_LIMIT:
        raise AssertionError("nash_md: the mixture's limit does not catch "
                             "attended padding")
    if got > MIXTURE_TV_LIMIT:
        raise AssertionError("nash_md: the mixture's first distribution "
                             "differs between kernel and plain path")


class OptTap:
    """The optimizer, wrapped for 33d: its ``apply`` timed on its own (the
    device synchronised around it), and the checked leaves' gradients,
    values before and after (the embedding's ``rows`` alone where its
    update is row-local) and the gradients' global norm kept on the host;
    ``tap_s`` is the time those copies took."""

    def __init__(self, optimizer, leaves, rows=None):
        self.optimizer, self.leaves, self.rows = optimizer, leaves, rows
        self.seconds, self.seen, self.tap_s = None, None, 0.0

    def init(self, params, paths=None):
        self.paths = paths
        return self.optimizer.init(params, paths)

    def _host(self, tensors, idx):
        from iadr1_tpu_torch.core.mesh import full

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for i in idx:
            t = full(tensors[i].detach())
            if self.rows is not None and self.paths[i] == "text/embed/weight":
                t = t[self.rows.to(t.device)]
            out.append(t.to("cpu", torch.float32, copy=True))
        self.tap_s += time.perf_counter() - t0
        return out

    def apply(self, params, grads, state, grad_norm=None):
        from iadr1_tpu_torch.train.optimizers import global_norm

        idx = [self.paths.index(p) for p in self.leaves]
        if grad_norm is None:
            grad_norm = global_norm(grads)
        self.seen = {"grad_norm": float(grad_norm),
                     "grads": self._host(grads, idx),
                     "before": self._host(params, idx)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.optimizer.apply(params, grads, state, grad_norm)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        self.seen["after"] = self._host(params, idx)
        return out


def cpu_update(name, opt_cfg, seen, leaves, card_opt, control=False):
    """The update of the checked leaves computed on the CPU by the same
    optimizer from the gradients the card saw (the rows the card kept);
    ``control``: with OPT_CONTROLS[name]'s change to the arithmetic."""
    from iadr1_tpu_torch.train import custom_optim, optimizers

    opt, _ = optimizers.make_optimizer(opt_cfg)
    undo = []
    if control:
        if name not in ("adafactor", "lion", "sgd"):
            for mod in (optimizers, custom_optim):
                undo.append((mod, mod.bias_correction))
                mod.bias_correction = lambda b, count: 1.0
        if name == "muon":
            opt.ns_steps -= 1
        elif name == "adafactor":
            opt.min_dim = math.inf
        elif name == "lion":
            direction = opt.direction

            def unsigned(i, g, p, state, count):
                mu = state["mu"][i].clone()
                direction(i, g, p, state, count)       # Lion's moment
                return (1.0 - opt.b1) * g + opt.b1 * mu
            opt.direction = unsigned
        elif name == "sgd":
            opt.max_grad_norm = None
    params = [b.clone() for b in seen["before"]]
    try:
        state = opt.init(params, list(leaves))
        if name == "apollo":                 # the card's leaf indices
            opt.index = {k: card_opt.index[card_opt.paths.index(p)]
                         for k, p in enumerate(leaves)
                         if card_opt.paths.index(p) in card_opt.index}
        opt.apply(params, seen["grads"], state,
                  torch.tensor(seen["grad_norm"]))
    finally:
        for mod, fn in undo:
            mod.bias_correction = fn
    return [p - b for p, b in zip(params, seen["before"])]


def _opt_state_bytes(state) -> int:
    """The bytes of the state's tensors this rank holds (a DTensor's local
    shard)."""
    from iadr1_tpu_torch.core.mesh import local

    return sum(local(t).nbytes for v in state.values() if isinstance(v, list)
               for t in v if t is not None)


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL group (torchrun's variables for a world of one) and
    its (1, 1, 1) mesh, armed as the ambient mesh, the world's and each
    axis's communicator made by one all-reduce before the first timed
    step; torn down after."""
    import torch.distributed as dist

    from iadr1_tpu_torch.core.distributed import maybe_initialize_distributed
    from iadr1_tpu_torch.core.mesh import (
        MeshConfig,
        build_mesh,
        set_kernel_mesh,
    )

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        if not maybe_initialize_distributed(DEVICE):
            raise AssertionError("no one-rank group was set up")
        mesh = build_mesh(MeshConfig(1, 1, 1))
        for group in [None] + [mesh.get_group(a) for a in range(mesh.ndim)]:
            dist.all_reduce(torch.zeros(1, device=DEVICE), group=group)
        torch.cuda.synchronize()
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)
        set_kernel_mesh(None)


def opt_step_on_mesh(name, mesh, bundle, base, batch, embed_rows, kernels,
                     total, depths, timed_proj, proj_s, card):
    """One optimizer's step of phase 33d on ``mesh`` (the one-rank group's):
    the model (and LoRA+'s adapters) placed as DTensors, the step timed
    with its launches counted into ``total``, the update held to the
    CPU's; returns (its wall s, its readings).  ``mesh`` None: on a copy
    of the model's plain leaves."""
    import gc

    from iadr1_tpu_torch.cli.train_grpo import shard_adapters
    from iadr1_tpu_torch.core.mesh import shard_pytree
    from iadr1_tpu_torch.train import custom_optim
    from iadr1_tpu_torch.train.adapters import (
        TuningConfig,
        init_lora_params,
        lora_training_fns,
    )
    from iadr1_tpu_torch.train.optimizers import (
        OptimizerConfig,
        make_optimizer,
    )
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    L, T = depths
    t_opt = time.perf_counter()
    lora = name == "loraplus"
    opt_cfg = OptimizerConfig(
        learning_rate=LEARNING_RATE, schedule="constant",
        warmup_steps=0, total_steps=10, max_grad_norm=1.0,
        **({"loraplus_lr_ratio": 16.0} if lora
           else {"optimizer": name}))
    inner, sched = make_optimizer(opt_cfg)
    leaves = (OPT_LORA_LEAVES if lora else OPT_ADAFACTOR_LEAVES
              if name == "adafactor" else OPT_LEAVES)
    # the embedding's update is row-local
    opt = OptTap(inner, leaves, embed_rows)
    # the model placed by its logical axes (each leaf's shard copied)
    params = (_cloned(base) if mesh is None
              else shard_pytree(base, bundle.logical_axes(), mesh))
    if lora:
        tcfg = TuningConfig(finetuning_type="lora")
        adapters = shard_adapters(bundle, init_lora_params(
            torch.Generator(device=DEVICE).manual_seed(3), base, tcfg), mesh)
        state = create_train_state(adapters, opt)
        hidden, head = lora_training_fns(bundle, params, tcfg, remat=True)
    else:
        state = create_train_state(params, opt)
        hidden = lambda p, b: bundle.hidden_fn(  # noqa: E731
            p, b, remat=True)
        head = bundle.head_kernel_fn
    step = make_chunked_sft_step(hidden, head, opt, sched,
                                 chunk_size=CE_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    svd_proj, custom_optim._svd_proj = custom_optim._svd_proj, timed_proj
    proj_s.clear()
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0 - opt.tap_s
    finally:
        custom_optim._svd_proj = svd_proj
    peak = torch.cuda.max_memory_allocated() / GIB
    launches = {k.name: k.launches for k in kernels}
    for k, v in launches.items():
        total[k] += v
    # a full step: K1 once a decoder layer and twice a tower block
    # (the tower's remat runs it again), K2 and K3 once each; LoRA's
    # frozen tower takes no backward
    tower = 0 if lora else T
    want = {"flash_fwd": L + T + tower, "flash_bwd_dq": L + tower,
            "flash_bwd_dkv": L + tower, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"optimizer {name}: launches {launches}, "
                             f"want {want}")
    state_bytes = _opt_state_bytes(state.opt_state)
    loss = float(metrics["loss"])
    got = [a - b for a, b in zip(opt.seen["after"], opt.seen["before"])]
    t_cpu = time.perf_counter()
    diffs, controls = [[float((g - w).norm() / w.norm().clamp(min=1e-30))
                        for g, w in zip(got, cpu_update(
                            name, opt_cfg, opt.seen, leaves, inner,
                            control))]
                       for control in (False, True)]
    cpu_s = time.perf_counter() - t_cpu
    limit = OPT_UPDATE_LIMITS.get(name, OPT_UPDATE_LIMIT)
    plain_ms, plain_gb = OPT_PLAIN_LEAVES[name]
    result = dict(step_ms=1e3 * step_s, opt_ms=1e3 * opt.seconds,
                  proj_ms=1e3 * sum(proj_s), projs=len(proj_s),
                  peak_gib=peak, state_bytes=state_bytes, loss=loss,
                  diffs=diffs, controls=controls)
    log(f"optimizers (33d): {name}: step {1e3 * step_s:.1f} ms, the "
        f"optimizer {1e3 * opt.seconds:.1f} ms"
        + (f" (its {len(proj_s)} projections {1e3 * sum(proj_s):.1f}"
           " ms)" if proj_s else "")
        + f", peak {peak:.2f} GiB, optimizer state "
        f"{state_bytes / 1e9:.3f} GB, loss {loss:.6f}, grad norm "
        f"{opt.seen['grad_norm']:.6f}; update vs the CPU's (||card - "
        f"cpu|| / ||cpu||, limit {limit}) "
        + ", ".join(f"{p} {d:.3e}" for p, d in zip(leaves, diffs))
        + f"; the control ({OPT_CONTROLS[name]}) "
        + ", ".join(f"{c:.3e}" for c in controls)
        + f"; the CPU's updates {cpu_s:.1f} s, "
        + ("on plain leaves" if mesh is None else "on the mesh")
        + f"; PR 22's tree on plain leaves (OPT_PLAIN_LEAVES): the "
        f"optimizer {plain_ms:.1f} ms, state {plain_gb:.3f} GB; on {card}")
    # the cached blocks stay for the next optimizer: its peak reads
    # allocated memory, not reserved
    del state, step, params, opt, inner, metrics
    gc.collect()
    wall = time.perf_counter() - t_opt
    if not all(math.isfinite(x) for x in diffs) or max(diffs) > limit:
        raise AssertionError(f"optimizer {name}: the card's update "
                             f"differs from the CPU's: {diffs}")
    if max(controls) <= limit:
        raise AssertionError(f"optimizer {name}: the limit does not "
                             f"catch {OPT_CONTROLS[name]}: {controls}")
    return wall, result


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def phase_optimizers(rows, card, plain_leaves=False) -> dict:
    """Phase 33d: one PA-SFT step of Qwen2-VL-2B (decoder at OPT_LAYERS of
    28 layers, the tower whole; phase 6's rows) with each optimizer
    ``make_optimizer`` builds, LoRA+ over LoRA's defaults, on DTensor
    leaves placed by the model's logical axes under a one-rank NCCL group
    (``one_rank_group``), as phase 35c places the model: the shard-local
    updates, their all-reduces and their one-matrix gathers run through
    NCCL.  It reports the step ms, the optimizer's own ms (GaLore's SVD
    apart), the peak memory and the bytes of optimizer state beside PR
    22's on plain leaves (OPT_PLAIN_LEAVES); each optimizer's update of two
    leaves is held to the same update computed on the CPU from the same
    gradients, and its control (OPT_CONTROLS) must fail.  Returns the
    launch counts.  ``plain_leaves``: on plain leaves with no group (the
    single-card path)."""
    import gc

    from iadr1_tpu_torch.data.collator import VLMBatchBuilder
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train import custom_optim
    from iadr1_tpu_torch.train.loop import batch_iterator
    from iadr1_tpu_torch.train.state import tree_leaves

    kernels = [k for k, _ in all_kernels()]
    total = {k.name: 0 for k in kernels}
    L, T = OPT_LAYERS, QWEN2_VL_2B["vision_config"]["depth"]
    t_setup = time.perf_counter()
    hf = pref_hf(OPT_LAYERS)
    bundle = bundle_from_hf_config(hf)
    batch = next(batch_iterator(rows, TRAIN_ROWS, 0,
                                VLMBatchBuilder(bundle, PATCH_BUDGET)))
    # the embedding rows the CPU check reads: the batch's tokens and 256
    # rows no token reaches
    embed_rows = torch.as_tensor(np.union1d(np.unique(np.asarray(
        batch["input_ids"])), np.arange(256)))
    base = bundle.init_params(seed=0, dtype=torch.float32, device=DEVICE)
    n_params = sum(p.numel() for p in tree_leaves(base))
    # GaLore's projections (custom_optim._svd_proj: the top singular
    # vectors by the f64 Gram matrix's eigh), timed apart
    proj_s = []
    svd_proj = custom_optim._svd_proj

    def timed_proj(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = svd_proj(*args)
        torch.cuda.synchronize()
        proj_s.append(time.perf_counter() - t0)
        return out

    results = {}
    torch.cuda.synchronize()
    setup_s, walls = time.perf_counter() - t_setup, {}
    with (contextlib.nullcontext() if plain_leaves
          else one_rank_group()) as mesh:
        for name in OPT_NAMES:
            walls[name], results[name] = opt_step_on_mesh(
                name, mesh, bundle, base, batch, embed_rows, kernels, total,
                (L, T), timed_proj, proj_s, card)
    adamw = results["adamw"]
    log(f"optimizers (33d): Qwen2-VL-2B at {OPT_LAYERS} decoder layers and "
        f"the whole tower, {n_params / 1e9:.3f}B f32 params, one step of "
        f"{TRAIN_ROWS} x {CUTOFF_LEN}; against AdamW (step "
        f"{adamw['step_ms']:.1f} ms, state {adamw['state_bytes'] / 1e9:.3f}"
        " GB): " + "; ".join(
            f"{n} step x{r['step_ms'] / adamw['step_ms']:.2f}, state "
            f"x{r['state_bytes'] / adamw['state_bytes']:.3f}"
            for n, r in results.items() if n != "adamw") + f" on {card}")
    log(f"optimizers (33d): wall s: the model and batch {setup_s:.1f}, each "
        "optimizer's step with its CPU check " + ", ".join(
            f"{n} {w:.1f}" for n, w in walls.items()))
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 34: the SFT leftovers and the native packing plane
# ---------------------------------------------------------------------------

# Qwen2-VL-2B's decoder as a Qwen2 text model at full width and depth
# (phase 31's model: f32 parameters, bf16 compute), 2 rows of 4096 packed
# text examples, every step from one state cloned.  The optimizer is SGD
# at learning rate 1, clipped at global norm 1: an update linear in the
# gradient (AdamW's first step is lr * sign(g) nearly, which reads the
# gradients' signs only), large enough that new - old keeps its f32 digits
SFT34_ROWS, SFT34_CUTOFF = 2, 4096
SFT34_OPT = dict(optimizer="sgd", learning_rate=1.0, schedule="constant",
                 warmup_steps=0, max_grad_norm=1.0)
SFT34_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_sft34")
# 34a: the knapsack timed over a seeded corpus of example lengths, and the
# whole packing over a seeded corpus of token examples
PACK_CORPUS, PACK_LENGTHS, PACK_TOKEN_EXAMPLES = 100_000, (16, 4096), 1000
# 34b-d: relative differences of the loss, the grad norm and, the largest
# over the watched leaves (the head, which is the tied embedding, and
# layer 0's q, k and v kernels), of a leaf's update (new - old)
# (about 3x the largest sound reading on the card: the fused step read 0,
# 7.904e-04 and 1.167e-02, JAX's design rounding dlogits to bf16)
SFT34_LIMITS = {"loss": 1e-4, "grad norm": 2.5e-3, "update": 3.5e-2}
SFT34_WATCHED = ("head", "layer 0 q", "layer 0 k", "layer 0 v")
# 34d: IterativeSFTTrainer's rows: texts of seeded words of the chain
# tokenizer (one id a word), the first row cut at max_length
ITER_MAX_LENGTH = 2048
ITER_TEXT_WORDS = ((2300, 1500), (1900, 2048))
ITER_PROMPT_LEN, ITER_ANSWER_LEN = 400, 1200


def check_packed_rows(rows, cutoff, pad_id) -> None:
    """The invariants of packed rows (tests/test_native_dataplane.py's):
    padding carries the pad id and IGNORE_INDEX labels, segments run 1, 2,
    ... from the row's start, each segment's positions count from 0."""
    for r in rows:
        segs, real = r["segment_ids"], r["segment_ids"] != 0
        n = int(real.sum())
        if (len(segs) != cutoff or real[n:].any()
                or (r["labels"][~real] != -100).any()
                or (r["input_ids"][~real] != pad_id).any()):
            raise AssertionError("a packed row's padding is not padding")
        for s in range(1, int(segs.max()) + 1):
            span = np.nonzero(segs == s)[0]
            if (len(span) == 0 or (np.diff(span) != 1).any()
                    or (r["position_ids"][span]
                        != np.arange(len(span))).any()):
                raise AssertionError(f"segment {s} of a packed row is not "
                                     "one run counted from 0")


def _rows_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        all(np.array_equal(ra[k], rb[k]) for k in (
            "input_ids", "labels", "segment_ids", "position_ids"))
        for ra, rb in zip(a, b))


def phase_packing(build_s: float) -> None:
    """34a: the native plane (built beside nvcc, ``build_s`` seconds)
    packs phase 34's rows, which keep the packed rows' invariants and
    equal its Python twin's; the knapsack over PACK_CORPUS seeded lengths
    and the whole packing of PACK_TOKEN_EXAMPLES seeded examples, native
    against the twin, in host ms."""
    from iadr1_tpu_torch.data import native
    from iadr1_tpu_torch.data.packing import greedy_knapsack, pack_examples

    examples = make_text_sft_examples(SFT34_ROWS, SFT34_CUTOFF, seed=37)
    t0 = time.perf_counter()
    rows = pack_examples(examples, SFT34_CUTOFF, ENDOFTEXT)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    twin = pack_examples(examples, SFT34_CUTOFF, ENDOFTEXT, use_native=False)
    twin_ms = 1e3 * (time.perf_counter() - t0)
    check_packed_rows(rows, SFT34_CUTOFF, ENDOFTEXT)
    if not _rows_equal(rows, twin):
        raise AssertionError("the native rows differ from the Python twin's")
    lib = native.load()
    rng = np.random.default_rng(38)
    lengths = rng.integers(PACK_LENGTHS[0], PACK_LENGTHS[1] + 1,
                           PACK_CORPUS).astype(np.int64)
    indices = np.zeros(PACK_CORPUS, np.int64)
    sizes = np.zeros(PACK_CORPUS, np.int64)
    t0 = time.perf_counter()
    n_bins = lib.greedy_knapsack(native.as_i64(lengths), PACK_CORPUS,
                                 PACK_LENGTHS[1], native.as_i64(indices),
                                 native.as_i64(sizes))
    knap_native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    bins = greedy_knapsack(lengths.tolist(), PACK_LENGTHS[1])
    knap_twin_ms = 1e3 * (time.perf_counter() - t0)
    starts = np.concatenate([[0], np.cumsum(sizes[:n_bins])])
    native_bins = [lengths[indices[a:b]].tolist()
                   for a, b in zip(starts[:-1], starts[1:])]
    if native_bins != bins:
        raise AssertionError("the native knapsack's bins differ from the "
                             "twin's")
    corpus = [{"input_ids": ids, "labels": ids} for ids in (
        rng.integers(0, ENDOFTEXT, int(n)).tolist() for n in rng.integers(
            PACK_LENGTHS[0], PACK_LENGTHS[1] + 1, PACK_TOKEN_EXAMPLES))]
    t0 = time.perf_counter()
    packed = pack_examples(corpus, PACK_LENGTHS[1], ENDOFTEXT)
    corpus_native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    packed_twin = pack_examples(corpus, PACK_LENGTHS[1], ENDOFTEXT,
                                use_native=False)
    corpus_twin_ms = 1e3 * (time.perf_counter() - t0)
    if not _rows_equal(packed, packed_twin):
        raise AssertionError("the corpus's native rows differ from the "
                             "twin's")
    log(f"sft34 packing: the native plane built in {build_s:.2f} s (c++ "
        f"-O3, beside nvcc); phase 34's {len(examples)} examples into "
        f"{len(rows)} rows of {SFT34_CUTOFF} (segments "
        f"{[int(r['segment_ids'].max()) for r in rows]}), equal to the "
        f"Python twin's, the invariants held; host ms (this machine's "
        f"CPU, not the card): those rows native {native_ms:.2f}, twin "
        f"{twin_ms:.2f}; the knapsack of {PACK_CORPUS} lengths in "
        f"{PACK_LENGTHS[0]}-{PACK_LENGTHS[1]} into {n_bins} bins native "
        f"{knap_native_ms:.1f}, twin {knap_twin_ms:.1f}; the packing of "
        f"{PACK_TOKEN_EXAMPLES} such examples "
        f"({sum(len(c['input_ids']) for c in corpus)} tokens) into "
        f"{len(packed)} rows native {corpus_native_ms:.1f}, twin "
        f"{corpus_twin_ms:.1f}")


def phase_kernels_sft_extras(rows):
    """Phase 3 at phase 34's shape: K1-K3 over its two packed rows of 4096
    (12 heads over 2, D = 128, causal, one segment an example)."""
    segs = torch.as_tensor(np.stack([r["segment_ids"] for r in rows]),
                           device="cuda", dtype=torch.int32)
    T = segs.shape[1]
    shape = (len(rows), 12, 2, T, T, 128, True, segs, segs)
    results = _labelled((*bwd_case(*shape, 179, timed=True),
                         flash_case(*shape, 180, timed=True)),
                        "sft34 packed rows")
    bwd = [results[:3]]
    fwd = [results[3], results[2]]
    log_kernel_results(fwd, [], bwd)
    return {"flash_fwd": fwd, "flash_bwd_dq": [results[0]],
            "flash_bwd_dkv": [results[1]], "decode_attention": []}


def _sft34_watched(params) -> dict:
    attn = params["layers"]["attn"]
    return {"head": params["embed"]["weight"],
            **{f"layer 0 {n}": attn[n]["kernel"][0] for n in "qkv"}}


def _sft34_diffs(got, ref, limits=SFT34_LIMITS) -> dict:
    (m, upd), (m0, upd0) = got, ref
    out = {"loss": abs(m["loss"] - m0["loss"]) / abs(m0["loss"]),
           "grad norm": abs(m["grad_norm"] - m0["grad_norm"])
           / m0["grad_norm"]}
    if "update" in limits:
        out["update"] = max(float((upd[n] - upd0[n]).norm()
                                  / upd0[n].norm()) for n in upd0)
    return out


def phase_sft_extras(rows, build_s: float, card):
    """Phase 34: the SFT leftovers on the card.  34a the native plane
    (``phase_packing``); then Qwen2-VL-2B's decoder as a Qwen2 text model
    (28 layers, f32 parameters drawn once, bf16 compute), each step from a
    clone of that one state on the same batch of 2 packed rows of 4096:
    34b make_chunked_sft_step with fused_ce=True against fused_ce=False
    (loss, grad norm, the watched leaves' updates; the chunked step runs
    again, warm, for its time and its reading against itself), with two
    controls that change the fused CE's arithmetic (its 1 / n_tokens
    dropped; its label mask dropped, the loss kept) that must fail; 34c
    make_sft_step over
    the [2, 4096, 151936] f32 logits against the chunked step; 34d
    IterativeSFTTrainer, two steps from texts (the chain tokenizer) and one
    from input_ids with a masked prompt, its first step against
    make_chunked_sft_step on the same padded batch.  K1-K3 once a layer a
    step, counted.  Returns the launch counts."""
    import gc

    from transformers import AutoTokenizer

    from iadr1_tpu_torch.data.collator import text_batch
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train import IterativeSFTTrainer, make_sft_step
    from iadr1_tpu_torch.train import sft
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state

    kernels = [k for k, _ in all_kernels()]
    for k in kernels:
        k.launches = 0
    phase_packing(build_s)
    hf = qwen2_vl_text_hf()
    bundle = bundle_from_hf_config(hf)
    L = bundle.cfg.num_hidden_layers
    opt_cfg = OptimizerConfig(**SFT34_OPT)
    batch = text_batch(rows)
    base = bundle.init_params(seed=0, dtype=torch.float32, device=DEVICE)
    n_params = sum(p.numel() for p in _leaves(base))
    before = {n: t.detach().clone() for n, t in _sft34_watched(base).items()}
    timings, n_steps = {}, [0]

    def fresh():
        opt, sched = make_optimizer(opt_cfg)
        return create_train_state(_clone_tree(base), opt), opt, sched

    def run(label, make_step, batch=batch):
        """One step from a clone of the state: (metrics, the watched
        leaves' updates); its ms and peak memory kept under ``label``."""
        state, opt, sched = fresh()
        step = make_step(opt, sched)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        timings[label] = (1e3 * (time.perf_counter() - t0),
                          torch.cuda.max_memory_allocated() / GIB)
        n_steps[0] += 1
        m = {k: float(v) for k, v in m.items()}
        upd = {n: (t.detach() - before[n]) for n, t in
               _sft34_watched(state.params).items()}
        del state
        return m, upd

    def chunked(fused, **kw):
        return lambda opt, sched: sft.make_chunked_sft_step(
            bundle.hidden_fn, bundle.head_kernel_fn, opt, sched,
            chunk_size=CE_CHUNK, fused_ce=fused, **kw)

    # 34b: the fused CE against the chunked CE, then the controls; the
    # chunked step runs again after the fused one, warm, for its time and
    # for the reading of one step against itself
    ref = run("chunked", chunked(False))
    fused = run("fused", chunked(True))
    again = _sft34_diffs(run("chunked, again", chunked(False)), ref)
    diffs = _sft34_diffs(fused, ref)
    fused_ce = sft._fused_ce

    def unscaled(hidden, kernel, labels, chunk, dtype, want, vocab=None):
        loss, correct, n, dh, dk = fused_ce(hidden, kernel, labels, chunk,
                                            dtype, want, vocab)
        scale = n.clamp(min=1)
        return loss, correct, n, dh * scale, dk * scale

    def unmasked(hidden, kernel, labels, chunk, dtype, want, vocab=None):
        loss, correct, n, _, _ = fused_ce(hidden, kernel, labels, chunk,
                                          dtype, False, vocab)
        every = torch.where(labels == -100, 0, labels)
        _, _, n_all, dh, dk = fused_ce(hidden, kernel, every, chunk, dtype,
                                       want, vocab)
        scale = n_all / n.clamp(min=1)       # back to 1 / n_tokens
        return loss, correct, n, dh * scale, dk * scale

    controls = {}
    for name, fn in (("1 / n_tokens dropped", unscaled),
                     ("label mask dropped", unmasked)):
        sft._fused_ce = fn
        try:
            controls[name] = _sft34_diffs(run(f"control: {name}",
                                              chunked(True)), ref)
        finally:
            sft._fused_ce = fused_ce
    margins = "; ".join(
        f"{name}: " + ", ".join(f"{k} {v / SFT34_LIMITS[k]:.3f}"
                                for k, v in c.items())
        for name, c in controls.items())
    log(f"sft34 fused ce: fused vs chunked step: loss {fused[0]['loss']:.6f} "
        f"vs {ref[0]['loss']:.6f}, grad norm {fused[0]['grad_norm']:.6f} vs "
        f"{ref[0]['grad_norm']:.6f}; {_diff_text(diffs, SFT34_LIMITS)}; "
        f"the chunked step again: {_diff_text(again, SFT34_LIMITS)}; the "
        "controls' margins (reading / limit, above 1 fails): " + margins)
    if not (_within(diffs, SFT34_LIMITS) and _within(again, SFT34_LIMITS)):
        raise AssertionError("the fused CE's step differs from the chunked "
                             "CE's")
    for name, c in controls.items():
        if _within(c, SFT34_LIMITS):
            raise AssertionError(f"the limits do not catch the fused CE "
                                 f"with its {name}")
    del fused
    # 34c: the unchunked step over the full logits
    full = run("unchunked", lambda opt, sched: make_sft_step(
        bundle.forward, opt, sched))
    full_limits = {k: SFT34_LIMITS[k] for k in ("loss", "grad norm")}
    full_diffs = _sft34_diffs(full, ref, full_limits)
    log(f"sft34 make_sft_step: unchunked vs chunked step: loss "
        f"{full[0]['loss']:.6f} vs {ref[0]['loss']:.6f}, grad norm "
        f"{full[0]['grad_norm']:.6f} vs {ref[0]['grad_norm']:.6f}; "
        f"{_diff_text(full_diffs, full_limits)} (the update, not held: "
        f"{_sft34_diffs(full, ref)['update']:.3e})")
    if not _within(full_diffs, full_limits):
        raise AssertionError("make_sft_step differs from the chunked step")
    del full, ref
    # 34d: IterativeSFTTrainer
    tok_dir = os.path.join(SFT34_DIR, "tokenizer")
    write_chain_tokenizer(tok_dir, hf["vocab_size"])
    tok = AutoTokenizer.from_pretrained(tok_dir)
    rng = np.random.default_rng(39)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(1, ENDOFTEXT, n))

    texts = [[words(n) for n in lens] for lens in ITER_TEXT_WORDS]
    prompt = rng.integers(1, ENDOFTEXT, ITER_PROMPT_LEN).tolist()
    answer = rng.integers(1, ENDOFTEXT, ITER_ANSWER_LEN).tolist()
    ids = [prompt + answer, answer]
    labels = [[-100] * len(prompt) + answer, answer]
    # trl's padded batch of the first texts, built here as the JAX trainer
    # builds it
    enc = [tok.encode(t, add_special_tokens=False)[:ITER_MAX_LENGTH]
           for t in texts[0]]
    T = max(len(x) for x in enc)
    padded = {"input_ids": np.full((2, T), tok.pad_token_id, np.int32),
              "labels": np.full((2, T), -100, np.int32),
              "segment_ids": np.zeros((2, T), np.int32),
              "position_ids": np.broadcast_to(np.arange(T, dtype=np.int32),
                                              (2, T)).copy()}
    for i, x in enumerate(enc):
        padded["input_ids"][i, :len(x)] = x
        padded["labels"][i, :len(x)] = x
        padded["segment_ids"][i, :len(x)] = 1
    direct = run("iterative: make_chunked_sft_step", chunked(False),
                 batch=padded)
    state, opt, sched = fresh()
    trainer = IterativeSFTTrainer(bundle, tok, opt, sched, state=state,
                                  max_length=ITER_MAX_LENGTH,
                                  ce_chunk=CE_CHUNK)
    del state
    history = []
    for i, kw in enumerate((dict(texts=texts[0]), dict(texts=texts[1]),
                            dict(input_ids=ids, labels=labels))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history.append(trainer.step(**kw))
        torch.cuda.synchronize()
        timings[f"iterative step {i + 1}"] = (
            1e3 * (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / GIB)
        n_steps[0] += 1
    del trainer
    iter_diffs = _sft34_diffs((history[0], None), (direct[0], None),
                              full_limits)
    log(f"sft34 iterative trainer: losses "
        f"{[round(h['loss'], 4) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, label tokens "
        f"{[int(h['n_label_tokens']) for h in history]}; step 1 vs "
        f"make_chunked_sft_step on the same padded batch: "
        f"{_diff_text(iter_diffs, full_limits)}")
    if not _within(iter_diffs, full_limits):
        raise AssertionError("IterativeSFTTrainer's step differs from "
                             "make_chunked_sft_step's")
    want_labels = [int((padded["labels"][:, 1:] != -100).sum()), None,
                   2 * ITER_ANSWER_LEN - 1]
    if (history[0]["n_label_tokens"] != want_labels[0]
            or history[2]["n_label_tokens"] != want_labels[2]
            or not all(math.isfinite(h[k]) for h in history
                       for k in ("loss", "grad_norm"))):
        raise AssertionError(f"the trainer's steps: {history}")
    del base, before, direct
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k.name: k.launches for k in kernels}
    steps = n_steps[0]
    want = {"flash_fwd": steps * L, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"sft34 launches {launches}, want {want}")
    log(f"sft34: Qwen2-VL-2B's decoder as Qwen2, {n_params / 1e9:.3f}B f32 "
        f"params, {steps} steps of {SFT34_ROWS}x{SFT34_CUTOFF} tokens (the "
        f"trainer's of 2x{ITER_MAX_LENGTH}), each from a clone of one "
        "state; step ms and peak GiB: " + ", ".join(
            f"{k} {ms:.1f} ({gib:.2f})" for k, (ms, gib) in timings.items())
        + f"; launches {launches} on {card}")
    return launches


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


# ---------------------------------------------------------------------------
# phase 35: the mesh
# ---------------------------------------------------------------------------

MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_mesh")
# (a) the kernels' sharding rule on the card, each mesh's shards run one
# after another: K1 and K2 + K3 (dlse != 0) at phase 6's decoder heads
# (12 over 2, D = 128) on 4 rows of 1024 in two packed segments that end
# early, and K4 over 8 fanned-out rows of a 1600-slot cache; (2, 1, 1)
# takes 3 rows, which dp does not divide
MESH_RULE_MESHES = ((2, 2, 2), (1, 4, 2), (2, 1, 1))
MESH_RULE_SHAPE = dict(H=12, Hkv=2, T=1024, D=128)
MESH_RULE_ROWS = {(2, 1, 1): 3}
MESH_RULE_B = 4
MESH_DECODE = dict(B=8, H=12, Hkv=2, S=1600, D=128, length=1100)
# (c) and (d): cli/train_sft.py and cli/train_grpo.py under a one-rank
# NCCL group set up as torchrun sets it, against the same runs with no
# group (one process, plain tensors); SC-GRPO's completions cut to 64
MESH_SFT_STEPS, MESH_GRPO_N = 2, 64
# the group's step metrics against the one-process run's: the same
# arithmetic on the same rank (the DTensors' local shards are the whole
# leaves, the global norm one all-reduce over one rank), bitwise in every
# run so far
MESH_METRIC_REL = 1e-6


def rule_inputs(B, seed):
    """q, k, v, segments, dO and dlse at MESH_RULE_SHAPE with B rows."""
    s = MESH_RULE_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = dict(device=DEVICE, dtype=torch.bfloat16)
    T = s["T"]
    q = torch.randn((B, s["H"], T, s["D"]), generator=gen, **dev)
    k = torch.randn((B, s["Hkv"], T, s["D"]), generator=gen, **dev)
    v = torch.randn((B, s["Hkv"], T, s["D"]), generator=gen, **dev)
    do = torch.randn((B, s["H"], T, s["D"]), generator=gen, **dev)
    dlse = torch.randn((B, s["H"], T), generator=gen, device=DEVICE)
    seg = torch.ones((B, T), dtype=torch.int32, device=DEVICE)
    seg[:, T // 2:] = 2
    for b in range(B):
        seg[b, T - 37 * (b + 1):] = 0
    return q, k, v, seg, do, dlse


def flash_call(q, k, v, seg, do, dlse, causal=True):
    """K1, then K2 + K3 through the flash Function with both cotangents:
    (out, lse, dq, dk, dv)."""
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in (q, k, v))
    out, lse = flash_attention(q, k, v, segment_ids=seg.contiguous(),
                               kv_segment_ids=seg.contiguous(), causal=causal)
    dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v),
                                     (do.contiguous(), dlse.contiguous()))
    return out.detach(), lse.detach(), dq, dk, dv


def sharded_flash(slices, q, k, v, seg, do, dlse, causal=True):
    """``flash_call`` shard by shard ((batch rows, heads, KV heads) each),
    the results put back in place."""
    out, dq = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b, h, hk in slices:
        res = flash_call(q[b, h], k[b, hk], v[b, hk], seg[b], do[b, h],
                         dlse[b, h], causal)
        for dst, part, heads in zip((out, lse, dq, dk, dv), res,
                                    (h, h, h, hk, hk)):
            dst[b, heads] = part
    return out, lse, dq, dk, dv


def decode_inputs(seed):
    s = MESH_DECODE
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = dict(device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn((s["B"], s["H"], s["D"]), generator=gen, **dev)
    k = torch.randn((s["B"], s["Hkv"], s["S"], s["D"]), generator=gen, **dev)
    v = torch.randn((s["B"], s["Hkv"], s["S"], s["D"]), generator=gen, **dev)
    seg = torch.ones((s["B"], s["S"]), dtype=torch.int32, device=DEVICE)
    for b in range(s["B"]):
        seg[b, :13 * b] = 0                      # left padding
    return q, k, v, seg


def phase_mesh_rule() -> None:
    """Phase 35a and 35b: K1-K4 under ``mesh_batch_heads`` for the
    virtual meshes of MESH_RULE_MESHES, each mesh's shards (the unsharded
    kernel on fewer rows or heads) run one after another on the card,
    bitwise equal to the unsharded launch and within phase 3's limits of
    the plain versions; the control, tp splitting the query heads but not
    the KV heads, must break the bitwise check."""
    from iadr1_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )
    from iadr1_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        mesh_batch_heads,
        shard_slices,
    )

    names = ("out", "lse", "dq", "dk", "dv")
    for shape in MESH_RULE_MESHES:
        sizes = dict(zip(("dp", "fsdp", "tp"), shape))
        B = MESH_RULE_ROWS.get(shape, MESH_RULE_B)
        q, k, v, seg, do, dlse = rule_inputs(B, seed=41)
        H, Hkv = q.shape[1], k.shape[1]
        whole = flash_call(q, k, v, seg, do, dlse)
        slices = shard_slices(sizes, B, H, Hkv)
        shards = sharded_flash(slices, q, k, v, seg, do, dlse)
        unequal = [n for n, a, b in zip(names, shards, whole)
                   if not torch.equal(a, b)]
        if unequal:
            raise AssertionError(f"mesh rule {shape}: {unequal} of the "
                                 "shards differ from the unsharded launch")
        scale = q.shape[-1] ** -0.5
        ref_out, ref_lse = plain(flash_attention_ref, q, k, v, seg, seg,
                                 causal=True, scale=scale)
        refs = plain(flash_attention_bwd_ref, q, k, v, seg, seg, ref_out,
                     ref_lse, do, dlse, causal=True, scale=scale)
        live = (seg != 0)[:, None, :, None]
        errs = [check_close("rule out", whole[0], ref_out, **OUT_TOL),
                max_err(torch.where(live[..., 0], whole[1], 0.0),
                        torch.where(live[..., 0], ref_lse, 0.0))]
        if errs[1] > LSE_ATOL:
            raise AssertionError(f"mesh rule {shape}: lse {errs[1]:.3e}")
        for name, got, ref in zip(names[2:], whole[2:], refs):
            errs.append(check_close(
                f"rule {name}", got, ref, atol=BWD_ATOL_FRAC * float(
                    ref.float().abs().max()), rtol=BWD_RTOL))

        dq_, dk_, dv_, dseg = decode_inputs(seed=42)
        length = MESH_DECODE["length"]
        dec = decode_attention(dq_, dk_, dv_, dseg, length)
        dec_shards = torch.empty_like(dec)
        dslices = shard_slices(sizes, *dq_.shape[:2], dk_.shape[1])
        for b, h, hk in dslices:
            dec_shards[b, h] = decode_attention(
                dq_[b, h].contiguous(), dk_[b, hk].contiguous(),
                dv_[b, hk].contiguous(), dseg[b].contiguous(), length)
        if not torch.equal(dec_shards, dec):
            raise AssertionError(f"mesh rule {shape}: K4's shards differ "
                                 "from the unsharded launch")
        errs.append(check_close("rule decode", dec, decode_attention_ref(
            dq_, dk_, dv_, dseg, length, scale=dq_.shape[-1] ** -0.5),
            **OUT_TOL))
        rule = mesh_batch_heads(sizes, B, H, Hkv)
        log(f"mesh rule {shape}: B={B} H={H} Hkv={Hkv} -> batch axes "
            f"{rule[0]}, head axis {rule[1]}: {len(slices)} K1-K3 shards "
            f"({[(b.stop - b.start, h.stop - h.start) for b, h, _ in slices]}"
            f" rows x heads) and {len(dslices)} K4 shards, each bitwise "
            f"equal to the unsharded launch; against the plain versions "
            f"out {errs[0]:.3e}, lse {errs[1]:.3e}, dq {errs[2]:.3e}, dk "
            f"{errs[3]:.3e}, dv {errs[4]:.3e}, K4 {errs[5]:.3e}")

    # the control: tp = 2 on the query heads alone breaks the GQA group
    B = MESH_RULE_B
    q, k, v, seg, do, dlse = rule_inputs(B, seed=41)
    H, Hkv = q.shape[1], k.shape[1]
    whole = flash_call(q, k, v, seg, do, dlse)
    broken = [(slice(0, B), slice(0, H // 2), slice(0, Hkv)),
              (slice(0, B), slice(H // 2, H), slice(0, Hkv))]
    shards = sharded_flash(broken, q, k, v, seg, do, dlse)
    differ = [n for n, a, b in zip(names, shards, whole)
              if not torch.equal(a, b)]
    if not differ:
        raise AssertionError("mesh rule control: splitting H but not Hkv "
                             "passed the bitwise check")
    log(f"mesh rule control (tp splitting the 12 query heads but not the "
        f"2 KV heads): {differ} differ from the unsharded launch, as they "
        f"must; out max err {max_err(shards[0], whole[0]):.3e}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MeshTap:
    """Patches for one CLI run of phases 35 and 37: the rows or examples
    handed in (no dataset is tokenized), the canned tokenizer, each step's
    metrics and the train state (with its starting parameters) recorded,
    each rollout's tokens and time recorded, the checkpoint written or
    not, and the SFT step made with the fused CE or not."""

    def __init__(self, rows=None, examples=None, save=True,
                 keep_state=False, fused_ce=False):
        from iadr1_tpu_torch.cli import train_grpo, train_sft
        from iadr1_tpu_torch.train import grpo, sft, state
        from iadr1_tpu_torch.train.checkpoint import CheckpointManager
        from iadr1_tpu_torch.train.rollout import RolloutEngine
        import transformers

        self.metrics, self.states, self.rollouts = [], [], []
        self.step_s, self._undo, self.initial = [], [], []

        def patch(obj, name, value):
            self._undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

        patch(train_sft, "prepare_rows", lambda *a, **k: rows)
        patch(train_sft, "load_tokenizer", lambda path: None)
        patch(train_grpo, "encode_rl_examples", lambda *a, **k: examples)
        patch(transformers.AutoTokenizer, "from_pretrained",
              staticmethod(lambda *a, **k: CannedTokenizer()))
        make_step, create, trainer_step, generate = (
            sft.make_chunked_sft_step, state.create_train_state,
            grpo.GRPOTrainer.step, RolloutEngine.generate)

        def make_chunked_sft_step(*a, **kw):
            step = make_step(*a, **(dict(kw, fused_ce=True) if fused_ce
                                    else kw))

            def recorded(st, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, batch)
                self.metrics.append({k: float(v) for k, v in m.items()})
                self.step_s.append(time.perf_counter() - t0)
                return st, m
            return recorded

        def create_train_state(params, optimizer):
            st = create(params, optimizer)
            if keep_state:
                from iadr1_tpu_torch.core.mesh import full
                from iadr1_tpu_torch.train.state import named_leaves

                self.states.append(st)
                # the parameters as they start (whole), before any step
                self.initial.append({n: full(t).detach().clone()
                                     for n, t in named_leaves(st.params)})
            return st

        def step(trainer, examples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trainer_step(trainer, examples)
            self.metrics.append(dict(out))
            self.step_s.append(time.perf_counter() - t0)
            return out

        def timed_generate(engine, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(engine, *a, **kw)
            torch.cuda.synchronize()
            self.rollouts.append((out["completion_ids"].cpu(),
                                  time.perf_counter() - t0,
                                  out["num_decode_steps"]))
            return out

        patch(sft, "make_chunked_sft_step", make_chunked_sft_step)
        patch(state, "create_train_state", create_train_state)
        patch(grpo.GRPOTrainer, "step", step)
        patch(RolloutEngine, "generate", timed_generate)
        if not save:
            patch(CheckpointManager, "save",
                  lambda self, step, state, metadata=None: False)

    def close(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)


def mesh_cli(module, cfg, name, **tap_kw) -> MeshTap:
    """One call of a training CLI's ``main`` on ``cfg`` under a MeshTap."""
    import gc
    import importlib

    path = os.path.join(MESH_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    main = importlib.import_module(f"iadr1_tpu_torch.cli.{module}").main
    tap = MeshTap(**tap_kw)
    try:
        code = main(["--config", path, "--device", DEVICE])
    finally:
        tap.close()
        gc.collect()
        torch.cuda.empty_cache()
    if code != 0:
        raise AssertionError(f"{module} exited with {code}")
    return tap


def mesh_sft_cfg(name) -> dict:
    """cli/train_sft.py on Qwen2-VL-2B from model.hf_config and seed 0,
    f32, phase 6's setting (its rows handed in by the tap)."""
    return {"model": {"model_name_or_path": MESH_DIR,
                      "hf_config": QWEN2_VL_2B, "seed": 0,
                      "dtype": "float32", "remat": "true"},
            "data": {"dataset": "phase 6 rows", "cutoff_len": CUTOFF_LEN,
                     "patch_budget": PATCH_BUDGET, "ce_chunk": CE_CHUNK},
            "optim": {"learning_rate": LEARNING_RATE, "schedule": "cosine",
                      "warmup_ratio": 0.1, "total_steps": MESH_SFT_STEPS,
                      "max_grad_norm": 1.0},
            "train": {"output_dir": os.path.join(MESH_DIR, name),
                      "max_steps": MESH_SFT_STEPS, "batch_size": TRAIN_ROWS,
                      "logging_steps": 1, "save_steps": 0, "seed": 0}}


def mesh_grpo_cfg(name) -> dict:
    """cli/train_grpo.py's defaults on Qwen2-VL-2B from model.hf_config and
    seed 0 (f32 policy, bf16 reference), phase 7's prompts handed in by
    the tap, completions of MESH_GRPO_N, one step."""
    data = os.path.join(MESH_DIR, "rl.json")
    with open(data, "w") as f:
        json.dump([{"image": "x.png", "problem": "p", "solution": s}
                   for s in GRPO_SOLUTIONS[:GRPO_PROMPTS]], f)
    return {"model": {"model_name_or_path": MESH_DIR,
                      "hf_config": QWEN2_VL_2B, "seed": 0,
                      "dtype": "float32"},
            "data": {"dataset_name": data, "image_path": MESH_DIR,
                     "patch_budget": GRPO_PATCH_BUDGET},
            "grpo": {"max_completion_length": MESH_GRPO_N},
            "optim": {"learning_rate": GRPO_LEARNING_RATE,
                      "total_steps": 100},
            "train": {"output_dir": os.path.join(MESH_DIR, name),
                      "max_steps": 1, "batch_size": GRPO_PROMPTS,
                      "logging_steps": 1, "save_steps": 0, "seed": 0}}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_decode(examples, mesh) -> dict:
    """Phase 35d's comparison of the rollout's two designs on a group:
    Qwen2-VL-2B's bf16 policy from seed 0 decodes phase 7's prompts (G =
    4, N = MESH_GRPO_N) as a plain copy (what SC-GRPO's rollout takes on
    a mesh: the parameters gathered whole) and as DTensors over the tp
    submesh of ``mesh`` (every op through DTensor's dispatch, the KV cache
    whole on each rank), from the same generator.  Returns the tokens'
    equality and each design's ms a decode step (prefill included)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from iadr1_tpu_torch.cli.train_grpo import (
        GRPODataSection,
        make_vlm_prompt_collator,
    )
    from iadr1_tpu_torch.core.mesh import logical_to_mesh_axes, tp_submesh
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.grpo import sampling_generator
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
    from iadr1_tpu_torch.train.sft import batch_to_device

    bundle = bundle_from_hf_config(QWEN2_VL_2B)
    G, P = 4, 1024
    collate = make_vlm_prompt_collator(
        bundle, CannedTokenizer(), None,
        GRPODataSection(patch_budget=GRPO_PATCH_BUDGET), P,
        num_generations=G)
    batch = batch_to_device(collate(examples, 1), DEVICE)
    engine = RolloutEngine(
        bundle, SamplingConfig(max_new_tokens=MESH_GRPO_N, eos_token_id=-1,
                               pad_token_id=ENDOFTEXT),
        max_len=P + MESH_GRPO_N, device=DEVICE)
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    tp = tp_submesh(mesh)

    def place(t, logical):
        axes = logical_to_mesh_axes(logical, mesh_axes=("tp",))
        return distribute_tensor(t, tp, list(axes), src_data_rank=None)

    def tree(node, logical):
        if isinstance(node, dict):
            return {k: tree(v, logical[k]) for k, v in node.items()}
        return place(node, logical)

    dparams = tree(params, bundle.logical_axes())
    out = {}
    for name, p, scope in (
            ("plain", params, contextlib.nullcontext),
            ("dtensor", dparams, implicit_replication),
            ("plain again", params, contextlib.nullcontext)):
        with scope():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.generate(p, batch, sampling_generator(0, 0, DEVICE),
                                  group_size=G)
            torch.cuda.synchronize()
        steps = res["num_decode_steps"]
        out[name] = (res["completion_ids"].cpu(),
                     1e3 * (time.perf_counter() - t0) / max(steps, 1), steps)
    del params, dparams
    return out


# (e) the preference launcher's and the fused CE's mesh paths on the same
# group: KTO (its KL rows collated over the whole batch), PPO (the value
# head, 2 minibatches of 1, the whitening), Nash-MD (two rollout copies,
# the mixture) and GKD (a sharded teacher, on-policy) through
# cli/train_pref.py on phase 32's datasets and settings, and the fused-CE
# step through cli/train_sft.py on 2 text rows of 2048, one step each at
# Qwen2-VL-2B's widths, the decoder cut to 4 of its 28 layers and the
# tower, which no text row reads, to 1 of its 32 blocks (the smoke's
# time); completions of 32 new tokens
MESH_PREF_LAYERS, MESH_PREF_N = 4, 32
MESH_FUSED_ROWS, MESH_FUSED_CUTOFF = 2, 2048
# the fused CE's vocabulary-sharded loop (tp > 1) at Qwen2-VL-2B's head,
# the tp ranks one after another on the card, against one rank's loop
# on the same rows: the loss's relative difference and d_hidden's and
# d_W's largest differences over their largest magnitudes (the reduction
# order differs: a max and a sum where one rank takes the logsumexp
# whole); the correct and label counts exactly.  The limits are about 3x
# the card's readings (loss 0, d_hidden 2.701e-06, d_W 6.627e-08; the
# loss's a few f32 ulps); the control that drops the last rank's sums
# read 1.430e-02, 2.006e-02 and 6.973e-04
MESH_FUSED_TP = 2
MESH_FUSED_VOCAB_LIMITS = {"loss": 1e-6, "d_hidden": 8e-6, "d_W": 2e-7}
# (stage, pref overrides, ppo section, the step's forwards and backwards
# beside its rollouts as pref_launches counts them)
MESH_PREF_STAGES = (
    ("kto", {}, None, (4, 1)),
    # the experience pass (policy, reference), then 2 minibatch updates
    ("ppo", {}, {"max_completion_length": MESH_PREF_N, "ppo_epochs": 1,
                 "mini_batch_size": 1}, (2 + 2, 2)),
    ("nash_md", {"max_completion_length": MESH_PREF_N}, None, (2, 1)),
    ("gkd", {"max_completion_length": MESH_PREF_N, "gkd_lmbda": 1.0}, None,
     (2, 1)),
)


def mesh_pref_hf() -> dict:
    return dict(QWEN2_VL_2B,
                text_config=dict(QWEN2_VL_2B["text_config"],
                                 num_hidden_layers=MESH_PREF_LAYERS),
                vision_config=dict(QWEN2_VL_2B["vision_config"], depth=1))


def mesh_pref_teacher() -> str:
    """GKD's teacher: mesh_pref_hf's model from seed 1 in bf16, written
    once under MESH_DIR as an HF checkpoint (read in the student's f32)."""
    from iadr1_tpu_torch.models.params_export import save_pretrained
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    path = os.path.join(MESH_DIR, "teacher")
    if not os.path.exists(os.path.join(path, "model.safetensors")):
        bundle = bundle_from_hf_config(mesh_pref_hf())
        save_pretrained(bundle, bundle.init_params(
            seed=1, dtype=torch.bfloat16, device=DEVICE), path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(mesh_pref_hf(), f)
    return path


def mesh_pref_cfg(name, stage, pref, ppo) -> str:
    """Phase 32's launcher config for ``stage`` (its tokenizer, datasets,
    batch and cutoff) at mesh_pref_hf, one step; returns its path."""
    tok_dir, data = pref_assets()
    pref = dict(pref, ref_dtype="bfloat16")
    if stage == "gkd":
        pref["teacher_model_name_or_path"] = mesh_pref_teacher()
    cfg = {"stage": stage,
           "model": {"model_name_or_path": tok_dir,
                     "hf_config": mesh_pref_hf(), "seed": 0,
                     "dtype": "float32"},
           "data": {"dataset_name": data[PREF_DATA[stage]],
                    "template": "qwen2_vl", "cutoff_len": PREF_CUTOFF},
           "pref": pref, "ppo": ppo or {},
           "optim": {"learning_rate": PREF_LEARNING_RATE,
                     "warmup_ratio": 0.0, "total_steps": 100},
           "train": {"output_dir": os.path.join(MESH_DIR, name),
                     "max_steps": 1, "batch_size": PREF_BATCH,
                     "logging_steps": 1, "save_steps": 0, "seed": 0}}
    path = os.path.join(MESH_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def mesh_fused_cfg(name) -> dict:
    """cli/train_sft.py at mesh_pref_hf from seed 0, f32, phase 6's
    optimizer with no warm-up (its one step moves the parameters), one
    step (the rows handed in by the tap)."""
    return {"model": {"model_name_or_path": MESH_DIR,
                      "hf_config": mesh_pref_hf(), "seed": 0,
                      "dtype": "float32", "remat": "true"},
            "data": {"dataset": "text rows", "cutoff_len": MESH_FUSED_CUTOFF,
                     "ce_chunk": CE_CHUNK},
            "optim": {"learning_rate": LEARNING_RATE, "schedule": "cosine",
                      "warmup_ratio": 0.0, "total_steps": 10,
                      "max_grad_norm": 1.0},
            "train": {"output_dir": os.path.join(MESH_DIR, name),
                      "max_steps": 1, "batch_size": MESH_FUSED_ROWS,
                      "logging_steps": 1, "save_steps": 0, "seed": 0}}


def mesh_pref_runs(kernels, side: str) -> dict:
    """Phase 35e's five runs, each one step from a fresh launch (on the
    group when one is set up): {label: {"metrics", "tokens" (each
    rollout's completions), "launches", "want" (the launches the step's
    path implies), "kinds" (whether the state's leaves, its heads among
    them, and the teacher are DTensors), "s"}}."""
    from iadr1_tpu_torch.data.packing import pack_examples

    out = {}
    for stage, pref, ppo, fwd_bwd in MESH_PREF_STAGES:
        path = mesh_pref_cfg(f"{stage}_{side}", stage, pref, ppo)
        t0 = time.perf_counter()
        tap = run_pref(path, kernels, probe=False)
        rec, = tap.records
        out[stage] = {
            "metrics": rec["metrics"], "launches": rec["launches"],
            "tokens": [r["completion_ids"].cpu() for r in
                       tap.first_rollouts],
            "want": pref_launches(stage, MESH_PREF_LAYERS, rec["rollouts"],
                                  fwd_bwd),
            "kinds": tap.leaf_kinds, "s": time.perf_counter() - t0}
        del tap
    rows = pack_examples(
        make_text_sft_examples(MESH_FUSED_ROWS, MESH_FUSED_CUTOFF, seed=38),
        MESH_FUSED_CUTOFF, ENDOFTEXT, use_native=False)[:MESH_FUSED_ROWS]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    tap = mesh_cli("train_sft", mesh_fused_cfg(f"fused_{side}"),
                   f"fused_{side}", rows=rows, save=False, keep_state=True,
                   fused_ce=True)
    L = MESH_PREF_LAYERS
    out["fused_ce"] = {
        "metrics": tap.metrics[0], "tokens": [],
        "launches": {k.name: k.launches for k in kernels},
        "want": {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                 "decode_attention": 0},
        "kinds": {"state": [all_dtensors(st.params) for st in tap.states],
                  "teacher": []},
        "s": time.perf_counter() - t0}
    del tap
    return out


def check_mesh_pref(group: dict, one: dict, card) -> dict:
    """Phase 35e's checks of the group runs against the runs with no
    group: every metric and completion bitwise, every state (heads
    included) and the teacher DTensors, the launches as predicted.
    Returns the group runs' launches summed."""
    total = {}
    for label, g in group.items():
        o = one[label]
        if g["metrics"] != o["metrics"]:
            worst = {k: _rel(g["metrics"][k], o["metrics"][k])
                     for k in o["metrics"]}
            raise AssertionError(f"mesh {label} (35e): the group's metrics "
                                 f"differ from the run with no group: "
                                 f"{worst}")
        if len(g["tokens"]) != len(o["tokens"]) or not all(
                torch.equal(a, b) for a, b in zip(g["tokens"], o["tokens"])):
            raise AssertionError(f"mesh {label} (35e): the group's "
                                 "completions differ")
        want_kinds = {"state": [True],
                      "teacher": [True] if label == "gkd" else []}
        if g["kinds"] != want_kinds or o["kinds"]["state"] != [False]:
            raise AssertionError(f"mesh {label} (35e): DTensor leaves "
                                 f"{g['kinds']} on the group, "
                                 f"{o['kinds']} without, want "
                                 f"{want_kinds} and plain")
        if g["launches"] != g["want"]:
            raise AssertionError(f"mesh {label} (35e): launches "
                                 f"{g['launches']}, want {g['want']}")
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    log("mesh pref (35e): Qwen2-VL-2B's widths, the decoder cut to "
        f"{MESH_PREF_LAYERS} layers, through cli/train_pref.py (KTO, PPO, "
        f"Nash-MD and GKD at N={MESH_PREF_N}) and cli/train_sft.py "
        "with the fused CE, one step each under the one-rank NCCL group: metrics "
        "and completions bitwise the runs with no group; the states' "
        "leaves, the value head and the teacher DTensors; launches as "
        "predicted: " + "; ".join(
            f"{label} {g['launches']} in {g['s']:.1f} s (no group "
            f"{one[label]['s']:.1f} s)" for label, g in group.items())
        + f" on {card}")
    return total


def check_fused_vocab(card) -> None:
    """Phase 35e's check of the fused CE's vocabulary-sharded branch
    (``train/sft.py`` ``_fused_ce`` with ``vocab``): Qwen2-VL-2B's head
    (1536 x 151936, f32, seed 0) split over MESH_FUSED_TP ranks that run
    one after another (``run_sequential_ranks``: the max, sum and min
    all-reduces in rank order), on MESH_FUSED_ROWS rows of
    MESH_FUSED_CUTOFF (a prefix of each ignored, every other label the
    argmax that predicts it, so the correct count reads the sharded
    argmax), against one rank's loop over the whole head; a control
    whose sums drop the last rank's part fails the limits."""
    from iadr1_tpu_torch.core.tensor_parallel import (
        rank_ordered_sum,
        run_sequential_ranks,
    )
    from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
    from iadr1_tpu_torch.train.sft import _fused_ce

    t0 = time.perf_counter()
    text = QWEN2_VL_2B["text_config"]
    H, V = text["hidden_size"], text["vocab_size"]
    B, T = MESH_FUSED_ROWS, MESH_FUSED_CUTOFF
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    hidden = torch.randn((B, T, H), generator=gen, device=DEVICE)
    kernel = 0.02 * torch.randn((H, V), generator=gen, device=DEVICE)
    labels = torch.randint(0, V, (B, T), generator=gen, device=DEVICE)
    with torch.no_grad():
        top = torch.matmul(hidden[:, :-1], kernel).argmax(-1)
    labels[:, 1::2] = top[:, ::2]
    labels[:, :T // 8] = IGNORE_INDEX
    del top
    per = -(-V // MESH_FUSED_TP)

    def rank(group):
        lo = group.rank * per
        return _fused_ce(hidden, kernel[:, lo:lo + per], labels, CE_CHUNK,
                         torch.float32, True, (group, lo, V))

    def diffs(ranks):
        d_hidden = rank_ordered_sum([r[3].float() for r in ranks])
        d_w = torch.cat([r[4] for r in ranks], dim=1)
        return {"loss": max(_rel(float(r[0]), float(want[0]))
                            for r in ranks),
                "d_hidden": float((d_hidden - want[3]).abs().max()
                                  / want[3].abs().max()),
                "d_W": float((d_w - want[4]).abs().max()
                             / want[4].abs().max())}

    with torch.no_grad():
        want = _fused_ce(hidden, kernel, labels, CE_CHUNK, torch.float32,
                         True)
        ranks = run_sequential_ranks(rank, MESH_FUSED_TP)
        got = diffs(ranks)
        counts = [(int(r[1]), int(r[2])) for r in ranks]
        del ranks
        control = diffs(run_sequential_ranks(
            rank, MESH_FUSED_TP,
            reduce=lambda parts: rank_ordered_sum(parts[:-1])))
    torch.cuda.synchronize()
    if any(c != (int(want[1]), int(want[2])) for c in counts):
        raise AssertionError(f"fused CE over tp (35e): correct and label "
                             f"counts {counts}, one rank's "
                             f"{(int(want[1]), int(want[2]))}")
    over = {k: v for k, v in got.items() if not v <= MESH_FUSED_VOCAB_LIMITS[k]}
    if over:
        raise AssertionError(f"fused CE over tp (35e): {over} over "
                             f"{MESH_FUSED_VOCAB_LIMITS}")
    if all(v <= MESH_FUSED_VOCAB_LIMITS[k] for k, v in control.items()):
        raise AssertionError(f"fused CE over tp (35e): the control (the "
                             f"last rank's sums dropped) {control} passed")
    log(f"fused CE over tp (35e): Qwen2-VL-2B's head ({H} x {V}, f32) over "
        f"{MESH_FUSED_TP} ranks one after another, {B} rows of {T}: "
        f"correct {int(want[1])} of {int(want[2])} labels as one rank; "
        f"against one rank " + ", ".join(
            f"{k} {v:.3e} (limit {MESH_FUSED_VOCAB_LIMITS[k]:.0e})"
            for k, v in got.items())
        + "; control (the last rank's sums dropped) " + ", ".join(
            f"{k} {v:.3e}" for k, v in control.items())
        + f"; {time.perf_counter() - t0:.1f} s on {card}")


def phase_mesh(rows, grpo_examples, card) -> dict:
    """Phase 35: (a, b) the kernels' sharding rule (``phase_mesh_rule``);
    (c) PA-SFT through cli/train_sft.py's main under a one-rank NCCL group
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT as torchrun
    sets them): Qwen2-VL-2B at full width and depth, f32, 2 steps on
    phase 6's rows; the train state's leaves and moments are DTensors,
    every attention call goes through K1-K3, the step metrics equal the
    same CLI's run with no group, and the checkpoint reads back bitwise;
    the kernel wrappers' DTensor path on the card (a one-rank mesh) equals
    the plain-tensor call; (d) one SC-GRPO step through cli/train_grpo.py
    on the same group (N = 64): the completions equal the one-process
    run's token for token, decode ms a step beside it; (e) KTO, PPO,
    Nash-MD, GKD and the fused-CE step on the same group
    (``mesh_pref_runs``, ``check_mesh_pref``).  Returns the launches of
    (c), (d) and (e)'s group runs."""
    import gc
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from iadr1_tpu_torch.core.mesh import (
        MeshConfig,
        build_mesh,
        full,
        set_kernel_mesh,
    )
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels import decode_attention as dec_mod
    from iadr1_tpu_torch.kernels import flash_attention as fa_mod
    from iadr1_tpu_torch.train.state import named_leaves

    t0 = time.perf_counter()
    phase_mesh_rule()
    log(f"phase 35a-b (mesh rule): {time.perf_counter() - t0:.1f} s")

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    kernels = [k for k, _ in all_kernels()]

    def counts():
        return {k.name: k.launches for k in kernels}

    # the one-process runs first: no group, plain tensors, no checkpoint
    t1 = time.perf_counter()
    one_sft = mesh_cli("train_sft", mesh_sft_cfg("sft_one"), "sft_one",
                       rows=rows, save=False)
    one_grpo = mesh_cli("train_grpo", mesh_grpo_cfg("grpo_one"), "grpo_one",
                        examples=grpo_examples, save=False)
    one_s = time.perf_counter() - t1
    t6 = time.perf_counter()
    one_pref = mesh_pref_runs(kernels, "one")
    one_pref_s = time.perf_counter() - t6

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        for k in kernels:
            k.launches = 0
        t2 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        mesh_sft = mesh_cli("train_sft", mesh_sft_cfg("sft_mesh"),
                            "sft_mesh", rows=rows, keep_state=True)
        sft_s = time.perf_counter() - t2
        sft_peak = torch.cuda.max_memory_allocated() / GIB
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        if not dist.is_initialized() or dist.get_backend() != backend:
            raise AssertionError(f"the SFT CLI did not set up the {backend}"
                                 " group")
        sft_launches = counts()

        # (c) the state: DTensor leaves and moments
        state = mesh_sft.states[0]
        named = named_leaves(state.params)
        moments = state.opt_state["mu"] + state.opt_state["nu"]
        if not all(isinstance(t, DTensor) for _, t in named) or not all(
                isinstance(t, DTensor) for t in moments):
            raise AssertionError("the group run's state holds plain tensors")
        n_leaves = len(named)
        L_dec = QWEN2_VL_2B["text_config"]["num_hidden_layers"]
        L_tower = QWEN2_VL_2B["vision_config"]["depth"]
        steps = MESH_SFT_STEPS
        want = {"flash_fwd": steps * (L_dec + 2 * L_tower),
                "flash_bwd_dq": steps * (L_dec + L_tower),
                "flash_bwd_dkv": steps * (L_dec + L_tower),
                "decode_attention": 0}
        if sft_launches != want:
            raise AssertionError(f"mesh sft launches {sft_launches}, want "
                                 f"{want}")
        worst = {}
        for got, ref in zip(mesh_sft.metrics, one_sft.metrics, strict=True):
            for key in ("loss", "grad_norm", "accuracy"):
                worst[key] = max(worst.get(key, 0.0),
                                 _rel(got[key], ref[key]))
        if max(worst.values()) > MESH_METRIC_REL:
            raise AssertionError(f"mesh sft metrics against one process: "
                                 f"{worst}")
        losses = [m["loss"] for m in mesh_sft.metrics]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"mesh sft: the loss did not fall {losses}")

        # the checkpoint, read back against the state
        from safetensors import safe_open

        t4 = time.perf_counter()
        path = os.path.join(MESH_DIR, "sft_mesh", "checkpoints",
                            f"{steps}.safetensors")
        size_gb = os.path.getsize(path) / 1e9
        expect = {f"params.{n}": t for n, t in named}
        for key in ("mu", "nu"):
            expect.update({f"{key}.{n}": t for (n, _), t in zip(
                named, state.opt_state[key])})
        with safe_open(path, framework="pt", device=DEVICE) as f:
            keys = set(f.keys())
            if keys != set(expect) | {"step", "opt_count"}:
                raise AssertionError("mesh sft checkpoint keys differ")
            for key, t in expect.items():
                if not torch.equal(f.get_tensor(key), full(t.detach())):
                    raise AssertionError(f"mesh sft checkpoint {key} differs"
                                         " from the state")
        read_s = time.perf_counter() - t4
        sft_ms = [round(1e3 * x, 1) for x in mesh_sft.step_s]
        one_ms = [round(1e3 * x, 1) for x in one_sft.step_s]
        del state, named, moments, expect, mesh_sft
        shutil.rmtree(os.path.join(MESH_DIR, "sft_mesh"))
        gc.collect()
        torch.cuda.empty_cache()

        t3 = time.perf_counter()
        mesh_grpo = mesh_cli("train_grpo", mesh_grpo_cfg("grpo_mesh"),
                             "grpo_mesh", examples=grpo_examples, save=False)
        grpo_s = time.perf_counter() - t3
        launches = counts()
        grpo_launches = {k: launches[k] - sft_launches[k] for k in launches}

        # the wrappers' DTensor path on the card: a one-rank mesh
        mesh = build_mesh(MeshConfig(1, 1, 1))
        rep = [Replicate()] * mesh.ndim
        q, k, v, seg, do, dlse = rule_inputs(MESH_RULE_B, seed=43)
        calls = (fa_mod.MESH_CALLS.calls, dec_mod.MESH_CALLS.calls)
        dts = [DTensor.from_local(t, mesh, rep, run_check=False)
               .requires_grad_(i < 3) for i, t in enumerate((q, k, v))]
        dseg = DTensor.from_local(seg, mesh, rep, run_check=False)
        out, lse = fa_mod.flash_attention(*dts, segment_ids=dseg,
                                          kv_segment_ids=dseg, causal=True)
        grads = torch.autograd.grad((out, lse), dts, (
            DTensor.from_local(do, mesh, rep, run_check=False),
            DTensor.from_local(dlse, mesh, rep, run_check=False)))
        got = (out, lse, *grads)
        ref = flash_call(q, k, v, seg, do, dlse)
        dq_, dk_, dv_, dcs = decode_inputs(seed=44)
        dd = dec_mod.decode_attention(*(
            DTensor.from_local(t, mesh, rep, run_check=False)
            for t in (dq_, dk_, dv_, dcs)), MESH_DECODE["length"])
        if not all(torch.equal(a.to_local(), b) for a, b in zip(got, ref)) \
                or not torch.equal(dd.to_local(), dec_mod.decode_attention(
                    dq_, dk_, dv_, dcs, MESH_DECODE["length"])):
            raise AssertionError("the wrappers' DTensor path differs from "
                                 "the plain-tensor call")
        wrapped = (fa_mod.MESH_CALLS.calls - calls[0],
                   dec_mod.MESH_CALLS.calls - calls[1])
        if wrapped != (1, 1):
            raise AssertionError(f"the wrappers counted {wrapped} DTensor "
                                 "calls, want (1, 1)")
        t5 = time.perf_counter()
        decode = mesh_decode(grpo_examples, mesh)
        decode_s = time.perf_counter() - t5
        tokens = [v[0] for v in decode.values()]
        if not all(torch.equal(t, tokens[0]) for t in tokens):
            raise AssertionError("mesh decode: the DTensor rollout's tokens "
                                 "differ from the plain copy's")
        # (e): the taps zero the counters, so 35c-d's are kept aside
        launches = counts()
        t7 = time.perf_counter()
        group_pref = mesh_pref_runs(kernels, "mesh")
        pref_s = time.perf_counter() - t7
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)
        set_kernel_mesh(None)

    # (d) SC-GRPO: the group's completions are the one-process run's
    (mesh_tokens, mesh_roll_s, mesh_steps), = mesh_grpo.rollouts
    (one_tokens, one_roll_s, one_steps), = one_grpo.rollouts
    if not torch.equal(mesh_tokens, one_tokens):
        raise AssertionError("mesh grpo: the group's completions differ "
                             "from the one-process run's")
    gworst = {key: _rel(mesh_grpo.metrics[0][key], one_grpo.metrics[0][key])
              for key in ("loss", "kl", "grad_norm", "reward")}
    if max(gworst.values()) > MESH_METRIC_REL:
        raise AssertionError(f"mesh grpo metrics against one process: "
                             f"{gworst}")
    if not all(grpo_launches.values()):
        raise AssertionError(f"mesh grpo launches {grpo_launches}")
    pref_launches_ = check_mesh_pref(group_pref, one_pref, card)
    launches = {k: v + pref_launches_.get(k, 0) for k, v in launches.items()}
    t8 = time.perf_counter()
    check_fused_vocab(card)
    vocab_s = time.perf_counter() - t8
    log(f"phase 35e (mesh pref): {pref_s + one_pref_s + vocab_s:.1f} s (the "
        f"group runs {pref_s:.1f} s, the runs with no group "
        f"{one_pref_s:.1f} s, the fused CE over tp {vocab_s:.1f} s)")
    shutil.rmtree(MESH_DIR, ignore_errors=True)

    log(f"mesh sft (35c): Qwen2-VL-2B f32 through cli/train_sft.py's main "
        f"under a one-rank NCCL group, {steps} steps of phase 6's rows; "
        f"{n_leaves} leaves and both moments DTensors; losses "
        f"{[round(x, 6) for x in losses]}; against the run with no group, "
        f"the largest relative difference of loss, grad norm and accuracy "
        f"{max(worst.values()):.3e} (limit {MESH_METRIC_REL}); the "
        f"checkpoint ({size_gb:.1f} GB) read back bitwise in {read_s:.1f} s; "
        f"the group run {sft_s:.1f} s with its checkpoint, peak memory "
        f"{sft_peak:.2f} GiB, steps {sft_ms} ms against the one-process "
        f"run's {one_ms} (which ran first, on a cold host); the DTensor wrappers on a one-rank mesh "
        f"bitwise equal to the plain-tensor calls (K1-K3, K4); launches "
        f"{sft_launches} on {card}")
    log(f"mesh decode (35d): Qwen2-VL-2B bf16, phase 7's prompts, G=4, "
        f"{decode['plain'][2]} decode steps, the same tokens both ways: "
        f"the plain copy {decode['plain'][1]:.3f} ms/step (again "
        f"{decode['plain again'][1]:.3f}), DTensors over the one-rank tp "
        f"submesh {decode['dtensor'][1]:.3f} ms/step (prefill included; "
        f"{decode_s:.1f} s in all) on {card}")
    log(f"mesh grpo (35d): one step through cli/train_grpo.py's main on "
        f"the group (N={MESH_GRPO_N}, {mesh_tokens.shape[0]} rows): "
        f"completions equal to the one-process run's, metrics within "
        f"{max(gworst.values()):.3e}; the rollout on the gathered bf16 copy "
        f"{1e3 * mesh_roll_s:.1f} ms for {mesh_steps} decode steps "
        f"({1e3 * mesh_roll_s / max(mesh_steps, 1):.3f} ms/step, prefill "
        f"included), the one-process run's {1e3 * one_roll_s:.1f} ms for "
        f"{one_steps} ({1e3 * one_roll_s / max(one_steps, 1):.3f} ms/step); "
        f"the group's step {1e3 * mesh_grpo.step_s[0]:.1f} ms, the "
        f"one-process run's {1e3 * one_grpo.step_s[0]:.1f} ms; the group "
        f"run {grpo_s:.1f} s, the one-process runs {one_s:.1f} s; launches "
        f"{grpo_launches} on {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 37: tensor parallelism (the repo's two tp = 4 recipes)
# ---------------------------------------------------------------------------

# llava-hf/llava-v1.6-34b-hf's published widths (configs/
# grpo_llava_next_34b.yaml's model): Yi-34B, 60 layers of 56 heads over 8
# (D = 128), MLP 20480, 64064 ids, an untied head; CLIP-L/336
LLAVA_NEXT_34B = dict(
    architectures=["LlavaNextForConditionalGeneration"],
    model_type="llava_next",
    text_config=dict(
        model_type="llama", vocab_size=64064, hidden_size=7168,
        intermediate_size=20480, num_hidden_layers=60,
        num_attention_heads=56, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=5000000.0, tie_word_embeddings=False,
        max_position_embeddings=4096),
    vision_config=dict(LLAVA_NEXT_8B["vision_config"]),
    image_token_index=64000, vision_feature_layer=-2,
    vision_feature_select_strategy="default",
    image_grid_pinpoints=LLAVA_NEXT_8B["image_grid_pinpoints"],
)
TP = 4
# (a) the attention calls of the two tp = 4 recipes, whole and as tp
# shards (each rank's: H / 4 query heads over Hkv / 4 KV heads): the
# decoders on one packed row of 4096 (the 72B SFT recipe's cutoff, 16
# rows over fsdp 16) in two segments, causal, the lse cotangent given;
# CLIP-L/336 over one image's 5 anyres tiles of 577; the Qwen2.5-VL tower
# over the recipe's patch budget of 8192 in windows of 64 patches (its
# windowed blocks), non-causal.  (label, B, H, Hkv, T, D, causal, window)
TP_FLASH = (("Yi-34B decoder", 1, 56, 8, 4096, 128, True, None),
            ("Qwen2.5-72B decoder", 1, 64, 8, 4096, 128, True, None),
            ("CLIP-L-336 tower", 5, 16, 16, 577, 64, False, None),
            ("Qwen2.5-VL tower", 1, 16, 16, 8192, 80, False, 64),
            # Qwen1.5-MoE-A2.7B's decoder at tp = 4 (its experts too, 37d)
            ("Qwen1.5-MoE-A2.7B decoder", 1, 16, 16, 4096, 128, True, None))
# K4 at the decoders' decode shards: the rollout's B = 8 rows over a cache
# of the recipe's 4096 + 512 slots, 4000 of them live; the MoE's over
# phase 29's 1024 + 128
TP_DECODE = (("Yi-34B", 8, 56, 8, 4608, 128, 4000),
             ("Qwen2.5-72B", 8, 64, 8, 4608, 128, 4000),
             ("Qwen1.5-MoE-A2.7B", 8, 16, 16, 1152, 128, 1100))
# the uneven shards: Qwen2.5-VL-7B's decoder (28 heads over 4, D = 128)
# at tp = 8, the rollout's split (``train/rollout.py tp_head_share``: 4,
# 4, 4, 4, 3, 3, 3, 3 query heads, each rank the KV heads they read); K1
# on one row of 4096 (the prefill's kernel there) and K4 as TP_DECODE's
TP_UNEVEN = ("Qwen2.5-VL-7B", 28, 4, 8, 128, 4096, (8, 4608, 4000))
# the shards whose PERF.md rows give SDPA's time beside the kernel's
TP_SHARDS_WITH_SDPA = ("Qwen1.5-MoE-A2.7B decoder", "Qwen1.5-MoE-A2.7B")
# (b) the tensor-parallel rollout: LLaVA-NeXT-34B cut to TP_LAYERS decoder
# layers at full width, bf16 from seed 0, B = 8 text prompts of
# TP_PROMPT_LEN, TP_NEW_TOKENS greedy steps; the ranks' first-step logits
# against the unsharded rollout's, relative L2: the row-parallel products
# add four bf16 partials (each rounded, 2^-8 relative) where the unsharded
# product rounds once, at each of 2 * TP_LAYERS reduces, and the residual
# stream carries those through the later layers (PERF.md has the
# prediction and the reading).  A control that drops one rank's partial
# sum must exceed it.
TP_LAYERS, TP_PROMPT_LEN, TP_NEW_TOKENS, TP_ROWS = 4, 512, 16, 8
TP_LOGITS_REL_L2 = 5e-2
# (c) LoRA SC-GRPO through cli/train_grpo.py under a one-rank NCCL group
# against the same CLI with no group: Qwen2-VL-2B cut to TP_LORA_LAYERS
# decoder layers, its bf16 base and configs/grpo_llava_next_34b.yaml's
# finetuning section (LoRA rank 16, alpha 32), phase 7's prompts, one step
# of completions cut to TP_LORA_N
TP_LORA_LAYERS, TP_LORA_N = 8, 32
TP_SHARD_CASES: dict = {}            # (a)'s timed cases, for the kernel line


def tp_rule_inputs(B, H, Hkv, T, D, causal, window, seed):
    """q, k, v, segments, dO and dlse of a TP_FLASH case: a causal row in
    two packed segments, the last 37 positions padding; a non-causal one
    in windows of ``window`` (or one segment a row)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = dict(device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn((B, H, T, D), generator=gen, **dev)
    k = torch.randn((B, Hkv, T, D), generator=gen, **dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, **dev)
    do = torch.randn((B, H, T, D), generator=gen, **dev)
    pos = torch.arange(T, device=DEVICE)
    if causal:
        seg = (1 + (pos >= T // 2)).to(torch.int32).expand(B, T).clone()
        seg[:, T - 37:] = 0
        dlse = torch.randn((B, H, T), generator=gen, device=DEVICE)
    else:
        seg = (1 + pos // (window or T)).to(torch.int32).expand(B, T)
        seg = seg.contiguous()
        dlse = torch.zeros((B, H, T), device=DEVICE)
    return q, k, v, seg, do, dlse


def phase_tp_shards() -> None:
    """Phase 37a: K1-K3 at TP_FLASH and K4 at TP_DECODE, whole and as the
    four tp ranks' shards (``shard_slices`` at tp = 4), each shard's
    launch bitwise equal to its slice of the unsharded launch; each shard
    shape timed against its plain version and SDPA (phase 3's cases, into
    the kernel line).  The control gives each rank of the Yi-34B decoder
    the next rank's KV heads and must break the bitwise check."""
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import shard_slices

    names = ("out", "lse", "dq", "dk", "dv")
    sizes = {"dp": 1, "fsdp": 1, "tp": TP}
    fwd, bwd, dec, lines = [], [], [], []
    for i, (label, B, H, Hkv, T, D, causal, window) in enumerate(TP_FLASH):
        q, k, v, seg, do, dlse = tp_rule_inputs(B, H, Hkv, T, D, causal,
                                                window, seed=370 + i)
        # each case's own mask: the towers' are non-causal
        whole = flash_call(q, k, v, seg, do, dlse, causal)
        slices = shard_slices(sizes, B, H, Hkv)
        shards = sharded_flash(slices, q, k, v, seg, do, dlse, causal)
        unequal = [n for n, a, b in zip(names, shards, whole)
                   if not torch.equal(a, b)]
        if unequal or len(slices) != TP:
            raise AssertionError(f"tp shards of {label}: {unequal} differ "
                                 f"from the unsharded launch")
        del whole, shards, q, k, v, do, dlse
        h, hkv = H // TP, Hkv // TP
        shape = (B, h, hkv, T, T, D, causal, seg, seg)
        new = label in TP_SHARDS_WITH_SDPA      # this PR's rows want SDPA
        results = _labelled((*bwd_case(*shape, 380 + i, timed=True,
                                       with_dlse=causal,
                                       library=label == "CLIP-L-336 tower"
                                       or new),
                             flash_case(*shape, 390 + i, timed=True,
                                        library=new)),
                            f"tp shard, {label}")
        bwd.append(results[:3])
        fwd.append(results[3])
        lines.append(f"{label} {H}/{Hkv} -> {h}/{hkv} x {TP}")
    for i, (label, B, H, Hkv, S, D, length) in enumerate(TP_DECODE):
        gen = torch.Generator(device=DEVICE).manual_seed(400 + i)
        dev = dict(device=DEVICE, dtype=torch.bfloat16)
        q = torch.randn((B, H, D), generator=gen, **dev)
        k = torch.randn((B, Hkv, S, D), generator=gen, **dev)
        v = torch.randn((B, Hkv, S, D), generator=gen, **dev)
        seg = torch.ones((B, S), dtype=torch.int32, device=DEVICE)
        for b in range(B):
            seg[b, :29 * b] = 0                     # left padding
        whole = decode_attention(q, k, v, seg, length)
        for b, hs, ks in shard_slices(sizes, B, H, Hkv):
            part = decode_attention(q[b, hs].contiguous(),
                                    k[b, ks].contiguous(),
                                    v[b, ks].contiguous(), seg[b], length)
            if not torch.equal(part, whole[b, hs]):
                raise AssertionError(f"tp shards of the {label} decode "
                                     "differ from the unsharded launch")
        del q, k, v, whole
        dec.append(_labelled([decode_case(
            B, H // TP, Hkv // TP, S, D, length, seg, 410 + i, True,
            library=label in TP_SHARDS_WITH_SDPA)],
            f"tp shard, {label} decode")[0])
        lines.append(f"{label} decode {H}/{Hkv} -> {H // TP}/{Hkv // TP}")
    uneven, uneven_dec = tp_uneven_shards()
    fwd += uneven
    dec += uneven_dec
    lines.append(f"{TP_UNEVEN[0]} {TP_UNEVEN[1]}/{TP_UNEVEN[2]} over "
                 f"{TP_UNEVEN[3]} ranks (4 or 3 query heads a rank)")
    log_kernel_results(fwd, dec, bwd)
    TP_SHARD_CASES.update({
        "flash_fwd": fwd + [r[2] for r in bwd],
        "flash_bwd_dq": [r[0] for r in bwd],
        "flash_bwd_dkv": [r[1] for r in bwd], "decode_attention": dec})

    # the control: each rank given the next rank's KV heads for its own
    # query heads
    label, B, H, Hkv, T, D, causal, window = TP_FLASH[0]
    q, k, v, seg, do, dlse = tp_rule_inputs(B, H, Hkv, T, D, causal, window,
                                            seed=370)
    whole = flash_call(q, k, v, seg, do, dlse)
    h, hkv = H // TP, Hkv // TP
    broken = [(slice(0, B), slice(r * h, (r + 1) * h),
               slice((r + 1) % TP * hkv, ((r + 1) % TP + 1) * hkv))
              for r in range(TP)]
    shards = sharded_flash(broken, q, k, v, seg, do, dlse)
    differ = [n for n, a, b in zip(names, shards, whole)
              if not torch.equal(a, b)]
    if not differ:
        raise AssertionError("tp shards control: each rank on the next "
                             "rank's KV heads passed the bitwise check")
    log(f"tp shards (37a): {'; '.join(lines)}: every rank's K1-K3 (dlse "
        f"given on the decoders) and K4 launch bitwise equal to its slice "
        f"of the unsharded launch, each held to its plain version above; "
        f"the control (each rank's {h} query heads on the next rank's "
        f"{hkv} KV heads) breaks it: {differ} differ, out max err "
        f"{max_err(shards[0], whole[0]):.3e}")


def tp_uneven_shards():
    """37a's uneven shards (TP_UNEVEN): each rank's K1 (out, lse) and K4
    launch on its query heads and the KV heads they read, bitwise equal
    to its heads of the unsharded launch; a 4-head and a 3-head shard
    each held to the plain version and timed.  Returns the timed K1 and
    K4 results."""
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention
    from iadr1_tpu_torch.train.rollout import tp_head_share

    label, H, Hkv, tp, D, T, (B, S, length) = TP_UNEVEN
    q, k, v, seg, _, _ = tp_rule_inputs(1, H, Hkv, T, D, True, None,
                                        seed=420)
    out, lse = flash_attention(q, k, v, segment_ids=seg,
                               kv_segment_ids=seg, causal=True)
    gen = torch.Generator(device=DEVICE).manual_seed(421)
    dev = dict(device=DEVICE, dtype=torch.bfloat16)
    dq = torch.randn((B, H, D), generator=gen, **dev)
    ck = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    cv = torch.randn((B, Hkv, S, D), generator=gen, **dev)
    cseg = torch.ones((B, S), dtype=torch.int32, device=DEVICE)
    for b in range(B):
        cseg[b, :29 * b] = 0                        # left padding
    dec = decode_attention(dq, ck, cv, cseg, length)
    groups = {}
    for r in range(tp):
        first, count, kv = tp_head_share(H, Hkv, tp, r)
        heads = slice(first, first + count)
        kv = list(range(r * Hkv // tp, (r + 1) * Hkv // tp)) \
            if kv is None else kv
        o, l = flash_attention(q[:, heads].contiguous(),
                               k[:, kv].contiguous(), v[:, kv].contiguous(),
                               segment_ids=seg, kv_segment_ids=seg,
                               causal=True)
        d = decode_attention(dq[:, heads].contiguous(), ck[:, kv].contiguous(),
                             cv[:, kv].contiguous(), cseg, length)
        if not (torch.equal(o, out[:, heads]) and torch.equal(l, lse[:, heads])
                and torch.equal(d, dec[:, heads])):
            raise AssertionError(f"tp shards of {label}: rank {r}'s {count} "
                                 f"heads over KV heads {kv} differ from the "
                                 "unsharded launch")
        groups.setdefault(count, len(kv))
    del q, k, v, out, lse, dq, ck, cv, dec
    fwd, decs = [], []
    for count, n_kv in sorted(groups.items(), reverse=True):
        shape = (1, count, n_kv, T, T, D, True, seg, seg)
        fwd.append(_labelled([flash_case(*shape, 422 + count, timed=True,
                                         library=True)],
                             f"tp shard, {label} decoder, {count} heads")[0])
        decs.append(_labelled([decode_case(B, count, n_kv, S, D, length,
                                           cseg, 430 + count, True,
                                           library=True)],
                              f"tp shard, {label} decode, {count} heads")[0])
    return fwd, decs


def tp_rollout_bundle():
    """LLaVA-NeXT-34B cut to TP_LAYERS decoder layers, its bf16 parameters
    from seed 0 on the card, and TP_ROWS text prompts (left-padded, a
    seeded length each)."""
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    hf = dict(LLAVA_NEXT_34B, text_config=dict(
        LLAVA_NEXT_34B["text_config"], num_hidden_layers=TP_LAYERS))
    bundle = bundle_from_hf_config(hf)
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(37)
    P = TP_PROMPT_LEN
    ids = np.full((TP_ROWS, P), 0, np.int64)
    mask = np.zeros((TP_ROWS, P), np.int64)
    for b in range(TP_ROWS):
        n = P - 17 * b
        ids[b, P - n:] = rng.integers(3, 64000, n)
        mask[b, P - n:] = 1
    batch = {"input_ids": torch.as_tensor(ids, device=DEVICE),
             "attention_mask": torch.as_tensor(mask, device=DEVICE)}
    return bundle, params, batch


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_tp_rollout(card) -> None:
    """Phase 37b: the tensor-parallel rollout at tp = 4 on LLaVA-NeXT-34B's
    bf16 decoder (``tp_rollout_check``: each rank 14 of 56 query heads, 2
    of 8 KV heads, a quarter of the MLP and of the vocabulary), against
    the unsharded rollout; the greedy tokens' agreement reported."""
    bundle, params, batch = tp_rollout_bundle()
    tcfg = bundle.cfg.text
    whole_gb = sum(t.numel() * t.element_size()
                   for t in _tensors(params["text"])) / 1e9
    res = tp_rollout_check(bundle, params, batch, TP)
    kv = [s["kv_heads"] for s in res["shapes"]]
    if kv != [tcfg.num_key_value_heads // TP] * TP:
        raise AssertionError(f"tp rollout: a rank's KV heads {kv}")
    log(f"tp rollout (37b): LLaVA-NeXT-34B cut to {TP_LAYERS} decoder layers "
        f"(Yi-34B width, bf16, {whole_gb:.2f} GB of decoder), {TP_ROWS} "
        f"prompts of {TP_PROMPT_LEN}, {TP_NEW_TOKENS} greedy steps: {TP} "
        f"ranks one after another, each on "
        f"{max(s['gb'] for s in res['shapes']):.2f} GB of decoder, its "
        f"cache holding {kv[0]} of the 8 KV heads; first-step logits "
        f"against the unsharded rollout's, relative L2 {res['rel_l2']:.3e} "
        f"(limit {TP_LOGITS_REL_L2}); every rank the same tokens, agreeing "
        f"with the unsharded greedy tokens at {res['agree']:.4f} of "
        f"positions ({res['first']:.4f} of the first tokens); the control "
        f"(rank {TP - 1}'s partial sums dropped) {res['control']:.3e}; the "
        f"unsharded prefill and rollout {res['whole_s']:.1f} s, the four "
        f"ranks' {res['tp_s']:.1f} s on {card}")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [] if tree is None else [tree]


def tp_lora_cfg(name) -> dict:
    """mesh_grpo_cfg's run with Qwen2-VL-2B cut to TP_LORA_LAYERS layers,
    its bf16 base, the 34B recipe's finetuning section and learning rate
    (no warmup), N = TP_LORA_N."""
    import yaml

    cfg = mesh_grpo_cfg(name)
    with open(LLAVA_GRPO_RECIPE) as f:
        recipe = yaml.safe_load(f)
    cfg["finetuning"] = recipe["finetuning"]
    # the recipe's learning rate, no warmup: the one step moves B off 0
    cfg["optim"].update(learning_rate=recipe["optim"]["learning_rate"],
                        warmup_ratio=0.0)
    hf = dict(QWEN2_VL_2B, text_config=dict(
        QWEN2_VL_2B["text_config"], num_hidden_layers=TP_LORA_LAYERS))
    cfg["model"].update(hf_config=hf, dtype="bfloat16")
    cfg["grpo"]["max_completion_length"] = TP_LORA_N
    return cfg


def phase_tp_lora(grpo_examples, card) -> None:
    """Phase 37c: one LoRA SC-GRPO step through cli/train_grpo.py's main
    under a one-rank NCCL group (the mesh path: the base sharded by its
    logical axes, the adapters and their moments by lora_logical_axes,
    the base's compute view in the update) against the same CLI with no
    group: the completions, the step's metrics and the adapters after it
    bitwise equal; the base unchanged; the control, the group's adapters
    before the step against the one-process adapters after it, must
    differ."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from iadr1_tpu_torch.core.mesh import full, set_kernel_mesh
    from iadr1_tpu_torch.train.state import named_leaves

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    one = mesh_cli("train_grpo", tp_lora_cfg("lora_one"), "lora_one",
                   examples=grpo_examples, save=False, keep_state=True)
    one_s = time.perf_counter() - t0
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    try:
        t1 = time.perf_counter()
        group = mesh_cli("train_grpo", tp_lora_cfg("lora_mesh"), "lora_mesh",
                         examples=grpo_examples, save=False, keep_state=True)
        group_s = time.perf_counter() - t1
        if not dist.is_initialized():
            raise AssertionError("the LoRA GRPO run set up no group")
        state = group.states[0]
        named = named_leaves(state.params)
        if not all(isinstance(t, DTensor) for _, t in named):
            raise AssertionError("the group's adapters are plain tensors")
        got = {n: full(t).detach() for n, t in named}
        before = group.initial[0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)
        set_kernel_mesh(None)
    want = {n: t.detach() for n, t in named_leaves(one.states[0].params)}
    (mesh_tokens, mesh_roll_s, steps), = group.rollouts
    (one_tokens, _, _), = one.rollouts
    if not torch.equal(mesh_tokens, one_tokens):
        raise AssertionError("tp lora grpo: the group's completions differ")
    keys = ("loss", "kl", "grad_norm", "reward", "completion_length")
    unequal = [k for k in keys if group.metrics[0][k] != one.metrics[0][k]]
    if unequal or got.keys() != want.keys() or not all(
            torch.equal(got[n], want[n]) for n in want):
        raise AssertionError(f"tp lora grpo: metrics {unequal} or adapters "
                             "differ from the one-process step's")
    moved = [n for n in want if not torch.equal(before[n], want[n])]
    if not moved:
        raise AssertionError("tp lora grpo control: the adapters before the "
                             "step equal the one-process adapters after it")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    log(f"tp lora grpo (37c): Qwen2-VL-2B cut to {TP_LORA_LAYERS} decoder "
        f"layers, its bf16 base, LoRA rank 16 alpha 32 "
        f"(configs/grpo_llava_next_34b.yaml), one step of {steps} decode "
        f"steps ({mesh_tokens.shape[0]} rows) through cli/train_grpo.py's "
        f"main under a one-rank NCCL group: {len(named)} adapter leaves "
        f"DTensors; completions, loss {group.metrics[0]['loss']:.6g}, kl, "
        f"grad norm {group.metrics[0]['grad_norm']:.6g}, reward and the "
        f"adapters after the step bitwise the no-group step's; the control "
        f"(the adapters before the step) differs in {len(moved)} of "
        f"{len(want)} leaves; rollout {1e3 * mesh_roll_s:.1f} ms, the "
        f"group run {group_s:.1f} s, the one-process run {one_s:.1f} s on "
        f"{card}")


# (d) the MoE at tp = 4 (Qwen1.5-MoE-A2.7B's published widths, 15 of the
# 60 experts a rank) and (e) uneven heads with DoRA at tp = 8
# (Qwen2.5-VL-7B, 28 heads over 8 ranks, DoRA rank 8 over its bf16 base),
# each as sequential ranks against the unsharded rollout, as (b); both
# decoders cut to TP_EXTRA_LAYERS layers (the smoke's time); 4 text
# prompts of TP_EXTRA_PROMPT_LEN, TP_NEW_TOKENS greedy steps
TP_EXTRA_LAYERS, TP_EXTRA_PROMPT_LEN, TP_EXTRA_ROWS = 4, 1024, 4
TP_MOE, TP_DORA = 4, 8
TP_DORA_RANK = 8
# 37d's limit: the MoE's index_add sums each token's expert outputs in an
# order CUDA's atomics pick, so a rollout's top-4 routing can differ from
# run to run and the readings spread (1.595e-02 and 2.534e-02 in two runs
# of the same tree); about 3x the larger, its control reads 1.003
TP_MOE_LOGITS_REL_L2 = 7.5e-2


def tp_text_batch(vocab, mrope):
    """TP_EXTRA_ROWS left-padded text prompts of TP_EXTRA_PROMPT_LEN (the
    first whole, each next 17 tokens shorter), ids from a seed; M-RoPE's
    positions and deltas for a Qwen2.5-VL decoder."""
    rng = np.random.default_rng(38)
    P, B = TP_EXTRA_PROMPT_LEN, TP_EXTRA_ROWS
    ids = np.zeros((B, P), np.int64)
    mask = np.zeros((B, P), np.int64)
    for b in range(B):
        n = P - 17 * b
        ids[b, P - n:] = rng.integers(3, vocab - 1000, n)
        mask[b, P - n:] = 1
    batch = {"input_ids": torch.as_tensor(ids, device=DEVICE),
             "attention_mask": torch.as_tensor(mask, device=DEVICE)}
    if mrope:
        pos = (batch["attention_mask"].cumsum(1) - 1).clamp(min=0)
        batch["position_ids"] = pos[None].expand(3, B, P).contiguous()
        batch["mrope_deltas"] = pos[:, -1] + 1 - P
    return batch


def tp_rollout_check(bundle, params, batch, tp, lora=None, scale=1.0,
                     limit=TP_LOGITS_REL_L2) -> dict:
    """The tensor-parallel rollout as ``tp`` ranks one after another on
    the card (``run_sequential_ranks``, the rank-ordered sum as the
    all-reduce), each rank's copy made inside its turn
    (``tp_local_params``; ``tp_local_lora`` for the adapters, whose DoRA
    norms reduce over the ranks), against the unsharded rollout on the
    same parameters: the first step's logits within ``limit`` (relative
    L2), every rank the same greedy tokens; the control drops the last
    rank's partial sums and must exceed the limit.  Returns the readings and
    each rank's copy's shapes (``shapes(copy)``)."""
    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks
    from iadr1_tpu_torch.train.rollout import (
        RolloutEngine,
        SamplingConfig,
        tp_local_lora,
        tp_local_params,
    )

    tcfg = getattr(bundle.cfg, "text", bundle.cfg)
    P = batch["input_ids"].shape[1]
    sampling = SamplingConfig(max_new_tokens=TP_NEW_TOKENS, temperature=0.0,
                              eos_token_id=2, pad_token_id=0)
    engine = RolloutEngine(bundle, sampling, max_len=P + TP_NEW_TOKENS,
                           device=DEVICE, lora_scale=scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_logits, _ = engine.prefill(params, batch, lora=lora)
    want = engine.generate(params, batch, lora=lora)["completion_ids"]
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    axes = bundle.logical_axes()

    def copies(group):
        base = tp_local_params(params, axes, tcfg, group.rank, group.size,
                               torch.bfloat16)
        return base, (None if lora is None else tp_local_lora(
            lora, params, base, axes, tcfg, group, torch.bfloat16, scale))

    def rank(group):
        base, adapters = copies(group)
        logits, cache = engine.prefill(base, batch, lora=adapters)
        ids = engine.generate(base, batch, lora=adapters,
                              tp=group)["completion_ids"]
        text = base.get("text", base)
        layers = text["layers"]
        return logits, ids, {
            "q_heads": (layers["attn"]["q"]["kernel"].shape[-1]
                        // tcfg.head_dim_),
            "kv_heads": cache["k"].shape[2],
            "experts": (layers["mlp"]["experts"]["gate"]["kernel"].shape[1]
                        if "experts" in layers["mlp"] else None),
            "gb": sum(t.numel() * t.element_size()
                      for t in _tensors(text)) / 1e9}

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ranks = run_sequential_ranks(rank, tp)
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t1
    errs = [_rel_l2(logits, want_logits) for logits, _, _ in ranks]
    if max(errs) > limit or not all(
            torch.isfinite(lg).all() for lg, _, _ in ranks):
        raise AssertionError(f"tp rollout: first-step logits {errs} against "
                             f"the unsharded (limit {limit})")
    tokens = [ids for _, ids, _ in ranks]
    if not all(torch.equal(t, tokens[0]) for t in tokens):
        raise AssertionError("tp rollout: the ranks drew other tokens")

    def prefill(group):
        base, adapters = copies(group)
        return engine.prefill(base, batch, lora=adapters)[0]

    dropped = run_sequential_ranks(prefill, tp,
                                   reduce=lambda parts: sum(parts[:-1]))
    control = _rel_l2(dropped[0], want_logits)
    if not control > limit:
        raise AssertionError(f"tp rollout control (rank {tp - 1}'s partial "
                             f"sums dropped): {control:.3e} passed")
    return {"rel_l2": max(errs), "control": control,
            "agree": float((tokens[0] == want).float().mean()),
            "first": float((tokens[0][:, 0] == want[:, 0]).float().mean()),
            "whole_s": whole_s, "tp_s": tp_s,
            "shapes": [r[2] for r in ranks]}


def _count_from_zero():
    from iadr1_tpu_torch.kernels import all_kernels

    kernels = [k for k, _ in all_kernels()]
    for k in kernels:
        k.launches = 0
    return kernels


def _rollout_launches(kernels, label) -> dict:
    launches = {k.name: k.launches for k in kernels}
    if not (launches["flash_fwd"] and launches["decode_attention"]):
        raise AssertionError(f"{label} launches {launches}")
    return launches


def phase_tp_moe(card) -> dict:
    """Phase 37d: the MoE at tp = 4, Qwen1.5-MoE-A2.7B at its published
    widths (cut to TP_EXTRA_LAYERS layers), bf16 from seed 0: each rank
    its 15 of the 60 experts (``moe_block``: its own experts' pairs and
    the shared expert's row-parallel partial, one all-reduce a layer),
    ``tp_rollout_check``.  Returns the launches of the sharded and
    unsharded rollouts, counted from 0."""
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    t0 = time.perf_counter()
    bundle = bundle_from_hf_config(dict(QWEN15_MOE_A27B,
                                        num_hidden_layers=TP_EXTRA_LAYERS))
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    batch = tp_text_batch(QWEN15_MOE_A27B["vocab_size"], False)
    kernels = _count_from_zero()
    res = tp_rollout_check(bundle, params, batch, TP_MOE,
                           limit=TP_MOE_LOGITS_REL_L2)
    launches = _rollout_launches(kernels, "tp moe (37d)")
    experts = [s["experts"] for s in res["shapes"]]
    if experts != [QWEN15_MOE_A27B["num_experts"] // TP_MOE] * TP_MOE:
        raise AssertionError(f"tp moe (37d): experts a rank {experts}")
    del params
    log(f"tp moe (37d): Qwen1.5-MoE-A2.7B cut to {TP_EXTRA_LAYERS} layers "
        f"(bf16), {TP_EXTRA_ROWS} prompts of {TP_EXTRA_PROMPT_LEN}, "
        f"{TP_NEW_TOKENS} greedy steps, tp = {TP_MOE} as ranks one after "
        f"another, experts a rank {experts}, query / KV heads a rank "
        f"{res['shapes'][0]['q_heads']} / {res['shapes'][0]['kv_heads']}: "
        f"first-step logits against the unsharded rollout's, relative L2 "
        f"{res['rel_l2']:.3e} (limit {TP_MOE_LOGITS_REL_L2}); every rank the "
        f"same tokens, agreeing with the unsharded greedy tokens at "
        f"{res['agree']:.4f} of positions ({res['first']:.4f} of the first "
        f"tokens); the control (rank {TP_MOE - 1}'s partial sums dropped) "
        f"{res['control']:.3e}; the unsharded prefill and rollout "
        f"{res['whole_s']:.1f} s, the ranks' {res['tp_s']:.1f} s; launches "
        f"{launches}; {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def phase_tp_dora(card) -> dict:
    """Phase 37e: uneven heads and DoRA at tp = 8, Qwen2.5-VL-7B at its
    published widths (the decoder cut to TP_EXTRA_LAYERS layers), its
    bf16 base from seed 0 with DoRA adapters of rank TP_DORA_RANK on the
    seven projections (B and the magnitudes moved off their initial
    values from a seed, so that the direction and its column norms
    matter): 28 query heads as 4, 4, 4, 4, 3, 3, 3, 3, each rank the KV
    heads they read, the column norms of a row-parallel kernel reduced
    over the ranks (``tp_local_lora``), ``tp_rollout_check``.  Returns the
    launches, counted from 0."""
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.adapters import TuningConfig, init_lora_params

    t0 = time.perf_counter()
    bundle = bundle_from_hf_config(dict(QWEN2_5_VL_7B,
                                        num_hidden_layers=TP_EXTRA_LAYERS))
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=DEVICE)
    tuning = TuningConfig(finetuning_type="lora", lora_rank=TP_DORA_RANK,
                          lora_alpha=2.0 * TP_DORA_RANK, use_dora=True)
    gen = torch.Generator(device=DEVICE).manual_seed(39)
    lora = init_lora_params(gen, params, tuning)

    def move(tree):
        if isinstance(tree, dict):
            if "m" in tree:
                tree["b"].normal_(0.0, 0.02, generator=gen)
                tree["m"].mul_(1.0 + 0.05 * torch.rand(
                    tree["m"].shape, generator=gen, device=DEVICE).to(
                        tree["m"].dtype))
                return
            for v in tree.values():
                move(v)

    move(lora)
    batch = tp_text_batch(QWEN2_5_VL_7B["vocab_size"], True)
    kernels = _count_from_zero()
    res = tp_rollout_check(bundle, params, batch, TP_DORA, lora=lora,
                           scale=tuning.lora_scale)
    launches = _rollout_launches(kernels, "tp dora (37e)")
    heads = [s["q_heads"] for s in res["shapes"]]
    if heads != [4] * 4 + [3] * 4:
        raise AssertionError(f"tp dora (37e): query heads a rank {heads}")
    del params, lora
    log(f"tp dora (37e): Qwen2.5-VL-7B cut to {TP_EXTRA_LAYERS} decoder "
        f"layers (bf16 base), DoRA rank {TP_DORA_RANK} on q, k, v, o, gate, "
        f"up, down, {TP_EXTRA_ROWS} prompts of {TP_EXTRA_PROMPT_LEN}, "
        f"{TP_NEW_TOKENS} greedy steps, tp = {TP_DORA} as ranks one after "
        f"another, query heads a rank {heads}, KV heads "
        f"{[s['kv_heads'] for s in res['shapes']]}: first-step logits "
        f"against the unsharded rollout's with the same adapters, relative "
        f"L2 {res['rel_l2']:.3e} (limit {TP_LOGITS_REL_L2}); every rank the "
        f"same tokens, agreeing with the unsharded greedy tokens at "
        f"{res['agree']:.4f} of positions ({res['first']:.4f} of the first "
        f"tokens); the control (rank {TP_DORA - 1}'s partial sums dropped) "
        f"{res['control']:.3e}; the unsharded prefill and rollout "
        f"{res['whole_s']:.1f} s, the ranks' {res['tp_s']:.1f} s; launches "
        f"{launches}; {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def phase_tp(grpo_examples, card) -> dict:
    """Phase 37: (a) the tp shards of K1-K4 (``phase_tp_shards``); (b)
    the tensor-parallel rollout (``phase_tp_rollout``); (c) LoRA SC-GRPO
    on a one-rank group (``phase_tp_lora``).  Returns the launches of (b)
    and (c), counted from 0."""
    from iadr1_tpu_torch.kernels import all_kernels

    t0 = time.perf_counter()
    phase_tp_shards()
    log(f"phase 37a (tp shards): {time.perf_counter() - t0:.1f} s")
    kernels = [k for k, _ in all_kernels()]
    for k in kernels:
        k.launches = 0
    t1 = time.perf_counter()
    phase_tp_rollout(card)
    t2 = time.perf_counter()
    phase_tp_lora(grpo_examples, card)
    launches = {k.name: k.launches for k in kernels}
    log(f"phase 37b (tp rollout) {t2 - t1:.1f} s, 37c (tp lora grpo) "
        f"{time.perf_counter() - t2:.1f} s; launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"tp launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 36: the tools (chat, the web board, MMLU, the embedding backend,
# profiling, the commercial client, do_predict and the loss plot)
# ---------------------------------------------------------------------------

# which optional host packages import here: filled from the import probe
HOST_PACKAGES: dict = {}
# phase 36 runs in two parts: 36a on phase 4's generator, 36b on phase 10's
# SFT export; their seconds and launches add up to the tools path
TOOLS = {"s": 0.0, "launches": {}, "parts": []}
TOOLS_NEW_TOKENS, TOOLS_PATCH_BUDGET, TOOLS_IMAGE_HW = 32, 1024, (448, 448)
TRACE_NEW_TOKENS = 8
MMLU_SUBJECTS = {"surface_inspection": "STEM", "assembly_inspection": "Other"}
MMLU_MAX_LENGTH, MMLU_BATCH, MMLU_SHOTS = 1024, 4, 1
# the bundle embedding backend: 10 texts in chunks of 8 (the second holds
# 2 texts and 6 padding rows with no valid key); rows 1 and 2 repeat row 0
EMBED_TEXTS = [
    "a deep scratch along the upper edge of the plate",
    "a deep scratch along the upper edge of the plate",
    "a deep scratch along the upper edge of the plate",
    "no defect: the surface texture is regular everywhere",
    "a dent near the lower left corner, about two millimetres wide",
    "",
    "stain",
    "a missing screw in the second row of the assembly",
    "two parallel cracks that run from the hole to the rim of the part",
    "the weld seam is broken in the middle",
]
EMBED_MAX_LEN, EMBED_BATCH = 128, 8
# kernel vs plain: the relative L2 distance of the stacked unit vectors
EMBED_REL_L2 = 2e-2
# 36b: the board's training run of the SFT CLI in a child process on the
# card (1 step of 2 rows packed from 4 of phase 10's examples, then
# do_predict on 2 of them)
WEBUI_STEPS, WEBUI_EXAMPLES, WEBUI_PREDICT_ROWS = 1, 4, 2
WEBUI_TIMEOUT_S = 300
BOARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_tools_board")
# the board's run in flight between phase 10 and the end of the phases
BOARD_RUN: dict = {}


def host_packages(report: str) -> dict:
    """{name: imports} from the import probe's report line."""
    out = {}
    for item in report.split(", "):
        name, _, verdict = item.partition(" ")
        if name:
            out[name] = verdict == "yes"
    return out


def _tool_kernels():
    from iadr1_tpu_torch.kernels import all_kernels

    return [k for k, _ in all_kernels()]


def _launches(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def _add_tools(launches: dict, seconds: float, part: str) -> None:
    for name, n in launches.items():
        TOOLS["launches"][name] = TOOLS["launches"].get(name, 0) + n
    TOOLS["s"] += seconds
    TOOLS["parts"].append(f"{part} {seconds:.1f} s")


def twin_bundle(bundle):
    """A Qwen2-VL bundle whose attention (tower and decoder) is the K1
    twin: the plain path over the same parameters."""
    from iadr1_tpu_torch.models import qwen2_vl

    cfg = bundle.cfg

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return qwen2_vl.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            patches=batch.get("patches"), rot_cos=batch.get("rot_cos"),
            rot_sin=batch.get("rot_sin"),
            vision_segments=batch.get("vision_segments"),
            scatter_rows=batch.get("scatter_rows"),
            scatter_cols=batch.get("scatter_cols"),
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=bundle.precision,
            attention_fn=twin_attn, vision_attention_fn=twin_attn,
            remat=remat)

    return dataclasses.replace(bundle, apply=apply)


def write_mmlu_task(root: str, seed: int = 36) -> str:
    """Two subjects of 4 test items and 1 train item each, with their
    mapping.json, in eval/mmlu.py's layout."""
    rng = np.random.default_rng(seed)
    words = ("scratch dent crack stain hole seam plate screw edge corner "
             "surface texture rim weld bolt").split()

    def text(n):
        return " ".join(rng.choice(words, n))

    os.makedirs(root, exist_ok=True)
    mapping = {}
    for subject, category in MMLU_SUBJECTS.items():
        items = [{"question": f"Which defect does the {text(30)} show?",
                  **{c: text(6) for c in "ABCD"},
                  "answer": "ABCD"[int(rng.integers(4))]}
                 for _ in range(5)]
        with open(os.path.join(root, f"{subject}.json"), "w") as f:
            json.dump({"train": items[:1], "test": items[1:]}, f)
        mapping[subject] = {"name": subject.replace("_", " "),
                            "category": category}
    with open(os.path.join(root, "mapping.json"), "w") as f:
        json.dump(mapping, f)
    return root


def choice_logits_at(bundle, params, choice_ids, batch, back: int):
    """The f32 choice logits ``back`` positions before each row's last
    prompt position (0: eval/mmlu.py's own position)."""
    with torch.no_grad():
        hidden = bundle.hidden_fn(params, batch, remat=False)
    idx = (batch["segment_ids"].sum(dim=1) - 1 - back).clamp(min=0)
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    kernel = bundle.head_kernel_fn(params)
    return last.float() @ kernel[:, torch.as_tensor(
        choice_ids, device=kernel.device)].float()


def rel_l2(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def tools_mmlu(gen, root, kernels) -> dict:
    """36a: the MMLU evaluator over the serving weights, on the kernels
    and again on the plain path; returns the kernel run's launches.  The
    stand-in tokenizer encodes each character as its code point, so the
    choice letters are 4 distinct ids."""
    from iadr1_tpu_torch.eval.mmlu import MMLUEvaluator

    cfg = gen.bundle.cfg
    task = write_mmlu_task(os.path.join(root, "mmlu_task"))
    tok = StandInTokenizer([""])
    ev = MMLUEvaluator(gen.bundle, gen.params, tok, max_length=MMLU_MAX_LENGTH,
                       batch_size=MMLU_BATCH, device=DEVICE)
    batches, kernel_logits, per_batch = [], [], []
    logits_fn = ev._logits

    def recorded(params, batch):
        before = _launches(kernels)
        out = logits_fn(params, batch)
        torch.cuda.synchronize()
        per_batch.append({k: n - before[k]
                          for k, n in _launches(kernels).items()})
        batches.append(batch)
        kernel_logits.append(out)
        return out

    ev._logits = recorded
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    scores = ev.eval_task(task, n_shot=MMLU_SHOTS, seed=42,
                          save_dir=os.path.join(root, "mmlu_out"))
    torch.cuda.synchronize()
    mmlu_s = time.perf_counter() - t0
    launches = _launches(kernels)
    with open(os.path.join(root, "mmlu_out", "results.json")) as f:
        saved = json.load(f)
    letters = "".join(p for subject in MMLU_SUBJECTS
                      for p in saved["results"][subject].values())

    twin = twin_bundle(gen.bundle)
    twin_ev = MMLUEvaluator(twin, gen.params, tok, max_length=MMLU_MAX_LENGTH,
                            batch_size=MMLU_BATCH, device=DEVICE)
    twin_logits = [twin_ev._logits(gen.params, b) for b in batches]
    # the control: the columns of the next four letters (E-H) in place of
    # A-D; beside it, the logits one position early
    other_ids = [tok.encode(c)[-1] for c in "EFGH"]
    columns = [choice_logits_at(twin, gen.params, other_ids, b, back=0)
               for b in batches]
    early = [choice_logits_at(twin, gen.params, ev.choice_ids, b, back=1)
             for b in batches]
    if _launches(kernels) != launches:
        raise AssertionError("mmlu: the plain path launched a kernel")
    got, want = torch.cat(kernel_logits), torch.cat(twin_logits)
    rel, control = rel_l2(got, want), rel_l2(torch.cat(columns), want)
    early_rel = rel_l2(torch.cat(early), want)
    twin_letters = "".join("ABCD"[i] for i in want.argmax(dim=1).tolist())
    top2 = want.topk(2, dim=1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    n_items = 4 * len(MMLU_SUBJECTS)
    if (got.dtype != torch.float32 or got.shape != (n_items, 4)
            or not torch.isfinite(got).all()):
        raise AssertionError(f"mmlu: choice logits {got.dtype} "
                             f"{tuple(got.shape)}")
    if set(scores) != {"Average", *MMLU_SUBJECTS.values()} or (
            len(letters) != n_items or not set(letters) <= set("ABCD")):
        raise AssertionError(f"mmlu: scores {scores}, letters {letters!r}")
    if letters != twin_letters:
        raise AssertionError(f"mmlu: letters {letters!r} on the kernels, "
                             f"{twin_letters!r} on the plain path")
    if not rel <= LOGITS_REL_L2 or not control > LOGITS_REL_L2:
        raise AssertionError(
            f"mmlu: choice logits kernel vs plain rel L2 {rel:.3e}, the "
            f"control (letters E-H) {control:.3e}, limit {LOGITS_REL_L2}")
    want_batch = {"flash_fwd": cfg.text.num_hidden_layers, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0, "decode_attention": 0}
    if per_batch != [want_batch] * (n_items // MMLU_BATCH):
        raise AssertionError(f"mmlu: launches per batch {per_batch}, want "
                             f"{want_batch}")
    log(f"tools mmlu (36a): {n_items} items of {len(MMLU_SUBJECTS)} subjects, "
        f"{MMLU_SHOTS}-shot, max_length {MMLU_MAX_LENGTH}, batches of "
        f"{MMLU_BATCH}: letters {letters} (the plain path's {twin_letters}, "
        f"smallest top-2 margin {margin:.3e}), scores {scores}; f32 choice "
        f"logits kernel vs plain rel L2 {rel:.3e} (limit {LOGITS_REL_L2}; "
        f"the control, letters E-H's columns, {control:.3e}; the logits one "
        f"position early read {early_rel:.3e}); {mmlu_s:.2f} s; launches "
        f"per batch {per_batch[0]}")
    return launches


def tools_embeddings(gen, kernels) -> dict:
    """36a: the bundle embedding backend on the kernels against the plain
    path; returns the kernel run's launches."""
    from iadr1_tpu_torch.rewards import description

    tok = StandInTokenizer([""])
    kw = dict(max_len=EMBED_MAX_LEN, batch_size=EMBED_BATCH, device=DEVICE)
    embed = description.make_bundle_embedding_backend(
        gen.bundle, gen.params, tok, **kw)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    vecs = torch.tensor(embed(EMBED_TEXTS), dtype=torch.float64)
    embed_s = time.perf_counter() - t0
    launches = _launches(kernels)
    twin = torch.tensor(description.make_bundle_embedding_backend(
        twin_bundle(gen.bundle), gen.params, tok, **kw)(EMBED_TEXTS),
        dtype=torch.float64)
    if _launches(kernels) != launches:
        raise AssertionError("embeddings: the plain path launched a kernel")
    n = len(EMBED_TEXTS)
    # the control: each text's vector against the plain path's of the next
    # distinct text
    other = [3, 3, 3, 4, 5, 6, 7, 8, 9, 0]
    rel, control = rel_l2(vecs, twin), rel_l2(vecs, twin[other])
    norms = vecs.norm(dim=1)
    if vecs.shape != (n, gen.bundle.cfg.text.hidden_size) or not bool(
            torch.isfinite(vecs).all()):
        raise AssertionError(f"embeddings: {tuple(vecs.shape)}")
    if float((norms - 1).abs().max()) > 5e-3:
        raise AssertionError(f"embeddings: norms {norms.tolist()}")
    if not (torch.equal(vecs[0], vecs[1]) and torch.equal(vecs[0], vecs[2])):
        raise AssertionError("embeddings: a repeated text gave another "
                             "vector")
    if not rel <= EMBED_REL_L2 or not control > EMBED_REL_L2:
        raise AssertionError(f"embeddings: kernel vs plain rel L2 {rel:.3e}, "
                             f"the control {control:.3e}, limit "
                             f"{EMBED_REL_L2}")
    chunks = -(-n // EMBED_BATCH)
    want = {"flash_fwd": chunks * gen.bundle.cfg.text.num_hidden_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"embeddings: launches {launches}, want {want}")
    description.register_embedding_backend(embed)
    try:
        same = description.description_score(EMBED_TEXTS[0], EMBED_TEXTS[0])
        diff = description.description_score(EMBED_TEXTS[0], EMBED_TEXTS[6])
    finally:
        description.register_embedding_backend(None)
    if abs(same - 1.0) > 5e-3 or not 0.0 <= diff < same:
        raise AssertionError(f"embeddings: description scores {same}, {diff}")
    log(f"tools embeddings (36a): {n} texts (3 repeated, 1 empty) in "
        f"{chunks} chunks of {EMBED_BATCH} x {EMBED_MAX_LEN} in {embed_s:.2f} "
        f"s; norms within {float((norms - 1).abs().max()):.1e} of 1, "
        f"repeated texts bitwise equal; kernel vs plain rel L2 {rel:.3e} "
        f"(limit {EMBED_REL_L2}; the control, other texts' vectors, "
        f"{control:.3e}); description_score through the backend {same:.4f} "
        f"(same text), {diff:.4f} (other); launches {launches}")
    return launches


def write_tools_image(path: str, seed: int = 36) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (*TOOLS_IMAGE_HW, 3),
                                 np.uint8)).save(path)
    return path


def tools_chat(gen, root, kernels, card) -> dict:
    """36a: chat_loop, the web board's chat route, profiling and the
    commercial client over the serving weights; returns the launches of
    the loop, the route and the traced generate."""
    import copy
    import urllib.request

    from iadr1_tpu_torch.cli.chat import chat_loop
    from iadr1_tpu_torch.core import profiling
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.webui.app import PAGE, create_server

    cfg = gen.bundle.cfg
    tok = StandInTokenizer(CHAT_RESPONSES)
    chat_gen = VLMGenerator(
        gen.bundle, gen.params, tok, gen.template,
        GeneratorConfig(max_prompt_length=PROMPT_LEN,
                        max_new_tokens=TOOLS_NEW_TOKENS, temperature=0.0,
                        batch_size=1, patch_budget=TOOLS_PATCH_BUDGET),
        device=DEVICE)
    tap = GenerateTap(chat_gen.engine, kernels)
    image = write_tools_image(os.path.join(root, "query.png"))
    requests, written = [], []
    generate = chat_gen.generate

    def recorded(reqs):
        requests.append(copy.deepcopy(reqs))
        return generate(reqs)

    chat_gen.generate = recorded
    script = iter(["Are there any defects on the part?", f"/image {image}",
                   "Where is the defect?", "/clear",
                   "Describe the surface.", "/exit"])
    for k in kernels:
        k.launches = 0
    n_encoded = len(tok.encoded)
    t0 = time.perf_counter()
    chat_loop(chat_gen, lambda prompt: next(script), written.append)
    chat_s = time.perf_counter() - t0
    chat_launches = _launches(kernels)
    pads = [text.count("<|image_pad|>") for text in tok.encoded[n_encoded:]]
    n_img = (TOOLS_IMAGE_HW[0] // 28) * (TOOLS_IMAGE_HW[1] // 28)
    shapes = [(len(r[0]["messages"]), len(r[0]["images"])) for r in requests]
    if shapes != [(1, 0), (3, 1), (1, 0)] or pads != [0, n_img, 0]:
        raise AssertionError(f"chat: turns (messages, images) {shapes}, "
                             f"image tokens {pads}")
    if requests[1][0]["messages"][2]["content"] != "<image>Where is the defect?":
        raise AssertionError(f"chat: the image turn {requests[1]}")
    if len(tap.calls) != 3 or written[-1] != f"assistant> {CHAT_RESPONSES[2]}":
        raise AssertionError(f"chat: {len(tap.calls)} generates, {written}")
    for i, call in enumerate(tap.calls):
        check_batch_launches(f"chat turn {i + 1}", call, cfg)

    # the web board with a chat_fn over the same generator
    server = create_server(chat_fn=lambda message: chat_gen.generate(
        [{"messages": [{"role": "user", "content": message}]}])[0], port=0)
    port = server.start_background()
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(
            base + "/api/chat", data=json.dumps(
                {"message": "Any defects?"}).encode(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            reply = json.loads(resp.read())
        board_ms = 1e3 * (time.perf_counter() - t0)
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            page = resp.read().decode()
        with urllib.request.urlopen(base + "/api/progress",
                                    timeout=30) as resp:
            progress = json.loads(resp.read())
    finally:
        server.shutdown()
    if (reply.get("response") not in CHAT_RESPONSES or page != PAGE
            or progress != {"state": "idle", "returncode": None,
                            "n_records": 0}):
        raise AssertionError(f"board: {reply}, {progress}")
    check_batch_launches("board chat", tap.calls[-1], cfg)

    # one short generate (TRACE_NEW_TOKENS) under the device trace, inside
    # an annotated region and two wall-time spans
    trace_gen = VLMGenerator(
        gen.bundle, gen.params, tok, gen.template,
        dataclasses.replace(chat_gen.cfg, max_new_tokens=TRACE_NEW_TOKENS),
        device=DEVICE)
    trace_tap = GenerateTap(trace_gen.engine, kernels)
    profiling.drain_profiling_metrics()
    traced = profiling.profiling_decorator(VLMGenerator.generate)
    trace_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    with profiling.device_trace(trace_dir):
        with profiling.annotate("tools_chat_turn"), \
                profiling.profiling_context("tools/chat turn"):
            traced(trace_gen, [{"messages": [
                {"role": "user", "content": "Any defects?"}]}])
    trace_s = time.perf_counter() - t0
    spans = profiling.drain_profiling_metrics()
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    size_mb = os.path.getsize(path) / 1e6
    with open(path) as f:
        names = {e.get("name") or "" for e in json.load(f)["traceEvents"]}
    wanted = ("tools_chat_turn",) + (("flash_fwd_kernel",
                                      "decode_chunk_kernel")
                                     if DEVICE == "cuda" else ())
    found = {want: any(want in n for n in names) for want in wanted}
    if not all(found.values()) or sorted(spans) != [
            "profiling/Time taken: VLMGenerator.generate",
            "profiling/Time taken: tools/chat turn"]:
        raise AssertionError(f"profiling: trace names {found}, spans {spans}")
    check_batch_launches("traced chat", trace_tap.calls[-1], cfg)
    launches = _launches(kernels)
    log(f"tools chat (36a): chat_loop on the serving weights (batch 1, "
        f"{TOOLS_NEW_TOKENS} new tokens, greedy, patch budget "
        f"{TOOLS_PATCH_BUDGET}; replies decoded by the stand-in tokenizer): "
        f"3 turns with (messages, images) {shapes}, image tokens {pads} "
        f"(the tower runs over the patch budget every turn, in both "
        f"packages' generators), decode steps "
        f"{[c['steps'] for c in tap.calls[:3]]}, "
        f"{[round(1e3 * c['s'], 1) for c in tap.calls[:3]]} ms a turn, "
        f"{chat_s:.2f} s in all, launches {chat_launches}")
    log(f"tools board (36a): POST /api/chat answered in {board_ms:.1f} ms "
        f"({tap.calls[3]['steps']} decode steps), GET / and /api/progress "
        f"answered; profiling: a traced generate of "
        f"{trace_tap.calls[-1]['steps']} decode steps in {trace_s:.2f} s "
        f"(trace {size_mb:.1f} MB names {sorted(found)}), spans "
        f"{ {k: round(1e3 * v, 1) for k, v in spans.items()} } ms on {card}")
    return launches


def tools_commercial(root) -> None:
    """36a: the commercial client over 2 benchmark items with an injected
    transport (host code: no request leaves the machine)."""
    from PIL import Image

    from iadr1_tpu_torch.eval.commercial import APIConfig, run_commercial_eval

    bench = os.path.join(root, "commercial", "test_SynthAD_format.json")
    os.makedirs(os.path.dirname(bench), exist_ok=True)
    make_eval_benchmark(bench)
    with open(bench) as f:
        items = list(json.load(f))[:2]
    rng = np.random.default_rng(37)
    for rel in items:
        p = os.path.join(root, "commercial", rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (96, 128, 3),
                                     np.uint8)).save(p)
    payloads = []

    def transport(payload, headers):
        payloads.append(payload)
        return {"choices": [{"message": {"content": "Answer: B."}}]}

    t0 = time.perf_counter()
    path = run_commercial_eval(bench, os.path.join(root, "commercial"),
                               APIConfig(), os.path.join(root, "api"),
                               transport=transport, max_items=2)
    api_s = time.perf_counter() - t0
    with open(path) as f:
        answers = json.load(f)
    csv_path = path.replace(".json", "_accuracy.csv")
    if ([a["gpt_answer"] for a in answers] != ["B", "B"]
            or len(payloads) != 2 or not os.path.exists(csv_path)):
        raise AssertionError(f"commercial: {answers}, {len(payloads)} calls")
    log(f"tools commercial (36a): run_commercial_eval over 2 items with an "
        f"injected transport: 2 payloads, answers "
        f"{[a['gpt_answer'] for a in answers]}, the answers JSON and "
        f"{os.path.basename(csv_path)} written in {api_s:.2f} s")


def phase_tools_serving(gen, card) -> None:
    """Phase 36a: MMLU, the bundle embedding backend, chat_loop, the web
    board's chat route, profiling and the commercial client, on phase 4's
    full-width generator."""
    import shutil
    import tempfile

    kernels = _tool_kernels()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir=build)
    t0 = time.perf_counter()
    total = {}
    try:
        for launches in (tools_mmlu(gen, root, kernels),
                         tools_embeddings(gen, kernels),
                         tools_chat(gen, root, kernels, card)):
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
        tools_commercial(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _add_tools(total, time.perf_counter() - t0, "36a")


def phase_tools_chain(root: str, sft_export: str, data: dict, card) -> None:
    """Phase 36b, on phase 10's SFT export before the phase removes it:
    the web board's Runner launches a training run of the SFT CLI on the
    card, with do_predict and (where matplotlib imports) the loss plot, on
    a hard-linked copy of the export and the chain's data; the child runs
    beside the next phases (its imports of torch and transformers take
    most of its time) and ``finish_board_run`` checks it at the end.  In
    the meantime cli/chat.py's main runs here on a script of 2 turns."""
    import atexit
    import builtins
    import copy
    import shutil
    import urllib.request

    from iadr1_tpu_torch.cli import chat
    from iadr1_tpu_torch.eval import generator as generator_mod
    from iadr1_tpu_torch.webui.app import create_server

    kernels = _tool_kernels()
    t0 = time.perf_counter()
    # --- the board's training run, launched first ------------------------
    shutil.rmtree(BOARD_DIR, ignore_errors=True)
    export = os.path.join(BOARD_DIR, "sft_export")
    data_dir = os.path.join(BOARD_DIR, "data")
    shutil.copytree(sft_export, export, copy_function=os.link)
    shutil.copytree(os.path.dirname(data["sft"]), data_dir,
                    copy_function=os.link)
    scores = HOST_PACKAGES.get("jieba", False) and HOST_PACKAGES.get(
        "nltk", False)
    plot = HOST_PACKAGES.get("matplotlib", False)
    out = os.path.join(BOARD_DIR, "run")
    dataset = os.path.join(data_dir, os.path.basename(data["sft"]))
    form = {"stage": "sft", "model_name_or_path": export,
            "dataset": dataset, "template": "qwen2_vl",
            "cutoff_len": CUTOFF_LEN, "learning_rate": LEARNING_RATE,
            "max_steps": WEBUI_STEPS, "batch_size": TRAIN_ROWS,
            "logging_steps": 1, "output_dir": out,
            "extra": {"data.image_dir": data_dir,
                      "data.patch_budget": PATCH_BUDGET,
                      "data.ce_chunk": CE_CHUNK, "data.min_pixels": 3136,
                      "data.max_pixels": 480000,
                      "data.max_samples": WEBUI_EXAMPLES,
                      "train.keep_checkpoints": 1, "train.plot_loss": plot,
                      "predict.do_predict": True,
                      "predict.max_samples": WEBUI_PREDICT_ROWS,
                      "predict.max_new_tokens": TOOLS_NEW_TOKENS,
                      "predict.batch_size": WEBUI_PREDICT_ROWS}}
    if DEVICE == "cpu":                  # a rehearsal on the CPU
        form["device"] = "cpu"
    torch.cuda.empty_cache()
    server = create_server(port=0)
    base = f"http://127.0.0.1:{server.start_background()}"
    atexit.register(stop_board_run)      # the child never outlives the run
    BOARD_RUN.update(server=server, base=base, out=out, scores=scores,
                     plot=plot, launched=time.time(),
                     info=server.runner.launch(
                         form, extra_args=[] if scores
                         else ["--no-predict-scores"]))
    with urllib.request.urlopen(base + "/api/progress", timeout=30) as resp:
        BOARD_RUN["first_state"] = json.loads(resp.read())["state"]

    # --- cli/chat.py main, greedy, on the export -------------------------
    turns, script = [], iter(["w12 w345 w6789 w10", "w901 w23 w4567", "/exit"])
    through = generator_mod.VLMGenerator.generate

    def recorded(self, requests):
        out = through(self, requests)
        turns.append((self, copy.deepcopy(requests), out))
        return out

    real_input = builtins.input
    builtins.input = lambda prompt="": next(script)
    generator_mod.VLMGenerator.generate = recorded
    for k in kernels:
        k.launches = 0
    try:
        t_chat = time.perf_counter()
        rc = chat.main(["--model-path", sft_export, "--temperature", "0",
                        "--max-new-tokens", str(TOOLS_NEW_TOKENS // 2),
                        "--max-prompt-length", "256",
                        "--patch-budget", str(TOOLS_PATCH_BUDGET)]
                       + (["--device", "cpu"] if DEVICE == "cpu" else []))
        torch.cuda.synchronize()
        chat_s = time.perf_counter() - t_chat
    finally:
        builtins.input = real_input
        generator_mod.VLMGenerator.generate = through
    launches = _launches(kernels)
    cfg = turns[0][0].bundle.cfg if turns else None
    if rc != 0 or len(turns) != 2:
        raise AssertionError(f"chat main: rc {rc}, {len(turns)} turns")
    again = [gen.generate(requests) for gen, requests, _ in turns]
    if again != [out for _, _, out in turns]:
        raise AssertionError(f"chat main: replies {[o for *_, o in turns]}, "
                             f"its generator's {again}")
    if (len(turns[1][1][0]["messages"]) != 3
            or turns[1][1][0]["messages"][1]["content"] != turns[0][2][0]):
        raise AssertionError(f"chat main: the second turn {turns[1][1]}")
    depth = cfg.vision.depth + cfg.text.num_hidden_layers
    if (launches["flash_fwd"] != 2 * depth or launches["flash_bwd_dq"]
            or launches["flash_bwd_dkv"] or not launches["decode_attention"]
            or launches["decode_attention"] % cfg.text.num_hidden_layers):
        raise AssertionError(f"chat main: launches {launches}")
    log(f"tools chat main (36b): cli/chat.py's main on the SFT export "
        f"({cfg.text.num_hidden_layers} + {cfg.vision.depth} layers, bf16, "
        f"greedy, {TOOLS_NEW_TOKENS // 2} new tokens) over 2 scripted "
        f"turns in {chat_s:.2f} s, its load included, beside the board's "
        f"child starting; replies {[o[0][:40] for *_, o in turns]} equal "
        f"to its generator's for the same conversation; launches "
        f"{launches}")
    _add_tools(launches, time.perf_counter() - t0, "36b")


def stop_board_run() -> None:
    """Abort phase 36b's child if it still runs and stop the board."""
    if BOARD_RUN.get("server") is not None:
        BOARD_RUN["server"].runner.abort()
        BOARD_RUN["server"].shutdown()
        BOARD_RUN["server"] = None


def finish_board_run(card) -> None:
    """Phase 36b's end: poll /api/progress until the board's child has
    finished, then check what it wrote (the trainer log, the predictions,
    and the scores and the plot where their packages import)."""
    import shutil
    import urllib.request

    t0 = time.perf_counter()
    base, out = BOARD_RUN["base"], BOARD_RUN["out"]
    scores, plot = BOARD_RUN["scores"], BOARD_RUN["plot"]
    polls, progress = 0, {}
    try:
        deadline = time.perf_counter() + WEBUI_TIMEOUT_S
        while time.perf_counter() < deadline:
            with urllib.request.urlopen(base + "/api/progress",
                                        timeout=30) as resp:
                progress = json.loads(resp.read())
            polls += 1
            if progress["state"] == "finished":
                break
            time.sleep(0.25)
    finally:
        stop_board_run()
    wait_s = time.perf_counter() - t0
    with open(os.path.join(out, "webui_stdout.log")) as f:
        child_log = f.read()
    if (BOARD_RUN["first_state"] != "running"
            or progress.get("state") != "finished"
            or progress.get("returncode") != 0):
        raise AssertionError(
            f"board run: {BOARD_RUN['first_state']} after the launch, "
            f"{progress} at the end; the child's log ends "
            f"{child_log[-3000:]}")
    since = {name: os.path.getmtime(os.path.join(out, name))
             - BOARD_RUN["launched"] for name in (
                 "trainer_log.jsonl", "generated_predictions.jsonl")}
    with open(os.path.join(out, "trainer_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(out, "generated_predictions.jsonl")) as f:
        preds = [json.loads(line) for line in f]
    files = set(os.listdir(out))
    if (len(records) != WEBUI_STEPS or not math.isfinite(records[0]["loss"])
            or progress["n_records"] != WEBUI_STEPS):
        raise AssertionError(f"board run: trainer log {records}")
    if len(preds) != WEBUI_PREDICT_ROWS or any(
            set(p) != {"prompt", "label", "predict"} for p in preds):
        raise AssertionError(f"board run: predictions {preds}")
    if ("predict_results.json" in files) != scores or (
            "training_loss.png" in files) != plot:
        raise AssertionError(f"board run: files {sorted(files)} with "
                             f"jieba/nltk {scores}, matplotlib {plot}")
    results = {}
    if scores:
        with open(os.path.join(out, "predict_results.json")) as f:
            results = json.load(f)
    shutil.rmtree(BOARD_DIR, ignore_errors=True)
    info = BOARD_RUN["info"]
    log(f"tools board run (36b): Runner.launch ran "
        f"{' '.join(info['command'][1:3])} on the card ({WEBUI_STEPS} step "
        f"of {TRAIN_ROWS} x {CUTOFF_LEN} packed from {WEBUI_EXAMPLES} of the "
        f"chain's examples, from the SFT export, then do_predict on "
        f"{WEBUI_PREDICT_ROWS} rows, {TOOLS_NEW_TOKENS} new tokens) beside "
        f"the phases after 10: its step's record written "
        f"{since['trainer_log.jsonl']:.1f} s after the launch (the child's "
        f"own clock {records[0]['elapsed_time']} s after its logger "
        f"started), its predictions {since['generated_predictions.jsonl']:.1f}"
        f" s after; /api/progress said running after the launch and "
        f"finished with return code 0 at the end ({polls} polls, "
        f"{wait_s:.2f} s of waiting); loss {records[0]['loss']:.4f}; wrote "
        f"{sorted(files)}; the child said: " + " | ".join(
            line[:160] for line in child_log.splitlines()
            if line.startswith(("packed", "[step", "predictions saved",
                                "similarity"))))
    log("tools host packages (36b): on the card "
        + ("the similarity scores " + json.dumps(results) if scores else
           "the generation half of run_predict only (jieba/nltk absent: "
           "predict_results.json is held by the CPU tests)")
        + ("; the loss plot" if plot else "; no loss plot (matplotlib "
           "absent: plot_loss is held by the CPU tests)")
        + "; wandb reporting is held by the CPU tests (a fake wandb)")
    _add_tools({k.name: 0 for k in _tool_kernels()}, wait_s,
               "36b board wait")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new-tokens", type=int, default=128,
                    help="new tokens of the serving phase's generate")
    ap.add_argument("--train-steps", type=int, default=4,
                    help="PA-SFT steps of phases 6, 12, 14 and 19 (at "
                         "least 2; phases 20 and 22 take LORA_SFT_STEPS)")
    ap.add_argument("--grpo-steps", type=int, default=2,
                    help="SC-GRPO steps of phase 7 (at least 1; phases 15 "
                         "and 16 take at most 2), each a rollout of "
                         "the recipe's 512 tokens")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers to run (3-37; "
                         "4, 5, 8 and 9 run together, and 36 brings 4 "
                         "and 10), for a partial run that prints no "
                         "kernel line; default: all")
    ap.add_argument("--opt-plain-leaves", action="store_true",
                    help="run phase 33d's optimizers on plain leaves with "
                         "no process group (the single-card path) instead "
                         "of on the one-rank mesh")
    ap.add_argument("--pad-compare", action="store_true",
                    help="also time K1-K3 at the SigLIP tower with q, k, v "
                         "and dO padded to 80 in the wrapper, beside the "
                         "in-kernel padding")
    args = ap.parse_args()
    if args.train_steps < 2:
        ap.error("--train-steps must be at least 2")
    if args.grpo_steps < 1:
        ap.error("--grpo-steps must be at least 1")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from iadr1_tpu_torch.data import native
    from iadr1_tpu_torch.kernels import all_kernels
    from iadr1_tpu_torch.kernels._build import finish_build, start_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    # the import probe and the kernels' build run beside the host's
    # making of every phase's requests and rows
    t_build = time.perf_counter()
    imports = importable(("tokenizers", "safetensors", "PIL", "pandas",
                          "yaml", "transformers", "jieba", "nltk",
                          "matplotlib", "wandb", "requests"))
    kernels = all_kernels()
    native_build = native.start_build()
    building = start_build([k.source for k, _ in kernels])
    native.finish_build(native_build)
    native_s = time.perf_counter() - t_build
    encoded = make_requests()
    train_rows = make_sft_rows()
    grpo_examples = make_grpo_examples()
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    llava = bundle_from_hf_config(LLAVA_OV_05B)       # host side only
    llava_encoded = make_llava_requests(llava)
    llava_rows = make_llava_sft_rows(llava, LLAVA_SFT_CUTOFF)
    q25_encoded = make_q25_requests()
    q25_rows = make_q25_sft_rows(Q25_SFT_CUTOFF)
    q25_grpo_examples = make_q25_grpo_examples()
    ov_grpo_examples = make_ov_grpo_examples(llava)
    next_bundle = bundle_from_hf_config(LLAVA_NEXT_8B)   # host side only
    next_encoded, next_feature_lens = make_next_requests(next_bundle)
    next_rows = make_next_sft_rows(next_bundle, NEXT_SFT_CUTOFF)
    v15_encoded = make_v15_requests(bundle_from_hf_config(LLAVA_15_7B))
    lora_rows = make_q25_lora_sft_rows(Q25_SFT_CUTOFF)
    intern = bundle_from_hf_config(INTERNVL_25_4B)    # host side only
    intern_encoded = make_internvl_requests(intern)
    intern_rows = make_internvl_sft_rows(intern, Q25_SFT_CUTOFF)
    intern_grpo = make_internvl_grpo_examples(intern)
    video_rows = make_video_sft_rows(Q25_SFT_CUTOFF)
    lnv_examples = make_video_examples(
        bundle_from_hf_config(LLAVA_NEXT_VIDEO_7B), seed=23)
    vllava_hf = dict(VIDEO_LLAVA_7B, text_config=dict(
        VIDEO_LLAVA_7B["text_config"], num_hidden_layers=VLLAVA_LAYERS))
    vllava_examples = make_video_examples(bundle_from_hf_config(vllava_hf),
                                          seed=24)
    pg = bundle_from_hf_config(PALIGEMMA_3B_448)      # host side only
    pg_encoded = make_paligemma_requests(pg)
    pg_rows = make_paligemma_sft_rows(pg, Q25_SFT_CUTOFF)
    pg_grpo = make_paligemma_grpo_examples(pg)
    px = bundle_from_hf_config(PIXTRAL_12B)           # host side only
    px_encoded = make_pixtral_requests(px)
    px_rows = make_pixtral_sft_rows(px, Q25_SFT_CUTOFF)
    px_grpo = make_pixtral_grpo_examples(px)
    moe_requests = make_moe_requests()
    moe_rows = make_text_sft_rows(MOE_SFT_ROWS, MOE_SFT_CUTOFF, seed=32)
    moe_grpo = make_moe_grpo_examples()
    longlora_rows = make_next_sft_rows(next_bundle, LONGLORA_CUTOFF, seed=35,
                                       n_rows=LONGLORA_ROWS,
                                       per_row=LONGLORA_PER_ROW)
    mod_rows = make_text_sft_rows(MOD_ROWS, MOD_CUTOFF, seed=34)
    sft34_rows = make_text_sft_rows(SFT34_ROWS, SFT34_CUTOFF, seed=37)
    data_s = time.perf_counter() - t_build
    finish_build(building)
    log(f"build: {len(kernels)} kernels from iadr1_tpu_torch/csrc for "
        f"sm_90a in {time.perf_counter() - t_build:.1f} s, the native "
        f"packing plane in {native_s:.2f} s, beside the requests and rows "
        f"of every phase ({data_s:.1f} s)")
    report = imports()
    HOST_PACKAGES.update(host_packages(report))
    log("imports: " + report)
    phases = (set(range(1, 38)) if args.phases is None
              else {int(x) for x in args.phases.split(",")})
    if 36 in phases:                 # 36a runs on phase 4's generator, 36b
        phases |= {4, 10}            # on phase 10's SFT export
    by_path, measured = {}, None
    t0 = time.perf_counter()
    if 3 in phases:
        measured = phase_kernels(encoded, args.max_new_tokens, train_rows,
                                 grpo_examples)
        group_s = {"qwen2_vl": time.perf_counter() - t0}
        for group, cases in (
                ("llava", lambda: phase_kernels_llava(
                    llava_encoded, llava_rows, args.max_new_tokens,
                    args.pad_compare)),
                ("q25", lambda: phase_kernels_q25(
                    q25_encoded, q25_rows, q25_grpo_examples,
                    args.max_new_tokens, lora_rows)),
                ("llava families", lambda: phase_kernels_llava_families(
                    next_encoded, v15_encoded, next_rows, ov_grpo_examples,
                    args.max_new_tokens)),
                ("internvl and video", lambda: phase_kernels_internvl_video(
                    intern_encoded, intern_rows, intern_grpo, video_rows,
                    VIDEO_SFT_BUDGET, args.max_new_tokens)),
                ("paligemma and pixtral",
                 lambda: phase_kernels_paligemma_pixtral(
                     pg_encoded, pg_grpo, px_encoded, px_rows, px_grpo,
                     args.max_new_tokens)),
                ("moe and context", lambda: phase_kernels_moe_context(
                    moe_requests, moe_grpo, longlora_rows, mod_rows,
                    args.max_new_tokens)),
                ("pref", phase_kernels_pref),
                ("sft extras", lambda: phase_kernels_sft_extras(
                    sft34_rows))):
            t_group = time.perf_counter()
            for name, results in cases().items():
                measured[name] += results
            group_s[group] = time.perf_counter() - t_group
        log(f"phase 3 (kernels): {time.perf_counter() - t0:.1f} s ("
            + ", ".join(f"{g} {s:.1f}" for g, s in group_s.items()) + ")")
    if phases & {4, 5, 8, 9}:
        t0 = time.perf_counter()
        by_path["serve"], gen, batch = phase_main(
            encoded, args.max_new_tokens, card)
        phase_profile("serve", gen, batch)
        by_path["eval"] = phase_eval(gen, card)
        by_path["chat"] = phase_chat(gen, card)
        if 36 in phases:
            phase_tools_serving(gen, card)
        del gen, batch
        torch.cuda.empty_cache()
        log(f"phases 4, 5, 8, 9 (serve, eval, chat): "
            f"{time.perf_counter() - t0:.1f} s")
    q25_steps = min(args.grpo_steps, Q25_GRPO_STEPS)
    ov_steps = min(args.grpo_steps, OV_GRPO_STEPS)
    intern_steps = min(args.grpo_steps, INTERNVL_GRPO_STEPS)
    pg_steps = min(args.grpo_steps, PG_GRPO_STEPS)
    px_steps = min(args.grpo_steps, PX_GRPO_STEPS)
    moe_steps = min(args.grpo_steps, MOE_GRPO_STEPS)
    q25_cut = dict(QWEN2_5_VL_3B, num_hidden_layers=Q25_GRPO_LAYERS)
    for n, path, run in (
        (6, "train", lambda: phase_train(train_rows, args.train_steps, card)),
        (7, "grpo", lambda: phase_grpo(grpo_examples, args.grpo_steps, card,
                                       grpo_case_qwen2_vl())),
        (10, "chain", lambda: phase_chain(
            card, phase_tools_chain if 36 in phases else None)),
        (11, "llava_serve", lambda: phase_llava_serve(
            llava_encoded, args.max_new_tokens, card)),
        (12, "llava_sft", lambda: phase_llava_sft(
            llava_rows, args.train_steps, card)),
        (13, "q25_serve", lambda: phase_q25_serve(
            q25_encoded, args.max_new_tokens, card)),
        (14, "q25_sft", lambda: phase_q25_sft(
            q25_rows, args.train_steps, card)),
        (15, "q25_grpo", lambda: phase_grpo(
            q25_grpo_examples, q25_steps, card, grpo_case_q25(
                q25_steps, name=f"Qwen2.5-VL-3B cut to {Q25_GRPO_LAYERS} "
                "decoder layers", hf=q25_cut))),
        (16, "llava_grpo", lambda: phase_grpo(
            ov_grpo_examples, ov_steps, card, grpo_case_ov(ov_steps))),
        (17, "llava16_serve", lambda: phase_next_serve(
            next_encoded, next_feature_lens, args.max_new_tokens, card)),
        (18, "llava15_serve", lambda: phase_v15_serve(
            v15_encoded, args.max_new_tokens, card)),
        (19, "llava16_sft", lambda: phase_next_sft(
            next_rows, args.train_steps, card)),
        (20, "q25_lora_sft", lambda: phase_lora_sft_q25(
            lora_rows, LORA_SFT_STEPS, card)),
        (21, "q25_lora_grpo", lambda: phase_lora_grpo(card)),
        (22, "llava16_qlora_sft", lambda: phase_qlora_sft_next(
            next_rows, LORA_SFT_STEPS, card)),
        (22, "q25_int8_serve", lambda: phase_quant_serve(
            q25_encoded, min(args.max_new_tokens, INT8_NEW_TOKENS), card,
            "int8")),
        (22, "q25_nf4_serve", lambda: phase_quant_serve(
            q25_encoded, NF4_NEW_TOKENS, card, "nf4", NF4_LAYERS)),
        (23, "internvl_serve", lambda: phase_internvl_serve(
            intern_encoded, args.max_new_tokens, card)),
        (24, "internvl_sft", lambda: phase_internvl_sft(
            intern_rows, INTERNVL_SFT_STEPS, card)),
        (25, "internvl_grpo", lambda: phase_grpo(
            intern_grpo, intern_steps, card,
            grpo_case_internvl(intern_steps))),
        (26, "q2vl_video_sft", lambda: phase_video_sft(
            video_rows, INTERNVL_SFT_STEPS, card)),
        (26, "lnv_video_rollout", lambda: phase_video_rollout(
            "lnv video rollout", "LLaVA-NeXT-Video-7B", LLAVA_NEXT_VIDEO_7B,
            lnv_examples, LNV_PROMPT_LEN, card)),
        (26, "vllava_video_rollout", lambda: phase_video_rollout(
            "video-llava rollout", f"Video-LLaVA-7B cut to {VLLAVA_LAYERS} "
            "decoder layers", vllava_hf, vllava_examples, VLLAVA_PROMPT_LEN,
            card)),
        (27, "paligemma_serve", lambda: phase_paligemma_serve(
            pg_encoded, args.max_new_tokens, card)),
        (27, "paligemma_sft", lambda: phase_paligemma_sft(
            pg_rows, PG_SFT_STEPS, card)),
        (27, "paligemma_grpo", lambda: phase_grpo(
            pg_grpo, pg_steps, card, grpo_case_paligemma(pg_steps))),
        (28, "pixtral_serve", lambda: phase_pixtral_serve(
            px_encoded, args.max_new_tokens, card)),
        (28, "pixtral_lora_sft", lambda: phase_pixtral_lora_sft(
            px_rows, PX_SFT_STEPS, card)),
        (28, "pixtral_lora_grpo", lambda: phase_grpo(
            px_grpo, px_steps, card, grpo_case_pixtral(px_steps))),
        (29, "moe_serve", lambda: phase_moe_serve(
            moe_requests, args.max_new_tokens, card)),
        (29, "moe_sft", lambda: phase_moe_sft(
            moe_rows, MOE_SFT_STEPS, card)),
        (29, "moe_grpo", lambda: phase_grpo(
            moe_grpo, moe_steps, card, grpo_case_moe(moe_steps))),
        (30, "longlora_sft", lambda: phase_longlora_sft(
            longlora_rows, LONGLORA_STEPS, card)),
        (31, "mod_train", lambda: phase_mod_train(
            mod_rows, MOD_STEPS, card)),
        (32, "pref", lambda: phase_pref(card)),
        (33, "pref33", lambda: phase_pref33(card)),
        (33, "optimizers", lambda: phase_optimizers(
            train_rows, card, args.opt_plain_leaves)),
        (34, "sft_extras", lambda: phase_sft_extras(sft34_rows, native_s,
                                                    card)),
        (35, "mesh", lambda: phase_mesh(train_rows, grpo_examples, card)),
        (37, "tp", lambda: phase_tp(grpo_examples, card)),
        (37, "tp_moe", lambda: phase_tp_moe(card)),
        (37, "tp_dora", lambda: phase_tp_dora(card)),
    ):
        if n in phases:
            t0 = time.perf_counter()
            by_path[path] = run()
            torch.cuda.empty_cache()
            log(f"phase {n} ({path}): {time.perf_counter() - t0:.1f} s")
            read_profiles(wait=False)
    if BOARD_RUN:
        finish_board_run(card)
    read_profiles(wait=True)
    if 36 in phases:
        by_path["tools"] = dict(TOOLS["launches"])
        log(f"phase 36 (tools): {TOOLS['s']:.1f} s ("
            + ", ".join(TOOLS["parts"]) + ")")
    if not set(range(3, 38)) <= phases:
        # a partial run's launch counts cover only the chosen phases
        log(f"partial run, phases {sorted(phases)} only: no kernel line")
        print(gpu_line())
        return 0

    for name, cases in TP_SHARD_CASES.items():       # phase 37a's shards
        measured[name] += cases
    line = []
    for k, replaces in kernels:
        main_case, *others = measured[k.name]
        entry = {"name": k.name, "route": "cuda",
                 "source": f"iadr1_tpu_torch/csrc/{k.source}",
                 "replaces": replaces,
                 "launches_by_path": {path: counts[k.name]
                                      for path, counts in by_path.items()}}
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
