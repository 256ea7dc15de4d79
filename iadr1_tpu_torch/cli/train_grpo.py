"""SC-GRPO launcher (counterpart of iadr1_tpu/cli/train_grpo.py): a json
dataset of {image, problem, solution} rows, the 0-shot/1-shot IAD prompt
templates, a reward-function list (default accuracy + format), G-way
rollouts and the SC-GRPO update, full-parameter; runs on the card unless
given ``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.train_grpo --config grpo.yaml \
        grpo.num_generations=4 train.max_steps=100 [--device cpu]

``require_ported`` names the ROADMAP item each option the port cannot run
yet waits for: a mesh of more than one device (A.11), LoRA and quantized
bases (A.12).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from iadr1_tpu_torch.cli.train_sft import add_device_argument, mesh_devices
from iadr1_tpu_torch.vision.mrope import get_mrope_positions


@dataclasses.dataclass
class GRPOModelSection:
    model_name_or_path: str = ""
    hf_config: dict | None = None
    attention: str = "auto"
    dtype: str = "float32"
    ref_dtype: str = "bfloat16"       # the frozen reference copy's precision
    seed: int = 0
    # a quantized base under LoRA (ROADMAP A.12)
    quant: str = "none"               # none | int8 | int4 | nf4
    quant_block: int = 64             # blockwise scale granularity (int4/nf4)


@dataclasses.dataclass
class GRPODataSection:
    dataset_name: str = ""            # RL json: [{image, problem, solution}]
    image_path: str | None = None
    use_system_prompt: bool = False
    single_img: int = 1
    template: str = "qwen2_vl"
    max_samples: int | None = None
    patch_budget: int = 4096
    min_pixels: int = 3136
    max_pixels: int = 480000


@dataclasses.dataclass
class GRPOSection:
    num_generations: int = 4
    beta: float = 0.04
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    max_prompt_length: int = 1024
    max_completion_length: int = 512
    # approximate top-k: a TPU speed knob; the port samples exactly
    approx_top_k: bool = False
    # periodic reference refresh
    sync_ref_model: bool = False
    ref_model_mixup_alpha: float = 0.6
    ref_model_sync_steps: int = 512
    reward_funcs: list = dataclasses.field(
        default_factory=lambda: ["accuracy", "format"])


@dataclasses.dataclass
class GRPOTuningSection:
    # "lora": factored adapters over a frozen bf16 base that is also the KL
    # reference (ROADMAP A.12)
    finetuning_type: str = "full"     # full | lora
    lora_rank: int = 8
    lora_alpha: float = 16.0
    use_dora: bool = False
    use_rslora: bool = False
    pissa_init: bool = False


@dataclasses.dataclass
class GRPOJobConfig:
    model: GRPOModelSection = dataclasses.field(default_factory=GRPOModelSection)
    data: GRPODataSection = dataclasses.field(default_factory=GRPODataSection)
    grpo: GRPOSection = dataclasses.field(default_factory=GRPOSection)
    finetuning: GRPOTuningSection = dataclasses.field(
        default_factory=GRPOTuningSection)
    mesh: dict = dataclasses.field(default_factory=dict)
    optim: dict = dataclasses.field(default_factory=dict)
    train: dict = dataclasses.field(default_factory=dict)


def require_ported(job: GRPOJobConfig) -> None:
    """Raise for an option the port cannot run yet, naming its item."""
    if mesh_devices(job.mesh) > 1:
        raise NotImplementedError(
            f"a mesh of more than one device ({job.mesh}) is not ported yet "
            "(ROADMAP A.11)")
    if job.finetuning.finetuning_type != "full" or job.model.quant != "none":
        raise NotImplementedError(
            "LoRA and quantized bases are not ported yet (ROADMAP A.12)")


def make_vlm_prompt_collator(bundle, tokenizer, template, cfg: GRPODataSection,
                             max_prompt_length: int, num_generations: int = 1):
    """(examples, G) -> rollout batch (numpy) with the vision arrays and
    the M-RoPE grids.

    Each example carries pre-encoded ``prompt_ids`` plus preprocessed
    ``patches`` and ``grid_thw``; prompts repeat G times consecutively.
    ``cfg.patch_budget`` sizes the G = num_generations (update) collation;
    the G = 1 rollout collation scales it down by the group factor, so the
    prefix-cached prefill's tower does not run over a patch stream padded
    G times too long."""
    pad = tokenizer.pad_token_id or tokenizer.eos_token_id
    img_id = getattr(bundle.cfg, "image_token_id", None)
    tcfg = getattr(bundle.cfg, "text", bundle.cfg)

    def collate(examples, G):
        P = max_prompt_length
        budget = max(cfg.patch_budget * G // max(num_generations, 1), 8)
        rows = [ex for ex in examples for _ in range(G)]
        B = len(rows)
        input_ids = np.full((B, P), pad, np.int64)
        mask = np.zeros((B, P), np.int64)
        patches_list, grids = [], []
        for i, ex in enumerate(rows):
            if ex.get("video_patches"):
                raise NotImplementedError(
                    "video prompts are not ported yet (ROADMAP A.13)")
            ids = ex["prompt_ids"][-P:]
            if len(ex["prompt_ids"]) > P and img_id is not None and (
                img_id in ex["prompt_ids"]
            ):
                # truncating through an image-token run would desynchronize
                # the feature scatter indices: VLM prompts must fit whole
                raise ValueError(
                    f"VLM prompt ({len(ex['prompt_ids'])} tokens) exceeds "
                    f"max_prompt_length={P}; raise max_prompt_length or "
                    "lower max_pixels")
            input_ids[i, P - len(ids):] = ids
            mask[i, P - len(ids):] = 1
            patches_list.extend(ex.get("patches", []))
            grids.extend(ex.get("grid_thw", []))
        batch = {"input_ids": input_ids, "attention_mask": mask}
        if tcfg.mrope_section is not None:
            grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
            batch["position_ids"], batch["mrope_deltas"] = get_mrope_positions(
                input_ids, grid_thw if len(grids) else None,
                bundle.cfg.image_token_id, bundle.cfg.vision_start_token_id,
                attention_mask=mask)
        batch.update(bundle.vision_arrays(input_ids, patches_list, grids,
                                          budget))
        return batch

    return collate


def encode_rl_examples(rows, cfg: GRPODataSection, bundle, tokenizer,
                       template) -> list[dict]:
    """RL rows -> conversations -> {"prompt_ids", "solution"} (+ the
    images' ``patches`` and ``grid_thw`` for a VLM)."""
    from iadr1_tpu_torch.data.mm import expand_image_tokens
    from iadr1_tpu_torch.train.prompts import make_conversation

    examples = []
    for row in rows:
        conv = make_conversation(
            row, image_path=cfg.image_path,
            use_system_prompt=cfg.use_system_prompt,
            single_img=cfg.single_img)
        ex = {"solution": conv["solution"]}
        messages = conv["messages"]
        if bundle.multimodal and conv["images"]:
            from PIL import Image

            patches, grids, seqlens = [], [], []
            for img in conv["images"]:
                pil = Image.open(img) if isinstance(img, str) else img
                flat, grid, seqlen = bundle.preprocess_image(
                    pil, min_pixels=cfg.min_pixels, max_pixels=cfg.max_pixels)
                patches.append(flat)
                grids.append(grid)
                seqlens.append(seqlen)
            messages = expand_image_tokens(
                messages, seqlens, template.mm_style, template.image_token)
            ex.update(patches=patches, grid_thw=grids)
        ex["prompt_ids"] = template.encode_prompt(
            tokenizer, messages, system=conv["system"])
        examples.append(ex)
    return examples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    add_device_argument(parser)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from iadr1_tpu_torch.core.config import dataclass_from_dict, load_config
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.registry import (
        bundle_from_hf_config,
        bundle_from_pretrained,
    )
    from iadr1_tpu_torch.rewards import get_reward_funcs
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer
    from iadr1_tpu_torch.train.loop import JsonlLogger, LoopConfig
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import (
        create_train_state,
        named_leaves,
        unflatten,
    )

    cfg = load_config(GRPOJobConfig, args.config, args.overrides)
    require_ported(cfg)
    device = resolve_device(args.device)
    loop_cfg = dataclass_from_dict(LoopConfig, cfg.train)
    opt_cfg = dataclass_from_dict(OptimizerConfig, cfg.optim)
    grpo_cfg = GRPOConfig(
        num_generations=cfg.grpo.num_generations, beta=cfg.grpo.beta,
        temperature=cfg.grpo.temperature, top_p=cfg.grpo.top_p,
        top_k=cfg.grpo.top_k, max_prompt_length=cfg.grpo.max_prompt_length,
        max_completion_length=cfg.grpo.max_completion_length,
        sync_ref_model=cfg.grpo.sync_ref_model,
        ref_model_mixup_alpha=cfg.grpo.ref_model_mixup_alpha,
        ref_model_sync_steps=cfg.grpo.ref_model_sync_steps,
    )
    sampling_overrides = (
        {"approx_top_k": True} if cfg.grpo.approx_top_k else None)

    dtype = getattr(torch, cfg.model.dtype)
    if cfg.model.hf_config:
        bundle = bundle_from_hf_config(cfg.model.hf_config,
                                       attention=cfg.model.attention)
        params = bundle.init_params(seed=cfg.model.seed, dtype=dtype,
                                    device=device)
    else:
        bundle = bundle_from_pretrained(cfg.model.model_name_or_path,
                                        attention=cfg.model.attention)
        params = bundle.convert_hf(
            load_safetensors_path(cfg.model.model_name_or_path), dtype=dtype,
            device=device)
    tokenizer = AutoTokenizer.from_pretrained(cfg.model.model_name_or_path)
    template = get_template(cfg.data.template)

    with open(cfg.data.dataset_name) as f:
        rows = json.load(f)
    if cfg.data.max_samples:
        rows = rows[: cfg.data.max_samples]
    examples = encode_rl_examples(rows, cfg.data, bundle, tokenizer,
                                  template)
    print(f"prepared {len(examples)} RL prompts")

    if not opt_cfg.total_steps:
        opt_cfg = dataclasses.replace(opt_cfg, total_steps=loop_cfg.max_steps)
    optimizer, schedule = make_optimizer(opt_cfg)
    collator = (
        make_vlm_prompt_collator(bundle, tokenizer, template, cfg.data,
                                 grpo_cfg.max_prompt_length,
                                 num_generations=grpo_cfg.num_generations)
        if bundle.multimodal else None)
    # the frozen reference: a copy in ref_dtype, never the policy's own
    # tensors (the policy is updated in place)
    ref_dtype = getattr(torch, cfg.model.ref_dtype)
    ref_params = unflatten({name: p.detach().to(ref_dtype, copy=True)
                            for name, p in named_leaves(params)})
    trainer = GRPOTrainer(
        bundle, tokenizer, optimizer, grpo_cfg,
        get_reward_funcs(cfg.grpo.reward_funcs),
        create_train_state(params, optimizer), ref_params,
        sampling_overrides=sampling_overrides, schedule=schedule,
        template=template, prompt_collator=collator, device=device,
        seed=loop_cfg.seed)
    del params, ref_params

    logger = JsonlLogger(loop_cfg.output_dir, loop_cfg.max_steps)
    ckpt = CheckpointManager(
        os.path.join(loop_cfg.output_dir, "checkpoints"),
        max_to_keep=loop_cfg.keep_checkpoints)
    start_step = 0
    if loop_cfg.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            trainer.state = ckpt.restore(trainer.state)
            trainer.fast_forward_rng(latest)
            start_step = latest
            print(f"resumed from checkpoint step {latest}")
    rng = np.random.default_rng(loop_cfg.seed)
    per_step = max(loop_cfg.batch_size, 1)
    try:
        for step_idx in range(1, loop_cfg.max_steps + 1):
            # the prompt stream is drawn every step, so a resumed run sees
            # the examples an uninterrupted one would
            idx = rng.choice(len(examples), size=per_step, replace=False)
            if step_idx <= start_step:
                continue
            metrics = trainer.step([examples[i] for i in idx])
            if step_idx % max(loop_cfg.logging_steps, 1) == 0:
                logger.log(step_idx, metrics)
            if loop_cfg.save_steps and step_idx % loop_cfg.save_steps == 0:
                ckpt.save(step_idx, trainer.state)
        ckpt.save(loop_cfg.max_steps, trainer.state)
        ckpt.wait()
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
