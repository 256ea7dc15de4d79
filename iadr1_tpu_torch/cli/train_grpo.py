"""SC-GRPO launcher (counterpart of iadr1_tpu/cli/train_grpo.py): a json
dataset of {image, problem, solution} rows, the 0-shot/1-shot IAD prompt
templates, a reward-function list (default accuracy + format), G-way
rollouts and the SC-GRPO update, full-parameter or LoRA (``finetuning``
section: LoRA, DoRA, rsLoRA, PiSSA) over a bf16 or quantized base
(``model.quant``: int8, int4, nf4, or gptq / awq for a prequantized
checkpoint); runs on the card unless given ``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.train_grpo --config grpo.yaml \
        grpo.num_generations=4 train.max_steps=100 [--device cpu]

A LoRA run checkpoints its adapters and their moments only; the base is
the KL reference (reference elision: one copy of the base weights).  On a
mesh (``torchrun --nproc_per_node N -m iadr1_tpu_torch.cli.train_grpo``
with a ``mesh:`` section) the policy and the reference (in LoRA mode the
base and the adapters; a quantized base replicates) are sharded by the
family's logical axes, each rank loads only its own shards, each rolls
out its share of every step's prompts, at tp > 1 with a tensor-parallel
decode (``train/rollout.py``), and PiSSA's initialization factors each
kernel on rank 0 and broadcasts the adapters and the residual
(``train/adapters.py pissa_init``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from iadr1_tpu_torch.cli.train_sft import (
    add_device_argument,
    load_checkpoint,
    shard_for_mesh,
)
from iadr1_tpu_torch.data.collator import NO_FRAME_STACKS
from iadr1_tpu_torch.vision.mrope import bundle_mrope_positions


@dataclasses.dataclass
class GRPOModelSection:
    model_name_or_path: str = ""
    hf_config: dict | None = None
    attention: str = "auto"
    dtype: str = "float32"
    ref_dtype: str = "bfloat16"       # the frozen reference copy's precision
    seed: int = 0
    # a quantized base under LoRA
    quant: str = "none"               # none | int8 | int4 | nf4 | gptq | awq
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
    # "lora": factored adapters over a frozen base that is also the KL
    # reference
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
    """Raise for an option the port cannot run yet, naming its item: none
    of the GRPO job's is left, on one card or on a mesh (tp > 1 with a
    tensor-parallel rollout, LoRA, DoRA, PiSSA, quantized bases)."""


def shard_adapters(bundle, lora, mesh):
    """An adapter tree (whole on every rank) placed by
    ``lora_logical_axes`` on ``mesh``; as it is without one."""
    if mesh is None:
        return lora
    from iadr1_tpu_torch.core.mesh import shard_pytree
    from iadr1_tpu_torch.train.adapters import lora_logical_axes

    return shard_pytree(lora, lora_logical_axes(lora, bundle.logical_axes()),
                        mesh)


def prepare_base(params, job: GRPOJobConfig):
    """The base as training reads it: quantized per ``model.quant`` (a
    gptq / awq checkpoint already is), with the JAX CLI's refusals: a
    quantized base only under LoRA, never with PiSSA, and gptq / awq only
    for a checkpoint that holds packed weights."""
    from iadr1_tpu_torch.models.quant import (
        QUANT_FORMATS,
        is_quantized,
        quantize_tree,
    )
    from iadr1_tpu_torch.train.adapters import _map_with_path

    quant = job.model.quant
    if quant == "none":
        return params
    if job.finetuning.finetuning_type != "lora":
        raise ValueError(
            "model.quant requires finetuning.finetuning_type=lora "
            "(integer base weights cannot take optimizer updates)")
    if job.finetuning.pissa_init:
        raise ValueError(
            "model.quant is incompatible with finetuning.pissa_init: PiSSA "
            "needs a full-precision SVD of the base kernels, but the "
            "quantized base holds packed quant dicts; disable one of the two")
    if quant in ("gptq", "awq"):
        found = []
        _map_with_path(lambda p, x: found.append(is_quantized(x)), params)
        if not any(found):
            raise ValueError(
                f"model.quant={quant!r} but the checkpoint has no packed "
                "qweight tensors; point model_name_or_path at a GPTQ/AWQ "
                "export or use int4/nf4/int8 to quantize a bf16 checkpoint")
        return params
    if quant not in QUANT_FORMATS:
        raise ValueError(f"unknown model.quant {quant!r}")
    return quantize_tree(params, fmt=quant, block_size=job.model.quant_block)


def tuning_config(job: GRPOJobConfig):
    """The ``finetuning`` section as a TuningConfig (LoRA runs), or None."""
    from iadr1_tpu_torch.train.adapters import TuningConfig

    ft = job.finetuning
    if ft.finetuning_type == "full":
        return None
    if ft.finetuning_type != "lora":
        raise ValueError(f"unknown finetuning_type {ft.finetuning_type!r}")
    return TuningConfig(
        finetuning_type="lora", lora_rank=ft.lora_rank,
        lora_alpha=ft.lora_alpha, use_dora=ft.use_dora,
        use_rslora=ft.use_rslora, pissa_init=ft.pissa_init)


def make_vlm_prompt_collator(bundle, tokenizer, template, cfg: GRPODataSection,
                             max_prompt_length: int, num_generations: int = 1):
    """(examples, G) -> rollout batch (numpy) with the vision arrays and
    the M-RoPE grids.

    Each example carries pre-encoded ``prompt_ids`` plus preprocessed
    ``patches`` and ``grid_thw`` (a Qwen family's videos among them, with
    an optional ``second_per_grid_ts`` per video for Qwen2.5-VL) and, for
    the LLaVA video families, ``video_patches`` (frame stacks); prompts
    repeat G times consecutively.  ``cfg.patch_budget`` sizes the G =
    num_generations (update) collation, which holds every prompt's images
    G times over; the G = 1 rollout collation scales it down by the group
    factor, so the prefix-cached prefill's tower does not run over a patch
    stream padded G times too long.  The first collation at each G prints
    its budget."""
    pad = tokenizer.pad_token_id or tokenizer.eos_token_id
    img_id = getattr(bundle.cfg, "image_token_id", None)
    tcfg = getattr(bundle.cfg, "text", bundle.cfg)
    printed = set()

    def collate(examples, G):
        P = max_prompt_length
        budget = max(cfg.patch_budget * G // max(num_generations, 1), 8)
        rows = [ex for ex in examples for _ in range(G)]
        B = len(rows)
        if G not in printed:
            # the dense update's batch repeats each prompt's images G times
            printed.add(G)
            n_images = sum(len(ex.get("patches", ())) for ex in rows)
            print(f"vision budget: {budget} patches for {B} rows "
                  f"({n_images} images, G={G})")
        input_ids = np.full((B, P), pad, np.int64)
        mask = np.zeros((B, P), np.int64)
        patches_list, grids, videos, spg = [], [], [], []
        for i, ex in enumerate(rows):
            if ex.get("video_patches") and bundle.preprocess_video is None:
                raise ValueError(NO_FRAME_STACKS.format(bundle.family))
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
            videos.extend(ex.get("video_patches", []))
            spg.extend(ex.get("second_per_grid_ts", []))
        batch = {"input_ids": input_ids, "attention_mask": mask}
        if tcfg.mrope_section is not None:
            batch["position_ids"], batch["mrope_deltas"] = (
                bundle_mrope_positions(bundle.cfg, input_ids, grids,
                                       attention_mask=mask,
                                       second_per_grid_ts=spg or None))
        batch.update(bundle.vision_arrays(
            input_ids, patches_list, grids, budget,
            **({"videos": videos} if videos else {})))
        return batch

    return collate


def encode_rl_examples(rows, cfg: GRPODataSection, bundle, tokenizer,
                       template) -> list[dict]:
    """RL rows -> conversations -> {"prompt_ids", "solution"} (+ the
    images' ``patches`` and ``grid_thw`` for a VLM; PaliGemma's image runs
    prepended to the prompt's ids)."""
    from iadr1_tpu_torch.data.mm import (
        expand_image_tokens,
        prepend_image_tokens,
    )
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
        if bundle.multimodal and conv["images"] and (
                template.mm_style == "paligemma"):
            ex["prompt_ids"], _ = prepend_image_tokens(
                ex["prompt_ids"], None, seqlens, bundle.cfg.image_token_id)
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
    from iadr1_tpu_torch.core.distributed import maybe_initialize_distributed
    from iadr1_tpu_torch.core.mesh import build_mesh, mesh_config
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.registry import (
        bundle_from_hf_config,
        bundle_from_pretrained,
    )
    from iadr1_tpu_torch.rewards import get_reward_funcs
    from iadr1_tpu_torch.train.adapters import init_lora_params, pissa_init
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer
    from iadr1_tpu_torch.train.loop import JsonlLogger, LoopConfig
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import (
        create_train_state,
        named_leaves,
        unflatten,
    )

    # a multi-process launch: wire the ranks together before any device use
    maybe_initialize_distributed(args.device)
    cfg = load_config(GRPOJobConfig, args.config, args.overrides)
    require_ported(cfg)
    device = resolve_device(args.device)
    mesh = build_mesh(mesh_config(cfg.mesh))
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
    else:
        bundle = bundle_from_pretrained(cfg.model.model_name_or_path,
                                        attention=cfg.model.attention)
    if cfg.model.hf_config:
        params = bundle.init_params(seed=cfg.model.seed, dtype=dtype,
                                    device=device)
    else:
        # a quantized base replicates: each rank loads it whole
        params = load_checkpoint(
            bundle, cfg.model.model_name_or_path, dtype, device,
            mesh if cfg.model.quant == "none" else None)
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
    params = prepare_base(params, cfg)
    tuning_cfg = tuning_config(cfg)
    if cfg.model.quant == "none":
        # as the JAX CLI places it: sharded by the family's logical axes; a
        # quantized base replicates (every rank holds it whole, as plain
        # tensors: its point is that the replica is small)
        params = shard_for_mesh(bundle, params, mesh)
    common = dict(sampling_overrides=sampling_overrides, schedule=schedule,
                  template=template, prompt_collator=collator, device=device,
                  seed=loop_cfg.seed)
    reward_funcs = get_reward_funcs(cfg.grpo.reward_funcs)
    if tuning_cfg is not None:
        # LoRA with reference elision: the state holds the adapters alone
        # and the frozen base is the KL reference (one copy of it)
        if tuning_cfg.pissa_init:
            lora, params = pissa_init(params, tuning_cfg)
        else:
            gen = torch.Generator(device=device).manual_seed(
                cfg.model.seed + 1)
            lora = init_lora_params(gen, params, tuning_cfg)
        lora = shard_adapters(bundle, lora, mesh)
        trainer = GRPOTrainer(
            bundle, tokenizer, optimizer, grpo_cfg, reward_funcs,
            create_train_state(lora, optimizer), None, base_params=params,
            tuning_cfg=tuning_cfg, **common)
        del lora
    else:
        # the frozen reference: a copy in ref_dtype, never the policy's own
        # tensors (the policy is updated in place)
        ref_dtype = getattr(torch, cfg.model.ref_dtype)
        ref_params = unflatten({name: p.detach().to(ref_dtype, copy=True)
                                for name, p in named_leaves(params)})
        trainer = GRPOTrainer(
            bundle, tokenizer, optimizer, grpo_cfg, reward_funcs,
            create_train_state(params, optimizer), ref_params, **common)
        del ref_params
    del params

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
