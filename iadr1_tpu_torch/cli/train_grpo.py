"""SC-GRPO launcher pieces (counterpart of iadr1_tpu/cli/train_grpo.py):
the job's config sections and the VLM prompt collator.

The ``main`` entry point (config file, tokenizer, dataset, checkpoints) is not
ported yet (ROADMAP A.4); ``GRPOTrainer`` is driven from Python.  The sections
load every GRPO file of ``configs/``; ``require_ported`` names the item each
option the port cannot run yet waits for.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iadr1_tpu_torch.cli.train_sft import mesh_devices
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
