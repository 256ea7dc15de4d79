"""The IAD-R1 recipe in ONE command: PA-SFT -> SC-GRPO -> benchmark eval
(counterpart of iadr1_tpu/cli/pipeline.py).

The checkpoint hand-off between stages and the template consistency
between train and eval are one config:

    python -m iadr1_tpu_torch.cli.pipeline --config configs/pipeline.yaml

Every stage runs on the card unless given ``--device cpu``.  Stage
artifacts (all under ``output_dir``):

    sft/            trainer_log.jsonl + checkpoints
    sft_export/     HF-format export (config/tokenizer copied from base)
    grpo/           trainer_log.jsonl + checkpoints
    grpo_export/    HF-format export
    results/<name>/answers_{k}_shot.json + *_accuracy.csv  per benchmark
    results/summary_{k}_shot.csv   all benchmarks, rows = datasets+Average

``stages`` selects a subset (default all three); a later stage picks up an
earlier stage's export from disk, so ``stages: [eval]`` re-runs eval alone
against an existing ``grpo_export``.

On more than one process (``torchrun --nproc_per_node N -m
iadr1_tpu_torch.cli.pipeline --config ...``) every rank runs the chain:
each training stage on the job's mesh (its section's ``mesh``; fsdp fills
the ranks by default), as its CLI runs under torchrun.  Rank 0 alone
writes what one process would write besides the stages' own files (each
stage's config, the exports, the eval's answers and CSVs, the summary and
the manifest), and the others wait for it at a barrier: the next stage
reads the export through the sharded load, and the eval runs on rank 0
off the mesh (the infer CLI is one process).  A LoRA GRPO stage exports its
adapters merged into the base (over the base quantized as training
quantized it, for a QLoRA run).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os

from iadr1_tpu_torch.cli.train_sft import add_device_argument


@dataclasses.dataclass
class BenchmarkSpec:
    test_data: str                     # test_*_format.json
    image_dir: str = ""
    name: str = ""                     # default: parsed from the filename
    normal_flag: str = "good"
    max_samples: int | None = None


@dataclasses.dataclass
class PipelineEvalSection:
    # list of benchmark dicts (BenchmarkSpec fields); the recipe evaluates
    # six sets (MVTec, VisA, MPDD, DAGM, DTD, SDD)
    benchmarks: list = dataclasses.field(default_factory=list)
    num_shot: int = 0
    batch_size: int = 4
    max_prompt_length: int = 1024
    max_new_tokens: int = 512
    patch_budget: int = 4096
    max_pixels: int = 480000
    template: str | None = None
    attention: str = "auto"
    mode: str = "iad"                  # iad | pretrain (base-ckpt variant)


@dataclasses.dataclass
class PipelineConfig:
    model_name_or_path: str = ""       # stage-0 base checkpoint
    output_dir: str = "output/pipeline"
    stages: list = dataclasses.field(
        default_factory=lambda: ["sft", "grpo", "eval"])
    sft: dict = dataclasses.field(default_factory=dict)    # SFTJobConfig
    grpo: dict = dataclasses.field(default_factory=dict)   # GRPOJobConfig
    eval: PipelineEvalSection = dataclasses.field(
        default_factory=PipelineEvalSection)


def _bench_name(spec: BenchmarkSpec) -> str:
    if spec.name:
        return spec.name
    base = os.path.basename(spec.test_data)
    # test_DAGM_format.json -> DAGM
    if base.startswith("test_") and base.endswith("_format.json"):
        return base[len("test_"):-len("_format.json")]
    return os.path.splitext(base)[0]


def export_run(base_model_path: str, checkpoint_dir: str, out_dir: str,
               finetuning: dict | None = None, step: int | None = None,
               quant: str = "none", quant_block: int = 64,
               device=None) -> str:
    """Run checkpoint -> HF-format dir the next stage can load: the
    parameters of ``step`` (default: the newest) read onto ``device``
    (default: the card) and written under the base checkpoint's config
    and tokenizer.

    ``finetuning`` (the GRPO CLI's section) with a LoRA type: the
    checkpoint holds the adapters alone; they are merged into the base
    read from ``base_model_path`` in f32, as the JAX export reads it, one
    layer at a time and in place, so the card holds the f32 base and one
    layer's transients, never a second copy of the adapted kernels.  ``quant`` must be the training run's
    ``model.quant``: the adapters trained against the quantized base, so
    the base is quantized the same way before the merge, and what the
    adapters did not touch is dequantized to bf16 (peft's
    merge_and_unload on a bnb base).  PiSSA runs are refused, as in JAX:
    the base checkpoint alone cannot rebuild their residual base."""
    import torch

    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.models.params_export import save_pretrained
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager

    lora = (finetuning or {}).get("finetuning_type", "full") == "lora"
    if quant != "none" and not lora:
        raise ValueError(
            "quantized export requires a LoRA finetuning section "
            "(a quantized base cannot have taken full updates)")
    if lora and finetuning.get("pissa_init"):
        raise ValueError(
            "pipeline export of pissa_init runs is unsupported: PiSSA "
            "rewrites the base weights at adapter init, so the base "
            "checkpoint alone cannot reconstruct the merged model")
    device = resolve_device(device)
    bundle = bundle_from_pretrained(base_model_path)
    ckpt = CheckpointManager(checkpoint_dir)
    if not lora:
        params = ckpt.restore_params(step, device)
        save_pretrained(bundle, params, out_dir, source_dir=base_model_path)
        return out_dir

    from iadr1_tpu_torch.cli.train_grpo import (
        GRPOJobConfig,
        prepare_base,
        tuning_config,
    )
    from iadr1_tpu_torch.core.config import dataclass_from_dict
    from iadr1_tpu_torch.models.quant import dequantize_tree
    from iadr1_tpu_torch.train.adapters import merge_lora

    job = dataclass_from_dict(GRPOJobConfig, {
        "model": {"quant": quant, "quant_block": quant_block},
        "finetuning": finetuning})
    params = bundle.convert_hf(load_safetensors_path(base_model_path),
                               dtype=torch.float32, device=device)
    params = prepare_base(params, job)
    lora_params = ckpt.restore_params(step, device)
    out = merge_lora(params, lora_params, tuning_config(job), inplace=True)
    del params, lora_params
    if quant != "none":
        # kernels no adapter touched may still be quant dicts; the HF
        # checkpoint needs dense kernels everywhere
        out = dequantize_tree(out, torch.bfloat16)
    save_pretrained(bundle, out, out_dir, source_dir=base_model_path)
    return out_dir


def _stage(main, stage_cfg: dict, cfg_path: str, device, name: str) -> None:
    from iadr1_tpu_torch.core.distributed import barrier, is_primary

    if is_primary():
        with open(cfg_path, "w") as f:
            json.dump(stage_cfg, f, indent=1)
    barrier()
    argv = ["--config", cfg_path]
    if device is not None:
        argv += ["--device", str(device)]
    rc = main(argv)
    if rc:
        raise RuntimeError(f"{name} stage failed (rc={rc})")


def run_pipeline(cfg: PipelineConfig, device=None) -> dict:
    """Execute the selected stages on ``device`` (default: the card);
    returns artifact paths."""
    from iadr1_tpu_torch.core.distributed import barrier, is_primary

    out = cfg.output_dir
    os.makedirs(out, exist_ok=True)
    sft_dir = os.path.join(out, "sft")
    sft_export = os.path.join(out, "sft_export")
    grpo_dir = os.path.join(out, "grpo")
    grpo_export = os.path.join(out, "grpo_export")
    results_dir = os.path.join(out, "results")
    artifacts = {"output_dir": out}

    if "sft" in cfg.stages:
        from iadr1_tpu_torch.cli.train_sft import main as sft_main

        stage_cfg = copy.deepcopy(cfg.sft)
        stage_cfg.setdefault("model", {}).setdefault(
            "model_name_or_path", cfg.model_name_or_path)
        stage_cfg.setdefault("train", {})["output_dir"] = sft_dir
        _stage(sft_main, stage_cfg, os.path.join(out, "sft_config.json"),
               device, "sft")
        if is_primary():
            export_run(stage_cfg["model"]["model_name_or_path"],
                       os.path.join(sft_dir, "checkpoints"), sft_export,
                       device=device)
        barrier()
        artifacts["sft"] = sft_dir
        artifacts["sft_export"] = sft_export

    if "grpo" in cfg.stages:
        from iadr1_tpu_torch.cli.train_grpo import main as grpo_main

        stage_cfg = copy.deepcopy(cfg.grpo)
        # warm start: the SC-GRPO base is the PA-SFT export
        stage_cfg.setdefault("model", {}).setdefault(
            "model_name_or_path",
            sft_export if os.path.isdir(sft_export)
            else cfg.model_name_or_path)
        stage_cfg.setdefault("train", {})["output_dir"] = grpo_dir
        _stage(grpo_main, stage_cfg, os.path.join(out, "grpo_config.json"),
               device, "grpo")
        if is_primary():
            export_run(stage_cfg["model"]["model_name_or_path"],
                       os.path.join(grpo_dir, "checkpoints"), grpo_export,
                       finetuning=stage_cfg.get("finetuning"),
                       quant=stage_cfg["model"].get("quant", "none"),
                       quant_block=stage_cfg["model"].get("quant_block", 64),
                       device=device)
        barrier()
        artifacts["grpo"] = grpo_dir
        artifacts["grpo_export"] = grpo_export

    if "eval" in cfg.stages:
        from iadr1_tpu_torch.core.mesh import kernel_mesh_scope

        if is_primary():
            # off the training stages' mesh: rank 0 alone generates
            with kernel_mesh_scope(None):
                _eval_stage(cfg, out, results_dir, device)
        artifacts.update(_eval_paths(cfg, results_dir))
    barrier()

    manifest = os.path.join(out, "pipeline_manifest.json")
    if is_primary():
        with open(manifest, "w") as f:
            json.dump(artifacts, f, indent=1)
    artifacts["manifest"] = manifest
    return artifacts


def _eval_paths(cfg: PipelineConfig, results_dir: str) -> dict:
    """The eval stage's artifacts: each benchmark's answers file and the
    summary CSV."""
    shot = cfg.eval.num_shot
    return {"results": {
        _bench_name(BenchmarkSpec(**spec)): os.path.join(
            results_dir, _bench_name(BenchmarkSpec(**spec)),
            f"answers_{shot}_shot.json")
        for spec in cfg.eval.benchmarks},
        "summary_csv": os.path.join(results_dir, f"summary_{shot}_shot.csv")}


def _eval_stage(cfg: PipelineConfig, out: str, results_dir: str,
                device) -> None:
    """Every benchmark through the infer CLI on the newest export, then
    the summary CSV (the files ``_eval_paths`` names)."""
    from iadr1_tpu_torch.cli.infer import main as infer_main
    from iadr1_tpu_torch.eval.summary import summarize_answers

    sft_export = os.path.join(out, "sft_export")
    grpo_export = os.path.join(out, "grpo_export")
    # only exports this invocation produced (or, for a pure
    # ``stages: [eval]`` re-run, any export on disk): a [sft, eval]
    # run must not pick up a stale grpo_export of an earlier run
    eval_only = list(cfg.stages) == ["eval"]
    candidates = []
    if "grpo" in cfg.stages or eval_only:
        candidates.append(grpo_export)
    if "sft" in cfg.stages or eval_only:
        candidates.append(sft_export)
    candidates.append(cfg.model_name_or_path)
    model_path = next(
        (d for d in candidates if d and os.path.isdir(d)), None)
    if model_path is None:
        raise RuntimeError("eval stage: no model export found and no "
                           "model_name_or_path configured")
    ev = cfg.eval
    shot = ev.num_shot
    all_answers: list[dict] = []
    for spec_dict in ev.benchmarks:
        spec = BenchmarkSpec(**spec_dict)
        name = _bench_name(spec)
        bench_out = os.path.join(results_dir, name)
        argv = [
            "--model-path", model_path,
            "--test-data", spec.test_data,
            "--image-dir", spec.image_dir,
            "--output-dir", bench_out,
            "--num-shot", str(shot),
            "--batch-size", str(ev.batch_size),
            "--max-prompt-length", str(ev.max_prompt_length),
            "--max-new-tokens", str(ev.max_new_tokens),
            "--patch-budget", str(ev.patch_budget),
            "--max-pixels", str(ev.max_pixels),
            "--attention", ev.attention,
            "--normal-flag", spec.normal_flag,
            "--mode", ev.mode,
        ]
        if ev.template:
            argv += ["--template", ev.template]
        if spec.max_samples:
            argv += ["--max-samples", str(spec.max_samples)]
        if device is not None:
            argv += ["--device", str(device)]
        rc = infer_main(argv)
        if rc:
            raise RuntimeError(f"eval stage failed on {name} (rc={rc})")
        answers_path = os.path.join(bench_out,
                                    f"answers_{shot}_shot.json")
        with open(answers_path) as f:
            all_answers.extend(json.load(f))

    # one row per dataset + Average, question types as columns (record
    # ``image`` keys carry the dataset as their first component)
    summary = summarize_answers(all_answers)
    summary_csv = os.path.join(results_dir, f"summary_{shot}_shot.csv")
    summary.to_csv(summary_csv)
    print(summary.to_string(2))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    add_device_argument(parser)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from iadr1_tpu_torch.core.config import load_config
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.core.distributed import maybe_initialize_distributed

    maybe_initialize_distributed(args.device)
    cfg = load_config(PipelineConfig, args.config, args.overrides)
    resolve_device(args.device)
    run_pipeline(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
