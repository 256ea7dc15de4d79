"""The IAD-R1 recipe in ONE command: PA-SFT -> SC-GRPO -> benchmark eval
(counterpart of iadr1_tpu/cli/pipeline.py, full-parameter).

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
against an existing ``grpo_export``.  LoRA and quantized runs wait for
ROADMAP A.12.
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
               quant: str = "none", device=None) -> str:
    """Run checkpoint -> HF-format dir the next stage can load: the
    parameters of ``step`` (default: the newest) read onto ``device``
    (default: the card) and written under the base checkpoint's config
    and tokenizer.  LoRA merging and quantized bases wait for ROADMAP
    A.12."""
    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.models.params_export import save_pretrained
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager

    if quant != "none" or (finetuning or {}).get(
            "finetuning_type", "full") != "full":
        raise NotImplementedError(
            "exporting LoRA or quantized runs is not ported yet "
            "(ROADMAP A.12)")
    device = resolve_device(device)
    bundle = bundle_from_pretrained(base_model_path)
    params = CheckpointManager(checkpoint_dir).restore_params(step, device)
    save_pretrained(bundle, params, out_dir, source_dir=base_model_path)
    return out_dir


def _stage(main, stage_cfg: dict, cfg_path: str, device, name: str) -> None:
    with open(cfg_path, "w") as f:
        json.dump(stage_cfg, f, indent=1)
    argv = ["--config", cfg_path]
    if device is not None:
        argv += ["--device", str(device)]
    rc = main(argv)
    if rc:
        raise RuntimeError(f"{name} stage failed (rc={rc})")


def run_pipeline(cfg: PipelineConfig, device=None) -> dict:
    """Execute the selected stages on ``device`` (default: the card);
    returns artifact paths."""
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
        export_run(stage_cfg["model"]["model_name_or_path"],
                   os.path.join(sft_dir, "checkpoints"), sft_export,
                   device=device)
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
        export_run(stage_cfg["model"]["model_name_or_path"],
                   os.path.join(grpo_dir, "checkpoints"), grpo_export,
                   finetuning=stage_cfg.get("finetuning"),
                   quant=stage_cfg["model"].get("quant", "none"),
                   device=device)
        artifacts["grpo"] = grpo_dir
        artifacts["grpo_export"] = grpo_export

    if "eval" in cfg.stages:
        from iadr1_tpu_torch.cli.infer import main as infer_main
        from iadr1_tpu_torch.eval.summary import summarize_answers

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
        per_bench = {}
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
            per_bench[name] = answers_path

        # one row per dataset + Average, question types as columns (record
        # ``image`` keys carry the dataset as their first component)
        summary = summarize_answers(all_answers)
        summary_csv = os.path.join(results_dir, f"summary_{shot}_shot.csv")
        summary.to_csv(summary_csv)
        artifacts["results"] = per_bench
        artifacts["summary_csv"] = summary_csv
        print(summary.to_string(2))

    manifest = os.path.join(out, "pipeline_manifest.json")
    with open(manifest, "w") as f:
        json.dump(artifacts, f, indent=1)
    artifacts["manifest"] = manifest
    return artifacts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    add_device_argument(parser)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from iadr1_tpu_torch.core.config import load_config
    from iadr1_tpu_torch.core.device import resolve_device

    cfg = load_config(PipelineConfig, args.config, args.overrides)
    resolve_device(args.device)
    run_pipeline(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
