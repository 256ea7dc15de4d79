"""The port's one-command recipe (cli/pipeline.py) on the CPU: PA-SFT on the
tiny Qwen2-VL checkpoint -> HF export -> SC-GRPO warm-started from that
export -> export -> the eval harness over two synthetic benchmarks -> the
combined summary CSV and the manifest, held to the assertions of
tests/test_e2e_pipeline.py that need no reference data.  A short run (4
SFT and 2 GRPO steps, a dense reward beside the recipe's so the policy
moves) checks the hand-offs and the artifacts; the JAX test's length (120
SFT and 8 GRPO steps; ~30 s alone, minutes beside other test workers) is
marked slow and checks what needs learning: the SFT loss falls and the
warm-started policy earns the recipe's rewards.  Also: an eval-only re-run
picks up the exports on disk, and the exports JAX refuses (a quantized
base without LoRA, PiSSA) are refused."""

import csv
import json
import os

import numpy as np
import pytest

from helpers import (
    build_benchmark_json,
    build_iad_rl_dataset,
    build_iad_sft_dataset,
    build_tiny_vlm_checkpoint,
)
from iadr1_tpu_torch.cli import pipeline
import torch_threads  # noqa: F401  (one intra-op thread)


def _distinct_chars(completions, **kw):
    """A dense reward: the tiny model's few steps of SFT teach it no
    scoreable answer, and with no advantage the policy would not move."""
    return [len(set(c[0]["content"])) / 10.0 for c in completions]


def _pipeline(tmp, sft_steps, grpo_steps, new_tokens, rewards,
              build=build_tiny_vlm_checkpoint, template="qwen2_vl"):
    tmp.mkdir(parents=True, exist_ok=True)
    checkpoint = build(str(tmp / "ckpt"))
    sft_json, sft_imgs = build_iad_sft_dataset(tmp / "sft_data")
    rl_json, rl_imgs = build_iad_rl_dataset(tmp / "rl_data")
    benches = []
    for name, seed_dir in (("DAGM", "a"), ("SDD", "b")):
        test_data, img_root = build_benchmark_json(tmp / seed_dir, n=4)
        # the dataset is the first component of each record's image key
        with open(test_data) as f:
            data = {k.replace("TinyDS/", f"{name}/", 1): dict(
                v, image_path=v["image_path"].replace("TinyDS/", f"{name}/"))
                for k, v in json.load(f).items()}
        os.rename(os.path.join(img_root, "TinyDS"),
                  os.path.join(img_root, name))
        path = os.path.join(tmp / seed_dir, f"test_{name}_format.json")
        with open(path, "w") as f:
            json.dump(data, f)
        benches.append({"test_data": path, "image_dir": img_root,
                        "max_samples": 4})
    out = str(tmp / "run")
    cfg = {
        "model_name_or_path": checkpoint,
        "output_dir": out,
        "sft": {
            "data": {"dataset": sft_json, "image_dir": sft_imgs,
                     "template": template, "cutoff_len": 128,
                     "patch_budget": 64, "min_pixels": 56 * 56,
                     "max_pixels": 56 * 56 * 4, "ce_chunk": 64},
            "optim": {"learning_rate": 2e-3, "warmup_ratio": 0.0},
            "train": {"max_steps": sft_steps, "batch_size": 4,
                      "logging_steps": 1, "save_steps": 0},
        },
        "grpo": {
            "model": {"ref_dtype": "float32"},
            "data": {"dataset_name": rl_json, "image_path": rl_imgs,
                     "template": template, "patch_budget": 128,
                     "min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4},
            "grpo": {"num_generations": 4, "max_prompt_length": 128,
                     "max_completion_length": new_tokens, "beta": 0.02,
                     "temperature": 1.0, "reward_funcs": rewards},
            "optim": {"learning_rate": 2e-3, "warmup_ratio": 0.0,
                      "max_grad_norm": 1.0},
            "train": {"max_steps": grpo_steps, "batch_size": 2,
                      "logging_steps": 1, "save_steps": 0},
        },
        "eval": {"benchmarks": benches, "num_shot": 0, "batch_size": 2,
                 "max_prompt_length": 128, "max_new_tokens": new_tokens,
                 "patch_budget": 64, "max_pixels": 56 * 56 * 4},
    }
    cfg_path = tmp / "pipeline.json"
    cfg_path.write_text(json.dumps(cfg))
    assert pipeline.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    return out, cfg_path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from iadr1_tpu_torch.rewards import REWARD_REGISTRY

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(REWARD_REGISTRY, "distinct_chars", _distinct_chars)
        return _pipeline(tmp_path_factory.mktemp("pipeline"), 4, 2, 16,
                         ["accuracy", "format", "distinct_chars"])


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_stages(out, sft_steps, grpo_steps):
    sft_log = _log(os.path.join(out, "sft", "trainer_log.jsonl"))
    assert len(sft_log) == sft_steps
    assert np.isfinite([r["loss"] for r in sft_log]).all()
    for name in ("model.safetensors", "tokenizer_config.json",
                 "config.json"):
        assert os.path.exists(os.path.join(out, "sft_export", name))
    with open(os.path.join(out, "grpo_config.json")) as f:
        grpo_cfg = json.load(f)
    assert grpo_cfg["model"]["model_name_or_path"] == os.path.join(
        out, "sft_export")
    grpo_log = _log(os.path.join(out, "grpo", "trainer_log.jsonl"))
    assert len(grpo_log) == grpo_steps
    assert np.isfinite([r["loss"] for r in grpo_log]).all()
    assert np.isfinite([r["reward"] for r in grpo_log]).all()
    # within-group reward variance: non-zero advantages, real gradients
    assert max(r["reward_std"] for r in grpo_log) > 0.0
    assert max(r["grad_norm"] for r in grpo_log) > 0.0
    assert os.path.exists(os.path.join(out, "grpo_export",
                                       "model.safetensors"))
    return sft_log, grpo_log


def test_sft_then_grpo_warm_started_from_the_sft_export(run):
    _check_stages(run[0], 4, 2)


@pytest.mark.slow
def test_the_recipe_at_the_jax_e2e_length_learns(tmp_path):
    out, _ = _pipeline(tmp_path, 120, 8, 48, ["accuracy", "format"])
    sft_log, grpo_log = _check_stages(out, 120, 8)
    first = np.mean([r["loss"] for r in sft_log[:5]])
    last = np.mean([r["loss"] for r in sft_log[-5:]])
    assert last < first, f"SFT did not learn: {first:.3f} -> {last:.3f}"
    # the warm-started policy already emits scoreable answers, which a
    # cold random policy never does
    rewards = [r["reward"] for r in grpo_log]
    assert np.mean(rewards) > 0.0, f"warm start produced no reward: {rewards}"
    _check_eval(out)


def test_the_chain_runs_on_qwen2_5_vl(tmp_path, monkeypatch):
    """The same chain on a tiny Qwen2.5-VL checkpoint (windowed tower,
    the qwen2_5_vl template): SFT -> export -> GRPO warm-started from it
    (the update batch carries the window segments) -> export -> eval ->
    the summary CSV."""
    from test_torch_qwen25_vl import build_tiny_qwen25_vl_checkpoint

    from iadr1_tpu_torch.rewards import REWARD_REGISTRY

    monkeypatch.setitem(REWARD_REGISTRY, "distinct_chars", _distinct_chars)
    out, _ = _pipeline(tmp_path, 2, 1, 8,
                       ["accuracy", "format", "distinct_chars"],
                       build=build_tiny_qwen25_vl_checkpoint,
                       template="qwen2_5_vl")
    _check_stages(out, 2, 1)
    _check_eval(out)
    with open(os.path.join(out, "grpo_export", "config.json")) as f:
        assert json.load(f)["model_type"] == "qwen2_5_vl"


def _check_eval(out):
    for ds in ("DAGM", "SDD"):
        answers_path = os.path.join(out, "results", ds,
                                    "answers_0_shot.json")
        with open(answers_path) as f:
            answers = json.load(f)
        assert len(answers) == 4
        for a in answers:
            assert a["image"].startswith(ds + "/")
            assert a["gpt_answer"] in "ABE"
            assert a["correct_answer"] in "AB"
        assert os.path.exists(answers_path.replace(".json", "_accuracy.csv"))
    with open(os.path.join(out, "results", "summary_0_shot.csv")) as f:
        table = list(csv.reader(f))
    assert [row[0] for row in table[1:]] == ["DAGM", "SDD", "Average"]
    assert table[0][-1] == "Average" and "Anomaly Detection" in table[0]
    values = np.asarray([[float(x) for x in row[1:]] for row in table[1:]])
    np.testing.assert_allclose(values[:, -1], values[:, :-1].mean(axis=1),
                               rtol=1e-9)
    with open(os.path.join(out, "pipeline_manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest["results"]) == {"DAGM", "SDD"}
    assert manifest["grpo_export"] == os.path.join(out, "grpo_export")


def test_eval_stage_and_the_summary_csv(run):
    _check_eval(run[0])


def test_an_eval_only_rerun_reads_the_grpo_export(run, monkeypatch):
    out, cfg_path = run
    seen = []
    real = pipeline.run_pipeline

    def spy(cfg, device=None):
        from iadr1_tpu_torch.cli import infer

        monkeypatch.setattr(infer, "main", lambda argv: seen.append(
            argv[argv.index("--model-path") + 1]) or 0)
        return real(cfg, device)

    monkeypatch.setattr(pipeline, "run_pipeline", spy)
    assert pipeline.main(["--config", str(cfg_path), "--device", "cpu",
                          "stages=[\"eval\"]"]) == 0
    assert seen == [os.path.join(out, "grpo_export")] * 2


@pytest.mark.parametrize("kw", [
    {"finetuning": {"finetuning_type": "lora", "pissa_init": True}},
    {"quant": "nf4"}])
def test_lora_and_quantized_exports_name_their_roadmap_item(kw, tmp_path):
    """Named for the refusal it checked until ROADMAP A.12 was ported.
    LoRA and QLoRA exports are ported (their parity with
    JAX's merge is tests/test_torch_adapters.py's).  What the JAX export
    refuses, the port refuses before it reads anything: a quantized base
    without LoRA, and a PiSSA run."""
    match = "pissa_init" if "finetuning" in kw else "requires a LoRA"
    with pytest.raises(ValueError, match=match):
        pipeline.export_run(str(tmp_path), str(tmp_path), str(tmp_path),
                            device="cpu", **kw)
