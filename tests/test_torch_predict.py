"""``do_predict`` through the SFT CLIs: the port's generated_predictions.jsonl
and predict_results.json against the JAX CLI's on the tiny Qwen2-VL
checkpoint in f32 (learning rate 0, so that the greedy tokens are the
base weights'), the loss plot beside them, and ``--no-predict-scores``
(the generation half alone)."""

import functools
import json
import os

import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from helpers import build_iad_sft_dataset, build_tiny_vlm_checkpoint
from iadr1_tpu.cli.train_sft import main as jax_sft_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu_torch.cli.train_sft import main as sft_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture
def f32_compute(monkeypatch):
    """Both CLIs' bundles compute in f32: greedy tokens are then the same
    in the two frameworks."""
    monkeypatch.setattr(jax_registry, "bundle_from_hf_config",
                        functools.partial(jax_registry.bundle_from_hf_config,
                                          precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_hf_config", functools.partial(
        registry.bundle_from_hf_config, precision=FULL_PRECISION))


def _predict_cfg(checkpoint, data_path, img_dir, out_dir):
    return {
        "model": {"model_name_or_path": checkpoint},
        "data": {"dataset": data_path, "image_dir": img_dir,
                 "template": "qwen2_vl", "cutoff_len": 128,
                 "patch_budget": 64, "min_pixels": 56 * 56,
                 "max_pixels": 56 * 56 * 4},
        # learning rate 0: the predictions are the base weights'
        "optim": {"learning_rate": 0.0, "warmup_ratio": 0.0},
        "train": {"output_dir": out_dir, "max_steps": 1, "batch_size": 2,
                  "logging_steps": 1, "plot_loss": True},
        "predict": {"do_predict": True, "max_samples": 3,
                    "max_new_tokens": 8, "batch_size": 2},
    }


def test_do_predict_writes_the_jax_files(checkpoint, f32_compute, tmp_path):
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    out = {}
    for side, main, extra in (("port", sft_main, ["--device", "cpu"]),
                              ("jax", jax_sft_main, [])):
        out[side] = str(tmp_path / side)
        cfg = _predict_cfg(checkpoint, data_path, img_dir, out[side])
        cfg["model"]["attention"] = "auto" if side == "port" else "xla"
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps(cfg))
        assert main(["--config", str(path)] + extra) == 0
    for name in ("generated_predictions.jsonl", "predict_results.json"):
        files = [open(os.path.join(out[s], name), "rb").read()
                 for s in ("port", "jax")]
        assert files[0] == files[1], name
    rows = [json.loads(line) for line in open(
        os.path.join(out["port"], "generated_predictions.jsonl"))]
    assert len(rows) == 3 and all(set(r) == {"prompt", "label", "predict"}
                                  for r in rows)
    assert rows[0]["label"].startswith("<think>")
    results = json.load(open(os.path.join(out["port"],
                                          "predict_results.json")))
    assert sorted(results) == ["predict_bleu-4", "predict_rouge-1",
                               "predict_rouge-2", "predict_rouge-l"]
    assert os.path.exists(os.path.join(out["port"], "training_loss.png"))

    # the generation half alone: predictions, no scores
    out2 = str(tmp_path / "no_scores")
    cfg = _predict_cfg(checkpoint, data_path, img_dir, out2)
    path = tmp_path / "no_scores.json"
    path.write_text(json.dumps(cfg))
    assert sft_main(["--config", str(path), "--device", "cpu",
                     "--no-predict-scores"]) == 0
    assert open(os.path.join(out2, "generated_predictions.jsonl"), "rb").read(
        ) == open(os.path.join(out["port"], "generated_predictions.jsonl"),
                  "rb").read()
    assert not os.path.exists(os.path.join(out2, "predict_results.json"))
