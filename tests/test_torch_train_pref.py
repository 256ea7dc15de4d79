"""The port's preference launcher (cli/train_pref.py) on the tiny Qwen2-VL
checkpoint of tests/helpers.py, on the CPU.

``dpo``, ``rm`` and ``bco`` are held to the JAX launcher on the same
config (rows under the cutoff, so that ROADMAP C.R22 does not arise; f32
compute and an f32 reference on both sides): every logged metric of both
steps within rtol 1e-4 (the logs round to 6 decimals).  ``kto``'s target
rows equal JAX's, and its KL rows are the mismatched pairs its docstring
describes where JAX's are whole other rows (C.R23, pinned on both
sides).  Every other stage runs to a finite log and a checkpoint; gkd's
dataset branch (``gkd_lmbda`` 0) logs what the JAX launcher logs, with a
teacher written from another seed; a mesh asks for a multi-process
launch (every stage runs on one: tests/test_torch_pref_mesh_*.py).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

from helpers import build_tiny_vlm_checkpoint
from iadr1_tpu.cli.train_pref import main as jax_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu.train import preference as jax_preference
from iadr1_tpu_torch.cli import train_pref
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.train import preference as port_preference
from iadr1_tpu_torch.train.checkpoint import CheckpointManager
import torch_threads  # noqa: F401  (one intra-op thread)

# the JAX launcher takes the JAX tests' 8-device CPU mesh; the port one device
JAX_MESH = {"dp": 1, "fsdp": 4, "tp": 2}


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def teacher_dir(checkpoint_dir, tmp_path_factory):
    """GKD's teacher: the tiny checkpoint's config (so its vocabulary)
    with weights drawn from another seed, written by save_pretrained."""
    from transformers import (
        AutoTokenizer,
        Qwen2VLConfig,
        Qwen2VLForConditionalGeneration,
    )

    path = str(tmp_path_factory.mktemp("teacher"))
    torch.manual_seed(1)
    Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_pretrained(
        checkpoint_dir)).save_pretrained(path)
    AutoTokenizer.from_pretrained(checkpoint_dir).save_pretrained(path)
    return path


@pytest.fixture
def f32_compute(monkeypatch):
    """Both launchers' bundles compute in f32 (tests/test_torch_checkpoint.py)."""
    monkeypatch.setattr(jax_registry, "bundle_from_hf_config",
                        functools.partial(jax_registry.bundle_from_hf_config,
                                          precision=JAX_FULL))
    monkeypatch.setattr(jax_registry, "bundle_from_pretrained",
                        functools.partial(jax_registry.bundle_from_pretrained,
                                          precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_pretrained", functools.partial(
        registry.bundle_from_pretrained, precision=FULL_PRECISION))


def _write(tmp_path, name, rows):
    path = tmp_path / name
    path.write_text(json.dumps(rows))
    return str(path)


def ranking_rows():
    return [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "chosen": "<think>clear surface</think><answer>No</answer>",
             "rejected": {"role": "assistant", "content": "maybe?" * (i + 1)}}
            for i in range(6)]


def feedback_rows():
    return [{"messages": [{"role": "user", "content": f"Check sample {i}."},
                          {"role": "assistant", "content":
                           "<answer>No</answer>" if i % 2 else "bad " * i}],
             "label": bool(i % 2)} for i in range(6)]


def prompt_rows():
    return [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "solution": "<answer>No</answer>"} for i in range(6)]


def prm_rows():
    return [{"prompt": f"Solve {i} + 1.",
             "completions": [f"Step one for {i}.", "Step two.", "Done."],
             "labels": [True, i % 2 == 0, True]} for i in range(6)]


def _config(stage, ckpt, data, out_dir, steps=2, **over):
    cfg = {"stage": stage,
           "model": {"model_name_or_path": ckpt},
           "data": {"dataset_name": data, "template": "qwen2_vl",
                    "cutoff_len": 96},
           "pref": {"beta": 0.1, "ref_dtype": "float32"},
           "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0},
           "train": {"output_dir": str(out_dir), "max_steps": steps,
                     "batch_size": 2, "logging_steps": 1, "save_steps": 0}}
    for section, values in over.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def run_port(cfg, path):
    path.write_text(json.dumps(cfg))
    assert train_pref.main(["--config", str(path), "--device", "cpu"]) == 0
    return _log(cfg["train"]["output_dir"])


def run_jax(cfg, path):
    cfg = dict(cfg, mesh=JAX_MESH,
               model=dict(cfg["model"], attention="xla"))
    path.write_text(json.dumps(cfg))
    assert jax_main(["--config", str(path)]) == 0
    return _log(cfg["train"]["output_dir"])


def _log(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _compare_logs(port, want_log, stage, extra=("grad_norm",)):
    assert len(port) == len(want_log) == 2
    for got, want in zip(port, want_log):
        # the port's steps log grad_norm besides
        assert set(got) == set(want) | set(extra)
        for key in want:
            if key in ("elapsed_time", "remaining_time"):
                continue
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=2e-6, err_msg=f"{stage} {key}")
    assert port[1]["loss"] != port[0]["loss"]


@pytest.mark.parametrize("stage", ["dpo", "rm", "bco"])
def test_logged_metrics_match_the_jax_cli(stage, checkpoint_dir, f32_compute,
                                          monkeypatch, tmp_path):
    """rm: the port's value head is JAX's, drawn from the JAX launcher's
    key and carried over by ``params_from_jax``."""
    monkeypatch.setattr(
        port_preference, "init_value_head",
        lambda generator, hidden, dtype=None: params_from_jax(
            jax_preference.init_value_head(jax.random.PRNGKey(1), hidden),
            device="cpu"))
    rows = feedback_rows() if stage == "bco" else ranking_rows()
    data = _write(tmp_path, "data.json", rows)
    logs = {side: run(_config(stage, checkpoint_dir, data, tmp_path / side),
                      tmp_path / f"{side}.json")
            for side, run in (("port", run_port), ("jax", run_jax))}
    _compare_logs(logs["port"], logs["jax"], stage)


def test_gkd_dataset_branch_logs_what_the_jax_cli_logs(
        checkpoint_dir, teacher_dir, f32_compute, tmp_path):
    """gkd at lmbda 0 (every step takes the dataset completion) with the
    teacher of another seed: both launchers' logs of both steps."""
    data = _write(tmp_path, "data.json", feedback_rows())
    over = {"pref": {"gkd_lmbda": 0.0, "max_completion_length": 16,
                     "teacher_model_name_or_path": teacher_dir}}
    logs = {side: run(_config("gkd", checkpoint_dir, data, tmp_path / side,
                              **over), tmp_path / f"{side}.json")
            for side, run in (("port", run_port), ("jax", run_jax))}
    _compare_logs(logs["port"], logs["jax"], "gkd")
    assert logs["port"][0]["on_policy"] == 0.0


def _capture_batch(monkeypatch, module, side, seen):
    """Wrap ``module.make_kto_step`` so that its step keeps its first
    batch in ``seen[side]``."""
    make = module.make_kto_step

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def run(state, ref, batch):
            seen.setdefault(side, {k: np.asarray(v) for k, v in
                                   batch.items()})
            return step(state, ref, batch)
        return run

    monkeypatch.setattr(module, "make_kto_step", wrapped)


def _row(batch, prefix, i):
    ids = batch[f"{prefix}input_ids"][i]
    labels = batch[f"{prefix}labels"][i]
    n = int(batch[f"{prefix}segment_ids"][i].sum())
    return list(ids[:n]), list(labels[:n])


def test_kto_rows_and_the_kl_pairs(checkpoint_dir, monkeypatch, tmp_path):
    """ROADMAP C.R23 on both sides, over one step of batch 3.  The target
    rows and tags are the same.  JAX's KL row i is the whole target row
    i - 1 (a matched prompt and completion); the port's is the prompt of
    row i with the completion of row i - 1, only the completion
    labeled."""
    data = _write(tmp_path, "feedback.json", feedback_rows())
    seen = {}
    _capture_batch(monkeypatch, jax_preference, "jax", seen)
    _capture_batch(monkeypatch, port_preference, "port", seen)
    for side, run in (("port", run_port), ("jax", run_jax)):
        run(_config("kto", checkpoint_dir, data, tmp_path / side, steps=1,
                    train={"batch_size": 3}), tmp_path / f"{side}.json")
    port, jax_batch = seen["port"], seen["jax"]
    for key in ("input_ids", "labels", "segment_ids", "position_ids",
                "tags"):
        np.testing.assert_array_equal(port[key], jax_batch[key], err_msg=key)
    for i in range(3):
        target_prev = _row(port, "", i - 1)
        assert _row(jax_batch, "kl_", i) == target_prev    # JAX: matched
        ids, labels = _row(port, "kl_", i)
        first = labels.index(next(x for x in labels if x != IGNORE_INDEX))
        prompt_i = _row(port, "", i)[0]
        prev_first = next(j for j, x in enumerate(target_prev[1])
                          if x != IGNORE_INDEX)
        assert ids[:first] == prompt_i[:len(ids[:first])]
        assert ids[first:] == target_prev[0][prev_first:]
        assert labels[first:] == ids[first:]
        assert ids != _row(jax_batch, "kl_", i)[0]


@pytest.mark.parametrize("stage,rows,over", [
    ("dpo", ranking_rows, {"pref": {"loss_type": "simpo"}}),
    ("dpo", ranking_rows, {"pref": {"loss_type": "cpo", "ftx": 1.0}}),
    ("kto", feedback_rows, {}),
    ("prm", prm_rows, {}),
    ("ppo", prompt_rows, {"ppo": {"max_prompt_length": 32,
                                  "max_completion_length": 8,
                                  "mini_batch_size": 1, "ppo_epochs": 2}}),
    ("rloo", prompt_rows, {"pref": {"num_generations": 2,
                                    "max_completion_length": 8}}),
    ("online_dpo", prompt_rows, {"pref": {"max_completion_length": 8,
                                          "missing_eos_penalty": 0.1}}),
], ids=["simpo", "cpo", "kto", "prm", "ppo", "rloo", "online_dpo"])
def test_stage_runs_to_a_finite_log_and_a_checkpoint(
        stage, rows, over, checkpoint_dir, tmp_path):
    data = _write(tmp_path, "data.json", rows())
    cfg = _config(stage, checkpoint_dir, data, tmp_path / "run", **over)
    log = run_port(cfg, tmp_path / "cfg.json")
    assert [r["current_steps"] for r in log] == [1, 2]
    for record in log:
        assert all(np.isfinite(v) for v in record.values()), record
        assert "grad_norm" in record
    saved = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    assert saved.latest_step() == 2
    params = saved.restore_params(2)
    head = {"ppo": "vhead", "prm": "prm_head"}.get(stage)
    if head is not None:
        assert sorted(params) == sorted(["model", head])
        assert sorted(params[head]) == ["bias", "kernel"]


def test_rm_checkpoint_holds_the_value_head(checkpoint_dir, tmp_path):
    data = _write(tmp_path, "data.json", ranking_rows())
    run_port(_config("rm", checkpoint_dir, data, tmp_path / "run", steps=1),
             tmp_path / "cfg.json")
    params = CheckpointManager(
        str(tmp_path / "run" / "checkpoints")).restore_params(1)
    assert params["value_head"]["kernel"].shape == (64, 1)
    assert params["value_head"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("stage", ["xpo", "nash_md", "gkd"])
def test_the_a14b_stages_run(stage, checkpoint_dir, teacher_dir,
                               tmp_path):
    """The stages of ROADMAP A.14b run: xpo and nash_md on prompt rows,
    gkd on conversations with a teacher (lmbda 1/2 under seed 0: a
    dataset step, then an on-policy one), each to a finite log and a
    checkpoint of the model's tree."""
    rows = feedback_rows if stage == "gkd" else prompt_rows
    data = _write(tmp_path, "data.json", rows())
    pref = {"max_completion_length": 8}
    if stage == "gkd":
        pref.update(teacher_model_name_or_path=teacher_dir, gkd_lmbda=0.5)
    cfg = _config(stage, checkpoint_dir, data, tmp_path / "run", pref=pref,
                  train={"seed": 0})
    log = run_port(cfg, tmp_path / "cfg.json")
    assert [r["current_steps"] for r in log] == [1, 2]
    for record in log:
        assert all(np.isfinite(v) for v in record.values()), record
    if stage == "gkd":
        assert [r["on_policy"] for r in log] == [0.0, 1.0]
    saved = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    assert saved.latest_step() == 2
    assert sorted(saved.restore_params(2)) == ["text", "vision"]


def test_gkd_without_a_teacher_raises(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"stage": "gkd"}))
    with pytest.raises(ValueError, match="teacher_model_name_or_path"):
        train_pref.main(["--config", str(path), "--device", "cpu"])


def test_a_mesh_and_an_unknown_stage_raise(tmp_path):
    """Every stage runs on a mesh (DPO in tests/test_torch_distributed.py,
    the others in tests/test_torch_pref_mesh_*.py), launched one process a
    device: in one process DPO and KTO alike ask for the torchrun line."""
    path = tmp_path / "cfg.json"
    for stage in ("dpo", "kto"):
        path.write_text(json.dumps({"stage": stage, "mesh": {"fsdp": 2}}))
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            train_pref.main(["--config", str(path), "--device", "cpu"])
    path.write_text(json.dumps({"stage": "sft"}))
    with pytest.raises(ValueError, match="unknown stage"):
        train_pref.main(["--config", str(path), "--device", "cpu"])


def test_the_launcher_needs_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"stage": "dpo", "model": {
        "model_name_or_path": str(tmp_path / "absent")}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pref.main(["--config", str(path)])
    with pytest.raises((OSError, KeyError)):
        train_pref.main(["--config", str(path), "--device", "cpu"])
