"""Config loading in the port against the JAX package: every file of
configs/ and the SFT and GRPO sections of the end-to-end pipeline's config
load into the port's job configs, LoopConfig and OptimizerConfig equal,
field by field, to the JAX package's; the options the port cannot run yet
raise at use, naming their ROADMAP item; the SFT log keeps the JAX keys."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from iadr1_tpu.cli import train_grpo as jax_grpo
from iadr1_tpu.cli import train_sft as jax_sft
from iadr1_tpu.core import config as jax_config
from iadr1_tpu.core.metrics import ThroughputMeter as JaxMeter
from iadr1_tpu.train import loop as jax_loop
from iadr1_tpu.train import optimizers as jax_opt
from iadr1_tpu_torch.cli import train_grpo, train_sft
from iadr1_tpu_torch.core import config
from iadr1_tpu_torch.core.metrics import ThroughputMeter
from iadr1_tpu_torch.train import loop, optimizers
import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))

# the "sft" and "grpo" sections of tests/test_e2e_pipeline.py's chain config
PIPELINE_SECTIONS = {
    "sft": {
        "model": {"attention": "xla"},
        "data": {"dataset": "expert_ad.json", "image_dir": "images",
                 "template": "qwen2_vl", "cutoff_len": 128,
                 "patch_budget": 64, "min_pixels": 56 * 56,
                 "max_pixels": 56 * 56 * 4, "ce_chunk": 64},
        "mesh": {"dp": 1, "fsdp": 4, "tp": 2},
        "optim": {"learning_rate": 2e-3, "warmup_ratio": 0.0},
        "train": {"max_steps": 120, "batch_size": 4,
                  "logging_steps": 1, "save_steps": 0},
    },
    "grpo": {
        "model": {"attention": "xla", "ref_dtype": "float32"},
        "data": {"dataset_name": "rl_data.json", "image_path": "rl_images",
                 "template": "qwen2_vl", "patch_budget": 128,
                 "min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4},
        "grpo": {"num_generations": 4, "max_prompt_length": 128,
                 "max_completion_length": 48, "beta": 0.02,
                 "temperature": 1.0},
        "mesh": {"dp": 1, "fsdp": 4, "tp": 2},
        "optim": {"learning_rate": 2e-3, "warmup_ratio": 0.0,
                  "max_grad_norm": 1.0},
        "train": {"max_steps": 8, "batch_size": 2,
                  "logging_steps": 1, "save_steps": 0},
    },
}

JOBS = {"sft": (train_sft.SFTJobConfig, jax_sft.SFTJobConfig),
        "grpo": (train_grpo.GRPOJobConfig, jax_grpo.GRPOJobConfig)}


def _kind(path):
    return "grpo" if os.path.basename(path).startswith("grpo") else "sft"


def _field_names(cls):
    """Every field of a config class and of its nested sections."""
    names = set()
    for f in dataclasses.fields(cls):
        names.add(f.name)
        if dataclasses.is_dataclass(f.default_factory):      # a section
            names |= {f"{f.name}.{n}" for n in _field_names(f.default_factory)}
    return names


def _assert_same_job(job, jax_job):
    assert dataclasses.asdict(job) == dataclasses.asdict(jax_job)
    # the loop and optimizer configs the CLIs build from the dicts
    lc = config.dataclass_from_dict(loop.LoopConfig, job.train)
    jlc = jax_config.dataclass_from_dict(jax_loop.LoopConfig, jax_job.train)
    assert dataclasses.asdict(lc) == dataclasses.asdict(jlc)
    oc = config.dataclass_from_dict(optimizers.OptimizerConfig, job.optim)
    joc = jax_config.dataclass_from_dict(jax_opt.OptimizerConfig,
                                         jax_job.optim)
    for name, value in dataclasses.asdict(oc).items():
        assert value == getattr(joc, name), name


@pytest.mark.parametrize("kind", ["sft", "grpo"])
def test_job_config_sections_match_the_jax_package(kind):
    ours, theirs = JOBS[kind]
    assert _field_names(ours) == _field_names(theirs)
    assert ({f.name for f in dataclasses.fields(loop.LoopConfig)}
            == {f.name for f in dataclasses.fields(jax_loop.LoopConfig)})
    assert ({f.name for f in dataclasses.fields(optimizers.OptimizerConfig)}
            <= {f.name for f in dataclasses.fields(jax_opt.OptimizerConfig)})


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_repo_config_loads_equal_to_jax(path):
    ours, theirs = JOBS[_kind(path)]
    _assert_same_job(config.load_config(ours, path),
                     jax_config.load_config(theirs, path))


@pytest.mark.parametrize("kind", ["sft", "grpo"])
def test_pipeline_sections_load_equal_to_jax(kind, tmp_path):
    ours, theirs = JOBS[kind]
    section = PIPELINE_SECTIONS[kind]
    _assert_same_job(config.dataclass_from_dict(ours, section),
                     jax_config.dataclass_from_dict(theirs, section))
    # a json file with dotted overrides, as the CLIs take them
    path = tmp_path / "job.json"
    path.write_text(json.dumps(section))
    overrides = ["train.max_steps=3", "optim.learning_rate=1e-4",
                 "model.seed=7", "data.template=qwen2_vl"]
    _assert_same_job(config.load_config(ours, path, overrides),
                     jax_config.load_config(theirs, path, overrides))


def test_unknown_keys_and_bad_overrides_raise_as_in_jax():
    for mod in (config, jax_config):
        with pytest.raises(KeyError, match="max_stepz"):
            mod.dataclass_from_dict(loop.LoopConfig, {"max_stepz": 1})
        with pytest.raises(ValueError, match="key=value"):
            mod.apply_overrides({}, ["train.max_steps"])
    data = config.apply_overrides({}, ["a.b=1", "a.c=true", "d=text"])
    assert data == jax_config.apply_overrides({}, ["a.b=1", "a.c=true",
                                                   "d=text"])


def test_options_the_port_cannot_run_yet_raise_at_use():
    by_name = {os.path.basename(p): p for p in CONFIGS}
    job = config.load_config(train_grpo.GRPOJobConfig,
                             by_name["grpo_llava_next_34b.yaml"])
    with pytest.raises(NotImplementedError, match="A.11"):
        train_grpo.require_ported(job)                  # fsdp 16 x tp 4
    job.mesh = {"dp": 1, "fsdp": -1, "tp": 1}
    train_grpo.require_ported(job)          # LoRA: ported (A.12)
    tuning = train_grpo.tuning_config(job)
    assert (tuning.lora_rank, tuning.lora_alpha) == (16, 32.0)
    job.finetuning.finetuning_type = "full"
    train_grpo.require_ported(job)
    assert train_grpo.tuning_config(job) is None
    job.model.quant = "nf4"
    train_grpo.require_ported(job)
    # a quantized base trains only under LoRA, as in the JAX CLI
    with pytest.raises(ValueError, match="requires finetuning"):
        train_grpo.prepare_base({}, job)
    train_grpo.require_ported(config.load_config(
        train_grpo.GRPOJobConfig, by_name["grpo_qwen2_5_vl_7b.yaml"]))

    sft = config.load_config(train_sft.SFTJobConfig,
                             by_name["sft_qwen2_5_vl_72b.yaml"])
    with pytest.raises(NotImplementedError, match="A.11"):
        train_sft.require_ported(sft)
    sft = config.load_config(train_sft.SFTJobConfig,
                             by_name["sft_qwen2_5_vl_7b.yaml"])
    train_sft.require_ported(sft)                       # fsdp -1: one card
    # context extension runs now (tests/test_torch_context_ext.py)
    for field, value in (("rope_scaling", "linear"), ("shift_attn", True)):
        train_sft.require_ported(dataclasses.replace(
            sft, model=dataclasses.replace(sft.model, **{field: value})))
    bad = dataclasses.replace(sft, predict=train_sft.PredictSection(
        do_predict=True))
    with pytest.raises(NotImplementedError, match="A.15"):
        train_sft.require_ported(bad)


def _fake_step(state, batch):
    return state + 1, {"loss": np.float32(2.0 / (state + 1)),
                       "grad_norm": np.float32(0.5)}


def _batches():
    while True:
        yield {"input_ids": np.zeros((2, 8), np.int64)}


def test_trainer_log_keys_match_jax(tmp_path):
    kw = dict(max_steps=3, batch_size=2, logging_steps=1, prefetch=0)
    loop.run_sft_loop(
        0, _fake_step, _batches(),
        loop.LoopConfig(output_dir=str(tmp_path / "port"), **kw),
        meter=ThroughputMeter(flops_per_token_fwd=1e6, peak_flops=1e12))
    jax_loop.run_sft_loop(
        0, _fake_step, _batches(),
        jax_loop.LoopConfig(output_dir=str(tmp_path / "jax"), **kw),
        meter=JaxMeter(flops_per_token_fwd=1e6))

    def keys(side):
        lines = (tmp_path / side / "trainer_log.jsonl").read_text()
        return [sorted(json.loads(line)) for line in lines.splitlines()]

    assert keys("port") == keys("jax")
    assert "tokens_per_sec_per_chip" in keys("port")[0]


@pytest.mark.parametrize("field", ["save_steps", "resume"])
def test_checkpointing_asked_for_in_the_loop_config_raises(field, tmp_path):
    """... when no checkpoint manager is given, instead of saving nothing
    (the CLIs always give one)."""
    cfg = loop.LoopConfig(output_dir=str(tmp_path), max_steps=2, prefetch=0,
                          **{field: {"save_steps": 1, "resume": True}[field]})
    with pytest.raises(ValueError, match="no checkpoint manager"):
        loop.run_sft_loop(0, _fake_step, _batches(), cfg)
