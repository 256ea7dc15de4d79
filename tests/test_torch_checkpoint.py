"""The port's checkpoints and its training CLIs: CheckpointManager's save
and restore bit for bit (parameters, both AdamW moments, the step and the
optimizer's count), ``max_to_keep``, the metadata sidecar, ``latest_step``;
the SFT and GRPO CLIs resumed from a checkpoint end bitwise equal to an
uninterrupted run with their steps numbered 1..n (the cases of
tests/test_resume.py, on one device); and the SFT CLI's trainer log
against the JAX CLI's over 3 steps on the tiny Qwen2-VL checkpoint."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from helpers import build_iad_rl_dataset, build_iad_sft_dataset, build_tiny_vlm_checkpoint
from iadr1_tpu.cli.train_sft import main as jax_sft_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu_torch.cli.train_grpo import main as grpo_main
from iadr1_tpu_torch.cli.train_sft import main as sft_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.train.checkpoint import CheckpointManager
from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def _state(seed, mu_dtype=None):
    gen = torch.Generator().manual_seed(seed)
    params = {"text": {"w": torch.randn(3, 5, generator=gen),
                       "b": torch.randn(5, generator=gen)},
              "half": torch.randn(4, generator=gen).to(torch.bfloat16)}
    opt, _ = make_optimizer(OptimizerConfig(total_steps=10, mu_dtype=mu_dtype))
    state = create_train_state(params, opt)
    for t in state.opt_state["mu"] + state.opt_state["nu"]:
        t.copy_(torch.randn(t.shape, generator=gen).abs())
    state.opt_state["count"] = seed
    return state._replace(step=seed)


def _all(state):
    return (tree_leaves(state.params) + state.opt_state["mu"]
            + state.opt_state["nu"])


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_save_and_restore_are_bitwise(mu_dtype, tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    saved = _state(7, mu_dtype)
    assert mgr.save(7, saved, metadata={"loss": 1.5})
    blank = _state(0, mu_dtype)
    got = mgr.restore(blank)
    assert got.step == 7 and got.opt_state["count"] == 7
    for a, b in zip(_all(got), _all(saved), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # in place: the restored tensors are the template's, still trainable
    assert got.params["text"]["w"] is blank.params["text"]["w"]
    assert got.params["text"]["w"].requires_grad
    with open(tmp_path / "meta_7.json") as f:
        assert json.load(f) == {"loss": 1.5}
    # the parameters alone, as an export reads them
    params = mgr.restore_params()
    assert torch.equal(params["text"]["w"], saved.params["text"]["w"])
    assert params["half"].dtype == torch.bfloat16
    # opt_state None: parameters and step only
    only = mgr.restore(_state(0, mu_dtype)._replace(opt_state=None))
    assert only.step == 7 and torch.equal(only.params["half"],
                                          saved.params["half"])


def test_max_to_keep_sidecars_and_latest_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                            save_interval_steps=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))
    assert not mgr.save(3, _state(3))           # off the save interval
    for step in (2, 4, 6):
        assert mgr.save(step, _state(step), metadata={"step": step})
    assert not mgr.save(6, _state(9))           # not later than the newest
    assert not mgr.save(4, _state(9))
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == [
        "4.safetensors", "6.safetensors", "meta_4.json", "meta_6.json"]
    assert mgr.restore(_state(0), step=4).step == 4
    with pytest.raises(FileNotFoundError, match="checkpoint 2"):
        mgr.restore(_state(0), step=2)
    # a fresh manager over the directory sees the same checkpoints
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    keep_all = CheckpointManager(str(tmp_path / "all"), max_to_keep=0)
    for step in (1, 2, 3):
        keep_all.save(step, _state(step))
    assert keep_all.all_steps() == [1, 2, 3]


def test_restore_refuses_a_mismatched_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    with pytest.raises(ValueError, match="params.half"):
        mgr.restore(_state(0, "bfloat16")._replace(params={
            "text": _state(0).params["text"],
            "half": torch.zeros(4)}))


# ---------------------------------------------------------------------------
# resume through the CLIs
# ---------------------------------------------------------------------------


def _run(main, cfg, path, device="cpu"):
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path)] + (["--device", device] if device else [])
    assert main(argv) == 0


def _final_state(out_dir):
    from safetensors.torch import load_file

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    return mgr.latest_step(), load_file(mgr.path(mgr.latest_step()))


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


def _steps_logged(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _sft_cfg(checkpoint_dir, data_path, img_dir, out_dir, max_steps,
             resume=False):
    return {
        "model": {"model_name_or_path": checkpoint_dir},
        "data": {"dataset": data_path, "image_dir": img_dir,
                 "template": "qwen2_vl", "cutoff_len": 128,
                 "patch_budget": 64, "min_pixels": 56 * 56,
                 "max_pixels": 56 * 56 * 4},
        # the schedule's horizon is pinned so the interrupted run follows
        # the uninterrupted one's learning rates
        "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                  "total_steps": 4},
        "train": {"output_dir": out_dir, "max_steps": max_steps,
                  "batch_size": 2, "logging_steps": 1, "save_steps": 0,
                  "resume": resume},
    }


def test_sft_resume_is_bitwise_equal_to_an_uninterrupted_run(checkpoint_dir,
                                                            tmp_path):
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _run(sft_main, _sft_cfg(checkpoint_dir, data_path, img_dir, full, 4),
         tmp_path / "full.json")
    _run(sft_main, _sft_cfg(checkpoint_dir, data_path, img_dir, part, 2),
         tmp_path / "part.json")
    _run(sft_main, _sft_cfg(checkpoint_dir, data_path, img_dir, part, 4,
                            resume=True), tmp_path / "resume.json")
    (step_a, a), (step_b, b) = _final_state(full), _final_state(part)
    assert step_a == step_b == 4 and int(b["step"]) == 4
    assert int(b["opt_count"]) == 4
    _assert_bitwise(a, b)
    assert [r["current_steps"] for r in _steps_logged(part)] == [1, 2, 3, 4]
    assert [r["loss"] for r in _steps_logged(part)] == [
        r["loss"] for r in _steps_logged(full)]


def _distinct_chars(completions, **kw):
    """A dense reward: random tiny-model text never scores under the
    recipe's rewards, and with no advantage the policy would not move."""
    return [len(set(c[0]["content"])) / 10.0 for c in completions]


def test_grpo_resume_is_bitwise_equal_to_an_uninterrupted_run(
        checkpoint_dir, tmp_path, monkeypatch):
    _check_grpo_resume(checkpoint_dir, tmp_path, monkeypatch, {})


def test_lora_grpo_resume_is_bitwise_equal_to_an_uninterrupted_run(
        checkpoint_dir, tmp_path, monkeypatch):
    """LoRA mode (DoRA, rank 4): the checkpoint holds the adapters and
    their moments alone, and a resumed run is the uninterrupted one."""
    b = _check_grpo_resume(checkpoint_dir, tmp_path, monkeypatch, {
        "finetuning": {"finetuning_type": "lora", "lora_rank": 4,
                       "use_dora": True}})
    names = [k for k in b if k not in ("step", "opt_count")]
    assert names and all(k.rsplit(".", 1)[-1] in "abm" for k in names)
    assert any(k.startswith("nu.text.layers.mlp.up.kernel.") for k in names)


def _check_grpo_resume(checkpoint_dir, tmp_path, monkeypatch, extra):
    """3 GRPO CLI steps, against 2 then a resumed third: the final
    checkpoints bitwise equal, the logged metrics equal; returns the
    final checkpoint's tensors."""
    from iadr1_tpu_torch.rewards import REWARD_REGISTRY

    monkeypatch.setitem(REWARD_REGISTRY, "distinct_chars", _distinct_chars)
    data_path, img_dir = build_iad_rl_dataset(tmp_path)

    def cfg(out_dir, max_steps, resume=False, save_steps=2):
        return {**extra, 
            "model": {"model_name_or_path": checkpoint_dir,
                      "ref_dtype": "float32"},
            "data": {"dataset_name": data_path, "image_path": img_dir,
                     "template": "qwen2_vl", "patch_budget": 64,
                     "min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4},
            "grpo": {"num_generations": 2, "max_prompt_length": 128,
                     "max_completion_length": 8, "temperature": 1.0,
                     "reward_funcs": ["distinct_chars"]},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                      "total_steps": 3},
            "train": {"output_dir": out_dir, "max_steps": max_steps,
                      "batch_size": 2, "logging_steps": 1,
                      "save_steps": save_steps, "resume": resume},
        }

    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _run(grpo_main, cfg(full, 3, save_steps=0), tmp_path / "full.json")
    _run(grpo_main, cfg(part, 2), tmp_path / "part.json")
    _run(grpo_main, cfg(part, 3, resume=True), tmp_path / "resume.json")
    (step_a, a), (step_b, b) = _final_state(full), _final_state(part)
    assert step_a == step_b == 3 and int(b["step"]) == 3
    _assert_bitwise(a, b)
    records = _steps_logged(part)
    assert [r["current_steps"] for r in records] == [1, 2, 3]
    assert np.isfinite([r["loss"] for r in records]).all()
    want = _steps_logged(full)
    for got, ref in zip(records, want, strict=True):
        for key in ("loss", "kl", "grad_norm", "reward",
                    "completion_length"):
            assert got[key] == ref[key], (got["current_steps"], key)
    assert all(r["grad_norm"] > 0 for r in want)     # the policy moved
    return b


# ---------------------------------------------------------------------------
# the SFT CLI against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def f32_compute(monkeypatch):
    """Both CLIs' bundles compute in f32: in bf16 the frameworks round
    differently and the logs would differ by bf16 noise."""
    monkeypatch.setattr(jax_registry, "bundle_from_hf_config",
                        functools.partial(jax_registry.bundle_from_hf_config,
                                          precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_hf_config", functools.partial(
        registry.bundle_from_hf_config, precision=FULL_PRECISION))


def test_sft_cli_log_matches_the_jax_cli(checkpoint_dir, f32_compute,
                                         tmp_path):
    """Steps 1-3 of the same config: the same keys, and loss, accuracy,
    grad norm and learning rate within rtol 1e-5 (f32 on both sides; the
    two differ in summation order only, as in tests/test_torch_sft.py).
    The JAX run takes the JAX tests' 8-device CPU mesh; the port runs on
    one device."""
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    cfg = _sft_cfg(checkpoint_dir, data_path, img_dir, None, 3)
    cfg["optim"]["learning_rate"] = 1e-3
    for side, main, extra in (
            ("port", sft_main, {}),
            ("jax", jax_sft_main, {"mesh": {"dp": 1, "fsdp": 4, "tp": 2}})):
        cfg["train"]["output_dir"] = str(tmp_path / side)
        cfg["model"]["attention"] = "auto" if side == "port" else "xla"
        _run(main, {**cfg, **extra}, tmp_path / f"{side}.json",
             "cpu" if side == "port" else None)
    port, jax = _steps_logged(tmp_path / "port"), _steps_logged(
        tmp_path / "jax")
    assert len(port) == len(jax) == 3
    for got, want in zip(port, jax):
        assert sorted(got) == sorted(want)
        assert got["current_steps"] == want["current_steps"]
        assert got["n_label_tokens"] == want["n_label_tokens"]
        for key in ("loss", "accuracy", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    assert port[-1]["loss"] < port[0]["loss"]
