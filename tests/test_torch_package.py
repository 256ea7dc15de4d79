"""Package rules of the PyTorch port: it imports neither JAX, nor the JAX
package, nor optax, nor pandas, and none of the optional host packages
(jieba, nltk, matplotlib, wandb, requests) at import; its entry points refuse to fall back to the CPU
silently, and its kernel wrappers take the twin only for CPU tensors."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

IMPORT_ALL_BLOCKED = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "iadr1_tpu", "optax", "pandas", "jieba",
               "nltk", "matplotlib", "wandb", "requests")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import iadr1_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        iadr1_tpu_torch.__path__, "iadr1_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = [m for m in sys.modules if blocked(m)]
    assert not loaded, loaded
    print(" ".join(names))
""")

# the SC-GRPO slice's modules: each must be among those imported
GRPO_MODULES = [
    "cli.train_grpo", "models.shared_prompt", "train.grpo", "train.prompts",
    "rewards.structure", "rewards.consistency", "rewards.location",
    "rewards.type_taxonomy", "rewards.description", "rewards.accuracy",
    "rewards.ablations",
]
# the eval and serving front ends and the config loading
FRONT_END_MODULES = [
    "core.config", "cli.train_sft", "cli.infer", "cli.summarize",
    "cli.serve", "eval.mcq", "eval.summary", "eval.harness", "serve.api",
    "serve.batcher",
]
# the training CLIs, checkpoints, export and the pipeline
CHAIN_MODULES = [
    "data.registry", "data.aligner", "data.tokenize", "data.cache",
    "data.template", "train.checkpoint", "train.loop",
    "models.params_export", "cli.export", "cli.pipeline",
]
# LLaVA-OneVision and Qwen2.5-VL
FAMILY_MODULES = ["vision.anyres", "models.siglip", "models.llava_onevision",
                  "models.qwen25_vl", "models.clip_vit", "models.llava"]
# adapters and quantization
ADAPTER_MODULES = ["models.quant", "train.adapters", "models.params_io",
                   "models.qwen2", "train.optimizers", "train.rollout"]
# InternVL and the video inputs
INTERNVL_VIDEO_MODULES = ["models.internvl", "models.registry", "data.mm",
                          "data.collator", "vision.preprocess",
                          "vision.mrope", "models.qwen2_vl"]
# PaliGemma and Pixtral
PALIGEMMA_PIXTRAL_MODULES = ["models.paligemma", "models.pixtral",
                             "cli.train_sft", "cli.train_grpo",
                             "eval.generator"]
# the preference stages
PREF_MODULES = ["train.preference", "train.ppo", "train.online_rl",
                "cli.train_pref", "data.tokenize", "train"]
# GKD and the optimizers beyond AdamW
A14B_MODULES = ["train.gkd", "train.custom_optim"]
# the SFT leftovers, the native packing plane and the data side
A14C_A13_MODULES = ["train.sft", "data.native", "data.packing",
                    "data.tools", "data.template", "data.mm_plugins"]
# the mesh and the distributed bootstrap
A11_MODULES = ["core.mesh", "core.distributed", "core.device",
               "train.state", "kernels.flash_attention",
               "kernels.decode_attention"]
# the last modules: chat, the web board, MMLU and the commercial client,
# profiling, the reporters and the similarity metrics
A15_MODULES = ["cli.chat", "core.profiling", "eval.commercial", "eval.mmlu",
               "train.metrics_text", "train.reporters", "webui",
               "webui.app", "webui.runner"]


def test_every_module_imports_without_jax_or_the_jax_package():
    """... nor optax, nor pandas (the card's machine has neither), nor
    jieba, nltk, matplotlib, wandb or requests (imported where used)."""
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL_BLOCKED],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 40                        # every module was reached
    missing = [m for m in (GRPO_MODULES + FRONT_END_MODULES + CHAIN_MODULES
                           + FAMILY_MODULES + ADAPTER_MODULES
                           + INTERNVL_VIDEO_MODULES
                           + PALIGEMMA_PIXTRAL_MODULES + PREF_MODULES
                           + A14B_MODULES + A14C_A13_MODULES
                           + A11_MODULES + A15_MODULES)
               if f"iadr1_tpu_torch.{m}" not in names]
    assert not missing, missing


def _tiny_hf():
    return dict(
        architectures=["Qwen2VLForConditionalGeneration"],
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2,
                         num_key_value_heads=1,
                         rope_scaling={"type": "mrope",
                                       "mrope_section": [2, 3, 3]}),
        vision_config=dict(depth=1, embed_dim=16, hidden_size=32,
                           num_heads=2),
    )


def test_entry_points_without_a_card_or_a_device_raise(monkeypatch, tmp_path):
    from iadr1_tpu_torch.cli import infer, serve
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.models.params_io import params_from_jax
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = bundle_from_hf_config(_tiny_hf())
    params = bundle.init_params(seed=0, device="cpu")    # asked for: works
    tok = type("Tok", (), {"eos_token_id": 1, "pad_token_id": 0})()
    calls = [
        lambda: bundle.init_params(seed=0),
        lambda: bundle.convert_hf({}),
        lambda: params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: RolloutEngine(bundle, SamplingConfig(), max_len=8),
        lambda: VLMGenerator(bundle, params, tok, get_template("qwen2_vl"),
                             GeneratorConfig()),
        lambda: GRPOTrainer(bundle, tok, None, GRPOConfig(), [], None, params),
        lambda: infer.main(["--model-path", str(tmp_path), "--test-data",
                            "t.json", "--output-dir", str(tmp_path)]),
        lambda: serve.main(["--model-path", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_llava_onevision_entry_points_without_a_card_raise(monkeypatch):
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = bundle_from_hf_config(dict(
        architectures=["LlavaOnevisionForConditionalGeneration"],
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2,
                         num_key_value_heads=1),
        vision_config=dict(hidden_size=16, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           image_size=28, patch_size=14)))
    bundle.init_params(seed=0, device="cpu")             # asked for: works
    for call in (lambda: bundle.init_params(seed=0),
                 lambda: bundle.convert_hf({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_export_and_pipeline_clis_need_a_card_or_cpu(monkeypatch,
                                                              tmp_path):
    """Each raises the no-card error before it reads a checkpoint, a
    tokenizer or a dataset; with --device cpu it gets past that check
    (and fails on the empty paths instead)."""
    import json

    from iadr1_tpu_torch.cli import export, pipeline, train_grpo, train_sft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "job.json"
    cfg.write_text(json.dumps({"model": {"model_name_or_path": str(
        tmp_path / "absent")}}))
    pipe = tmp_path / "pipeline.json"
    pipe.write_text(json.dumps({"output_dir": str(tmp_path / "run")}))
    export_args = ["--model-path", str(tmp_path / "absent"),
                   "--checkpoint-dir", str(tmp_path), "--output-dir",
                   str(tmp_path / "out")]
    for main, args in ((train_sft.main, ["--config", str(cfg)]),
                       (train_grpo.main, ["--config", str(cfg)]),
                       (export.main, export_args),
                       (pipeline.main, ["--config", str(pipe)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
        if main is not pipeline.main:
            with pytest.raises((OSError, KeyError)):
                main(args + ["--device", "cpu"])


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    handed to the twin."""
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention

    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q[:, :, 0], q, q,
                         torch.ones((1, 8), dtype=torch.int32, device="meta"),
                         4)


def test_other_families_name_their_roadmap_item():
    """Every model family of the JAX package builds now (Qwen2-MoE was the
    last), and so does every chat template: ``get_template`` refuses only
    a name the JAX package does not know either, listing the known ones."""
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.registry import (
        NOT_YET_PORTED,
        bundle_from_hf_config,
    )

    bundle = bundle_from_hf_config({
        "model_type": "qwen2_moe", "vocab_size": 64, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 1,
        "num_attention_heads": 2})
    assert bundle.family == "qwen2_moe" and not NOT_YET_PORTED
    assert get_template("qwen").name == "qwen"
    with pytest.raises(KeyError, match="known:"):
        get_template("no_such_template")


def test_a_library_is_rebuilt_when_its_source_or_a_shared_header_is_newer(
        tmp_path, monkeypatch):
    import os

    from iadr1_tpu_torch.kernels import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, header, lib = csrc / "k.cu", csrc / "common.cuh", build / "k.so"
    src.write_text("")
    header.write_text("")
    assert _build._stale("k.cu")                  # never built
    lib.write_text("")

    def age(path, t):
        os.utime(path, (t, t))

    age(src, 100)
    age(header, 100)
    age(lib, 200)
    assert not _build._stale("k.cu")
    age(header, 300)                              # a shared header changed
    assert _build._stale("k.cu")
    age(header, 100)
    age(src, 300)                                 # the source changed
    assert _build._stale("k.cu")


def test_every_jax_module_has_a_counterpart():
    """The module lists of the two packages differ only by the port's own
    files (the device resolution, the CUDA sources' build helper, the
    native plane's loader, the rollout's explicit tensor-parallel
    collectives, which XLA's partitioner makes for JAX) and JAX's
    ``native/``, which the port builds from ``csrc/dataplane.cpp`` into
    ``data/native.py``."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent

    def modules(pkg):
        base = root / pkg
        return {str(p.relative_to(base)) for p in base.rglob("*.py")}

    jax_only = modules("iadr1_tpu") - modules("iadr1_tpu_torch")
    port_only = modules("iadr1_tpu_torch") - modules("iadr1_tpu")
    assert jax_only == {"native/__init__.py"}, jax_only
    assert port_only == {"core/device.py", "core/tensor_parallel.py",
                         "data/native.py", "kernels/_build.py"}, port_only
