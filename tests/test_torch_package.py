"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU silently, and its
kernel wrappers take the twin only for CPU tensors."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

IMPORT_ALL_BLOCKED = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "iadr1_tpu")

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
    print(len(names))
""")


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL_BLOCKED],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20      # every module was reached


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


def test_entry_points_without_a_card_or_a_device_raise(monkeypatch):
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.models.params_io import params_from_jax
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


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
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config

    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        bundle_from_hf_config({"model_type": "qwen2_5_vl"})


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
