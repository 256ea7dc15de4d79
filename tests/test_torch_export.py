"""The port's HF export against the JAX package and HF ``transformers``: an
export of the port's parameters loads into ``iadr1_tpu`` and into HF's
Qwen2-VL with every tensor bit for bit, a JAX export loads into the port
likewise, and the logits of the loaded models agree within the parity
tolerance of tests/test_torch_qwen2_vl.py (atol 1e-4, f32).  Also: the
text family with an untied head, a bf16 model exported as bf16, and the
export CLI over a port checkpoint."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models.params_export import export_params as jax_export
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu_torch.cli.export import main as export_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_export import export_params, save_pretrained
from iadr1_tpu_torch.models.params_io import load_safetensors_path, params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train.checkpoint import CheckpointManager
from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
from iadr1_tpu_torch.train.state import create_train_state
from iadr1_tpu_torch.vision.mrope import get_mrope_positions
from iadr1_tpu_torch.vision.preprocess import patchify_image
import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-4
TEXT = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-6)
VLM = dict(
    architectures=["Qwen2VLForConditionalGeneration"], model_type="qwen2_vl",
    text_config=dict(TEXT, tie_word_embeddings=True,
                     rope_scaling={"type": "mrope",
                                   "mrope_section": [4, 2, 2]}),
    vision_config=dict(depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, video_token_id=8,
    vision_start_token_id=5, vision_end_token_id=6,
)
QWEN2 = dict(TEXT, architectures=["Qwen2ForCausalLM"], model_type="qwen2",
             tie_word_embeddings=False)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_same_params(got, want):
    """Every leaf bit for bit (numpy arrays or tensors)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for name in g:
        a, b = (x.detach().float().numpy() if torch.is_tensor(x)
                else np.asarray(x) for x in (g[name], w[name]))
        np.testing.assert_array_equal(a, b, err_msg=name)


def _noised(params, seed=0):
    """HF-scale init makes every logit nearly equal; noise makes the
    logits comparison a real check."""
    gen = torch.Generator().manual_seed(seed)
    return {k: _noised(v, seed + 1 + i) if isinstance(v, dict) else
            v + 0.2 * torch.randn(v.shape, generator=gen, dtype=v.dtype)
            for i, (k, v) in enumerate(params.items())}


def _write(dirpath, hf, params=None, state=None, bundle=None):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(hf, f)
    if state is not None:
        from safetensors.numpy import save_file

        save_file(state, os.path.join(dirpath, "model.safetensors"))
    else:
        save_pretrained(bundle, params, dirpath)
    return dirpath


def _vlm_batch(seed=0):
    """Two left-padded prompts with one image each."""
    rng = np.random.default_rng(seed)
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate([(56, 84), (84, 56)]):
        flat, grid = patchify_image(rng.random((h, w, 3), dtype=np.float32))
        patches.append(flat)
        grids.append(grid)
        n = int(np.prod(grid)) // 4
        text = rng.integers(10, 120, 4 + 3 * i).tolist()
        prompts.append(text[:2] + [5] + [7] * n + [6] + text[2:])
    T = max(map(len, prompts)) + 2
    ids = np.zeros((2, T), np.int64)
    mask = np.zeros((2, T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    pos, _ = get_mrope_positions(ids, np.asarray(grids), 7, 5,
                                 attention_mask=mask)
    return ids, mask, pos, patches, grids


def _logits_both(jb, jparams, tb, tparams):
    """Logits of the JAX and the port bundle on the same image batch, at
    the rows that hold tokens."""
    ids, mask, pos, patches, grids = _vlm_batch()
    budget = sum(p.shape[0] for p in patches) + 8
    batch = {"input_ids": ids, "position_ids": pos, "segment_ids": mask,
             **tb.vision_arrays(ids, patches, grids, budget)}
    jh, _ = jb.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jparams, jh))
    with torch.no_grad():
        th, _ = tb.apply(tparams, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
        got = tb.logits_fn(tparams, th).numpy()
    rows = mask.astype(bool)
    return got[rows], want[rows]


@pytest.fixture(scope="module")
def port_vlm(tmp_path_factory):
    tb = bundle_from_hf_config(VLM, precision=FULL_PRECISION)
    params = _noised(tb.init_params(seed=0, device="cpu"))
    path = _write(str(tmp_path_factory.mktemp("port_export")), VLM, params,
                  bundle=tb)
    return tb, params, path


def test_port_export_loads_into_jax(port_vlm):
    tb, params, path = port_vlm
    jb = jax_bundle(VLM, attention="xla", precision=JAX_FULL)
    jparams = jb.convert_hf(jax_load(path))
    _assert_same_params(jparams, params)
    got, want = _logits_both(jb, jparams, tb, params)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.std(want) > 0.1


def test_port_export_has_the_jax_names_and_dtypes(port_vlm):
    tb, params, path = port_vlm
    jb = jax_bundle(VLM, attention="xla")
    want = jax_export(jb, jb.convert_hf(jax_load(path)))
    got = load_safetensors_path(path)
    assert got.keys() == want.keys()
    assert any(k.startswith("model.language_model.") for k in got)
    assert any(k.startswith("model.visual.") for k in got)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.shape == want[name].shape, name
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def test_port_export_loads_into_hf_transformers(port_vlm):
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    tb, params, path = port_vlm
    hf_cfg = Qwen2VLConfig(
        vision_config=VLM["vision_config"], text_config=VLM["text_config"],
        image_token_id=7, video_token_id=8, vision_start_token_id=5,
        vision_end_token_id=6)
    torch.manual_seed(0)
    model = Qwen2VLForConditionalGeneration(hf_cfg).eval()
    missing, unexpected = model.load_state_dict(
        load_safetensors_path(path), strict=False)
    assert not unexpected, unexpected
    # rotary inv_freq buffers are the only missing entries; the tied head
    # is the embedding
    assert all("inv_freq" in k or "rotary" in k or k == "lm_head.weight"
               for k in missing), missing
    # a text batch: HF's M-RoPE positions are then the text positions
    ids = torch.as_tensor(np.random.default_rng(1).integers(10, 120, (2, 9)))
    with torch.no_grad():
        want = model(input_ids=ids).logits.numpy()
        pos = torch.arange(9).expand(3, 2, 9)
        th, _ = tb.apply(params, {"input_ids": ids, "position_ids": pos})
        got = tb.logits_fn(params, th).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_jax_export_loads_into_the_port(tmp_path):
    jb = jax_bundle(VLM, attention="xla", precision=JAX_FULL)
    jparams = jax.tree.map(
        lambda x: x + 0.2 * jax.random.normal(jax.random.PRNGKey(1),
                                              x.shape, x.dtype),
        jb.init_params(jax.random.PRNGKey(0)))
    path = _write(str(tmp_path), VLM, state=jax_export(jb, jparams))
    tb = bundle_from_hf_config(VLM, precision=FULL_PRECISION)
    tparams = tb.convert_hf(load_safetensors_path(path), device="cpu")
    _assert_same_params(tparams, params_from_jax(jparams, device="cpu"))
    got, want = _logits_both(jb, jparams, tb, tparams)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_text_family_with_an_untied_head_round_trips(tmp_path):
    tb = bundle_from_hf_config(QWEN2)
    params = tb.init_params(seed=3, device="cpu")
    state = export_params(tb, params)
    assert "lm_head.weight" in state
    path = _write(str(tmp_path), QWEN2, params, bundle=tb)
    _assert_same_params(tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"), params)
    jb = jax_bundle(QWEN2, attention="xla")
    _assert_same_params(jb.convert_hf(jax_load(path)), params)


def test_a_bf16_model_exports_as_bf16(tmp_path):
    """The card's base checkpoint: bf16 weights stay bf16 on disk and load
    back bit for bit through the port (numpy cannot hold bf16)."""
    tb = bundle_from_hf_config(VLM)
    params = tb.init_params(seed=0, dtype=torch.bfloat16, device="cpu")
    path = _write(str(tmp_path), VLM, params, bundle=tb)
    state = load_safetensors_path(path)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    back = tb.convert_hf(state, dtype=torch.bfloat16, device="cpu")
    for (name, a), (_, b) in zip(_leaves(back), _leaves(params),
                                 strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name


def test_export_cli_writes_a_checkpoint_as_an_hf_directory(port_vlm,
                                                           tmp_path):
    tb, params, base = port_vlm
    tiny_qwen_tokenizer().save_pretrained(base)
    opt, _ = make_optimizer(OptimizerConfig(total_steps=4))
    trained = _noised(params, seed=9)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(3, create_train_state(trained, opt))
    out = str(tmp_path / "export")
    assert export_main(["--model-path", base, "--checkpoint-dir",
                        mgr.directory, "--output-dir", out,
                        "--device", "cpu"]) == 0
    assert {"config.json", "tokenizer.json", "tokenizer_config.json",
            "model.safetensors"} <= set(os.listdir(out))
    _assert_same_params(tb.convert_hf(load_safetensors_path(out),
                                      device="cpu"), trained)
