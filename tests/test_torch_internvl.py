"""The port's InternVL (InternViT tower, pixel shuffle, MLP projector, the
Qwen2 decoder; the intern_vl template) against the JAX package: the host
tiling, serving, PA-SFT and SC-GRPO, LoRA and an int8 base.

A tiny ``InternVLForConditionalGeneration`` is written by
``save_pretrained`` into a temporary directory with the tiny tokenizer of
tests/helpers.py plus ``<img>``, ``</img>`` and ``<IMG_CONTEXT>`` (the
image token), and loaded by both packages.  The tower is
tests/test_internvl_parity.py's: tiles of 56 px (4 x 4 patches + CLS = 17
tokens), 32 wide with 4 heads, 2 layers; the decoder has 2 layers, 4
heads over 2.  Both packages run FULL_PRECISION (f32 compute); the JAX
side runs ``attention="xla"`` (its tower is dense in any case), the port
its K1 twin, whose tower masks the zero tiles that pad the tile stream
(``tile_segments``): the towers are compared on the real tiles, whose
features alone reach the tokens.

Tolerances: the host arrays and token ids exactly equal, the tiles within
1e-6; live tile features atol 1e-5; logits atol 1e-4; greedy tokens
identical (the weights get seeded noise); SFT loss rtol 1e-5 and grad
norms rtol 1e-4; GRPO metrics rtol 1e-4 and parameters atol 1e-5
(tests/test_torch_llava.py's helpers); the LoRA hidden states and
adapter gradients atol 1e-5 and rtol 1e-4.

The JAX package's SC-GRPO update batch drops InternVL's ``tiles``
(ROADMAP C.R9: its update scores the completions without the image),
which one test pins; the port's update is held to JAX's update step fed
the port's batch.  The JAX tiles use OpenAI-CLIP's statistics whatever a
checkpoint says (C.R13), also pinned.
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.mm import expand_image_tokens as jax_expand
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models import internvl as jinternvl
from iadr1_tpu.models import quant as jq
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import adapters as jad
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.mm import expand_image_tokens
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import internvl
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_export import export_params
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.quant import quantize_tree
from iadr1_tpu_torch.models.registry import (
    NOT_YET_PORTED,
    bundle_from_hf_config,
    bundle_from_pretrained,
)
from iadr1_tpu_torch.train import adapters as tad
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves
from iadr1_tpu_torch.vision import anyres
from test_torch_llava import (
    Tok,
    _assert_params_close,
    _image,
    _leaves,
    check_shared_pred,
    check_update,
    record_grpo_case,
)

TILE = 56                          # a tiny "448": 4 x 4 patches of 14 px
FPT = 4                            # features a tile after the shuffle
VISION = dict(
    hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, image_size=[TILE, TILE], patch_size=[14, 14],
    layer_norm_eps=1e-6, attention_bias=True, use_qk_norm=False,
    norm_type="layer_norm", hidden_dropout_prob=0.0, attention_dropout=0.0,
    projection_dropout=0.0, use_absolute_position_embeddings=True,
    layer_scale_init_value=0.1, use_mean_pooling=True)
TEXT = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
            rms_norm_eps=1e-6, tie_word_embeddings=False, model_type="qwen2",
            attention_dropout=0.0)
# (h, w): one tile, a (2, 1) grid, a (3, 2) grid and a wide (4, 1) one:
# 1, 3, 7 and 5 tiles (more than one tile adds the thumbnail)
IMAGES = [(56, 56), (56, 112), (84, 140), (40, 170)]
BUDGET = 12 * 16                   # 12 tiles of 16 patches
IMAGE_TOKENS = ["<img>", "</img>", "<IMG_CONTEXT>"]


def internvl_tokenizer():
    """The tiny tokenizer with InternVL's image tokens; its BOS is
    ``<|endoftext|>`` so the template's BOS prefix shows."""
    tok = tiny_qwen_tokenizer()
    tok.add_tokens(IMAGE_TOKENS, special_tokens=True)
    tok.bos_token = "<|endoftext|>"
    return tok


def build_tiny_internvl_checkpoint(dirpath: str) -> str:
    """A tiny InternVL HF checkpoint: config, safetensors, tokenizer; the
    layer scales and projector norm drawn away from their init."""
    from transformers import InternVLConfig, InternVLForConditionalGeneration

    tok = internvl_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    model = InternVLForConditionalGeneration(InternVLConfig(
        vision_config=dict(VISION),
        text_config=dict(TEXT, vocab_size=max(len(tok), 600)),
        image_token_id=tok.convert_tokens_to_ids("<IMG_CONTEXT>"),
        downsample_ratio=0.5, vision_feature_layer=-1,
        vision_feature_select_strategy="default",
        projector_hidden_act="gelu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lambda" in name or "multi_modal_projector.layer_norm" in name:
                p.add_(0.3 * torch.randn_like(p))
    model.eval().save_pretrained(dirpath)
    return dirpath


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = build_tiny_internvl_checkpoint(
        str(tmp_path_factory.mktemp("internvl")))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


# ---------------------------------------------------------------------------
# registry, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_resolves_the_family(tiny, key):
    hf = dict(tiny["hf"])
    hf.pop("model_type" if key == "architectures" else "architectures")
    if key == "model_type":
        hf["model_type"] = "internvl"
    tb = bundle_from_hf_config(hf)
    assert tb.family == "internvl" and tb.template == "intern_vl"
    assert tb.cfg.vision.head_dim == 8 and tb.cfg.features_per_tile == FPT
    assert tb.shared_pred_fn is not None and tb.preprocess_video is None
    assert not {"internvl", "InternVLForConditionalGeneration"} & set(
        NOT_YET_PORTED)


# the key layout of transformers' own InternVL modules, and the one
# save_pretrained writes
NEW_TO_OLD = [("model.language_model.", "language_model.model."),
              ("lm_head.", "language_model.lm_head."),
              ("model.vision_tower.", "vision_tower."),
              ("model.multi_modal_projector.", "multi_modal_projector.")]


def _state(tiny, layout):
    """The checkpoint's tensors in ``layout``'s key names."""
    state = load_safetensors_path(tiny["path"])
    pairs = NEW_TO_OLD if layout == "language_model.model" else [
        (old, new) for new, old in NEW_TO_OLD]

    def rename(k):
        return next((b + k[len(a):] for a, b in pairs if k.startswith(a)), k)

    return {rename(k): v for k, v in state.items()}


@pytest.mark.parametrize("layout", ["model.language_model",
                                    "language_model.model"])
def test_convert_hf_equals_jax_convert_then_params_from_jax(tiny, layout):
    state = _state(tiny, layout)
    assert any(k.startswith(layout) for k in state)
    got = dict(_leaves(tiny["tb"].convert_hf(state, device="cpu")))
    want = dict(_leaves(params_from_jax(tiny["jb"].convert_hf(
        {k: v.numpy() for k, v in state.items()}), device="cpu")))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_init_params_has_the_jax_tree(tiny):
    got = dict(_leaves(tiny["tb"].init_params(seed=0, device="cpu")))
    want = dict(_leaves(tiny["jb"].init_params(jax.random.PRNGKey(0))))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name


def test_export_is_refused_as_in_jax(tiny):
    with pytest.raises(ValueError, match="internvl"):
        export_params(tiny["tb"], tiny["tparams"])


# ---------------------------------------------------------------------------
# host side: tiling, vision arrays, template
# ---------------------------------------------------------------------------


def test_optimal_tile_grid_equals_jax():
    """A sweep of sizes, ties among them (aspect 2:1 has (2, 1), (4, 2),
    (6, 3); 1:1 has (1, 1), (2, 2), (3, 3)), small and large images."""
    sizes = [(h, w) for h in (20, 56, 100, 112, 224, 448, 900)
             for w in (20, 56, 100, 112, 224, 448, 900, 1344)]
    for tile, lo, hi in ((56, 1, 12), (448, 1, 12), (448, 2, 6)):
        for h, w in sizes:
            assert internvl.optimal_tile_grid(h, w, tile, lo, hi) == \
                jinternvl.optimal_tile_grid(h, w, tile, lo, hi), (h, w, tile)


@pytest.mark.parametrize("hw", IMAGES + [(300, 57)])
def test_tiles_equal_jax(hw):
    img = _image(*hw, seed=sum(hw))
    got, n = internvl.internvl_tiles(img, TILE, 1, 12)
    want, m = jinternvl.internvl_tiles(img, TILE, 1, 12)
    assert n == m == len(got) and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_pixel_shuffle_is_exactly_jax():
    x = np.random.default_rng(0).standard_normal((3, 4, 4, 8), np.float32)
    got = internvl.pixel_shuffle(torch.as_tensor(x), 0.5).numpy()
    want = np.asarray(jinternvl.pixel_shuffle(jnp.asarray(x), 0.5))
    assert got.shape == (3, 2, 2, 32)
    np.testing.assert_array_equal(got, want)


def _prompts(tb, sizes=IMAGES[:2], seed=0, pad=3):
    """Left-padded prompts with one image each: the images' patches,
    grids and token ids (text ids clear of the image token)."""
    rng = np.random.default_rng(seed)
    img_id = tb.cfg.image_token_id
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate(sizes):
        p, grid, n = tb.preprocess_image(_image(h, w, seed + i))
        patches.append(p)
        grids.append(grid)
        text = rng.integers(10, 300, 6 + i).tolist()
        prompts.append(text[:2] + [img_id] * n + text[2:])
    T = max(map(len, prompts)) + pad
    ids = np.zeros((len(prompts), T), np.int64)
    mask = np.zeros((len(prompts), T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    return ids, mask, patches, grids


def test_preprocess_and_vision_arrays_equal_jax(tiny):
    jb, tb = tiny["jb"], tiny["tb"]
    for i, (h, w) in enumerate(IMAGES):
        img = _image(h, w, i)
        want, got = jb.preprocess_image(img), tb.preprocess_image(img)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    ids, _, patches, grids = _prompts(tb)
    want = jb.vision_arrays(ids, patches, grids, BUDGET)
    got = tb.vision_arrays(ids, patches, grids, BUDGET)
    assert set(got) == set(want) | {"tile_segments"}
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    n_real = sum(p.shape[0] for p in patches)
    assert n_real == 1 + 3
    np.testing.assert_array_equal(
        got["tile_segments"], (np.arange(12) < n_real).astype(np.int32))
    cut = ids.copy()                 # one image token short
    r, c = np.nonzero(cut == tb.cfg.image_token_id)
    cut[r[0], c[0]] = 11
    with pytest.raises(ValueError, match="image tokens"):
        tb.vision_arrays(cut, patches, grids, BUDGET)
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, 32)


def test_template_and_expansion_encode_as_jax():
    tok = internvl_tokenizer()
    msgs = [{"role": "user", "content": "<image>Are there any defects?"}]
    got_m = expand_image_tokens(msgs, [5], "intern_vl", "<IMG_CONTEXT>")
    assert got_m == jax_expand(msgs, [5], "intern_vl", "<IMG_CONTEXT>")
    got, want = get_template("intern_vl"), jax_template("intern_vl")
    assert (got.image_token, got.mm_style, got.stop_words) == (
        want.image_token, want.mm_style, tuple(want.stop_words))
    for system in (None, "Answer in one word."):
        ids = got.encode_prompt(tok, got_m, system)
        assert ids == want.encode_prompt(tok, got_m, system)
        assert ids[0] == tok.bos_token_id
        assert ids.count(tok.convert_tokens_to_ids("<IMG_CONTEXT>")) == 5
        pairs = got_m + [{"role": "assistant", "content": "No."}]
        assert got.encode_multiturn(tok, pairs, system) == [
            tuple(p) for p in want.encode_multiturn(tok, pairs, system)]


def test_preprocessor_statistics(tiny, tmp_path):
    """C.R13: the port's tiles read ImageNet's mean and std from a
    checkpoint's preprocessor_config.json (InternVL-2.5's published
    preprocessing); without the file they use OpenAI-CLIP's, the JAX
    package's constants, which it keeps whatever the file says."""
    imagenet = dict(image_mean=[0.485, 0.456, 0.406],
                    image_std=[0.229, 0.224, 0.225])
    path = tmp_path / "ckpt"
    path.mkdir()
    with open(path / "config.json", "w") as f:
        json.dump(tiny["hf"], f)
    img = _image(60, 100, 3)
    plain = bundle_from_pretrained(str(path)).preprocess_image(img)[0]
    np.testing.assert_allclose(plain, tiny["jb"].preprocess_image(img)[0],
                               atol=1e-6, rtol=0)
    with open(path / "preprocessor_config.json", "w") as f:
        json.dump(imagenet, f)
    got = bundle_from_pretrained(str(path)).preprocess_image(img)[0]
    tiles, _ = jinternvl.internvl_tiles(img, TILE, 1, 12,
                                        mean=imagenet["image_mean"],
                                        std=imagenet["image_std"])
    np.testing.assert_allclose(got, anyres.patchify_tiles(tiles, 14),
                               atol=1e-6, rtol=0)
    assert not np.allclose(got, plain)
    # the JAX bundle ignores the file: its tiles stay OpenAI-CLIP's
    from iadr1_tpu.models.registry import bundle_from_pretrained as jfrom

    np.testing.assert_array_equal(jfrom(str(path)).preprocess_image(img)[0],
                                  tiny["jb"].preprocess_image(img)[0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tower_batch(tb):
    ids, _, patches, grids = _prompts(tb, IMAGES[1:3], seed=1)
    return tb.vision_arrays(ids, patches, grids, BUDGET)


@pytest.mark.parametrize("remat", [False, True, "save_acts"])
def test_live_tile_features_match_jax(tiny, remat):
    """Pixel-shuffled, projected features of the tiles that hold images,
    f32, against JAX's dense tower; the remat modes run forward and
    backward."""
    jb, tb, jp = tiny["jb"], tiny["tb"], tiny["jparams"]
    arrays = _tower_batch(tb)
    n_real = int(arrays["tile_segments"].sum())
    want = np.asarray(jinternvl.image_features(
        jp, jb.cfg, jnp.asarray(arrays["tiles"]), JAX_FULL))
    params = copy.deepcopy(tiny["tparams"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(params["vision"])]
    got = internvl.image_features(
        params, tb.cfg, torch.as_tensor(arrays["tiles"]), FULL_PRECISION,
        remat, default_attention("auto"),
        torch.as_tensor(arrays["tile_segments"]))
    assert got.shape == (12 * FPT, 48)
    np.testing.assert_allclose(got.detach().numpy()[:n_real * FPT],
                               want[:n_real * FPT], atol=1e-5, rtol=0)
    grads = torch.autograd.grad(got[:n_real * FPT].sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("layout", ["model.language_model",
                                    "language_model.model"])
def test_logits_match_jax(tiny, layout):
    """The full forward's logits, f32, through both bundles (the port's
    tower masks its padding tiles, JAX's attends over them)."""
    jb, tb, jp = tiny["jb"], tiny["tb"], tiny["jparams"]
    tp = tb.convert_hf(_state(tiny, layout), device="cpu")
    ids, mask, patches, grids = _prompts(tb, seed=2)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    pos = np.clip(mask.cumsum(1) - 1, 0, None)
    batch = dict(arrays, input_ids=ids, position_ids=pos, segment_ids=mask)
    h, _ = jb.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()
                         if k != "tile_segments"})
    want = np.asarray(jb.logits_fn(jp, h))
    with torch.no_grad():
        h, _ = tb.apply(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
        got = tb.logits_fn(tp, h).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=120, max_new_tokens=8, batch_size=2,
           patch_budget=BUDGET)


def _requests():
    q = "<image>Are there any defects in the image?"
    return [{"messages": [{"role": "user", "content": q}],
             "images": [_image(*IMAGES[0], 0)]},
            {"messages": [{"role": "user", "content": "Describe it. " + q}],
             "images": [_image(*IMAGES[2], 1)]}]


@functools.lru_cache(maxsize=None)
def _noised_state(path):
    rng = np.random.default_rng(0)
    return {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in jax_load(path).items()}


def test_greedy_generation_is_token_identical_to_jax(tiny):
    tok = internvl_tokenizer()
    state = _noised_state(tiny["path"])
    jb = tiny["jb"]
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template(jb.template), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(tiny["path"], precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template(tb.template), GeneratorConfig(**GEN),
                        device="cpu")
    enc = [tgen._encode_request(r["messages"], r["images"])
           for r in _requests()]
    jenc = [jgen._encode_request(r["messages"], r["images"])
            for r in _requests()]
    for (ids, patches, grids), (jids, jpatches, _) in zip(enc, jenc):
        assert ids == list(jids)
        assert ids.count(tb.cfg.image_token_id) == FPT * patches[0].shape[0]
    got_b = tgen._collate(enc)
    assert int(got_b["tile_segments"].sum()) == 1 + 7
    want = jgen.engine.generate(jgen.params, jgen._collate(jenc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, got_b)
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 2 and not torch.equal(ids[0], ids[1])


def test_int8_generation_is_token_identical_to_jax(tiny):
    """An int8 base (the infer CLI's --quant int8), greedy f32 rollouts of
    two image prompts: the port's tokens equal JAX's."""
    from iadr1_tpu.train.rollout import RolloutEngine as JaxEngine
    from iadr1_tpu.train.rollout import SamplingConfig as JaxSampling

    jb, tb = tiny["jb"], tiny["tb"]
    jqp = jq.quantize_tree(jb.convert_hf(_noised_state(tiny["path"])))
    tqp = params_from_jax(jqp, device="cpu")
    assert tqp["text"]["layers"]["attn"]["q"]["kernel"]["qvalues"].dtype \
        == torch.int8
    ids, mask, patches, grids = _prompts(tb, seed=4)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    kw = dict(max_new_tokens=6, temperature=0.0, eos_token_id=-1,
              pad_token_id=0)
    P = ids.shape[1]
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()
              if k != "tile_segments"}
    want = JaxEngine(jb, JaxSampling(**kw), max_len=P + 6,
                     cache_dtype=jnp.float32).generate(
        jqp, dict(jbatch, input_ids=jnp.asarray(ids, jnp.int32),
                  attention_mask=jnp.asarray(mask, jnp.int32)),
        jax.random.PRNGKey(0))["completion_ids"]
    got = RolloutEngine(tb, SamplingConfig(**kw), max_len=P + 6,
                        cache_dtype=torch.float32, device="cpu").generate(
        tqp, {k: torch.as_tensor(v) for k, v in
              dict(arrays, input_ids=ids, attention_mask=mask).items()}
    )["completion_ids"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the port's own quantizer gives the same codes
    mine = quantize_tree(tb.convert_hf(_noised_state(tiny["path"]),
                                       device="cpu"), fmt="int8")
    for name, t in _leaves(mine):
        assert torch.equal(t, dict(_leaves(tqp))[name]), name


def test_infer_cli_answers_a_benchmark_over_int8(tiny, tmp_path):
    """cli/infer.py on the tiny checkpoint with ``--quant int8``: the
    bundle's intern_vl template, the <img> runs and the family's tiles,
    over an int8 base."""
    from helpers import build_benchmark_json
    from iadr1_tpu_torch.cli.infer import main

    test_data, image_dir = build_benchmark_json(tmp_path, n=4)
    out = tmp_path / "out"
    assert main(["--model-path", tiny["path"], "--test-data", test_data,
                 "--image-dir", image_dir, "--output-dir", str(out),
                 "--batch-size", "2", "--max-prompt-length", "200",
                 "--max-new-tokens", "4", "--patch-budget", str(BUDGET),
                 "--quant", "int8", "--device", "cpu"]) == 0
    with open(out / "answers_0_shot.json") as f:
        answers = json.load(f)
    assert len(answers) == 4 and all("response" in a for a in answers)


# ---------------------------------------------------------------------------
# PA-SFT, LoRA
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CUTOFF, CHUNK = 48, 64


@functools.lru_cache(maxsize=None)
def _sft_batches(path):
    """Six examples (four with an image of 1 to 8 tiles) packed by the
    port and batched by its VLMBatchBuilder: two batches of two rows."""
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    rng = np.random.default_rng(5)
    img_id = tb.cfg.image_token_id
    examples = []
    for i in range(6):
        prompt = [1, 2] + rng.integers(10, 300, 3 + i % 3).tolist()
        extra = {}
        if i % 3 != 2:
            h, w = IMAGES[i % len(IMAGES)]
            p, grid, n = tb.preprocess_image(_image(h, w, 10 + i))
            prompt += [img_id] * n
            extra = {"extras": {"patches": [p], "grid_thw": [grid]}}
        answer = rng.integers(10, 300, 8 + 3 * i).tolist()
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer, **extra})
    rows = pack_examples(examples, CUTOFF, 0)
    assert len(rows) >= 4
    collate = VLMBatchBuilder(tb, patch_budget=24 * 16)
    return tb, [collate(rows[i:i + 2]) for i in (0, 2)]


def test_sft_steps_match_jax(tiny):
    """Loss, grad norm and learning rate of 3 steps, and the parameters
    after 1 and after 3 steps, on the port's batches."""
    jb = tiny["jb"]
    tb, batches = _sft_batches(tiny["path"])
    assert all(b["tiles"].shape == (24, 16, 588) for b in batches)
    jparams = jb.convert_hf(jax_load(tiny["path"]))
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstate = jax_state(jparams, jo)
    jfn = jax_step(lambda p, b: jb.hidden_fn(p, b, remat=False),
                   jb.head_kernel_fn, jo, jsched, donate=False,
                   chunk_size=CHUNK)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstate = create_train_state(params_from_jax(jparams, device="cpu"), to)
    tfn = make_chunked_sft_step_port(tb, to, tsched)
    for step, i in enumerate([0, 1, 0], start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batches[i].items()
                                  if k != "tile_segments"})
        tstate, tm = tfn(tstate, batches[i])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {step} grad norm")
        if step in (1, 3):
            _assert_params_close(tstate.params, jstate.params, 2e-6,
                                 f"step {step}")


def make_chunked_sft_step_port(tb, opt, sched):
    """The port's step with the recipes' remat modes (save_qkv, the
    tower's save_acts), held to JAX's step without remat."""
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step

    return make_chunked_sft_step(
        lambda p, b: tb.hidden_fn(p, b, remat="save_qkv",
                                  tower_remat="save_acts"),
        tb.head_kernel_fn, opt, sched, chunk_size=CHUNK)


def test_lora_hidden_states_and_adapter_gradients_match_jax(tiny):
    """LoRA over the decoder ("text" subtree, JAX's tree and targets,
    rank 4, B drawn non-zero): the hidden states and the adapters'
    gradients of a linear read-out, against JAX's."""
    jb, tb = tiny["jb"], tiny["tb"]
    _, batches = _sft_batches(tiny["path"])
    batch = batches[0]
    jbase = tiny["jparams"]
    jcfg = jad.TuningConfig(finetuning_type="lora", lora_rank=4)
    jlora = jax.tree.map(lambda x: x + 0.02, jad.init_lora_params(
        jax.random.PRNGKey(1), jbase, jcfg))
    scale = jcfg.lora_scale
    # padding positions (segment 0) attend no key: the frameworks give
    # them different values, which reach no loss
    valid = batch["segment_ids"] != 0
    readout = np.random.default_rng(3).standard_normal(
        batch["input_ids"].shape + (48,)).astype(np.float32)
    readout *= valid[..., None]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "tile_segments"}

    def jloss(lo):
        h = jb.hidden_fn(jbase, jbatch, remat=False, lora=lo,
                         lora_scale=scale)
        return (h * readout).sum(), h

    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(jlora)
    tbase = tiny["tparams"]
    tlora = params_from_jax(jlora, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tlora)]
    th = tb.hidden_fn(tbase, {k: torch.as_tensor(v) for k, v in
                              batch.items()},
                      lora=tlora, lora_scale=tad.TuningConfig(
                          finetuning_type="lora", lora_rank=4).lora_scale)
    np.testing.assert_allclose(th.detach().numpy()[valid],
                               np.asarray(jh)[valid], atol=1e-5, rtol=1e-4)
    tg = torch.autograd.grad((th * torch.as_tensor(readout)).sum(), leaves,
                             allow_unused=True)
    want = [g for g in jax.tree.leaves(jg)]
    assert len(tg) == len(want)
    n_text = 0
    for g, w in zip(tg, want):
        if g is None:        # the tower's adapters: the tower takes none
            assert not np.asarray(w).any()
            continue
        n_text += 1
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
    assert n_text > 0


# ---------------------------------------------------------------------------
# SC-GRPO
# ---------------------------------------------------------------------------

GRPO_PROMPT_LEN = 64
GRPO_BUDGET = 2 * 8 * 16           # the G = 1 collation holds 8 tiles


def grpo_examples(tb, sizes, seed=0):
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(sizes):
        p, grid, n = tb.preprocess_image(_image(h, w, 20 + i))
        examples.append({
            "prompt_ids": ([1] + [tb.cfg.image_token_id] * n
                           + rng.integers(10, 300, 5 + 3 * i).tolist()),
            "patches": [p], "grid_thw": [grid], "solution": "ab"[i]})
    return examples


@pytest.fixture(scope="module")
def grpo_case(tiny):
    return record_grpo_case(tiny["jb"], tiny["tb"], tiny["jparams"],
                            grpo_examples(tiny["tb"], IMAGES[:2]),
                            GRPO_PROMPT_LEN, GRPO_BUDGET)


def test_jax_update_batch_drops_the_tiles(grpo_case):
    """C.R9 reaches InternVL: the JAX update batch keeps the scatter
    indices but not the tiles, and nothing raises; its update then scores
    the completions without the image."""
    keys = grpo_case["jax_update_keys"]
    assert "tiles" not in keys
    assert {"scatter_rows", "scatter_cols", "prompt_ids"} <= keys


def test_shared_pred_matches_jax(tiny, grpo_case):
    check_shared_pred(tiny["jb"], tiny["tb"], grpo_case)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
def test_update_matches_jax_fed_the_port_batch(tiny, grpo_case, shared):
    """The port's update batch carries tiles and tile_segments (R9
    repaired); one update on it matches JAX's update step with the tiles
    put back into JAX's batch."""
    check_update(tiny["jb"], tiny["tb"], grpo_case, shared)


def test_grpo_cli_runs_the_family(tiny, tmp_path, monkeypatch):
    """cli/train_grpo.py main on the tiny checkpoint (the Qwen2.5-VL
    recipe with paths and sizes overridden): the intern_vl template
    encodes the prompts, the update batch carries the tiles, a step
    runs."""
    from helpers import build_iad_rl_dataset
    from iadr1_tpu_torch.cli import train_grpo
    from iadr1_tpu_torch.train import grpo as tgrpo

    seen = {}
    inner_step = tgrpo.GRPOTrainer.step

    def step(self, examples):
        inner = self.update_step

        def update(state, ref, batch):
            seen["keys"] = set(batch)
            return inner(state, ref, batch)

        self.update_step = update
        self.tokenizer = Tok()
        return inner_step(self, examples)

    monkeypatch.setattr(tgrpo.GRPOTrainer, "step", step)
    data, img_dir = build_iad_rl_dataset(tmp_path)
    out = tmp_path / "out"
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "grpo_qwen2_5_vl_7b.yaml")
    assert train_grpo.main([
        "--config", recipe, "--device", "cpu",
        f"model.model_name_or_path={tiny['path']}", "model.dtype=float32",
        f"data.dataset_name={data}", f"data.image_path={img_dir}",
        "data.template=intern_vl", "data.patch_budget=512",
        "grpo.num_generations=2", "grpo.max_prompt_length=200",
        "grpo.max_completion_length=4", "grpo.approx_top_k=false",
        f"train.output_dir={out}", "train.max_steps=1",
        "train.batch_size=2", "train.save_steps=0"]) == 0
    assert {"tiles", "tile_segments", "scatter_rows"} <= seen["keys"]
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and np.isfinite(records[0]["loss"])


def test_sft_cli_runs_the_family(tiny, tmp_path):
    """cli/train_sft.py main on the tiny checkpoint with the Qwen2.5-VL
    recipe's settings and the intern_vl template: prepare_rows expands
    each image into <img> + <IMG_CONTEXT> x n + </img>, the loss is
    finite."""
    from helpers import build_iad_sft_dataset
    from iadr1_tpu_torch.cli import train_sft

    data, img_dir = build_iad_sft_dataset(tmp_path)
    out = tmp_path / "out"
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "sft_qwen2_5_vl_7b.yaml")
    assert train_sft.main([
        "--config", recipe, "--device", "cpu",
        f"model.model_name_or_path={tiny['path']}",
        f"data.dataset={data}", f"data.image_dir={img_dir}",
        "data.template=intern_vl", "data.cutoff_len=512",
        "data.patch_budget=512", "optim.learning_rate=1e-3",
        "optim.warmup_steps=0", f"train.output_dir={out}",
        "train.max_steps=2", "train.batch_size=2", "train.logging_steps=1",
        "train.save_steps=0"]) == 0
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["current_steps"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in records)
