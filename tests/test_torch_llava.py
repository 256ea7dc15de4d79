"""The port's LLaVA-1.5 and LLaVA-NeXT (CLIP tower, projector, llama-style
decoder; the llava, llava_next, llava_next_llama3 and llava_next_yi
templates) against the JAX package: serving, PA-SFT and SC-GRPO.

Tiny ``LlavaForConditionalGeneration`` and
``LlavaNextForConditionalGeneration`` checkpoints are written by
``save_pretrained`` into a temporary directory (with the tiny tokenizer of
tests/helpers.py, whose ``<image>`` is the image token) and loaded by
both packages.  The tower is 128 wide with 2 heads, so the head dim is
CLIP-L's 64, 3 layers of which 2 run (``vision_feature_layer`` -2); tiles
of 56 px (4 x 4 patches + CLS = 17 tokens).  The 1.5 decoder has 4 heads
over 4 KV heads (GQA group 1, as Vicuna-7B), the NeXT decoder 8 over 2
(group 4, as LLaMA-3-8B).  Both packages run FULL_PRECISION (f32 compute);
the JAX side runs ``attention="xla"`` (the JAX tower is dense in any
case), the port its K1 twin, whose tower masks the zero tiles that pad
the tile stream (``tile_segments``): the towers are compared on the real
tiles, whose features alone reach the tokens.

Tolerances: the host arrays and token ids exactly equal; tower features
atol 2e-5 and logits atol 1e-4 (f32, summation order only); remat modes
against no remat atol 1e-7, rtol 1e-6 (the same arithmetic replayed);
greedy tokens identical (the weights get seeded noise, as
tests/test_torch_generate.py says why); SFT loss, grad norm and learning
rate rtol 1e-5 and parameters atol 2e-6; GRPO metrics rtol 1e-4 and
parameters atol 1e-5 (tests/test_torch_grpo.py).

The JAX package cannot encode a LLaVA image request (ROADMAP C.R6), so its
generator is fed the port's encoded rows.  Its SC-GRPO update batch drops
the LLaVA families' vision arrays (ROADMAP C.R9: its update then scores
the completions as if the image tokens were plain embeddings), which one
test pins; the port's update is held to JAX's update step fed the port's
batch.  Its text config reader rotates a LLaMA decoder whose config
leaves ``rope_theta`` out at Qwen2's 1e6 (ROADMAP C.R10), also pinned.
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
from iadr1_tpu.cli.train_grpo import GRPODataSection as JaxDataSection
from iadr1_tpu.cli.train_grpo import make_vlm_prompt_collator as jax_collator
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models import clip_vit as jclip
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import _qwen2_text_cfg as jax_text_cfg
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import grpo as jgrpo
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu.vision import anyres as janyres
from iadr1_tpu_torch.cli.train_grpo import (
    GRPODataSection,
    make_vlm_prompt_collator,
)
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.mm import expand_image_tokens
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import clip_vit
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import (
    GRPO_NOT_YET_PORTED,
    NOT_YET_PORTED,
    _qwen2_text_cfg,
    bundle_from_hf_config,
    bundle_from_pretrained,
)
from iadr1_tpu_torch.train import grpo as tgrpo
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import (
    batch_to_device,
    chunked_sft_loss,
    make_chunked_sft_step,
)
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves
from iadr1_tpu_torch.vision import anyres
import torch_threads  # noqa: F401  (one intra-op thread)

TOWER_ATOL, LOGITS_ATOL = 2e-5, 1e-4
TILE = 56                    # a tiny "336": 4 x 4 patches of 14 px
PINPOINTS = [[56, 112], [112, 56], [112, 112], [56, 168]]
IMAGES = [(70, 100), (150, 60), (56, 56), (120, 130)]    # (h, w)
MODES = ["llava", "llava_next"]
VISION = dict(hidden_size=128, intermediate_size=96, num_hidden_layers=3,
              num_attention_heads=2, image_size=TILE, patch_size=14,
              hidden_act="quick_gelu", layer_norm_eps=1e-5)
TEXT = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
            max_position_embeddings=1024, model_type="llama")
HEADS = {"llava": (4, 4), "llava_next": (8, 2)}       # (heads, KV heads)


def build_tiny_llava_checkpoint(dirpath: str, mode: str) -> str:
    """A tiny LLaVA-1.5 ("llava") or LLaVA-NeXT ("llava_next") HF
    checkpoint: config, safetensors and the tiny tokenizer; NeXT's newline
    vector non-zero."""
    from transformers import (
        LlavaConfig,
        LlavaForConditionalGeneration,
        LlavaNextConfig,
        LlavaNextForConditionalGeneration,
    )

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    heads, kv = HEADS[mode]
    kw = dict(vision_config=dict(VISION),
              text_config=dict(TEXT, vocab_size=max(tok.vocab_size, 600),
                               num_attention_heads=heads,
                               num_key_value_heads=kv),
              image_token_index=tok.convert_tokens_to_ids("<image>"),
              vision_feature_layer=-2,
              vision_feature_select_strategy="default")
    if mode == "llava":
        model = LlavaForConditionalGeneration(LlavaConfig(**kw))
    else:
        model = LlavaNextForConditionalGeneration(LlavaNextConfig(
            **kw, image_grid_pinpoints=PINPOINTS))
        with torch.no_grad():
            model.get_parameter(next(
                n for n, _ in model.named_parameters()
                if n.endswith("image_newline"))).normal_()
    model.save_pretrained(dirpath)
    return dirpath


def _image(h, w, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("llava"))


@functools.lru_cache(maxsize=None)
def _checkpoint(root, mode):
    path = build_tiny_llava_checkpoint(os.path.join(root, mode), mode)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


@pytest.fixture(scope="module", params=MODES)
def tiny(root, request):
    return _checkpoint(root, request.param)


@pytest.fixture(scope="module")
def next_tiny(root):
    return _checkpoint(root, "llava_next")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_params_close(tparams, jparams, atol, msg):
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[name]),
                                   atol=atol, rtol=0, err_msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# registry, parameters, the text config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_resolves_the_family(tiny, key):
    hf = dict(tiny["hf"])
    hf.pop("model_type" if key == "architectures" else "architectures")
    bundle = bundle_from_hf_config(hf)
    mode = tiny["tb"].family
    assert bundle.family == mode and bundle.template == mode
    assert bundle.cfg.anyres == (mode == "llava_next")
    assert bundle.cfg.vision.head_dim == 64 and bundle.cfg.tower_layers == 2
    assert not bundle.cfg.text.attention_bias
    assert bundle.shared_pred_fn is not None
    assert mode not in NOT_YET_PORTED and mode not in GRPO_NOT_YET_PORTED
    assert not GRPO_NOT_YET_PORTED


@pytest.mark.parametrize("arch", [
    "LlavaNextVideoForConditionalGeneration",
    "VideoLlavaForConditionalGeneration", "pixtral"])
def test_video_and_pixtral_families_name_their_item(next_tiny, arch):
    """The video families (tests/test_torch_video.py) and Pixtral (a
    LLaVA config with a pixtral vision_config, tests/test_torch_pixtral.py)
    are ported and build with their family and template."""
    hf = dict(next_tiny["hf"], architectures=[arch],
              model_type=arch if arch != "pixtral" else "llava")
    if arch == "pixtral":
        hf["architectures"] = ["LlavaForConditionalGeneration"]
        hf["vision_config"] = dict(hf["vision_config"], model_type="pixtral")
        bundle = bundle_from_hf_config(hf)
        assert bundle.family == bundle.template == "pixtral"
        assert arch not in NOT_YET_PORTED
        return
    family = {"LlavaNextVideoForConditionalGeneration": "llava_next_video",
              "VideoLlavaForConditionalGeneration": "video_llava"}[arch]
    bundle = bundle_from_hf_config(dict(hf, video_token_index=8))
    assert bundle.family == bundle.template == family
    assert bundle.preprocess_video is not None
    assert bundle.cfg.separate_video_tower == (family == "video_llava")
    assert arch not in NOT_YET_PORTED


def test_llama_text_config_takes_llama_defaults():
    """C.R10: a LLaMA text config that leaves fields out means
    transformers.LlamaConfig's defaults; the JAX reader fills rope_theta
    with Qwen2's 1e6 (and wants the widths written out)."""
    from transformers import LlamaConfig

    hf = {"model_type": "llama", "vocab_size": 32064, "rms_norm_eps": 1e-5,
          "max_position_embeddings": 4096}
    got = _qwen2_text_cfg(hf, attention_bias=False)
    want = LlamaConfig(**hf)
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "rms_norm_eps", "rope_theta",
                  "tie_word_embeddings"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.rope_theta == 10000.0 and not got.attention_bias
    full = {**hf, "hidden_size": 4096, "intermediate_size": 11008,
            "num_hidden_layers": 32, "num_attention_heads": 32}
    assert jax_text_cfg(full).rope_theta == 1000000.0
    with pytest.raises(KeyError):
        jax_text_cfg(hf)
    # a Qwen2 text config keeps the Qwen2 default
    qwen = dict(full, model_type="qwen2")
    assert _qwen2_text_cfg(qwen).rope_theta == 1000000.0


NEW_LAYOUT = [("language_model.model.", "model.language_model."),
              ("language_model.lm_head.", "lm_head."),
              ("vision_tower.", "model.vision_tower."),
              ("multi_modal_projector.", "model.multi_modal_projector."),
              ("image_newline", "model.image_newline")]


@pytest.mark.parametrize("layout", ["language_model.model",
                                    "model.language_model"])
def test_convert_hf_equals_jax_convert_then_params_from_jax(tiny, layout):
    state = load_safetensors_path(tiny["path"])
    if not any(k.startswith("language_model.model.") for k in state):
        pytest.fail("save_pretrained wrote the newer layout")
    if layout == "model.language_model":
        def rename(key):
            for old, new in NEW_LAYOUT:
                if key.startswith(old):
                    return new + key[len(old):]
            raise AssertionError(key)
        state = {rename(k): v for k, v in state.items()}
    want = dict(_leaves(params_from_jax(tiny["jb"].convert_hf(state),
                                        device="cpu")))
    got = dict(_leaves(tiny["tb"].convert_hf(state, device="cpu")))
    assert got.keys() == want.keys()
    assert ("/image_newline" in got) == (tiny["tb"].family == "llava_next")
    for name, t in got.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name


def test_init_params_has_the_jax_tree(tiny):
    jp = jax.eval_shape(tiny["jb"].init_params, jax.random.PRNGKey(3))
    want = {n: tuple(a.shape) for n, a in _leaves(jp)}
    got = {n: tuple(t.shape) for n, t in _leaves(
        tiny["tb"].init_params(seed=3, device="cpu"))}
    assert got == want
    assert got["/vision/pos_embed"] == (17, 128)


def test_export_is_refused_as_in_jax(tiny):
    """The JAX export has no LLaVA branch; the port's raises alike."""
    from iadr1_tpu.models.params_export import export_params as jax_export
    from iadr1_tpu_torch.models.params_export import export_params

    with pytest.raises(ValueError, match=tiny["tb"].family):
        export_params(tiny["tb"], tiny["tparams"])
    with pytest.raises(ValueError, match=tiny["tb"].family):
        jax_export(tiny["jb"], tiny["jparams"])


def test_video_inputs_name_their_item(next_tiny):
    """LLaVA-NeXT (an image family) refuses video frames, in the collator
    and in its vision arrays; the video families take them
    (tests/test_torch_video.py)."""
    tb = next_tiny["tb"]
    ids = np.zeros((1, 4), np.int64)
    row = {"input_ids": ids[0], "labels": ids[0], "segment_ids": ids[0],
           "position_ids": ids[0],
           "extras": [{"video_patches": [np.zeros((1, 16, 588))]}]}
    with pytest.raises(ValueError, match="video frame stacks"):
        VLMBatchBuilder(tb, patch_budget=64)([row])
    with pytest.raises(ValueError, match="takes no videos"):
        tb.vision_arrays(ids, [], [], 64, videos=[np.zeros((1, 16, 588))])


# ---------------------------------------------------------------------------
# host side: images, vision arrays, templates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", IMAGES + [(57, 300), (301, 57)])
def test_clip_center_crop_and_next_tiles_equal_jax(hw):
    img = _image(*hw, 3)
    np.testing.assert_array_equal(
        anyres.clip_resize_center_crop(img, 336),
        janyres.clip_resize_center_crop(img, 336))
    got, grid = anyres.llava_next_tiles(img, PINPOINTS, TILE)
    want, jgrid = janyres.llava_next_tiles(img, PINPOINTS, TILE)
    np.testing.assert_array_equal(got, want)
    assert tuple(grid) == tuple(jgrid)


def _prompts(tb, seed=0, pad=3):
    """Left-padded prompts with one image each: the images' patches,
    grids and token ids (text ids clear of the image token)."""
    rng = np.random.default_rng(seed)
    img_id = tb.cfg.image_token_id
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate(IMAGES[:2]):
        p, grid, n = tb.preprocess_image(_image(h, w, seed + i))
        patches.append(p)
        grids.append(grid)
        text = rng.integers(10, 300, 6 + i).tolist()
        prompts.append(text[:2] + [img_id] * n + text[2:])
    T = max(map(len, prompts)) + pad
    ids = np.zeros((2, T), np.int64)
    mask = np.zeros((2, T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    return ids, mask, patches, grids


BUDGET = 12 * 16                 # 12 tiles of 16 patches


def test_preprocess_and_vision_arrays_equal_jax(tiny):
    jb, tb = tiny["jb"], tiny["tb"]
    for i, (h, w) in enumerate(IMAGES):
        img = _image(h, w, i)
        want, got = jb.preprocess_image(img), tb.preprocess_image(img)
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    ids, _, patches, grids = _prompts(tb)
    want = jb.vision_arrays(ids, patches, grids, BUDGET)
    got = tb.vision_arrays(ids, patches, grids, BUDGET)
    assert set(got) == set(want) | {"tile_segments"}
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    n_real = sum(p.shape[0] for p in patches)
    np.testing.assert_array_equal(
        got["tile_segments"], (np.arange(12) < n_real).astype(np.int32))
    assert (got["tiles"][n_real:] == 0).all()
    cut = ids.copy()                 # one image token short
    r, c = np.nonzero(cut == tb.cfg.image_token_id)
    cut[r[0], c[0]] = 11
    with pytest.raises(ValueError, match="image tokens"):
        tb.vision_arrays(cut, patches, grids, BUDGET)
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, 16)


@pytest.mark.parametrize("name", ["llava", "llava_next",
                                  "llava_next_llama3", "llava_next_yi"])
def test_templates_encode_as_jax(name):
    tok = copy.deepcopy(tiny_qwen_tokenizer())
    tok.bos_token = "<|im_start|>"          # llama3's prefix is its BOS
    messages = expand_image_tokens(
        [{"role": "user", "content": "<image>Are there any defects?"}],
        [5], "llava", "<image>")
    got, want = get_template(name), jax_template(name)
    assert (got.image_token, got.mm_style) == (want.image_token,
                                               want.mm_style) == (
        "<image>", "llava")
    for system in (None, "Answer in one word."):
        ids = got.encode_prompt(tok, messages, system)
        assert ids == want.encode_prompt(tok, messages, system)
        assert ids.count(tok.convert_tokens_to_ids("<image>")) == 5
        pairs = messages + [{"role": "assistant", "content": "No."}]
        assert got.encode_multiturn(tok, pairs, system) == [
            tuple(p) for p in want.encode_multiturn(tok, pairs, system)]
        turns = pairs + [{"role": "user", "content": "Where?"}]
        assert got.encode_prompt(tok, turns, system) == want.encode_prompt(
            tok, turns, system)


def test_chatml_prompts_need_only_encode():
    """A tokenizer that only encodes (the card smoke's stand-in) still
    renders the chatml templates, whose slots hold no EOS or BOS."""
    class Encoder:
        def encode(self, text, add_special_tokens=False):
            return [ord(c) for c in text]

    messages = [{"role": "user", "content": "Any defects?"}]
    for name in ("qwen2_vl", "llava_next_qwen", "llava_next_yi"):
        ids = get_template(name).encode_prompt(Encoder(), messages, "Sys.")
        want = jax_template(name).render_conversation(
            messages, "Sys.", add_generation_prompt=True)
        assert "".join(map(chr, ids)) == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["xla", "auto"])
def test_tower_matches_jax_on_the_real_tiles(tiny, attention):
    """The tower's features (layer L - 1, no post-layernorm, CLS dropped),
    f32, against JAX's dense tower, on the tiles that hold images."""
    jb, tb, jp, tp = tiny["jb"], tiny["tb"], tiny["jparams"], tiny["tparams"]
    ids, _, patches, grids = _prompts(tb, seed=1)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    real = arrays["tile_segments"].astype(bool)
    want = np.asarray(jclip.apply(
        jp["vision"], jb.cfg.vision, jnp.asarray(arrays["tiles"]),
        precision=JAX_FULL, num_layers=jb.cfg.tower_layers))
    attn = default_attention(attention) if attention == "auto" else None
    with torch.no_grad():
        got = clip_vit.apply(
            tp["vision"], tb.cfg.vision, torch.as_tensor(arrays["tiles"]),
            precision=FULL_PRECISION, num_layers=tb.cfg.tower_layers,
            attention_fn=attn,
            tile_segments=torch.as_tensor(arrays["tile_segments"])).numpy()
    assert got.shape == want.shape == (12, 16, 128)
    np.testing.assert_allclose(got[real], want[real], atol=TOWER_ATOL,
                               rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("layout", ["language_model.model",
                                    "model.language_model"])
def test_logits_match_jax(tiny, layout):
    """The full forward's logits, f32, through both bundles (the port's
    tower masks its padding tiles, JAX's attends over them)."""
    jb, tb, jp = tiny["jb"], tiny["tb"], tiny["jparams"]
    state = load_safetensors_path(tiny["path"])
    if layout == "model.language_model":
        def rename(key):
            return next(new + key[len(old):] for old, new in NEW_LAYOUT
                        if key.startswith(old))
        state = {rename(k): v for k, v in state.items()}
    tp = tb.convert_hf(state, device="cpu")
    ids, mask, patches, grids = _prompts(tb, seed=2)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    pos = np.clip(mask.cumsum(1) - 1, 0, None)
    batch = dict(arrays, input_ids=ids, position_ids=pos, segment_ids=mask)
    h, _ = jb.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jp, h))
    with torch.no_grad():
        h, _ = tb.apply(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
        got = tb.logits_fn(tp, h).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=LOGITS_ATOL,
                               rtol=0)


def _tower_grads(tb, params, tiles, segs, remat):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params["vision"])]
    feats = clip_vit.apply(params["vision"], tb.cfg.vision, tiles,
                           precision=FULL_PRECISION, remat=remat,
                           num_layers=tb.cfg.tower_layers,
                           attention_fn=default_attention("auto"),
                           tile_segments=segs)
    weights = torch.linspace(-1, 1, feats.numel()).reshape(feats.shape)
    return torch.autograd.grad((feats * weights).sum(), leaves,
                               allow_unused=True)


@pytest.mark.parametrize("mode", [True, "full", "save_acts", "save_qkv"])
def test_tower_remat_modes_give_the_same_gradients(next_tiny, mode):
    tb = next_tiny["tb"]
    ids, _, patches, grids = _prompts(tb, seed=3)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    tiles = torch.as_tensor(arrays["tiles"])
    segs = torch.as_tensor(arrays["tile_segments"])
    params = copy.deepcopy(next_tiny["tparams"])
    base = _tower_grads(tb, params, tiles, segs, False)
    got = _tower_grads(tb, params, tiles, segs, mode)
    # the post-layernorm and the third layer do not reach the features
    assert sum(w is None for w in base) == 2
    for g, w in zip(got, base):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=224, max_new_tokens=10, batch_size=2,
           patch_budget=BUDGET)


def _requests():
    q = "<image>Are there any defects in the image?"
    return [{"messages": [{"role": "user", "content": q}],
             "images": [_image(*IMAGES[0], 0)]},
            {"messages": [{"role": "user", "content": "Describe it. " + q}],
             "images": [_image(*IMAGES[1], 1)]}]


def test_greedy_generation_is_token_identical_to_jax(tiny):
    tok = tiny_qwen_tokenizer()
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in jax_load(tiny["path"]).items()}
    jb = tiny["jb"]
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template(jb.template), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(tiny["path"], precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template(tb.template), GeneratorConfig(**GEN),
                        device="cpu")
    enc = [tgen._encode_request(r["messages"], r["images"])
           for r in _requests()]
    for (ids, _, grids), req in zip(enc, _requests()):
        n = tb.preprocess_image(req["images"][0])[2]
        assert ids.count(tb.cfg.image_token_id) == n and len(grids[0]) == 4
    got_b = tgen._collate(enc)
    assert int(got_b["tile_segments"].sum()) == sum(
        p[0].shape[0] for _, p, _ in enc)
    want = jgen.engine.generate(jgen.params, jgen._collate(enc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, got_b)
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 3 and not torch.equal(ids[0], ids[1])


def test_infer_cli_answers_a_benchmark(tiny, tmp_path):
    """cli/infer.py on the tiny checkpoint: the bundle's template, the
    llava expansion, 1-D positions and the family's vision arrays."""
    from helpers import build_benchmark_json
    from iadr1_tpu_torch.cli.infer import main

    test_data, image_dir = build_benchmark_json(tmp_path, n=4)
    out = tmp_path / "out"
    assert main(["--model-path", tiny["path"], "--test-data", test_data,
                 "--image-dir", image_dir, "--output-dir", str(out),
                 "--batch-size", "2", "--max-prompt-length", "200",
                 "--max-new-tokens", "4", "--patch-budget", str(BUDGET),
                 "--device", "cpu"]) == 0
    with open(out / "answers_0_shot.json") as f:
        answers = json.load(f)
    assert len(answers) == 4 and all("response" in a for a in answers)


# ---------------------------------------------------------------------------
# PA-SFT
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
# rows of 64 tokens for 1.5 (16 features an image), 128 for NeXT (up to
# 90): four rows or more either way
CUTOFF, CHUNK = {"llava": 64, "llava_next": 128}, 64


@functools.lru_cache(maxsize=None)
def _sft_batches(path):
    """Six examples (four with an image) packed by the port and batched by
    its VLMBatchBuilder: two batches of two rows."""
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
    rows = pack_examples(examples, CUTOFF[tb.family], 0)
    assert len(rows) >= 4
    builder = VLMBatchBuilder(tb, patch_budget=24 * 16)
    return tb, [builder(rows[i:i + 2]) for i in (0, 2)]


def test_sft_steps_match_jax(tiny):
    """Loss, grad norm and learning rate of steps 1-3, and the parameters
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
    tfn = make_chunked_sft_step(tb.hidden_fn, tb.head_kernel_fn, to, tsched,
                                chunk_size=CHUNK)
    for step, i in enumerate([0, 1, 0], start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batches[i].items()})
        tstate, tm = tfn(tstate, batches[i])
        for key in ("loss", "grad_norm", "learning_rate", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {key}")
        if step in (1, 3):
            _assert_params_close(tstate.params, jstate.params, 2e-6,
                                 f"step {step}")


def test_recipe_remat_gives_the_same_gradients(next_tiny):
    """save_qkv with the tower's save_acts (the LLaVA SFT recipe's modes)
    against no remat, through hidden_fn and the chunked loss."""
    tb, batches = _sft_batches(next_tiny["path"])
    b = batch_to_device(batches[0], "cpu")

    def grads(**kw):
        params = copy.deepcopy(next_tiny["tparams"])
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = chunked_sft_loss(tb.hidden_fn(params, b, **kw),
                                   tb.head_kernel_fn(params), b["labels"],
                                   CHUNK)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    base = grads(remat=False, tower_remat=False)
    got = grads(remat="save_qkv", tower_remat="save_acts")
    for g, w in zip(got, base):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


def test_sft_cli_takes_the_recipe_template(next_tiny, tmp_path, monkeypatch):
    """cli/train_sft.py on configs/sft_llava_onevision_0_5b.yaml (the
    family's mm style) with ``data.template=llava_next``: prepare_rows
    expands the images through the llava style into the NeXT arrays, the
    recipe's template reaches the encoding, and the log is finite."""
    from helpers import build_iad_sft_dataset
    from iadr1_tpu_torch.cli import train_sft
    from iadr1_tpu_torch.models.registry import ModelBundle

    seen = {}
    inner = ModelBundle.hidden_fn
    inner_rows = train_sft.prepare_rows

    def hidden_fn(self, params, batch, **kw):
        seen.update(keys=set(batch), tiles=int(batch["tile_segments"].sum()))
        return inner(self, params, batch, **kw)

    def prepare_rows(cfg, tokenizer, template, *args, **kw):
        seen["template"] = template.name
        return inner_rows(cfg, tokenizer, template, *args, **kw)

    monkeypatch.setattr(ModelBundle, "hidden_fn", hidden_fn)
    monkeypatch.setattr(train_sft, "prepare_rows", prepare_rows)
    data, img_dir = build_iad_sft_dataset(tmp_path)
    out = tmp_path / "out"
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "sft_llava_onevision_0_5b.yaml")
    assert train_sft.main([
        "--config", recipe, "--device", "cpu",
        f"model.model_name_or_path={next_tiny['path']}",
        f"data.dataset={data}", f"data.image_dir={img_dir}",
        "data.template=llava_next", "data.cutoff_len=256",
        "data.patch_budget=128", "optim.learning_rate=1e-3",
        "optim.warmup_steps=0", f"train.output_dir={out}",
        "train.max_steps=2", "train.batch_size=2", "train.logging_steps=1",
        "train.save_steps=0"]) == 0
    assert seen["template"] == "llava_next"
    assert {"tiles", "tile_segments", "pack_src", "newline_mask"} <= \
        seen["keys"] and seen["tiles"] >= 1
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["current_steps"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in records)


# ---------------------------------------------------------------------------
# SC-GRPO (helpers shared with tests/test_torch_llava_onevision.py)
# ---------------------------------------------------------------------------

EOS, PAD = 3, 2
GRPO_OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
                max_grad_norm=1.0, eps=1e-4)
GRPO_KW = dict(num_generations=2, beta=0.04, temperature=1.0, top_k=0,
               top_p=1.0, max_completion_length=4, logp_chunk_size=8,
               remat=False)
# the families' image arrays, which the JAX update batch drops (C.R9)
LLAVA_VISION_KEYS = ("tiles", "pack_src", "pack_weights", "newline_mask")


class Tok:
    """The three attributes the trainer needs; ids decode to letters."""
    eos_token_id, pad_token_id = EOS, PAD

    def batch_decode(self, seqs, skip_special_tokens=True):
        return ["".join(chr(97 + int(t) % 26) for t in s
                        if int(t) not in (EOS, PAD)) for s in seqs]


def vowel_reward(completions, **kwargs):
    return [sum(ch in "aeiou" for ch in c[0]["content"]) / 4.0
            + len(c[0]["content"]) / 16.0 for c in completions]


def grpo_examples(tb, sizes, seed=0):
    """One prompt per image size, each with its image's token run."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(sizes):
        p, grid, n = tb.preprocess_image(_image(h, w, 20 + i))
        examples.append({
            "prompt_ids": ([1] + [tb.cfg.image_token_id] * n
                           + rng.integers(10, 300, 5 + 3 * i).tolist()),
            "patches": [p], "grid_thw": [grid], "solution": "ab"[i]})
    return examples


class RecordingEngine:
    """Around the JAX engine: keeps what ``generate`` returned, after
    cutting one rollout short (an EOS, then padding)."""

    def __init__(self, engine):
        self.engine, self.out = engine, None

    def generate(self, *args, **kw):
        out = {k: np.array(v) for k, v in
               self.engine.generate(*args, **kw).items()}
        ids, mask = out["completion_ids"], out["completion_mask"]
        ids[1, 1], ids[1, 2:], mask[1, 2:] = EOS, PAD, 0
        self.out = out
        return out


class ReplayEngine:
    """The port trainer's engine, replaced: returns a recorded rollout."""

    def __init__(self, recorded):
        self.recorded = recorded

    def generate(self, params, batch, generator=None, group_size=1):
        return {k: torch.as_tensor(v) for k, v in self.recorded.items()}


def record_grpo_case(jb, tb, jparams, examples, prompt_len, patch_budget):
    """The JAX trainer's shared-prompt step on ``examples``: its recorded
    rollout and the keys of its update batch (C.R9)."""
    G = GRPO_KW["num_generations"]
    jparams = jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               x.shape, x.dtype), jparams)
    data = dict(patch_budget=patch_budget)
    jcollate = jax_collator(jb, Tok(), None, JaxDataSection(**data),
                            prompt_len, G)
    tcollate = make_vlm_prompt_collator(tb, Tok(), None,
                                        GRPODataSection(**data),
                                        prompt_len, G)
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**GRPO_OPT))
    jt = jgrpo.GRPOTrainer(
        jb, Tok(), jo,
        jgrpo.GRPOConfig(**GRPO_KW, max_prompt_length=prompt_len),
        [vowel_reward], jax_state(jax.tree.map(jnp.copy, jparams), jo),
        jax.tree.map(jnp.copy, jparams), schedule=jsched,
        prompt_collator=jcollate)
    jt.engine = RecordingEngine(jt.engine)
    keys = []
    inner = jt.update_step
    jt.update_step = lambda s, r, b: keys.append(set(b)) or inner(s, r, b)
    jt.step(examples)
    return dict(jparams=jparams, tcollate=tcollate, examples=examples,
                rollout=jt.engine.out, jax_update_keys=keys[0],
                prompt_len=prompt_len)


def port_update(tb, case, shared=True):
    """The port trainer's step on the recorded rollout: (metrics, update
    batch, trainer)."""
    key = ("update", shared)
    if key not in case:
        to, tsched = topt.make_optimizer(topt.OptimizerConfig(**GRPO_OPT))
        jparams = case["jparams"]
        tt = tgrpo.GRPOTrainer(
            tb, Tok(), to,
            tgrpo.GRPOConfig(**GRPO_KW, shared_prompt_scoring=shared,
                             max_prompt_length=case["prompt_len"]),
            [vowel_reward],
            create_train_state(params_from_jax(jparams, device="cpu"), to),
            params_from_jax(jparams, device="cpu"), schedule=tsched,
            prompt_collator=case["tcollate"], device="cpu")
        assert tt._shared == shared
        tt.engine = ReplayEngine(case["rollout"])
        batches = []
        inner = tt.update_step
        tt.update_step = lambda s, r, b: batches.append(b) or inner(s, r, b)
        metrics = tt.step(case["examples"])
        case[key] = (metrics, batches[0], tt)
    return case[key]


def check_shared_pred(jb, tb, case):
    """The shared-prompt scoring's hidden states (tower once per unique
    prompt, completions over the shared prompt K/V) against JAX's, on the
    port's update batch."""
    batch = port_update(tb, case)[1]
    G = GRPO_KW["num_generations"]
    jparams = case["jparams"]
    want = np.asarray(jb.shared_pred_fn(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, G,
        remat=False))
    with torch.no_grad():
        got = tb.shared_pred_fn(params_from_jax(jparams, device="cpu"),
                                batch_to_device(batch, "cpu"), G,
                                remat=False).numpy()
    m = batch["completion_mask"].astype(bool)
    np.testing.assert_allclose(got[m], want[m], atol=LOGITS_ATOL, rtol=0)


def check_update(jb, tb, case, shared, vision_key="tiles"):
    """C.R9 repaired: the port's update batch carries the image arrays
    (``vision_key`` among them); one update on it matches JAX's update
    step (dense attention) fed the same batch: every metric, and every
    parameter after it."""
    metrics, batch, tt = port_update(tb, case, shared)
    vision = set(case["tcollate"](case["examples"], 1)) - set(
        tgrpo.PROMPT_KEYS)
    assert vision_key in vision and vision <= set(batch)
    assert "position_ids" not in case["tcollate"](case["examples"], 1)
    G = GRPO_KW["num_generations"]
    cfg = jgrpo.GRPOConfig(**GRPO_KW, shared_prompt_scoring=shared,
                           max_prompt_length=case["prompt_len"])
    logps_fn = None
    if shared:
        def logps_fn(params, b, _aux):
            pred = jb.shared_pred_fn(params, b, G, remat=False)
            return jgrpo.chunked_token_logps(
                pred, jb.head_kernel_fn(params), b["completion_ids"],
                cfg.logp_chunk_size)
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**GRPO_OPT))
    jstep = jgrpo.make_grpo_update_step(
        jgrpo.bundle_score_fn(jb, remat=False), jo, cfg, jsched,
        logps_fn=logps_fn, ref_logps_fn=logps_fn)
    jparams = case["jparams"]
    jstate = jax_state(jax.tree.map(jnp.copy, jparams), jo)
    jbatch = {k: (v if k == "prompt_len" else jnp.asarray(v))
              for k, v in batch.items()}
    jstate, jm = jstep(jstate, jparams, jbatch)
    for key in jm:
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert metrics["reward_std"] > 0 and all(
        np.isfinite(v) for v in metrics.values())
    _assert_params_close(tt.state.params, jstate.params, 1e-5,
                         "shared" if shared else "dense")


def check_trainer_step(tb, examples, prompt_len, patch_budget):
    """One port GRPOTrainer.step with image prompts, sampling from its own
    engine: finite metrics, a parameter update, the image arrays in the
    update batch."""
    tcollate = make_vlm_prompt_collator(
        tb, Tok(), None, GRPODataSection(patch_budget=patch_budget),
        prompt_len, GRPO_KW["num_generations"])
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**GRPO_OPT))
    params = tb.init_params(seed=1, device="cpu")
    before = copy.deepcopy(params)
    tt = tgrpo.GRPOTrainer(
        tb, Tok(), to,
        tgrpo.GRPOConfig(**GRPO_KW, max_prompt_length=prompt_len),
        [vowel_reward], create_train_state(params, to),
        copy.deepcopy(params), schedule=tsched, prompt_collator=tcollate,
        device="cpu", seed=3)
    keys = []
    inner = tt.update_step
    tt.update_step = lambda s, r, b: keys.append(set(b)) or inner(s, r, b)
    m = tt.step(examples)
    assert all(np.isfinite(v) for v in m.values()) and tt.state.step == 1
    assert m["reward_std"] > 0          # so the update moves the policy
    anyres_family = getattr(tb.cfg, "anyres", True)     # 1.5: tiles only
    assert "tiles" in keys[0]
    assert (set(LLAVA_VISION_KEYS) <= keys[0]) == anyres_family
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tt.state.params), tree_leaves(before)))


GRPO_PROMPT_LEN = 96
GRPO_BUDGET = 2 * 8 * 16        # the G = 1 collation holds 8 tiles


@pytest.fixture(scope="module")
def grpo_case(next_tiny):
    """LLaVA-NeXT's prompts through the JAX trainer (the 1.5 family's
    update takes the same code with one array fewer)."""
    return record_grpo_case(
        next_tiny["jb"], next_tiny["tb"], next_tiny["jparams"],
        grpo_examples(next_tiny["tb"], IMAGES[1:3]), GRPO_PROMPT_LEN,
        GRPO_BUDGET)


def test_jax_update_batch_drops_the_image_arrays(grpo_case):
    """C.R9: the JAX update batch copies Qwen2-VL's vision keys only; the
    LLaVA families' arrays are missing, and nothing raises."""
    keys = grpo_case["jax_update_keys"]
    assert not set(LLAVA_VISION_KEYS) & keys
    assert {"scatter_rows", "scatter_cols", "prompt_ids"} <= keys


def test_shared_pred_matches_jax(next_tiny, grpo_case):
    check_shared_pred(next_tiny["jb"], next_tiny["tb"], grpo_case)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
def test_update_matches_jax_fed_the_port_batch(next_tiny, grpo_case,
                                                shared):
    check_update(next_tiny["jb"], next_tiny["tb"], grpo_case, shared)


def test_trainer_step_with_its_own_engine(tiny):
    tb = tiny["tb"]
    check_trainer_step(tb, grpo_examples(tb, IMAGES[1:3], seed=1),
                       GRPO_PROMPT_LEN, GRPO_BUDGET)


def test_grpo_cli_runs_the_llava_next_recipe(next_tiny, tmp_path,
                                             monkeypatch):
    """cli/train_grpo.py on configs/grpo_llava_next_34b.yaml on one device
    (its 16 x 4 mesh runs on 64 processes, and one process says how to
    launch it; tests/test_torch_tensor_parallel.py runs it on a small
    mesh), in the recipe's
    own LoRA mode with reference elision (rank 16, alpha 32), paths and
    sizes overridden: the recipe's llava_next_yi template encodes the
    prompts, a step runs, and the checkpoint holds the adapters and their
    moments alone."""
    from helpers import build_iad_rl_dataset
    from iadr1_tpu_torch.cli import train_grpo

    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "grpo_llava_next_34b.yaml")
    base = ["--config", recipe, "--device", "cpu",
            f"model.model_name_or_path={next_tiny['path']}"]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 64"):
        train_grpo.main(base)
    seen = []
    inner = train_grpo.encode_rl_examples

    def encode(rows, cfg, bundle, tokenizer, template):
        seen.append(template.name)
        return inner(rows, cfg, bundle, tokenizer, template)

    monkeypatch.setattr(train_grpo, "encode_rl_examples", encode)
    data, img_dir = build_iad_rl_dataset(tmp_path)
    out = tmp_path / "out"
    assert train_grpo.main(base + [
        "mesh.fsdp=1", "mesh.tp=1",
        "model.dtype=float32", f"data.dataset_name={data}",
        f"data.image_path={img_dir}", "data.patch_budget=256",
        "grpo.num_generations=2", "grpo.max_prompt_length=200",
        "grpo.max_completion_length=4", f"train.output_dir={out}",
        "train.max_steps=1", "train.batch_size=2", "train.save_steps=0"]) == 0
    assert seen == ["llava_next_yi"]
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and np.isfinite(records[0]["loss"])
    from safetensors import safe_open

    with safe_open(str(out / "checkpoints" / "1.safetensors"), "pt") as f:
        names = [k for k in f.keys() if "." in k]
    assert names and all(k.endswith((".a", ".b")) for k in names), names
    assert any(k.startswith("mu.text.layers.attn.q.kernel.") for k in names)
    a = [k for k in names if k.startswith("params.")][0]
    with safe_open(str(out / "checkpoints" / "1.safetensors"), "pt") as f:
        assert f.get_tensor(a).shape[-1] == 16 or f.get_tensor(
            a).shape[-2] == 16
