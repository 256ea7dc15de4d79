"""The port's LLaVA-OneVision (SigLIP tower, anyres packing, projector,
Qwen2 decoder; the llava_next_qwen template) against the JAX package.

A tiny ``LlavaOnevisionForConditionalGeneration`` is written by
``save_pretrained`` into a temporary directory and loaded by both
packages.  Its tower is 144 wide with 2 heads, so the head dim is
SigLIP's 72, and its decoder has 14 heads over 2 KV heads (GQA group 7,
as LLaVA-OneVision-0.5B).  Both run FULL_PRECISION (f32 compute).

Tolerances: tower features and logits atol 2e-5 (f32; the two differ in
summation order only), against the JAX tower run dense (its bundle's
default) and with ``tower_attention_fn=flash_attn`` in interpret mode
(the port's tower takes the K1 twin on the CPU).  Greedy tokens must be
identical (the checkpoint gets seeded noise, as tests/test_torch_generate.py
says why).  SFT steps: loss, grad norm and learning rate rtol 1e-5,
parameters atol 2e-6 after 1 and 3 steps (as tests/test_torch_sft.py,
whose reasons hold here), with the exceptions ``_param_atol`` states.  Remat modes against
no remat: atol 1e-7, rtol 1e-6 (the same arithmetic replayed).

The JAX package cannot encode a LLaVA-OneVision request with an image
(ROADMAP C.R6: its ``expand_image_tokens`` reads its own ``<image>`` run as
further placeholders), so the JAX side is fed the port's encoded rows.
The SC-GRPO cases at the end run the helpers of tests/test_torch_llava.py
(its tolerances; C.R9 pinned for this family too).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_llava as llava_cases
from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.mm import expand_image_tokens as jax_expand
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models import siglip as jsiglip
from iadr1_tpu.models.attention import flash_attn as jax_flash_attn
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.mm import expand_image_tokens
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import siglip
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import (
    NOT_YET_PORTED,
    bundle_from_hf_config,
    bundle_from_pretrained,
)
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import (
    batch_to_device,
    chunked_sft_loss,
    make_chunked_sft_step,
)
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

ATOL = 2e-5
TILE = 56                    # a tiny "384": 4 x 4 patches of 14 px
PINPOINTS = [[56, 56], [56, 112], [112, 56], [112, 112], [112, 168]]
IMAGES = [(70, 100), (150, 60), (56, 56), (120, 130)]    # (h, w)


def build_tiny_llava_ov_checkpoint(dirpath: str) -> str:
    """A tiny LLaVA-OneVision HF checkpoint (config, safetensors and the
    tiny tokenizer of tests/helpers.py, whose ``<image>`` is the image
    token) with a non-zero newline vector."""
    from transformers import (
        LlavaOnevisionConfig,
        LlavaOnevisionForConditionalGeneration,
    )

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    cfg = LlavaOnevisionConfig(
        vision_config=dict(hidden_size=144, intermediate_size=96,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=TILE, patch_size=14,
                           hidden_act="gelu_pytorch_tanh"),
        text_config=dict(vocab_size=max(tok.vocab_size, 600),
                         hidden_size=112, intermediate_size=160,
                         num_hidden_layers=2, num_attention_heads=14,
                         num_key_value_heads=2, rope_theta=10000.0,
                         rms_norm_eps=1e-6, tie_word_embeddings=True,
                         max_position_embeddings=1024),
        image_token_index=tok.convert_tokens_to_ids("<image>"),
        video_token_index=0, image_grid_pinpoints=PINPOINTS,
        vision_aspect_ratio="anyres_max_9",
        vision_feature_select_strategy="full", vision_feature_layer=-1)
    model = LlavaOnevisionForConditionalGeneration(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("image_newline"):
                p.normal_()
    model.save_pretrained(dirpath)
    return dirpath


def _image(h, w, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = build_tiny_llava_ov_checkpoint(
        str(tmp_path_factory.mktemp("ckpt")))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name]), name


# ---------------------------------------------------------------------------
# registry, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_resolves_the_family(tiny, key):
    hf = dict(tiny["hf"])
    if key == "model_type":
        hf.pop("architectures")
    else:
        hf.pop("model_type")
    bundle = bundle_from_hf_config(hf)
    assert bundle.family == "llava_onevision" and bundle.multimodal
    assert bundle.template == "llava_next_qwen"
    assert bundle.cfg.vision.head_dim == 72
    assert "llava_onevision" not in NOT_YET_PORTED
    assert "LlavaOnevisionForConditionalGeneration" not in NOT_YET_PORTED


# the newer HF key layout (transformers' own modules), from the older one
# that save_pretrained writes for compatibility
NEW_LAYOUT = [("language_model.model.", "model.language_model."),
              ("language_model.lm_head.", "lm_head."),
              ("vision_tower.", "model.vision_tower."),
              ("multi_modal_projector.", "model.multi_modal_projector."),
              ("image_newline", "model.image_newline")]


@pytest.mark.parametrize("layout", ["language_model.model",
                                    "model.language_model"])
def test_convert_hf_equals_jax_convert_then_params_from_jax(tiny, layout):
    state = load_safetensors_path(tiny["path"])
    assert any(k.startswith("language_model.model.") for k in state)
    if layout == "model.language_model":
        def rename(key):
            for old, new in NEW_LAYOUT:
                if key.startswith(old):
                    return new + key[len(old):]
            raise AssertionError(key)
        state = {rename(k): v for k, v in state.items()}
    jp = tiny["jb"].convert_hf(state)
    tp = tiny["tb"].convert_hf(state, device="cpu")
    _assert_trees_equal(tp, params_from_jax(jp, device="cpu"))


def test_params_from_jax_carries_a_jax_llava_onevision_tree(tiny):
    """JAX's init_params tree (stacked tower and decoder layers) comes
    across leaf for leaf, shapes and values."""
    jp = tiny["jb"].init_params(jax.random.PRNGKey(3))
    tp = params_from_jax(jp, device="cpu")
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert got.keys() == want.keys()
    assert got["/vision/layers/attn/q/kernel"].shape == (2, 144, 144)
    assert got["/vision/layers/mlp/fc1/kernel"].shape == (2, 144, 96)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    fresh = tiny["tb"].init_params(seed=3, device="cpu")
    assert dict(_leaves(fresh)).keys() == got.keys()
    for name, t in _leaves(fresh):
        assert t.shape == got[name].shape, name


# ---------------------------------------------------------------------------
# host side: images, vision arrays, the template, C.R6
# ---------------------------------------------------------------------------


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


def test_preprocess_and_vision_arrays_equal_jax(tiny):
    jb, tb = tiny["jb"], tiny["tb"]
    for i, (h, w) in enumerate(IMAGES):
        img = _image(h, w, i)
        want, got = jb.preprocess_image(img), tb.preprocess_image(img)
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    ids, _, patches, grids = _prompts(tb)
    budget = 12 * 16                           # 12 tiles, 8 of them used
    want = jb.vision_arrays(ids, patches, grids, budget)
    got = tb.vision_arrays(ids, patches, grids, budget)
    # the port adds each tile's segment id: 0 for the budget's padding
    # tiles, which its tower skips
    assert set(got) == set(want) | {"tile_segments"}
    n_real = sum(p.shape[0] for p in patches)
    np.testing.assert_array_equal(got["tile_segments"],
                                  (np.arange(12) < n_real).astype(np.int32))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    cut = ids.copy()                 # one image token short
    cut[np.nonzero(cut == tb.cfg.image_token_id)[0][0],
        np.nonzero(cut == tb.cfg.image_token_id)[1][0]] = 11
    with pytest.raises(ValueError, match="image tokens"):
        tb.vision_arrays(cut, patches, grids, budget)
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, 4 * 16)


def test_checkpoint_image_statistics_are_read(tiny, tmp_path):
    """ROADMAP C.R11: a checkpoint whose preprocessor_config.json states
    other image statistics (a locally built LlavaOnevisionImageProcessor
    with SigLIP's 0.5 / 0.5, saved beside the config, no download): the
    port's tiles equal that processor's ``pixel_values``; the JAX package
    still normalises with OpenAI-CLIP's constants (pinned)."""
    import shutil

    from transformers import LlavaOnevisionImageProcessor

    from iadr1_tpu.models.registry import (
        bundle_from_pretrained as jax_from_pretrained,
    )
    from iadr1_tpu.vision import anyres as jax_anyres
    from iadr1_tpu_torch.vision import anyres

    shutil.copy(os.path.join(tiny["path"], "config.json"), tmp_path)
    proc = LlavaOnevisionImageProcessor(
        image_mean=[0.5] * 3, image_std=[0.5] * 3,
        size={"height": TILE, "width": TILE},
        crop_size={"height": TILE, "width": TILE},
        image_grid_pinpoints=PINPOINTS)
    proc.save_pretrained(str(tmp_path))
    tb = bundle_from_pretrained(str(tmp_path))
    jb = jax_from_pretrained(str(tmp_path))
    for i, (h, w) in enumerate(IMAGES):
        img = _image(h, w, 10 + i)
        want = proc(images=img, return_tensors="np")["pixel_values"][0]
        got = tb.preprocess_image(img)[0]
        np.testing.assert_array_equal(
            got, anyres.patchify_tiles(want[:got.shape[0]], 14))
        # the JAX bundle: OpenAI-CLIP's statistics whatever the file says
        jax_tiles = jb.preprocess_image(img)[0]
        clip, _ = jax_anyres.onevision_tiles(img, [tuple(p) for p in
                                                   PINPOINTS], TILE)
        np.testing.assert_array_equal(jax_tiles,
                                      anyres.patchify_tiles(clip, 14))
        assert not np.allclose(jax_tiles, got)
    np.testing.assert_array_equal(jax_anyres.DEFAULT_MEAN,
                                  anyres.DEFAULT_MEAN)
    np.testing.assert_array_equal(jax_anyres.DEFAULT_STD, anyres.DEFAULT_STD)
    # without the file, the port keeps OpenAI-CLIP's, as before
    np.testing.assert_array_equal(
        bundle_from_pretrained(tiny["path"]).preprocess_image(img)[0],
        jax_tiles)


def test_llava_expansion_counts_each_placeholder_once():
    """C.R6: the llava style expands ``<image>`` into n ``<image>`` tokens
    (the run does not feed the loop); the JAX function raises."""
    messages = [{"role": "user", "content": "<image>What is shown?"},
                {"role": "assistant", "content": "A part."},
                {"role": "user", "content": "And <image> here<image>?"}]
    got = expand_image_tokens(messages, [3, 1, 2], "llava", "<image>")
    assert [m["content"] for m in got] == [
        "<image><image><image>What is shown?", "A part.",
        "And <image> here<image><image>?"]
    assert got[1] == messages[1]
    with pytest.raises(ValueError, match="more image placeholders"):
        jax_expand(messages[:1], [3], "llava", "<image>")
    with pytest.raises(ValueError, match="placeholders found"):
        expand_image_tokens(messages, [3, 1, 2, 4], "llava", "<image>")
    # the styles whose runs hold no placeholder expand as JAX does
    for style, token in (("qwen2_vl", "<|image_pad|>"),
                         ("plain", "<|image_pad|>")):
        assert expand_image_tokens(messages, [3, 1, 2], style, token) == \
            jax_expand(messages, [3, 1, 2], style, token)


def test_llava_next_qwen_template_encodes_as_jax():
    tok = tiny_qwen_tokenizer()
    messages = expand_image_tokens(
        [{"role": "user", "content": "<image>Are there any defects?"}],
        [5], "llava", "<image>")
    got = get_template("llava_next_qwen")
    want = jax_template("llava_next_qwen")
    assert (got.image_token, got.mm_style) == (want.image_token,
                                               want.mm_style)
    ids = got.encode_prompt(tok, messages)
    assert ids == want.encode_prompt(tok, messages)
    assert ids.count(tok.convert_tokens_to_ids("<image>")) == 5
    pairs = messages + [{"role": "assistant", "content": "No."}]
    assert got.encode_multiturn(tok, pairs) == [
        tuple(p) for p in want.encode_multiturn(tok, pairs)]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _jax_flash(q, k, v, causal=False):
    return jax_flash_attn(q, k, v, causal=causal, interpret=True)


@pytest.mark.parametrize("tower", ["dense", "flash"])
def test_tower_and_logits_match_jax(tiny, tower):
    """The tower's features (before its post-layernorm, as the model reads
    them) and the full forward's logits, f32, against JAX's dense tower
    and its flash tower in interpret mode."""
    jb, tb, jp, tp = tiny["jb"], tiny["tb"], tiny["jparams"], tiny["tparams"]
    ids, mask, patches, grids = _prompts(tb, seed=1)
    arrays = tb.vision_arrays(ids, patches, grids, 12 * 16)
    jflash = _jax_flash if tower == "flash" else None
    port = bundle_from_hf_config(
        tiny["hf"], attention="auto" if tower == "flash" else "xla",
        precision=FULL_PRECISION)
    want = jsiglip.apply(jp["vision"], jb.cfg.vision,
                         jnp.asarray(arrays["tiles"]), precision=JAX_FULL,
                         post_layernorm=False, attention_fn=jflash)
    attn = None if tower == "dense" else default_attention("auto")
    with torch.no_grad():
        got = siglip.apply(tp["vision"], tb.cfg.vision,
                           torch.as_tensor(arrays["tiles"]),
                           precision=FULL_PRECISION, post_layernorm=False,
                           attention_fn=attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)

    pos = np.clip(mask.cumsum(1) - 1, 0, None)
    batch = dict(arrays, input_ids=ids, position_ids=pos, segment_ids=mask)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    h, _ = jb.apply(jp, jbatch, tower_attention_fn=jflash)
    want = np.asarray(jb.logits_fn(jp, h))
    with torch.no_grad():
        h, _ = port.apply(tp, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
        got = port.logits_fn(tp, h).numpy()
    valid = mask.astype(bool)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def _tower_grads(tb, params, tiles, remat):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params["vision"])]
    feats = siglip.apply(params["vision"], tb.cfg.vision, tiles,
                         precision=FULL_PRECISION, remat=remat,
                         post_layernorm=False,
                         attention_fn=default_attention("auto"))
    weights = torch.linspace(-1, 1, feats.numel()).reshape(feats.shape)
    # the post-layernorm is unused: the model reads the features before it
    return torch.autograd.grad((feats * weights).sum(), leaves,
                               allow_unused=True)


@pytest.mark.parametrize("mode", [True, "full", "save_acts", "save_qkv"])
def test_tower_remat_modes_give_the_same_gradients(tiny, mode):
    tb = tiny["tb"]
    ids, _, patches, grids = _prompts(tb, seed=2)
    tiles = torch.as_tensor(tb.vision_arrays(ids, patches, grids,
                                             8 * 16)["tiles"])
    params = tb.convert_hf(load_safetensors_path(tiny["path"]),
                           device="cpu")
    base = _tower_grads(tb, params, tiles, False)
    got = _tower_grads(tb, params, tiles, mode)
    assert sum(w is None for w in base) == 2          # post_norm
    for g, w in zip(got, base):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=224, max_new_tokens=10, batch_size=2,
           patch_budget=12 * 16)


@pytest.fixture(scope="module")
def gens(tiny):
    tok = tiny_qwen_tokenizer()
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in jax_load(tiny["path"]).items()}
    jb = tiny["jb"]
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template("llava_next_qwen"), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(tiny["path"], precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template(tb.template), GeneratorConfig(**GEN),
                        device="cpu")
    return jgen, tgen


def _requests():
    q = "<image>Are there any defects in the image?"
    return [{"messages": [{"role": "user", "content": q}],
             "images": [_image(*IMAGES[0], 0)]},
            {"messages": [{"role": "user", "content": "Describe it. " + q}],
             "images": [_image(*IMAGES[1], 1)]}]


def test_greedy_generation_is_token_identical_to_jax(gens):
    jgen, tgen = gens
    enc = [tgen._encode_request(r["messages"], r["images"])
           for r in _requests()]
    img_id = tgen.bundle.cfg.image_token_id
    for (ids, patches, grids), req in zip(enc, _requests()):
        seqlen = tgen.bundle.preprocess_image(req["images"][0])[2]
        assert ids.count(img_id) == seqlen and len(grids[0]) == 4
    with pytest.raises(ValueError, match="more image placeholders"):
        jgen._encode_request(_requests()[0]["messages"],
                             _requests()[0]["images"])
    want = jgen.engine.generate(jgen.params, jgen._collate(enc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, tgen._collate(enc))
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 3 and not torch.equal(ids[0], ids[1])


def test_generator_raises_on_a_prompt_that_cuts_an_image(gens):
    """C.P1 for a 1-D-position family: the check keys on image_token_id."""
    _, tgen = gens
    long = {"role": "user",
            "content": "<image>" + " defect" * GEN["max_prompt_length"]}
    with pytest.raises(ValueError, match="exceeds max_prompt_length"):
        tgen._encode_request([long], [_image(56, 56, 0)])


# ---------------------------------------------------------------------------
# PA-SFT
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)


def _param_atol(step: int, name: str) -> float:
    """Parameters of the two packages after ``step`` steps: 2e-6 (f32
    summation order, through Adam's normalised step).  The decoder's k
    bias 2e-5 (tests/test_torch_sft.py says why).  By step 3 the tower's
    and projector's leaves 1e-5, 1% of the learning rate: their gradients
    arrive through the anyres gather and the scatter, many elements are
    mostly f32 summation noise, and Adam's step carries that noise at the
    learning rate's scale (measured up to 4.6e-6, one element a leaf)."""
    if name == "/text/layers/attn/k/bias":
        return 2e-5
    if step == 3 and name.startswith(("/vision/", "/projector/")):
        return 1e-5
    return 2e-6
CUTOFF, CHUNK = 192, 64


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
    rows = pack_examples(examples, CUTOFF, 0)
    builder = VLMBatchBuilder(tb, patch_budget=24 * 16)
    return tb, [builder(rows[i:i + 2]) for i in (0, 2)]


def test_batch_builder_takes_the_rows_positions(tiny):
    tb, batches = _sft_batches(tiny["path"])
    for b in batches:
        assert b["position_ids"].shape == b["input_ids"].shape
        assert b["tiles"].shape == (24, 16, 588)
        segs = b["segment_ids"]
        for r in range(segs.shape[0]):       # positions restart per segment
            for s in np.unique(segs[r][segs[r] != 0]):
                span = b["position_ids"][r][segs[r] == s]
                np.testing.assert_array_equal(span, np.arange(len(span)))


def test_sft_steps_match_jax(tiny):
    """Loss, grad norm and learning rate of steps 1-3, and the parameters
    after 1 and after 3 steps, on the port's batches."""
    jb, tb = tiny["jb"], tiny["tb"]
    _, batches = _sft_batches(tiny["path"])
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
            want = dict(_leaves(jstate.params))
            for name, t in _leaves(tstate.params):
                np.testing.assert_allclose(
                    t.detach().numpy(), np.asarray(want[name]),
                    atol=_param_atol(step, name),
                    rtol=0, err_msg=f"step {step} {name}")


def test_recipe_remat_gives_the_same_gradients(tiny):
    """The recipe's remat (decoder save_qkv, tower save_acts) against no
    remat, through the bundle's hidden_fn and the chunked loss."""
    tb, batches = _sft_batches(tiny["path"])
    b = batch_to_device(batches[0], "cpu")

    def grads(**kw):
        params = tb.convert_hf(load_safetensors_path(tiny["path"]),
                               device="cpu")
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


def test_sft_cli_runs_the_recipe_config(tiny, tmp_path, monkeypatch):
    """cli/train_sft.py on configs/sft_llava_onevision_0_5b.yaml with its
    own keys, only the paths and sizes overridden: the template, the remat
    modes (save_qkv, tower save_acts), the bf16 CE blocks of 4096, the
    bf16 first moment and the bf16 parameters reach the step; the images
    expand through the llava style into anyres batches, and the log is
    finite."""
    from helpers import build_iad_sft_dataset
    from iadr1_tpu_torch.cli.train_sft import main
    from iadr1_tpu_torch.models.registry import ModelBundle
    from iadr1_tpu_torch.train import optimizers, sft

    seen = {}

    def spy(owner, name, record):
        fn = getattr(owner, name)

        def wrapped(*args, **kw):
            record(*args, **kw)
            return fn(*args, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    spy(sft, "make_chunked_sft_step",
        lambda *a, **kw: seen.update(chunk=kw["chunk_size"],
                                     logits=kw["logits_dtype"]))
    spy(optimizers, "make_optimizer",
        lambda cfg: seen.update(mu=cfg.mu_dtype, lr=cfg.learning_rate))
    spy(ModelBundle, "hidden_fn",
        lambda self, params, batch, **kw: seen.update(
            remat=kw, tiles=tuple(batch["tiles"].shape),
            dtype=params["text"]["embed"]["weight"].dtype))
    data, img_dir = build_iad_sft_dataset(tmp_path)
    out = tmp_path / "out"
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "sft_llava_onevision_0_5b.yaml")
    assert main(["--config", recipe, "--device", "cpu",
                 f"model.model_name_or_path={tiny['path']}",
                 f"data.dataset={data}", f"data.image_dir={img_dir}",
                 "data.cutoff_len=256", "data.patch_budget=128",
                 "optim.learning_rate=1e-3", "optim.warmup_steps=0",
                 f"train.output_dir={out}", "train.max_steps=2",
                 "train.batch_size=2", "train.logging_steps=1",
                 "train.save_steps=0"]) == 0
    assert seen["chunk"] == 4096 and seen["logits"] == torch.bfloat16
    assert seen["mu"] == "bfloat16" and seen["dtype"] == torch.bfloat16
    assert seen["remat"] == {"remat": "save_qkv", "tower_remat": "save_acts"}
    assert seen["tiles"] == (8, 16, 588)            # 128 // 16 tiles
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["current_steps"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in records)


# ---------------------------------------------------------------------------
# what this family does not have yet
# ---------------------------------------------------------------------------


def test_grpo_and_export_are_refused(tiny):
    """Since ROADMAP A.16 only the export is refused (as JAX's, which has
    no LLaVA branch); SC-GRPO takes the family, with its shared-prompt
    scoring."""
    from iadr1_tpu_torch.models.params_export import export_params
    from iadr1_tpu_torch.models.registry import GRPO_NOT_YET_PORTED
    from iadr1_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer

    tb, tp = tiny["tb"], tiny["tparams"]
    assert tb.shared_pred_fn is not None
    assert "llava_onevision" not in GRPO_NOT_YET_PORTED
    trainer = GRPOTrainer(tb, tiny_qwen_tokenizer(), None, GRPOConfig(), [],
                          None, tp, device="cpu")
    assert trainer._shared
    with pytest.raises(ValueError, match="llava_onevision"):
        export_params(tb, tp)


# ---------------------------------------------------------------------------
# SC-GRPO (ROADMAP A.16; the cases of tests/test_torch_llava.py)
# ---------------------------------------------------------------------------

GRPO_PROMPT_LEN, GRPO_BUDGET = 224, 2 * 8 * 16


@pytest.fixture(scope="module")
def grpo_case(tiny):
    """Two one-image prompts through the JAX trainer's shared-prompt step:
    its recorded rollout and its update batch's keys."""
    return llava_cases.record_grpo_case(
        tiny["jb"], tiny["tb"], tiny["jparams"],
        llava_cases.grpo_examples(tiny["tb"], IMAGES[1:3]), GRPO_PROMPT_LEN,
        GRPO_BUDGET)


def test_jax_update_batch_drops_the_image_arrays(grpo_case):
    """C.R9: JAX's update scores these completions without the image."""
    keys = grpo_case["jax_update_keys"]
    assert not set(llava_cases.LLAVA_VISION_KEYS) & keys
    assert {"scatter_rows", "scatter_cols", "prompt_ids"} <= keys


def test_shared_pred_matches_jax(tiny, grpo_case):
    llava_cases.check_shared_pred(tiny["jb"], tiny["tb"], grpo_case)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
def test_update_matches_jax_fed_the_port_batch(tiny, grpo_case, shared):
    """The 1-D-position branches of the update batch (positions from the
    masks), with the anyres arrays, against JAX's update step."""
    llava_cases.check_update(tiny["jb"], tiny["tb"], grpo_case, shared)


def test_trainer_step_with_its_own_engine(tiny):
    tb = tiny["tb"]
    llava_cases.check_trainer_step(
        tb, llava_cases.grpo_examples(tb, IMAGES[1:3], seed=1),
        GRPO_PROMPT_LEN, GRPO_BUDGET)


def test_infer_cli_answers_a_benchmark(tiny, tmp_path):
    """cli/infer.py on the tiny checkpoint: the requests expand through
    the llava style, collate with 1-D positions and the anyres arrays,
    and every item gets an answer (the JAX CLI raises here, C.R6)."""
    from helpers import build_benchmark_json
    from iadr1_tpu_torch.cli.infer import main

    test_data, image_dir = build_benchmark_json(tmp_path, n=4)
    out = tmp_path / "out"
    assert main(["--model-path", tiny["path"], "--test-data", test_data,
                 "--image-dir", image_dir, "--output-dir", str(out),
                 "--batch-size", "2", "--max-prompt-length", "400",
                 "--max-new-tokens", "4", "--patch-budget", "256",
                 "--device", "cpu"]) == 0
    with open(out / "answers_0_shot.json") as f:
        answers = json.load(f)
    assert len(answers) == 4 and all("response" in a for a in answers)
