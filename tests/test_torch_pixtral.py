"""The port's Pixtral (the 2-D-RoPE tower over one packed patch stream,
the LLaVA projector, the Mistral decoder; the pixtral template and mm
style) against the JAX package: the host side, serving, PA-SFT and
SC-GRPO.

A tiny ``LlavaForConditionalGeneration`` with a pixtral vision config is
written by ``save_pretrained`` into a temporary directory with the tiny
tokenizer of tests/helpers.py plus ``[IMG]`` (the image token),
``[IMG_BREAK]`` and ``[IMG_END]``, and loaded by both packages.  The
tower is 128 wide with 2 heads, so its head dim is Pixtral-ViT's 64;
images up to 64 px (``max_side`` 4 patches of 16).  The decoder has 4
heads over 2, untied.  Both packages run FULL_PRECISION (f32 compute);
the JAX side runs ``attention="xla"`` (its tower is dense in any case),
the port its K1 twin: one segment-masked call a tower layer over the
stream, whose padding sits at segment 0.  The towers are compared on the
images' patches, whose features alone reach the tokens.

Tolerances: the host arrays and token ids exactly equal, the patches
within 1e-6; tower features atol 2e-5; logits atol 1e-4 (f32, summation
order only); greedy tokens identical (the weights get seeded noise); SFT
loss rtol 1e-5, grad norm rtol 1e-4, parameters atol 2e-6; GRPO metrics
rtol 1e-4 and parameters atol 1e-5 (tests/test_torch_llava.py's
helpers).

The JAX package's hazards, each pinned on both sides: its resize rounds
the scaled sides up where transformers floors them (ROADMAP C.R2), its
text config reader needs ``num_attention_heads`` and fills a missing
``rope_theta`` with 1e6 where a Mistral config means 32 and 1e4 (C.R17),
and its SC-GRPO update batch drops the patch stream (C.R9: its update
scores the completions without the images).
"""

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
from iadr1_tpu.models import pixtral as jpixtral
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import _qwen2_text_cfg as jax_text_cfg
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
from iadr1_tpu_torch.models import pixtral
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_export import export_params
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import (
    _qwen2_text_cfg,
    bundle_from_hf_config,
    bundle_from_pretrained,
    pixtral_resize_hw,
)
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import make_chunked_sft_step
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves
from test_torch_llava import (
    _assert_params_close,
    _image,
    _leaves,
    check_update,
    port_update,
    record_grpo_case,
)

PS, EDGE = 16, 64                  # patch size, the longest edge
VISION = dict(model_type="pixtral", hidden_size=128, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2, head_dim=64,
              image_size=EDGE, patch_size=PS, rope_theta=10000.0)
TEXT = dict(model_type="mistral", hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=False, sliding_window=None,
            attention_dropout=0.0)
IMAGE_TOKENS = ["[IMG]", "[IMG_BREAK]", "[IMG_END]"]
# (h, w) -> patch grids (4, 4), (2, 3), (4, 2) after the resize
IMAGES = [(64, 64), (30, 40), (120, 60)]
TOWER_ATOL, LOGITS_ATOL = 2e-5, 1e-4
BUDGET = 48


def pixtral_tokenizer():
    tok = tiny_qwen_tokenizer()
    tok.add_tokens(IMAGE_TOKENS, special_tokens=True)
    tok.bos_token = "<|endoftext|>"
    return tok


def build_tiny_pixtral_checkpoint(dirpath: str) -> str:
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    tok = pixtral_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    model = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=dict(VISION),
        text_config=dict(TEXT, vocab_size=max(len(tok), 600)),
        image_token_index=tok.convert_tokens_to_ids("[IMG]"),
        vision_feature_layer=-1, vision_feature_select_strategy="full",
        projector_hidden_act="gelu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.3 * torch.randn_like(p))
    model.eval().save_pretrained(dirpath)
    return dirpath


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = build_tiny_pixtral_checkpoint(
        str(tmp_path_factory.mktemp("pixtral")))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


# ---------------------------------------------------------------------------
# registry, parameters, the text config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_routes_the_llava_config_to_pixtral(tiny, key):
    hf = dict(tiny["hf"])
    hf.pop("model_type" if key == "architectures" else "architectures")
    tb = bundle_from_hf_config(hf)
    assert tb.family == "pixtral" and tb.template == "pixtral"
    assert tb.cfg.vision.head_dim == 64 and tb.cfg.vision.max_side == 4
    assert not tb.cfg.text.attention_bias and tb.shared_pred_fn is None
    assert tb.cfg.image_token_id == tiny["jb"].cfg.image_token_id


def test_mistral_text_config_takes_mistral_defaults():
    """C.R17: a sparse Mistral text config, as Pixtral-12B's published
    one (no num_attention_heads), and one without rope_theta.  The port
    reads transformers' MistralConfig defaults; the JAX reader raises on
    the first and fills the second's rope_theta with 1e6."""
    from transformers import MistralConfig

    published = dict(model_type="mistral", hidden_size=5120, head_dim=128,
                     intermediate_size=14336, num_hidden_layers=40,
                     num_key_value_heads=8, rms_norm_eps=1e-5,
                     rope_theta=1e9, vocab_size=131072)
    cfg = _qwen2_text_cfg(published, attention_bias=False)
    assert (cfg.num_attention_heads, cfg.head_dim_, cfg.rope_theta) == (
        MistralConfig().num_attention_heads, 128, 1e9)
    with pytest.raises(KeyError, match="num_attention_heads"):
        jax_text_cfg(published)
    sparse = dict(TEXT, vocab_size=600)
    del sparse["rope_theta"]
    assert _qwen2_text_cfg(sparse).rope_theta == MistralConfig().rope_theta
    assert jax_text_cfg(sparse).rope_theta == 1e6


NEW_TO_OLD = [("model.language_model.", "language_model.model."),
              ("lm_head.", "language_model.lm_head."),
              ("model.vision_tower.", "vision_tower."),
              ("model.multi_modal_projector.", "multi_modal_projector.")]


def _state(tiny, layout):
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


def test_init_params_has_the_jax_tree_and_export_is_refused(tiny):
    got = dict(_leaves(tiny["tb"].init_params(seed=0, device="cpu")))
    # shapes only: jax.eval_shape traces the JAX init without running it
    want = dict(_leaves(jax.eval_shape(
        lambda: tiny["jb"].init_params(jax.random.PRNGKey(0)))))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
    with pytest.raises(ValueError, match="pixtral"):
        export_params(tiny["tb"], tiny["tparams"])


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def test_template_and_expansion_encode_as_jax():
    tok = pixtral_tokenizer()
    msgs = [{"role": "user", "content": "<image>Are there any defects?"}]
    got_m = expand_image_tokens(msgs, [(2, 3)], "pixtral", "[IMG]")
    assert got_m == jax_expand(msgs, [(2, 3)], "pixtral", "[IMG]")
    assert got_m[0]["content"].startswith(
        "[IMG][IMG][IMG][IMG_BREAK][IMG][IMG][IMG][IMG_END]Are")
    got, want = get_template("pixtral"), jax_template("pixtral")
    assert (got.image_token, got.mm_style, got.system_in_user) == (
        want.image_token, want.mm_style, want.system_in_user)
    for system in (None, "Answer in one word."):
        ids = got.encode_prompt(tok, got_m, system)
        assert ids == want.encode_prompt(tok, got_m, system)
        assert ids[0] == tok.bos_token_id
        assert ids.count(tok.convert_tokens_to_ids("[IMG]")) == 6
        pairs = got_m + [{"role": "assistant", "content": "No."}]
        assert got.encode_multiturn(tok, pairs, system) == [
            tuple(p) for p in want.encode_multiturn(tok, pairs, system)]


def _prompts(tb, sizes=IMAGES[:2], seed=0, pad=3):
    """Left-padded pixtral prompts, one image each: BOS, its rows of
    [IMG] with [IMG_BREAK] / [IMG_END], text ids clear of them."""
    rng = np.random.default_rng(seed)
    tok = pixtral_tokenizer()
    brk, end = (tok.convert_tokens_to_ids(t) for t in IMAGE_TOKENS[1:])
    img_id = tb.cfg.image_token_id
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate(sizes):
        p, grid, (rows, cols) = tb.preprocess_image(_image(h, w, seed + i))
        patches.append(p)
        grids.append(grid)
        run = ([img_id] * cols + [brk]) * rows
        run[-1] = end
        prompts.append([1] + run + rng.integers(10, 300, 4 + i).tolist())
    T = max(map(len, prompts)) + pad
    ids = np.zeros((len(prompts), T), np.int64)
    mask = np.zeros((len(prompts), T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    return ids, mask, patches, grids


def test_preprocess_and_vision_arrays_equal_jax(tiny):
    """Sizes whose scaled sides need no rounding (C.R2 aside): patches,
    grids, the packed stream, meshgrid ids, segments, scatter indices."""
    jb, tb = tiny["jb"], tiny["tb"]
    for i, hw in enumerate(IMAGES):
        img = _image(*hw, i)
        want, got = jb.preprocess_image(img), tb.preprocess_image(img)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        assert tuple(got[1]) == tuple(want[1])
        assert tuple(got[2]) == tuple(want[2])
    ids, _, patches, grids = _prompts(tb, IMAGES)
    want = jb.vision_arrays(ids, patches, grids, BUDGET)
    got = tb.vision_arrays(ids, patches, grids, BUDGET)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    n = 16 + 6 + 8
    np.testing.assert_array_equal(got["patch_segments"][:n],
                                  [1] * 16 + [2] * 6 + [3] * 8)
    assert not got["patch_segments"][n:].any()
    np.testing.assert_array_equal(got["patch_pos_ids"][16:22],
                                  [0, 1, 2, 4, 5, 6])
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, 24)


def test_resize_floors_as_transformers_does(tiny):
    """C.R2 at a boundary: 128 x 97 scales by 2 to 64 x 48.5.
    transformers floors to 48 (3 patch columns); JAX rounds up to 49 and
    then to 4 columns.  The port agrees with transformers' processor."""
    from transformers.models.pixtral.image_processing_pixtral import (
        get_resize_output_image_size,
    )

    img = _image(128, 97, 5)
    want_hw = get_resize_output_image_size(np.asarray(img), (EDGE, EDGE),
                                           (PS, PS))
    assert pixtral_resize_hw(128, 97, EDGE, PS) == tuple(want_hw) == (64, 48)
    p, grid, seqlen = tiny["tb"].preprocess_image(img)
    assert grid == seqlen == (4, 3) and p.shape == (12, 3 * PS * PS)
    assert tuple(tiny["jb"].preprocess_image(img)[1]) == (4, 4)
    for h in range(40, 200, 7):
        for w in (33, 65, 97, 150):
            got = pixtral_resize_hw(h, w, EDGE, PS)
            want = get_resize_output_image_size(
                np.zeros((h, w, 3), np.uint8), (EDGE, EDGE), (PS, PS))
            assert got == tuple(want), (h, w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True, "save_acts"])
def test_tower_features_match_jax(tiny, remat):
    """The stream's features on the images' patches (three images, one
    segment each, the padding at 0), f32, against JAX's dense
    block-diagonal tower; the remat modes run forward and backward."""
    import copy

    jb, tb = tiny["jb"], tiny["tb"]
    ids, _, patches, grids = _prompts(tb, IMAGES, seed=1)
    a = tb.vision_arrays(ids, patches, grids, BUDGET)
    n = int((a["patch_segments"] != 0).sum())
    want = np.asarray(jpixtral.tower_apply(
        tiny["jparams"]["vision"], jb.cfg.vision,
        jnp.asarray(a["patch_stream"]), jnp.asarray(a["patch_pos_ids"]),
        jnp.asarray(a["patch_segments"]), JAX_FULL))
    vision = copy.deepcopy(tiny["tparams"]["vision"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(vision)]
    got = pixtral.tower_apply(
        vision, tb.cfg.vision, torch.as_tensor(a["patch_stream"]),
        torch.as_tensor(a["patch_pos_ids"]),
        torch.as_tensor(a["patch_segments"]), FULL_PRECISION, remat=remat,
        attention_fn=default_attention("auto"))
    np.testing.assert_allclose(got.detach().numpy()[:n], want[:n],
                               atol=TOWER_ATOL, rtol=0)
    grads = torch.autograd.grad(got[:n].sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("layout", ["model.language_model",
                                    "language_model.model"])
def test_logits_match_jax(tiny, layout):
    jb, tb, jp = tiny["jb"], tiny["tb"], tiny["jparams"]
    tp = tb.convert_hf(_state(tiny, layout), device="cpu")
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=64, max_new_tokens=6, batch_size=2,
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
    tok = pixtral_tokenizer()
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
    for (ids, patches, grids), (jids, _, _) in zip(enc, jenc):
        assert ids == list(jids)
        assert ids.count(tb.cfg.image_token_id) == patches[0].shape[0]
    want = jgen.engine.generate(jgen.params, jgen._collate(jenc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, tgen._collate(enc))
    for key in ("completion_ids", "completion_mask", "prompt_ids"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 2 and not torch.equal(ids[0], ids[1])


# ---------------------------------------------------------------------------
# PA-SFT
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CUTOFF, CHUNK = 48, 64


@functools.lru_cache(maxsize=None)
def _sft_batches(path):
    """Eight examples (five with an image) packed by the port and batched
    by its VLMBatchBuilder: two batches of two rows."""
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    rng = np.random.default_rng(5)
    img_id = tb.cfg.image_token_id
    examples = []
    for i in range(8):
        prompt = [1] + rng.integers(10, 300, 2 + i % 3).tolist()
        extra = {}
        if i % 3 != 2:
            h, w = IMAGES[1:][i % 2]
            p, grid, (rows, cols) = tb.preprocess_image(_image(h, w, 10 + i))
            prompt += [img_id] * (rows * cols)
            extra = {"extras": {"patches": [p], "grid_thw": [grid]}}
        answer = rng.integers(10, 300, 4 + 2 * i).tolist()
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer, **extra})
    rows = pack_examples(examples, CUTOFF, 0)
    assert len(rows) >= 4
    collate = VLMBatchBuilder(tb, patch_budget=BUDGET)
    return tb, [collate(rows[i:i + 2]) for i in (0, 2)]


def test_sft_steps_match_jax(tiny):
    """Loss and grad norm of 3 steps and the parameters after 1 and 3
    steps, on the port's batches; the port's step runs the recipes' remat
    modes (save_qkv, the tower's save_acts), JAX's none."""
    jb = tiny["jb"]
    tb, batches = _sft_batches(tiny["path"])
    jparams = jb.convert_hf(jax_load(tiny["path"]))
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstate = jax_state(jparams, jo)
    jfn = jax_step(lambda p, b: jb.hidden_fn(p, b, remat=False),
                   jb.head_kernel_fn, jo, jsched, donate=False,
                   chunk_size=CHUNK)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstate = create_train_state(params_from_jax(jparams, device="cpu"), to)
    tfn = make_chunked_sft_step(
        lambda p, b: tb.hidden_fn(p, b, remat="save_qkv",
                                  tower_remat="save_acts"),
        tb.head_kernel_fn, to, tsched, chunk_size=CHUNK)
    for step, i in enumerate([0, 1, 0], start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batches[i].items()})
        tstate, tm = tfn(tstate, batches[i])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {step} grad norm")
        if step in (1, 3):
            _assert_params_close(tstate.params, jstate.params, 2e-6,
                                 f"step {step}")


# ---------------------------------------------------------------------------
# SC-GRPO: the dense update
# ---------------------------------------------------------------------------

GRPO_PROMPT_LEN = 40
GRPO_BUDGET = 2 * 2 * 16           # G = 2: the update holds 4 images


def grpo_examples(tb, seed=0):
    rng = np.random.default_rng(seed)
    img_id = tb.cfg.image_token_id
    examples = []
    for i, (h, w) in enumerate(IMAGES[:2]):
        p, grid, (rows, cols) = tb.preprocess_image(_image(h, w, 20 + i))
        examples.append({
            "prompt_ids": ([1] + [img_id] * (rows * cols)
                           + rng.integers(10, 300, 5 + 3 * i).tolist()),
            "patches": [p], "grid_thw": [grid], "solution": "ab"[i]})
    return examples


@pytest.fixture(scope="module")
def grpo_case(tiny):
    return record_grpo_case(tiny["jb"], tiny["tb"], tiny["jparams"],
                            grpo_examples(tiny["tb"]), GRPO_PROMPT_LEN,
                            GRPO_BUDGET)


def test_jax_update_batch_drops_the_patch_stream(grpo_case):
    """C.R9 reaches Pixtral: the JAX update batch keeps the scatter
    indices but not the patch stream, its meshgrid ids or its segments,
    and nothing raises."""
    keys = grpo_case["jax_update_keys"]
    assert not {"patch_stream", "patch_pos_ids", "patch_segments"} & keys
    assert {"scatter_rows", "scatter_cols", "input_ids"} <= keys


def test_dense_update_matches_jax_fed_the_port_batch(tiny, grpo_case):
    """The dense update (no shared path in either package): the port's
    G-repeated batch carries every rollout's images in one stream (R9
    repaired); one update on it matches JAX's update step fed the same
    batch."""
    check_update(tiny["jb"], tiny["tb"], grpo_case, shared=False,
                 vision_key="patch_stream")
    batch = port_update(tiny["tb"], grpo_case, shared=False)[1]
    np.testing.assert_array_equal(np.unique(batch["patch_segments"]),
                                  [0, 1, 2, 3, 4])
