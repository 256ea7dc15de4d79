"""The port's Qwen2.5-VL (windowed tower, merger, Qwen2 decoder; serving,
PA-SFT, SC-GRPO) against the JAX package.

A tiny ``Qwen2_5_VLForConditionalGeneration`` is written by
``save_pretrained`` into a temporary directory (with the tiny tokenizer of
tests/helpers.py) and loaded by both packages: 3 tower blocks, block 1
attending over whole images and the others within windows of 56 pixels (2
x 2 merged features, 16 patches), 2 decoder layers, the head tied or not.
Both run FULL_PRECISION (f32 compute); the JAX side runs
``attention="xla"``, the port its K1 twin.  The JAX bundle's tower under
``attention="xla"`` attends unmasked (ROADMAP C.R8, pinned below): the
JAX side's dense attention here builds the mask from the segment ids the
tower passes, as its own ``apply_vision`` does with no attention function.

Tolerances: the host arrays (window permutation, segments, feature order,
scatter indices) exactly equal; tower features atol 2e-5 and logits atol
1e-4 (f32, summation order only); remat modes against no remat atol 1e-7,
rtol 1e-6 (the same arithmetic replayed); greedy tokens identical (the
weights get seeded noise, as tests/test_torch_generate.py says why); SFT
loss, grad norm and learning rate rtol 1e-5 and parameters atol 2e-6 (the
decoder's k bias 2e-5, tests/test_torch_sft.py says why); GRPO metrics
rtol 1e-4 and parameters atol 1e-5 (tests/test_torch_grpo.py).

The JAX SC-GRPO update batch copies only Qwen2-VL's vision keys
(ROADMAP C.R7): its trainer fails on a Qwen2.5-VL image prompt, which one
test pins; the port's update is held to JAX's update step fed the port's
batch, which carries ``full_segs`` and ``window_segs``.
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
from iadr1_tpu.models import qwen25_vl as jq25
from iadr1_tpu.models import registry as jregistry
from iadr1_tpu.models.common import xla_attention as jax_xla_attention
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import _scatter_indices as jax_scatter
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import grpo as jgrpo
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.cli.train_grpo import (
    GRPODataSection,
    make_vlm_prompt_collator,
)
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import qwen25_vl
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import (
    NOT_YET_PORTED,
    _scatter_indices,
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
from iadr1_tpu_torch.vision.mrope import get_mrope_positions

TOWER_ATOL, LOGITS_ATOL = 2e-5, 1e-4
# (height, width) in pixels: merged grids 2 x 2 (one whole window), 4 x 3
# and 3 x 5 (windows cut at the image's edge)
IMAGES = [(56, 56), (112, 84), (84, 140)]
PIXELS = dict(min_pixels=56 * 56, max_pixels=140 * 140)


def build_tiny_qwen25_vl_checkpoint(dirpath: str, tie: bool = True) -> str:
    """A tiny Qwen2.5-VL HF checkpoint (config, safetensors and the tiny
    tokenizer of tests/helpers.py): 3 tower blocks of width 64 (4 heads,
    D = 16), block 1 full attention, windows of 56 pixels; 2 decoder
    layers of width 64, GQA 2, M-RoPE sections (2, 3, 3)."""
    from transformers import (
        Qwen2_5_VLConfig,
        Qwen2_5_VLForConditionalGeneration,
    )

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    cfg = Qwen2_5_VLConfig(
        vision_config=dict(depth=3, hidden_size=64, intermediate_size=96,
                           out_hidden_size=64, num_heads=4, in_channels=3,
                           patch_size=14, spatial_merge_size=2,
                           temporal_patch_size=2, window_size=56,
                           fullatt_block_indexes=[1]),
        text_config=dict(vocab_size=max(tok.vocab_size, 600), hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         rope_theta=10000.0, rms_norm_eps=1e-6,
                         tie_word_embeddings=tie,
                         max_position_embeddings=1024,
                         rope_scaling={"type": "mrope",
                                       "mrope_section": [2, 3, 3]}),
        image_token_id=tok.convert_tokens_to_ids("<|image_pad|>"),
        vision_start_token_id=tok.convert_tokens_to_ids("<|vision_start|>"),
        vision_end_token_id=tok.convert_tokens_to_ids("<|vision_end|>"),
        video_token_id=0, tie_word_embeddings=tie)
    Qwen2_5_VLForConditionalGeneration(cfg).save_pretrained(dirpath)
    return dirpath


def _image(h, w, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


def jax_segment_xla(q, k, v, *, mask=None, q_segments=None,
                    kv_segments=None, causal=True):
    """JAX's dense attention, the mask built from the segment ids where the
    caller passes none: the JAX Qwen2.5-VL tower hands its dispatch only
    segment ids, which JAX's own ``xla_attn`` ignores (ROADMAP C.R8)."""
    if mask is None and q_segments is not None:
        mask = ((q_segments[:, :, None] == kv_segments[:, None, :])
                & (kv_segments[:, None, :] != 0))
        if causal:
            T, S = q.shape[1], k.shape[1]
            mask &= jnp.tril(jnp.ones((T, S), bool))[None]
        mask = mask[:, None]
    return jax_xla_attention(q, k, v, mask)


def jax_qwen25_bundle(hf):
    """The JAX bundle on dense attention, its tower masked (C.R8)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jregistry, "default_attention",
                   lambda kind: jax_segment_xla)
        return jax_bundle(hf, attention="xla", precision=JAX_FULL)


@functools.lru_cache(maxsize=None)
def _checkpoint(root, tie):
    path = os.path.join(root, f"tie_{tie}")
    os.makedirs(path, exist_ok=True)
    build_tiny_qwen25_vl_checkpoint(path, tie)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_qwen25_bundle(hf)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("qwen25_vl"))


@pytest.fixture(scope="module")
def tiny(root):
    return _checkpoint(root, True)


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


def _assert_params_close(tparams, jparams, atol, msg, atol_of=None):
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(
            t.detach().numpy(), np.asarray(want[name]),
            atol=atol_of(name) if atol_of else atol, rtol=0,
            err_msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# registry, parameters, template
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_resolves_the_family(tiny, key):
    hf = {k: v for k, v in tiny["hf"].items() if k != "model_type"}
    if key == "architectures":
        hf["architectures"] = ["Qwen2_5_VLForConditionalGeneration"]
    else:
        hf["model_type"] = "qwen2_5_vl"
    bundle = bundle_from_hf_config(hf)
    assert bundle.family == "qwen2_5_vl" and bundle.multimodal
    assert bundle.template == "qwen2_vl" and bundle.shared_pred_fn
    assert bundle.cfg.vision.fullatt_block_indexes == (1,)
    assert bundle.cfg.vision.window_size == 56
    assert not {"qwen2_5_vl", "Qwen2_5_VLForConditionalGeneration"} & set(
        NOT_YET_PORTED)


# the key layout of transformers' own modules, from the one save_pretrained
# writes
NEW_LAYOUT = [("model.", "model.language_model."), ("visual.", "model.visual.")]


def _state(path, layout):
    state = load_safetensors_path(path)
    assert any(k.startswith("visual.blocks.") for k in state)
    if layout == "model.language_model":
        def rename(key):
            for old, new in NEW_LAYOUT:
                if key.startswith(old):
                    return new + key[len(old):]
            assert key == "lm_head.weight", key
            return key
        state = {rename(k): v for k, v in state.items()}
    return state


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("layout", ["model", "model.language_model"])
def test_convert_hf_equals_jax_convert_then_params_from_jax(root, layout,
                                                            tie):
    t = _checkpoint(root, tie)
    state = _state(t["path"], layout)
    jp = t["jb"].convert_hf({k: v.numpy() for k, v in state.items()})
    tp = t["tb"].convert_hf(state, device="cpu")
    _assert_trees_equal(tp, params_from_jax(jp, device="cpu"))
    assert ("lm_head" in tp["text"]) != tie
    assert tp["vision"]["blocks"]["norm1"].shape == (3, 64)
    assert tp["vision"]["merger"]["ln_q"].shape == (64,)


def test_init_params_has_the_jax_tree(tiny):
    """JAX's init_params tree comes across leaf for leaf through
    params_from_jax, and the port's own init draws the same shapes."""
    jp = tiny["jb"].init_params(jax.random.PRNGKey(3))
    got = dict(_leaves(params_from_jax(jp, device="cpu")))
    want = dict(_leaves(jp))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)
    fresh = dict(_leaves(tiny["tb"].init_params(seed=3, device="cpu")))
    assert fresh.keys() == got.keys()
    for name, t in fresh.items():
        assert t.shape == got[name].shape, name


def test_qwen2_5_vl_template_encodes_as_jax():
    tok = tiny_qwen_tokenizer()
    got, want = get_template("qwen2_5_vl"), jax_template("qwen2_5_vl")
    assert (got.image_token, got.mm_style) == (want.image_token,
                                               want.mm_style)
    messages = [{"role": "user", "content":
                 "<|vision_start|><|image_pad|><|image_pad|><|vision_end|>"
                 "Are there any defects?"}]
    assert got.encode_prompt(tok, messages) == want.encode_prompt(tok,
                                                                  messages)
    pairs = messages + [{"role": "assistant", "content": "No."}]
    assert got.encode_multiturn(tok, pairs) == [
        tuple(p) for p in want.encode_multiturn(tok, pairs)]


# ---------------------------------------------------------------------------
# host arrays
# ---------------------------------------------------------------------------


def _prompts(tb, sizes, seed=0, pad=3):
    """Left-padded prompts, one image each (text ids clear of the specials):
    ids, mask, M-RoPE positions, patches and grids."""
    rng = np.random.default_rng(seed)
    c = tb.cfg
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate(sizes):
        p, grid, n = tb.preprocess_image(_image(h, w, seed + i), **PIXELS)
        patches.append(p)
        grids.append(grid)
        text = rng.integers(10, 300, 5 + 2 * i).tolist()
        prompts.append(text[:2] + [c.vision_start_token_id]
                       + [c.image_token_id] * n + [c.vision_end_token_id]
                       + text[2:])
    T = max(map(len, prompts)) + pad
    ids = np.full((len(sizes), T), 0, np.int64)
    mask = np.zeros((len(sizes), T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    pos, _ = get_mrope_positions(ids, np.asarray(grids), c.image_token_id,
                                 c.vision_start_token_id, attention_mask=mask)
    return ids, mask, pos, patches, grids


@pytest.mark.parametrize("sizes", [IMAGES[:1], IMAGES[1:2], IMAGES[1:],
                                   IMAGES], ids=["one_window", "partial",
                                                 "two_images", "three"])
def test_vision_arrays_equal_jax(tiny, sizes):
    """window_partition, qwen25vl_vision_arrays and the bundle's
    vision_arrays (window-ordered patches, scatter through feature_order)
    exactly equal to JAX's, padded to a budget and at the exact length."""
    jb, tb = tiny["jb"], tiny["tb"]
    ids, _, _, patches, grids = _prompts(tb, sizes)
    grid_thw = np.asarray(grids)
    jcfg, tcfg = jb.cfg.vision, tb.cfg.vision
    for got, want in zip(qwen25_vl.window_partition(grid_thw, tcfg),
                         jq25.window_partition(grid_thw, jcfg)):
        np.testing.assert_array_equal(got, want)
    n = sum(p.shape[0] for p in patches)
    for pad_to in (None, n + 40):
        got = qwen25_vl.qwen25vl_vision_arrays(grid_thw, tcfg, pad_to)
        want = jq25.qwen25vl_vision_arrays(grid_thw, jcfg, pad_to)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for budget in (n, n + 40):
        got = tb.vision_arrays(ids, patches, grids, budget)
        want = jb.vision_arrays(ids, patches, grids, budget)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
    segs = got["window_segs"]
    assert segs.max() >= len(sizes) and (segs[n:] == 0).all()
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, n - 4)


def test_vision_arrays_without_an_image_equal_jax(tiny):
    ids = np.arange(10, 22).reshape(2, 6)
    got = tiny["tb"].vision_arrays(ids, [], [], 32)
    want = tiny["jb"].vision_arrays(ids, [], [], 32)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


def test_scatter_indices_equal_jax():
    """Reading order, a feature order, video tokens matched only when the
    image tokens fall short of the features; the port raises where the
    image tokens outnumber the budget."""
    ids = np.asarray([[1, 7, 7, 8, 7, 2], [7, 8, 8, 3, 7, 7]])
    order = np.asarray([2, 0, 4, 1, 3, 5, 7, 6])
    for kw in (dict(), dict(feature_order=order[:6]),
               dict(video_token_id=8, n_expected=9),
               dict(video_token_id=8, n_expected=6),
               dict(feature_order=order, video_token_id=8, n_expected=9)):
        for got, want in zip(_scatter_indices(ids, 7, 12, **kw),
                             jax_scatter(ids, 7, 12, **kw)):
            np.testing.assert_array_equal(got, want, err_msg=str(kw))
    with pytest.raises(ValueError, match="feature budget"):
        _scatter_indices(ids, 7, 5)


def test_a_video_prompt_names_its_roadmap_item(tiny):
    """A video's frame stack is refused with the way in: Qwen2.5-VL takes
    a video's patches and (t, h, w) grid through its patch stream
    (tests/test_torch_video.py)."""
    builder = VLMBatchBuilder(tiny["tb"], patch_budget=64)
    row = {"input_ids": np.ones(8, np.int64), "labels": np.ones(8, np.int64),
           "segment_ids": np.ones(8, np.int64),
           "extras": [{"video_patches": [np.zeros((4, 4))]}]}
    with pytest.raises(ValueError, match="grid_thw"):
        builder([row])


# ---------------------------------------------------------------------------
# the tower and the VLM
# ---------------------------------------------------------------------------


def _tower_inputs(tb, sizes=IMAGES, extra=24):
    ids, _, _, patches, grids = _prompts(tb, sizes)
    n = sum(p.shape[0] for p in patches)
    arrays = tb.vision_arrays(ids, patches, grids, n + extra)
    return n, arrays


@pytest.mark.parametrize("attention", ["xla", "auto"])
def test_tower_matches_jax(tiny, attention):
    """The merged features of three images (two with windows cut at their
    edges, budget padding after them) against JAX's dense tower."""
    jb, tb = tiny["jb"], tiny["tb"]
    n, a = _tower_inputs(tb)
    want = jq25.apply_vision(
        tiny["jparams"]["vision"], jb.cfg.vision, jnp.asarray(a["patches"]),
        jnp.asarray(a["rot_cos"]), jnp.asarray(a["rot_sin"]),
        jnp.asarray(a["full_segs"]), jnp.asarray(a["window_segs"]),
        precision=JAX_FULL)
    attn = None if attention == "xla" else default_attention("auto")
    with torch.no_grad():
        got = qwen25_vl.apply_vision(
            tiny["tparams"]["vision"], tb.cfg.vision,
            *(torch.as_tensor(a[k]) for k in ("patches", "rot_cos",
                                              "rot_sin", "full_segs",
                                              "window_segs")),
            precision=FULL_PRECISION, attention_fn=attn)
    feats = n // 4                     # padding features attend nothing
    np.testing.assert_allclose(got.numpy()[:feats], np.asarray(want)[:feats],
                               atol=TOWER_ATOL, rtol=0)
    assert np.std(np.asarray(want)[:feats]) > 0.05


def test_jax_dense_tower_ignores_its_segments(tiny):
    """C.R8: the JAX tower hands its attention function segment ids and no
    mask, and JAX's ``xla_attn`` reads only the mask; so under
    ``attention="xla"`` (the JAX default off a TPU) every patch attends
    every other, images, windows and padding alike: its features do not
    change when the segments do, and differ from the masked tower's."""
    from iadr1_tpu.models.attention import default_attention as jax_default

    jb = tiny["jb"]
    _, a = _tower_inputs(tiny["tb"])

    def run(full, window, fn):
        return np.asarray(jq25.apply_vision(
            tiny["jparams"]["vision"], jb.cfg.vision,
            *(jnp.asarray(a[k]) for k in ("patches", "rot_cos", "rot_sin")),
            jnp.asarray(full), jnp.asarray(window), precision=JAX_FULL,
            attention_fn=fn))

    ones = np.ones_like(a["full_segs"])
    unmasked = run(a["full_segs"], a["window_segs"], jax_default("xla"))
    np.testing.assert_array_equal(unmasked, run(ones, ones,
                                                jax_default("xla")))
    masked = run(a["full_segs"], a["window_segs"], None)
    assert np.abs(unmasked - masked).max() > 100 * TOWER_ATOL


def _tower_grads(tb, tparams, a, remat):
    params = copy.deepcopy(tparams["vision"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    feats = qwen25_vl.apply_vision(
        params, tb.cfg.vision,
        *(torch.as_tensor(a[k]) for k in ("patches", "rot_cos", "rot_sin",
                                          "full_segs", "window_segs")),
        precision=FULL_PRECISION, attention_fn=default_attention("auto"),
        remat=remat)
    weights = torch.linspace(-1, 1, feats.numel()).reshape(feats.shape)
    return feats.detach(), torch.autograd.grad((feats * weights).sum(),
                                               leaves)


@pytest.mark.parametrize("mode", [True, "save_acts", "full", "save_qkv"])
def test_tower_remat_modes_give_the_same_output_and_gradients(tiny, mode):
    tb = tiny["tb"]
    _, a = _tower_inputs(tb, IMAGES[1:])
    base_out, base = _tower_grads(tb, tiny["tparams"], a, False)
    out, got = _tower_grads(tb, tiny["tparams"], a, mode)
    torch.testing.assert_close(out, base_out, atol=1e-7, rtol=1e-6)
    for g, w in zip(got, base):
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("layout", ["model", "model.language_model"])
def test_logits_match_jax(root, layout, tie):
    """The full forward (tower, window-order scatter, M-RoPE decoder) of
    two left-padded image prompts, port parameters through
    params_from_jax of JAX's conversion under either key layout."""
    t = _checkpoint(root, tie)
    jb, tb = t["jb"], t["tb"]
    state = _state(t["path"], layout)
    rng = np.random.default_rng(4)
    state = {k: v.numpy() + 0.2 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in state.items()}
    jp = jb.convert_hf(state)
    tp = params_from_jax(jp, device="cpu")
    ids, mask, pos, patches, grids = _prompts(tb, IMAGES[1:], seed=2)
    n = sum(p.shape[0] for p in patches)
    batch = dict(tb.vision_arrays(ids, patches, grids, n + 16),
                 input_ids=ids, position_ids=pos, segment_ids=mask)
    h, _ = jb.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jp, h))
    with torch.no_grad():
        h, _ = tb.apply(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
        got = tb.logits_fn(tp, h).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=LOGITS_ATOL,
                               rtol=0)
    assert np.std(want[valid]) > 0.1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=96, max_new_tokens=10, batch_size=2,
           patch_budget=128, **PIXELS)


def _requests():
    q = "<image>Are there any defects in the image?"
    return [{"messages": [{"role": "user", "content": q}],
             "images": [_image(*IMAGES[1], 0)]},
            {"messages": [{"role": "user", "content": "Describe it. " + q}],
             "images": [_image(*IMAGES[2], 1)]}]


def test_greedy_generation_is_token_identical_to_jax(tiny):
    """Both generators encode, collate (M-RoPE, window-ordered vision
    arrays) and decode the same two image requests."""
    tok = tiny_qwen_tokenizer()
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in jax_load(tiny["path"]).items()}
    jb = tiny["jb"]
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template("qwen2_5_vl"), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(tiny["path"], precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template("qwen2_5_vl"), GeneratorConfig(**GEN),
                        device="cpu")
    reqs = _requests()
    enc = [tgen._encode_request(r["messages"], r["images"]) for r in reqs]
    jenc = [jgen._encode_request(r["messages"], r["images"]) for r in reqs]
    for (ids, patches, grids), (jids, jpatches, jgrids) in zip(enc, jenc):
        assert list(ids) == list(jids)
        np.testing.assert_array_equal(patches[0], jpatches[0])
    got_b, want_b = tgen._collate(enc), jgen._collate(jenc)
    for key in want_b:
        np.testing.assert_array_equal(got_b[key].numpy(),
                                      np.asarray(want_b[key]), err_msg=key)
    want = jgen.engine.generate(jgen.params, want_b, jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, got_b)
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 3 and not torch.equal(ids[0], ids[1])


# ---------------------------------------------------------------------------
# PA-SFT
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CUTOFF, CHUNK = 48, 32


def _sft_param_atol(name: str) -> float:
    return 2e-5 if name == "/text/layers/attn/k/bias" else 2e-6


@functools.lru_cache(maxsize=None)
def _sft_batches(path):
    """Six examples (four with an image) packed by the port and batched by
    its VLMBatchBuilder: two batches of two rows."""
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    c = tb.cfg
    rng = np.random.default_rng(5)
    examples = []
    for i in range(6):
        prompt = [1, 2] + rng.integers(10, 300, 3 + i % 3).tolist()
        extra = {}
        if i % 3 != 2:
            h, w = IMAGES[i % len(IMAGES)]
            p, grid, n = tb.preprocess_image(_image(h, w, 10 + i), **PIXELS)
            prompt += ([c.vision_start_token_id] + [c.image_token_id] * n
                       + [c.vision_end_token_id])
            extra = {"extras": {"patches": [p], "grid_thw": [grid]}}
        answer = rng.integers(10, 300, 8 + 3 * i).tolist()
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer, **extra})
    rows = pack_examples(examples, CUTOFF, 0)
    assert len(rows) >= 4
    builder = VLMBatchBuilder(tb, patch_budget=256)
    return tb, [builder(rows[i:i + 2]) for i in (0, 2)]


def test_sft_steps_match_jax(tiny):
    """Loss, grad norm and learning rate of steps 1-3, and the parameters
    after 1 and after 3 steps, on the port's batches."""
    jb = tiny["jb"]
    tb, batches = _sft_batches(tiny["path"])
    assert all(b["patches"].shape == (256, 1176) for b in batches)
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
            _assert_params_close(tstate.params, jstate.params, None,
                                 f"step {step}", _sft_param_atol)


def test_recipe_remat_gives_the_same_gradients(tiny):
    """The recipe's remat (decoder save_qkv, the tower following it) and
    the tower's save_acts, against no remat, through the bundle's
    hidden_fn and the chunked loss."""
    tb, batches = _sft_batches(tiny["path"])
    b = batch_to_device(batches[0], "cpu")

    def grads(**kw):
        params = copy.deepcopy(tiny["tparams"])
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = chunked_sft_loss(tb.hidden_fn(params, b, **kw),
                                   tb.head_kernel_fn(params), b["labels"],
                                   CHUNK)
        return torch.autograd.grad(loss, leaves)

    base = grads(remat=False)
    for kw in (dict(remat="save_qkv"),
               dict(remat="save_qkv", tower_remat="save_acts")):
        for g, w in zip(grads(**kw), base):
            torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


def test_sft_cli_runs_the_recipe_config(tiny, tmp_path, monkeypatch):
    """cli/train_sft.py on configs/sft_qwen2_5_vl_7b.yaml with its own
    keys, only the paths and sizes overridden: the decoder's save_qkv
    remat, the bf16 CE blocks of 4096 and the window-ordered vision
    arrays reach the step, and the log is finite."""
    from helpers import build_iad_sft_dataset
    from iadr1_tpu_torch.cli.train_sft import main
    from iadr1_tpu_torch.models.registry import ModelBundle
    from iadr1_tpu_torch.train import sft

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
    spy(ModelBundle, "hidden_fn",
        lambda self, params, batch, **kw: seen.update(
            remat=kw, keys=set(batch),
            windows=int(batch["window_segs"].max())))
    data, img_dir = build_iad_sft_dataset(tmp_path)
    out = tmp_path / "out"
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "sft_qwen2_5_vl_7b.yaml")
    assert main(["--config", recipe, "--device", "cpu",
                 f"model.model_name_or_path={tiny['path']}",
                 f"data.dataset={data}", f"data.image_dir={img_dir}",
                 "data.cutoff_len=160", "data.patch_budget=64",
                 "optim.learning_rate=1e-3", "optim.warmup_steps=0",
                 f"train.output_dir={out}", "train.max_steps=2",
                 "train.batch_size=2", "train.logging_steps=1",
                 "train.save_steps=0"]) == 0
    assert seen["chunk"] == 4096 and seen["logits"] == torch.bfloat16
    assert seen["remat"] == {"remat": "save_qkv"}
    assert {"full_segs", "window_segs", "patches"} <= seen["keys"]
    assert seen["windows"] >= 1
    with open(out / "trainer_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["current_steps"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in records)


def test_infer_cli_answers_a_benchmark(tiny, tmp_path):
    from helpers import build_benchmark_json
    from iadr1_tpu_torch.cli.infer import main

    test_data, image_dir = build_benchmark_json(tmp_path, n=4)
    out = tmp_path / "out"
    assert main(["--model-path", tiny["path"], "--test-data", test_data,
                 "--image-dir", image_dir, "--output-dir", str(out),
                 "--batch-size", "2", "--max-prompt-length", "200",
                 "--max-new-tokens", "4", "--patch-budget", "256",
                 "--device", "cpu"]) == 0
    with open(out / "answers_0_shot.json") as f:
        answers = json.load(f)
    assert len(answers) == 4 and all("response" in a for a in answers)


# ---------------------------------------------------------------------------
# SC-GRPO
# ---------------------------------------------------------------------------

EOS, PAD = 3, 2
GRPO_OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
                max_grad_norm=1.0, eps=1e-4)


class Tok:
    """The three attributes the trainer needs; ids decode to letters."""
    eos_token_id, pad_token_id = EOS, PAD

    def batch_decode(self, seqs, skip_special_tokens=True):
        return ["".join(chr(97 + int(t) % 26) for t in s
                        if int(t) not in (EOS, PAD)) for s in seqs]


def vowel_reward(completions, **kwargs):
    return [sum(ch in "aeiou" for ch in c[0]["content"]) / 4.0
            + len(c[0]["content"]) / 16.0 for c in completions]


def _grpo_examples(tb, seed=0):
    """Two prompts, each with one image whose windows are cut at an edge."""
    rng = np.random.default_rng(seed)
    c = tb.cfg
    examples = []
    for i, (h, w) in enumerate(IMAGES[1:]):
        p, grid, n = tb.preprocess_image(_image(h, w, 20 + i), **PIXELS)
        examples.append({
            "prompt_ids": ([1, c.vision_start_token_id]
                           + [c.image_token_id] * n
                           + [c.vision_end_token_id]
                           + rng.integers(10, 300, 5 + 3 * i).tolist()),
            "patches": [p], "grid_thw": [grid], "solution": "ab"[i]})
    return examples


GRPO_KW = dict(num_generations=2, beta=0.04, temperature=1.0, top_k=0,
               top_p=1.0, max_prompt_length=48, max_completion_length=4,
               logp_chunk_size=8, remat=False)
PATCH_BUDGET = 2 * 160          # the G = 1 collation holds 160 patches


def _collators(jb, tb):
    data = dict(patch_budget=PATCH_BUDGET)
    G, P = GRPO_KW["num_generations"], GRPO_KW["max_prompt_length"]
    return (jax_collator(jb, Tok(), None, JaxDataSection(**data), P, G),
            make_vlm_prompt_collator(tb, Tok(), None, GRPODataSection(**data),
                                     P, G))


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


def _jax_trainer(jb, jparams, shared, collate):
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**GRPO_OPT))
    return jgrpo.GRPOTrainer(
        jb, Tok(), jo,
        jgrpo.GRPOConfig(**GRPO_KW, shared_prompt_scoring=shared),
        [vowel_reward], jax_state(jax.tree.map(jnp.copy, jparams), jo),
        jax.tree.map(jnp.copy, jparams), schedule=jsched,
        prompt_collator=collate)


@pytest.fixture(scope="module")
def grpo_case(tiny):
    """The JAX engine's rollout of the two image prompts, recorded where
    the JAX trainer's update fails (C.R7)."""
    jb, tb = tiny["jb"], tiny["tb"]
    jparams = jax.tree.map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               x.shape, x.dtype),
        tiny["jparams"])
    jcollate, tcollate = _collators(jb, tb)
    examples = _grpo_examples(tb)
    jt = _jax_trainer(jb, jparams, True, jcollate)
    jt.engine = RecordingEngine(jt.engine)
    try:
        jt.step(examples)
        error = None
    except KeyError as e:
        error = e
    return dict(jparams=jparams, tcollate=tcollate, jcollate=jcollate,
                examples=examples, rollout=jt.engine.out, error=error)


def test_jax_trainer_drops_the_window_segments(grpo_case):
    """C.R7: the JAX update batch copies Qwen2-VL's vision keys only, so
    the shared-prompt update's ``batch["full_segs"]`` raises."""
    assert isinstance(grpo_case["error"], KeyError)
    assert grpo_case["error"].args == ("full_segs",)


def test_shared_pred_matches_jax(tiny, grpo_case):
    """The shared-prompt scoring's hidden states (tower once per unique
    prompt, completions over the shared prompt K/V), against JAX's."""
    jb, tb = tiny["jb"], tiny["tb"]
    batch = _port_update_batch(tiny, grpo_case)[1]
    G = GRPO_KW["num_generations"]
    jparams = grpo_case["jparams"]
    want = np.asarray(jb.shared_pred_fn(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, G,
        remat=False))
    with torch.no_grad():
        got = tb.shared_pred_fn(params_from_jax(jparams, device="cpu"),
                                batch_to_device(batch, "cpu"), G,
                                remat=False).numpy()
    m = batch["completion_mask"].astype(bool)
    np.testing.assert_allclose(got[m], want[m], atol=LOGITS_ATOL, rtol=0)


def _port_update_batch(tiny, case, shared=True):
    """The port trainer's step on the recorded rollout: (metrics, update
    batch, trainer)."""
    key = ("update", shared)
    if key not in case:
        tb = tiny["tb"]
        to, tsched = topt.make_optimizer(topt.OptimizerConfig(**GRPO_OPT))
        jparams = case["jparams"]
        tt = tgrpo.GRPOTrainer(
            tb, Tok(), to,
            tgrpo.GRPOConfig(**GRPO_KW, shared_prompt_scoring=shared),
            [vowel_reward],
            create_train_state(params_from_jax(jparams, device="cpu"), to),
            params_from_jax(jparams, device="cpu"), schedule=tsched,
            prompt_collator=case["tcollate"], device="cpu")
        assert tt._shared == shared
        tt.engine = ReplayEngine(case["rollout"])
        batches = []
        inner = tt.update_step

        def spy(state, ref, batch):
            batches.append(batch)
            return inner(state, ref, batch)
        tt.update_step = spy
        metrics = tt.step(case["examples"])
        case[key] = (metrics, batches[0], tt)
    return case[key]


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
def test_update_matches_jax_fed_the_port_batch(tiny, grpo_case, shared):
    """C.R7 repaired: the port trainer's update batch of an image prompt
    carries ``full_segs`` and ``window_segs``; one update on it matches
    JAX's update step (dense attention) fed the same batch: every metric,
    and every parameter after it."""
    jb = tiny["jb"]
    metrics, batch, tt = _port_update_batch(tiny, grpo_case, shared)
    assert {"full_segs", "window_segs", "patches", "rot_cos", "rot_sin",
            "scatter_rows", "scatter_cols"} <= set(batch)
    assert "vision_segments" not in batch
    G = GRPO_KW["num_generations"]
    cfg = jgrpo.GRPOConfig(**GRPO_KW, shared_prompt_scoring=shared)
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
    jparams = grpo_case["jparams"]
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


def test_trainer_step_with_its_own_engine(tiny):
    """One port GRPOTrainer.step with image prompts, sampling from its own
    engine: finite metrics, a parameter update, and the update batch
    holds the window segments."""
    tb = tiny["tb"]
    _, tcollate = _collators(tiny["jb"], tb)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**GRPO_OPT))
    params = tb.init_params(seed=1, device="cpu")
    before = copy.deepcopy(params)
    tt = tgrpo.GRPOTrainer(
        tb, Tok(), to, tgrpo.GRPOConfig(**GRPO_KW), [vowel_reward],
        create_train_state(params, to), copy.deepcopy(params),
        schedule=tsched, prompt_collator=tcollate, device="cpu")
    keys = []
    inner = tt.update_step
    tt.update_step = lambda s, r, b: keys.append(set(b)) or inner(s, r, b)
    m = tt.step(_grpo_examples(tb, seed=1))
    assert all(np.isfinite(v) for v in m.values()) and tt.state.step == 1
    assert {"full_segs", "window_segs"} <= keys[0]
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tt.state.params), tree_leaves(before)))


# ---------------------------------------------------------------------------
# the HF export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_export_equals_the_jax_export(root, tie):
    """Key for key and value for value; a tied model (Qwen2.5-VL-3B) writes
    no head."""
    from iadr1_tpu.models.params_export import export_params as jax_export
    from iadr1_tpu_torch.models.params_export import export_params

    t = _checkpoint(root, tie)
    got = export_params(t["tb"], t["tparams"])
    want = jax_export(t["jb"], t["jparams"])
    assert got.keys() == want.keys()
    assert ("lm_head.weight" in got) != tie
    assert "model.visual.merger.ln_q.weight" in got
    assert "model.visual.merger.ln_q.bias" not in got
    assert "model.visual.blocks.2.mlp.gate_proj.bias" in got
    for name, t in got.items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_export_loads_into_hf_transformers(root, tie, tmp_path):
    """The port's export of noised parameters loads into transformers'
    ``Qwen2_5_VLForConditionalGeneration``; its logits on an image prompt
    (HF's own rope index and window order) equal the port's."""
    from transformers import (
        Qwen2_5_VLConfig,
        Qwen2_5_VLForConditionalGeneration,
    )

    from iadr1_tpu_torch.models.params_export import save_pretrained

    t = _checkpoint(root, tie)
    tb = t["tb"]
    gen = torch.Generator().manual_seed(7)
    params = jax.tree.map(
        lambda x: x + 0.2 * torch.randn(x.shape, generator=gen), t["tparams"])
    save_pretrained(tb, params, str(tmp_path), source_dir=t["path"])
    model = Qwen2_5_VLForConditionalGeneration(
        Qwen2_5_VLConfig.from_pretrained(str(tmp_path))).eval()
    missing, unexpected = model.load_state_dict(
        load_safetensors_path(str(tmp_path)), strict=False)
    assert not unexpected, unexpected
    assert all("inv_freq" in k or k == "lm_head.weight" for k in missing), \
        missing
    assert ("lm_head.weight" in missing) == tie
    ids, mask, pos, patches, grids = _prompts(tb, IMAGES[2:], seed=6, pad=0)
    n = patches[0].shape[0]
    with torch.no_grad():
        want = model(input_ids=torch.as_tensor(ids),
                     pixel_values=torch.as_tensor(patches[0]),
                     image_grid_thw=torch.as_tensor(np.asarray(grids))
                     ).logits.numpy()
        batch = dict(tb.vision_arrays(ids, patches, grids, n), input_ids=ids,
                     position_ids=pos)
        h, _ = tb.apply(params, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
        got = tb.logits_fn(params, h).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    assert np.std(want) > 0.1
