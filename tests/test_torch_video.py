"""The port's video inputs against the JAX package (and, where the JAX
package departs from the published models, against transformers):
frame sampling, Qwen2-VL's temporal patches, the video token runs, M-RoPE
video positions, the Qwen towers over a video, and LLaVA-NeXT-Video and
Video-LLaVA through their collators, forward and greedy rollouts.

The LLaVA video families use tests/test_video_vlm_parity.py's tiny
configs (CLIP tiles of 56 px, 32 wide with 4 heads, 3 layers of which 2
run; a 2-layer decoder, 4 heads over 2), random HF weights with seeded
noise, converted by both packages from the same state; both run
FULL_PRECISION, JAX with ``attention="xla"``, the port its K1 twin, whose
tower masks the zero frames that pad the frame stream.

Tolerances: host arrays, positions and token ids exactly equal (the frame
patches of the shared numpy code too); logits atol 1e-4 at the valid
positions; the Qwen2-VL tower against transformers' atol 1e-4.

Four JAX hazards, pinned here and not copied:
- C.R6 reaches videos: the JAX expansion writes the video token itself, so
  the LLaVA families' ``<video>`` reads as another placeholder and raises.
- C.R14: JAX steps a Qwen2.5-VL video's temporal position by 1, where
  transformers steps by ``second_per_grid_t * tokens_per_second``.
- C.R15: the JAX collators give ``get_mrope_positions`` no video token,
  so a Qwen video span gets text positions.
- C.R16: JAX gives a Qwen video one tower segment over all its frames,
  where transformers attends within each temporal patch.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.cli.train_grpo import GRPODataSection as JaxDataSection
from iadr1_tpu.cli.train_grpo import make_vlm_prompt_collator as jax_collator
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data import mm as jmm
from iadr1_tpu.data.collator import VLMBatchBuilder as JaxBuilder
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.models import llava as jllava
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train.rollout import RolloutEngine as JaxEngine
from iadr1_tpu.train.rollout import SamplingConfig as JaxSampling
from iadr1_tpu.vision import mrope as jmrope
from iadr1_tpu.vision import preprocess as jvp
from iadr1_tpu_torch.cli.train_grpo import (
    GRPODataSection,
    make_vlm_prompt_collator,
)
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data import mm
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.models import llava, qwen2_vl
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.registry import (
    NOT_YET_PORTED,
    bundle_from_hf_config,
)
from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
from iadr1_tpu_torch.vision import mrope, preprocess as vp

TILE = 56
G = TILE // 14                         # 4 x 4 patches a frame
TEXT = dict(vocab_size=160, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False)
CLIP_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                   num_attention_heads=4, image_size=TILE, patch_size=14,
                   hidden_act="quick_gelu", layer_norm_eps=1e-5)
PINPOINTS = [[56, 112], [112, 56], [112, 112]]
IMG_ID, VID_ID, PAD, EOS = 7, 8, 0, 1
FAMILIES = ["llava_next_video", "video_llava"]
# the Qwen families' ids in the tiny configs
VS, VE, Q_IMG, Q_VID = 5, 6, 7, 8


def _image(w, h, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


def _frames(n, seed=0, w=80, h=64):
    return [_image(w, h, seed=seed + i) for i in range(n)]


# ---------------------------------------------------------------------------
# host side: sampling, Qwen temporal patches, token runs
# ---------------------------------------------------------------------------


def test_frame_sampling_and_qwen_video_preprocess_equal_jax():
    for total in (1, 2, 7, 30, 100, 1000):
        for dur in (0.5, 3.0, 5.0, 100.0):
            for fps, maxlen in ((2.0, 64), (1.0, 8)):
                np.testing.assert_array_equal(
                    vp.sample_frame_indices(total, dur, fps, maxlen),
                    jvp.sample_frame_indices(total, dur, fps, maxlen))
    for n in (2, 3, 8):                       # an odd count repeats one
        frames = _frames(n, seed=n, w=84, h=56)
        kw = dict(min_pixels=28 * 28, max_pixels=56 * 84)
        got, ggrid = vp.qwen2vl_preprocess_video(frames, **kw)
        want, wgrid = jvp.qwen2vl_preprocess_video(frames, **kw)
        assert ggrid == wgrid and ggrid[0] == (n + 1) // 2
        np.testing.assert_array_equal(got, want)


def test_video_token_runs_equal_jax():
    """The qwen2_vl run equals JAX's; the LLaVA families' ``<video>`` run,
    which JAX's expansion reads as further placeholders (C.R6 for
    videos), counts once here."""
    msgs = [{"role": "user", "content": "<video> any motion? <video>"}]
    got = mm.expand_video_tokens(msgs, [3, 2], "qwen2_vl")
    assert got == jmm.expand_video_tokens(msgs, [3, 2], "qwen2_vl")
    assert got[0]["content"].count("<|video_pad|>") == 5
    got = mm.expand_video_tokens(msgs, [3, 2], "llava", "<video>")
    assert got[0]["content"] == "<video>" * 3 + " any motion? " + \
        "<video>" * 2
    with pytest.raises(ValueError, match="placeholders"):
        jmm.expand_video_tokens(msgs, [3, 2], "llava", "<video>")
    with pytest.raises(ValueError, match="3 videos"):
        mm.expand_video_tokens(msgs, [3, 2, 1], "qwen2_vl")
    assert mm.VIDEO_PLACEHOLDER == jmm.VIDEO_PLACEHOLDER


@pytest.mark.parametrize("name", ["llava_next_video",
                                  "llava_next_video_mistral",
                                  "llava_next_video_yi", "video_llava"])
def test_video_templates_encode_as_jax(name):
    from helpers import tiny_qwen_tokenizer

    tok = copy.deepcopy(tiny_qwen_tokenizer())
    tok.bos_token = "<|im_start|>"
    messages = mm.expand_image_tokens(
        [{"role": "user", "content": "<image>Are there any defects?"}],
        [5], "llava", "<image>")
    got, want = get_template(name), jax_template(name)
    assert (got.image_token, got.mm_style) == (want.image_token,
                                               want.mm_style)
    for system in (None, "Answer in one word."):
        assert got.encode_prompt(tok, messages, system) == \
            want.encode_prompt(tok, messages, system)
        pairs = messages + [{"role": "assistant", "content": "No."}]
        assert got.encode_multiturn(tok, pairs, system) == [
            tuple(p) for p in want.encode_multiturn(tok, pairs, system)]


# ---------------------------------------------------------------------------
# M-RoPE video positions
# ---------------------------------------------------------------------------


def _qwen_rows():
    """Two left-padded rows: an image then a video (t = 3), and a video
    (t = 2) alone; the (t, h, w) grids in reading order."""
    grids = [(1, 4, 6), (3, 4, 4), (2, 2, 4)]
    n = [t * h * w // 4 for t, h, w in grids]
    rows = [[9, 10, VS] + [Q_IMG] * n[0] + [VE, 11, VS] + [Q_VID] * n[1]
            + [VE, 12, 13], [14, VS] + [Q_VID] * n[2] + [VE, 15]]
    T = max(map(len, rows)) + 2
    ids = np.zeros((2, T), np.int64)
    mask = np.zeros((2, T), np.int64)
    for b, r in enumerate(rows):
        ids[b, T - len(r):], mask[b, T - len(r):] = r, 1
    return ids, mask, grids


def _hf_rope_index(model_cls, config_cls, ids, mask, grids, **kw):
    """transformers' get_rope_index on the rows (image and video grids
    apart, as its processor gives them), tokens_per_second 2 as in
    Qwen2.5-VL's published configs (the class default is 4)."""
    import types

    grid_t = torch.as_tensor(grids)
    cfg = config_cls(vision_config=dict(spatial_merge_size=2,
                                        tokens_per_second=2),
                     image_token_id=Q_IMG, video_token_id=Q_VID,
                     vision_start_token_id=VS)
    pos, deltas = model_cls.get_rope_index(
        types.SimpleNamespace(config=cfg), torch.as_tensor(ids),
        image_grid_thw=grid_t[:1], video_grid_thw=grid_t[1:],
        attention_mask=torch.as_tensor(mask), **kw)
    return pos.numpy(), deltas.numpy()[:, 0]


def test_qwen2_vl_video_positions_equal_jax_and_transformers():
    from transformers import Qwen2VLConfig
    from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VLModel

    ids, mask, grids = _qwen_rows()
    got = mrope.get_mrope_positions(ids, np.asarray(grids), Q_IMG, VS,
                                    attention_mask=mask,
                                    video_token_id=Q_VID)
    want = jmrope.get_mrope_positions(ids, np.asarray(grids), Q_IMG, VS,
                                      attention_mask=mask,
                                      video_token_id=Q_VID)
    hf = _hf_rope_index(Qwen2VLModel, Qwen2VLConfig, ids, mask, grids)
    for g, w, h in zip(got, want, hf):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("spg", [None, [1.0, 2.0], [0.5, 1.0]],
                         ids=["default", "fps 2 and 1", "fps 4 and 2"])
def test_qwen25_vl_video_positions_follow_transformers(spg):
    """C.R14: a Qwen2.5-VL video's temporal index steps by
    second_per_grid_t * tokens_per_second (2), as transformers'
    get_rope_index computes it; the JAX package steps by 1."""
    from transformers import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VLModel,
    )

    ids, mask, grids = _qwen_rows()
    got = mrope.get_mrope_positions(ids, np.asarray(grids), Q_IMG, VS,
                                    attention_mask=mask, video_token_id=Q_VID,
                                    second_per_grid_ts=spg,
                                    tokens_per_second=2)
    kw = {} if spg is None else {"second_per_grid_ts": torch.as_tensor(spg)}
    hf = _hf_rope_index(Qwen2_5_VLModel, Qwen2_5_VLConfig, ids, mask, grids,
                        **kw)
    for g, h in zip(got, hf):
        np.testing.assert_array_equal(g, h)
    jax_pos, _ = jmrope.get_mrope_positions(
        ids, np.asarray(grids), Q_IMG, VS, attention_mask=mask,
        video_token_id=Q_VID)
    assert not np.array_equal(jax_pos, hf[0])
    # the collators read the step from the bundle's config
    cfg = bundle_from_hf_config(_qwen_hf("Qwen2_5_VLForConditionalGeneration")
                                ).cfg
    assert cfg.vision.tokens_per_second == 2
    pos, _ = mrope.bundle_mrope_positions(cfg, ids, grids,
                                          attention_mask=mask,
                                          second_per_grid_ts=spg)
    np.testing.assert_array_equal(pos, hf[0])


def _qwen_hf(arch):
    vision = dict(depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                  patch_size=14, spatial_merge_size=2, temporal_patch_size=2)
    if arch.startswith("Qwen2_5"):
        vision = dict(depth=2, hidden_size=32, intermediate_size=48,
                      out_hidden_size=64, num_heads=4, patch_size=14,
                      spatial_merge_size=2, temporal_patch_size=2,
                      window_size=56, fullatt_block_indexes=[1])
    return dict(architectures=[arch], vision_config=vision,
                text_config=dict(vocab_size=160, hidden_size=64,
                                 intermediate_size=96, num_hidden_layers=2,
                                 num_attention_heads=4,
                                 num_key_value_heads=2, rope_theta=1e4,
                                 tie_word_embeddings=True,
                                 rope_scaling={"type": "mrope",
                                               "mrope_section": [4, 2, 2]}),
                image_token_id=Q_IMG, video_token_id=Q_VID,
                vision_start_token_id=VS, vision_end_token_id=VE)


# ---------------------------------------------------------------------------
# the Qwen towers and collators over a video
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _qwen2_vl_hf():
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    hf = _qwen_hf("Qwen2VLForConditionalGeneration")
    torch.manual_seed(0)
    model = Qwen2VLForConditionalGeneration(Qwen2VLConfig(
        vision_config=hf["vision_config"],
        text_config=dict(hf["text_config"], model_type="qwen2"),
        **{k: hf[k] for k in ("image_token_id", "video_token_id",
                              "vision_start_token_id",
                              "vision_end_token_id")})).eval()
    return hf, model


def test_qwen2_vl_tower_attends_within_each_temporal_patch():
    """C.R16: the port's segments give each temporal patch of a video its
    own segment, as transformers' cu_seqlens do, and its tower's features
    equal transformers' over a video of 4 frames (t = 2) beside an image;
    JAX gives the whole video one segment."""
    hf, model = _qwen2_vl_hf()
    frames = _frames(4, seed=3, w=84, h=56)
    vflat, vgrid = vp.qwen2vl_preprocess_video(frames, min_pixels=28 * 28,
                                               max_pixels=56 * 84)
    iflat, igrid = vp.qwen2vl_preprocess(_image(56, 56, 9),
                                         min_pixels=28 * 28,
                                         max_pixels=56 * 56)
    grids = [igrid, vgrid]
    segs = vp.vision_segment_ids(grids)
    hw = vgrid[1] * vgrid[2]
    np.testing.assert_array_equal(
        segs, np.repeat([1, 2, 3], [igrid[1] * igrid[2], hw, hw]))
    np.testing.assert_array_equal(jvp.vision_segment_ids(grids), np.repeat(
        [1, 2], [igrid[1] * igrid[2], 2 * hw]))
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    tp = tb.convert_hf(model.state_dict(), device="cpu")
    flat = np.concatenate([iflat, vflat])
    cos, sin = vp.vision_rotary_tables(np.asarray(grids), tb.cfg.vision.head_dim)
    with torch.no_grad():
        got = qwen2_vl.apply_vision(
            tp["vision"], tb.cfg.vision, torch.as_tensor(flat),
            torch.as_tensor(cos), torch.as_tensor(sin), torch.as_tensor(segs),
            precision=FULL_PRECISION,
            attention_fn=default_attention("auto")).numpy()
        want = model.model.visual(torch.as_tensor(flat),
                                  grid_thw=torch.as_tensor(grids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _qwen_video_row(tb):
    """A packed row of two segments: a video (4 frames, t = 2) with text,
    and an image with text; the extras as a caller gives them."""
    frames = _frames(4, seed=5, w=84, h=56)
    vflat, vgrid = vp.qwen2vl_preprocess_video(frames, min_pixels=28 * 28,
                                               max_pixels=56 * 84)
    iflat, igrid = vp.qwen2vl_preprocess(_image(56, 56, 9),
                                         min_pixels=28 * 28,
                                         max_pixels=56 * 56)
    nv, ni = int(np.prod(vgrid)) // 4, int(np.prod(igrid)) // 4
    seg1 = [9, VS] + [Q_VID] * nv + [VE, 10, 11, 12]
    seg2 = [13, VS] + [Q_IMG] * ni + [VE, 14, 15]
    T = len(seg1) + len(seg2) + 3
    ids = np.zeros(T, np.int64)
    ids[:len(seg1) + len(seg2)] = seg1 + seg2
    segs = np.zeros(T, np.int64)
    segs[:len(seg1)], segs[len(seg1):len(seg1) + len(seg2)] = 1, 2
    pos = np.zeros(T, np.int64)
    row = {"input_ids": ids, "labels": ids.copy(), "segment_ids": segs,
           "position_ids": pos,
           "extras": [{"patches": [vflat], "grid_thw": [vgrid],
                       "second_per_grid_ts": [1.0]},
                      {"patches": [iflat], "grid_thw": [igrid]}]}
    return row, len(seg1)


@pytest.mark.parametrize("arch", ["Qwen2VLForConditionalGeneration",
                                  "Qwen2_5_VLForConditionalGeneration"])
def test_qwen_video_batch(arch):
    """A Qwen row with a video through VLMBatchBuilder: the video rides the
    patch stream and its tokens take the scattered features, as in JAX;
    the positions place the video span (C.R15: JAX's collator gives it
    text positions), per temporal patch on Qwen2.5-VL (C.R14); the
    forward is finite."""
    hf = _qwen_hf(arch)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    row, n1 = _qwen_video_row(tb)
    got = VLMBatchBuilder(tb, patch_budget=128)([row])
    jrow = dict(row, extras=[{k: v for k, v in e.items()
                              if k != "second_per_grid_ts"}
                             for e in row["extras"]])
    want = JaxBuilder(jb, patch_budget=128)([jrow])
    differ = {"position_ids", "vision_segments", "full_segs"}
    for key in set(want) - differ:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    ids = row["input_ids"][None]
    vid = ids[0] == Q_VID
    assert (got["scatter_rows"][:vid.sum()] == 0).all()
    tps = 2 if arch.startswith("Qwen2_5") else None
    span1, _ = mrope.get_mrope_positions(
        ids[:, :n1], np.asarray([row["extras"][0]["grid_thw"][0]]), Q_IMG,
        VS, video_token_id=Q_VID, second_per_grid_ts=[1.0],
        tokens_per_second=tps)
    np.testing.assert_array_equal(got["position_ids"][:, 0, :n1],
                                  span1[:, 0])
    t_vid = got["position_ids"][0, 0, :n1][vid[:n1]]
    assert t_vid.max() - t_vid.min() == (2 if tps else 1)
    jt = np.asarray(want["position_ids"])[0, 0, :n1][vid[:n1]]
    assert (np.diff(jt) == 1).all()            # C.R15: text positions
    params = tb.init_params(seed=0, device="cpu")
    with torch.no_grad():
        h = tb.hidden_fn(params, {k: torch.as_tensor(v)
                                  for k, v in got.items()}, remat=False)
    assert torch.isfinite(h).all()


# ---------------------------------------------------------------------------
# LLaVA-NeXT-Video and Video-LLaVA
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _llava_case(family):
    """HF config dict, both bundles, and both packages' parameters from
    the same noised HF state."""
    torch.manual_seed(11)
    text_cfg = dict(**TEXT, model_type="llama", attention_bias=False,
                    attention_dropout=0.0)
    if family == "llava_next_video":
        from transformers import (
            LlavaNextVideoConfig,
            LlavaNextVideoForConditionalGeneration,
        )

        model = LlavaNextVideoForConditionalGeneration(LlavaNextVideoConfig(
            vision_config=dict(CLIP_VISION), text_config=text_cfg,
            image_token_index=IMG_ID, video_token_index=VID_ID,
            vision_feature_layer=-2, vision_feature_select_strategy="default",
            spatial_pool_mode="average", spatial_pool_stride=2,
            image_grid_pinpoints=PINPOINTS))
        arch = "LlavaNextVideoForConditionalGeneration"
        extra = dict(spatial_pool_mode="average", spatial_pool_stride=2,
                     image_grid_pinpoints=PINPOINTS)
    else:
        from transformers import (
            VideoLlavaConfig,
            VideoLlavaForConditionalGeneration,
        )

        model = VideoLlavaForConditionalGeneration(VideoLlavaConfig(
            vision_config=dict(CLIP_VISION), text_config=text_cfg,
            image_token_index=IMG_ID, video_token_index=VID_ID,
            vision_feature_layer=-2,
            vision_feature_select_strategy="default"))
        arch = "VideoLlavaForConditionalGeneration"
        extra = {}
    hf = dict(architectures=[arch], text_config=TEXT,
              vision_config=CLIP_VISION, image_token_index=IMG_ID,
              video_token_index=VID_ID, vision_feature_layer=-2,
              vision_feature_select_strategy="default", **extra)
    rng = np.random.default_rng(0)
    state = {k: (v.detach().numpy() + 0.2 * rng.standard_normal(
        v.shape).astype(np.float32)) for k, v in model.state_dict().items()}
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(hf=hf, jb=jb, tb=tb, jparams=jb.convert_hf(state),
                tparams=tb.convert_hf(state, device="cpu"))


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return _llava_case(request.param)


def test_families_resolve(case):
    tb = case["tb"]
    assert tb.family == tb.template and tb.family in FAMILIES
    assert tb.cfg.video_token_id == VID_ID
    assert not {tb.family, case["hf"]["architectures"][0]} & set(
        NOT_YET_PORTED)
    assert set(case["tparams"]) == set(case["jparams"])


def test_pool_video_features_is_exactly_jax():
    """Exactly equal at the published grid (24 x 24 features a frame,
    stride 2, several draws); at other grids XLA may sum a window in
    another order, so within f32 rounding there."""
    rng = np.random.default_rng(0)
    for g, stride in ((24, 2), (24, 2), (24, 2), (5, 3), (5, 2)):
        x = rng.standard_normal((3, g * g, 8)).astype(np.float32)
        got = llava.pool_video_features(torch.as_tensor(x), stride).numpy()
        want = np.asarray(jllava.pool_video_features(jnp.asarray(x), stride))
        assert got.shape == want.shape == (3, (g // stride) ** 2, 8)
        if g == 24:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _video_prompts(tb, n_frames=(3, 2), image=False, seed=21):
    """Prompts of one video each (the first also an image when asked):
    frame patches, the image's patches and grid, the prompt ids."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, n in enumerate(n_frames):
        vpatches, meta, vseqlen = tb.preprocess_video(
            _frames(n, seed=5 + 10 * i))
        assert meta == ("video", n) and vpatches.shape[0] == n
        text = rng.integers(10, TEXT["vocab_size"], 4 + 3 * i).tolist()
        ex = {"prompt_ids": text[:2] + [VID_ID] * vseqlen + text[2:],
              "video_patches": [vpatches], "solution": "a"}
        if image and i == 0:
            p, grid, iseqlen = tb.preprocess_image(_image(90, 70, seed=9))
            ex["prompt_ids"] = [IMG_ID] * iseqlen + ex["prompt_ids"]
            ex.update(patches=[p], grid_thw=[grid])
        examples.append(ex)
    return examples


BUDGET = 8 * G * G                   # 8 tiles (frames) of 16 patches


def test_video_preprocess_and_arrays_equal_jax(case):
    jb, tb = case["jb"], case["tb"]
    frames = _frames(3, seed=1)
    got, want = tb.preprocess_video(frames), jb.preprocess_video(frames)
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    per = got[2] // 3
    assert per == ((G // 2) ** 2 if tb.family == "llava_next_video"
                   else G * G + 1)
    exs = _video_prompts(tb, image=True)
    P = max(len(e["prompt_ids"]) for e in exs)
    ids = np.zeros((2, P), np.int64)
    for b, e in enumerate(exs):
        ids[b, P - len(e["prompt_ids"]):] = e["prompt_ids"]
    videos = [v for e in exs for v in e["video_patches"]]
    args = (ids, exs[0]["patches"], exs[0]["grid_thw"], BUDGET)
    g, w = (tb.vision_arrays(*args, videos=videos),
            jb.vision_arrays(*args, videos=videos))
    assert set(g) == set(w) | {"tile_segments", "video_tile_segments"}
    for key in w:
        np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)
    np.testing.assert_array_equal(g["video_tile_segments"],
                                  (np.arange(8) < 5).astype(np.int32))
    with pytest.raises(ValueError, match="video tokens"):
        tb.vision_arrays(*args, videos=videos[:1])
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids[1:], [], [], 4 * G * G, videos=videos[1:] * 3)


def _batch(tb, exs, P):
    ids = np.full((len(exs), P), PAD, np.int64)
    mask = np.zeros((len(exs), P), np.int64)
    patches, grids, videos = [], [], []
    for b, e in enumerate(exs):
        ids[b, P - len(e["prompt_ids"]):] = e["prompt_ids"]
        mask[b, P - len(e["prompt_ids"]):] = 1
        patches += e.get("patches", [])
        grids += e.get("grid_thw", [])
        videos += e["video_patches"]
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET, videos=videos)
    return dict(arrays, input_ids=ids, segment_ids=mask,
                position_ids=np.clip(mask.cumsum(1) - 1, 0, None))


def test_video_logits_match_jax(case):
    """A video row and, for both families, a row with an image before its
    video (Video-LLaVA: the image tower and the video tower in one
    prompt): the logits at the valid positions."""
    jb, tb = case["jb"], case["tb"]
    exs = _video_prompts(tb, image=True)
    batch = _batch(tb, exs, max(len(e["prompt_ids"]) for e in exs) + 2)
    h, _ = jb.apply(case["jparams"], {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(case["jparams"], h))
    with torch.no_grad():
        h, _ = tb.apply(case["tparams"], {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
        got = tb.logits_fn(case["tparams"], h).numpy()
    valid = batch["segment_ids"].astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4, rtol=0)


class _Tok:
    eos_token_id, pad_token_id = EOS, PAD


def test_greedy_rollout_through_the_prompt_collator_matches_jax(case):
    """Two video prompts (the first with an image too) through each
    package's GRPO prompt collator (G = 1) and its rollout engine, greedy,
    f32: every collated array and the tokens equal."""
    jb, tb = case["jb"], case["tb"]
    exs = _video_prompts(tb, image=True, seed=4)
    P = max(len(e["prompt_ids"]) for e in exs) + 2
    jcol = jax_collator(jb, _Tok(), None, JaxDataSection(patch_budget=BUDGET),
                        P, 1)(exs, 1)
    tcol = make_vlm_prompt_collator(tb, _Tok(), None,
                                    GRPODataSection(patch_budget=BUDGET), P,
                                    1)(exs, 1)
    assert set(tcol) == set(jcol) | {"tile_segments", "video_tile_segments"}
    for key in jcol:
        np.testing.assert_array_equal(tcol[key], np.asarray(jcol[key]),
                                      err_msg=key)
    N = 6
    kw = dict(max_new_tokens=N, temperature=0.0, eos_token_id=EOS,
              pad_token_id=PAD)
    want = JaxEngine(jb, JaxSampling(**kw), max_len=P + N,
                     cache_dtype=jnp.float32).generate(
        case["jparams"], jcol, jax.random.PRNGKey(0))
    got = RolloutEngine(tb, SamplingConfig(**kw), max_len=P + N,
                        cache_dtype=torch.float32, device="cpu").generate(
        case["tparams"], {k: torch.as_tensor(v) for k, v in tcol.items()})
    for key in ("completion_ids", "completion_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert len(set(got["completion_ids"][0].tolist())) > 1


def test_vlm_batch_collation_takes_videos_as_jax(case):
    """VLMBatchBuilder with a video as PIL frames (``videos``) in one row
    and as a frame stack (``video_patches``) in the other: every array
    equal to JAX's VLMBatchBuilder's."""
    jb, tb = case["jb"], case["tb"]
    frames = _frames(2, seed=40)
    stack = tb.preprocess_video(_frames(3, seed=50))
    rows = []
    for i, extra in enumerate(({"videos": [frames]},
                               {"video_patches": [stack[0]]})):
        n = tb.preprocess_video(frames)[2] if i == 0 else stack[2]
        ids = np.zeros(n + 8, np.int64)
        ids[2:2 + n] = VID_ID
        ids[:2], ids[2 + n:2 + n + 3] = [11, 12], [13, 14, 15]
        segs = (np.arange(n + 8) < n + 5).astype(np.int64)
        rows.append({"input_ids": ids, "labels": ids.copy(),
                     "segment_ids": segs,
                     "position_ids": np.arange(n + 8) * segs,
                     "extras": [extra]})
    T = max(len(r["input_ids"]) for r in rows)
    for r in rows:
        for k in ("input_ids", "labels", "segment_ids", "position_ids"):
            r[k] = np.pad(r[k], (0, T - len(r[k])))
    got = VLMBatchBuilder(tb, patch_budget=BUDGET)(rows)
    want = JaxBuilder(jb, patch_budget=BUDGET)(rows)
    assert set(got) == set(want) | {"tile_segments", "video_tile_segments"}
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    assert int(got["video_tile_segments"].sum()) == 5
