"""The port's six mm plugins against the JAX package's, on seeded numpy
images: the pixel arrays (atol 1e-6: both read the same PIL resizes and
normalise in f32, and the pixel values lie within a few units), the
messages with their placeholders expanded, and each family's token
plumbing and masks (PaliGemma's image prefix and token types, Mllama's
aspect ratios and cross-attention masks, MiniCPM-V's image bounds),
exactly."""

import numpy as np
import pytest

from iadr1_tpu.data import mm_plugins as jax_plugins
from iadr1_tpu_torch.data import mm_plugins
import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-6


def _image(w, h, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_inputs(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key])


IMAGES = [_image(300, 200, seed=1), _image(180, 260, seed=2),
          _image(700, 500, seed=3)]
# Video-LLaVA stacks its videos: the same frame count each
FRAMES = [[_image(400, 280, seed=10 + i) for i in range(3)],
          [_image(160, 240, seed=20 + i) for i in range(3)]]
TEXT = [{"role": "user", "content": "<image>Any defect? <image>and <image>"},
        {"role": "assistant", "content": "None."}]
VIDEO_TEXT = [{"role": "user", "content": "<video>then <video>"}]


def test_every_jax_plugin_is_registered():
    assert sorted(mm_plugins.MM_PLUGINS) == sorted(jax_plugins.MM_PLUGINS)
    for name in jax_plugins.MM_PLUGINS:
        got = mm_plugins.get_mm_plugin(name)
        assert type(got).__name__ == type(
            jax_plugins.get_mm_plugin(name)).__name__
    with pytest.raises(KeyError, match="unknown mm plugin"):
        mm_plugins.get_mm_plugin("nope")


@pytest.mark.parametrize("name", ["llava_next_video", "video_llava"])
def test_video_families_match_jax(name):
    got = mm_plugins.get_mm_plugin(name)
    want = jax_plugins.get_mm_plugin(name)
    _same_inputs(got.get_mm_inputs(images=IMAGES, videos=FRAMES),
                 want.get_mm_inputs(images=IMAGES, videos=FRAMES))
    assert (got.process_messages(TEXT + VIDEO_TEXT, IMAGES, FRAMES)
            == want.process_messages(TEXT + VIDEO_TEXT, IMAGES, FRAMES))
    with pytest.raises(ValueError, match="placeholders"):
        got.process_messages(TEXT, IMAGES[:2])


def test_llava_next_video_seqlens_match_jax():
    got = mm_plugins.LlavaNextVideoPlugin(
        vision_feature_select_strategy="full")
    want = jax_plugins.LlavaNextVideoPlugin(
        vision_feature_select_strategy="full")
    for im in IMAGES + [_image(336, 336), _image(250, 700)]:
        assert got.image_seqlen(im) == want.image_seqlen(im)
    assert got.video_seqlen(FRAMES[0]) == want.video_seqlen(FRAMES[0])


def test_paligemma_matches_jax():
    got = mm_plugins.PaliGemmaPlugin(image_size=224)
    want = jax_plugins.PaliGemmaPlugin(image_size=224)
    _same_inputs(got.get_mm_inputs(images=IMAGES),
                 want.get_mm_inputs(images=IMAGES))
    assert (got.process_messages(TEXT, IMAGES)
            == want.process_messages(TEXT, IMAGES))
    ids, labels = [5, 6, 7], [-100, 6, 7]
    assert (got.process_token_ids(ids, labels, IMAGES[:2], 9)
            == want.process_token_ids(ids, labels, IMAGES[:2], 9))
    assert (got.process_token_ids(ids, None, IMAGES[:1], 9)
            == want.process_token_ids(ids, None, IMAGES[:1], 9))
    n = got.image_seqlen
    assert (got.token_type_ids([1, 2], [n + 3, 2 * n + 5])
            == want.token_type_ids([1, 2], [n + 3, 2 * n + 5]))
    with pytest.raises(ValueError, match="images only"):
        got.process_messages(VIDEO_TEXT, videos=FRAMES)


def test_pixtral_matches_jax():
    got, want = mm_plugins.PixtralPlugin(), jax_plugins.PixtralPlugin()
    images = IMAGES + [_image(2000, 500, seed=4), _image(64, 64, seed=5)]
    _same_inputs(got.get_mm_inputs(images=images),
                 want.get_mm_inputs(images=images))
    assert (got.process_messages(TEXT, images[:3])
            == want.process_messages(TEXT, images[:3]))
    for im in images:
        h, w = im.size[1], im.size[0]
        assert got.target_size(h, w) == want.target_size(h, w)
        assert got.expansion(h, w) == want.expansion(h, w)


def test_mllama_matches_jax():
    got = mm_plugins.MllamaPlugin(tile_size=112, max_tiles=4)
    want = jax_plugins.MllamaPlugin(tile_size=112, max_tiles=4)
    batch = [[_image(160, 80, seed=5)],
             [_image(60, 180, seed=6), _image(112, 112, seed=7),
              _image(300, 90, seed=8)]]
    _same_inputs(got.get_mm_inputs(batch), want.get_mm_inputs(batch))
    for h, w in ((80, 160), (180, 60), (112, 112), (90, 300), (500, 20)):
        assert got.optimal_canvas(h, w) == want.optimal_canvas(h, w)
    assert (got.process_messages(TEXT, IMAGES)
            == want.process_messages(TEXT, IMAGES))
    tok = 99
    batch_ids = [[1, tok, 2, 3, tok, 4, 5, 6], [tok, 7, 8], [1, 2]]
    num_tiles = [[4, 2], [3], []]
    for ids in batch_ids:
        assert (got.cross_attention_token_mask(ids, tok)
                == want.cross_attention_token_mask(ids, tok))
    for length in (8, 3):
        np.testing.assert_array_equal(
            got.dense_cross_attention_mask(batch_ids, num_tiles, tok, length),
            want.dense_cross_attention_mask(batch_ids, num_tiles, tok,
                                            length))
    with pytest.raises(ValueError, match="count mismatch"):
        got.process_messages(TEXT, IMAGES[:1])


def test_minicpm_v_matches_jax():
    got, want = mm_plugins.MiniCPMVPlugin(), jax_plugins.MiniCPMVPlugin()
    images = IMAGES + [_image(1400, 500, seed=9)]
    _same_inputs(got.get_mm_inputs(images=images),
                 want.get_mm_inputs(images=images))
    for im in images:
        h, w = im.size[1], im.size[0]
        assert got.best_grid(h, w) == want.best_grid(h, w)
        assert got.image_placeholder(h, w, 3) == want.image_placeholder(
            h, w, 3)
    assert got.n_slices(500, 1400) == want.n_slices(500, 1400) > 0
    assert (got.process_messages(TEXT, images[:3])
            == want.process_messages(TEXT, images[:3]))
    assert (got.process_messages(VIDEO_TEXT, videos=FRAMES)
            == want.process_messages(VIDEO_TEXT, videos=FRAMES))
    ids = [1, 10, 5, 5, 11, 2, 12, 5, 13, 12, 5, 5, 13, 3]
    for kw in ({}, {"slice_start_id": 12, "slice_end_id": 13}):
        np.testing.assert_array_equal(
            got.image_bounds(ids, 10, 11, **kw),
            want.image_bounds(ids, 10, 11, **kw))
    with pytest.raises(ValueError, match="together"):
        got.process_messages(TEXT + VIDEO_TEXT, IMAGES, FRAMES)
