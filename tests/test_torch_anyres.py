"""The port's anyres tiling and packing plan (iadr1_tpu_torch/vision/
anyres.py) against the JAX package's, exactly, on LLaVA-OneVision-SI's
own settings: 384-pixel tiles of 14-pixel patches (a 27 x 27 grid),
anyres_max_9, and the 36 grid pinpoints of transformers'
``LlavaOnevisionConfig`` (384 to 2304 pixels a side).  Eight image sizes,
among them a square one, both orientations of long thin ones, a tiny one
and two that hold more than nine tiles' worth (the bilinear downscale,
ratio > 1.1).  Random pixels from a numpy seed."""

import numpy as np
import pytest

from iadr1_tpu.vision import anyres as jax_anyres
from iadr1_tpu_torch.vision import anyres
import torch_threads  # noqa: F401  (one intra-op thread)

SIZES = [(448, 448), (336, 560), (100, 900), (2000, 300), (384, 384),
         (1500, 1600), (50, 60), (3000, 3000)]
GRID, PATCH, TILE, MAX_TILES = 27, 14, 384, 9


@pytest.fixture(scope="module")
def pinpoints():
    from transformers import LlavaOnevisionConfig

    pins = [tuple(p) for p in LlavaOnevisionConfig().image_grid_pinpoints]
    assert len(pins) == 36 and pins[0] == (384, 384)
    assert pins[-1] == (2304, 2304)
    return pins


def _image(h, w, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_tiles_patches_and_plan_equal_jax(pinpoints, size):
    h, w = size
    img = _image(h, w, h * 7 + w)
    assert anyres.select_best_resolution(size, pinpoints) == \
        jax_anyres.select_best_resolution(size, pinpoints)
    tiles, grid = anyres.onevision_tiles(img, pinpoints, TILE)
    want_tiles, want_grid = jax_anyres.onevision_tiles(img, pinpoints, TILE)
    assert grid == want_grid
    assert tiles.shape == (1 + grid[0] * grid[1], 3, TILE, TILE)
    np.testing.assert_array_equal(tiles, want_tiles)
    patches = anyres.patchify_tiles(tiles, PATCH)
    assert patches.shape == (tiles.shape[0], GRID * GRID, 3 * PATCH ** 2)
    np.testing.assert_array_equal(patches,
                                  jax_anyres.patchify_tiles(tiles, PATCH))

    plan = anyres.onevision_pack_plan(size, grid, GRID, MAX_TILES)
    want = jax_anyres.onevision_pack_plan(size, grid, GRID, MAX_TILES)
    for key in ("src", "weights", "newline"):
        assert plan[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(plan[key], want[key], err_msg=key)
    assert (plan["length"], plan["out_hw"]) == (want["length"],
                                                want["out_hw"])
    n = anyres.onevision_feature_len(size, grid, GRID, MAX_TILES)
    assert n == plan["length"] == jax_anyres.onevision_feature_len(
        size, grid, GRID, MAX_TILES)

    rng = np.random.default_rng(1)
    feats = rng.standard_normal((tiles.shape[0] * GRID * GRID, 8)).astype(
        np.float32)
    newline = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_array_equal(
        anyres.pack_features_numpy(feats, plan, newline),
        jax_anyres.pack_features_numpy(feats, want, newline))


def test_the_serving_sizes_and_the_downscale(pinpoints):
    """The smoke's two request sizes, and the downscale's reach."""
    for size, tiles, tokens in (((448, 448), 5, 3699),
                                ((336, 560), 3, 1998)):
        grid = anyres.select_best_resolution(size, pinpoints)
        grid = (grid[0] // TILE, grid[1] // TILE)
        assert 1 + grid[0] * grid[1] == tiles
        assert anyres.onevision_feature_len(size, grid, GRID) == tokens
    # 1500 x 1600 takes 4 x 5 tiles, more than 9 tiles' worth: downscaled
    plan = anyres.onevision_pack_plan((1500, 1600), (4, 5), GRID)
    oh, ow = plan["out_hw"]
    assert oh * ow <= 1.1 ** 2 * MAX_TILES * GRID ** 2 < 4 * 5 * GRID ** 2
    assert (plan["weights"][GRID * GRID:].sum(1)[~plan["newline"][
        GRID * GRID:]] == pytest.approx(1.0))
    assert not plan["newline"][:GRID * GRID].any()
    assert plan["newline"].sum() == oh
