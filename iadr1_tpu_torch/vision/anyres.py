"""AnyRes tiling and feature packing for LLaVA-OneVision and LLaVA-NeXT,
and LLaVA-1.5's center crop, as numpy functions (the port's own copy of
iadr1_tpu/vision/anyres.py).

On the host, per image:
* ``onevision_tiles``: the grid pinpoint that keeps the most of the image
  (``select_best_resolution``), an aspect-keeping bicubic resize, a
  centred pad, its division into square tiles, and the whole image
  squashed into one more tile in front (HF
  ``LlavaOnevisionImageProcessor.get_image_patches``);
* ``onevision_pack_plan``: how the tiles' features become the image's
  token run (HF ``LlavaOnevisionModel.pack_image_features``): the base
  tile, then the tiles' spatial grid with the padding cut off again,
  downscaled bilinearly when it holds more than ``anyres_max_N`` tiles'
  worth, each row followed by the newline vector.  The plan is a [F, 4]
  table of source features and weights and a newline mask, which the
  model applies as one weighted gather, so the packing stays
  differentiable into the tower.
``PIL`` is imported only where an image is resized.
"""

from __future__ import annotations

import math

import numpy as np

# OpenAI-CLIP statistics, HF LlavaOnevisionImageProcessor's defaults.  The
# JAX package normalises with these whatever a checkpoint's
# preprocessor_config.json says (ROADMAP C.R11); the port's bundles pass a
# checkpoint's own statistics where it states them
# (``registry.bundle_from_pretrained``), and these otherwise
DEFAULT_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
DEFAULT_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def select_best_resolution(original_size, possible_resolutions):
    """The (h, w) pinpoint that keeps the most of the image's pixels after
    an aspect-keeping fit, and of those the one that wastes least."""
    oh, ow = original_size
    best, best_kept, best_waste = None, 0, float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        kept = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - kept
        if kept > best_kept or (kept == best_kept and waste < best_waste):
            best, best_kept, best_waste = (h, w), kept, waste
    return best


def _patch_output_size(oh, ow, target):
    """(h, w) of the aspect-keeping resize of an (oh, ow) image into
    ``target``: the side that binds fills it, the other is rounded up."""
    th, tw = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        return min(math.ceil(oh * scale_w), th), tw
    return th, min(math.ceil(ow * scale_h), tw)


def onevision_tiles(image, grid_pinpoints, tile_size: int = 384,
                    mean=DEFAULT_MEAN, std=DEFAULT_STD):
    """PIL image -> (tiles [n, 3, ts, ts] normalised f32, grid (n_h, n_w)).

    tiles[0] is the whole image squashed to one tile; tiles[1:] divide the
    best pinpoint's resize and pad, row by row."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    oh, ow = image.height, image.width
    best = select_best_resolution((oh, ow), grid_pinpoints)
    nh, nw = _patch_output_size(oh, ow, best)
    bicubic = Image.Resampling.BICUBIC
    resized = np.asarray(image.resize((nw, nh), resample=bicubic), np.float32)
    canvas = np.zeros((best[0], best[1], 3), np.float32)
    top, left = (best[0] - nh) // 2, (best[1] - nw) // 2
    canvas[top:top + nh, left:left + nw] = resized / 255.0

    n_h, n_w = best[0] // tile_size, best[1] // tile_size
    base = np.asarray(image.resize((tile_size, tile_size), resample=bicubic),
                      np.float32) / 255.0
    tiles = [base] + [
        canvas[i * tile_size:(i + 1) * tile_size,
               j * tile_size:(j + 1) * tile_size]
        for i in range(n_h) for j in range(n_w)]
    arr = (np.stack(tiles) - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)
    return arr.transpose(0, 3, 1, 2), (n_h, n_w)


def llava_next_tiles(image, grid_pinpoints, tile_size: int = 336,
                     mean=DEFAULT_MEAN, std=DEFAULT_STD):
    """LLaVA-NeXT's anyres tiles: OneVision's tiling at CLIP's 336 (the
    base tile is the whole image squashed, not center-cropped)."""
    return onevision_tiles(image, grid_pinpoints, tile_size, mean, std)


def clip_resize_center_crop(image, size: int = 336, mean=DEFAULT_MEAN,
                            std=DEFAULT_STD) -> np.ndarray:
    """HF CLIPImageProcessor's path, LLaVA-1.5's one tile: a bicubic
    resize of the shortest edge to ``size``, a center crop, normalisation
    -> [3, size, size] f32.  The long side is truncated (``int()``, as HF
    ``get_resize_output_image_size``), not rounded: one pixel more shifts
    the crop window and every feature."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.width, image.height
    if w < h:
        nw, nh = size, int(h * size / w)
    else:
        nh, nw = size, int(w * size / h)
    image = image.resize((nw, nh), resample=Image.Resampling.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


def to_array(image, size_hw=None, resample: str = "bicubic") -> np.ndarray:
    """The RGB image, resized first to ``size_hw`` (height, width) when
    given, as f32 [3, h, w] in [0, 1]."""
    from PIL import Image

    image = image.convert("RGB")
    if size_hw is not None:
        res = {"bicubic": Image.Resampling.BICUBIC,
               "bilinear": Image.Resampling.BILINEAR}[resample]
        image = image.resize((size_hw[1], size_hw[0]), resample=res)
    return (np.asarray(image, np.float32) / 255.0).transpose(2, 0, 1)


def normalize(arr: np.ndarray, mean=DEFAULT_MEAN, std=DEFAULT_STD
              ) -> np.ndarray:
    """(arr - mean) / std per channel of a [3, h, w] array."""
    mean = np.asarray(mean, np.float32)[:, None, None]
    std = np.asarray(std, np.float32)[:, None, None]
    return (arr - mean) / std


def patchify_tiles(tiles: np.ndarray, patch_size: int) -> np.ndarray:
    """[n, C, H, W] -> [n, (H // ps) * (W // ps), C * ps * ps] in the patch
    embedding convolution's order (channel, then row, then column).  Rows
    and columns that do not fill a whole patch are dropped, as the strided
    convolution drops them (384 = 27 * 14 + 6)."""
    n, c, h, w = tiles.shape
    gh, gw = h // patch_size, w // patch_size
    x = tiles[:, :, :gh * patch_size, :gw * patch_size]
    x = x.reshape(n, c, gh, patch_size, gw, patch_size)
    x = x.transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(n, gh * gw, c * patch_size * patch_size).astype(
        np.float32)


def _unpad_bounds(cur_h, cur_w, original_size):
    """(y0, y1, x0, x1): the part of a [cur_h, cur_w] feature grid that
    holds the image and not the centred pad (HF ``unpad_image``)."""
    oh, ow = original_size
    if ow / oh > cur_w / cur_h:
        new_h = int(round(oh * (cur_w / ow), 7))
        pad = (cur_h - new_h) // 2
        return pad, cur_h - pad, 0, cur_w
    new_w = int(round(ow * (cur_h / oh), 7))
    pad = (cur_w - new_w) // 2
    return 0, cur_h, pad, cur_w - pad


def _bilinear_plan_1d(out_size, in_size, offset):
    """torch's bilinear sampling (align_corners=False) along one axis:
    (low index, high index, low weight, high weight) per output, indices
    shifted by ``offset``."""
    coords = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    coords = np.clip(coords, 0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = coords - lo
    return lo + offset, hi + offset, 1.0 - w_hi, w_hi


def _packed_hw(original_size, grid, grid_side, max_tiles):
    """The unpadded bounds, the downscale ratio and the packed (h, w)."""
    n_h, n_w = grid
    y0, y1, x0, x1 = _unpad_bounds(n_h * grid_side, n_w * grid_side,
                                   original_size)
    uh, uw = y1 - y0, x1 - x0
    # max_tiles None: LLaVA-NeXT's packing, which never downscales
    ratio = (math.sqrt(uh * uw / (max_tiles * grid_side ** 2))
             if max_tiles else 0.0)
    if ratio > 1.1:
        return (y0, x0, uh, uw), ratio, (int(uh // ratio), int(uw // ratio))
    return (y0, x0, uh, uw), ratio, (uh, uw)


def onevision_pack_plan(original_size: tuple[int, int],
                        grid: tuple[int, int], grid_side: int,
                        max_tiles: int | None = 9) -> dict:
    """The gather plan of one image's features.

    Features are read from [n_tiles * grid_side ** 2] flattened tile
    features, tile 0 the base.  Returns ``src`` [F, 4] indices and
    ``weights`` [F, 4] (f32), ``newline`` [F] (rows that take the newline
    vector and gather nothing), ``length`` F = grid_side ** 2 + oh *
    (ow + 1) and ``out_hw`` (oh, ow)."""
    n_w = grid[1]
    g = grid_side
    (y0, x0, uh, uw), ratio, (oh, ow) = _packed_hw(original_size, grid, g,
                                                   max_tiles)
    if ratio > 1.1:
        ylo, yhi, wy0, wy1 = _bilinear_plan_1d(oh, uh, y0)
        xlo, xhi, wx0, wx1 = _bilinear_plan_1d(ow, uw, x0)
    else:
        ylo = yhi = np.arange(uh) + y0
        xlo = xhi = np.arange(uw) + x0
        wy0, wy1 = np.ones(oh), np.zeros(oh)
        wx0, wx1 = np.ones(ow), np.zeros(ow)

    def flat_idx(y, x):            # tile 0 is the base, the grid follows
        tile = (y // g) * n_w + (x // g) + 1
        return tile * g * g + (y % g) * g + (x % g)

    F = g * g + oh * (ow + 1)
    src = np.zeros((F, 4), np.int64)
    wts = np.zeros((F, 4), np.float32)
    newline = np.zeros(F, bool)
    src[:g * g, 0] = np.arange(g * g)
    wts[:g * g, 0] = 1.0
    # the spatial rows: entry (yy, xx) at g*g + yy*(ow+1) + xx, its four
    # corners in the order (y lo, x lo), (y lo, x hi), (y hi, x lo),
    # (y hi, x hi); a newline closes each row
    rows = g * g + np.arange(oh)[:, None] * (ow + 1)
    at = (rows + np.arange(ow)[None, :]).reshape(-1)
    for k, (ys, wy, xs, wx) in enumerate(
            ((ylo, wy0, xlo, wx0), (ylo, wy0, xhi, wx1),
             (yhi, wy1, xlo, wx0), (yhi, wy1, xhi, wx1))):
        src[at, k] = flat_idx(ys[:, None], xs[None, :]).reshape(-1)
        wts[at, k] = (wy[:, None] * wx[None, :]).reshape(-1)
    newline[rows[:, 0] + ow] = True
    return {"src": src, "weights": wts, "newline": newline, "length": F,
            "out_hw": (oh, ow)}


def onevision_feature_len(original_size, grid, grid_side,
                          max_tiles=9) -> int:
    """The packed feature count F, without the plan."""
    _, _, (oh, ow) = _packed_hw(original_size, grid, grid_side, max_tiles)
    return grid_side ** 2 + oh * (ow + 1)


def pack_features_numpy(features: np.ndarray, plan: dict,
                        newline: np.ndarray) -> np.ndarray:
    """The plan applied in numpy (the tests' reference): features [n_tiles
    * g ** 2, E], newline [E] -> [F, E]."""
    gathered = (features[plan["src"]] * plan["weights"][..., None]).sum(1)
    return np.where(plan["newline"][:, None], newline[None, :], gathered)
