"""Qwen2-VL image preprocessing as numpy functions (the port's own copy of
iadr1_tpu/vision/preprocess.py, reduced to what the serving path needs).

``PIL`` is imported only where an image is resized: ``patchify_image``
takes an already-sized array, so a caller without ``PIL`` can feed the
tower.
"""

from __future__ import annotations

import math

import numpy as np

# OpenAI-CLIP normalization used by Qwen2-VL's image processor
OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Resize targets: multiples of ``factor`` within the pixel bounds,
    preserving aspect ratio (HF Qwen2VL image processor semantics)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _area_cap_resize(image, image_resolution: int):
    """Cap the area at ``image_resolution`` pixels (NEAREST), force RGB."""
    from PIL import Image

    if image.width * image.height > image_resolution:
        factor = math.sqrt(image_resolution / (image.width * image.height))
        image = image.resize(
            (int(image.width * factor), int(image.height * factor)),
            resample=Image.Resampling.NEAREST)
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


def _qwen_clamp_image(image):
    """Qwen2-VL guards: min side 28 px, aspect ratio < 200."""
    from PIL import Image

    nearest = Image.Resampling.NEAREST
    if min(image.width, image.height) < 28:
        image = image.resize((max(image.width, 28), max(image.height, 28)),
                             resample=nearest)
    if image.width / image.height > 200:
        image = image.resize((image.height * 180, image.height),
                             resample=nearest)
    if image.height / image.width > 200:
        image = image.resize((image.width, image.width * 180),
                             resample=nearest)
    return image


def patchify_image(pixels: np.ndarray, patch_size: int = 14,
                   merge_size: int = 2, temporal_patch_size: int = 2,
                   ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """An already-sized RGB array [h, w, 3] in [0, 1] (h, w multiples of
    patch_size * merge_size) -> (flatten_patches [t*gh*gw, 3*tps*ps*ps],
    grid_thw), normalized and in 2x2-merge-block order (the order the
    tower's rotary grids and the merger expect)."""
    h, w = pixels.shape[:2]
    unit = patch_size * merge_size
    if h % unit or w % unit:
        raise ValueError(f"image {h}x{w} is not a multiple of {unit}")
    arr = (np.asarray(pixels, np.float32) - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    arr = arr.transpose(2, 0, 1)[None]                       # [1, 3, h, w]
    arr = np.tile(arr, (temporal_patch_size, 1, 1, 1))       # repeat frame
    channel = arr.shape[1]
    grid_t = arr.shape[0] // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size
    patches = arr.reshape(
        grid_t, temporal_patch_size, channel,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    ).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w,
        channel * temporal_patch_size * patch_size * patch_size,
    )
    return flat, (grid_t, grid_h, grid_w)


def qwen2vl_preprocess(image, patch_size: int = 14, merge_size: int = 2,
                       temporal_patch_size: int = 2,
                       min_pixels: int = 56 * 56,
                       max_pixels: int = 14 * 14 * 4 * 1280):
    """PIL image -> (flatten_patches, grid_thw): clamp, smart_resize
    (bicubic), then ``patchify_image``."""
    from PIL import Image

    image = _qwen_clamp_image(_area_cap_resize(image, max_pixels))
    h, w = smart_resize(image.height, image.width, patch_size * merge_size,
                        min_pixels, max_pixels)
    image = image.resize((w, h), resample=Image.Resampling.BICUBIC)
    pixels = np.asarray(image, np.float32) / 255.0
    return patchify_image(pixels, patch_size, merge_size, temporal_patch_size)


def vision_rotary_ids(grid_thw, merge_size: int = 2) -> np.ndarray:
    """Per-patch (h, w) rotary position ids in merge-block order,
    [sum(t*h*w), 2] int32 (Qwen2VisionTransformer.rot_pos_emb)."""
    out = [np.zeros((0, 2), np.int64)]
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        ids = [
            grid.reshape(h // merge_size, merge_size, w // merge_size,
                         merge_size).transpose(0, 2, 1, 3).reshape(-1)
            for grid in (hpos, wpos)
        ]
        out.append(np.tile(np.stack(ids, axis=-1), (t, 1)))
    return np.concatenate(out, axis=0).astype(np.int32)


def vision_rotary_tables(grid_thw, head_dim: int, merge_size: int = 2,
                         theta: float = 10000.0):
    """(cos, sin) [P, head_dim] for the tower's 2-D rotary: the first half
    of the frequency pairs encodes h, the second w; the half-table is
    duplicated for the rotate-half convention."""
    ids = vision_rotary_ids(grid_thw, merge_size)
    if ids.shape[0] == 0:
        return (np.ones((0, head_dim), np.float32),
                np.zeros((0, head_dim), np.float32))
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freqs = ids[..., None].astype(np.float32) * inv_freq  # [P, 2, dim/2]
    half = freqs.reshape(ids.shape[0], -1)
    emb = np.concatenate([half, half], axis=-1)
    return np.cos(emb), np.sin(emb)


def vision_segment_ids(grid_thw, pad_to: int | None = None) -> np.ndarray:
    """1-based per-image segment ids over the concatenated patch stream."""
    segs = [np.full(t * h * w, i + 1, np.int32)
            for i, (t, h, w) in enumerate(grid_thw)]
    out = np.concatenate(segs) if segs else np.zeros(0, np.int32)
    if pad_to is not None and len(out) < pad_to:
        out = np.concatenate([out, np.zeros(pad_to - len(out), np.int32)])
    return out
