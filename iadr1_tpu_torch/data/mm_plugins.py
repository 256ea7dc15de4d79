"""The host plugins of six families (the port's own copy of
iadr1_tpu/data/mm_plugins.py): MiniCPM-V, Mllama, PaliGemma, Pixtral,
Video-LLaVA and LLaVA-NeXT-Video.

Given PIL images or frame lists, a plugin produces (a) messages whose
placeholders are expanded to the family's exact token run and (b) the
pixel arrays and the family's batch auxiliaries (Mllama's cross-attention
mask, PaliGemma's token_type_ids and image-token prefix, MiniCPM-V's image
bounds), as LLaMA-Factory's mm plugins of the same names do.  The port
has no tower for MiniCPM-V or Mllama: these two are plugins only.  Pixels
and tiles come from ``vision/anyres.py``; everything here is host numpy.
"""

from __future__ import annotations

import dataclasses
import math
import re
from copy import deepcopy
from typing import Sequence

import numpy as np

from iadr1_tpu_torch.vision.anyres import normalize as _normalize
from iadr1_tpu_torch.vision.anyres import to_array as _to_array

IMAGE_PLACEHOLDER = "<image>"
VIDEO_PLACEHOLDER = "<video>"
IGNORE_INDEX = -100

def _replace_stream(messages, placeholder: str, repls: list[str]):
    """Replace successive ``placeholder`` occurrences across the
    conversation with per-occurrence strings; errors on count mismatch
    (LLaMA-Factory's num_image_tokens validation).  Split-and-interleave
    so a replacement containing the placeholder text itself (e.g. the
    "<image>" token repeated) is never re-matched (LLaMA-Factory's
    {{image}} two-phase substitution)."""
    out = deepcopy(list(messages))
    idx = 0
    for m in out:
        parts = m["content"].split(placeholder)
        need = len(parts) - 1
        if idx + need > len(repls):
            raise ValueError(f"more {placeholder} placeholders than inputs")
        content = parts[0]
        for tail in parts[1:]:
            content += repls[idx] + tail
            idx += 1
        m["content"] = content
    if idx != len(repls):
        raise ValueError(
            f"{len(repls)} inputs but {idx} {placeholder} placeholders")
    return out


# ---------------------------------------------------------------------------
# LLaVA-NeXT-Video
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LlavaNextVideoPlugin:
    """Images go through the LLaVA-NeXT anyres path; videos are
    CLIP-resized frames whose per-frame feature grid is average-pooled by
    4 (the model's video pooling layer), giving
    video_seqlen = (H/p)*(W/p)//4 * frames."""

    image_token: str = "<image>"
    video_token: str = "<video>"
    tile_size: int = 336
    patch_size: int = 14
    grid_pinpoints: tuple = ((336, 672), (672, 336), (672, 672),
                             (1008, 336), (336, 1008))
    vision_feature_select_strategy: str = "default"

    def image_seqlen(self, image) -> int:
        from iadr1_tpu_torch.vision.anyres import (
            select_best_resolution, onevision_pack_plan,
        )

        res = select_best_resolution(
            (image.height, image.width),
            [list(p) for p in self.grid_pinpoints])
        grid = (res[0] // self.tile_size, res[1] // self.tile_size)
        g = self.tile_size // self.patch_size
        plan = onevision_pack_plan(
            (image.height, image.width), grid, g, max_tiles=None)
        # plan["length"] never counts a CLS token (our towers drop it),
        # matching HF's "default" select strategy; "full" keeps the CLS
        n = plan["length"]
        if self.vision_feature_select_strategy == "full":
            n += 1
        return n

    def video_seqlen(self, frames: Sequence) -> int:
        g = self.tile_size // self.patch_size
        return (g * g) // 4 * len(frames)

    def process_messages(self, messages, images=(), videos=()):
        out = _replace_stream(
            messages, IMAGE_PLACEHOLDER,
            [self.image_token * self.image_seqlen(im) for im in images])
        return _replace_stream(
            out, VIDEO_PLACEHOLDER,
            [self.video_token * self.video_seqlen(v) for v in videos])

    def get_mm_inputs(self, images=(), videos=()):
        from iadr1_tpu_torch.vision.anyres import llava_next_tiles

        mm: dict = {}
        if images:
            pix, sizes = [], []
            for im in images:
                tiles, _grid = llava_next_tiles(
                    im, [list(p) for p in self.grid_pinpoints],
                    self.tile_size)
                pix.append(tiles)
                sizes.append([im.height, im.width])
            mm["pixel_values"] = pix            # list of [tiles, 3, T, T]
            mm["image_sizes"] = np.asarray(sizes, np.int64)
        if videos:
            from iadr1_tpu_torch.vision.anyres import clip_resize_center_crop

            mm["pixel_values_videos"] = [
                np.stack([clip_resize_center_crop(f, self.tile_size)
                          for f in frames])
                for frames in videos
            ]
        return mm


# ---------------------------------------------------------------------------
# VideoLLaVA
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VideoLlavaPlugin:
    """CLIP-resized single tile per image; videos are per-frame tiles.
    image_seqlen = (H/p)*(W/p) + 1 (CLS), minus 1 under the "default"
    select strategy; video_seqlen keeps the CLS per frame (LLaMA-Factory
    computes it BEFORE the -=1)."""

    image_token: str = "<image>"
    video_token: str = "<video>"
    tile_size: int = 224
    patch_size: int = 14
    vision_feature_select_strategy: str = "default"

    def _seqlens(self, num_frames: int) -> tuple[int, int]:
        g = self.tile_size // self.patch_size
        image_seqlen = g * g + 1
        video_seqlen = image_seqlen * num_frames
        if self.vision_feature_select_strategy == "default":
            image_seqlen -= 1
        return image_seqlen, video_seqlen

    def process_messages(self, messages, images=(), videos=()):
        image_seqlen, _ = self._seqlens(0)
        out = _replace_stream(
            messages, IMAGE_PLACEHOLDER,
            [self.image_token * image_seqlen for _ in images])
        repls = []
        for frames in videos:
            _, video_seqlen = self._seqlens(len(frames))
            repls.append(self.video_token * video_seqlen)
        return _replace_stream(out, VIDEO_PLACEHOLDER, repls)

    def get_mm_inputs(self, images=(), videos=()):
        from iadr1_tpu_torch.vision.anyres import clip_resize_center_crop

        mm: dict = {}
        if images:
            mm["pixel_values_images"] = np.stack([
                clip_resize_center_crop(im, self.tile_size) for im in images
            ])
        if videos:
            mm["pixel_values_videos"] = np.stack([
                np.stack([clip_resize_center_crop(f, self.tile_size)
                          for f in frames])
                for frames in videos
            ])
        return mm


# ---------------------------------------------------------------------------
# PaliGemma
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PaliGemmaPlugin:
    """Placeholders are STRIPPED from the text; the image token run is
    prepended at the TOKEN level (process_token_ids) and token_type_ids
    mark the prefix (0) vs text (1) for the prefix-LM loss."""

    image_token: str = "<image>"
    image_size: int = 224
    patch_size: int = 14

    @property
    def image_seqlen(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def process_messages(self, messages, images=(), videos=()):
        if videos:
            raise ValueError("PaliGemma accepts images only")
        return _replace_stream(messages, IMAGE_PLACEHOLDER,
                               ["" for _ in images])

    def process_token_ids(self, input_ids, labels, images,
                          image_token_id: int):
        n = len(images) * self.image_seqlen
        input_ids = [image_token_id] * n + list(input_ids)
        if labels is not None:
            labels = [IGNORE_INDEX] * n + list(labels)
        return input_ids, labels

    def token_type_ids(self, imglens: Sequence[int],
                       seqlens: Sequence[int]) -> list[list[int]]:
        out = []
        for imglen, seqlen in zip(imglens, seqlens):
            n = imglen * self.image_seqlen
            out.append([0] * n + [1] * (seqlen - n))
        return out

    def get_mm_inputs(self, images=(), videos=()):
        pix = np.stack([
            _normalize(_to_array(im, (self.image_size, self.image_size)),
                       mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
            for im in images
        ])
        return {"pixel_values": pix}


# ---------------------------------------------------------------------------
# Pixtral
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PixtralPlugin:
    """Variable-size images scaled to fit ``longest_edge`` and rounded UP
    to patch multiples; each image expands to rows of [IMG] tokens ending
    with [IMG_BREAK], the final row ending with [IMG_END]."""

    image_token: str = "[IMG]"
    image_break_token: str = "[IMG_BREAK]"
    image_end_token: str = "[IMG_END]"
    longest_edge: int = 1024
    patch_size: int = 16

    def target_size(self, height: int, width: int) -> tuple[int, int]:
        ratio = max(height / self.longest_edge, width / self.longest_edge)
        if ratio > 1:
            height = math.ceil(height / ratio)
            width = math.ceil(width / ratio)
        nh = math.ceil(height / self.patch_size)
        nw = math.ceil(width / self.patch_size)
        return nh * self.patch_size, nw * self.patch_size

    def expansion(self, height: int, width: int) -> str:
        th, tw = self.target_size(height, width)
        nh, nw = th // self.patch_size, tw // self.patch_size
        rows = [[self.image_token] * nw + [self.image_break_token]] * nh
        flat = [t for row in rows for t in row]
        flat[-1] = self.image_end_token
        return "".join(flat)

    def process_messages(self, messages, images=(), videos=()):
        if videos:
            raise ValueError("Pixtral accepts images only")
        return _replace_stream(
            messages, IMAGE_PLACEHOLDER,
            [self.expansion(im.size[1], im.size[0]) for im in images])

    def get_mm_inputs(self, images=(), videos=()):
        pix = [
            _normalize(_to_array(im, self.target_size(im.size[1],
                                                      im.size[0])))
            for im in images
        ]
        return {"pixel_values": pix}   # list: sizes vary per image


# ---------------------------------------------------------------------------
# Mllama
# ---------------------------------------------------------------------------


def _mllama_supported_ratios(max_tiles: int) -> list[tuple[int, int]]:
    out = []
    for h in range(1, max_tiles + 1):
        for w in range(1, max_tiles + 1):
            if h * w <= max_tiles:
                out.append((h, w))
    return out


@dataclasses.dataclass
class MllamaPlugin:
    """One <|image|> token per image in the text; pixels become padded
    tile grids [max_imgs, max_tiles, 3, T, T] with aspect_ratio ids/mask,
    and the dense cross-attention mask maps each text token to the tiles
    of the images preceding it (behavior of transformers'
    get_cross_attention_token_mask + convert_sparse_..., which
    LLaMA-Factory's plugin calls)."""

    image_token: str = "<|image|>"
    tile_size: int = 560
    max_tiles: int = 4
    # IMAGENET_STANDARD normalization (transformers mllama default)
    image_mean: tuple = (0.5, 0.5, 0.5)
    image_std: tuple = (0.5, 0.5, 0.5)

    def process_messages(self, messages, images=(), videos=()):
        if videos:
            raise ValueError("Mllama accepts images only")
        n = sum(m["content"].count(IMAGE_PLACEHOLDER) for m in messages)
        if n != len(images):
            raise ValueError("image count mismatch")
        return [{**m, "content": m["content"].replace(
            IMAGE_PLACEHOLDER, self.image_token)} for m in messages]

    def optimal_canvas(self, height: int, width: int) -> tuple[int, int]:
        """(tiles_h, tiles_w): smallest-waste canvas among supported
        ratios (transformers get_optimal_tiled_canvas: prefer the canvas
        needing the least upscaling, then the smallest area)."""
        ratios = _mllama_supported_ratios(self.max_tiles)
        sizes = np.asarray(
            [(h * self.tile_size, w * self.tile_size) for h, w in ratios])
        scales = np.min(sizes / np.asarray([height, width]), axis=1)
        up = scales[scales >= 1]
        scale = np.min(up) if up.size else np.max(scales)
        chosen = np.nonzero(scales == scale)[0]
        areas = sizes[chosen].prod(axis=1)
        best = chosen[int(np.argmin(areas))]
        return ratios[best]

    def _fit_size(self, height, width, canvas_h, canvas_w):
        """transformers get_image_size_fit_to_canvas: targets are clipped
        to [tile_size, canvas] (small images upscale to a full tile); the
        limiting side lands EXACTLY on its target, only the other side is
        floored."""
        target_h = min(max(height, self.tile_size), canvas_h)
        target_w = min(max(width, self.tile_size), canvas_w)
        scale_h, scale_w = target_h / height, target_w / width
        if scale_w < scale_h:
            return (min(math.floor(height * scale_w) or 1, target_h),
                    target_w)
        return (target_h, min(math.floor(width * scale_h) or 1, target_w))

    def preprocess_image(self, image):
        """-> (tiles [n, 3, T, T], aspect_ratio_id, num_tiles)."""
        h, w = image.size[1], image.size[0]
        th, tw = self.optimal_canvas(h, w)
        canvas_h, canvas_w = th * self.tile_size, tw * self.tile_size
        nh, nw = self._fit_size(h, w, canvas_h, canvas_w)
        arr = _normalize(_to_array(image, (nh, nw), resample="bilinear"),
                         mean=self.image_mean, std=self.image_std)
        # the processor pads BEFORE normalize: canvas background is
        # normalize(0), not 0 (only unused tile SLOTS stay literal zero)
        pad_val = (-np.asarray(self.image_mean, np.float32)
                   / np.asarray(self.image_std, np.float32))
        padded = np.broadcast_to(
            pad_val[:, None, None], (3, canvas_h, canvas_w)).copy()
        padded[:, :nh, :nw] = arr
        tiles = (
            padded.reshape(3, th, self.tile_size, tw, self.tile_size)
            .transpose(1, 3, 0, 2, 4)
            .reshape(th * tw, 3, self.tile_size, self.tile_size)
        )
        ratios = _mllama_supported_ratios(self.max_tiles)
        return tiles, ratios.index((th, tw)) + 1, th * tw

    def get_mm_inputs(self, batch_images: Sequence[Sequence]):
        """batch_images: per-sample image lists (the processor's
        List[List[Image]] contract)."""
        B = len(batch_images)
        max_imgs = max((len(imgs) for imgs in batch_images), default=0)
        pix = np.zeros((B, max_imgs, self.max_tiles, 3,
                        self.tile_size, self.tile_size), np.float32)
        ar_ids = np.zeros((B, max_imgs), np.int64)
        ar_mask = np.zeros((B, max_imgs, self.max_tiles), np.int64)
        # transformers quirk kept for parity: tile 0 is marked valid even
        # for PADDED image slots (padding aspect ratio is (1, 1))
        ar_mask[:, :, 0] = 1
        num_tiles = []
        for b, imgs in enumerate(batch_images):
            row = []
            for i, im in enumerate(imgs):
                tiles, ar_id, n = self.preprocess_image(im)
                pix[b, i, :n] = tiles
                ar_ids[b, i] = ar_id
                ar_mask[b, i, :n] = 1
                row.append(n)
            num_tiles.append(row)
        return {"pixel_values": pix, "aspect_ratio_ids": ar_ids,
                "aspect_ratio_mask": ar_mask, "num_tiles": num_tiles}

    @staticmethod
    def cross_attention_token_mask(input_ids: Sequence[int],
                                   image_token_id: int):
        """Per-image [start, end) spans: each image attends from its
        token to the next image token or, for the LAST image, to the end
        of the sequence (transformers get_cross_attention_token_mask)."""
        locs = [i for i, t in enumerate(input_ids) if t == image_token_id]
        if not locs:
            return []
        if len(locs) == 1:
            return [[locs[0], -1]]
        spans = [[loc1, loc2] for loc1, loc2 in zip(locs[:-1], locs[1:])]
        spans.append([locs[-1], len(input_ids)])
        return spans

    def dense_cross_attention_mask(self, batch_ids, num_tiles,
                                   image_token_id: int, length: int):
        """[B, length, max_imgs, max_tiles] dense mask (transformers
        convert_sparse_cross_attention_mask_to_dense)."""
        B = len(batch_ids)
        max_imgs = max((len(row) for row in num_tiles), default=0)
        out = np.zeros((B, length, max_imgs, self.max_tiles), np.int64)
        for b, (ids, tiles_row) in enumerate(zip(batch_ids, num_tiles)):
            spans = self.cross_attention_token_mask(ids, image_token_id)
            for i, ((start, end), n) in enumerate(zip(spans, tiles_row)):
                if start >= length:
                    continue
                end = length if end == -1 else min(end, length)
                out[b, start:end, i, :n] = 1
        return out


# ---------------------------------------------------------------------------
# MiniCPM-V
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MiniCPMVPlugin:
    """Adaptive slicing: the image becomes a resized "source" plus up to
    ``max_slice_nums`` grid slices; the text placeholder becomes
    "<image>unk*Q</image>" plus per-slice "<slice>unk*Q</slice>" rows.

    The HF processor for this family ships as hub remote code (not in the
    transformers package), so pixel-level parity is NOT testable offline;
    the geometry below follows the published MiniCPM-V-2.6 processor
    algorithm (ensure_divide / find_best_resize / get_refine_size) and is
    pinned by structural tests.
    """

    query_num: int = 64
    scale_resolution: int = 448
    patch_size: int = 14
    max_slice_nums: int = 9
    im_start: str = "<image>"
    im_end: str = "</image>"
    slice_start: str = "<slice>"
    slice_end: str = "</slice>"
    unk: str = "<unk>"
    use_image_id: bool = True
    im_id_start: str = "<image_id>"
    im_id_end: str = "</image_id>"

    # --- geometry (published minicpm-v processor algorithm) -------------

    @staticmethod
    def _ensure_divide(length: int, patch_size: int) -> int:
        return max(round(length / patch_size) * patch_size, patch_size)

    def _find_best_resize(self, h, w, allow_upscale=False):
        if (w * h > self.scale_resolution ** 2) or allow_upscale:
            r = w / h
            w = int(self.scale_resolution * math.sqrt(r))
            h = int(w / r)
        return (self._ensure_divide(h, self.patch_size),
                self._ensure_divide(w, self.patch_size))

    def best_grid(self, height: int, width: int) -> tuple[int, int] | None:
        """Slice grid (rows, cols) or None when the image is small enough
        that only the source view is used."""
        log_ratio = math.log(width / height)
        ratio = (width * height) / (self.scale_resolution ** 2)
        multiple = min(math.ceil(ratio), self.max_slice_nums)
        if multiple <= 1:
            return None
        candidates = []
        for n in (multiple - 1, multiple, multiple + 1):
            if n == 1 or n > self.max_slice_nums:
                continue
            for m in range(1, n + 1):
                if n % m == 0:
                    candidates.append((m, n // m))
        best, err = None, float("inf")
        for rows, cols in candidates:
            e = abs(log_ratio - math.log(cols / rows))
            if e < err:
                best, err = (rows, cols), e
        return best

    def n_slices(self, height: int, width: int) -> int:
        grid = self.best_grid(height, width)
        return 0 if grid is None else grid[0] * grid[1]

    # --- text expansion -------------------------------------------------

    def image_placeholder(self, height, width, index: int) -> str:
        body = self.im_start + self.unk * self.query_num + self.im_end
        if self.use_image_id:
            body = (self.im_id_start + str(index) + self.im_id_end) + body
        grid = self.best_grid(height, width)
        if grid is not None:
            rows, cols = grid
            slice_row = (self.slice_start + self.unk * self.query_num
                         + self.slice_end)
            body += "\n" + "\n".join(slice_row * cols for _ in range(rows))
        return body

    def process_messages(self, messages, images=(), videos=()):
        if images and videos:
            raise ValueError(
                "MiniCPM-V does not take images and videos together")
        if videos:
            # frames become plain (unsliced) image views, no image ids
            sub = dataclasses.replace(self, max_slice_nums=2,
                                      use_image_id=False)
            repls = []
            for frames in videos:
                repls.append("".join(
                    sub.image_placeholder(f.size[1], f.size[0], i)
                    for i, f in enumerate(frames)))
            return _replace_stream(messages, VIDEO_PLACEHOLDER, repls)
        return _replace_stream(
            messages, IMAGE_PLACEHOLDER,
            [self.image_placeholder(im.size[1], im.size[0], i)
             for i, im in enumerate(images)])

    def get_mm_inputs(self, images=(), videos=()):
        """Source view + slices per image, each resized to its
        best-resize geometry (pixel values in [-0.5/std ..] CLIP-style
        normalization like the published processor)."""
        pix, tgt_sizes = [], []
        for im in images:
            h, w = im.size[1], im.size[0]
            views = [self._find_best_resize(h, w)]
            grid = self.best_grid(h, w)
            if grid is not None:
                rows, cols = grid
                refine_h = self._ensure_divide(h, rows * self.patch_size)
                refine_w = self._ensure_divide(w, cols * self.patch_size)
                sh, sw = refine_h // rows, refine_w // cols
                views += [
                    self._find_best_resize(sh, sw, allow_upscale=True)
                ] * (rows * cols)
            arrs = [
                _normalize(_to_array(im, v), mean=(0.5,) * 3, std=(0.5,) * 3)
                for v in views
            ]
            pix.append(arrs)
            tgt_sizes.append([(a.shape[1] // self.patch_size,
                               a.shape[2] // self.patch_size)
                              for a in arrs])
        return {"pixel_values": pix, "tgt_sizes": tgt_sizes}

    @staticmethod
    def image_bounds(input_ids: Sequence[int], im_start_id: int,
                     im_end_id: int, slice_start_id: int | None = None,
                     slice_end_id: int | None = None) -> np.ndarray:
        """[n, 2] (start+1, end) spans of image/slice token runs
        (LLaMA-Factory's MiniCPM-V get_mm_inputs)."""
        ids = np.asarray(input_ids)
        start_cond = ids == im_start_id
        end_cond = ids == im_end_id
        if slice_start_id is not None:
            start_cond |= ids == slice_start_id
        if slice_end_id is not None:
            end_cond |= ids == slice_end_id
        starts = np.nonzero(start_cond)[0] + 1
        ends = np.nonzero(end_cond)[0]
        n = max(len(starts), len(ends))
        return np.stack([starts[:n], ends[:n]], axis=1)


MM_PLUGINS = {
    "llava_next_video": LlavaNextVideoPlugin,
    "video_llava": VideoLlavaPlugin,
    "paligemma": PaliGemmaPlugin,
    "pixtral": PixtralPlugin,
    "mllama": MllamaPlugin,
    "minicpm_v": MiniCPMVPlugin,
}


def get_mm_plugin(name: str, **kwargs):
    """Instantiate a plugin by its family's name."""
    if name not in MM_PLUGINS:
        raise KeyError(f"unknown mm plugin {name!r}; known: "
                       f"{sorted(MM_PLUGINS)}")
    return MM_PLUGINS[name](**kwargs)
