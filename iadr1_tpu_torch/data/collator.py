"""Batch assembly: packed rows + host vision precompute -> numpy batches
(the port's own copy of iadr1_tpu/data/collator.py, for images).

Every batch is a set of static-shape arrays: packed token rows with
segment ids, the family's padded vision stream and scatter indices, and
positions: [3, B, T] M-RoPE grids computed per packed segment for
Qwen2-VL, the rows' own 1-D positions otherwise.  The
collator returns numpy; the train step moves a batch to its device.
Videos are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from iadr1_tpu_torch.vision.mrope import get_mrope_positions


@dataclasses.dataclass
class VLMBatchBuilder:
    """Builds VLM batches from packed rows whose extras carry image info.

    extras per segment: {"images": [paths or PIL], "grid_thw": [(t,h,w)],
    "patches": [np [n, patch_dim]] (optional, if preprocessed already)}.
    The rotary tables, segment ids and scatter indices come from
    ``bundle.vision_arrays``."""

    bundle: object                 # ModelBundle
    patch_budget: int              # static max patches per batch
    merge_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 480000

    @property
    def image_token_id(self) -> int:
        return self.bundle.cfg.image_token_id

    @property
    def vision_start_token_id(self) -> int:
        return self.bundle.cfg.vision_start_token_id

    @property
    def spatial_merge_size(self) -> int:
        return self.bundle.cfg.vision.spatial_merge_size

    def _images(self, rows):
        patches_list, grids = [], []
        for r in rows:
            for extra in r.get("extras", []):
                if "video_patches" in extra or extra.get("videos"):
                    raise NotImplementedError(
                        "video inputs are not ported yet (ROADMAP A.13)")
                if "patches" in extra:
                    patches_list.extend(extra["patches"])
                    grids.extend(extra["grid_thw"])
                    continue
                for img in extra.get("images", []):
                    from PIL import Image

                    pil = Image.open(img) if isinstance(img, str) else img
                    flat, grid, _ = self.bundle.preprocess_image(
                        pil, min_pixels=self.min_pixels,
                        max_pixels=self.max_pixels)
                    patches_list.append(flat)
                    grids.append(grid)
        return patches_list, grids

    def __call__(self, rows: Sequence[dict]) -> dict:
        input_ids = np.stack([r["input_ids"] for r in rows])
        labels = np.stack([r["labels"] for r in rows])
        segment_ids = np.stack([r["segment_ids"] for r in rows])
        patches_list, grids = self._images(rows)

        batch = {
            "input_ids": input_ids.astype(np.int32),
            "labels": labels.astype(np.int32),
            "segment_ids": segment_ids.astype(np.int32),
            "position_ids": self._positions(rows, input_ids, grids),
        }
        batch.update(self.bundle.vision_arrays(input_ids, patches_list, grids,
                                               self.patch_budget))
        return batch

    def _positions(self, rows, input_ids, grids) -> np.ndarray:
        """[3, B, T] M-RoPE grids per packed segment, each segment consuming
        as many image grids as it has vision-start markers; for a family
        without M-RoPE the rows' own restarting positions [B, T].  Grid
        tuples are the family's ((t, h, w) here, (n_h, n_w, height, width)
        for LLaVA-OneVision); only this path reads them as (t, h, w)."""
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        if tcfg.mrope_section is None:
            return np.stack([r["position_ids"] for r in rows]).astype(
                np.int32)
        B, T = input_ids.shape
        grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
        position_ids = np.zeros((3, B, T), np.int64)
        gi = 0
        for b, r in enumerate(rows):
            segs = r["segment_ids"]
            for s in np.unique(segs[segs != 0]):
                span = segs == s
                ids_span = input_ids[b][span][None]
                n_starts = int(np.sum(ids_span == self.vision_start_token_id))
                seg_grids = grid_thw[gi:gi + n_starts]
                gi += n_starts
                pos, _ = get_mrope_positions(
                    ids_span, seg_grids if n_starts else None,
                    self.image_token_id, self.vision_start_token_id,
                    spatial_merge_size=self.spatial_merge_size)
                position_ids[:, b, span] = pos[:, 0]
        return position_ids.astype(np.int32)


def text_batch(rows: Sequence[dict]) -> dict:
    """Plain-text batch from packed rows (1-D RoPE positions)."""
    return {
        key: np.stack([r[key] for r in rows]).astype(np.int32)
        for key in ("input_ids", "labels", "segment_ids", "position_ids")
    }
