"""Batch assembly: packed rows + host vision precompute -> numpy batches
(the port's own copy of iadr1_tpu/data/collator.py).

Every batch is a set of static-shape arrays: packed token rows with
segment ids, the family's padded vision stream and scatter indices, and
positions: [3, B, T] M-RoPE grids computed per packed segment for the
Qwen families, the rows' own 1-D positions otherwise.  The collator
returns numpy; the train step moves a batch to its device.

Videos: the Qwen families take a video's patches and (t, h, w) grid
through the image stream (``patches``/``grid_thw``), as the JAX package
does; its M-RoPE grids here also place the video spans (the JAX collator
passes no video token, so a video span gets text positions there:
ROADMAP C.R15).  The LLaVA video families take ``video_patches`` (frame
stacks) or ``videos`` (PIL frames, through ``bundle.preprocess_video``),
which go to ``vision_arrays(videos=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from iadr1_tpu_torch.vision.mrope import bundle_mrope_positions

NO_FRAME_STACKS = (
    "family {} takes no video frame stacks ('video_patches', 'videos'); "
    "a Qwen family takes a video's patches and (t, h, w) grid through "
    "'patches' and 'grid_thw'")


@dataclasses.dataclass
class VLMBatchBuilder:
    """Builds VLM batches from packed rows whose extras carry image info.

    extras per segment: {"images": [paths or PIL], "grid_thw": [(t,h,w)],
    "patches": [np [n, patch_dim]] (optional, if preprocessed already),
    "second_per_grid_ts": [seconds a temporal patch spans, per video of
    the stream] (optional, Qwen2.5-VL), "video_patches": [frame stacks] or
    "videos": [[PIL frames]] (the LLaVA video families)}.  The rotary
    tables, segment ids and scatter indices come from
    ``bundle.vision_arrays``."""

    bundle: object                 # ModelBundle
    patch_budget: int              # static max patches per batch
    merge_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 480000

    @property
    def vision_start_token_id(self) -> int:
        return self.bundle.cfg.vision_start_token_id

    def _images(self, rows):
        patches_list, grids, videos, spg = [], [], [], []
        for r in rows:
            for extra in r.get("extras", []):
                if "patches" in extra:
                    patches_list.extend(extra["patches"])
                    grids.extend(extra["grid_thw"])
                else:
                    for img in extra.get("images", []):
                        from PIL import Image

                        pil = Image.open(img) if isinstance(img, str) else img
                        flat, grid, _ = self.bundle.preprocess_image(
                            pil, min_pixels=self.min_pixels,
                            max_pixels=self.max_pixels)
                        patches_list.append(flat)
                        grids.append(grid)
                spg.extend(extra.get("second_per_grid_ts", ()))
                if "video_patches" in extra or extra.get("videos"):
                    if self.bundle.preprocess_video is None:
                        raise ValueError(NO_FRAME_STACKS.format(
                            self.bundle.family))
                    videos.extend(extra.get("video_patches", ()))
                    for frames in extra.get("videos") or ():
                        videos.append(self.bundle.preprocess_video(frames)[0])
        return patches_list, grids, videos, spg

    def __call__(self, rows: Sequence[dict]) -> dict:
        input_ids = np.stack([r["input_ids"] for r in rows])
        labels = np.stack([r["labels"] for r in rows])
        segment_ids = np.stack([r["segment_ids"] for r in rows])
        patches_list, grids, videos, spg = self._images(rows)

        batch = {
            "input_ids": input_ids.astype(np.int32),
            "labels": labels.astype(np.int32),
            "segment_ids": segment_ids.astype(np.int32),
            "position_ids": self._positions(rows, input_ids, grids, spg),
        }
        kw = {"videos": videos} if videos else {}
        batch.update(self.bundle.vision_arrays(input_ids, patches_list, grids,
                                               self.patch_budget, **kw))
        return batch

    def _positions(self, rows, input_ids, grids, spg) -> np.ndarray:
        """[3, B, T] M-RoPE grids per packed segment, each segment consuming
        as many (t, h, w) grids as it has vision-start markers (and as many
        of ``spg``, the videos' seconds per temporal patch, as it has
        video spans); for a family without M-RoPE the rows' own restarting
        positions [B, T].  Grid tuples are the family's ((t, h, w) here,
        (n_h, n_w, height, width) for the anyres families); only this path
        reads them as (t, h, w)."""
        cfg = self.bundle.cfg
        tcfg = getattr(cfg, "text", cfg)
        if tcfg.mrope_section is None:
            return np.stack([r["position_ids"] for r in rows]).astype(
                np.int32)
        B, T = input_ids.shape
        grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
        video_id = getattr(cfg, "video_token_id", None)
        position_ids = np.zeros((3, B, T), np.int64)
        gi = vi = 0
        for b, r in enumerate(rows):
            segs = r["segment_ids"]
            for s in np.unique(segs[segs != 0]):
                span = segs == s
                ids_span = input_ids[b][span][None]
                starts = np.nonzero(ids_span[0, :-1]
                                    == self.vision_start_token_id)[0]
                n_starts = len(starts)
                n_videos = int(np.sum(ids_span[0, starts + 1] == video_id))
                pos, _ = bundle_mrope_positions(
                    cfg, ids_span, grid_thw[gi:gi + n_starts],
                    second_per_grid_ts=(spg[vi:vi + n_videos] if spg
                                        else None))
                gi += n_starts
                vi += n_videos
                position_ids[:, b, span] = pos[:, 0]
        return position_ids.astype(np.int32)


def text_batch(rows: Sequence[dict]) -> dict:
    """Plain-text batch from packed rows (1-D RoPE positions)."""
    return {
        key: np.stack([r[key] for r in rows]).astype(np.int32)
        for key in ("input_ids", "labels", "segment_ids", "position_ids")
    }
