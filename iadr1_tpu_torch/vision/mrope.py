"""M-RoPE position grids for Qwen2-VL and Qwen2.5-VL (host numpy; the
port's own copy of iadr1_tpu/vision/mrope.py).

For every image or video span, temporal/height/width positions form a 3-D
grid offset by the running text position; text spans advance all three
axes together, restarting at max(previous) + 1 (HF get_rope_index
semantics).  A video's temporal index steps by 1 a temporal patch for
Qwen2-VL; for Qwen2.5-VL by ``second_per_grid_t * tokens_per_second``, as
transformers' ``Qwen2_5_VLModel.get_rope_index`` computes it (the JAX
package steps by 1 for both families: ROADMAP C.R14).
"""

from __future__ import annotations

import numpy as np


def get_mrope_positions(input_ids, grid_thw, image_token_id: int,
                        vision_start_token_id: int, attention_mask=None,
                        spatial_merge_size: int = 2,
                        video_token_id: int | None = None,
                        second_per_grid_ts=None,
                        tokens_per_second: float | None = None):
    """(position_ids [3, B, T], deltas [B]) for image, video and text
    sequences.

    ``grid_thw`` rows are consumed in reading order across the batch, one
    per vision span; a span is a video's when the token after its
    vision-start marker is ``video_token_id``.  ``tokens_per_second``
    None: a video's temporal index steps by 1 (Qwen2-VL); else by
    ``second_per_grid_t * tokens_per_second`` with ``second_per_grid_t``
    (the seconds a temporal patch spans) truncated to an integer first, as
    transformers does, from ``second_per_grid_ts`` (one per video in
    reading order; 1.0 where None, transformers' default).  Padding
    positions (attention_mask == 0) get position 1 (HF behavior).
    """
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.ones((3, B, T), np.int64)
    deltas = np.zeros(B, np.int64)
    grid_idx = video_idx = 0

    for b in range(B):
        keep = np.asarray(attention_mask[b]) == 1
        ids = input_ids[b][keep]
        tokens = ids.tolist()
        spans: list[np.ndarray] = []
        st = 0
        starts = (np.nonzero(ids[:-1] == vision_start_token_id)[0]
                  if grid_thw is not None else np.zeros(0, np.int64))
        after = ids[starts + 1]
        remain = {image_token_id: int(np.sum(after == image_token_id))}
        if video_token_id is not None and video_token_id != image_token_id:
            remain[video_token_id] = int(np.sum(after == video_token_id))
        for _ in range(sum(remain.values())):
            cands = []
            for tid, left in remain.items():
                if left > 0:
                    try:
                        cands.append((tokens.index(tid, st), tid))
                    except ValueError:
                        pass
            if not cands:
                break
            ed, tid = min(cands)
            remain[tid] -= 1
            t, h, w = grid_thw[grid_idx]
            grid_idx += 1
            gt = int(t)
            gh, gw = int(h) // spatial_merge_size, int(w) // spatial_merge_size
            text_len = ed - st
            start = spans[-1].max() + 1 if spans else 0
            if text_len > 0:
                spans.append(np.broadcast_to(np.arange(text_len),
                                             (3, text_len)) + start)
                start = start + text_len
            t_steps = np.arange(gt, dtype=np.int64)
            if tid == video_token_id:
                if tokens_per_second is not None:
                    spg = (1.0 if second_per_grid_ts is None
                           else second_per_grid_ts[video_idx])
                    t_steps = (t_steps * np.int64(spg)
                               * tokens_per_second).astype(np.int64)
                video_idx += 1
            t_idx = np.repeat(t_steps, gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_idx = np.tile(np.arange(gw), gt * gh)
            spans.append(np.stack([t_idx, h_idx, w_idx]) + start)
            st = ed + gt * gh * gw
        if st < len(tokens):
            start = spans[-1].max() + 1 if spans else 0
            text_len = len(tokens) - st
            spans.append(np.broadcast_to(np.arange(text_len),
                                         (3, text_len)) + start)
        pos = (np.concatenate(spans, axis=1) if spans
               else np.zeros((3, 0), np.int64))
        position_ids[:, b, keep] = pos
        deltas[b] = (pos.max() + 1 if pos.size else 0) - T
    return position_ids, deltas


def bundle_mrope_positions(cfg, input_ids, grids, attention_mask=None,
                           second_per_grid_ts=None):
    """``get_mrope_positions`` with a Qwen bundle's config (``cfg``:
    Qwen2VLConfig or Qwen25VLConfig): its image, video and vision-start
    ids, its merge size, and Qwen2.5-VL's ``tokens_per_second``.
    ``grids``: the batch's (t, h, w) grids in reading order."""
    grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
    return get_mrope_positions(
        input_ids, grid_thw if len(grid_thw) else None, cfg.image_token_id,
        cfg.vision_start_token_id, attention_mask=attention_mask,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        video_token_id=getattr(cfg, "video_token_id", None),
        second_per_grid_ts=second_per_grid_ts,
        tokens_per_second=getattr(cfg.vision, "tokens_per_second", None))
