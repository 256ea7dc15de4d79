"""M-RoPE position grids for Qwen2-VL (host numpy; the port's own copy of
iadr1_tpu/vision/mrope.py).

For every image span, temporal/height/width positions form a 3-D grid
offset by the running text position; text spans advance all three axes
together, restarting at max(previous) + 1 (HF get_rope_index semantics).
"""

from __future__ import annotations

import numpy as np


def get_mrope_positions(input_ids, grid_thw, image_token_id: int,
                        vision_start_token_id: int, attention_mask=None,
                        spatial_merge_size: int = 2):
    """(position_ids [3, B, T], deltas [B]) for image+text sequences.

    ``grid_thw`` rows are consumed in reading order across the batch.
    Padding positions (attention_mask == 0) get position 1 (HF behavior).
    """
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.ones((3, B, T), np.int64)
    deltas = np.zeros(B, np.int64)
    grid_idx = 0

    for b in range(B):
        keep = np.asarray(attention_mask[b]) == 1
        ids = input_ids[b][keep]
        tokens = ids.tolist()
        spans: list[np.ndarray] = []
        st = 0
        n_vision = (int(np.sum(ids == vision_start_token_id))
                    if grid_thw is not None else 0)
        for _ in range(n_vision):
            try:
                ed = tokens.index(image_token_id, st)
            except ValueError:
                break
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
            t_idx = np.repeat(np.arange(gt), gh * gw)
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
