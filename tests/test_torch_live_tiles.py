"""K3's dead-tile test (``live_tiles``) against the valid pairs it must keep.

K3 (``csrc/flash_bwd.cu``) skips a (key block, query tile) pair when the
two ranges of non-zero segment ids do not overlap or, when causal, the
tile ends before the block begins.  ``live_tiles`` is the plain mirror of
that test.  Skipping is only sound if it is conservative: every valid
(query, key) pair of ``_valid_pairs`` must lie in a live tile, for any
segment ids, sorted or not.  Segment ids are drawn with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from iadr1_tpu_torch.kernels.flash_attention import (
    DKV_TILE_K,
    DKV_TILE_Q,
    _valid_pairs,
    live_tiles,
)
from iadr1_tpu_torch.vision.preprocess import vision_segment_ids


def _expand(live, T, S, tile_q, tile_k):
    """[B, nk, nq] tile flags -> [B, T, S] per pair."""
    per_pair = live.repeat_interleave(tile_k, 1).repeat_interleave(tile_q, 2)
    return per_pair[:, :S, :T].transpose(1, 2)


def _sorted_runs(rng, B, n, n_seg):
    cuts = np.sort(rng.integers(0, n, (B, n_seg)), axis=1)
    seg = np.zeros((B, n), np.int32)
    for b in range(B):
        for i, c in enumerate(cuts[b]):
            seg[b, c:] = i + 1
    seg[:, n - n // 7:] = 0                     # trailing padding
    return seg


def _case(kind, rng):
    if kind == "sorted":
        seg = _sorted_runs(rng, 2, 300, 3)
        return seg, seg
    if kind == "unsorted":
        seg = rng.integers(0, 4, (2, 261)).astype(np.int32)
        return seg, seg
    if kind == "all_padding":
        seg = np.zeros((1, 130), np.int32)
        return seg, seg
    if kind == "t_lt_s":
        return (rng.integers(0, 3, (2, 70)).astype(np.int32),
                rng.integers(0, 3, (2, 333)).astype(np.int32))
    if kind == "t_gt_s":
        return (_sorted_runs(rng, 1, 333, 2), _sorted_runs(rng, 1, 129, 2))
    if kind == "causal_edge":
        # the last query row (128) is the first key of a block: the one
        # valid pair that tile and block share must keep them live
        return np.ones((1, 129), np.int32), np.ones((1, 200), np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("tiles", [(32, 64), (64, 64), (64, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "all_padding",
                                  "t_lt_s", "t_gt_s", "causal_edge"])
def test_every_valid_pair_lies_in_a_live_tile(kind, causal, tiles):
    tile_q, tile_k = tiles
    rng = np.random.default_rng(sum(map(ord, kind)) + 7 * causal + tile_q)
    q_np, kv_np = _case(kind, rng)
    q_seg, kv_seg = torch.from_numpy(q_np), torch.from_numpy(kv_np)
    T, S = q_seg.shape[1], kv_seg.shape[1]
    live = live_tiles(q_seg, kv_seg, causal, tile_q, tile_k)
    assert live.shape == (q_seg.shape[0], -(-S // tile_k), -(-T // tile_q))
    valid = _valid_pairs(q_seg, kv_seg, causal)[:, 0]          # [B, T, S]
    covered = _expand(live, T, S, tile_q, tile_k)
    assert not (valid & ~covered).any()
    if kind == "all_padding":
        assert not live.any()


def test_causal_ends_the_walk_when_t_lt_s():
    q_seg = torch.ones((1, 70), dtype=torch.int32)
    kv_seg = torch.ones((1, 333), dtype=torch.int32)
    live = live_tiles(q_seg, kv_seg, True, 32, 64)
    # keys from 70 on are past every query row (top-left alignment)
    assert not live[:, 70 // 64 + 1:].any()
    assert live[:, 0].all()


def test_tower_layout_computes_about_a_quarter_of_its_tiles():
    # the serving path's four images: 1024, 960, 1024 and 960 patches in a
    # 4096-patch budget, then padding
    grids = [(1, 32, 32), (1, 24, 40), (1, 32, 32), (1, 24, 40)]
    seg = torch.from_numpy(vision_segment_ids(grids, pad_to=4096))[None]
    live = live_tiles(seg, seg, False)
    share = float(live.float().mean())
    assert 0.2 <= share <= 0.3, share
    valid = _valid_pairs(seg, seg, False)[:, 0]
    covered = _expand(live, 4096, 4096, DKV_TILE_Q, DKV_TILE_K)
    assert not (valid & ~covered).any()
