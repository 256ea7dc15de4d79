"""The flash kernels' dead-tile tests against the valid pairs they must keep.

K3 (``csrc/flash_bwd.cu``) skips a (key block, query tile) pair when the
two ranges of non-zero segment ids do not overlap or, when causal, the
tile ends before the block begins; ``live_tiles`` is the plain mirror of
that test.  K1 and K2 skip a (stacked query-row block, key tile) pair by
the same test from the other side, and skip the mask where every pair of
a tile is valid; ``live_key_tiles`` mirrors both.  Skipping is only sound
if it is conservative: every valid (query, key) pair of ``_valid_pairs``
must lie in a live tile, for any segment ids, sorted or not, and every
pair of a full tile must be valid.  Segment ids are drawn with numpy from
a seed.
"""

import numpy as np
import pytest
import torch

from iadr1_tpu_torch.kernels.flash_attention import (
    DKV_TILE_K,
    DKV_TILE_Q,
    KEY_TILE,
    ROW_BLOCK,
    _valid_pairs,
    live_key_tiles,
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


# K1 and K2 (csrc/flash_fwd.cu, csrc/flash_bwd.cu): blocks of 64 stacked
# query rows (row r = g*T + t) against 64-key tiles, by ``live_key_tiles``


def _expand_rows(flags, T, S, group):
    """[B, n_row_blocks, n_key_tiles] block flags -> [B, group*T, S] per
    (stacked row, key)."""
    rows = torch.arange(group * T)
    return flags[:, rows // ROW_BLOCK].repeat_interleave(KEY_TILE, 2)[:, :, :S]


def _key_tile_case(kind, rng):
    if kind == "aligned":                     # T a multiple of 64
        seg = _sorted_runs(rng, 2, 256, 3)
        return seg, seg
    if kind == "one_segment":                 # whole tiles of one id
        seg = np.ones((2, 256), np.int32)
        return seg, seg
    return _case(kind, rng)


KEY_TILE_KINDS = ["sorted", "aligned", "one_segment", "unsorted",
                  "all_padding", "t_lt_s", "t_gt_s", "causal_edge"]


@pytest.mark.parametrize("group", [1, 6, 7])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", KEY_TILE_KINDS)
def test_every_valid_pair_lies_in_a_live_key_tile(kind, causal, group):
    rng = np.random.default_rng(sum(map(ord, kind)) + 7 * causal + group)
    q_np, kv_np = _key_tile_case(kind, rng)
    q_seg, kv_seg = torch.from_numpy(q_np), torch.from_numpy(kv_np)
    B, T = q_seg.shape
    S = kv_seg.shape[1]
    live, full = live_key_tiles(q_seg, kv_seg, causal, group)
    assert live.shape == full.shape == (B, -(-group * T // ROW_BLOCK),
                                        -(-S // KEY_TILE))
    # each stacked row r reads the valid pairs of its own t = r % T, so a
    # block whose rows run from one head into the next covers both runs
    valid = _valid_pairs(q_seg, kv_seg, causal)[:, 0][
        :, torch.arange(group * T) % T]                     # [B, gT, S]
    assert not (valid & ~_expand_rows(live, T, S, group)).any()
    # a full tile skips the mask: each of its pairs must be valid
    assert not (full & ~live).any()
    assert not (_expand_rows(full, T, S, group) & ~valid).any()
    if kind == "all_padding":
        assert not live.any()
    if kind == "one_segment":
        assert full.any()


def test_a_wrapping_block_covers_both_heads():
    # GQA 6, T = 200: block 3 holds rows 192..255, i.e. t 192..199 of head
    # 0 and t 0..55 of head 1; causal, its last t is 199
    seg = torch.ones((1, 200), dtype=torch.int32)
    live, full = live_key_tiles(seg, seg, True, 6)
    assert live[0, 3].all()                 # keys up to 199: all 4 tiles
    assert not full[0, 3].any()             # its first t is 0
    one = torch.ones((1, 256), dtype=torch.int32)
    live, full = live_key_tiles(one, one, True, 1)
    assert full[0, 3, :3].all() and not full[0, 3, 3]   # the diagonal tile


def test_prefill_layout_keeps_few_of_its_causal_tiles():
    # the serving path's prefill: four prompts of 292, 283, 306 and 297
    # tokens left-padded into 1024 slots, GQA 6 (Qwen2-VL-2B's decoder)
    seg = torch.zeros((4, 1024), dtype=torch.int32)
    for b, n in enumerate((292, 283, 306, 297)):
        seg[b, 1024 - n:] = 1
    live, _ = live_key_tiles(seg, seg, True, 6)
    causal, _ = live_key_tiles(torch.ones_like(seg), torch.ones_like(seg),
                               True, 6)
    share = float(live.sum()) / float(causal.sum())
    assert share <= 0.15, share
    valid = _valid_pairs(seg, seg, True)[:, 0][:, torch.arange(6 * 1024) % 1024]
    assert not (valid & ~_expand_rows(live, 1024, 1024, 6)).any()


def test_tower_layout_keeps_about_a_quarter_of_its_key_tiles():
    grids = [(1, 32, 32), (1, 24, 40), (1, 32, 32), (1, 24, 40)]
    seg = torch.from_numpy(vision_segment_ids(grids, pad_to=4096))[None]
    live, full = live_key_tiles(seg, seg, False, 1)
    share = float(live.float().mean())
    assert 0.2 <= share <= 0.3, share
    valid = _valid_pairs(seg, seg, False)[:, 0]
    assert not (valid & ~_expand_rows(live, 4096, 4096, 1)).any()
    assert not (_expand_rows(full, 4096, 4096, 1) & ~valid).any()
