"""Sequence packing: greedy knapsack + segment-id rows (the port's own copy
of iadr1_tpu/data/packing.py).

Every packed row has the same static length; segment ids feed the flash
kernels' segment masking directly.  ``pack_examples`` runs the native
packing plane (``data/native.py``, ``csrc/dataplane.cpp``) by default;
``use_native=False`` runs its Python twin.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np

from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX


def greedy_knapsack(lengths: Sequence[int], capacity: int) -> list[list[int]]:
    """Partition ``lengths`` into bins of at most ``capacity``: repeatedly
    open a bin and stuff it with the largest remaining length that still
    fits (binary search over the sorted pool)."""
    pool = sorted(lengths)
    bins: list[list[int]] = []
    while pool:
        remaining = capacity
        current: list[int] = []
        while True:
            idx = bisect.bisect(pool, remaining) - 1
            if idx < 0:
                break
            remaining -= pool[idx]
            current.append(pool.pop(idx))
        bins.append(current)
    return bins


def _pack_examples_native(kept: Sequence[dict], cutoff_len: int,
                          pad_token_id: int) -> list[dict]:
    """The knapsack and the rows' assembly in one native pass."""
    from iadr1_tpu_torch.data import native

    lib = native.load()
    n = len(kept)
    lengths = np.asarray([len(ex["input_ids"]) for ex in kept], np.int64)
    tokens = np.concatenate(
        [np.asarray(ex["input_ids"], np.int32) for ex in kept]
    ) if n else np.zeros(0, np.int32)
    labels = np.concatenate(
        [np.asarray(ex["labels"], np.int32) for ex in kept]
    ) if n else np.zeros(0, np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    indices = np.zeros(n, np.int64)
    bin_sizes = np.zeros(max(n, 1), np.int64)
    n_bins = lib.greedy_knapsack(native.as_i64(lengths), n, cutoff_len,
                                 native.as_i64(indices),
                                 native.as_i64(bin_sizes))
    out = {key: np.empty((n_bins, cutoff_len), np.int32) for key in (
        "input_ids", "labels", "segment_ids", "position_ids")}
    lib.pack_rows(native.as_i32(tokens), native.as_i32(labels),
                  native.as_i64(offsets), native.as_i64(indices),
                  native.as_i64(bin_sizes), n_bins, cutoff_len,
                  pad_token_id, IGNORE_INDEX,
                  *(native.as_i32(a) for a in out.values()))
    rows, item = [], 0
    for b in range(n_bins):
        extras = []
        for _ in range(int(bin_sizes[b])):
            ex = kept[int(indices[item])]
            if "extras" in ex:
                extras.append(ex["extras"])
            item += 1
        rows.append({**{key: a[b] for key, a in out.items()},
                     "extras": extras})
    return rows


def pack_examples(examples: Sequence[dict], cutoff_len: int,
                  pad_token_id: int, use_native: bool = True) -> list[dict]:
    """Pack encoded examples into fixed-length rows with segment ids.

    Each input example: {"input_ids": [...], "labels": [...], optional
    "extras" carried per segment}.  Output rows hold ``input_ids`` (padded
    with ``pad_token_id``), ``labels`` (padded with IGNORE_INDEX),
    ``segment_ids`` (1-based per segment, 0 = padding), ``position_ids``
    (restarting at each segment), all [cutoff_len] int32, and ``extras``,
    the packed examples' extras in pack order.  Examples longer than
    ``cutoff_len`` are dropped.  ``use_native`` runs the native plane,
    which raises if it cannot be built; False runs the Python twin."""
    kept = [ex for ex in examples if len(ex["input_ids"]) <= cutoff_len]
    if use_native:
        return _pack_examples_native(kept, cutoff_len, pad_token_id)
    lengths = [len(ex["input_ids"]) for ex in kept]
    by_length: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        by_length.setdefault(n, []).append(i)

    rows = []
    for knapsack in greedy_knapsack(lengths, cutoff_len):
        ids: list[int] = []
        labels: list[int] = []
        segments: list[int] = []
        positions: list[int] = []
        extras = []
        for seg_idx, length in enumerate(knapsack):
            ex = kept[by_length[length].pop()]
            ids += list(ex["input_ids"])
            labels += list(ex["labels"])
            segments += [seg_idx + 1] * length
            positions += list(range(length))
            if "extras" in ex:
                extras.append(ex["extras"])
        pad = cutoff_len - len(ids)
        rows.append({
            "input_ids": np.asarray(ids + [pad_token_id] * pad, np.int32),
            "labels": np.asarray(labels + [IGNORE_INDEX] * pad, np.int32),
            "segment_ids": np.asarray(segments + [0] * pad, np.int32),
            "position_ids": np.asarray(positions + [0] * pad, np.int32),
            "extras": extras,
        })
    return rows
