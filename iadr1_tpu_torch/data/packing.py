"""Sequence packing: greedy knapsack + segment-id rows (the port's own copy
of iadr1_tpu/data/packing.py, Python path only).

Every packed row has the same static length; segment ids feed the flash
kernels' segment masking directly.  The JAX package's native C++ fast path
(``use_native``) is not ported: this is the plain Python path, which
produces the same rows.
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


def pack_examples(examples: Sequence[dict], cutoff_len: int,
                  pad_token_id: int) -> list[dict]:
    """Pack encoded examples into fixed-length rows with segment ids.

    Each input example: {"input_ids": [...], "labels": [...], optional
    "extras" carried per segment}.  Output rows hold ``input_ids`` (padded
    with ``pad_token_id``), ``labels`` (padded with IGNORE_INDEX),
    ``segment_ids`` (1-based per segment, 0 = padding), ``position_ids``
    (restarting at each segment), all [cutoff_len] int32, and ``extras``,
    the packed examples' extras in pack order.  Examples longer than
    ``cutoff_len`` are dropped."""
    kept = [ex for ex in examples if len(ex["input_ids"]) <= cutoff_len]
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
