"""Tokenized-dataset cache: save/load packed rows (the port's own copy of
iadr1_tpu/data/cache.py).

The counterpart of the reference's tokenized_path save/load
(data/loader.py:237-300, datasets save_to_disk/load_from_disk): the
expensive tokenize+knapsack-pack step runs once and later launches load
the arrays directly.  Text fields only -- rows carrying multimodal
``extras`` (image patch arrays) are not cached and the caller falls back
to re-deriving them (returns False from save_tokenized).
"""

from __future__ import annotations

import os

import numpy as np

_FIELDS = ("input_ids", "labels", "segment_ids", "position_ids")


def save_tokenized(path: str, rows: list[dict]) -> bool:
    """Write packed rows to ``path`` (.npz).  Returns False (no write) when
    any row carries non-cacheable multimodal extras."""
    if any("extras" in r and r["extras"] for r in rows):
        return False
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {
        f: np.stack([np.asarray(r[f]) for r in rows]) for f in _FIELDS
        if rows and f in rows[0]
    }
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return True


def load_tokenized(path: str) -> list[dict] | None:
    """Load rows saved by save_tokenized; None when the cache is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    n = len(next(iter(fields.values())))
    return [{k: v[i] for k, v in fields.items()} for i in range(n)]
