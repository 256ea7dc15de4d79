"""Description reward: embedding cosine similarity of ``<description>`` tags.

Defined-but-unused in the reference main recipe (reward_process/
description_reward.py uses sentence-transformers all-MiniLM-L6-v2).  We keep
the same shape -- cosine similarity in [0, 1] between the predicted and
ground-truth descriptions -- but make the embedding backend pluggable so the
framework has no hard sentence-transformers dependency.  When no backend is
registered we fall back to a bag-of-words cosine, which preserves ordering
semantics (identical -> 1.0, disjoint -> 0.0) for tests.

The port's own copy of iadr1_tpu/rewards/description.py.  The two
embedding backends of the JAX package (a mean-pooled HF encoder and a
mean-pooled model bundle) are not ported yet (ROADMAP A.15); their
constructors raise.  The reward is unused in the reference main recipe.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Callable, Sequence

_EMBED_FN: Callable[[Sequence[str]], "list[list[float]]"] | None = None


def register_embedding_backend(fn) -> None:
    """Install an ``embed(texts) -> [[float]]`` backend (e.g. a sentence encoder)."""
    global _EMBED_FN
    _EMBED_FN = fn


_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _bow_cosine(a: str, b: str) -> float:
    ca = Counter(_TOKEN_RE.findall(a.lower()))
    cb = Counter(_TOKEN_RE.findall(b.lower()))
    if not ca or not cb:
        return 0.0
    dot = sum(ca[t] * cb[t] for t in ca.keys() & cb.keys())
    na = math.sqrt(sum(v * v for v in ca.values()))
    nb = math.sqrt(sum(v * v for v in cb.values()))
    return dot / (na * nb)


def description_score(predicted: str, actual: str) -> float:
    """Cosine similarity of the two descriptions, clamped to [0, 1]."""
    if not predicted or not actual:
        return 0.0
    if _EMBED_FN is not None:
        va, vb = _EMBED_FN([predicted, actual])
        dot = sum(x * y for x, y in zip(va, vb))
        na = math.sqrt(sum(x * x for x in va))
        nb = math.sqrt(sum(y * y for y in vb))
        sim = dot / (na * nb) if na and nb else 0.0
    else:
        sim = _bow_cosine(predicted, actual)
    return max(0.0, min(1.0, sim))


def make_transformer_embedding_backend(model_name_or_path: str):
    """Mean-pooled HF AutoModel embedding backend (not ported yet)."""
    raise NotImplementedError(
        "the transformer embedding backend is not ported yet (ROADMAP A.15); "
        "register an embed(texts) function with register_embedding_backend")


def make_bundle_embedding_backend(bundle, params, tokenizer,
                                  max_len: int = 128, batch_size: int = 8):
    """Mean-pooled decoder hidden states of a model bundle as the
    embedding (not ported yet)."""
    raise NotImplementedError(
        "the bundle embedding backend is not ported yet (ROADMAP A.15); "
        "register an embed(texts) function with register_embedding_backend")
