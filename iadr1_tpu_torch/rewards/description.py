"""Description reward: embedding cosine similarity of ``<description>`` tags.

Defined-but-unused in the reference main recipe (reward_process/
description_reward.py uses sentence-transformers all-MiniLM-L6-v2).  We keep
the same shape -- cosine similarity in [0, 1] between the predicted and
ground-truth descriptions -- but make the embedding backend pluggable so the
framework has no hard sentence-transformers dependency.  When no backend is
registered we fall back to a bag-of-words cosine, which preserves ordering
semantics (identical -> 1.0, disjoint -> 0.0) for tests.

The port's own copy of iadr1_tpu/rewards/description.py, with its two
embedding backends: a mean-pooled HF ``AutoModel`` encoder and the
mean-pooled decoder hidden states of any port bundle.  Exact agreement
with sentence-transformers' MiniLM has never been measured (no MiniLM
weights offline); the reward is unused in the reference main recipe.
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


def make_transformer_embedding_backend(model_name_or_path: str,
                                       device=None):
    """Mean-pooled HF AutoModel embedding backend -- the reference's
    all-MiniLM-L6-v2 sentence-transformers recipe
    (reward_process/description_reward.py:7-52) without the
    sentence-transformers dependency: MiniLM's ST head is exactly
    mean-pooling + L2 normalization over the last hidden state.  The
    encoder runs on ``device`` (the card unless given).

    Pass a *local* checkpoint directory.  Install with:

        register_embedding_backend(
            make_transformer_embedding_backend("/ckpts/all-MiniLM-L6-v2"))
    """
    import torch
    from transformers import AutoModel, AutoTokenizer

    from iadr1_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tok = AutoTokenizer.from_pretrained(model_name_or_path)
    model = AutoModel.from_pretrained(model_name_or_path).to(device).eval()

    def embed(texts: Sequence[str]) -> list[list[float]]:
        enc = tok(list(texts), padding=True, truncation=True,
                  max_length=256, return_tensors="pt").to(device)
        with torch.no_grad():
            hidden = model(**enc).last_hidden_state
        mask = enc["attention_mask"].unsqueeze(-1).to(hidden.dtype)
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)
        pooled = torch.nn.functional.normalize(pooled, dim=-1)
        return pooled.tolist()

    return embed


def make_bundle_embedding_backend(bundle, params, tokenizer,
                                  max_len: int = 128, batch_size: int = 8,
                                  device=None):
    """Mean-pooled decoder hidden states from any port bundle (the policy
    itself can score its own description similarity -- no second model),
    at fixed [batch_size, max_len] shapes on ``device`` (the card unless
    given).

    Same pooling recipe as the reference's sentence-transformers usage
    (mean pool + L2 normalize, description_reward.py:7-52).  The last
    chunk's padding rows hold no valid key (all segment 0: K1 gives them
    zeros); only the first ``n`` pooled rows of a chunk are returned, and
    nothing reduces across the batch, so a padding row cannot reach them.
    """
    import numpy as np
    import torch

    from iadr1_tpu_torch.core.device import resolve_device

    device = resolve_device(device)

    @torch.no_grad()
    def _embed(ids, mask):
        batch = {
            "input_ids": ids,
            "segment_ids": mask,
            "position_ids": (mask.cumsum(dim=1) - 1).clamp(min=0),
        }
        hidden = bundle.hidden_fn(params, batch, remat=False)   # [B, T, H]
        m = mask.to(hidden.dtype)[:, :, None]
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)

    pad = tokenizer.pad_token_id or tokenizer.eos_token_id

    def embed(texts: Sequence[str]) -> list[list[float]]:
        out = []
        for start in range(0, len(texts), batch_size):
            chunk = list(texts[start:start + batch_size])
            n = len(chunk)
            ids = np.full((batch_size, max_len), pad, np.int64)
            mask = np.zeros((batch_size, max_len), np.int32)
            for i, t in enumerate(chunk):
                enc = tokenizer.encode(t, add_special_tokens=False)[:max_len]
                if not enc:
                    enc = [pad]
                ids[i, :len(enc)] = enc
                mask[i, :len(enc)] = 1
            pooled = _embed(torch.as_tensor(ids).to(device),
                            torch.as_tensor(mask).to(device))
            out.extend(pooled[:n].float().cpu().tolist())
        return out

    return embed
