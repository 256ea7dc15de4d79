"""Tag extraction helpers shared by all reward functions.

The IAD-R1 output grammar (reference README.md:71-118, grpo_ad.py:72-118):

* normal image:    ``<think>...</think><answer>No</answer>``
* anomalous image: ``<think>...</think><location>...</location>``
  ``<type>...</type><answer>Yes</answer>``
"""

from __future__ import annotations

import re

_TAG_RE_CACHE: dict[tuple[str, int], re.Pattern] = {}


def _tag_re(tag: str, flags: int = 0) -> re.Pattern:
    key = (tag, flags)
    pat = _TAG_RE_CACHE.get(key)
    if pat is None:
        pat = re.compile(rf"<{tag}>(.*?)</{tag}>", flags)
        _TAG_RE_CACHE[key] = pat
    return pat


def extract_tag(tag: str, text: str, *, ignorecase: bool = False) -> str | None:
    """First ``<tag>...</tag>`` payload in ``text``, or None.

    Matches the reference's non-DOTALL ``re.search(r'<tag>(.*?)</tag>', text)``
    used throughout train/stage_rl/reward.py: the payload must not span
    newlines.
    """
    flags = re.IGNORECASE if ignorecase else 0
    m = _tag_re(tag, flags).search(text)
    return m.group(1) if m else None


def has_tag(tag: str, text: str) -> bool:
    """Case-insensitive, newline-spanning tag presence check.

    Matches the ``re.search(..., re.IGNORECASE | re.DOTALL)`` presence checks
    in the reference CoT ablation rewards (reward.py:137-141).
    """
    return bool(re.search(rf"<{tag}>.*?</{tag}>", text, re.IGNORECASE | re.DOTALL))


def extract_answer(text: str, *, ignorecase: bool = False) -> str:
    """Ground-truth answer from a solution string.

    The reference resolves ground truth as the ``<answer>`` payload if tagged,
    otherwise the whole stripped string (reward.py:20-21).
    """
    payload = extract_tag("answer", text, ignorecase=ignorecase)
    return payload.strip() if payload is not None else text.strip()


def completion_texts(completions) -> list[str]:
    """Unwrap the trainer's conversation-shaped completions to raw strings."""
    return [completion[0]["content"] for completion in completions]
