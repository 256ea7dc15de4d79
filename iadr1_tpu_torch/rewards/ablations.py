"""Ablation reward variants from the reference recipe's studies.

Behavior-compatible with train/stage_rl/reward.py:107-347:

* ``consistency_reward_cot`` / ``format_consistency_reward_cot`` -- graded
  tag-count consistency (identical twins in the reference).
* ``accuracy_reward_cot_wo_type`` / ``..._wo_location`` -- accuracy with one
  partial-credit channel removed; unlike the main accuracy reward these
  require the remaining tag pair to be present (any missing tag zeroes the
  whole sample via the reference's blanket try/except).
* ``format_reward_cot_base`` / ``accuracy_reward_cot_base`` -- base R1-style
  think/answer format and answer-only accuracy.
* ``wo_format`` -- the no-format control (returns scalar 0, as the
  reference does).
"""

from __future__ import annotations

import re

from iadr1_tpu_torch.rewards.location import location_score
from iadr1_tpu_torch.rewards.structure import (
    completion_texts,
    extract_answer,
    extract_tag,
    has_tag,
)
from iadr1_tpu_torch.rewards.type_taxonomy import AnomalyTypeScorer

_BASE_PATTERN = re.compile(
    r".*<think>.*?</think><answer>.*?</answer>.*", re.DOTALL
)

_TAG_COUNT_SCORES_YES = {3: 1.0, 2: 0.7, 1: 0.4, 0: 0.0}

_SCORER = AnomalyTypeScorer()


def _graded_consistency(content: str, solution: str) -> float:
    gt = extract_answer(solution, ignorecase=True).lower()
    answer = extract_tag("answer", content, ignorecase=True)
    if answer is None:
        return 0.0
    answer = answer.strip().lower()
    if answer != gt:
        return 0.0
    tag_count = sum(
        has_tag(tag, content) for tag in ("type", "location", "description")
    )
    if answer == "no":
        return 1.0 if tag_count == 0 else 0.0
    if answer == "yes":
        return _TAG_COUNT_SCORES_YES[tag_count]
    return 0.0


def consistency_reward_cot(completions, solution, **kwargs) -> list[float]:
    return [
        _graded_consistency(c, s)
        for c, s in zip(completion_texts(completions), solution)
    ]


def format_consistency_reward_cot(completions, solution, **kwargs) -> list[float]:
    # Identical logic to consistency_reward_cot (reward.py:161-213 duplicates
    # :107-158); kept as a distinct registry entry for config parity.
    return consistency_reward_cot(completions, solution, **kwargs)


def _accuracy_single_channel(content: str, solution: str, channel: str) -> float:
    gt = extract_answer(solution).lower()
    if gt == "no":
        answer = extract_tag("answer", content)
        return 1.0 if answer is not None and answer.strip().lower() == "no" else 0.0
    if gt != "yes":
        return 0.0

    # The reference dereferences the tag matches unconditionally inside a
    # try/except, so a missing tag on either side zeroes the sample
    # including the answer bonus (reward.py:240-247, 286-295).
    pred = extract_tag(channel, content)
    truth = extract_tag(channel, solution)
    if pred is None or truth is None:
        return 0.0
    pred = pred.strip().lower()
    truth = truth.strip().lower()
    if channel == "location":
        reward = float(location_score(pred, truth))
    else:
        reward = _SCORER.score(pred, truth)

    answer = extract_tag("answer", content)
    if answer is not None and answer.strip().lower() == "yes":
        reward += 1.0
    return reward


def accuracy_reward_cot_wo_type(completions, solution, **kwargs) -> list[float]:
    return [
        _accuracy_single_channel(c, s, "location")
        for c, s in zip(completion_texts(completions), solution)
    ]


def accuracy_reward_cot_wo_location(completions, solution, **kwargs) -> list[float]:
    return [
        _accuracy_single_channel(c, s, "type")
        for c, s in zip(completion_texts(completions), solution)
    ]


def format_reward_cot_base(completions, solution, **kwargs) -> list[float]:
    return [
        1.0 if _BASE_PATTERN.fullmatch(content) else 0.0
        for content in completion_texts(completions)
    ]


def _answer_only(content: str, solution: str) -> float:
    gt = extract_answer(solution).lower()
    answer = extract_tag("answer", content)
    if answer is None:
        return 0.0
    answer = answer.strip().lower()
    if gt in ("no", "yes") and answer == gt:
        return 1.0
    return 0.0


def accuracy_reward_cot_base(completions, solution, **kwargs) -> list[float]:
    return [
        _answer_only(c, s)
        for c, s in zip(completion_texts(completions), solution)
    ]


def wo_format(completions, solution, **kwargs):
    # Control arm: contributes nothing (reference returns the scalar 0,
    # reward.py:345-347).
    return 0
