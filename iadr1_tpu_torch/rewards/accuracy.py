"""Accuracy reward: verdict correctness plus localized/typed partial credit.

* ground truth "no":  1.0 iff the completion's ``<answer>`` is exactly "no".
* ground truth "yes": (type_score + location_score) / 2, each contributing
  only when both sides carry the tag, plus 1.0 iff ``<answer>`` is "yes".
  Range [0, 2] -- partial credit for location/type accrues even when the
  final verdict is wrong, matching the reference.

Behavior-compatible with ``accuracy_reward`` in the reference
(train/stage_rl/reward.py:32-101).
"""

from __future__ import annotations

from iadr1_tpu_torch.rewards.location import location_score
from iadr1_tpu_torch.rewards.structure import (
    completion_texts,
    extract_answer,
    extract_tag,
)
from iadr1_tpu_torch.rewards.type_taxonomy import AnomalyTypeScorer


def score_accuracy(
    content: str, solution: str, scorer: AnomalyTypeScorer | None = None
) -> float:
    """Per-sample accuracy score: [0, 1] for "no" truths, [0, 2] for "yes"."""
    scorer = scorer or _DEFAULT_SCORER
    gt = extract_answer(solution).lower()

    if gt == "no":
        answer = extract_tag("answer", content)
        return 1.0 if answer is not None and answer.strip().lower() == "no" else 0.0

    if gt != "yes":
        return 0.0

    reward = 0.0

    pred_type = extract_tag("type", content)
    gt_type = extract_tag("type", solution)
    if pred_type is not None and gt_type is not None:
        reward += scorer.score(pred_type.strip().lower(), gt_type.strip().lower())

    pred_loc = extract_tag("location", content)
    gt_loc = extract_tag("location", solution)
    if pred_loc is not None and gt_loc is not None:
        reward += location_score(pred_loc.strip().lower(), gt_loc.strip().lower())

    reward /= 2.0  # max_reward normalization (reward.py:63,92)

    answer = extract_tag("answer", content)
    if answer is not None and answer.strip().lower() == "yes":
        reward += 1.0
    return reward


_DEFAULT_SCORER = AnomalyTypeScorer()


def accuracy_reward(completions, solution, **kwargs) -> list[float]:
    """Batch wrapper with the trainer-facing signature."""
    return [
        score_accuracy(content, sol, _DEFAULT_SCORER)
        for content, sol in zip(completion_texts(completions), solution)
    ]
