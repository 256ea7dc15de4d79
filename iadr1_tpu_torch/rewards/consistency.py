"""Structural-consistency ("format") reward.

Checks that the completion's structure matches the ground-truth verdict:
a "yes" ground truth demands think+location+type+answer in that exact order
with no separators between adjacent closing/opening tags; a "no" ground truth
demands think+answer and forbids any location/type tag anywhere.

Behavior-compatible with ``consistency_reward`` in the reference
(train/stage_rl/reward.py:13-30); patterns are full-matched with DOTALL so
tag payloads may span lines but the inter-tag glue must be empty.
"""

from __future__ import annotations

import re

from iadr1_tpu_torch.rewards.structure import completion_texts, extract_answer

# Normal (gt == "no"): think then answer, adjacent; no <location>/<type>
# anywhere in the completion (negative lookaheads). reward.py:14
_NO_PATTERN = re.compile(
    r"^(?!.*<location>)(?!.*<type>).*<think>.*?</think><answer>.*?</answer>.*$",
    re.DOTALL,
)

# Anomalous (gt == "yes"): think, location, type, answer, all adjacent.
# reward.py:15
_YES_PATTERN = re.compile(
    r".*<think>.*?</think><location>.*?</location>"
    r"<type>.*?</type><answer>.*?</answer>.*",
    re.DOTALL,
)


def score_consistency(content: str, solution: str) -> float:
    """Per-sample structural consistency score in {0.0, 1.0}."""
    ground_truth = extract_answer(solution).lower()
    if ground_truth == "yes":
        return 1.0 if _YES_PATTERN.fullmatch(content) else 0.0
    if ground_truth == "no":
        return 1.0 if _NO_PATTERN.fullmatch(content) else 0.0
    # The reference silently skips samples whose ground truth is neither
    # yes nor no (which would crash its trainer on a length mismatch);
    # we score them 0.0 instead so the batch stays rectangular.
    return 0.0


def consistency_reward(completions, solution, **kwargs) -> list[float]:
    """Batch wrapper with the trainer-facing signature."""
    return [
        score_consistency(content, sol)
        for content, sol in zip(completion_texts(completions), solution)
    ]
