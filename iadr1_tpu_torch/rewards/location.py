"""Location reward: free-text position -> 3x3 grid cell equality.

Both the prediction and the ground truth are mapped onto a 3x3 grid numbered
1..9 row-major with 5 = center.  Directional keywords shift from the center:
left/right move one column, top|upper / bottom|lower move one row.  The score
is 1 iff both land on the same cell.

Behavior-compatible with ``map_location_to_region`` in the reference
(train/stage_rl/reward_process/location_reward.py:1-49).
"""

from __future__ import annotations


def location_cell(text: str) -> int:
    """Map a free-text location description to a 3x3 grid cell (1..9)."""
    t = text.lower().strip()
    cell = 5
    if "left" in t:
        cell -= 1
    elif "right" in t:
        cell += 1
    if "top" in t or "upper" in t:
        cell -= 3
    elif "bottom" in t or "lower" in t:
        cell += 3
    return max(1, min(9, cell))


def location_score(predicted: str, actual: str) -> int:
    """1 iff both location descriptions map to the same grid cell."""
    return 1 if location_cell(predicted) == location_cell(actual) else 0
