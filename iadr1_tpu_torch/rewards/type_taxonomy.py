"""Anomaly-type reward: tiered matching against an 8-category taxonomy.

Scoring tiers (reference reward_config, reward_process/type_reward.py:61-68):

* 1.00  exact   -- normalized strings equal
* 0.85  semantic -- one normalized string contains the other
* 0.60..0.85 category -- both resolve to the same taxonomy category; blended
  upward by the weaker resolution confidence
* 0.40 x sim  fuzzy -- SequenceMatcher ratio >= 0.7
* 0.30  group  -- same coarse group (Surface vs Structural), or one side
  names a group and the other side's category belongs to it
* 0.00  otherwise, and always when the two sides resolve to *different*
  groups (checked before every other tier)

Behavior-compatible with ``AnomalyRewardCalculator`` in the reference
(train/stage_rl/reward_process/type_reward.py:5-232), validated by golden
tests produced by running the reference implementation.
"""

from __future__ import annotations

import re
from difflib import SequenceMatcher

# --- taxonomy fact tables (data, mirrored from type_reward.py:9-58) -------

CATEGORY_SYNONYMS: dict[str, tuple[str, ...]] = {
    "Contamination": (
        "surface contamination", "stain", "dirt", "impurity", "color anomaly",
    ),
    "Presence of foreign objects": (
        "foreign object", "foreign body", "debris", "contaminant object",
        "extraneous material", "foreign element", "foreign matter",
        "unwanted object",
    ),
    "Scratch": (
        "surface scratch", "scratch mark", "linear scratch", "score mark",
        "linear anomaly",
    ),
    "Missing parts": (
        "missing part", "surface notch", "notch", "gap", "chip",
        "surface discontinuity",
    ),
    "Deformation": (
        "shape distortion", "warping", "bending", "twisting",
        "shape deviation", "geometric distortion", "irregularity",
        "bent component",
    ),
    "Hole": (
        "opening", "perforation", "puncture", "cavity", "void", "aperture",
        "penetration defect", "through-hole",
    ),
    "Damage": (
        "structural damage", "breakage", "fracture", "rupture",
        "deterioration", "material damage", "surface damage",
    ),
    "Abrasion": (
        "wear", "grinding damage", "surface erosion", "wear mark",
        "surface wear",
    ),
}

GROUP_MEMBERS: dict[str, tuple[str, ...]] = {
    "Surface Anomalies": (
        "Contamination", "Presence of foreign objects", "Scratch",
        "Missing parts",
    ),
    "Structural Anomalies": ("Deformation", "Hole", "Damage", "Abrasion"),
}

GROUP_ALIASES: dict[str, tuple[str, ...]] = {
    "Surface Anomalies": ("surface anomalies", "surface anomaly"),
    "Structural Anomalies": ("structural anomalies", "structural anomaly"),
}

SCORE_EXACT = 1.0
SCORE_SEMANTIC = 0.85
SCORE_CATEGORY = 0.6
SCORE_FUZZY = 0.4
SCORE_GROUP = 0.3
FUZZY_THRESHOLD = 0.7

_WS_RE = re.compile(r"\s+")
_PUNCT_RE = re.compile(r"[^\w\s-]")


def normalize(text: str) -> str:
    """Lowercase, collapse whitespace, drop punctuation except hyphens."""
    if not text:
        return ""
    text = _WS_RE.sub(" ", text.lower().strip())
    return _PUNCT_RE.sub("", text)


class AnomalyTypeScorer:
    """Stateless tiered matcher over the anomaly taxonomy.

    Construction builds the keyword/group lookup indices once; reuse a single
    instance across a batch (the reference constructs one per sample, which
    is pure overhead -- the tables are constants).
    """

    def __init__(self) -> None:
        self._keyword_to_category: dict[str, str] = {}
        for category, synonyms in CATEGORY_SYNONYMS.items():
            self._keyword_to_category[normalize(category)] = category
            for syn in synonyms:
                self._keyword_to_category[normalize(syn)] = category

        self._category_to_group: dict[str, str] = {}
        for group, categories in GROUP_MEMBERS.items():
            for category in categories:
                self._category_to_group[category] = group

        self._alias_to_group: dict[str, str] = {}
        for group, aliases in GROUP_ALIASES.items():
            self._alias_to_group[normalize(group)] = group
            for alias in aliases:
                self._alias_to_group[normalize(alias)] = group

    # --- resolution ------------------------------------------------------

    def resolve_category(self, text: str) -> tuple[str | None, float]:
        """Resolve free text to (category, confidence).

        Resolution order mirrors type_reward._find_best_match (:123-147):
        exact keyword hit (confidence 1.0), then best substring containment
        (confidence = len ratio), then best fuzzy keyword match above the
        threshold.  Fuzzy only runs when no containment hit exists.
        """
        norm = normalize(text)
        category = self._keyword_to_category.get(norm)
        if category is not None:
            return category, 1.0

        best_category: str | None = None
        best_conf = 0.0
        for keyword, cat in self._keyword_to_category.items():
            if norm in keyword or keyword in norm:
                shorter = min(len(norm), len(keyword))
                longer = max(len(norm), len(keyword))
                conf = shorter / longer
                if conf > best_conf:
                    best_conf, best_category = conf, cat
        if best_category is not None:
            return best_category, best_conf

        for keyword, cat in self._keyword_to_category.items():
            sim = SequenceMatcher(None, norm, keyword).ratio()
            if sim >= FUZZY_THRESHOLD and sim > best_conf:
                best_conf, best_category = sim, cat
        return best_category, best_conf

    def group_of_text(self, text: str) -> str | None:
        """Group named directly in the text (exact alias match only)."""
        if not text:
            return None
        return self._alias_to_group.get(normalize(text))

    def group_of_category(self, category: str | None) -> str | None:
        if category is None:
            return None
        return self._category_to_group.get(category)

    # --- scoring ---------------------------------------------------------

    def score(self, predicted: str, actual: str) -> float:
        """Tiered type score in [0, 1]; see module docstring for tiers."""
        if not predicted or not actual:
            return 0.0

        pred_norm = normalize(predicted)
        actual_norm = normalize(actual)

        pred_group_text = self.group_of_text(predicted)
        actual_group_text = self.group_of_text(actual)
        pred_cat, pred_conf = self.resolve_category(predicted)
        actual_cat, actual_conf = self.resolve_category(actual)
        pred_group = pred_group_text or self.group_of_category(pred_cat)
        actual_group = actual_group_text or self.group_of_category(actual_cat)

        # Hard gate: resolvable groups that disagree zero the reward,
        # regardless of how similar the surface strings are
        # (type_reward.py:185-186).
        if pred_group and actual_group and pred_group != actual_group:
            return 0.0

        # One side names only a coarse group and the other side's category
        # falls inside it (type_reward.py:188-192).
        if pred_group_text and not actual_group_text and actual_group == pred_group_text:
            return SCORE_GROUP
        if actual_group_text and not pred_group_text and pred_group == actual_group_text:
            return SCORE_GROUP

        if pred_norm == actual_norm:
            return SCORE_EXACT

        if pred_norm in actual_norm or actual_norm in pred_norm:
            return SCORE_SEMANTIC

        if pred_cat is None or actual_cat is None:
            sim = SequenceMatcher(None, pred_norm, actual_norm).ratio()
            return sim * SCORE_FUZZY if sim >= FUZZY_THRESHOLD else 0.0

        if pred_cat == actual_cat:
            # Blend upward from the category base by the weaker confidence
            # (type_reward.py:216-219).
            conf = min(pred_conf, actual_conf)
            return SCORE_CATEGORY + (SCORE_SEMANTIC - SCORE_CATEGORY) * conf

        if (
            self.group_of_category(pred_cat) is not None
            and self.group_of_category(pred_cat) == self.group_of_category(actual_cat)
        ):
            return SCORE_GROUP

        sim = SequenceMatcher(None, pred_norm, actual_norm).ratio()
        return sim * SCORE_FUZZY if sim >= FUZZY_THRESHOLD else 0.0


_DEFAULT_SCORER = AnomalyTypeScorer()


def type_score(predicted: str, actual: str) -> float:
    """Module-level convenience using a shared scorer instance."""
    return _DEFAULT_SCORER.score(predicted, actual)
