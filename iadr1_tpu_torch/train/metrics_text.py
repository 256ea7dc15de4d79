"""Text-similarity eval metrics for SFT predict/eval (the port's own copy
of iadr1_tpu/train/metrics_text.py).

Counterpart of the reference's ComputeAccuracy / ComputeSimilarity
(train/sft/metric.py:63-139): token accuracy is already a first-class
metric of the chunked CE loss (train/sft.py); this module covers the
predict_with_generate side -- ROUGE-1/2/L f-scores over jieba-segmented
text and BLEU-4 over character lists with NLTK method3 smoothing, each
scaled x100 and rounded to 4 decimals exactly as the reference logs them.

BLEU uses the same nltk call as the reference.  ``jieba`` and ``nltk``
are imported inside ``similarity_scores``; a missing one raises an
ImportError that names it.  ROUGE is first-party: the reference's
rouge-chinese package is a py-rouge fork computing standard ROUGE-N
(f = 2pr/(p+r) on n-gram multiset overlap of whitespace-split tokens) and
ROUGE-L (LCS-based f); both are reimplemented from the published
formulas.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence


def _ngram_f(hyp: list[str], ref: list[str], n: int) -> float:
    if len(hyp) < n or len(ref) < n:
        return 0.0
    hc = Counter(tuple(hyp[i : i + n]) for i in range(len(hyp) - n + 1))
    rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    overlap = sum((hc & rc).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(hc.values()), 1)
    r = overlap / max(sum(rc.values()), 1)
    return 2 * p * r / (p + r)


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        curr = [0]
        for j, y in enumerate(b, 1):
            curr.append(prev[j - 1] + 1 if x == y else max(prev[j], curr[-1]))
        prev = curr
    return prev[-1]


def _rouge_l_f(hyp: list[str], ref: list[str]) -> float:
    lcs = _lcs_len(hyp, ref)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(hyp), lcs / len(ref)
    return 2 * p * r / (p + r)


def similarity_scores(
    preds: Sequence[str], labels: Sequence[str]
) -> dict[str, float]:
    """Mean rouge-1/rouge-2/rouge-l/bleu-4 over prediction/label pairs.

    Segmentation and scaling mirror the reference ComputeSimilarity: ROUGE
    over jieba-cut word sequences (empty segmentations score 0), BLEU-4
    over raw character lists with SmoothingFunction().method3.
    """
    try:
        import jieba
        from nltk.translate.bleu_score import SmoothingFunction, sentence_bleu
    except ImportError as e:
        raise ImportError(
            "similarity_scores requires the jieba and nltk packages: "
            f"{e}") from e

    score_dict: dict[str, list[float]] = {
        "rouge-1": [], "rouge-2": [], "rouge-l": [], "bleu-4": []
    }
    smooth = SmoothingFunction().method3
    for pred, label in zip(preds, labels):
        hyp = list(jieba.cut(pred))
        ref = list(jieba.cut(label))
        hyp_tokens = " ".join(hyp).split()
        ref_tokens = " ".join(ref).split()
        if not hyp_tokens or not ref_tokens:
            r1 = r2 = rl = 0.0
        else:
            r1 = _ngram_f(hyp_tokens, ref_tokens, 1)
            r2 = _ngram_f(hyp_tokens, ref_tokens, 2)
            rl = _rouge_l_f(hyp_tokens, ref_tokens)
        score_dict["rouge-1"].append(round(r1 * 100, 4))
        score_dict["rouge-2"].append(round(r2 * 100, 4))
        score_dict["rouge-l"].append(round(rl * 100, 4))
        bleu = sentence_bleu([list(label)], list(pred),
                             smoothing_function=smooth)
        score_dict["bleu-4"].append(round(bleu * 100, 4))
    return {k: float(sum(v) / max(len(v), 1)) for k, v in score_dict.items()}
