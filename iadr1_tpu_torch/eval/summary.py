"""Per-dataset x question-type accuracy summaries (the port's own copy of
iadr1_tpu/eval/summary.py, without pandas).

The headline metric is balanced accuracy for the "Anomaly Detection"
question type: mean(normal_acc, abnormal_acc) x 100, where a sample is
"normal" iff ``normal_flag`` appears in its image path.  The table has the
datasets and "Average" as rows, the question types and "Average" (and
"Overkill", "Miss" when asked) as columns.  ``AccuracyTable.to_csv``
writes the same bytes as pandas' ``DataFrame.to_csv`` of the JAX
package's table: the means are summed in pandas' order and the floats
written as their repr.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Iterable, Sequence

import numpy as np

VALID_LETTERS = frozenset("ABCDE")

# Question-type aliasing (helper/summary.py:19-20).
_TYPE_ALIASES = {
    "Object Structure": "Object Analysis",
    "Object Details": "Object Analysis",
}


def _canon_type(question_type: str) -> str:
    return _TYPE_ALIASES.get(question_type, question_type)


def _ratio(correct: int, total: int):
    return correct / total if total else 0


def _row_means(a: np.ndarray) -> np.ndarray:
    """Mean across the columns of each row, summed as pandas sums
    ``DataFrame.mean(axis=1)``: along a row of a column-major array."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.asfortranarray(a).sum(axis=1) / a.shape[1]


def _col_means(a: np.ndarray) -> np.ndarray:
    """Mean down each column, summed as pandas sums ``DataFrame.mean()``:
    over a contiguous column."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.ascontiguousarray(a.T).sum(axis=1) / a.shape[0]


class AccuracyTable:
    """Rows x columns of float64 with labels: the table the JAX package
    keeps in a DataFrame."""

    def __init__(self, index: Sequence[str], columns: Sequence[str],
                 values: np.ndarray):
        self.index = list(index)
        self.columns = list(columns)
        self.values = np.asarray(values, np.float64).reshape(
            len(self.index), len(self.columns))

    def at(self, row: str, column: str) -> float:
        return float(self.values[self.index.index(row),
                                 self.columns.index(column)])

    def to_csv(self, path: str) -> None:
        """What ``DataFrame.to_csv(path)`` writes: an empty index header,
        floats as repr, NaN as an empty field."""
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow([""] + self.columns)
            for name, row in zip(self.index, self.values):
                writer.writerow([name] + [
                    "" if np.isnan(v) else repr(float(v)) for v in row])

    def to_string(self, decimals: int = 2) -> str:
        """Aligned text, values rounded to ``decimals`` places."""
        cells = [[""] + self.columns] + [
            [name] + [f"{v:.{decimals}f}" for v in row]
            for name, row in zip(self.index, self.values)]
        widths = [max(len(r[j]) for r in cells) for j in range(len(cells[0]))]
        return "\n".join(
            "  ".join(c.ljust(w) if j == 0 else c.rjust(w)
                      for j, (c, w) in enumerate(zip(r, widths)))
            for r in cells)


def summarize_answers(
    answers: Iterable[dict],
    normal_flag: str = "good",
    show_overkill_miss: bool = False,
) -> AccuracyTable:
    """Build the accuracy table from answer records.

    Each record needs ``image`` (path whose first component is the dataset
    name), ``question_type``, ``gpt_answer`` and ``correct_answer`` (option
    letters).  Records with out-of-range letters are dropped, as in the
    reference.
    """
    answers = [
        a for a in answers
        if a["correct_answer"] in VALID_LETTERS
        and a["gpt_answer"] in VALID_LETTERS
    ]

    dataset_names: list[str] = []
    type_list: list[str] = []
    for a in answers:
        ds = a["image"].split("/")[0]
        qt = _canon_type(a["question_type"])
        if ds not in dataset_names:
            dataset_names.append(ds)
        if qt not in type_list:
            type_list.append(qt)

    stats = {ds: {qt: [0, 0] for qt in type_list} for ds in dataset_names}
    detect = {ds: {"normal": [0, 0], "abnormal": [0, 0]}
              for ds in dataset_names}              # [correct, total]
    for a in answers:
        ds = a["image"].split("/")[0]
        qt = _canon_type(a["question_type"])
        correct = int(a["correct_answer"] == a["gpt_answer"])
        stats[ds][qt][0] += correct
        stats[ds][qt][1] += 1
        if qt == "Anomaly Detection":
            bucket = "normal" if normal_flag in a["image"] else "abnormal"
            detect[ds][bucket][0] += correct
            detect[ds][bucket][1] += 1

    def detect_accs(ds):
        return (_ratio(*detect[ds]["normal"]), _ratio(*detect[ds]["abnormal"]))

    table = np.zeros((len(dataset_names), len(type_list)))
    for i, ds in enumerate(dataset_names):
        for j, qt in enumerate(type_list):
            if qt == "Anomaly Detection":
                # balanced accuracy replaces the raw AD accuracy
                normal_acc, anomaly_acc = detect_accs(ds)
                table[i, j] = (normal_acc + anomaly_acc) / 2 * 100
            else:
                table[i, j] = _ratio(*stats[ds][qt]) * 100
    columns = type_list + ["Average"]
    table = np.concatenate([table, _row_means(table)[:, None]], axis=1)

    if show_overkill_miss and dataset_names:   # no rows, no columns added
        extra = np.zeros((len(dataset_names), 2))
        for i, ds in enumerate(dataset_names):
            normal_acc, anomaly_acc = detect_accs(ds)
            extra[i] = ((1 - normal_acc) * 100, (1 - anomaly_acc) * 100)
        columns += ["Overkill", "Miss"]
        table = np.concatenate([table, extra], axis=1)

    table = np.concatenate([table, _col_means(table)[None]], axis=0)
    return AccuracyTable(dataset_names + ["Average"], columns, table)


def summarize_mvtec_per_class(
    answers: Iterable[dict], normal_flag: str = "good"
) -> AccuracyTable:
    """Per-class MVTec-style accuracy table.

    Behavior-compatible with the reference's ``caculate_accuracy``
    (helper/summary.py:126-267): questions are numbered 1..5 per image
    (parsed from "Question N" in the text, else by position), anomalous
    images map them to [Existence, Defect Type, Defect Location, Defect
    Appearance, Other] while normal images map 1 -> Existence and the rest
    to Other; rows are classes plus an Average row; Overkill/Miss come from
    question 1.
    """
    anomaly_labels = ["Existence", "Defect Type", "Defect Location",
                      "Defect Appearance", "Other"]
    normal_labels = ["Existence", "Other", "Other", "Other", "Other"]
    labels = anomaly_labels

    stats: dict = {}
    q1: dict = {}
    last_image, q_num = "", 1
    for a in answers:
        cls = a["class"]
        if cls not in stats:
            stats[cls] = {label: [0, 0] for label in labels}
            q1[cls] = {"normal": [0, 0], "anomaly": [0, 0]}
        question = a.get("question")
        text = (question.get("text", "") if isinstance(question, dict)
                else str(a.get("question", "")))
        if "Question" in text:
            q_num = int(text.split("Question")[1].strip()[0])
        elif a["image"] == last_image:
            q_num += 1
        else:
            q_num = 1
        last_image = a["image"]
        if (a["correct_answer"] not in VALID_LETTERS
                or a["gpt_answer"] not in VALID_LETTERS):
            continue
        normal = normal_flag in a["image"]
        label = (normal_labels if normal else anomaly_labels)[q_num - 1]
        correct = int(a["correct_answer"] == a["gpt_answer"])
        stats[cls][label][0] += correct
        stats[cls][label][1] += 1
        if q_num == 1:
            bucket = q1[cls]["normal" if normal else "anomaly"]
            bucket[0] += correct
            bucket[1] += 1

    classes = list(stats)
    table = np.array([[_ratio(*stats[c][label]) for label in labels]
                      for c in classes], np.float64).reshape(-1, len(labels))
    extra = np.array([[1 - _ratio(*q1[c]["normal"]),
                       1 - _ratio(*q1[c]["anomaly"])] for c in classes],
                     np.float64).reshape(-1, 2)
    table = np.concatenate([table, _row_means(table)[:, None], extra], axis=1)
    table = np.concatenate([table, _col_means(table)[None]], axis=0)
    return AccuracyTable(classes + ["Average"],
                         labels + ["Average", "Overkill", "Miss"], table)


def summarize_answers_file(
    answers_json_path: str,
    normal_flag: str = "good",
    show_overkill_miss: bool = False,
    save_heatmap: bool = False,
) -> AccuracyTable:
    """Read the answers JSON, write the ``*_accuracy.csv`` sibling,
    optionally render the heatmap PNG."""
    with open(answers_json_path) as f:
        answers = json.load(f)
    table = summarize_answers(answers, normal_flag, show_overkill_miss)
    table.to_csv(answers_json_path.replace(".json", "_accuracy.csv"))

    if save_heatmap:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns

        plt.figure(figsize=(10, 7))
        sns.heatmap(table.values, annot=True, cmap="coolwarm", fmt=".1f",
                    vmax=100, vmin=25, xticklabels=table.columns,
                    yticklabels=table.index)
        title = os.path.split(answers_json_path)[-1].replace(".json", "")
        plt.title(f"Accuracy of {title}")
        plt.xticks(rotation=30, ha="right")
        plt.tight_layout()
        plt.savefig(answers_json_path.replace(".json", "_accuracy.png"))
        plt.close()
    return table
