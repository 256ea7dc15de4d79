"""MMLU-style MCQ evaluator via choice-letter logits (the port's own copy
of iadr1_tpu/eval/mmlu.py).

The counterpart of the reference's llamafactory Evaluator
(eval/evaluator.py:59-124 + eval/template.py): examples are
{"question", "A".."D", "answer"} rows grouped by subject; the prompt is
"<system about subject>\n\n<n-shot examples>\n<question + choices>Answer:"
and the prediction is argmax over the logits of the choice-letter tokens
at the last prompt position (no generation).

Offline-first: subjects come from a local directory of
``<subject>.json`` files, each {"train": [...], "test": [...]}, plus an
optional ``mapping.json`` ({subject: {"name", "category"}}).

The prompt batch runs once through the bundle's ``hidden_fn`` (K1 on the
card, causal and segment-masked; no generation, so no K4), and the four
choice logits are the f32 product of the last prompt position's hidden
state with the head kernel's raw choice columns, both upcast unrounded
as in JAX (``qwen2.logits`` rounds the kernel to the compute dtype first).
The n-shot support sets are drawn with numpy's ``default_rng(seed)`` in
subject order, so that they are JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from iadr1_tpu_torch.core.device import resolve_device

CHOICES = ("A", "B", "C", "D")

# the reference eval templates (eval/template.py registry): "en" for
# MMLU, "zh" for CMMLU / C-Eval
EVAL_TEMPLATES = {
    "en": dict(
        system=("The following are multiple choice questions (with "
                "answers) about {subject}.\n\n"),
        choice="\n{choice}. {content}",
        answer="\nAnswer:",
    ),
    "zh": dict(
        system="以下是中国关于{subject}考试的单项选择题，请选出其中的正确答案。\n\n",
        choice="\n{choice}. {content}",
        answer="\n答案：",
    ),
}

# kept for compatibility with earlier call sites
EN_SYSTEM = EVAL_TEMPLATES["en"]["system"]
EN_CHOICE = EVAL_TEMPLATES["en"]["choice"]
EN_ANSWER = EVAL_TEMPLATES["en"]["answer"]


def format_example(example: dict, support_set: Sequence[dict],
                   subject_name: str, lang: str = "en") -> tuple[str, str]:
    """(prompt_text, answer_letter) with n-shot support examples inlined
    (eval/template.py _parse_example + format_example); ``lang`` picks the
    en (MMLU) or zh (CMMLU/C-Eval) template."""
    tpl = EVAL_TEMPLATES[lang]

    def one(ex):
        cands = [tpl["choice"].format(choice=c, content=ex[c])
                 for c in CHOICES if c in ex]
        return ("".join([ex["question"]] + cands + [tpl["answer"]]),
                ex["answer"])

    parts = [tpl["system"].format(subject=subject_name)]
    for ex in support_set:
        p, a = one(ex)
        parts.append(p + " " + a + "\n\n")
    p, a = one(example)
    parts.append(p)
    return "".join(parts), a


@dataclasses.dataclass
class MMLUEvaluator:
    """Choice-logit evaluation over a bundle + params, on ``device`` (the
    card unless given)."""

    bundle: object
    params: object
    tokenizer: object
    max_length: int = 1024
    batch_size: int = 4
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # last sub-token of each choice letter (evaluator.py:71)
        self.choice_ids = [
            self.tokenizer.encode(c, add_special_tokens=False)[-1]
            for c in CHOICES
        ]

    @torch.no_grad()
    def _logits(self, params, batch) -> torch.Tensor:
        """[B, 4] f32 choice logits at each row's last prompt position."""
        hidden = self.bundle.hidden_fn(params, batch, remat=False)
        lengths = batch["segment_ids"].sum(dim=1)
        idx = (lengths - 1).clamp(min=0)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      idx]                                # [B, H]
        kernel = self.bundle.head_kernel_fn(params)       # [H, V]
        choice_kernel = kernel[:, torch.as_tensor(self.choice_ids,
                                                  device=kernel.device)]
        return last.float() @ choice_kernel.float()

    def encode_batch(self, prompts: Sequence[str]) -> dict:
        """Prompts -> one batch of device tensors, right-padded to
        ``max_length`` with positions running across the padding."""
        pad = self.tokenizer.pad_token_id or self.tokenizer.eos_token_id or 0
        enc = [self.tokenizer.encode(p)[-self.max_length:] for p in prompts]
        T = self.max_length
        ids = np.full((len(enc), T), pad, np.int64)
        segs = np.zeros((len(enc), T), np.int32)
        for j, e in enumerate(enc):
            ids[j, : len(e)] = e
            segs[j, : len(e)] = 1
        batch = {
            "input_ids": ids, "segment_ids": segs,
            "position_ids": np.broadcast_to(np.arange(T),
                                            (len(enc), T)).copy(),
        }
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def predict(self, prompts: Sequence[str]) -> list[str]:
        out = []
        for i in range(0, len(prompts), self.batch_size):
            batch = self.encode_batch(prompts[i : i + self.batch_size])
            scores = self._logits(self.params, batch).cpu().numpy()
            out.extend(CHOICES[k] for k in scores.argmax(axis=1))
        return out

    def eval_task(self, task_dir: str, split: str = "test", n_shot: int = 0,
                  save_dir: str | None = None, seed: int = 42,
                  lang: str = "en") -> dict:
        """Evaluate every ``<subject>.json`` under task_dir; returns and
        optionally saves per-category accuracies (evaluator.py:78-124)."""
        mapping_path = os.path.join(task_dir, "mapping.json")
        if os.path.exists(mapping_path):
            with open(mapping_path) as f:
                mapping = json.load(f)
        else:
            mapping = {
                os.path.splitext(f)[0]: {"name": os.path.splitext(f)[0],
                                         "category": "Average"}
                for f in sorted(os.listdir(task_dir)) if f.endswith(".json")
            }
        rng = np.random.default_rng(seed)
        category_corrects: dict[str, list[bool]] = {"Average": []}
        results = {}
        for subject, meta in mapping.items():
            with open(os.path.join(task_dir, f"{subject}.json")) as f:
                data = json.load(f)
            train, test = data.get("train", []), data.get(split, [])
            prompts, labels = [], []
            for ex in test:
                if train and n_shot:
                    pick = rng.permutation(len(train))[: n_shot]
                    support = [train[int(k)] for k in pick]
                else:
                    support = []
                p, a = format_example(ex, support, meta.get("name", subject),
                                      lang=lang)
                prompts.append(p)
                labels.append(a)
            preds = self.predict(prompts)
            corrects = [p == l for p, l in zip(preds, labels)]
            category = meta.get("category", "Average")
            category_corrects.setdefault(category, []).extend(corrects)
            if category != "Average":
                category_corrects["Average"].extend(corrects)
            results[subject] = {str(i): p for i, p in enumerate(preds)}

        score_info = {
            cat: round(100.0 * float(np.mean(c)), 2)
            for cat, c in category_corrects.items() if c
        }
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "results.json"), "w") as f:
                json.dump({"results": results, "scores": score_info}, f,
                          indent=2)
        return score_info
