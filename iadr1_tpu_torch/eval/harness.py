"""Benchmark inference harness: batch generation over the six IAD test sets
(the port's own copy of iadr1_tpu/eval/harness.py).

Behavior-compatible with the reference vLLM eval scripts
(scripts/Inference/IAD-R1-Inference/vLLM_Qwen_detect_format.py): load the
benchmark JSON (image_path -> {conversation, similar/random templates}),
build the chat prompt (optionally with few-shot template images), greedy
generation (temperature 0.0, max 512 tokens, :33-40,214-219), extract the
``<answer>`` tag to an option letter (:143-169), append to a *resumable*
answers JSON (skip already-answered images, :298-317), and summarize with
the balanced-accuracy scorer.

The generation backend is the same RolloutEngine the GRPO stage uses --
one engine for training rollouts and eval, replacing vLLM in both roles.
The pretrain mode's system turn reaches the generator as the first
message, which makes it the template's system block.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence

from iadr1_tpu_torch.eval.mcq import (
    MCQQuestion,
    extract_option_answer,
    parse_conversation,
)
from iadr1_tpu_torch.eval.summary import AccuracyTable, summarize_answers_file


# Default eval question, matching the reference script's hardcoded text
# (vLLM_Qwen_detect_format.py:116-120).
EVAL_QUESTION = "Are there any defects in the test image?"

FEW_SHOT_PREAMBLE = (
    "Following is {n} image of normal sample, "
    "which can be used as a template to compare the image being queried."
)
FEW_SHOT_TEST_MARKER = "Following is image of test sample:"


@dataclasses.dataclass
class EvalItem:
    image: str                      # relative image path (dataset key)
    question: MCQQuestion
    few_shot: list[str] = dataclasses.field(default_factory=list)


def load_benchmark(path: str, num_shot: int = 0,
                   template_key: str = "similar_templates") -> list[EvalItem]:
    """Benchmark JSON -> eval items (first question per image, as in the
    reference scripts, which slice questions[0:1], :52-54)."""
    with open(path) as f:
        data = json.load(f)
    items = []
    for image, sample in data.items():
        questions = parse_conversation(sample)
        if not questions:
            continue
        few_shot = list(sample.get(template_key) or [])[:num_shot]
        items.append(EvalItem(image=image, question=questions[0],
                              few_shot=few_shot))
    return items


PRETRAIN_SYSTEM_PROMPT = "Please answer by yes or no"  # Pretrain-Inference
# scripts prepend this system message (vLLM_Qwen_detect.py:87-90)


def build_messages(item: EvalItem, question_text: str | None = None,
                   system_prompt: str | None = None) -> list[dict]:
    """User message with image placeholders + the question (reference
    build_prompt, :88-128).  ``system_prompt`` prepends a system turn
    (pretrain-variant scripts)."""
    parts = []
    if item.few_shot:
        parts.append(FEW_SHOT_PREAMBLE.format(n=len(item.few_shot)))
        parts.extend("<image>" for _ in item.few_shot)
        parts.append(FEW_SHOT_TEST_MARKER)
    parts.append("<image>")
    parts.append(question_text or EVAL_QUESTION)
    messages = [{"role": "user", "content": "".join(parts)}]
    if system_prompt:
        messages.insert(0, {"role": "system", "content": system_prompt})
    return messages


def run_benchmark(
    items: Sequence[EvalItem],
    generate_fn: Callable[[Sequence[EvalItem]], list[str]],
    answers_path: str,
    batch_size: int = 4,
    save_every: int = 1,
    answer_extractor: Callable[[str, dict | None], str] | None = None,
) -> list[dict]:
    """Drive generation over items, resumably appending to answers_path.

    ``generate_fn(batch_items) -> list[str]`` produces raw model responses.
    """
    answers: list[dict] = []
    if os.path.exists(answers_path):
        with open(answers_path) as f:
            answers = json.load(f)
    done = {a["image"] for a in answers}
    todo = [it for it in items if it.image not in done]

    for i in range(0, len(todo), batch_size):
        batch = todo[i : i + batch_size]
        responses = generate_fn(batch)
        extractor = answer_extractor or extract_option_answer
        for item, resp in zip(batch, responses):
            letter = extractor(resp, item.question.options)
            answers.append({
                "image": item.image,
                "question": {"text": item.question.text},
                "question_type": item.question.question_type,
                "correct_answer": item.question.answer,
                "gpt_answer": letter,
                "response": resp,
            })
        if (i // batch_size) % save_every == 0:
            _atomic_write(answers_path, answers)
    _atomic_write(answers_path, answers)
    return answers


def _atomic_write(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def summarize(answers_path: str, normal_flag: str = "good",
              show_overkill_miss: bool = False) -> AccuracyTable:
    """Answers JSON -> accuracy CSV (reference: caculate_accuracy_mmad call
    at the script's end, :380-381)."""
    return summarize_answers_file(
        answers_path, normal_flag, show_overkill_miss
    )
