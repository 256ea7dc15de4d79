"""MCQ parsing and answer extraction for the benchmark harness (the port's
own copy of iadr1_tpu/eval/mcq.py, quirks included).

The benchmark JSONs map ``image_path -> {conversation: [{Question, Answer,
Options, type}], similar_templates, random_templates}``.  Questions are
rendered as "Question N: <text>\\n A. ...\\n B. ...\\n" blocks and model
responses are mapped back to option letters.

Behavior-compatible with GPT4Query.parse_conversation (GPT4/gpt4v.py:123-169)
and get_ans (scripts/Inference/IAD-R1-Inference/
vLLM_Qwen_detect_format.py:143-169).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class MCQQuestion:
    text: str                      # rendered "Question N: ...\n<options>" block
    options: dict[str, str]        # letter -> option text
    answer: str                    # correct option letter
    question_type: str = ""        # e.g. "Anomaly Detection"
    raw_question: str = ""         # unrendered question text
    extras: dict = field(default_factory=dict)


def parse_conversation(sample: dict) -> list[MCQQuestion]:
    """Render every QA turn of the first ``conversation*`` key in ``sample``.

    Option order is preserved (the reference's shuffle is commented out) and
    letters are re-assigned A, B, C... in that order; the correct letter is
    remapped accordingly.
    """
    questions: list[MCQQuestion] = []
    for key in sample.keys():
        if not key.startswith("conversation"):
            continue
        for i, qa in enumerate(sample[key]):
            items = list(qa["Options"].items())
            options_text = ""
            new_answer = None
            options: dict[str, str] = {}
            for j, (orig_key, value) in enumerate(items):
                letter = chr(65 + j)
                options_text += f"{letter}. {value}\n"
                options[letter] = value
                if qa["Answer"] == orig_key:
                    new_answer = letter
            if new_answer is None:
                raise ValueError(
                    f"Answer key {qa['Answer']!r} not present in options"
                )
            questions.append(
                MCQQuestion(
                    text=f"Question {i + 1}: {qa['Question']} \n{options_text}",
                    options=options,
                    answer=new_answer,
                    question_type=qa.get("type", ""),
                    raw_question=qa["Question"],
                )
            )
        break  # only the first conversation key, as in the reference
    return questions


_ANSWER_TAG_RE = re.compile(r"<answer>(.*?)</answer>")


def extract_option_answer(response_text: str, options: dict[str, str] | None = None) -> str:
    """Map a model response to an option letter.

    Pipeline (vLLM_Qwen_detect_format.py:143-169): take the ``<answer>`` tag
    payload, try exact match against option texts (case/period-insensitive),
    then bidirectional substring matching, else return 'E'.  A missing
    ``<answer>`` tag also yields 'E'.  With no options supplied, returns the
    lowercased payload itself.
    """
    m = _ANSWER_TAG_RE.search(response_text)
    if m is None:
        return "E"
    answer = m.group(1).strip().lower()
    if options is None:
        return answer
    for letter, value in options.items():
        if answer == value.lower().strip("."):
            return letter
    for letter, value in options.items():
        clean = value.lower().strip(".").strip()
        if answer in clean or clean in answer:
            return letter
    return "E"


def extract_option_answer_pretrain(
    response_text: str, options: dict[str, str] | None = None
) -> str:
    """Tag-free answer mapping for base-model (pretrain) checkpoints.

    Mirrors the Pretrain-Inference scripts' get_ans
    (scripts/Inference/Pretrain-Inference/vLLM_Qwen_detect.py:141-161):
    the whole response is the answer (no <answer> tag); exact match strips
    trailing '.' or '!'; the substring fallback compares the *raw-case*
    response against lowercased option text (reference quirk, kept for
    behavior parity); else 'E'.
    """
    try:
        if options is None:
            return response_text
        for letter, value in options.items():
            v = value.lower().strip(".")
            if (response_text.lower().strip(".") == v
                    or response_text.lower().strip("!") == v):
                return letter
        for letter, value in options.items():
            clean = value.lower().strip(".").strip()
            if response_text in clean or clean in response_text:
                return letter
        return "E"
    except (AttributeError, TypeError):
        return "E"
