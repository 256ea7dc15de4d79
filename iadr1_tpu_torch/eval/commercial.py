"""Commercial-API eval client for the GPT-4V/Claude/Qwen-VL-MAX benchmark
(the port's own copy of iadr1_tpu/eval/commercial.py; host code, no
device).

Behavior-compatible with the reference's GPT4Query (GPT4/gpt4v.py:50-395)
and the Commercial-Inference scripts (scripts/Inference/
Commercial-Inference/*.py): base64-JPEG images resized into a 512x512 box,
an OpenAI-style chat payload with the industrial-inspector instruction,
retry with exponential backoff (gpt4v.py:83-121), refusal-keyword retry,
per-question incremental querying, and [A-E]-letter answer parsing with
difflib fuzzy fallback (gpt4v.py:218-239).

The transport is pluggable (``transport(payload, headers) -> dict``) so the
client is fully offline-testable; the default transport uses ``requests``,
imported when it is first called.  Parsing comes from the port's
eval/mcq.py and the accuracy CSV from its eval/summary.py (no pandas).
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import re
import time
from difflib import get_close_matches
from typing import Callable, Sequence

# data contract: the reference's system instruction, verbatim
# (GPT4/gpt4v.py:29-32)
INSTRUCTION = """
You are an industrial inspector who checks products by images. You should judge whether there is a defect in the query image and answer the questions about it.
Answer with the option's letter from the given choices directly.
"""

# responses containing these are refusals and must be retried
# (GPT4/gpt4v.py:23)
ERROR_KEYWORDS = ("please", "sorry", "today", "cannot assist")

_ANSWER_RE = re.compile(r"\b([A-E])\b")


@dataclasses.dataclass
class APIConfig:
    url: str = "https://api.openai.com/v1/chat/completions"
    api_key: str = "YOUR_API_KEY"
    model: str = "gpt-4o"
    max_tokens: int = 600
    max_image_size: tuple[int, int] = (512, 512)
    max_retries: int = 3
    detail: str = "low"


def default_transport(payload: dict, headers: dict, url: str) -> dict:
    try:
        import requests
    except ImportError as e:
        raise ImportError(
            "the default transport requires the requests package; pass "
            "transport= to use another client") from e

    return requests.post(url, headers=headers, json=payload).json()


def encode_image_to_base64(image, max_size=(512, 512)) -> str:
    """PIL image -> base64 JPEG scaled to fit ``max_size`` (aspect kept,
    upscaling allowed -- gpt4v.py:62-72 uses the same min-scale rule)."""
    w, h = image.size
    scale = min(max_size[0] / w, max_size[1] / h)
    resized = image.resize((int(w * scale), int(h * scale)))
    buf = io.BytesIO()
    resized.convert("RGB").save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def parse_answer(response_text: str, options: dict | None = None) -> list[str]:
    """Extract option letters; difflib fuzzy fallback over option values
    when no letter is present (gpt4v.py:218-239)."""
    answers = _ANSWER_RE.findall(response_text)
    if not answers and options is not None:
        values = list(options.values())
        closest = get_close_matches(response_text, values, n=1, cutoff=0.0)
        if closest:
            for key, value in options.items():
                if value == closest[0]:
                    answers.append(key)
                    break
    return answers


class CommercialQuery:
    """One image's QA loop against a commercial chat-completions API."""

    def __init__(self, cfg: APIConfig, image_path: str, text_gt: dict,
                 few_shot: Sequence[str] = (),
                 transport: Callable | None = None,
                 sleep: Callable = time.sleep):
        self.cfg = cfg
        self.image_path = image_path
        self.text_gt = text_gt
        self.few_shot = list(few_shot)
        self.transport = transport or (
            lambda payload, headers: default_transport(payload, headers, cfg.url)
        )
        self.sleep = sleep
        self.api_time_cost = 0.0

    # --- request plumbing ---------------------------------------------------

    def send_request_to_api(self, payload: dict) -> dict | None:
        """Retry loop: exponential backoff on transport errors, plain retry
        on empty choices / refusal keywords (gpt4v.py:83-121)."""
        headers = {
            "Content-Type": "application/json",
            "Authorization": f"Bearer {self.cfg.api_key}",
        }
        retry_delay = 1.0
        retries = 0
        while retries < self.cfg.max_retries:
            try:
                before = time.time()
                response = self.transport(payload, headers)
                choices = response.get("choices", [])
                if choices:
                    content = choices[0]["message"]["content"]
                    if any(w in content.lower() for w in ERROR_KEYWORDS):
                        retries += 1
                        continue
                    self.api_time_cost += time.time() - before
                    return response
                retries += 1
            except Exception:
                self.sleep(retry_delay)
                retry_delay *= 2  # exponential backoff
                retries += 1
        return None

    @staticmethod
    def parse_json(response_json: dict) -> str:
        choices = response_json.get("choices", [])
        if choices:
            return choices[0].get("message", {})["content"]
        return ""

    # --- payload construction ------------------------------------------------

    def _image_part(self, path: str) -> dict:
        from PIL import Image

        with Image.open(path) as im:
            b64 = encode_image_to_base64(im, self.cfg.max_image_size)
        return {
            "type": "image_url",
            "image_url": {
                "url": f"data:image/jpeg;base64,{b64}",
                "detail": self.cfg.detail,
            },
        }

    def get_query(self, conversation: list[dict]) -> dict:
        """OpenAI chat payload: instruction + few-shot normals + query image
        + question list (gpt4v.py:325-395)."""
        incontext: list[dict] = []
        if self.few_shot:
            incontext.append({
                "type": "text",
                "text": f"Following is {len(self.few_shot)} image of normal "
                        "sample, which can be used as a template to compare.",
            })
            for ref in self.few_shot:
                incontext.append(self._image_part(ref))
        return {
            "model": self.cfg.model,
            "messages": [
                {"role": "system",
                 "content": [{"type": "text", "text": INSTRUCTION}]},
                {"role": "user",
                 "content": incontext + [
                     {"type": "text", "text": "Following is the query image: "},
                     self._image_part(self.image_path),
                     {"type": "text", "text": "Following is the question list: "},
                 ] + conversation},
            ],
            "max_tokens": self.cfg.max_tokens,
        }

    # --- QA loop --------------------------------------------------------------

    def generate_answer(self):
        """Ask question i with questions[:i+1] as context; returns
        (questions, gt_answers, api_answers) (gpt4v.py:262-283)."""
        from iadr1_tpu_torch.eval.mcq import parse_conversation

        parsed = parse_conversation(self.text_gt)
        if not parsed:
            return [], [], None
        questions = [
            {"type": "text", "text": q.text, "options": q.options}
            for q in parsed
        ]
        answers = [q.answer for q in parsed]

        api_answers: list[str] = []
        for i in range(len(questions)):
            part = [
                {k: v for k, v in q.items() if k != "options"}
                for q in questions[: i + 1]
            ]
            payload = self.get_query(part)
            respond = self.send_request_to_api(payload)
            if respond is None:
                api_answers.append("")
                continue
            text = self.parse_json(respond)
            letters = parse_answer(text, questions[i]["options"])
            api_answers.append(letters[-1] if letters else "")
        return questions, answers, api_answers


def run_commercial_eval(
    test_json: str,
    image_dir: str,
    cfg: APIConfig,
    output_dir: str,
    transport: Callable | None = None,
    few_shot: int = 0,
    max_items: int | None = None,
) -> str:
    """The benchmark run: resumable answers JSON + accuracy CSV, mirroring
    the Commercial-Inference scripts (answers schema identical to the vLLM
    scripts so helper/summary.py-compatible scoring applies)."""
    from iadr1_tpu_torch.eval.mcq import parse_conversation
    from iadr1_tpu_torch.eval.summary import summarize_answers_file

    with open(test_json) as f:
        data = json.load(f)
    os.makedirs(output_dir, exist_ok=True)
    answers_path = os.path.join(
        output_dir, f"answers_{few_shot}_shot.json"
    )
    existing = []
    if os.path.exists(answers_path):
        with open(answers_path) as f:
            existing = json.load(f)
    done = {a["image"] for a in existing}

    items = list(data.items())
    if max_items:
        items = items[:max_items]
    for image_rel, text_gt in items:
        if image_rel in done:
            continue  # resumable: skip already-answered images
        shots = [
            os.path.join(image_dir, p)
            for p in text_gt.get("similar_templates", [])[:few_shot]
        ]
        query = CommercialQuery(
            cfg, os.path.join(image_dir, image_rel), text_gt,
            few_shot=shots, transport=transport,
        )
        _, gt_answers, api_answers = query.generate_answer()
        if api_answers is None:
            continue
        parsed = parse_conversation(text_gt)
        for q, gt, got in zip(parsed, gt_answers, api_answers):
            existing.append({
                "image": image_rel,
                "question": q.raw_question,
                "question_type": q.question_type,
                "correct_answer": gt,
                "gpt_answer": got or "E",
            })
        tmp = answers_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(existing, f, indent=1)
        os.replace(tmp, answers_path)  # atomic, crash-resumable

    summarize_answers_file(answers_path)
    return answers_path
