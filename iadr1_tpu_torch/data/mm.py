"""Image-placeholder expansion (the port's own copy of the qwen2_vl and
plain styles of iadr1_tpu/data/mm.py ``expand_image_tokens``)."""

from __future__ import annotations

from typing import Sequence

IMAGE_PLACEHOLDER = "<image>"


def expand_image_tokens(messages: Sequence[dict], image_seqlens: Sequence[int],
                        mm_style: str, image_token: str) -> list[dict]:
    """Replace each ``<image>`` with the family's expanded token run:
    ``<|vision_start|>`` + image_token x N + ``<|vision_end|>`` for
    qwen2_vl, image_token x N for plain.  ``image_seqlens[i]`` is the
    feature count of the i-th image in reading order."""
    if mm_style not in ("qwen2_vl", "plain"):
        raise NotImplementedError(
            f"mm style {mm_style!r} is not ported yet (ROADMAP A.13)")
    out, idx = [], 0
    for message in messages:
        content = message["content"]
        while IMAGE_PLACEHOLDER in content:
            if idx >= len(image_seqlens):
                raise ValueError("more image placeholders than provided images")
            run = image_token * image_seqlens[idx]
            if mm_style == "qwen2_vl":
                run = f"<|vision_start|>{run}<|vision_end|>"
            content = content.replace(IMAGE_PLACEHOLDER, run, 1)
            idx += 1
        out.append({**message, "content": content})
    if idx != len(image_seqlens):
        raise ValueError(
            f"{len(image_seqlens)} images provided but {idx} placeholders found")
    return out
