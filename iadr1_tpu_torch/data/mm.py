"""Image-placeholder expansion (the port's own copy of the qwen2_vl, llava
and plain styles of iadr1_tpu/data/mm.py ``expand_image_tokens``).

Each placeholder is expanded into a run of a temporary character, which
becomes the image token only once the message is whole, as LLaMA-Factory's
LLaVA plugins do through ``{{image}}``.  The JAX function writes the image
token itself, so where that token is ``<image>`` (the llava_next_qwen
template) it reads its own output as further placeholders and raises
(ROADMAP C.R6); here an ``<image>`` of the text counts once.
"""

from __future__ import annotations

from typing import Sequence

IMAGE_PLACEHOLDER = "<image>"
# one image token, until the message is whole (a private-use code point)
_IMAGE_RUN = "\ue000"
MM_STYLES = ("qwen2_vl", "llava", "plain")


def expand_image_tokens(messages: Sequence[dict], image_seqlens: Sequence[int],
                        mm_style: str, image_token: str) -> list[dict]:
    """Replace each ``<image>`` with the family's expanded token run:
    ``<|vision_start|>`` + image_token x N + ``<|vision_end|>`` for
    qwen2_vl, image_token x N for llava and plain.  ``image_seqlens[i]`` is
    the feature count of the i-th image in reading order."""
    if mm_style not in MM_STYLES:
        raise NotImplementedError(
            f"mm style {mm_style!r} is not ported yet (ROADMAP A.13)")
    out, idx = [], 0
    for message in messages:
        content = message["content"]
        while IMAGE_PLACEHOLDER in content:
            if idx >= len(image_seqlens):
                raise ValueError("more image placeholders than provided images")
            run = _IMAGE_RUN * image_seqlens[idx]
            if mm_style == "qwen2_vl":
                run = f"<|vision_start|>{run}<|vision_end|>"
            content = content.replace(IMAGE_PLACEHOLDER, run, 1)
            idx += 1
        out.append({**message,
                    "content": content.replace(_IMAGE_RUN, image_token)})
    if idx != len(image_seqlens):
        raise ValueError(
            f"{len(image_seqlens)} images provided but {idx} placeholders found")
    return out
