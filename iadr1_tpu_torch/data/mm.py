"""Image- and video-placeholder expansion (the port's own copy of
iadr1_tpu/data/mm.py: ``expand_image_tokens`` in every style, qwen2_vl,
llava, intern_vl, paligemma, pixtral and plain, ``expand_video_tokens``
and ``prepend_image_tokens``).

Each placeholder is expanded into a run of a temporary character, which
becomes the image (video) token only once the message is whole, as
LLaMA-Factory's LLaVA plugins do through ``{{image}}``.  The JAX functions
write the token itself, so where that token is the placeholder (``<image>``
of the llava_next_qwen template, ``<video>`` of the LLaVA video families)
they read their own output as further placeholders and raise (ROADMAP
C.R6); here a placeholder of the text counts once.
"""

from __future__ import annotations

from typing import Sequence

IMAGE_PLACEHOLDER = "<image>"
VIDEO_PLACEHOLDER = "<video>"
# one image (video) token, until the message is whole (a private-use code
# point)
_IMAGE_RUN = "\ue000"
MM_STYLES = ("qwen2_vl", "llava", "intern_vl", "paligemma", "pixtral",
             "plain")
# Pixtral's row and image ends
IMG_BREAK, IMG_END = "[IMG_BREAK]", "[IMG_END]"


def prepend_image_tokens(input_ids: Sequence[int],
                         labels: Sequence[int] | None,
                         image_seqlens: Sequence[int], image_token_id: int
                         ) -> tuple[list[int], list[int] | None]:
    """PaliGemma's image prefix: the placeholders were stripped from the
    text (mm style "paligemma") and every image's run of image tokens goes
    ahead of the encoded ids, ahead of BOS, as HF's processor puts it; the
    run's labels are IGNORE_INDEX."""
    from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX

    n = sum(image_seqlens)
    ids = [image_token_id] * n + list(input_ids)
    if labels is None:
        return ids, None
    return ids, [IGNORE_INDEX] * n + list(labels)


def expand_image_tokens(messages: Sequence[dict], image_seqlens: Sequence[int],
                        mm_style: str, image_token: str) -> list[dict]:
    """Replace each ``<image>`` with the family's expanded token run:
    ``<|vision_start|>`` + image_token x N + ``<|vision_end|>`` for
    qwen2_vl, ``<img>`` + image_token x N + ``</img>`` for intern_vl,
    image_token x N for llava and plain; nothing for paligemma, whose runs
    ``prepend_image_tokens`` puts ahead of the encoded ids; for pixtral,
    rows of image_token x cols each ending in ``[IMG_BREAK]``, the last
    one in ``[IMG_END]``.  ``image_seqlens[i]`` is the feature count of the
    i-th image in reading order, for pixtral its (rows, cols) grid."""
    if mm_style not in MM_STYLES:
        raise ValueError(f"unknown mm style {mm_style!r}")
    return _expand(messages, image_seqlens, mm_style, image_token,
                   IMAGE_PLACEHOLDER, "images")


def expand_video_tokens(messages: Sequence[dict], video_seqlens: Sequence[int],
                        mm_style: str,
                        video_token: str = "<|video_pad|>") -> list[dict]:
    """Replace each ``<video>`` with the family's expanded token run:
    ``<|vision_start|>`` + video_token x N + ``<|vision_end|>`` for
    qwen2_vl, video_token x N otherwise.  ``video_seqlens[i]`` is the
    feature count of the i-th video in reading order."""
    return _expand(messages, video_seqlens,
                   "qwen2_vl" if mm_style == "qwen2_vl" else "plain",
                   video_token, VIDEO_PLACEHOLDER, "videos")


def _expand(messages, seqlens, mm_style: str, token: str, placeholder: str,
            what: str) -> list[dict]:
    out, idx = [], 0
    for message in messages:
        content = message["content"]
        while placeholder in content:
            if idx >= len(seqlens):
                raise ValueError(f"more {placeholder} placeholders than "
                                 f"provided {what}")
            if mm_style == "paligemma":
                run = ""
            elif mm_style == "pixtral":
                rows, cols = seqlens[idx]
                run = IMG_BREAK.join([_IMAGE_RUN * cols] * rows) + IMG_END
            else:
                run = _IMAGE_RUN * seqlens[idx]
            if mm_style == "qwen2_vl":
                run = f"<|vision_start|>{run}<|vision_end|>"
            elif mm_style == "intern_vl":
                run = f"<img>{run}</img>"
            content = content.replace(placeholder, run, 1)
            idx += 1
        out.append({**message, "content": content.replace(_IMAGE_RUN, token)})
    if idx != len(seqlens):
        raise ValueError(
            f"{len(seqlens)} {what} provided but {idx} placeholders found")
    return out
