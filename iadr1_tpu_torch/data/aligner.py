"""Dataset aligners: sharegpt/alpaca rows -> unified conversation records
(the port's own copy of iadr1_tpu/data/aligner.py).

Behavior-compatible with llamafactory/data/aligner.py: every row becomes
{"messages": [{role, content}...], "system": str|None, "images": [paths]},
with ``image_dir`` prefixing (the reference's local image_dir addition,
aligner.py:35-55, hparams/data_args.py:44).
"""

from __future__ import annotations

import os
from typing import Sequence

from iadr1_tpu_torch.data.registry import DatasetAttr


def _prefix_images(images, image_dir: str | None) -> list:
    if not images:
        return []
    if not isinstance(images, (list, tuple)):
        images = [images]
    out = []
    for image in images:
        if isinstance(image, str) and image_dir is not None and not os.path.isabs(image):
            out.append(os.path.join(image_dir, image))
        else:
            out.append(image)
    return out


def align_sharegpt(
    row: dict, attr: DatasetAttr, image_dir: str | None = None
) -> dict | None:
    """One sharegpt row -> unified record; None if malformed (dropped)."""
    tag_to_role = {
        attr.user_tag: "user",
        attr.assistant_tag: "assistant",
        attr.observation_tag: "user",
        attr.function_tag: "assistant",
    }
    raw = row.get(attr.messages) or []
    system = row.get(attr.system) if attr.system else None

    if raw and raw[0].get(attr.role_tag) == attr.system_tag:
        system = raw[0][attr.content_tag]
        raw = raw[1:]

    messages = []
    for i, msg in enumerate(raw):
        role = tag_to_role.get(msg.get(attr.role_tag))
        if role is None:
            return None
        expected = "user" if i % 2 == 0 else "assistant"
        if role != expected:
            return None
        messages.append({"role": role, "content": msg[attr.content_tag]})
    if len(messages) % 2:
        return None

    images = row.get(attr.images) if attr.images else None
    return {
        "messages": messages,
        "system": system,
        "images": _prefix_images(images, image_dir),
    }


def align_alpaca(
    row: dict, attr: DatasetAttr, image_dir: str | None = None
) -> dict | None:
    """One alpaca row -> unified record."""
    messages = []
    for old_prompt, old_response in row.get(attr.history) or []:
        messages.append({"role": "user", "content": old_prompt})
        messages.append({"role": "assistant", "content": old_response})

    prompt_parts = []
    if row.get(attr.prompt):
        prompt_parts.append(row[attr.prompt])
    if attr.query and row.get(attr.query):
        prompt_parts.append(row[attr.query])
    response = row.get(attr.response)
    if not prompt_parts or response is None:
        return None
    messages.append({"role": "user", "content": "\n".join(prompt_parts)})
    messages.append({"role": "assistant", "content": response})

    images = row.get(attr.images) if attr.images else None
    return {
        "messages": messages,
        "system": row.get(attr.system) if attr.system else None,
        "images": _prefix_images(images, image_dir),
    }


def align_rows(
    rows: Sequence[dict], attr: DatasetAttr, image_dir: str | None = None
) -> list[dict]:
    fn = align_sharegpt if attr.formatting == "sharegpt" else align_alpaca
    out = []
    for row in rows:
        rec = fn(row, attr, image_dir)
        if rec is not None:
            out.append(rec)
    return out
