"""Chat templates for prompt encoding (the port's own copy of the pieces of
iadr1_tpu/data/template.py ``ChatTemplate.encode_prompt`` that the
``qwen2_vl`` chatml template needs)."""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    name: str
    user: str = "{content}"
    assistant: str = "{content}"
    system: str = "{content}"
    default_system: str = ""
    stop_words: tuple = ()
    image_token: str = "<image>"
    mm_style: str = "plain"

    def render_conversation(self, messages: Sequence[dict],
                            system: str | None = None) -> str:
        """The conversation as one string, ending in the assistant
        preamble when the last message is the user's (the user slot
        carries it)."""
        parts = []
        for i, msg in enumerate(messages):
            if i == 0:
                sys = system if system is not None else self.default_system
                if sys:
                    parts.append(self.system.replace("{content}", sys))
            if msg["role"] == "user":
                parts.append(self.user.replace("{content}", msg["content"]))
            elif msg["role"] == "assistant":
                parts.append(self.assistant.replace("{content}",
                                                    msg["content"]))
            else:
                raise ValueError(f"unsupported role {msg['role']!r}")
        if messages and messages[-1]["role"] != "user":
            parts.append(self.user.rsplit("{content}", 1)[1])
        return "".join(parts)

    def encode_prompt(self, tokenizer, messages: Sequence[dict],
                      system: str | None = None) -> list[int]:
        """Token ids of the conversation with the generation preamble."""
        text = self.render_conversation(messages, system)
        return tokenizer.encode(text, add_special_tokens=False)


TEMPLATES = {
    "qwen2_vl": ChatTemplate(
        name="qwen2_vl",
        user="<|im_start|>user\n{content}<|im_end|>\n<|im_start|>assistant\n",
        assistant="{content}<|im_end|>\n",
        system="<|im_start|>system\n{content}<|im_end|>\n",
        default_system="You are a helpful assistant.",
        stop_words=("<|im_end|>",),
        image_token="<|image_pad|>",
        mm_style="qwen2_vl",
    ),
}


def get_template(name: str) -> ChatTemplate:
    if name not in TEMPLATES:
        raise NotImplementedError(
            f"template {name!r} is not ported yet (ROADMAP A.13)")
    return TEMPLATES[name]
