"""Chat templates for prompt and training encoding (the port's own copy of
the pieces of iadr1_tpu/data/template.py ``ChatTemplate.encode_prompt`` and
``encode_multiturn`` that the ``qwen2_vl`` chatml template needs; the other
templates wait for ROADMAP A.13)."""

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

    def _message_chunks(self, role: str, content: str, first: bool,
                        system: str | None) -> list[str]:
        """One message as the strings the JAX package encodes one by one:
        the system block (first message only) and the role's slot."""
        chunks = []
        sys = system if system is not None else self.default_system
        if first and sys:
            chunks.append(self.system.replace("{content}", sys))
        if role not in ("user", "assistant"):
            raise ValueError(f"unsupported role {role!r}")
        slot = self.user if role == "user" else self.assistant
        chunks.append(slot.replace("{content}", content))
        return chunks

    def encode_multiturn(self, tokenizer, messages: Sequence[dict],
                         system: str | None = None
                         ) -> list[tuple[list[int], list[int]]]:
        """[(prompt_ids, response_ids)] per user/assistant turn pair.  Each
        chunk is tokenized on its own, so no merge spans the system block
        and the first user turn (as in JAX)."""
        encoded = []
        for i, m in enumerate(messages):
            ids: list[int] = []
            for chunk in self._message_chunks(m["role"], m["content"],
                                              i == 0, system):
                if chunk:
                    ids.extend(tokenizer.encode(chunk,
                                                add_special_tokens=False))
            encoded.append(ids)
        if len(encoded) % 2:
            raise ValueError("conversation must alternate user/assistant")
        return [(encoded[i], encoded[i + 1])
                for i in range(0, len(encoded), 2)]


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
