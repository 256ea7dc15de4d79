"""Chat templates for prompt and training encoding (the port's own copy of
the pieces of iadr1_tpu/data/template.py ``ChatTemplate.encode_prompt`` and
``encode_multiturn`` that the ported families' templates need: the chatml
``qwen2_vl``, ``qwen2_5_vl``, ``llava_next_qwen``, ``llava_next_yi``,
``llava_next_video_yi`` and ``intern_vl``, the vicuna-style ``llava``,
``llava_next``, ``llava_next_video`` and ``video_llava``, the Mistral-style
``llava_next_video_mistral`` and ``pixtral``, ``llava_next_llama3``, and
the Gemma-style ``paligemma``; the other templates wait for ROADMAP
A.13).

A template is a few slots, each a tuple of chunks: strings with a
``{content}`` placeholder, and the sentinels ``EOS`` and ``BOS`` for the
tokenizer's own special tokens.  ``prefix`` leads the first message."""

from __future__ import annotations

import dataclasses
from typing import Sequence

# the tokenizer's special tokens inside a slot
EOS = object()
BOS = object()


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    name: str
    user: tuple = ("{content}",)
    assistant: tuple = ("{content}", EOS)
    system: tuple = ("{content}",)
    prefix: tuple = ()
    default_system: str = ""
    stop_words: tuple = ()
    image_token: str = "<image>"
    mm_style: str = "plain"
    # the system text goes in front of the first user message's content,
    # inside the user slot, instead of a slot of its own
    system_in_user: bool = False

    def _message_chunks(self, role: str, content: str, first: bool,
                        system: str | None) -> list:
        """One message as the chunks the JAX package encodes one by one:
        the prefix and the system block (first message only), then the
        role's slot."""
        chunks: list = []
        if first:
            chunks += list(self.prefix)
            sys = system if system is not None else self.default_system
            if sys:
                block = [c.replace("{content}", sys) if isinstance(c, str)
                         else c for c in self.system]
                if self.system_in_user:
                    if role == "user":
                        content = "".join(c for c in block
                                          if isinstance(c, str)) + content
                else:
                    chunks += block
        if role not in ("user", "assistant"):
            raise ValueError(f"unsupported role {role!r}")
        slot = self.user if role == "user" else self.assistant
        chunks += [c.replace("{content}", content) if isinstance(c, str)
                   else c for c in slot]
        return chunks

    def render_conversation(self, messages: Sequence[dict],
                            system: str | None = None, eos_text: str = "",
                            bos_text: str = "") -> str:
        """The conversation as one string, ending in the assistant
        preamble (the user slot carries it; after a last message of the
        assistant's, the user slot's text after ``{content}`` follows)."""
        special = {id(EOS): eos_text, id(BOS): bos_text}
        parts = [special.get(id(c), c)
                 for i, m in enumerate(messages)
                 for c in self._message_chunks(m["role"], m["content"],
                                               i == 0, system)]
        if messages and messages[-1]["role"] != "user":
            seen = False
            for c in self.user:
                if isinstance(c, str) and "{content}" in c:
                    parts.append(c.rsplit("{content}", 1)[1])
                    seen = True
                elif seen and isinstance(c, str):
                    parts.append(c)
        return "".join(parts)

    def encode_prompt(self, tokenizer, messages: Sequence[dict],
                      system: str | None = None) -> list[int]:
        """Token ids of the conversation with the generation preamble.
        EOS and BOS render as the tokenizer's token strings, where it has
        them (a stand-in that only encodes serves the chatml templates)."""
        text = self.render_conversation(
            messages, system,
            eos_text=getattr(tokenizer, "eos_token", None) or "",
            bos_text=getattr(tokenizer, "bos_token", None) or "")
        return tokenizer.encode(text, add_special_tokens=False)

    def encode_multiturn(self, tokenizer, messages: Sequence[dict],
                         system: str | None = None
                         ) -> list[tuple[list[int], list[int]]]:
        """[(prompt_ids, response_ids)] per user/assistant turn pair.  Each
        chunk is tokenized on its own, so no merge spans the system block
        and the first user turn (as in JAX); EOS and BOS become the
        tokenizer's ids, or nothing where it has none."""
        encoded = []
        for i, m in enumerate(messages):
            ids: list[int] = []
            for chunk in self._message_chunks(m["role"], m["content"],
                                              i == 0, system):
                if chunk is EOS or chunk is BOS:
                    tid = (tokenizer.eos_token_id if chunk is EOS
                           else tokenizer.bos_token_id)
                    if tid is not None:
                        ids.append(tid)
                elif chunk:
                    ids.extend(tokenizer.encode(chunk,
                                                add_special_tokens=False))
            encoded.append(ids)
        if len(encoded) % 2:
            raise ValueError("conversation must alternate user/assistant")
        return [(encoded[i], encoded[i + 1])
                for i in range(0, len(encoded), 2)]


_CHATML = dict(
    user=("<|im_start|>user\n{content}<|im_end|>\n<|im_start|>assistant\n",),
    assistant=("{content}<|im_end|>\n",),
    system=("<|im_start|>system\n{content}<|im_end|>\n",),
    stop_words=("<|im_end|>",),
)
_QWEN_SYSTEM = "You are a helpful assistant."
# vicuna v1 (LLaVA-1.5 and LLaVA-1.6-Vicuna)
_VICUNA = dict(
    user=("USER: {content} ASSISTANT:",),
    default_system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."),
)
# LLaMA-3 instruct (LLaVA-NeXT-8B)
_LLAMA3 = dict(
    user=("<|start_header_id|>user<|end_header_id|>\n\n{content}<|eot_id|>"
          "<|start_header_id|>assistant<|end_header_id|>\n\n",),
    assistant=("{content}<|eot_id|>",),
    system=("<|start_header_id|>system<|end_header_id|>\n\n{content}"
            "<|eot_id|>",),
    prefix=(BOS,),
    stop_words=("<|eot_id|>", "<|eom_id|>"),
)
# Mistral instruct (LLaVA-NeXT-Video-Mistral): the system text inside the
# first user message
_MISTRAL = dict(
    user=("[INST] {content}[/INST]",),
    assistant=(" {content}", EOS),
    system=("{content}\n\n",),
    prefix=(BOS,),
    system_in_user=True,
)
# the LLaVA families: each image a run of <image> tokens
_LLAVA = dict(image_token="<image>", mm_style="llava")

TEMPLATES = {
    "qwen2_vl": ChatTemplate(name="qwen2_vl", image_token="<|image_pad|>",
                             mm_style="qwen2_vl",
                             default_system=_QWEN_SYSTEM, **_CHATML),
    "qwen2_5_vl": ChatTemplate(name="qwen2_5_vl",
                               image_token="<|image_pad|>",
                               mm_style="qwen2_vl",
                               default_system=_QWEN_SYSTEM, **_CHATML),
    # LLaVA-OneVision
    "llava_next_qwen": ChatTemplate(name="llava_next_qwen",
                                    default_system=_QWEN_SYSTEM,
                                    **_CHATML, **_LLAVA),
    # LLaVA-1.5, LLaVA-1.6-Vicuna, LLaVA-NeXT-8B and LLaVA-1.6-34B
    "llava": ChatTemplate(name="llava", **_VICUNA, **_LLAVA),
    "llava_next": ChatTemplate(name="llava_next", **_VICUNA, **_LLAVA),
    "llava_next_llama3": ChatTemplate(name="llava_next_llama3", **_LLAMA3,
                                      **_LLAVA),
    "llava_next_yi": ChatTemplate(name="llava_next_yi", **_CHATML, **_LLAVA),
    # the video families
    "llava_next_video": ChatTemplate(name="llava_next_video", **_VICUNA,
                                     **_LLAVA),
    "llava_next_video_mistral": ChatTemplate(
        name="llava_next_video_mistral", **_MISTRAL, **_LLAVA),
    "llava_next_video_yi": ChatTemplate(name="llava_next_video_yi",
                                        **_CHATML, **_LLAVA),
    "video_llava": ChatTemplate(name="video_llava", **_VICUNA, **_LLAVA),
    # InternVL-2.5: chatml after the tokenizer's BOS, each image
    # <img> + <IMG_CONTEXT> x N + </img>
    "intern_vl": ChatTemplate(name="intern_vl", prefix=(BOS,),
                              image_token="<IMG_CONTEXT>",
                              mm_style="intern_vl", **_CHATML),
    # PaliGemma: Gemma's turns after BOS; the image runs are prepended to
    # the encoded ids (data/mm.py prepend_image_tokens), ahead of BOS
    "paligemma": ChatTemplate(
        name="paligemma",
        user=("<start_of_turn>user\n{content}<end_of_turn>\n"
              "<start_of_turn>model\n",),
        assistant=("{content}<end_of_turn>\n",), prefix=(BOS,),
        image_token="<image>", mm_style="paligemma"),
    # Pixtral: Mistral's [INST] turns without the spaces, the system text
    # inside the first user message; each image rows of [IMG]
    "pixtral": ChatTemplate(
        name="pixtral", user=("[INST]{content}[/INST]",),
        system=("{content}\n\n",), prefix=(BOS,), system_in_user=True,
        image_token="[IMG]", mm_style="pixtral"),
}


def get_template(name: str) -> ChatTemplate:
    if name not in TEMPLATES:
        raise NotImplementedError(
            f"template {name!r} is not ported yet (ROADMAP A.13)")
    return TEMPLATES[name]
