"""Chat templates for prompt and training encoding (the port's own copy of
iadr1_tpu/data/template.py: every template the JAX package registers).

A template is a few slots, each a tuple of chunks: strings with a
``{content}`` placeholder (and ``{idx}``, the round counter of the
chatglm2 style), and the sentinels ``EOS`` and ``BOS`` for the
tokenizer's own special tokens.  ``prefix`` leads the first message.
Rendered strings are byte for byte those of LLaMA-Factory's registrations
of the same names; encoding tokenizes each chunk on its own with no
special tokens, so no merge spans two chunks.  Tool definitions fold into
the system block and tool calls render in the template's ``tool_style``
(``data/tools.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Sentinels for tokenizer-dependent special tokens inside slots.
EOS = object()
BOS = object()

Slot = "str | object"


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
    # how the mm front-end expands image placeholders; one of
    # "qwen2_vl" (vision_start/pad*N/vision_end), "llava" (single token or
    # anyres count), "plain"
    mm_style: str = "plain"
    # llama2-style: the rendered system block is prepended INSIDE the first
    # user message instead of standing alone (LLaMA-Factory's Llama2Template,
    # template.py:162-205; applied to any name containing llama2/mistral/
    # pixtral, template.py:245)
    system_in_user: bool = False
    # tool-role slots: "observation" messages (tool results) and "function"
    # messages (assistant tool calls, content = JSON call list rendered via
    # ``tool_style``); None falls back to the user/assistant slots
    # (LLaMA-Factory's format_observation/format_function)
    observation: "tuple | None" = None
    function: "tuple | None" = None
    # data/tools.py style for tool definitions + call syntax (LLaMA-Factory's
    # ToolFormatter/FunctionFormatter tool_format)
    tool_style: "str | None" = None
    # parity metadata: LLaMA-Factory drops the trailing EOS slot and lets
    # the collator add one terminator (template.py efficient_eos).  The
    # label stream here needs a terminator either way, so rendering keeps
    # the EOS chunk; the flag records LLaMA-Factory's intent.
    efficient_eos: bool = False

    # --- rendering -------------------------------------------------------

    def _fill(self, slots: Sequence, content: str, idx: int = 0) -> list:
        out = []
        for slot in slots:
            if isinstance(slot, str):
                slot = slot.replace("{content}", content)
                # chatglm2-style round counter (LLaMA-Factory's {{idx}},
                # template.py:126 format_user.apply(idx=str(i // 2)))
                if "{idx}" in slot:
                    slot = slot.replace("{idx}", str(idx))
                out.append(slot)
            else:
                out.append(slot)
        return out

    def _system_chunks(self, system: str | None, tools=None):
        """(standalone chunks, inline text) for the first message."""
        sys = system if system is not None else self.default_system
        tool_text = ""
        if tools:
            from iadr1_tpu_torch.data.tools import (
                get_tool_style,
                render_tools_content,
            )

            style = get_tool_style(self.tool_style or "default")
            tool_text = render_tools_content(style, tools)
        if not sys and not tool_text:
            return [], ""
        content = sys + tool_text
        if self.system_in_user:
            return [], "".join(
                s for s in self._fill(self.system, content)
                if isinstance(s, str)
            )
        return self._fill(self.system, content), ""

    def render_message(self, role: str, content: str, first: bool,
                       system: str | None, idx: int = 0,
                       tools=None) -> list:
        """Render one message to a list of str/EOS/BOS chunks.

        ``idx`` is the zero-based user-turn index (chatglm2 rounds);
        ``tools`` is a JSON string / list of tool definitions folded into
        the system block of the first message.
        """
        chunks: list = []
        sys_text = ""
        if first:
            chunks += list(self.prefix)
            sys_chunks, sys_text = self._system_chunks(system, tools)
            chunks += sys_chunks
        if role == "user":
            chunks += self._fill(self.user, sys_text + content, idx)
        elif role == "assistant":
            chunks += self._fill(self.assistant, content, idx)
        elif role == "observation":
            chunks += self._fill(self.observation or self.user,
                                 sys_text + content, idx)
        elif role == "function":
            from iadr1_tpu_torch.data.tools import (
                get_tool_style,
                render_function_content,
            )

            style = get_tool_style(self.tool_style or "default")
            rendered = render_function_content(style, content)
            chunks += self._fill(self.function or self.assistant,
                                 rendered, idx)
        else:
            raise ValueError(f"unsupported role {role!r}")
        return chunks

    def render_conversation(
        self,
        messages: Sequence[dict],
        system: str | None = None,
        add_generation_prompt: bool = False,
        eos_text: str = "",
        bos_text: str = "",
        tools=None,
    ) -> str:
        """Full conversation as a single string (rollout/eval prompt path).

        ``add_generation_prompt`` appends the user->assistant transition so
        the model continues as the assistant (as HF's
        apply_chat_template(add_generation_prompt=True) does for the
        IAD-R1 eval scripts).
        """
        text = []
        for i, msg in enumerate(messages):
            for chunk in self.render_message(
                msg["role"], msg["content"], i == 0, system, idx=i // 2,
                tools=tools,
            ):
                if chunk is EOS:
                    text.append(eos_text)
                elif chunk is BOS:
                    text.append(bos_text)
                else:
                    text.append(chunk)
        if add_generation_prompt:
            # the user slot carries the assistant preamble after {content};
            # emit everything that follows the content placeholder
            tail = []
            seen = False
            for slot in self.user:
                if isinstance(slot, str) and "{content}" in slot:
                    tail.append(slot.rsplit("{content}", 1)[1])
                    seen = True
                elif seen and isinstance(slot, str):
                    tail.append(slot)
            if messages and messages[-1]["role"] == "user":
                pass  # transition already emitted by the user slot
            else:
                text += tail
        return "".join(text)

    # --- encoding --------------------------------------------------------

    def _encode_chunks(self, tokenizer, chunks: list) -> list[int]:
        ids: list[int] = []
        for chunk in chunks:
            if chunk is EOS:
                # tokenizers without the special token skip the slot
                # (LLaMA-Factory's _convert_elements_to_ids)
                if tokenizer.eos_token_id is not None:
                    ids.append(tokenizer.eos_token_id)
            elif chunk is BOS:
                if tokenizer.bos_token_id is not None:
                    ids.append(tokenizer.bos_token_id)
            elif chunk:
                ids.extend(tokenizer.encode(chunk, add_special_tokens=False))
        return ids

    def encode_multiturn(
        self, tokenizer, messages: Sequence[dict], system: str | None = None,
        tools=None,
    ) -> list[tuple[list[int], list[int]]]:
        """[(prompt_ids, response_ids)] per user/assistant turn pair."""
        encoded = [
            self._encode_chunks(
                tokenizer,
                self.render_message(m["role"], m["content"], i == 0, system,
                                    idx=i // 2, tools=tools),
            )
            for i, m in enumerate(messages)
        ]
        if len(encoded) % 2:
            raise ValueError("conversation must alternate user/assistant")
        return [(encoded[i], encoded[i + 1]) for i in range(0, len(encoded), 2)]

    def encode_prompt(
        self, tokenizer, messages: Sequence[dict], system: str | None = None,
        tools=None,
    ) -> list[int]:
        """Token ids of the conversation with the generation preamble.
        EOS and BOS render as the tokenizer's token strings, where it has
        them (a stand-in that only encodes serves the templates whose
        slots hold neither)."""
        text = self.render_conversation(
            messages, system, add_generation_prompt=True,
            eos_text=getattr(tokenizer, "eos_token", None) or "",
            bos_text=getattr(tokenizer, "bos_token", None) or "",
            tools=tools,
        )
        return tokenizer.encode(text, add_special_tokens=False)


_CHATML_KW = dict(
    user=("<|im_start|>user\n{content}<|im_end|>\n<|im_start|>assistant\n",),
    assistant=("{content}<|im_end|>\n",),
    system=("<|im_start|>system\n{content}<|im_end|>\n",),
    default_system="You are a helpful assistant.",
    stop_words=("<|im_end|>",),
)

_VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)

TEMPLATES: dict[str, ChatTemplate] = {}


def _register(template: ChatTemplate) -> None:
    TEMPLATES[template.name] = template


def register_template(template: ChatTemplate) -> None:
    """Public user-registration hook (LLaMA-Factory's ``_register_template``,
    template.py:216-266 -- its docstring demonstrates registering a
    ``custom`` template; that example ships below)."""
    _register(template)


# "custom" is NOT among LLaMA-Factory's 78 registered names -- it is the
# register_template docstring example (template.py:236-243).  Registered
# here verbatim (literal <s>/</s> strings, as in the example) so the
# documented user contract works out of the box.
_register(ChatTemplate(
    name="custom",
    user=("<user>{content}\n<model>",),
    assistant=("{content}</s>\n",),
    prefix=("<s>",),
))

_register(ChatTemplate(name="qwen2_vl", image_token="<|image_pad|>",
                       mm_style="qwen2_vl", **_CHATML_KW))
_register(ChatTemplate(name="qwen2_5_vl", image_token="<|image_pad|>",
                       mm_style="qwen2_vl", **_CHATML_KW))
_register(ChatTemplate(name="llava_next_qwen", image_token="<image>",
                       mm_style="llava", **_CHATML_KW))
# plain chatml has NO default system (LLaMA-Factory's chatml;
# the qwen-family registrations add theirs explicitly)
_register(ChatTemplate(
    name="chatml",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    stop_words=("<|im_end|>", "<|im_start|>"),
))
_register(
    ChatTemplate(
        name="llava",
        user=("USER: {content} ASSISTANT:",),
        default_system=_VICUNA_SYSTEM,
        image_token="<image>",
        mm_style="llava",
    )
)
_register(
    ChatTemplate(
        name="llava_next",
        user=("USER: {content} ASSISTANT:",),
        default_system=_VICUNA_SYSTEM,
        image_token="<image>",
        mm_style="llava",
    )
)
_MISTRAL_TOOLS = dict(
    function=("[TOOL_CALLS] ", "{content}", EOS),
    observation=('[TOOL_RESULTS] {"content": {content}}[/TOOL_RESULTS]',),
    tool_style="mistral",
)

_register(
    ChatTemplate(
        name="llava_next_mistral",
        user=("[INST] {content}[/INST]",),
        assistant=(" {content}", EOS),
        system=("{content}\n\n",),
        prefix=(BOS,),
        image_token="<image>",
        mm_style="llava",
        system_in_user=True,
        **_MISTRAL_TOOLS,
    )
)
_register(
    ChatTemplate(
        name="intern_vl",
        user=("<|im_start|>user\n{content}<|im_end|>\n<|im_start|>assistant\n",),
        assistant=("{content}<|im_end|>\n",),
        system=("<|im_start|>system\n{content}<|im_end|>\n",),
        prefix=(BOS,),
        stop_words=("<|im_end|>",),
        image_token="<IMG_CONTEXT>",
        mm_style="intern_vl",
    )
)


# --- general-purpose templates beyond the IAD-R1 recipe --------------------
# Rendered strings match LLaMA-Factory's registrations byte-for-byte
# (llamafactory/data/template.py), tool and function slots included where
# a registration has them.  Templates LLaMA-Factory marks efficient_eos keep the EOS chunk here: the label stream needs a
# terminator either way, and single-turn training is identical.

_register(ChatTemplate(
    name="default",
    user=("Human: {content}\nAssistant:",),
    assistant=("{content}", EOS, "\n"),
    system=("System: {content}\n",),
))
_register(ChatTemplate(
    name="empty",
    user=("{content}",),
    assistant=("{content}", EOS),
))
_register(ChatTemplate(
    name="alpaca",
    user=("### Instruction:\n{content}\n\n### Response:\n",),
    assistant=("{content}", EOS, "\n\n"),
    default_system=(
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
    ),
))
_register(ChatTemplate(
    name="vicuna",
    user=("USER: {content} ASSISTANT:",),
    default_system=_VICUNA_SYSTEM,
))
_register(ChatTemplate(
    name="llama2",
    user=(BOS, "[INST] {content} [/INST]"),
    system=("<<SYS>>\n{content}\n<</SYS>>\n\n",),
    system_in_user=True,
))
_register(ChatTemplate(
    name="llama3",
    user=("<|start_header_id|>user<|end_header_id|>\n\n{content}<|eot_id|>"
          "<|start_header_id|>assistant<|end_header_id|>\n\n",),
    assistant=("{content}<|eot_id|>",),
    system=("<|start_header_id|>system<|end_header_id|>\n\n{content}<|eot_id|>",),
    prefix=(BOS,),
    stop_words=("<|eot_id|>", "<|eom_id|>"),
    function=("{content}<|eot_id|>",),
    observation=("<|start_header_id|>ipython<|end_header_id|>\n\n{content}<|eot_id|>"
                 "<|start_header_id|>assistant<|end_header_id|>\n\n",),
    tool_style="llama3",
))
_register(ChatTemplate(
    name="mistral",
    user=("[INST] {content}[/INST]",),
    assistant=(" {content}", EOS),
    system=("{content}\n\n",),
    prefix=(BOS,),
    # mistral names route through LLaMA-Factory's Llama2Template
    # (template.py:245): system renders INSIDE the first [INST] block
    system_in_user=True,
    **_MISTRAL_TOOLS,
))
_GEMMA_OBS = ("<start_of_turn>tool\n{content}<end_of_turn>\n"
              "<start_of_turn>model\n",)

_register(ChatTemplate(
    name="gemma",
    user=("<start_of_turn>user\n{content}<end_of_turn>\n<start_of_turn>model\n",),
    assistant=("{content}<end_of_turn>\n",),
    prefix=(BOS,),
    observation=_GEMMA_OBS,
))
_register(ChatTemplate(
    name="phi",
    user=("<|user|>\n{content}<|end|>\n<|assistant|>\n",),
    assistant=("{content}<|end|>\n",),
    system=("<|system|>\n{content}<|end|>\n",),
    stop_words=("<|end|>",),
))
_register(ChatTemplate(
    name="phi4",
    user=("<|im_start|>user<|im_sep|>{content}<|im_end|>"
          "<|im_start|>assistant<|im_sep|>",),
    assistant=("{content}<|im_end|>",),
    system=("<|im_start|>system<|im_sep|>{content}<|im_end|>",),
    stop_words=("<|im_end|>",),
))
_QWEN_TOOLS = dict(
    function=("{content}<|im_end|>\n",),
    observation=("<|im_start|>user\n<tool_response>\n{content}\n"
                 "</tool_response><|im_end|>\n<|im_start|>assistant\n",),
    tool_style="qwen",
)

_register(ChatTemplate(
    name="qwen",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    default_system="You are a helpful assistant.",
    stop_words=("<|im_end|>",),
    **_QWEN_TOOLS,
))
_register(ChatTemplate(
    name="yi",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="deepseek",
    user=("User: {content}\n\nAssistant:",),
    system=("{content}\n\n",),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="deepseek3",
    user=("<｜User｜>{content}<｜Assistant｜>",),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="baichuan2",
    user=("<reserved_106>{content}<reserved_107>",),
))
_register(ChatTemplate(
    name="zephyr",
    user=("<|user|>\n{content}", EOS, "<|assistant|>\n"),
    system=("<|system|>\n{content}", EOS),
    default_system="You are Zephyr, a helpful assistant.",
))
_register(ChatTemplate(
    name="openchat",
    user=("GPT4 Correct User: {content}", EOS, "GPT4 Correct Assistant:"),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="intern2",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    prefix=(BOS,),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="glm4",
    user=("<|user|>\n{content}<|assistant|>",),
    assistant=("\n{content}", EOS),
    system=("<|system|>\n{content}",),
    prefix=("[gMASK]<sop>",),
    stop_words=("<|user|>", "<|observation|>"),
    function=("{content}", EOS),
    observation=("<|observation|>\n{content}<|assistant|>",),
    tool_style="glm4",
    efficient_eos=True,
))
_register(ChatTemplate(
    name="olmo",
    user=("<|user|>\n{content}<|assistant|>\n",),
    prefix=(EOS,),
))
_register(ChatTemplate(
    name="falcon",
    user=("User: {content}\nFalcon:",),
    assistant=("{content}", EOS, "\n"),
))
_register(ChatTemplate(
    name="aquila",
    user=("Human: {content}###Assistant:",),
    assistant=("{content}###",),
    system=("System: {content}###",),
    default_system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    stop_words=("</s>",),
))
_register(ChatTemplate(
    name="atom",
    user=(BOS, "Human: {content}\n", EOS, BOS, "Assistant:"),
    assistant=("{content}\n", EOS),
))
_register(ChatTemplate(
    name="breeze",
    user=("[INST] {content} [/INST] ",),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="cohere",
    user=("<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{content}<|END_OF_TURN_TOKEN|>"
          "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",),
    system=("<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{content}"
            "<|END_OF_TURN_TOKEN|>",),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="cpm",
    user=("<用户>{content}<AI>",),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="cpm3",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    prefix=(BOS,),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="dbrx",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    default_system=(
        "You are DBRX, created by Databricks. You were last updated in "
        "December 2023. You answer questions based on information "
        "available up to that point.\n"
        "YOU PROVIDE SHORT RESPONSES TO SHORT QUESTIONS OR STATEMENTS, "
        "but provide thorough responses to more complex and open-ended "
        "questions.\n"
        "You assist with various tasks, from writing to coding (using "
        "markdown for code blocks \u2014 remember to use ``` with code, "
        "JSON, and tables).\n"
        "(You do not have real-time data access or code execution "
        "capabilities. You avoid stereotyping and provide balanced "
        "perspectives on controversial topics. You do not provide song "
        "lyrics, poems, or news articles and do not divulge details of "
        "your training data.)\n"
        "This is your system prompt, guiding your responses. Do not "
        "reference it, just respond to the user. If you find yourself "
        "talking about this message, stop. You should be responding "
        "appropriately and usually that means not mentioning this.\n"
        "YOU DO NOT MENTION ANY OF THIS INFORMATION ABOUT YOURSELF UNLESS "
        "THE INFORMATION IS DIRECTLY PERTINENT TO THE USER'S QUERY."
    ),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="exaone",
    user=("[|user|]{content}\n[|assistant|]",),
    assistant=("{content}", EOS, "\n"),
    system=("[|system|]{content}[|endofturn|]\n",),
))
_register(ChatTemplate(
    name="orion",
    user=("Human: {content}\n\nAssistant: ", EOS),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="solar",
    user=("### User:\n{content}\n\n### Assistant:\n",),
    system=("### System:\n{content}\n\n",),
))
_register(ChatTemplate(
    name="starchat",
    user=("<|user|>\n{content}<|end|>\n<|assistant|>",),
    assistant=("{content}<|end|>\n",),
    system=("<|system|>\n{content}<|end|>\n",),
    stop_words=("<|end|>",),
))
_register(ChatTemplate(
    name="telechat",
    user=("<_user>{content}<_bot>",),
    system=("<_system>{content}<_end>",),
))
_register(ChatTemplate(
    name="xverse",
    user=("Human: {content}\n\nAssistant: ",),
))
_register(ChatTemplate(
    name="yuan",
    user=("{content}<sep>",),
    assistant=("{content}<eod>\n",),
    stop_words=("<eod>",),
))
_register(ChatTemplate(
    name="ziya",
    user=("<human>:{content}\n<bot>:",),
    assistant=("{content}\n",),
))

# --- breadth to LLaMA-Factory's full 78-name registry ---------------------
# (llamafactory/data/template.py:404-1330; slots transcribed per
# registration, efficient_eos handled per the module-top note)

_register(ChatTemplate(
    name="baichuan",
    user=("<reserved_102>{content}<reserved_103>",),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="belle",
    user=("Human: {content}\n\nBelle: ",),
    assistant=("{content}", EOS, "\n\n"),
    prefix=(BOS,),
))
_register(ChatTemplate(
    name="bluelm",
    user=("[|Human|]:{content}[|AI|]:",),
))
_register(ChatTemplate(
    name="chatglm2",
    user=("[Round {idx}]\n\n问：{content}\n\n答：",),
    prefix=("[gMASK]sop",),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="chatglm3",
    user=("<|user|>\n{content}<|assistant|>",),
    assistant=("\n{content}", EOS),
    system=("<|system|>\n{content}",),
    function=("{content}", EOS),
    observation=("<|observation|>\n{content}<|assistant|>",),
    tool_style="glm4",
    prefix=("[gMASK]sop",),
    stop_words=("<|user|>", "<|observation|>"),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="chatml_de",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    observation=("<|im_start|>tool\n{content}<|im_end|>\n"
                 "<|im_start|>assistant\n",),
    default_system="Du bist ein freundlicher und hilfsbereiter KI-Assistent.",
    stop_words=("<|im_end|>", "<|im_start|>"),
))
_register(ChatTemplate(
    name="codegeex2",
    prefix=("[gMASK]sop",),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="codegeex4",
    user=("<|user|>\n{content}<|assistant|>\n",),
    system=("<|system|>\n{content}",),
    function=("{content}", EOS),
    observation=("<|observation|>\n{content}<|assistant|>\n",),
    tool_style="glm4",
    prefix=("[gMASK]<sop>",),
    default_system=(
        "你是一位智能编程助手，你叫CodeGeeX。你会为用户回答关于编程、代码、计算机方面的任何问题，"
        "并提供格式规范、可以执行、准确安全的代码，并在必要时提供详细的解释。"
    ),
    stop_words=("<|user|>", "<|observation|>"),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="deepseekcoder",
    user=("### Instruction:\n{content}\n### Response:",),
    assistant=("\n{content}\n<|EOT|>\n",),
    prefix=(BOS,),
    default_system=(
        "You are an AI programming assistant, utilizing the DeepSeek Coder "
        "model, developed by DeepSeek Company, and you only answer questions "
        "related to computer science. For politically sensitive questions, "
        "security and privacy issues, and other non-computer science "
        "questions, you will refuse to answer.\n"
    ),
))
_register(ChatTemplate(
    name="fewshot",
    assistant=("{content}", EOS, "\n\n"),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="granite3",
    user=("<|start_of_role|>user<|end_of_role|>{content}<|end_of_text|>\n"
          "<|start_of_role|>assistant<|end_of_role|>",),
    assistant=("{content}<|end_of_text|>\n",),
    system=("<|start_of_role|>system<|end_of_role|>{content}"
            "<|end_of_text|>\n",),
))
_register(ChatTemplate(
    name="index",
    user=("reserved_0{content}reserved_1",),
    system=("<unk>{content}",),
    efficient_eos=True,
))
_register(ChatTemplate(
    name="intern",
    user=("<|User|>:{content}\n<|Bot|>:",),
    assistant=("{content}<eoa>\n",),
    system=("<|System|>:{content}\n",),
    prefix=(BOS,),
    stop_words=("<eoa>",),
))
_register(ChatTemplate(
    name="intern3",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    prefix=(BOS,),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="llama2_zh",
    user=(BOS, "[INST] {content} [/INST]"),
    system=("<<SYS>>\n{content}\n<</SYS>>\n\n",),
    system_in_user=True,
    default_system="You are a helpful assistant. 你是一个乐于助人的助手。",
))
_LLAMA3_KW = dict(
    user=("<|start_header_id|>user<|end_header_id|>\n\n{content}<|eot_id|>"
          "<|start_header_id|>assistant<|end_header_id|>\n\n",),
    assistant=("{content}<|eot_id|>",),
    system=("<|start_header_id|>system<|end_header_id|>\n\n{content}"
            "<|eot_id|>",),
    prefix=(BOS,),
    stop_words=("<|eot_id|>", "<|eom_id|>"),
    function=("{content}<|eot_id|>",),
    observation=("<|start_header_id|>ipython<|end_header_id|>\n\n{content}"
                 "<|eot_id|><|start_header_id|>assistant<|end_header_id|>"
                 "\n\n",),
    tool_style="llama3",
)
_register(ChatTemplate(
    name="llava_next_llama3",
    image_token="<image>", mm_style="llava", **_LLAMA3_KW,
))
_register(ChatTemplate(
    name="llava_next_video",
    user=("USER: {content} ASSISTANT:",),
    default_system=_VICUNA_SYSTEM,
    image_token="<image>", mm_style="llava",
))
_register(ChatTemplate(
    name="llava_next_video_mistral",
    user=("[INST] {content}[/INST]",),
    assistant=(" {content}", EOS),
    system=("{content}\n\n",),
    prefix=(BOS,),
    system_in_user=True,
    image_token="<image>", mm_style="llava",
    **_MISTRAL_TOOLS,
))
_register(ChatTemplate(
    name="llava_next_video_yi",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    stop_words=("<|im_end|>",),
    image_token="<image>", mm_style="llava",
))
_register(ChatTemplate(
    name="llava_next_yi",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    stop_words=("<|im_end|>",),
    image_token="<image>", mm_style="llava",
))
_register(ChatTemplate(
    name="marco",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    observation=("<|im_start|>tool\n{content}<|im_end|>\n"
                 "<|im_start|>assistant\n",),
    default_system=(
        "你是一个经过良好训练的AI助手，你的名字是Marco-o1."
        "由阿里国际数字商业集团的AI Business创造.\n## 重要！！！！！\n"
        "当你回答问题时，你的思考应该在<Thought>内完成，<Output>内输出你的结果。\n"
        "<Thought>应该尽可能是英文，但是有2个特例，一个是对原文中的引用，"
        "另一个是是数学应该使用markdown格式，<Output>内的输出需要遵循用户输入的语言。\n"
    ),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="minicpm_v",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    stop_words=("<|im_end|>",),
    image_token="<image>", mm_style="llava",
))
_register(ChatTemplate(
    name="mllama",
    image_token="<|image|>", mm_style="llava", **_LLAMA3_KW,
))
_register(ChatTemplate(
    name="openchat-3.6",
    user=("<|start_header_id|>GPT4 Correct User<|end_header_id|>\n\n"
          "{content}<|eot_id|>"
          "<|start_header_id|>GPT4 Correct Assistant<|end_header_id|>\n\n",),
    prefix=(BOS,),
    stop_words=("<|eot_id|>",),
))
_register(ChatTemplate(
    name="opencoder",
    user=_CHATML_KW["user"],
    assistant=_CHATML_KW["assistant"],
    system=_CHATML_KW["system"],
    observation=("<|im_start|>tool\n{content}<|im_end|>\n"
                 "<|im_start|>assistant\n",),
    default_system="You are OpenCoder, created by OpenCoder Team.",
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="paligemma",
    user=("<start_of_turn>user\n{content}<end_of_turn>\n"
          "<start_of_turn>model\n",),
    assistant=("{content}<end_of_turn>\n",),
    prefix=(BOS,),
    observation=_GEMMA_OBS,
    image_token="<image>", mm_style="paligemma",
))
_register(ChatTemplate(
    name="phi_small",
    user=("<|user|>\n{content}<|end|>\n<|assistant|>\n",),
    assistant=("{content}<|end|>\n",),
    system=("<|system|>\n{content}<|end|>\n",),
    # LLaMA-Factory's prefix slot {"<|endoftext|>"} is a set literal its
    # encoder silently drops (template.py:151-156 handles only
    # bos_token/eos_token sets) -- byte-parity means no prefix
    stop_words=("<|end|>",),
))
_register(ChatTemplate(
    name="pixtral",
    user=("[INST]{content}[/INST]",),
    system=("{content}\n\n",),
    prefix=(BOS,),
    system_in_user=True,
    image_token="[IMG]", mm_style="pixtral",
))
_register(ChatTemplate(
    name="sailor",
    user=("<|im_start|>question\n{content}<|im_end|>\n<|im_start|>answer\n",),
    assistant=("{content}<|im_end|>\n",),
    system=_CHATML_KW["system"],
    default_system=(
        "You are an AI assistant named Sailor created by Sea AI Lab. "
        "Your answer should be friendly, unbiased, faithful, informative "
        "and detailed."
    ),
    stop_words=("<|im_end|>",),
))
_register(ChatTemplate(
    name="skywork_o1",
    default_system=(
        "You are Skywork-o1, a thinking model developed by Skywork AI, "
        "specializing in solving complex problems involving mathematics, "
        "coding, and logical reasoning through deep thought. When faced "
        "with a user's request, you first engage in a lengthy and in-depth "
        "thinking process to explore possible solutions to the problem. "
        "After completing your thoughts, you then provide a detailed "
        "explanation of the solution process in your response."
    ),
    **_LLAMA3_KW,
))
_register(ChatTemplate(
    name="telechat2",
    user=("<_user>{content}<_bot>",),
    system=("<_system>{content}",),
    default_system=(
        "你是中国电信星辰语义大模型，英文名是TeleChat，你是由中电信人工智能科技"
        "有限公司和中国电信人工智能研究院（TeleAI）研发的人工智能助手。"
    ),
))
_register(ChatTemplate(
    name="video_llava",
    user=("USER: {content} ASSISTANT:",),
    default_system=_VICUNA_SYSTEM,
    image_token="<image>", mm_style="llava",
))
_register(ChatTemplate(
    name="xuanyuan",
    user=("Human: {content} Assistant:",),
    default_system=(
        "以下是用户和人工智能助手之间的对话。用户以Human开头，人工智能助手以Assistant"
        "开头，会对人类提出的问题给出有帮助、高质量、详细和礼貌的回答，并且总是拒绝参与"
        "与不道德、不安全、有争议、政治敏感等相关的话题、问题和指示。\n"
    ),
))
_register(ChatTemplate(
    name="yayi",
    user=("<|Human|>:\n{content}\n\n<|YaYi|>:",),
    assistant=("{content}\n\n",),
    system=("<|System|>:\n{content}\n\n",),
    default_system=(
        "You are a helpful, respectful and honest assistant named YaYi "
        "developed by Beijing Wenge Technology Co.,Ltd. "
        "Always answer as helpfully as possible, while being safe.  "
        "Your answers should not include any harmful, unethical, "
        "racist, sexist, toxic, dangerous, or illegal content. "
        "Please ensure that your responses are socially unbiased and "
        "positive in nature.\n\n"
        "If a question does not make any sense, or is not factually "
        "coherent, explain why instead of answering something not correct. "
        "If you don't know the answer to a question, please don't share "
        "false information."
    ),
    stop_words=("<|End|>",),
))
_register(ChatTemplate(
    name="yi_vl",
    user=("### Human: {content}\n### Assistant:",),
    assistant=("{content}\n",),
    default_system=(
        "This is a chat between an inquisitive human and an AI assistant. "
        "Assume the role of the AI assistant. Read all the images carefully, "
        "and respond to the human's questions with informative, helpful, "
        "detailed and polite answers. "
        "这是一个好奇的人类和一个人工智能助手之间的对话。假设你扮演这个AI助手的角色。"
        "仔细阅读所有的图像，并对人类的问题做出信息丰富、有帮助、详细的和礼貌的回答。"
        "\n\n"
    ),
    stop_words=("###",),
    efficient_eos=True,
    image_token="<image>", mm_style="llava",
))


def get_template(name: str) -> ChatTemplate:
    try:
        return TEMPLATES[name]
    except KeyError:
        raise KeyError(
            f"unknown template {name!r}; known: {sorted(TEMPLATES)}"
        ) from None
