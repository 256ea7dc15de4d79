"""Tool and function-call rendering styles for chat templates (the port's
own copy of iadr1_tpu/data/tools.py).

A template may carry a ``tool_style`` that knows how to

* ``describe_tools``: render tool definitions (JSON-schema dicts) into the
  system-prompt text the model family was trained on;
* ``render_calls``: render assistant tool-call messages (a JSON list of
  {name, arguments}) into the family's call syntax;
* ``extract``: parse the family's call syntax back out of a generated
  completion (the inverse of ``render_calls``).

The prompt strings are data contracts: the models were trained on these
exact bytes.  Five styles: default, glm4, llama3, mistral and qwen.
"""

from __future__ import annotations

import dataclasses
import json
import re
from datetime import datetime
from typing import Any, Callable, NamedTuple


class FunctionCall(NamedTuple):
    name: str
    arguments: str  # JSON-encoded kwargs


# --- prompt contracts ----------------------------------------------------------

DEFAULT_TOOL_PROMPT = (
    "You have access to the following tools:\n{tool_text}"
    "Use the following format if using a tool:\n"
    "```\n"
    "Action: tool name (one of [{tool_names}])\n"
    "Action Input: the input to the tool, in a JSON format representing the kwargs "
    """(e.g. ```{{"input": "hello world", "num_beams": 5}}```)\n"""
    "```\n"
)

GLM4_TOOL_PROMPT = (
    "你是一个名为 ChatGLM 的人工智能助手。你是基于智谱AI训练的语言模型 GLM-4 模型开发的，"
    "你的任务是针对用户的问题和要求提供适当的答复和支持。# 可用工具{tool_text}"
)

LLAMA3_TOOL_PROMPT = (
    "Cutting Knowledge Date: December 2023\nToday Date: {date}\n\n"
    "You have access to the following functions. To call a function, please respond with JSON for a function call. "
    """Respond in the format {{"name": function name, "parameters": dictionary of argument name and its value}}. """
    "Do not use variables.\n\n{tool_text}"
)

QWEN_TOOL_PROMPT = (
    "\n\n# Tools\n\nYou may call one or more functions to assist with the user query.\n\n"
    "You are provided with function signatures within <tools></tools> XML tags:\n<tools>{tool_text}"
    "\n</tools>\n\nFor each function call, return a json object with function name and arguments within "
    """<tool_call></tool_call> XML tags:\n<tool_call>\n{{"name": <function-name>, """
    """"arguments": <args-json-object>}}\n</tool_call><|im_end|>\n"""
)


def _json(obj: Any, **kw) -> str:
    return json.dumps(obj, ensure_ascii=False, **kw)


@dataclasses.dataclass(frozen=True)
class ToolStyle:
    name: str
    describe_tools: Callable[[list[dict]], str]
    render_calls: Callable[[list[FunctionCall]], str]
    extract: Callable[[str], "str | list[FunctionCall]"]


# --- default (ReAct-ish Action/Action Input) -------------------------------


def _default_describe(tools: list[dict]) -> str:
    tool_text, names = "", []
    for tool in tools:
        param_text = ""
        for pname, param in tool["parameters"]["properties"].items():
            required = (
                ", required"
                if pname in tool["parameters"].get("required", [])
                else ""
            )
            enum = (
                ", should be one of [{}]".format(", ".join(param["enum"]))
                if param.get("enum")
                else ""
            )
            items = (
                ", where each item should be {}".format(
                    param["items"].get("type", "")
                )
                if param.get("items")
                else ""
            )
            param_text += (
                f"  - {pname} ({param.get('type', '')}{required}): "
                f"{param.get('description', '')}{enum}{items}\n"
            )
        tool_text += (
            f"> Tool Name: {tool['name']}\n"
            f"Tool Description: {tool.get('description', '')}\n"
            f"Tool Args:\n{param_text}\n"
        )
        names.append(tool["name"])
    return DEFAULT_TOOL_PROMPT.format(
        tool_text=tool_text, tool_names=", ".join(names)
    )


def _default_render(calls: list[FunctionCall]) -> str:
    return "".join(
        f"Action: {name}\nAction Input: {args}\n" for name, args in calls
    )


_DEFAULT_CALL_RE = re.compile(
    r"Action:\s*([a-zA-Z0-9_]+)\s*Action Input:\s*(.+?)(?=\s*Action:|\s*$)",
    re.DOTALL,
)


def _default_extract(content: str):
    matches = _DEFAULT_CALL_RE.findall(content)
    if not matches:
        return content
    out = []
    for name, raw in matches:
        raw = raw.strip().strip('"').strip("```")
        try:
            out.append(FunctionCall(name.strip(), _json(json.loads(raw))))
        except json.JSONDecodeError:
            return content
    return out


# --- glm4 ------------------------------------------------------------------


def _glm4_describe(tools: list[dict]) -> str:
    tool_text = "".join(
        "\n\n## {name}\n\n{body}\n在调用上述函数时，请使用 Json 格式表示调用的参数。".format(
            name=t["name"], body=_json(t, indent=4)
        )
        for t in tools
    )
    return GLM4_TOOL_PROMPT.format(tool_text=tool_text)


def _glm4_render(calls: list[FunctionCall]) -> str:
    if len(calls) > 1:
        raise ValueError("glm4 does not support parallel tool calls")
    return f"{calls[0].name}\n{calls[0].arguments}"


def _glm4_extract(content: str):
    if "\n" not in content:
        return content
    name, raw = content.split("\n", 1)
    try:
        return [FunctionCall(name, _json(json.loads(raw.strip())))]
    except json.JSONDecodeError:
        return content


# --- llama3 ----------------------------------------------------------------


def _llama3_describe(tools: list[dict], date: str | None = None) -> str:
    date = date or datetime.now().strftime("%d %b %Y")
    tool_text = "".join(
        _json({"type": "function", "function": t}, indent=4) + "\n\n"
        for t in tools
    )
    return LLAMA3_TOOL_PROMPT.format(date=date, tool_text=tool_text)


def _llama3_render(calls: list[FunctionCall]) -> str:
    if len(calls) > 1:
        raise ValueError("llama3 does not support parallel tool calls")
    return f'{{"name": "{calls[0].name}", "parameters": {calls[0].arguments}}}'


def _llama3_extract(content: str):
    try:
        tool = json.loads(content.strip())
    except json.JSONDecodeError:
        return content
    if not isinstance(tool, dict) or "name" not in tool or "parameters" not in tool:
        return content
    return [FunctionCall(tool["name"], _json(tool["parameters"]))]


# --- mistral ---------------------------------------------------------------


def _mistral_describe(tools: list[dict]) -> str:
    wrapped = [{"type": "function", "function": t} for t in tools]
    return "[AVAILABLE_TOOLS] " + _json(wrapped) + "[/AVAILABLE_TOOLS]"


def _mistral_render(calls: list[FunctionCall]) -> str:
    body = ", ".join(
        f'{{"name": "{name}", "arguments": {args}}}' for name, args in calls
    )
    return "[" + body + "]"


def _mistral_extract(content: str):
    try:
        tools = json.loads(content.strip())
    except json.JSONDecodeError:
        return content
    if not isinstance(tools, list):
        tools = [tools]
    out = []
    for tool in tools:
        if not isinstance(tool, dict) or "name" not in tool or "arguments" not in tool:
            return content
        out.append(FunctionCall(tool["name"], _json(tool["arguments"])))
    return out


# --- qwen ------------------------------------------------------------------


def _qwen_describe(tools: list[dict]) -> str:
    tool_text = "".join(
        "\n" + _json({"type": "function", "function": t}) for t in tools
    )
    return QWEN_TOOL_PROMPT.format(tool_text=tool_text)


def _qwen_render(calls: list[FunctionCall]) -> str:
    return "\n".join(
        "<tool_call>\n"
        + f'{{"name": "{name}", "arguments": {args}}}'
        + "\n</tool_call>"
        for name, args in calls
    )


_QWEN_CALL_RE = re.compile(
    r"<tool_call>(.+?)</tool_call>(?=\s*<tool_call>|\s*$)", re.DOTALL
)


def _qwen_extract(content: str):
    matches = _QWEN_CALL_RE.findall(content)
    if not matches:
        return content
    out = []
    for raw in matches:
        try:
            tool = json.loads(raw.strip())
        except json.JSONDecodeError:
            return content
        if "name" not in tool or "arguments" not in tool:
            return content
        out.append(FunctionCall(tool["name"], _json(tool["arguments"])))
    return out


TOOL_STYLES: dict[str, ToolStyle] = {
    s.name: s
    for s in (
        ToolStyle("default", _default_describe, _default_render, _default_extract),
        ToolStyle("glm4", _glm4_describe, _glm4_render, _glm4_extract),
        ToolStyle("llama3", _llama3_describe, _llama3_render, _llama3_extract),
        ToolStyle("mistral", _mistral_describe, _mistral_render, _mistral_extract),
        ToolStyle("qwen", _qwen_describe, _qwen_render, _qwen_extract),
    )
}


def get_tool_style(name: str) -> ToolStyle:
    try:
        return TOOL_STYLES[name]
    except KeyError:
        raise KeyError(
            f"unknown tool style {name!r}; known: {sorted(TOOL_STYLES)}"
        ) from None


def render_function_content(style: ToolStyle, content: str) -> str:
    """Assistant tool-call message content (JSON, single dict or list) ->
    the family's call syntax."""
    calls = json.loads(content)
    if not isinstance(calls, list):
        calls = [calls]
    return style.render_calls(
        [FunctionCall(c["name"], _json(c["arguments"])) for c in calls]
    )


def render_tools_content(style: ToolStyle, tools: "str | list") -> str:
    """Tool definitions (JSON string or list of dicts) -> system text."""
    if isinstance(tools, str):
        tools = json.loads(tools)
    return style.describe_tools(tools) if tools else ""
