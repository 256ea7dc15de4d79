"""The port's tool styles against the JAX package's: for each of the five
styles, the tool descriptions (the system text), the rendered calls, and
the calls extracted again from rendered and from plain text, equal."""

import json

import pytest

from iadr1_tpu.data import tools as jax_tools
from iadr1_tpu_torch.data import tools
import torch_threads  # noqa: F401  (one intra-op thread)

STYLES = ("default", "glm4", "llama3", "mistral", "qwen")
TOOLS = [
    {"name": "inspect_region",
     "description": "Zoom into one region of the image",
     "parameters": {
         "type": "object",
         "properties": {
             "region": {"type": "string", "description": "where to look",
                        "enum": ["top", "bottom"]},
             "scales": {"type": "array", "description": "zoom factors",
                        "items": {"type": "number"}},
         },
         "required": ["region"]}},
    {"name": "measure",
     "description": "Length of a defect in mm",
     "parameters": {"type": "object",
                    "properties": {"defect": {"type": "string"}}}},
]
ONE_CALL = [{"name": "inspect_region",
             "arguments": {"region": "top", "scales": [2, 4]}}]
TWO_CALLS = ONE_CALL + [{"name": "measure",
                         "arguments": {"defect": "scratch é"}}]


def test_the_styles_are_jax_styles():
    assert sorted(tools.TOOL_STYLES) == sorted(jax_tools.TOOL_STYLES)
    assert sorted(tools.TOOL_STYLES) == sorted(STYLES)
    with pytest.raises(KeyError, match="unknown tool style"):
        tools.get_tool_style("nope")


@pytest.mark.parametrize("name", STYLES)
def test_style_describes_renders_and_extracts_as_jax(name):
    got, want = tools.get_tool_style(name), jax_tools.get_tool_style(name)
    if name == "llama3":
        assert (got.describe_tools(TOOLS, date="02 Jan 2026")
                == want.describe_tools(TOOLS, date="02 Jan 2026"))
    else:
        assert (tools.render_tools_content(got, TOOLS)
                == jax_tools.render_tools_content(want, TOOLS))
        assert (tools.render_tools_content(got, json.dumps(TOOLS))
                == jax_tools.render_tools_content(want, json.dumps(TOOLS)))
    assert tools.render_tools_content(got, []) == ""
    parallel = name not in ("glm4", "llama3")
    for calls in (ONE_CALL, TWO_CALLS, ONE_CALL[0]):
        content = json.dumps(calls)
        if isinstance(calls, list) and len(calls) > 1 and not parallel:
            with pytest.raises(ValueError, match="parallel"):
                tools.render_function_content(got, content)
            continue
        rendered = tools.render_function_content(got, content)
        assert rendered == jax_tools.render_function_content(want, content)
        extracted = got.extract(rendered)
        assert extracted == want.extract(rendered)
        n = len(calls) if isinstance(calls, list) else 1
        assert len(extracted) == n
        assert all(isinstance(c, tools.FunctionCall) for c in extracted)
        assert [c.name for c in extracted] == [
            c["name"] for c in (calls if isinstance(calls, list) else [calls])]
    for text in ("No defect was found.", "Action: x\nAction Input: {bad",
                 "<tool_call>{bad}</tool_call>", '{"name": "x"}'):
        assert got.extract(text) == want.extract(text) == text
