"""The port's chat templates against the JAX package's: every registered
name renders and encodes one multi-turn conversation with a system
message, tools, a tool call (the ``function`` role) and its result (the
``observation`` role) on tests/helpers.py's tiny tokenizer, byte for byte
and id for id; ``register_template`` and ``get_template``'s refusal.

The llama3 tool style prints today's date: both packages' ``datetime`` is
pinned to one day, so a run across midnight compares like with like.
"""

import datetime
import json

import pytest

from iadr1_tpu.data import template as jax_template_mod
from iadr1_tpu.data import tools as jax_tools
from iadr1_tpu_torch.data import template as template_mod
from iadr1_tpu_torch.data import tools
import torch_threads  # noqa: F401  (one intra-op thread)

from helpers import tiny_qwen_tokenizer

TOOLS = [{
    "name": "inspect_region",
    "description": "Zoom into one region of the image",
    "parameters": {
        "type": "object",
        "properties": {
            "region": {"type": "string", "description": "where to look",
                       "enum": ["top", "bottom"]},
            "scales": {"type": "array", "description": "zoom factors",
                       "items": {"type": "number"}},
        },
        "required": ["region"],
    },
}]
CALL = json.dumps({"name": "inspect_region",
                   "arguments": {"region": "top", "scales": [2, 4]}})
MESSAGES = [
    {"role": "user", "content": "Are there any defects in the image?"},
    {"role": "function", "content": CALL},
    {"role": "observation", "content": "a scratch near the top left"},
    {"role": "assistant",
     "content": "<answer>Yes</answer><type>scratch</type>"},
]
SYSTEM = "You are a helpful assistant."


class _Day(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2)


@pytest.fixture(autouse=True)
def pinned_date(monkeypatch):
    monkeypatch.setattr(jax_tools, "datetime", _Day)
    monkeypatch.setattr(tools, "datetime", _Day)


@pytest.fixture(scope="module")
def tok():
    return tiny_qwen_tokenizer()


def test_every_jax_name_is_registered():
    assert sorted(template_mod.TEMPLATES) == sorted(
        jax_template_mod.TEMPLATES)
    assert len(template_mod.TEMPLATES) == 80


@pytest.mark.parametrize("name", sorted(jax_template_mod.TEMPLATES))
def test_template_renders_and_encodes_as_jax(name, tok):
    """One conversation through render_conversation (with and without the
    generation preamble, with the default system too), encode_multiturn
    and encode_prompt: strings equal byte for byte, ids equal."""
    got = template_mod.get_template(name)
    want = jax_template_mod.get_template(name)
    for system in (SYSTEM, None):
        for gen in (False, True):
            kw = dict(system=system, add_generation_prompt=gen,
                      eos_text="</s>", bos_text="<s>", tools=TOOLS)
            assert (got.render_conversation(MESSAGES, **kw)
                    == want.render_conversation(MESSAGES, **kw))
        assert got.encode_multiturn(tok, MESSAGES, system, tools=TOOLS) == [
            tuple(p) for p in want.encode_multiturn(tok, MESSAGES, system,
                                                    tools=TOOLS)]
        prompt = MESSAGES[:3]
        assert got.encode_prompt(tok, prompt, system) == want.encode_prompt(
            tok, prompt, system)
    assert (got.stop_words, got.image_token, got.mm_style, got.tool_style,
            got.efficient_eos) == (want.stop_words, want.image_token,
                                   want.mm_style, want.tool_style,
                                   want.efficient_eos)


def test_round_counter_and_tools_reach_the_text():
    """chatglm2's ``{idx}`` counts the rounds; qwen's tools fold into the
    system block and its tool call renders as <tool_call> JSON."""
    text = template_mod.get_template("chatglm2").render_conversation(
        MESSAGES, eos_text="</s>")
    assert "[Round 0]" in text and "[Round 1]" in text
    text = template_mod.get_template("qwen").render_conversation(
        MESSAGES, SYSTEM, tools=TOOLS, eos_text="</s>")
    assert text.startswith(f"<|im_start|>system\n{SYSTEM}\n\n# Tools")
    assert ('<tool_call>\n{"name": "inspect_region", "arguments": '
            '{"region": "top", "scales": [2, 4]}}\n</tool_call>') in text
    assert "<tool_response>\na scratch near the top left\n" in text


def test_register_template_matches_jax(monkeypatch, tok):
    """A template registered by the caller is returned by get_template and
    renders as the same registration does in JAX."""
    monkeypatch.setattr(template_mod, "TEMPLATES",
                        dict(template_mod.TEMPLATES))
    monkeypatch.setattr(jax_template_mod, "TEMPLATES",
                        dict(jax_template_mod.TEMPLATES))
    for mod in (template_mod, jax_template_mod):
        mod.register_template(mod.ChatTemplate(
            name="inspection", user=("Q: {content}\nA:",),
            assistant=(" {content}", mod.EOS), system=("# {content}\n",),
            prefix=(mod.BOS,), observation=("Tool: {content}\nA:",),
            tool_style="qwen"))
    got = template_mod.get_template("inspection")
    want = jax_template_mod.get_template("inspection")
    assert got.name == "inspection"
    assert (got.render_conversation(MESSAGES, SYSTEM, tools=TOOLS,
                                    eos_text="</s>", bos_text="<s>")
            == want.render_conversation(MESSAGES, SYSTEM, tools=TOOLS,
                                        eos_text="</s>", bos_text="<s>"))
    assert got.encode_multiturn(tok, MESSAGES, SYSTEM) == [
        tuple(p) for p in want.encode_multiturn(tok, MESSAGES, SYSTEM)]


def test_an_unknown_name_is_refused_with_the_known_ones():
    with pytest.raises(KeyError, match="unknown template 'nope'; known:") as e:
        template_mod.get_template("nope")
    assert "'qwen2_vl'" in str(e.value) and "'custom'" in str(e.value)
    with pytest.raises(ValueError, match="unsupported role"):
        template_mod.get_template("qwen").render_message(
            "tool", "x", True, None)
