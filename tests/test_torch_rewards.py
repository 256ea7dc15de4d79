"""The port's reward functions and prompt data (host-side Python) against
the JAX package's: exact equality of every float on golden case lists
(the lists of tests/test_rewards.py and tests/test_description_reward.py,
copied here), and equal prompt strings and conversation dicts."""

import pytest

from iadr1_tpu import rewards as jr
from iadr1_tpu.rewards import description as jdesc
from iadr1_tpu.train import prompts as jprompts
from iadr1_tpu_torch import rewards as tr
from iadr1_tpu_torch.rewards import description as tdesc
from iadr1_tpu_torch.train import prompts as tprompts
import torch_threads  # noqa: F401  (one intra-op thread)


def conv(s):
    return [{"role": "assistant", "content": s}]


TYPE_GOLDENS = [
    ("scratch", "scratch", 1.0),
    ("scratch mark", "scratch", 0.85),
    ("linear scratch", "surface scratch", 0.85),
    ("a small scratch", "scratch", 0.85),
    ("dirt", "stain", 0.85),
    ("hole", "opening", 0.85),
    ("perforation", "crack", 0.0),
    ("crack", "fracture", 0.0),
    ("dent", "deformation", 0.0),
    ("scratch", "hole", 0.0),
    ("surface anomaly", "scratch", 0.3),
    ("scratch", "structural anomaly", 0.0),
    ("surface anomalies", "structural anomalies", 0.0),
    ("", "scratch", 0.0),
    ("scratch", "", 0.0),
    ("scrach", "scratch", 0.8307692307692307),
    ("missing part", "gap", 0.85),
    ("bent component", "warping", 0.85),
    ("foreign object", "debris", 0.85),
    ("wear", "abrasion", 0.85),
    ("broken", "breakage", 0.0),
    ("contamination", "surface contamination", 0.85),
    ("weird thing", "blob", 0.0),
    ("blob", "blobby", 0.85),
    ("damage", "structural damage", 0.85),
    ("hole", "void", 0.85),
    ("surface scratch on metal", "scratch", 0.85),
    ("color anomaly", "stain", 0.85),
    ("puncture", "surface scratch", 0.0),
    ("structural anomaly", "hole", 0.3),
]


LOCATION_GOLDENS = [
    ("top left", "upper left", 1),
    ("top-left corner", "left top", 1),
    ("center", "middle", 1),
    ("left side", "left", 1),
    ("bottom right", "lower right", 1),
    ("top", "bottom", 0),
    ("the upper part", "top area", 1),
    ("right", "left", 0),
    ("center of image", "the middle region", 1),
    ("bottom left corner", "lower-left", 1),
    ("somewhere", "center", 1),
    ("top right", "top", 0),
]


CONSISTENCY_GOLDENS = [
    ("<think>x</think><answer>No</answer>", "<answer>no</answer>", 1.0),
    ("<think>x</think><answer>No</answer>", "<answer>yes</answer>", 0.0),
    ("<think>x</think><location>top</location><type>scratch</type><answer>Yes</answer>",
     "<answer>yes</answer>", 1.0),
    ("<think>x</think><location>top</location><type>scratch</type><answer>Yes</answer>",
     "<answer>no</answer>", 0.0),
    # tag order matters: type before location fails
    ("<think>x</think><type>scratch</type><location>top</location><answer>Yes</answer>",
     "<answer>yes</answer>", 0.0),
    # separator between adjacent tags fails
    ("<think>x</think>\n<answer>no</answer>", "<answer>no</answer>", 0.0),
    # leading/trailing junk is tolerated
    ("prefix <think>x</think><answer>no</answer> suffix", "<answer>no</answer>", 1.0),
    # missing think fails
    ("<answer>no</answer>", "<answer>no</answer>", 0.0),
    # a location tag anywhere poisons the "no" pattern
    ("<think>a<location>l</location>b</think><answer>no</answer>",
     "<answer>no</answer>", 0.0),
    # empty payloads are fine
    ("<think>x</think><location></location><type></type><answer>yes</answer>",
     "<answer>yes</answer>", 1.0),
]


ACCURACY_GOLDENS = [
    ("<think>x</think><answer>no</answer>", "<answer>no</answer>", 1.0),
    ("<think>x</think><answer>yes</answer>", "<answer>no</answer>", 0.0),
    ("<think>x</think><location>top left</location><type>scratch</type><answer>yes</answer>",
     "<think>g</think><location>upper left</location><type>scratch</type><answer>yes</answer>",
     2.0),
    ("<think>x</think><location>bottom</location><type>hole</type><answer>yes</answer>",
     "<think>g</think><location>top</location><type>scratch</type><answer>yes</answer>",
     1.0),
    ("<think>x</think><answer>yes</answer>",
     "<think>g</think><location>top</location><type>scratch</type><answer>yes</answer>",
     1.0),
    # partial credit accrues even with the wrong verdict
    ("<think>x</think><location>top</location><type>dirt</type><answer>no</answer>",
     "<think>g</think><location>top</location><type>stain</type><answer>yes</answer>",
     0.925),
    ("no answer tags at all", "<answer>no</answer>", 0.0),
    ("<answer>NO</answer>", "<answer>No</answer>", 1.0),
    ("<think>x</think><location>center</location><type>surface contamination</type><answer>yes</answer>",
     "<think>g</think><location>middle</location><type>stain</type><answer>yes</answer>",
     1.925),
]


# completions x solutions for every registry function: the goldens' own
# pairs plus the CoT-ablation grammar (description tags, missing tags,
# answers contradicting the tags, newlines inside payloads)
COT = [
    "<think>t</think><location>l</location><type>y</type>"
    "<description>d</description><answer>yes</answer>",
    "<think>t</think><location>l</location><type>y</type><answer>yes</answer>",
    "<think>t</think><type>y</type><answer>yes</answer>",
    "<think>t</think><answer>yes</answer>",
    "<think>t</think><answer>no</answer>",
    "<think>t</think><type>y</type><answer>no</answer>",
    "<think>a\nb</think><location>top\nleft</location><type>scratch</type>"
    "<answer>Yes</answer>",
    "<THINK>t</THINK><ANSWER>Yes</ANSWER>",
    "free text with no tags",
    "",
]
SOLUTIONS = [
    "<answer>no</answer>", "<answer>yes</answer>", "<answer>No</answer>",
    "<think>g</think><location>upper left</location><type>scratch</type>"
    "<answer>yes</answer>",
    "<think>g</think><type>stain</type><answer>Yes</answer>",
    "yes", "maybe", "<ANSWER>YES</ANSWER>",
]
CONTENTS = sorted({c for c, _, _ in CONSISTENCY_GOLDENS + ACCURACY_GOLDENS}
                  | set(COT))
ALL_SOLUTIONS = sorted({s for _, s, _ in CONSISTENCY_GOLDENS
                        + ACCURACY_GOLDENS} | set(SOLUTIONS))


def test_registries_name_the_same_functions():
    assert list(tr.REWARD_REGISTRY) == list(jr.REWARD_REGISTRY)
    assert len(tr.REWARD_REGISTRY) == 9
    for name, fn in tr.REWARD_REGISTRY.items():
        assert fn.__name__ == jr.REWARD_REGISTRY[name].__name__
        assert fn.__module__.startswith("iadr1_tpu_torch.")
    assert tr.get_reward_funcs(["accuracy", "format"]) == [
        tr.accuracy_reward, tr.consistency_reward]


@pytest.mark.parametrize("name", list(jr.REWARD_REGISTRY))
def test_registry_function_equals_jax_on_every_pair(name):
    """Every content against every solution, one batch per solution."""
    ours, ref = tr.REWARD_REGISTRY[name], jr.REWARD_REGISTRY[name]
    comps = [conv(c) for c in CONTENTS]
    for sol in ALL_SOLUTIONS:
        got = ours(comps, [sol] * len(comps), current_step=3)
        want = ref(comps, [sol] * len(comps), current_step=3)
        assert got == want, (name, sol)
        assert type(got) is type(want)


@pytest.mark.parametrize("pred,actual,expected", TYPE_GOLDENS)
def test_type_score(pred, actual, expected):
    assert tr.type_score(pred, actual) == jr.type_score(pred, actual)
    assert tr.type_score(pred, actual) == pytest.approx(expected, abs=1e-12)
    assert (tr.AnomalyTypeScorer().score(pred, actual)
            == jr.AnomalyTypeScorer().score(pred, actual))


def test_type_score_constants():
    from iadr1_tpu.rewards import type_taxonomy as jt
    from iadr1_tpu_torch.rewards import type_taxonomy as tt

    for name in ("SCORE_EXACT", "SCORE_SEMANTIC", "SCORE_CATEGORY",
                 "SCORE_FUZZY", "SCORE_GROUP", "FUZZY_THRESHOLD"):
        assert getattr(tt, name) == getattr(jt, name)


@pytest.mark.parametrize("pred,actual,expected", LOCATION_GOLDENS)
def test_location_score(pred, actual, expected):
    assert tr.location_score(pred, actual) == expected
    assert tr.location_score(pred, actual) == jr.location_score(pred, actual)
    for text in (pred, actual):
        assert tr.location_cell(text) == jr.location_cell(text)


@pytest.mark.parametrize("content,sol,expected", CONSISTENCY_GOLDENS)
def test_score_consistency(content, sol, expected):
    assert tr.score_consistency(content, sol) == expected
    assert (tr.score_consistency(content, sol)
            == jr.score_consistency(content, sol))
    assert tr.consistency_reward([conv(content)], [sol]) == [expected]


@pytest.mark.parametrize("content,sol,expected", ACCURACY_GOLDENS)
def test_score_accuracy(content, sol, expected):
    assert tr.score_accuracy(content, sol) == jr.score_accuracy(content, sol)
    assert tr.accuracy_reward([conv(content)], [sol]) == pytest.approx(
        [expected], abs=1e-12)


def test_extractors_equal_jax():
    from iadr1_tpu.rewards import structure as js
    from iadr1_tpu_torch.rewards import structure as ts

    for text in CONTENTS + ALL_SOLUTIONS:
        assert ts.extract_answer(text) == js.extract_answer(text)
        assert (ts.extract_answer(text, ignorecase=True)
                == js.extract_answer(text, ignorecase=True))
        for tag in ("think", "answer", "type", "location"):
            assert ts.extract_tag(tag, text) == js.extract_tag(tag, text)
            assert ts.has_tag(tag, text) == js.has_tag(tag, text)
    comps = [conv(c) for c in CONTENTS]
    assert ts.completion_texts(comps) == js.completion_texts(comps) == CONTENTS


DESCRIPTIONS = [
    ("a small scratch", "a small scratch"),
    ("scratch on top", "dent at bottom"),
    ("", "anything"),
    ("anything", ""),
    ("A deep scratch, on the LEFT side", "deep scratch left"),
    ("scratch scratch dent", "scratch dent dent"),
    ("!!!", "scratch"),
]


@pytest.fixture
def _no_backend():
    yield
    tdesc.register_embedding_backend(None)
    jdesc.register_embedding_backend(None)


@pytest.mark.parametrize("pred,actual", DESCRIPTIONS)
def test_description_score(pred, actual, _no_backend):
    assert tdesc.description_score(pred, actual) == jdesc.description_score(
        pred, actual)
    assert tdesc._bow_cosine(pred, actual) == jdesc._bow_cosine(pred, actual)
    # a registered backend replaces the bag of words in both
    embed = lambda texts: [[float(len(t)), 1.0, float(t.count("s"))]
                           for t in texts]
    tdesc.register_embedding_backend(embed)
    jdesc.register_embedding_backend(embed)
    assert tdesc.description_score(pred, actual) == jdesc.description_score(
        pred, actual)


def test_description_bow_ordering():
    assert tdesc.description_score("a small scratch", "a small scratch") == 1.0
    assert tdesc.description_score("scratch on top", "dent at bottom") < 0.5
    assert tdesc.description_score("", "anything") == 0.0


@pytest.mark.parametrize("make", ["make_transformer_embedding_backend",
                                  "make_bundle_embedding_backend"])
def test_embedding_backends_wait_for_their_roadmap_item(make):
    args = ("path",) if "transformer" in make else (None, None, None)
    with pytest.raises(NotImplementedError, match="A.15"):
        getattr(tdesc, make)(*args)


PROMPT_NAMES = ["SYSTEM_PROMPT_0SHOT", "QUESTION_PROMPT_0SHOT",
                "SYSTEM_PROMPT_1SHOT", "QUESTION_PROMPT_1SHOT"]


@pytest.mark.parametrize("name", PROMPT_NAMES)
def test_prompt_constants_are_byte_equal(name):
    assert getattr(tprompts, name) == getattr(jprompts, name)
    assert getattr(tprompts, name).encode() == getattr(jprompts, name).encode()


ROWS = [
    {"image": "a.png", "problem": "Any defects?", "solution": "<answer>No</answer>"},
    {"image": ["ref.png", {"path": "test.png"}], "problem": "Compare.",
     "solution": "<answer>Yes</answer>"},
    {"problem": "No image at all."},
]


@pytest.mark.parametrize("row", ROWS, ids=["one", "two", "none"])
@pytest.mark.parametrize("use_system_prompt", [False, True])
@pytest.mark.parametrize("single_img", [1, 0])
def test_make_conversation_equals_jax(row, use_system_prompt, single_img):
    kw = dict(image_path="/data/img", use_system_prompt=use_system_prompt,
              single_img=single_img)
    assert tprompts.make_conversation(row, **kw) == jprompts.make_conversation(
        row, **kw)
    assert (tprompts.make_conversation(row, image_path=None)
            == jprompts.make_conversation(row, image_path=None))
