"""The port's SFT data path against the JAX package's: the dataset registry,
the aligners, ``infer_seqlen``, ``ChatTemplate.encode_multiturn``,
``encode_supervised_example``, ``prepare_rows`` (sft with images, text
only through a VLM, a text model given image rows, pt, a registry dataset
in both formats, an inline one) and the tokenized cache.  Everything here
is integer bookkeeping or a copy of the same numpy preprocessing, so every
comparison is exact."""

import dataclasses
import json
import os

import numpy as np
import pytest

from helpers import build_iad_sft_dataset, build_tiny_vlm_checkpoint, tiny_qwen_tokenizer
from iadr1_tpu.cli import train_sft as jax_sft
from iadr1_tpu.data import aligner as jax_aligner
from iadr1_tpu.data import cache as jax_cache
from iadr1_tpu.data import registry as jax_registry
from iadr1_tpu.data import tokenize as jax_tokenize
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu_torch.cli import train_sft
from iadr1_tpu_torch.data import aligner, cache, registry, tokenize
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.models.registry import bundle_from_hf_config

QWEN2 = dict(architectures=["Qwen2ForCausalLM"], vocab_size=600,
             hidden_size=32, intermediate_size=64, num_hidden_layers=1,
             num_attention_heads=2, num_key_value_heads=1)


@pytest.fixture(scope="module")
def tok():
    return tiny_qwen_tokenizer()


@pytest.fixture(scope="module")
def vlm_hf(tmp_path_factory):
    path = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# token budgets and the multi-turn encoding
# ---------------------------------------------------------------------------


def test_infer_seqlen_matches_jax():
    for src in range(1, 40, 3):
        for tgt in range(1, 40, 3):
            for cutoff in (0, 1, 7, 16, 33, 64):
                assert tokenize.infer_seqlen(src, tgt, cutoff) == \
                    jax_tokenize.infer_seqlen(src, tgt, cutoff)


CONVERSATIONS = [
    # one turn, the template's default system block
    ([{"role": "user", "content": "Are there any defects in the image?"},
      {"role": "assistant", "content": "<answer>No</answer>"}], None),
    # a system turn and three turn pairs
    ([{"role": "user", "content": "hi"},
      {"role": "assistant", "content": "hello"},
      {"role": "user", "content": "<|vision_start|><|image_pad|>"
       "<|image_pad|><|vision_end|>Any scratch?"},
      {"role": "assistant", "content": "<think>looks clean</think>"
       "<answer>No</answer>"},
      {"role": "user", "content": "The quick brown fox " * 6},
      {"role": "assistant", "content": "jumps over the lazy dog " * 5}],
     "You are an expert in detecting anomalies."),
    # an empty system: no system block at all
    ([{"role": "user", "content": "top left"},
      {"role": "assistant", "content": "scratch"}], ""),
]


@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
def test_encode_multiturn_matches_jax(conv, tok):
    messages, system = CONVERSATIONS[conv]
    got = get_template("qwen2_vl").encode_multiturn(tok, messages, system)
    want = jax_template("qwen2_vl").encode_multiturn(tok, messages, system)
    assert got == want
    assert len(got) == len(messages) // 2


def test_encode_multiturn_rejects_an_odd_conversation(tok):
    with pytest.raises(ValueError, match="alternate"):
        get_template("qwen2_vl").encode_multiturn(
            tok, CONVERSATIONS[0][0][:1])


@pytest.mark.parametrize("cutoff", [1, 5, 12, 30, 57, 4096])
@pytest.mark.parametrize("train_on_prompt,mask_history",
                         [(False, False), (True, False), (False, True)])
def test_encode_supervised_example_matches_jax(cutoff, train_on_prompt,
                                               mask_history, tok):
    """Every conversation at budgets that cut inside the first turn,
    between turns and not at all."""
    for messages, system in CONVERSATIONS:
        kw = dict(system=system, cutoff_len=cutoff,
                  train_on_prompt=train_on_prompt, mask_history=mask_history)
        got = tokenize.encode_supervised_example(
            messages, get_template("qwen2_vl"), tok, **kw)
        want = jax_tokenize.encode_supervised_example(
            messages, jax_template("qwen2_vl"), tok, **kw)
        assert got == want
        assert len(got[0]) == len(got[1]) <= cutoff


# ---------------------------------------------------------------------------
# registry and aligners
# ---------------------------------------------------------------------------

DATASET_INFO = {
    "iad_sharegpt": {
        "file_name": "share.json", "formatting": "sharegpt",
        "columns": {"messages": "conversations", "images": "images",
                    "system": "system"},
        "tags": {"role_tag": "from", "content_tag": "value",
                 "user_tag": "human", "assistant_tag": "gpt"},
    },
    "iad_alpaca": {
        "file_name": "alpaca.jsonl", "num_samples": 5,
        "columns": {"prompt": "instruction", "query": "input",
                    "response": "output", "history": "history",
                    "system": "system"},
    },
    "remote": {"hf_hub_url": "org/remote", "subset": "s", "split": "test",
               "num_samples": 2},
}

SHAREGPT_ROWS = [
    {"conversations": [
        {"from": "system", "value": "Inspect the part."},
        {"from": "human", "value": "<image>Any defect?"},
        {"from": "gpt", "value": "<answer>Yes</answer>"}],
     "images": ["img_0.png"]},
    {"conversations": [
        {"from": "human", "value": "<image>Any defect?"},
        {"from": "gpt", "value": "<answer>No</answer>"},
        {"from": "human", "value": "Sure?"},
        {"from": "gpt", "value": "<think>clean</think><answer>No</answer>"}],
     "images": ["img_1.png"], "system": "Be brief."},
    # malformed: two user turns in a row, an odd count, an unknown role
    {"conversations": [{"from": "human", "value": "a"},
                       {"from": "human", "value": "b"}]},
    {"conversations": [{"from": "human", "value": "a"}]},
    {"conversations": [{"from": "robot", "value": "a"},
                       {"from": "gpt", "value": "b"}]},
]

ALPACA_ROWS = [
    {"instruction": "Describe the defect.", "input": "top left",
     "output": "A scratch.", "system": "Be precise."},
    {"instruction": "Is it normal?", "output": "Yes.",
     "history": [["hi", "hello"], ["again", "hello again"]]},
    {"instruction": "", "input": "only input", "output": "ok"},
    {"instruction": "no answer"},                       # dropped
    {"instruction": "a", "input": "b", "output": "c"},
    {"instruction": "d", "output": "e"},
    {"instruction": "beyond num_samples", "output": "x"},
]


def _write_registry(root):
    with open(os.path.join(root, "dataset_info.json"), "w") as f:
        json.dump(DATASET_INFO, f)
    with open(os.path.join(root, "share.json"), "w") as f:
        json.dump(SHAREGPT_ROWS, f)
    with open(os.path.join(root, "alpaca.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in ALPACA_ROWS) + "\n\n")
    return os.path.join(root, "dataset_info.json")


def test_registry_and_aligners_match_jax(tmp_path):
    info = _write_registry(str(tmp_path))
    ours = registry.load_dataset_registry(info)
    theirs = jax_registry.load_dataset_registry(info)
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert dataclasses.asdict(ours[name]) == dataclasses.asdict(
            theirs[name])
        if ours[name].file_name is None:
            continue
        for attr in (ours[name], theirs[name]):
            attr.file_name = os.path.join(str(tmp_path), attr.file_name)
        rows = registry.load_json_dataset(ours[name])
        assert rows == jax_registry.load_json_dataset(theirs[name])
        for image_dir in (None, str(tmp_path / "imgs")):
            assert aligner.align_rows(rows, ours[name], image_dir) == \
                jax_aligner.align_rows(rows, theirs[name], image_dir)
    assert len(registry.load_json_dataset(ours["iad_alpaca"])) == 5
    assert len(aligner.align_rows(SHAREGPT_ROWS, ours["iad_sharegpt"])) == 2


def test_hub_datasets_go_through_the_fetcher_registry(tmp_path):
    info = _write_registry(str(tmp_path))
    attr = registry.load_dataset_registry(info)["remote"]
    assert registry.hub_source(attr) == ("hf_hub", "org/remote")
    seen = []

    def fake(a):
        seen.append((a.hf_hub_url, a.subset, a.split))
        return [{"instruction": str(i), "output": "o"} for i in range(4)]

    assert len(registry.load_json_dataset(attr, hub_fetcher=fake)) == 2
    prev = registry.register_hub_fetcher("hf_hub", fake)
    try:
        assert len(registry.load_json_dataset(attr)) == 2
    finally:
        registry.register_hub_fetcher("hf_hub", prev)
    assert seen == [("org/remote", "s", "test")] * 2
    with pytest.raises(ValueError, match="no file_name or hub url"):
        registry.load_json_dataset(registry.DatasetAttr(name="nothing"))


# ---------------------------------------------------------------------------
# prepare_rows, both packages
# ---------------------------------------------------------------------------


def _rows_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for key in ("input_ids", "labels", "segment_ids", "position_ids"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        ea, eb = a.get("extras", []), b.get("extras", [])
        assert len(ea) == len(eb)
        for xa, xb in zip(ea, eb):
            assert [tuple(g) for g in xa["grid_thw"]] == [
                tuple(g) for g in xb["grid_thw"]]
            for pa, pb in zip(xa["patches"], xb["patches"], strict=True):
                np.testing.assert_array_equal(pa, pb)


def _both(tok, hf, data: dict, stage="sft"):
    got = train_sft.prepare_rows(
        train_sft.DataSection(**data), tok, get_template("qwen2_vl"),
        bundle_from_hf_config(hf), stage=stage)
    want = jax_sft.prepare_rows(
        jax_sft.DataSection(**data), tok, jax_template("qwen2_vl"),
        jax_bundle(hf, attention="xla"), stage=stage)
    _rows_equal(got, want)
    return got


IMAGE_KW = dict(min_pixels=56 * 56, max_pixels=56 * 56 * 4)


def test_prepare_rows_sft_with_images_matches_jax(tok, vlm_hf, tmp_path):
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    rows = _both(tok, vlm_hf, dict(dataset=data_path, image_dir=img_dir,
                                   cutoff_len=256, **IMAGE_KW))
    assert sum(len(r["extras"]) for r in rows) == 12
    assert max(int(r["segment_ids"].max()) for r in rows) >= 2


def test_prepare_rows_cuts_a_long_image_row_at_the_cutoff(tok, vlm_hf,
                                                          tmp_path):
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    rows = _both(tok, vlm_hf, dict(dataset=data_path, image_dir=img_dir,
                                   cutoff_len=40, max_samples=3, **IMAGE_KW))
    assert all(int(r["segment_ids"].max()) == 1 for r in rows)


def _text_dataset(root):
    rows = [{"messages": [
        {"role": "system", "content": "You inspect metal parts."},
        {"role": "user", "content": "Any scratch on the part? " * (1 + i)},
        {"role": "assistant", "content": "<answer>No</answer>" * (1 + i)},
        {"role": "user", "content": "And on the left?"},
        {"role": "assistant", "content": "<think>checked</think>"}]}
        for i in range(5)] + [
        {"messages": [{"role": "user", "content": "hi"},
                      {"role": "assistant", "content": "hello"}]},
        {"text": "The quick brown fox jumps over the lazy dog",
         "messages": []}]
    path = os.path.join(root, "text.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return path


@pytest.mark.parametrize("stage", ["sft", "pt"])
@pytest.mark.parametrize("model", ["qwen2_vl", "qwen2"])
def test_prepare_rows_text_only_matches_jax(stage, model, tok, vlm_hf,
                                            tmp_path):
    hf = vlm_hf if model == "qwen2_vl" else QWEN2
    rows = _both(tok, hf, dict(dataset=_text_dataset(str(tmp_path)),
                               cutoff_len=48), stage=stage)
    if stage == "pt":                           # every token is labeled
        for r in rows:
            real = r["segment_ids"] != 0
            np.testing.assert_array_equal(r["labels"][real],
                                          r["input_ids"][real])


def test_prepare_rows_text_model_strips_image_placeholders(tok, tmp_path):
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    rows = _both(tok, QWEN2, dict(dataset=data_path, image_dir=img_dir,
                                  cutoff_len=64))
    image = tok.convert_tokens_to_ids("<image>")
    assert not any((r["input_ids"] == image).any() for r in rows)


@pytest.mark.parametrize("name", ["iad_sharegpt", "iad_alpaca"])
def test_prepare_rows_from_the_registry_matches_jax(name, tok, vlm_hf,
                                                    tmp_path, monkeypatch):
    info = _write_registry(str(tmp_path))
    build_iad_sft_dataset(tmp_path)             # img_0.png, img_1.png, ...
    monkeypatch.chdir(tmp_path)                 # file_name is relative
    _both(tok, vlm_hf, dict(dataset=name, dataset_info=info,
                            image_dir=str(tmp_path / "images"),
                            cutoff_len=64, **IMAGE_KW))


def test_the_paligemma_branch_names_its_roadmap_item(tok, vlm_hf, tmp_path):
    """The PaliGemma branch is ported (tests/test_torch_paligemma.py): with
    the paligemma mm style the placeholders are stripped and each image's
    run goes ahead of the encoded ids, rows equal to JAX's."""
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    data = dict(dataset=data_path, image_dir=img_dir, cutoff_len=256,
                **IMAGE_KW)
    got = train_sft.prepare_rows(
        train_sft.DataSection(**data), tok,
        dataclasses.replace(get_template("qwen2_vl"), mm_style="paligemma"),
        bundle_from_hf_config(vlm_hf))
    want = jax_sft.prepare_rows(
        jax_sft.DataSection(**data), tok,
        dataclasses.replace(jax_template("qwen2_vl"), mm_style="paligemma"),
        jax_bundle(vlm_hf, attention="xla"))
    _rows_equal(got, want)
    image = tok.convert_tokens_to_ids("<|image_pad|>")
    assert all(int(r["input_ids"][0]) == image for r in got)


# ---------------------------------------------------------------------------
# the tokenized cache
# ---------------------------------------------------------------------------


def test_tokenized_cache_round_trips_and_reads_as_jax(tok, tmp_path):
    rows = train_sft.prepare_rows(
        train_sft.DataSection(dataset=_text_dataset(str(tmp_path)),
                              cutoff_len=48), tok, get_template("qwen2_vl"),
        bundle_from_hf_config(QWEN2))
    path = str(tmp_path / "cache" / "rows.npz")
    assert cache.load_tokenized(path) is None
    assert cache.save_tokenized(path, rows)
    for loaded in (cache.load_tokenized(path),
                   jax_cache.load_tokenized(path)):
        assert len(loaded) == len(rows)
        for a, b in zip(loaded, rows):
            assert set(a) == set(cache._FIELDS)
            for key in cache._FIELDS:
                np.testing.assert_array_equal(a[key], b[key])
    # rows with images are not cached: their patches are derived again
    assert not cache.save_tokenized(str(tmp_path / "vlm.npz"), [
        dict(rows[0], extras=[{"patches": [np.zeros((4, 8))]}])])
    assert not os.path.exists(tmp_path / "vlm.npz")
