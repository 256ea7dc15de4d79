"""The port's benchmark eval against the JAX package's: MCQ parsing and
answer extraction, the accuracy tables and their CSV (byte for byte, with
no pandas in the port), the resumable harness, the infer and summarize
CLIs on the tiny Qwen2-VL checkpoint, the pretrain mode's system prompt,
the over-long image prompt, and the weight swap."""

import filecmp
import functools
import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from helpers import build_benchmark_json, build_tiny_vlm_checkpoint, tiny_qwen_tokenizer
from iadr1_tpu.cli.infer import main as jax_infer_main
from iadr1_tpu.cli.summarize import main as jax_summarize_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.mm import expand_image_tokens as jax_expand
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval import harness as jax_harness
from iadr1_tpu.eval import mcq as jax_mcq
from iadr1_tpu.eval import summary as jax_summary
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu.models.params_io import load_safetensors_path
from iadr1_tpu_torch.cli.infer import main as infer_main
from iadr1_tpu_torch.cli.summarize import main as summarize_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval import harness, mcq, summary
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import registry
import torch_threads  # noqa: F401  (one intra-op thread)

# ---------------------------------------------------------------------------
# MCQ parsing and answer extraction
# ---------------------------------------------------------------------------

SAMPLES = [
    {"image_path": "a.png", "conversation": [
        {"Question": "Are there any defects?", "Answer": "B",
         "Options": {"A": "Yes.", "B": "No."}, "type": "Anomaly Detection"},
        {"Question": "Which defect?", "Answer": "C",
         "Options": {"C": "Scratch", "A": "Hole", "B": "Crack"},
         "type": "Defect Classification"}]},
    # only the first conversation key counts; a missing "type" is ""
    {"conversation_2": [{"Question": "Q?", "Answer": "Y",
                         "Options": {"X": "left", "Y": "right"}}],
     "conversation": [{"Question": "ignored", "Answer": "A",
                       "Options": {"A": "a"}}]},
    {"similar_templates": []},                       # no conversation
]

YES_NO = {"A": "Yes.", "B": "No."}
CLASSES = {"A": "Scratch on the surface.", "B": "Hole", "C": "No defect"}
RESPONSES = [
    ("<answer>No</answer>", YES_NO), ("<answer> yes. </answer>", YES_NO),
    ("<think>x</think><answer>NO.</answer>", YES_NO),
    ("no tags at all", YES_NO), ("<answer></answer>", YES_NO),
    ("<answer>scratch</answer>", CLASSES),
    ("<answer>a hole in it</answer>", CLASSES),
    ("<answer>crack</answer>", CLASSES), ("<answer>Maybe</answer>", None),
    ("<answer>first</answer><answer>No</answer>", YES_NO),
    # the pretrain extractor's quirks: raw-case containment, the empty
    # string matching the first option, trailing "!" stripped
    ("Yes, there are defects.", YES_NO), ("yes, there are defects", YES_NO),
    ("", YES_NO), ("No!", YES_NO), ("Scratch", CLASSES), ("hole", CLASSES),
    ("whatever", None),
]


@pytest.mark.parametrize("sample", SAMPLES)
def test_parse_conversation_matches_jax(sample):
    got, want = mcq.parse_conversation(sample), jax_mcq.parse_conversation(sample)
    assert [vars(q) for q in got] == [vars(q) for q in want]


def test_parse_conversation_raises_on_a_missing_answer_as_jax():
    bad = {"conversation": [{"Question": "Q", "Answer": "Z",
                             "Options": {"A": "a"}}]}
    for mod in (mcq, jax_mcq):
        with pytest.raises(ValueError, match="not present"):
            mod.parse_conversation(bad)


@pytest.mark.parametrize("response,options", RESPONSES)
def test_extractors_match_jax(response, options):
    assert (mcq.extract_option_answer(response, options)
            == jax_mcq.extract_option_answer(response, options))
    assert (mcq.extract_option_answer_pretrain(response, options)
            == jax_mcq.extract_option_answer_pretrain(response, options))


def test_pretrain_extractor_keeps_the_raw_case_quirk():
    # "Yes, ..." does not contain "yes, ..." raw-case; lowercase input does
    assert mcq.extract_option_answer_pretrain(
        "Yes, a scratch.", {"A": "yes, a scratch here", "B": "No."}) == "E"
    assert mcq.extract_option_answer_pretrain(
        "yes, a scratch", {"A": "yes, a scratch here", "B": "No."}) == "A"


# ---------------------------------------------------------------------------
# the accuracy tables and their CSV
# ---------------------------------------------------------------------------


def _answer(image, qtype, correct, got, **kw):
    return {"image": image, "question_type": qtype, "correct_answer": correct,
            "gpt_answer": got, **kw}


def _random_answers(seed, n=80):
    """Many datasets and question types (8 and more, where the order of a
    mean's sum shows in the last digit), letters out of range included."""
    rng = np.random.default_rng(seed)
    types = ["Anomaly Detection", "Defect Classification",
             "Object Structure", "Object Details", "Defect Localization",
             "Defect Description", "Defect Analysis",
             "Object Classification", "Texture", "Color"]
    out = []
    for i in range(n):
        normal = "good" if rng.random() < 0.5 else "bad"
        out.append(_answer(
            f"DS{rng.integers(9)}/c{rng.integers(3)}/{normal}/{i}.png",
            types[rng.integers(len(types))], "ABCDEF"[rng.integers(6)],
            "ABCDEFX"[rng.integers(7)], **{"class": f"c{rng.integers(4)}"},
            question={"text": f"Question {rng.integers(1, 6)}: q"}
            if rng.random() < 0.5 else {"text": "q"}))
    return out


ANSWER_SETS = {
    "two datasets": [
        _answer("DAGM/c1/good/1.png", "Anomaly Detection", "B", "B"),
        _answer("DAGM/c1/bad/2.png", "Anomaly Detection", "A", "B"),
        _answer("DAGM/c1/bad/3.png", "Anomaly Detection", "A", "A"),
        _answer("DAGM/c1/bad/3.png", "Defect Classification", "C", "A"),
        _answer("SDD/k/good/1.png", "Anomaly Detection", "B", "A"),
        _answer("SDD/k/bad/1.png", "Anomaly Detection", "A", "A"),
        _answer("SDD/k/bad/1.png", "Defect Localization", "D", "D"),
    ],
    "aliased types": [
        _answer("MPDD/x/good/1.png", "Object Structure", "A", "A"),
        _answer("MPDD/x/good/2.png", "Object Details", "B", "A"),
        _answer("MPDD/x/bad/3.png", "Object Analysis", "C", "C"),
        _answer("MPDD/x/bad/4.png", "Anomaly Detection", "A", "B"),
    ],
    "out-of-range letters": [
        _answer("DTD/t/good/1.png", "Anomaly Detection", "B", "F"),
        _answer("DTD/t/good/2.png", "Anomaly Detection", "B", "E"),
        _answer("DTD/t/bad/3.png", "Anomaly Detection", "Z", "A"),
        _answer("DTD/t/bad/4.png", "Anomaly Detection", "A", "A"),
        _answer("WFDD/t/bad/5.png", "Defect Description", "C", ""),
    ],
    "empty": [],
    "random 1": _random_answers(1),
    "random 2": _random_answers(2, n=200),
}


@pytest.mark.parametrize("overkill_miss", [False, True])
@pytest.mark.parametrize("name", sorted(ANSWER_SETS))
def test_accuracy_csv_is_byte_identical_to_jax(name, overkill_miss, tmp_path):
    paths = []
    for side in ("port", "jax"):
        path = tmp_path / side / "answers_0_shot.json"
        path.parent.mkdir()
        path.write_text(json.dumps(ANSWER_SETS[name]))
        paths.append(str(path))
    table = summary.summarize_answers_file(paths[0], "good", overkill_miss)
    df = jax_summary.summarize_answers_file(paths[1], "good", overkill_miss)
    csvs = [p.replace(".json", "_accuracy.csv") for p in paths]
    assert open(csvs[0], "rb").read() == open(csvs[1], "rb").read()
    assert table.index == list(df.index) and table.columns == list(df.columns)
    np.testing.assert_array_equal(table.values, df.to_numpy())


def test_balanced_accuracy_by_hand():
    table = summary.summarize_answers(ANSWER_SETS["two datasets"],
                                      show_overkill_miss=True)
    # DAGM: normal 1/1, abnormal 1/2 -> 75; SDD: normal 0/1, abnormal 1/1
    assert table.at("DAGM", "Anomaly Detection") == 75.0
    assert table.at("SDD", "Anomaly Detection") == 50.0
    assert table.at("SDD", "Overkill") == 100.0
    assert table.at("Average", "Anomaly Detection") == 62.5


@pytest.mark.parametrize("name", ["random 1", "random 2"])
def test_mvtec_per_class_table_matches_jax(name):
    answers = ANSWER_SETS[name]
    table = summary.summarize_mvtec_per_class(answers)
    df = jax_summary.summarize_mvtec_per_class(answers)
    assert table.index == list(df.index) and table.columns == list(df.columns)
    np.testing.assert_array_equal(table.values, df.to_numpy())


@pytest.mark.parametrize("overkill_miss", [False, True])
def test_summarize_cli_writes_the_jax_csv(overkill_miss, tmp_path, capsys):
    flag = ["--overkill-miss"] if overkill_miss else []
    csvs = []
    for side, main in (("port", summarize_main), ("jax", jax_summarize_main)):
        path = tmp_path / side / "answers_1_shot.json"
        path.parent.mkdir()
        path.write_text(json.dumps(ANSWER_SETS["random 1"]))
        assert main(["--answers-json", str(path)] + flag) == 0
        csvs.append(str(path).replace(".json", "_accuracy.csv"))
    assert filecmp.cmp(*csvs, shallow=False)
    assert "Average" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return build_benchmark_json(tmp_path_factory.mktemp("bench"), n=6,
                                templates=2)


def _stub_generate(batch_items):
    """A canned response per item, chosen by its image's index."""
    canned = ["<answer>No</answer>", "<answer>Yes</answer>", "free text",
              "<answer>yes.</answer>", "No.", "<answer>no</answer>"]
    return [canned[int(os.path.basename(it.image)[0]) % len(canned)]
            for it in batch_items]


@pytest.mark.parametrize("pretrain", [False, True])
def test_run_benchmark_writes_the_jax_answers_and_resumes(bench, pretrain,
                                                          tmp_path):
    path, _ = bench
    items = harness.load_benchmark(path, num_shot=1)
    jitems = jax_harness.load_benchmark(path, num_shot=1)
    assert ([(it.image, it.few_shot, vars(it.question)) for it in items]
            == [(it.image, it.few_shot, vars(it.question)) for it in jitems])
    extract = dict(answer_extractor=(mcq.extract_option_answer_pretrain
                                     if pretrain else None))
    jextract = dict(answer_extractor=(jax_mcq.extract_option_answer_pretrain
                                      if pretrain else None))
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    # the port resumes from a file holding the first two answers
    harness.run_benchmark(items[:2], _stub_generate, ours, batch_size=4,
                          **extract)
    harness.run_benchmark(items, _stub_generate, ours, batch_size=4,
                          **extract)
    jax_harness.run_benchmark(jitems, _stub_generate, theirs, batch_size=4,
                              **jextract)
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    def never(batch):
        raise AssertionError("a resumed run generated again")

    before = open(ours, "rb").read()
    assert len(harness.run_benchmark(items, never, ours, **extract)) == 6
    assert open(ours, "rb").read() == before
    assert (harness.build_messages(items[0], system_prompt="s")
            == jax_harness.build_messages(jitems[0], system_prompt="s"))


# ---------------------------------------------------------------------------
# the infer CLI and the generator on the tiny checkpoint
# ---------------------------------------------------------------------------

# the CLIs' generation settings, small
CLI_ARGS = ["--batch-size", "2", "--max-prompt-length", "192",
            "--max-new-tokens", "8", "--patch-budget", "128",
            "--max-pixels", str(56 * 56 * 4)]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny Qwen2-VL checkpoint with seeded noise on every weight: at
    HF's init scale the tiny model repeats one token, which would make the
    comparison of responses a weak check."""
    from safetensors.numpy import save_file

    path = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in load_safetensors_path(path).items()}
    for name in os.listdir(path):
        if name.endswith(".safetensors"):
            os.remove(os.path.join(path, name))
    save_file(state, os.path.join(path, "model.safetensors"))
    return path


@pytest.fixture
def f32_compute(monkeypatch):
    """Both CLIs' bundles compute in f32 (the weights stay bf16): greedy
    decoding is then token-identical across the frameworks, where bf16
    compute rounds differently and a row may take another token."""
    monkeypatch.setattr(jax_registry, "bundle_from_pretrained", functools.partial(
        jax_registry.bundle_from_pretrained, precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_pretrained", functools.partial(
        registry.bundle_from_pretrained, precision=FULL_PRECISION))


@pytest.mark.parametrize("num_shot", [0, 1])
def test_infer_cli_writes_the_jax_answers_and_csv(num_shot, checkpoint,
                                                  f32_compute, tmp_path,
                                                  monkeypatch):
    test_data, image_dir = build_benchmark_json(tmp_path, n=4,
                                                templates=num_shot)
    args = ["--model-path", checkpoint, "--test-data", test_data,
            "--image-dir", image_dir, "--num-shot", str(num_shot)] + CLI_ARGS
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    assert infer_main(args + ["--output-dir", out["port"],
                              "--device", "cpu"]) == 0
    assert jax_infer_main(args + ["--output-dir", out["jax"],
                                  "--attention", "xla"]) == 0
    name = f"answers_{num_shot}_shot"
    answers = [json.load(open(os.path.join(out[s], name + ".json")))
               for s in ("port", "jax")]
    assert answers[0] == answers[1] and len(answers[0]) == 4
    assert len({a["response"] for a in answers[0]}) > 1
    assert filecmp.cmp(*(os.path.join(out[s], name + "_accuracy.csv")
                         for s in ("port", "jax")), shallow=False)

    # a second call resumes: it generates nothing and changes nothing
    def never(self, encoded):
        raise AssertionError("a resumed run generated again")

    monkeypatch.setattr(VLMGenerator, "_generate_encoded", never)
    path = os.path.join(out["port"], name + ".json")
    before = open(path, "rb").read()
    assert infer_main(args + ["--output-dir", out["port"],
                              "--device", "cpu"]) == 0
    assert open(path, "rb").read() == before


@pytest.mark.parametrize("quant", ["int8", "int4", "nf4"])
def test_infer_cli_quant_waits_for_its_roadmap_item(quant, checkpoint,
                                                    f32_compute, tmp_path):
    """Named for the refusal it checked until ROADMAP A.12 was ported.
    ``--quant``: the port's CLI quantizes the
    bf16 weights bit for bit as the JAX CLI does, and writes the JAX
    CLI's answers and CSV (both bundles computing in f32)."""
    test_data, image_dir = build_benchmark_json(tmp_path, n=2)
    args = ["--model-path", checkpoint, "--test-data", test_data,
            "--image-dir", image_dir, "--quant", quant] + CLI_ARGS
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    assert infer_main(args + ["--output-dir", out["port"],
                              "--device", "cpu"]) == 0
    assert jax_infer_main(args + ["--output-dir", out["jax"],
                                  "--attention", "xla"]) == 0
    name = "answers_0_shot"
    answers = [json.load(open(os.path.join(out[s], name + ".json")))
               for s in ("port", "jax")]
    assert answers[0] == answers[1] and len(answers[0]) == 2
    assert filecmp.cmp(*(os.path.join(out[s], name + "_accuracy.csv")
                         for s in ("port", "jax")), shallow=False)


@pytest.fixture(scope="module")
def gens(checkpoint):
    """The port's and the JAX package's generators on the checkpoint, f32."""
    tok = tiny_qwen_tokenizer()
    state = load_safetensors_path(checkpoint)
    cfg = dict(max_prompt_length=64, max_new_tokens=6, batch_size=2,
               patch_budget=64, max_pixels=56 * 56)
    jb = jax_registry.bundle_from_pretrained(checkpoint, attention="xla",
                                             precision=JAX_FULL)
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template("qwen2_vl"), JaxGenCfg(**cfg))
    tb = registry.bundle_from_pretrained(checkpoint, precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template("qwen2_vl"), GeneratorConfig(**cfg),
                        device="cpu")
    return jgen, tgen, state


def _image(seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (56, 56, 3), np.uint8))


def test_pretrain_mode_lifts_the_system_message(checkpoint, gens, tmp_path):
    """The pretrain prompt equals JAX's encode_prompt with the system
    prompt passed as ``system`` (the JAX generator itself rejects the
    system turn), and the CLI runs end to end in that mode."""
    jgen, tgen, _ = gens
    test_data, image_dir = build_benchmark_json(tmp_path, n=2)
    item = harness.load_benchmark(test_data)[0]
    image = os.path.join(image_dir, item.image)
    messages = harness.build_messages(
        item, system_prompt=harness.PRETRAIN_SYSTEM_PROMPT)
    ids, patches, grids = tgen._encode_request(messages, [image])
    n_img = [int(np.prod(g)) // 4 for g in grids]
    want = jax_template("qwen2_vl").encode_prompt(
        jgen.tokenizer, jax_expand(messages[1:], n_img, "qwen2_vl",
                                   "<|image_pad|>"),
        system=harness.PRETRAIN_SYSTEM_PROMPT)
    assert list(ids) == list(want)
    assert "Please answer by yes or no" in jgen.tokenizer.decode(ids)
    with pytest.raises(ValueError, match="unsupported role"):
        jgen._encode_request(messages, [image])

    out = tmp_path / "out"
    assert infer_main(["--model-path", checkpoint, "--test-data", test_data,
                       "--image-dir", image_dir, "--output-dir", str(out),
                       "--mode", "pretrain", "--device", "cpu"]
                      + CLI_ARGS) == 0
    answers = json.load(open(out / "answers_0_shot.json"))
    assert len(answers) == 2 and all(a["gpt_answer"] in "ABE"
                                     for a in answers)


def test_an_over_long_image_prompt_raises_and_text_is_cut_as_jax(gens):
    jgen, tgen, _ = gens
    P = tgen.cfg.max_prompt_length
    two_images = [{"role": "user", "content": "<image><image>"
                   + "Are there any defects in the image? " * 3}]
    with pytest.raises(ValueError, match="exceeds max_prompt_length"):
        tgen._encode_request(two_images, [_image(0), _image(1)])
    text = [{"role": "user", "content": "The quick brown fox jumps " * 8}]
    ids, _, _ = tgen._encode_request(text, [])
    want, _, _ = jgen._encode_request(text, [])
    assert len(ids) == P and list(ids) == list(want)


def test_update_params_generates_as_a_fresh_generator(gens):
    _, tgen, state = gens
    rng = np.random.default_rng(5)
    other = {k: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in state.items()}
    params = tgen.bundle.convert_hf(other, device="cpu")
    requests = [{"messages": [{"role": "user", "content": "<image>Any defects?"}],
                 "images": [_image(i)]} for i in range(3)]
    before = tgen.generate(requests)
    old = tgen.params
    tgen.update_params(params)
    try:
        swapped = tgen.generate(requests)
    finally:
        tgen.update_params(old)
    fresh = VLMGenerator(tgen.bundle, params, tgen.tokenizer, tgen.template,
                         tgen.cfg, device="cpu").generate(requests)
    assert swapped == fresh and swapped != before
