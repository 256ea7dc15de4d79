"""The port's commercial-API eval client against the JAX package's (host
code, an injected transport and sleep): answer parsing, the base64 JPEG
bytes, the request payload, the retry and backoff delays, and the
resumable benchmark run's answers JSON and accuracy CSV byte for byte."""

import filecmp
import json
import os

import pytest

from helpers import build_benchmark_json
from iadr1_tpu.eval import commercial as jax_commercial
from iadr1_tpu_torch.eval import commercial
import torch_threads  # noqa: F401  (one intra-op thread)


def _resp(text):
    return {"choices": [{"message": {"content": text}}]}


def _gt(n_questions=2):
    return {"image_path": "ds/good/x.png", "conversation": [
        {"Question": f"Q{i}: any defects?", "Answer": "AB"[i % 2],
         "Options": {"A": "Yes.", "B": "No."}, "type": "Anomaly Detection"}
        for i in range(n_questions)]}


@pytest.mark.parametrize("text,options", [
    ("Answer: B.", None), ("1. A\n2. B", None), ("No", {"A": "Yes.",
                                                     "B": "No."}),
    ("yes", {"A": "Yes.", "B": "No."}), ("", None), ("", {"A": "x"}),
    ("E is not an option; C.", {"C": "hole"}),
    ("a hole in the corner", {"A": "Scratch", "B": "Hole", "C": "None"}),
])
def test_parse_answer_matches_jax(text, options):
    assert commercial.parse_answer(text, options) == (
        jax_commercial.parse_answer(text, options))


def test_constants_match_jax():
    assert commercial.INSTRUCTION == jax_commercial.INSTRUCTION
    assert commercial.ERROR_KEYWORDS == jax_commercial.ERROR_KEYWORDS
    assert commercial.APIConfig() == commercial.APIConfig(
        **vars(jax_commercial.APIConfig()))


@pytest.mark.parametrize("size", [(1024, 256), (100, 300), (512, 512)])
def test_base64_jpeg_bytes_match_jax(size):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                       np.uint8))
    assert commercial.encode_image_to_base64(img, (512, 512)) == (
        jax_commercial.encode_image_to_base64(img, (512, 512)))


def _queries(tmp_path, transport, sleep=None, few_shot=0):
    from PIL import Image

    paths = []
    for i in range(1 + few_shot):
        p = str(tmp_path / f"img{i}.png")
        Image.new("RGB", (64, 48), (10 * i, 100, 30)).save(p)
        paths.append(p)
    out = []
    for mod in (commercial, jax_commercial):
        kw = {"sleep": sleep} if sleep else {}
        out.append(mod.CommercialQuery(
            mod.APIConfig(max_retries=4), paths[0], _gt(),
            few_shot=paths[1:], transport=transport, **kw))
    return out


@pytest.mark.parametrize("few_shot", [0, 2])
def test_payloads_match_jax(tmp_path, few_shot):
    seen = {"port": [], "jax": []}
    for side, q in zip(("port", "jax"), _queries(
            tmp_path, None, few_shot=few_shot)):
        q.transport = lambda payload, headers, side=side: (
            seen[side].append((payload, headers)) or _resp("B"))
        assert q.generate_answer()[2] == ["B", "B"]
    assert json.dumps(seen["port"]) == json.dumps(seen["jax"])
    assert len(seen["port"]) == 2


def test_retry_and_backoff_delays_match_jax(tmp_path):
    """Transport errors back off 1, 2, 4 s; refusals and empty choices
    retry at once; a run out of retries answers ''."""
    script = [RuntimeError("down"), RuntimeError("down"),
              _resp("Sorry, I cannot assist"), _resp("A"),
              {"choices": []}, RuntimeError("down"), RuntimeError("down"),
              RuntimeError("down")]
    record = {}
    for side in ("port", "jax"):
        calls, sleeps = iter(script), []

        def transport(payload, headers, calls=calls):
            item = next(calls)
            if isinstance(item, Exception):
                raise item
            return item

        q = _queries(tmp_path, transport, sleep=sleeps.append)[
            side == "jax"]
        record[side] = (q.generate_answer()[2], sleeps)
    assert record["port"] == record["jax"]
    assert record["port"] == (["A", ""], [1.0, 2.0, 1.0, 2.0, 4.0])


@pytest.mark.parametrize("few_shot", [0, 1])
def test_run_commercial_eval_writes_the_jax_files_and_resumes(tmp_path,
                                                             few_shot):
    bench, img_root = build_benchmark_json(tmp_path, n=6, templates=few_shot)
    replies = ["Answer: B.", "A", "The answer is A", "no idea", "B", "Yes."]
    out = {}
    for side, mod in (("port", commercial), ("jax", jax_commercial)):
        calls = iter(replies)
        out[side] = str(tmp_path / side)
        path = mod.run_commercial_eval(
            bench, img_root, mod.APIConfig(), out[side],
            transport=lambda payload, headers, calls=calls: _resp(
                next(calls)), few_shot=few_shot, max_items=5)
        assert os.path.basename(path) == f"answers_{few_shot}_shot.json"
    name = f"answers_{few_shot}_shot"
    for suffix in (".json", "_accuracy.csv"):
        assert filecmp.cmp(*(os.path.join(out[s], name + suffix)
                             for s in ("port", "jax")), shallow=False), suffix
    answers = json.load(open(os.path.join(out["port"], name + ".json")))
    assert len(answers) == 5

    # a second call resumes: the answered items are not asked again, the
    # sixth is
    asked = []
    commercial.run_commercial_eval(
        bench, img_root, commercial.APIConfig(), out["port"],
        transport=lambda payload, headers: asked.append(1) or _resp("B"),
        few_shot=few_shot)
    assert len(asked) == 1
    assert len(json.load(open(os.path.join(out["port"],
                                           name + ".json")))) == 6


def test_default_transport_needs_requests(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(ImportError, match="requests"):
        commercial.default_transport({}, {}, "http://localhost:9/none")
