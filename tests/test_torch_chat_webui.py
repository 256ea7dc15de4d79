"""The port's chat CLI and web board against the JAX package's: the
requests each chat turn hands ``generate`` (scripted input with /image,
/clear and /exit), the port's replies at temperature 0 against its own
generator's, ``build_job_config`` for every stage, the HTTP routes, the
launch command with and without ``--device cpu``, the subprocess
lifecycle, and one real launch of the port's SFT CLI on the CPU."""

import builtins
import copy
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from helpers import build_iad_sft_dataset, build_tiny_vlm_checkpoint
from iadr1_tpu.cli import chat as jax_chat
from iadr1_tpu.eval import generator as jax_generator
from iadr1_tpu.webui import runner as jax_runner
from iadr1_tpu_torch.cli import chat
from iadr1_tpu_torch.eval import generator
from iadr1_tpu_torch.webui.app import PAGE, create_server
from iadr1_tpu_torch.webui.runner import Runner, build_job_config
import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny Qwen2-VL checkpoint with its weights noised, so that greedy
    replies vary from turn to turn."""
    from safetensors.numpy import save_file

    from iadr1_tpu.models.params_io import load_safetensors_path

    path = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in load_safetensors_path(path).items()}
    for name in os.listdir(path):
        if name.endswith(".safetensors"):
            os.remove(os.path.join(path, name))
    save_file(state, os.path.join(path, "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    from PIL import Image

    path = str(tmp_path_factory.mktemp("img") / "query.png")
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 255, (56, 56, 3), np.uint8)).save(path)
    return path


def _script(image_path):
    return ["hello there", "/image " + image_path, "what is in it?", "",
            "and the left side?", "/clear", "and now?", "/exit", "unread"]


CHAT_ARGS = ["--max-prompt-length", "160", "--max-new-tokens", "6",
             "--patch-budget", "64"]


def _run_chat(main, generator_cls, monkeypatch, script, argv, capsys,
              generate=None):
    """Run ``main`` on scripted input; returns (the requests handed to
    generate at each turn, deep-copied, the replies, the printed lines)."""
    lines = iter(script)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
    seen, replies = [], []
    through = generator_cls.generate

    def recording(self, requests):
        seen.append(copy.deepcopy(requests))
        out = (generate or through)(self, requests)
        replies.append(out[0])
        return out

    monkeypatch.setattr(generator_cls, "generate", recording)
    assert main(argv) == 0
    return seen, replies, capsys.readouterr().out.splitlines()


def test_chat_turns_hand_generate_the_jax_requests(checkpoint, image_path,
                                                   monkeypatch, capsys):
    """Both CLIs on the same script, each generate replaced by canned
    replies: the message history and the image list of every turn are
    equal, byte for byte."""
    def canned(self, requests):
        return [f"reply {len(requests[0]['messages'])}"]

    argv = ["--model-path", checkpoint] + CHAT_ARGS
    port, _, port_out = _run_chat(chat.main, generator.VLMGenerator,
                                  monkeypatch, _script(image_path),
                                  argv + ["--device", "cpu"], capsys, canned)
    ref, _, ref_out = _run_chat(jax_chat.main, jax_generator.VLMGenerator,
                                monkeypatch, _script(image_path),
                                argv + ["--attention", "xla"], capsys,
                                canned)
    assert json.dumps(port, ensure_ascii=False) == json.dumps(
        ref, ensure_ascii=False)
    assert port_out == ref_out
    assert len(port) == 4
    # the image turn and the next carry the image; after /clear, one
    # message and no image
    assert port[1][0]["messages"][-1]["content"] == "<image>what is in it?"
    assert port[1][0]["images"] == port[2][0]["images"] == [image_path]
    assert port[2][0]["messages"][0]["content"] == "hello there"
    assert port[2][0]["messages"][-1]["content"] == "and the left side?"
    assert port[-1] == [{"messages": [{"role": "user", "content": "and now?"}],
                         "images": []}]
    assert "(history cleared)" in port_out


def test_chat_replies_at_temperature_zero_are_its_generators(
        checkpoint, image_path, monkeypatch, capsys):
    """The port's chat generating for real on the CPU (bf16, greedy):
    each printed reply equals its generator's reply to the same request."""
    import torch

    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from transformers import AutoTokenizer

    argv = (["--model-path", checkpoint, "--temperature", "0",
             "--device", "cpu"] + CHAT_ARGS)
    seen, replies, out = _run_chat(chat.main, generator.VLMGenerator,
                                   monkeypatch, _script(image_path), argv,
                                   capsys)
    assert len(replies) == len(seen) == 4
    assert "\n".join(out).count("assistant> ") == 4
    assert len(set(replies)) > 1

    monkeypatch.undo()
    bundle = bundle_from_pretrained(checkpoint)
    gen = generator.VLMGenerator(
        bundle, bundle.convert_hf(load_safetensors_path(checkpoint),
                                  dtype=torch.bfloat16, device="cpu"),
        AutoTokenizer.from_pretrained(checkpoint), get_template("qwen2_vl"),
        generator.GeneratorConfig(max_prompt_length=160, max_new_tokens=6,
                                  temperature=0.0, batch_size=1,
                                  patch_budget=64),
        device="cpu")
    assert [gen.generate(r)[0] for r in seen] == replies
    # each turn's history holds the earlier replies
    assert seen[1][0]["messages"][1] == {"role": "assistant",
                                         "content": replies[0]}


def test_chat_loop_reads_and_writes_through_its_arguments():
    class Gen:
        def __init__(self):
            self.requests = []

        def generate(self, requests):
            self.requests.append(copy.deepcopy(requests))
            return ["ok"]

    lines = iter(["/image a.png", "look", "/exit"])
    written = []
    gen = Gen()
    assert chat.chat_loop(gen, lambda prompt: next(lines),
                          written.append) == 0
    assert gen.requests == [[{"messages": [
        {"role": "user", "content": "<image>look"}], "images": ["a.png"]}]]
    assert written[-1] == "assistant> ok"

    def eof(prompt):
        raise EOFError

    assert chat.chat_loop(gen, eof, written.append) == 0


# ---------------------------------------------------------------------------
# the web board
# ---------------------------------------------------------------------------


FORM = {"model_name_or_path": "/ckpt", "dataset": "d.json",
        "learning_rate": "2e-5", "max_steps": "7", "batch_size": "2",
        "cutoff_len": "512", "template": "qwen2_vl", "logging_steps": "3",
        "extra": {"mesh.tp": 2, "data.image_dir": "/imgs"}}


@pytest.mark.parametrize("stage", sorted(jax_runner.STAGE_CLI))
def test_build_job_config_matches_jax(stage, tmp_path):
    form = {**FORM, "stage": stage, "output_dir": str(tmp_path)}
    module, cfg = build_job_config(copy.deepcopy(form))
    jax_module, jax_cfg = jax_runner.build_job_config(copy.deepcopy(form))
    assert cfg == jax_cfg
    assert module == jax_module.replace("iadr1_tpu.", "iadr1_tpu_torch.")
    __import__(module)                              # the port's CLI exists
    with pytest.raises(ValueError, match="unknown stage"):
        build_job_config({**form, "stage": "nope"})


@pytest.mark.parametrize("device", [None, "cpu"])
def test_dry_run_command_and_progress(device, tmp_path):
    out = str(tmp_path / "run")
    form = {"stage": "sft", "model_name_or_path": "/ckpt",
            "dataset": "d.json", "output_dir": out}
    if device:
        form["device"] = device
    r = Runner()
    info = r.launch(form, dry_run=True)
    assert info["command"][1:] == (
        ["-m", "iadr1_tpu_torch.cli.train_sft", "--config",
         os.path.join(out, "webui_job.json")]
        + (["--device", device] if device else []))
    extra = r.launch(form, dry_run=True, extra_args=["--no-predict-scores"])
    assert extra["command"] == info["command"] + ["--no-predict-scores"]
    with open(os.path.join(out, "webui_job.json")) as f:
        assert json.load(f) == info["config"]
    assert "device" not in json.dumps(info["config"])
    assert r.progress()["state"] == "idle"
    with open(os.path.join(out, "trainer_log.jsonl"), "w") as f:
        f.write(json.dumps({"current_steps": 1, "loss": 2.0}) + "\n")
        f.write(json.dumps({"current_steps": 2, "loss": 1.5}) + "\n")
    p = r.progress()
    assert p["n_records"] == 2 and p["latest"]["loss"] == 1.5
    assert p["loss_curve"] == [[1, 2.0], [2, 1.5]]


def test_subprocess_lifecycle_closes_its_log(tmp_path):
    """A child that sleeps: running, aborted, finished, and its log file
    closed once it has ended (the JAX runner leaves it open)."""
    r = Runner()
    r.output_dir = str(tmp_path)
    r._log = log = open(os.path.join(tmp_path, "webui_stdout.log"), "w")
    r.proc = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"], stdout=log)
    assert r.running and r.progress()["state"] == "running"
    with pytest.raises(RuntimeError, match="in progress"):
        r.launch({})
    assert r.abort()
    assert not r.running and log.closed
    p = r.progress()
    assert p["state"] == "finished" and p["returncode"] != 0
    assert not r.abort()


def test_http_routes(tmp_path):
    server = create_server(chat_fn=lambda m: f"echo:{m}", port=0)
    port = server.start_background()
    base = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(), method="POST")
        try:
            resp = urllib.request.urlopen(req, timeout=30)
            return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        html = urllib.request.urlopen(base + "/", timeout=30).read().decode()
        assert html == PAGE and "/api/train" in html
        code, out = post("/api/train", {
            "stage": "sft", "model_name_or_path": "/ckpt",
            "dataset": "d.json", "output_dir": str(tmp_path / "r"),
            "device": "cpu", "dry_run": True})
        assert code == 200 and out["ok"]
        assert out["command"][-2:] == ["--device", "cpu"]
        code, out = post("/api/train", {
            "stage": "bogus", "model_name_or_path": "x", "dataset": "d",
            "dry_run": True, "output_dir": str(tmp_path)})
        assert code == 400 and "unknown stage" in out["error"]
        prog = json.loads(urllib.request.urlopen(base + "/api/progress",
                                                 timeout=30).read())
        assert prog["state"] == "idle"
        assert post("/api/chat", {"message": "hi"}) == (
            200, {"response": "echo:hi"})
        assert post("/api/abort", {}) == (200, {"aborted": False})
        assert post("/api/nope", {})[0] == 404
    finally:
        server.shutdown()
    bare = create_server(port=0)
    assert bare.handle("POST", "/api/chat", {})[0] == 400


def test_a_real_cpu_launch_of_the_sft_cli(checkpoint, tmp_path, monkeypatch):
    """The board launches the port's SFT CLI with ``--device cpu`` for one
    step; /api/progress reads it to the end (return code 0)."""
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    server = create_server(port=0)
    port = server.start_background()
    base = f"http://127.0.0.1:{port}"
    out = str(tmp_path / "run")
    form = {"stage": "sft", "model_name_or_path": checkpoint,
            "dataset": data_path, "cutoff_len": 128, "max_steps": 1,
            "batch_size": 2, "logging_steps": 1, "output_dir": out,
            "device": "cpu",
            "extra": {"data.image_dir": img_dir, "data.patch_budget": 64,
                      "data.max_pixels": 56 * 56 * 4}}
    try:
        req = urllib.request.Request(base + "/api/train",
                                     data=json.dumps(form).encode(),
                                     method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=30).read())[
            "ok"]
        deadline = time.time() + 240
        while time.time() < deadline:
            prog = json.loads(urllib.request.urlopen(
                base + "/api/progress", timeout=30).read())
            if prog["state"] == "finished":
                break
            time.sleep(0.5)
    finally:
        server.runner.abort()
        server.shutdown()
    log = open(os.path.join(out, "webui_stdout.log")).read()
    assert prog["state"] == "finished" and prog["returncode"] == 0, log
    assert prog["n_records"] == 1 and prog["latest"]["current_steps"] == 1
    assert np.isfinite(prog["latest"]["loss"])
