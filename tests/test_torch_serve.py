"""The port's OpenAI-compatible server against the JAX package's: message
parsing, the request batcher, and real HTTP round trips to a ChatServer on
the tiny Qwen2-VL checkpoint (same content as the JAX server, SSE
streaming, the error codes), plus a system message, which the JAX server
cannot answer."""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)

from helpers import build_tiny_vlm_checkpoint, tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models.params_io import load_safetensors_path
from iadr1_tpu.models.registry import bundle_from_pretrained as jax_bundle
from iadr1_tpu.serve.api import ChatServer as JaxChatServer
from iadr1_tpu.serve.api import parse_openai_messages as jax_parse
from iadr1_tpu_torch.cli.serve import main as serve_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models.registry import bundle_from_pretrained
from iadr1_tpu_torch.serve.api import ChatServer, parse_openai_messages
from iadr1_tpu_torch.serve.batcher import RequestBatcher
import torch_threads  # noqa: F401  (one intra-op thread)

GEN = dict(max_prompt_length=64, max_new_tokens=6, batch_size=1,
           patch_budget=64, max_pixels=56 * 56 * 2)


def _png(seed, size=28):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _data_url(seed, size=28):
    return "data:image/png;base64," + base64.b64encode(
        _png(seed, size)).decode()


def test_parse_openai_messages_matches_jax(tmp_path):
    path = tmp_path / "img.png"
    path.write_bytes(_png(3))
    messages = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [
            {"type": "text", "text": "look: "},
            {"type": "image_url", "image_url": {"url": _data_url(1)}},
            {"type": "text", "text": " and "},
            {"type": "image_url", "image_url": {"url": f"file://{path}"}},
        ]},
        {"role": "assistant", "content": "ok"},
        {"role": "user", "content": "plain text"},
    ]
    got, want = parse_openai_messages(messages), jax_parse(messages)
    assert got[0] == want[0] and got[2] == want[2] == "be brief"
    assert got[0][0] == {"role": "user", "content": "look: <image> and <image>"}
    assert len(got[1]) == len(want[1]) == 2
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="image URLs"):
        parse_openai_messages([{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "http://x/y.png"}}]}])


def test_request_batcher_coalesces_orders_and_delivers_errors():
    calls = []

    def generate(requests):
        calls.append(len(requests))
        time.sleep(0.02)
        return [f"re:{r}" for r in requests]

    # a wait window far longer than the threads take to submit
    b = RequestBatcher(generate, max_batch=4, max_wait_ms=2000)
    results = {}

    def worker(i):
        results[i] = b.submit(f"q{i}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == {i: f"re:q{i}" for i in range(6)}
    # 6 requests at max_batch 4 within one wait window: 4, then 2
    assert calls == [4, 2], calls
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("late")

    def boom(requests):
        raise RuntimeError("backend down")

    def short(requests):
        return ["only one"]

    for fn, match in ((boom, "backend down"), (short, "1 results for 2")):
        b2 = RequestBatcher(fn, max_batch=2, max_wait_ms=200)
        errors = []

        def failing(i, b2=b2):
            try:
                b2.submit(i)
            except RuntimeError as e:
                errors.append(str(e))

        threads = [threading.Thread(target=failing, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(errors) == 2 and all(match in e for e in errors), errors
        b2.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port and a JAX ChatServer over the same noised tiny checkpoint,
    f32 compute (greedy decoding is then token-identical)."""
    path = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    tok = tiny_qwen_tokenizer()
    rng = np.random.default_rng(0)
    state = {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in load_safetensors_path(path).items()}
    jb = jax_bundle(path, attention="xla", precision=JAX_FULL)
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template("qwen2_vl"), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template("qwen2_vl"), GeneratorConfig(**GEN),
                        device="cpu")
    port, ref = ChatServer(tgen, port=0), JaxChatServer(jgen, port=0)
    port.start_background()
    ref.start_background()
    yield port, ref
    port.shutdown()
    ref.shutdown()


def _request(server, path, body=None, raw=None):
    """-> (status, body text) of one HTTP round trip."""
    url = f"http://127.0.0.1:{server.port}{path}"
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


CHATS = [
    [{"role": "user", "content": "Are there any defects in the image?"}],
    [{"role": "user", "content": "hello"},
     {"role": "assistant", "content": "hi"},
     {"role": "user", "content": "The quick brown fox"}],
    [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": _data_url(7, 56)}},
        {"type": "text", "text": "Are there any defects?"}]}],
]


@pytest.mark.parametrize("messages", CHATS, ids=["text", "turns", "image"])
def test_chat_completion_matches_the_jax_server(servers, messages):
    port, ref = servers
    body = {"model": "m", "messages": messages}
    (code, got), (jcode, want) = (_request(s, "/v1/chat/completions", body)
                                  for s in servers)
    assert code == jcode == 200
    got, want = json.loads(got), json.loads(want)
    assert got["choices"] == want["choices"]
    assert got["object"] == "chat.completion" and got["model"] == "m"
    assert got["id"].startswith("chatcmpl-") and got["usage"] == want["usage"]
    assert got["choices"][0]["message"]["content"]

    code, stream = _request(port, "/v1/chat/completions",
                            {**body, "stream": True})
    events = [line[len("data: "):] for line in stream.split("\n\n") if line]
    assert code == 200 and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == got["choices"][0]["message"]["content"]


def test_a_system_message_is_answered(servers):
    """The port lifts the system turn into the template's system block; the
    JAX server hands it to the template, which rejects the role."""
    port, ref = servers
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hello"}]}
    code, text = _request(port, "/v1/chat/completions", body)
    assert code == 200 and json.loads(text)["choices"][0]["message"]
    jcode, jtext = _request(ref, "/v1/chat/completions", body)
    assert jcode == 500 and "unsupported role" in jtext
    # the system block replaces the default one in the prompt
    gen = port.generator
    ids, _, _ = gen._encode_request(
        [{"role": "system", "content": "be brief"},
         {"role": "user", "content": "hello"}], [])
    prompt = gen.tokenizer.decode(ids)
    assert "be brief" in prompt and "helpful assistant" not in prompt


@pytest.mark.parametrize("method,path,raw,body", [
    ("GET", "/v1/models", None, None),
    ("GET", "/v1/nothing", None, None),
    ("POST", "/v1/nothing", None, {"messages": ["x"]}),
    ("POST", "/v1/chat/completions", b"{not json", None),
    ("POST", "/v1/chat/completions", None, {"model": "m"}),
    ("POST", "/v1/score/evaluation", None, {"messages": ["some text"]}),
])
def test_status_codes_match_the_jax_server(servers, method, path, raw, body):
    (code, got), (jcode, want) = (_request(s, path, body, raw)
                                  for s in servers)
    assert code == jcode
    if path == "/v1/models":
        got, want = json.loads(got), json.loads(want)
        for listing in (got, want):
            listing["data"][0].pop("created")
        assert code == 200 and got == want
    else:
        assert code in (400, 404, 405) and got == want


def test_score_endpoint_with_a_score_fn():
    def score_fn(texts, max_length):
        return [float(len(t)) + (max_length or 0) for t in texts]

    srv = ChatServer(generator=None, port=0, score_fn=score_fn, max_batch=1)
    srv.start_background()
    try:
        code, text = _request(srv, "/v1/score/evaluation",
                              {"model": "rm", "messages": ["ab", "cdef"],
                               "max_length": 32})
    finally:
        srv.shutdown()
    out = json.loads(text)
    assert code == 200 and out["scores"] == [34.0, 36.0]
    assert out["object"] == "score.evaluation"
    assert out["id"].startswith("scoreval-")


def test_batched_chat_server_coalesces_concurrent_requests():
    calls = []

    class FakeGen:
        def generate(self, requests):
            calls.append(len(requests))
            return ["ok:" + r["messages"][-1]["content"] for r in requests]

    srv = ChatServer(FakeGen(), port=0, max_batch=4, batch_wait_ms=5000)
    srv.start_background()
    results = {}

    def chat(i):
        results[i] = json.loads(_request(srv, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"q{i}"}]})[1])

    try:
        threads = [threading.Thread(target=chat, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        srv.shutdown()
    assert calls == [4]
    assert {i: r["choices"][0]["message"]["content"]
            for i, r in results.items()} == {i: f"ok:q{i}" for i in range(4)}


def test_serve_cli_quant_waits_for_its_roadmap_item(tmp_path, monkeypatch,
                                                    capsys):
    """Named for the refusal it checked until ROADMAP A.12 was ported.
    ``--quant int8``: the server's generator
    holds the JAX CLI's int8 quant dicts (bit for bit) and the CLI
    reports the JAX CLI's byte counts."""
    import jax.numpy as jnp

    from iadr1_tpu.models.quant import quantize_tree, quantized_bytes

    path = build_tiny_vlm_checkpoint(str(tmp_path / "ckpt"))
    seen = {}

    def no_serve(self):
        seen["params"] = self.generator.params
        self.shutdown()                 # ends the batcher's worker

    monkeypatch.setattr(ChatServer, "serve_forever", no_serve)
    assert serve_main(["--model-path", path, "--device", "cpu",
                       "--quant", "int8", "--port", "0"]) == 0

    want = quantize_tree(jax_bundle(path).convert_hf(
        load_safetensors_path(path), dtype=jnp.bfloat16))
    got = seen["params"]["text"]["layers"]["mlp"]["up"]["kernel"]
    ref = want["text"]["layers"]["mlp"]["up"]["kernel"]
    for k in ("qvalues", "scales"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    now, bf16 = quantized_bytes(want)
    assert (f"int8 weight-only quant: {now / 1e6:.1f} MB (bf16 would be "
            f"{bf16 / 1e6:.1f} MB)") in capsys.readouterr().out
