"""The port's MMLU evaluator against the JAX package's: the prompt strings
(en and zh, with and without shots), the f32 choice logits at the last
prompt position (within 1e-4) on the tiny text Qwen2 bundle and the tiny
Qwen2-VL checkpoint, the letters, and results.json byte for byte with the
same seed and n_shot."""

import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)
import jax.numpy as jnp
import torch

from helpers import build_tiny_vlm_checkpoint, tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.eval import mmlu as jax_mmlu
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu.models.params_io import load_safetensors_path
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.eval import mmlu
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.models.params_io import params_from_jax
import torch_threads  # noqa: F401  (one intra-op thread)

EX = {"question": "Is this a defect?", "A": "yes", "B": "no",
      "C": "maybe", "D": "unknown", "answer": "B"}
ZH = {"question": "题目", "A": "甲", "B": "乙", "C": "丙", "D": "丁",
      "answer": "C"}
THREE = {"question": "Which part?", "A": "top", "B": "left", "C": "none",
         "answer": "A"}


@pytest.mark.parametrize("lang,example,shots", [
    ("en", EX, []), ("en", EX, [EX, THREE]), ("en", THREE, [EX]),
    ("zh", ZH, []), ("zh", ZH, [ZH, ZH]),
])
def test_format_example_matches_jax(lang, example, shots):
    subject = "数学" if lang == "zh" else "anomaly detection"
    assert mmlu.format_example(example, shots, subject, lang=lang) == (
        jax_mmlu.format_example(example, shots, subject, lang=lang))
    assert mmlu.EVAL_TEMPLATES == jax_mmlu.EVAL_TEMPLATES
    assert (mmlu.EN_SYSTEM, mmlu.EN_CHOICE, mmlu.EN_ANSWER) == (
        jax_mmlu.EN_SYSTEM, jax_mmlu.EN_CHOICE, jax_mmlu.EN_ANSWER)


TEXT_HF = dict(vocab_size=600, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, rope_theta=1e4,
               tie_word_embeddings=True,
               architectures=["Qwen2ForCausalLM"])


@pytest.fixture(scope="module")
def vl_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


def _evaluators(kind, vl_checkpoint, max_length=96, batch_size=3):
    """(port, JAX) evaluators over the same f32 parameters."""
    tok = tiny_qwen_tokenizer()
    if kind == "text":
        jb = jax_registry.make_qwen2_bundle(TEXT_HF, attention="xla",
                                            precision=JAX_FULL)
        jparams = jb.init_params(jax.random.PRNGKey(3))
        tb = registry.make_qwen2_bundle(TEXT_HF, precision=FULL_PRECISION)
        tparams = params_from_jax(jparams, device="cpu")
    else:
        state = load_safetensors_path(vl_checkpoint)
        jb = jax_registry.bundle_from_pretrained(
            vl_checkpoint, attention="xla", precision=JAX_FULL)
        jparams = jb.convert_hf(state, dtype=jnp.float32)
        tb = registry.bundle_from_pretrained(vl_checkpoint,
                                             precision=FULL_PRECISION)
        tparams = tb.convert_hf(state, dtype=torch.float32, device="cpu")
    kw = dict(max_length=max_length, batch_size=batch_size)
    return (mmlu.MMLUEvaluator(tb, tparams, tok, device="cpu", **kw),
            jax_mmlu.MMLUEvaluator(jb, jparams, tok, **kw))


def _prompts():
    rng = np.random.default_rng(0)
    words = ["scratch", "dent", "surface", "top", "left", "image", "fox",
             "lazy", "dog", "hello", "defects", "answer"]
    out = []
    for i in range(5):
        ex = {"question": " ".join(rng.choice(words, 3 + i)),
              **{c: " ".join(rng.choice(words, 2)) for c in "ABCD"},
              "answer": "ABCD"[i % 4]}
        shots = [EX] * (i % 3)
        out.append(mmlu.format_example(ex, shots, "inspection")[0])
    # one prompt longer than max_length: cut from the left
    out.append(" ".join(["defects"] * 200) + out[0])
    return out


@pytest.mark.parametrize("kind", ["text", "qwen2_vl"])
def test_choice_logits_and_letters_match_jax(kind, vl_checkpoint):
    port, ref = _evaluators(kind, vl_checkpoint)
    assert port.choice_ids == ref.choice_ids
    prompts = _prompts()
    for i in range(0, len(prompts), port.batch_size):
        chunk = prompts[i:i + port.batch_size]
        batch = port.encode_batch(chunk)
        assert batch["input_ids"].shape == (len(chunk), port.max_length)
        # positions run across the right padding; the last valid
        # position is sum(segments) - 1
        np.testing.assert_array_equal(
            batch["position_ids"][0].numpy(), np.arange(port.max_length))
        got = port._logits(port.params, batch).numpy()
        want = np.asarray(ref._logits(ref.params, {
            "input_ids": jnp.asarray(batch["input_ids"].numpy(), jnp.int32),
            "segment_ids": jnp.asarray(batch["segment_ids"].numpy()),
            "position_ids": jnp.asarray(batch["position_ids"].numpy(),
                                        jnp.int32)}))
        assert got.dtype == np.float32 and got.shape == (len(chunk), 4)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    letters = port.predict(prompts)
    assert letters == ref.predict(prompts)
    assert set(letters) <= set("ABCD")


def test_encode_batch_pins_the_jax_details():
    """Choice ids are each letter's last sub-token without specials, the
    pad id falls back to EOS then 0, a prompt is cut from the left."""
    class Tok:
        pad_token_id = None
        eos_token_id = None

        def encode(self, text, add_special_tokens=True):
            ids = [ord(c) for c in text]
            return ([1] + ids) if add_special_tokens else [99] + ids

    ev = mmlu.MMLUEvaluator(None, None, Tok(), max_length=4, batch_size=2,
                            device="cpu")
    assert ev.choice_ids == [ord(c) for c in "ABCD"]
    batch = ev.encode_batch(["abcdef", "x"])
    np.testing.assert_array_equal(batch["input_ids"].numpy(), [
        [ord(c) for c in "cdef"], [1, ord("x"), 0, 0]])
    np.testing.assert_array_equal(batch["segment_ids"].numpy(),
                                  [[1, 1, 1, 1], [1, 1, 0, 0]])


def _task_dir(root):
    rng = np.random.default_rng(1)
    os.makedirs(root)
    subjects = {"anomaly": "STEM", "surface": "Other", "parts": "STEM"}
    for k, subject in enumerate(subjects):
        items = [{"question": f"Q{k}-{i}: is it {w}?", "A": "yes",
                  "B": "no", "C": str(w), "D": "unknown",
                  "answer": "ABCD"[int(rng.integers(4))]}
                 for i, w in enumerate(rng.choice(["scratch", "dent",
                                                   "fox"], 4))]
        with open(os.path.join(root, f"{subject}.json"), "w") as f:
            json.dump({"train": items[:3], "test": items}, f)
    with open(os.path.join(root, "mapping.json"), "w") as f:
        json.dump({s: {"name": f"{s} inspection", "category": c}
                   for s, c in subjects.items()}, f)
    return root


@pytest.mark.parametrize("n_shot,seed", [(0, 42), (2, 7)])
def test_eval_task_results_json_is_byte_identical(n_shot, seed,
                                                  vl_checkpoint, tmp_path):
    port, ref = _evaluators("qwen2_vl", vl_checkpoint, max_length=160,
                            batch_size=4)
    task = _task_dir(str(tmp_path / "task"))
    out = {s: str(tmp_path / s) for s in ("port", "jax")}
    scores = port.eval_task(task, n_shot=n_shot, seed=seed,
                            save_dir=out["port"])
    assert scores == ref.eval_task(task, n_shot=n_shot, seed=seed,
                                   save_dir=out["jax"])
    assert set(scores) == {"Average", "STEM", "Other"}
    files = [open(os.path.join(out[s], "results.json"), "rb").read()
             for s in ("port", "jax")]
    assert files[0] == files[1]
