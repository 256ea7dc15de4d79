"""Serving path parity: the port's RolloutEngine and VLMGenerator against
the JAX package's on the tiny Qwen2-VL checkpoint of tests/helpers.py.

Both run FULL_PRECISION (f32 compute) with the generators' default bf16
KV cache; the port's attention is the K1/K4 twin, the JAX side's the XLA
oracle.  Greedy decoding must be token-identical.  Two images of different
sizes, left padding.  The checkpoint's weights get the same seeded numpy
noise on both sides: at HF's init scale the tiny model repeats one token,
which would make token identity a weak check.
"""

import numpy as np
import pytest
import torch

import jax

from helpers import build_tiny_vlm_checkpoint, tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models.params_io import load_safetensors_path
from iadr1_tpu.models.registry import bundle_from_pretrained as jax_bundle
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models.registry import bundle_from_pretrained
from iadr1_tpu_torch.train.rollout import SamplingConfig, sample_token

GEN = dict(max_prompt_length=96, max_new_tokens=10, batch_size=2,
           patch_budget=128, min_pixels=56 * 56, max_pixels=28 * 28 * 64)
QUESTION = "<image>Are there any defects in the image?"


def _image(w, h, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def gens(tmp_path_factory):
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
    return jgen, tgen


def _requests():
    return [
        {"messages": [{"role": "user", "content": QUESTION}],
         "images": [_image(56, 56, 0)]},
        {"messages": [{"role": "user", "content": "Describe it. " + QUESTION}],
         "images": [_image(112, 84, 1)]},
    ]


def _encoded(gen):
    return [gen._encode_request(r["messages"], r["images"])
            for r in _requests()]


def test_greedy_rollout_is_token_identical_to_jax(gens):
    jgen, tgen = gens
    jenc, tenc = _encoded(jgen), _encoded(tgen)
    for (jids, jp, jg), (tids, tp, tg) in zip(jenc, tenc):
        assert list(jids) == list(tids)
        assert jg == tg
        np.testing.assert_array_equal(tp[0], jp[0])
    assert len(tenc[0][0]) != len(tenc[1][0])      # rows are left-padded
    want = jgen.engine.generate(jgen.params, jgen._collate(jenc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, tgen._collate(tenc))
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 3 and not torch.equal(ids[0], ids[1])


def test_group_size_equals_repeated_prompts(gens):
    _, tgen = gens
    enc = _encoded(tgen)
    grouped = tgen.engine.generate(tgen.params, tgen._collate(enc),
                                   group_size=2)
    tgen.cfg.batch_size = 4
    try:
        repeated = tgen.engine.generate(
            tgen.params, tgen._collate([enc[0], enc[0], enc[1], enc[1]]))
    finally:
        tgen.cfg.batch_size = 2
    for key in ("completion_ids", "completion_mask", "prompt_ids",
                "prompt_mask"):
        torch.testing.assert_close(grouped[key], repeated[key], atol=0,
                                   rtol=0)


def test_vlm_generator_strings_match_jax(gens):
    jgen, tgen = gens
    want = jgen.generate(_requests() + _requests()[:1])
    got = tgen.generate(_requests() + _requests()[:1])
    assert got == want
    assert len(got) == 3 and got[0] != got[1]


def test_sampling_stays_inside_top_k_top_p_support():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 200)).astype(np.float32) * 3
    cfg = SamplingConfig(temperature=0.7, top_k=20, top_p=0.8)
    support = []
    for row in logits / cfg.temperature:
        order = np.argsort(-row)[:cfg.top_k]
        p = np.exp(row[order] - row[order].max())
        p /= p.sum()
        before = np.cumsum(p) - p
        support.append(set(order[before < cfg.top_p].tolist()))
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in support]
    for _ in range(200):
        tok = sample_token(torch.as_tensor(logits), cfg, gen).numpy()
        for b, t in enumerate(tok):
            assert t in support[b]
            seen[b].add(int(t))
    assert all(len(s) > 1 for s in seen)     # it does sample, not argmax


def test_approx_top_k_is_rejected():
    with pytest.raises(ValueError):
        SamplingConfig(approx_top_k=True)
