"""The port's PaliGemma (SigLIP tower, linear projector, the Gemma decoder
as a prefix LM; the paligemma template and mm style) against the JAX
package: the host side, serving, PA-SFT and SC-GRPO.

A tiny ``PaliGemmaForConditionalGeneration`` is written by
``save_pretrained`` into a temporary directory with the tiny tokenizer of
tests/helpers.py (its ``<image>`` is the image token; its BOS is set to
``<|endoftext|>`` so the template's BOS shows), and loaded by both
packages.  The tower is 144 wide with 2 heads, so its head dim is
so400m's 72; square inputs of 42 px (3 x 3 patches of 14).  The decoder
has 4 heads over 1 KV head of 16 (PaliGemma's single KV head), tied.
Both packages run FULL_PRECISION (f32 compute); the JAX side runs
``attention="xla"`` (its tower and its prefix-LM decoder are dense in any
case), the port its K1 twin in the tower, which masks the zero tiles that
pad the tile stream, and its dense prefix-LM attention in the decoder.

Tolerances: the host arrays and token ids exactly equal, the tiles within
1e-6; tower features atol 2e-5; logits and the mask modes' hidden states
atol 1e-4 (f32, summation order only); greedy tokens identical (the
weights get seeded noise); SFT loss rtol 1e-5, grad norm rtol 1e-4,
parameters atol 5e-6 (the tower's key bias takes only rounding noise for
a gradient, which AdamW's normalisation turns into updates of ~1e-6 in
either framework); GRPO metrics rtol 1e-4 and parameters atol 1e-5
(tests/test_torch_llava.py's helpers).

The JAX package's hazards, each pinned on both sides: its generator cuts
an over-long prompt from the left, the prepended image run first (ROADMAP
C.R3; the port raises), its SFT rows clamp the text's budget at 8 tokens
so packing drops the over-long row (C.R4; the port raises), and its
SC-GRPO update batch drops the ``tiles`` (C.R9: its update scores the
completions without the image).
"""

import copy
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.mm import expand_image_tokens as jax_expand
from iadr1_tpu.data.mm import prepend_image_tokens as jax_prepend
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.eval.generator import GeneratorConfig as JaxGenCfg
from iadr1_tpu.eval.generator import VLMGenerator as JaxGenerator
from iadr1_tpu.models import qwen2 as jqwen2
from iadr1_tpu.models import siglip as jsiglip
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.collator import VLMBatchBuilder
from iadr1_tpu_torch.data.mm import expand_image_tokens, prepend_image_tokens
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
from iadr1_tpu_torch.models import qwen2, siglip
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_export import export_params
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import (
    NOT_YET_PORTED,
    bundle_from_hf_config,
    bundle_from_pretrained,
)
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import make_chunked_sft_step
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves
from test_torch_llava import (
    _assert_params_close,
    _image,
    _leaves,
    check_update,
    record_grpo_case,
)
import torch_threads  # noqa: F401  (one intra-op thread)

SIZE, G2 = 42, 9                   # input px; patches (= features) a tile
VISION = dict(hidden_size=144, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=SIZE, patch_size=14,
              projection_dim=48)
TEXT = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=1, head_dim=16,
            rope_theta=10000.0, rms_norm_eps=1e-6, attention_dropout=0.0)
TOWER_ATOL, LOGITS_ATOL = 2e-5, 1e-4
BUDGET = 4 * G2                    # 4 tiles


def paligemma_tokenizer():
    tok = tiny_qwen_tokenizer()
    tok.bos_token = "<|endoftext|>"
    return tok


def build_tiny_paligemma_checkpoint(dirpath: str) -> str:
    """A tiny PaliGemma HF checkpoint: config, safetensors, tokenizer; the
    Gemma norms (zero at init) drawn away from it."""
    from transformers import (
        PaliGemmaConfig,
        PaliGemmaForConditionalGeneration,
    )

    tok = paligemma_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    model = PaliGemmaForConditionalGeneration(PaliGemmaConfig(
        text_config=dict(TEXT, vocab_size=max(len(tok), 600)),
        vision_config=dict(VISION),
        image_token_index=tok.convert_tokens_to_ids("<image>"),
        projection_dim=TEXT["hidden_size"]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name and "language_model" in name:
                p.add_(0.3 * torch.randn_like(p))
    model.eval().save_pretrained(dirpath)
    return dirpath


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = build_tiny_paligemma_checkpoint(
        str(tmp_path_factory.mktemp("paligemma")))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    return dict(path=path, hf=hf, jb=jb, tb=tb,
                jparams=jb.convert_hf(jax_load(path)),
                tparams=tb.convert_hf(load_safetensors_path(path),
                                      device="cpu"))


# ---------------------------------------------------------------------------
# registry, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["architectures", "model_type"])
def test_registry_resolves_the_family(tiny, key):
    hf = dict(tiny["hf"])
    hf.pop("model_type" if key == "architectures" else "architectures")
    tb = bundle_from_hf_config(hf)
    t = tb.cfg.text
    assert tb.family == "paligemma" and tb.template == "paligemma"
    assert (t.rms_norm_offset, t.hidden_act, t.scale_embeds) == (
        1.0, "gelu_pytorch_tanh", True)
    assert t.tie_word_embeddings and not t.attention_bias
    assert tb.cfg.vision.head_dim == 72 and tb.shared_pred_fn is None
    jt = tiny["jb"].cfg.text
    for field in ("rms_norm_offset", "hidden_act", "scale_embeds",
                  "head_dim_", "rope_theta", "rms_norm_eps"):
        assert getattr(t, field) == getattr(jt, field), field
    assert not {"paligemma", "PaliGemmaForConditionalGeneration",
                "pixtral"} & set(NOT_YET_PORTED)


NEW_TO_OLD = [("model.language_model.", "language_model.model."),
              ("lm_head.", "language_model.lm_head."),
              ("model.vision_tower.", "vision_tower."),
              ("model.multi_modal_projector.", "multi_modal_projector.")]


def _state(tiny, layout):
    state = load_safetensors_path(tiny["path"])
    pairs = NEW_TO_OLD if layout == "language_model.model" else [
        (old, new) for new, old in NEW_TO_OLD]

    def rename(k):
        return next((b + k[len(a):] for a, b in pairs if k.startswith(a)), k)

    return {rename(k): v for k, v in state.items()}


@pytest.mark.parametrize("layout", ["model.language_model",
                                    "language_model.model"])
def test_convert_hf_equals_jax_convert_then_params_from_jax(tiny, layout):
    state = _state(tiny, layout)
    assert any(k.startswith(layout) for k in state)
    got = dict(_leaves(tiny["tb"].convert_hf(state, device="cpu")))
    want = dict(_leaves(params_from_jax(tiny["jb"].convert_hf(
        {k: v.numpy() for k, v in state.items()}), device="cpu")))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_init_params_has_the_jax_tree(tiny):
    got = dict(_leaves(tiny["tb"].init_params(seed=0, device="cpu")))
    # shapes only: jax.eval_shape traces the JAX init without running it
    want = dict(_leaves(jax.eval_shape(
        lambda: tiny["jb"].init_params(jax.random.PRNGKey(0)))))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        if "norm" in name and name.startswith("/text"):
            assert not t.any(), name       # Gemma's (1 + w): w starts at 0


def test_export_is_refused_as_in_jax(tiny):
    with pytest.raises(ValueError, match="paligemma"):
        export_params(tiny["tb"], tiny["tparams"])


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def test_template_strip_and_prepend_encode_as_jax():
    tok = paligemma_tokenizer()
    img_id = tok.convert_tokens_to_ids("<image>")
    msgs = [{"role": "user", "content": "<image>Are there any defects?"}]
    got_m = expand_image_tokens(msgs, [G2], "paligemma", "<image>")
    assert got_m == jax_expand(msgs, [G2], "paligemma", "<image>")
    assert got_m[0]["content"] == "Are there any defects?"
    got, want = get_template("paligemma"), jax_template("paligemma")
    assert (got.image_token, got.mm_style, got.stop_words) == (
        want.image_token, want.mm_style, tuple(want.stop_words))
    ids = got.encode_prompt(tok, got_m)
    assert ids == want.encode_prompt(tok, got_m)
    assert ids[0] == tok.bos_token_id
    pairs = got_m + [{"role": "assistant", "content": "No."}]
    enc = got.encode_multiturn(tok, pairs)
    assert enc == [tuple(p) for p in want.encode_multiturn(tok, pairs)]
    src, tgt = enc[0]
    labels = [-100] * len(src) + tgt
    for lab in (labels, None):
        mine = prepend_image_tokens(src + tgt, lab, [G2, G2], img_id)
        assert mine == jax_prepend(src + tgt, lab, [G2, G2], img_id)
    ids, labels = prepend_image_tokens(src + tgt, labels, [G2], img_id)
    assert ids[:G2 + 1] == [img_id] * G2 + [tok.bos_token_id]
    assert labels[:G2 + len(src)] == [-100] * (G2 + len(src))


def _prompts(tb, n=2, seed=0, pad=3):
    """Left-padded paligemma prompts, one image each: the run ahead of
    BOS, then text ids clear of the image token."""
    rng = np.random.default_rng(seed)
    img_id = tb.cfg.image_token_id
    patches, grids, prompts = [], [], []
    for i in range(n):
        p, grid, k = tb.preprocess_image(_image(30 + 20 * i, 50, seed + i))
        patches.append(p)
        grids.append(grid)
        prompts.append([img_id] * k + [1] + rng.integers(
            10, 300, 4 + 2 * i).tolist())
    T = max(map(len, prompts)) + pad
    ids = np.zeros((n, T), np.int64)
    mask = np.zeros((n, T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    return ids, mask, patches, grids


def test_preprocess_and_vision_arrays_equal_jax(tiny):
    jb, tb = tiny["jb"], tiny["tb"]
    for i, hw in enumerate([(30, 50), (42, 42), (90, 20)]):
        img = _image(*hw, i)
        want, got = jb.preprocess_image(img), tb.preprocess_image(img)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2] == G2
    ids, _, patches, grids = _prompts(tb)
    want = jb.vision_arrays(ids, patches, grids, BUDGET)
    got = tb.vision_arrays(ids, patches, grids, BUDGET)
    assert set(got) == set(want) | {"tile_segments"}
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got["tile_segments"], [1, 1, 0, 0])
    cut = ids.copy()                 # one image token short
    r, c = np.nonzero(cut == tb.cfg.image_token_id)
    cut[r[0], c[0]] = 11
    with pytest.raises(ValueError, match="image tokens"):
        tb.vision_arrays(cut, patches, grids, BUDGET)
    with pytest.raises(ValueError, match="budget"):
        tb.vision_arrays(ids, patches, grids, G2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True, "save_acts"])
def test_tower_features_match_jax(tiny, remat):
    """SigLIP features of the tiles that hold images (D = 72), f32,
    against JAX's dense tower; the remat modes run forward and
    backward."""
    jb, tb = tiny["jb"], tiny["tb"]
    ids, _, patches, grids = _prompts(tb, seed=1)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    want = np.asarray(jsiglip.apply(tiny["jparams"]["vision"], jb.cfg.vision,
                                    jnp.asarray(arrays["tiles"]), JAX_FULL))
    vision = copy.deepcopy(tiny["tparams"]["vision"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(vision)]
    got = siglip.apply(vision, tb.cfg.vision,
                       torch.as_tensor(arrays["tiles"]), FULL_PRECISION,
                       remat=remat, attention_fn=default_attention("auto"),
                       tile_segments=torch.as_tensor(arrays["tile_segments"]))
    np.testing.assert_allclose(got.detach().numpy()[:2], want[:2],
                               atol=TOWER_ATOL, rtol=0)
    grads = torch.autograd.grad(got[:2].sum(), leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("layout", ["model.language_model",
                                    "language_model.model"])
def test_logits_match_jax(tiny, layout):
    """The training forward (no cache: the image columns unmasked) through
    both bundles, f32."""
    jb, tb, jp = tiny["jb"], tiny["tb"], tiny["jparams"]
    tp = tb.convert_hf(_state(tiny, layout), device="cpu")
    ids, mask, patches, grids = _prompts(tb, seed=2)
    arrays = tb.vision_arrays(ids, patches, grids, BUDGET)
    pos = np.clip(mask.cumsum(1) - 1, 0, None)
    batch = dict(arrays, input_ids=ids, position_ids=pos, segment_ids=mask)
    h, _ = jb.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()
                         if k != "tile_segments"})
    want = np.asarray(jb.logits_fn(jp, h))
    with torch.no_grad():
        h, _ = tb.apply(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
        got = tb.logits_fn(tp, h).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=LOGITS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["none", "prefill", "extend"])
def test_prefix_lm_mask_modes_match_jax(tiny, mode):
    """The Gemma decoder with ``bidirectional_mask`` in each cache mode
    against the JAX decoder: no cache (flags on a prefix of each segment,
    two packed segments and padding), a prefill (the whole block
    flagged), and an extend of 4 tokens after a 6-token prefill, flags on
    its first 2 written into the cache's slots."""
    jcfg, tcfg = tiny["jb"].cfg.text, tiny["tb"].cfg.text
    jp, tp = tiny["jparams"]["text"], tiny["tparams"]["text"]
    rng = np.random.default_rng(7)
    B, T = 2, 10
    emb = rng.standard_normal((B, T, 48)).astype(np.float32)
    seg = np.array([[0, 0, 1, 1, 1, 1, 2, 2, 2, 2], [1] * T], np.int32)
    pos = np.array([[0, 0, 0, 1, 2, 3, 0, 1, 2, 3], list(range(T))], np.int32)
    flags = np.array([[0, 0, 1, 1, 0, 0, 1, 0, 0, 0],
                      [1, 1, 1, 0, 0, 0, 0, 0, 0, 0]], np.int32)

    def both(emb, pos, seg, flags, jcache=None, tcache=None, cache_mode=""):
        kw = dict(cache_mode=cache_mode) if cache_mode else {}
        jh, jc = jqwen2.apply(
            jp, jcfg, inputs_embeds=jnp.asarray(emb),
            position_ids=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
            bidirectional_mask=(None if flags is None
                                else jnp.asarray(flags)),
            cache=jcache, precision=JAX_FULL, **kw)
        with torch.no_grad():
            th, tc = qwen2.apply(
                tp, tcfg, inputs_embeds=torch.as_tensor(emb),
                position_ids=torch.as_tensor(pos),
                segment_ids=torch.as_tensor(seg),
                bidirectional_mask=(None if flags is None
                                    else torch.as_tensor(flags)),
                cache=tcache, precision=FULL_PRECISION, **kw)
        return np.asarray(jh), th.numpy(), jc, tc

    if mode == "none":
        jh, th, _, _ = both(emb, pos, seg, flags)
        valid = seg != 0
        np.testing.assert_allclose(th[valid], jh[valid], atol=LOGITS_ATOL,
                                   rtol=0)
        causal, _, _, _ = both(emb, pos, seg, None)
        assert not np.allclose(causal[valid], jh[valid], atol=1e-3)
        return
    seg = np.ones((B, T), np.int32)
    seg[0, :2] = 0
    jcache = jqwen2.init_cache(jcfg, B, 16, jnp.float32)
    tcache = qwen2.init_cache(tcfg, B, 16, torch.float32, "cpu")
    if mode == "prefill":
        jh, th, jc, tc = both(emb, pos, seg, np.ones((B, T), np.int32),
                              jcache, tcache, "prefill")
        valid = seg != 0
        np.testing.assert_allclose(th[valid], jh[valid], atol=LOGITS_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   atol=LOGITS_ATOL, rtol=0)
        return
    _, _, jc, tc = both(emb[:, :6], pos[:, :6], seg[:, :6], None, jcache,
                        tcache, "prefill")
    ext = np.zeros((B, 4), np.int32)
    ext[:, :2] = 1
    jh, th, _, _ = both(emb[:, 6:], pos[:, 6:], seg[:, 6:], ext, jc, tc,
                        "extend")
    np.testing.assert_allclose(th, jh, atol=LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEN = dict(max_prompt_length=96, max_new_tokens=6, batch_size=2,
           patch_budget=BUDGET)


def _requests():
    q = "<image>Are there any defects in the image?"
    return [{"messages": [{"role": "user", "content": q}],
             "images": [_image(30, 50, 0)]},
            {"messages": [{"role": "user", "content": "Describe it. " + q}],
             "images": [_image(60, 40, 1)]}]


@functools.lru_cache(maxsize=None)
def _noised_state(path):
    rng = np.random.default_rng(0)
    return {k: v + 0.2 * rng.standard_normal(v.shape).astype(v.dtype)
            for k, v in jax_load(path).items()}


def test_greedy_generation_is_token_identical_to_jax(tiny):
    """Both generators encode the requests alike (the image run prepended,
    ahead of BOS) and roll out the same tokens: the port's prefill is
    prefix-LM and dense, its decode K4's twin at D = 16 here; JAX's decode
    the dense path over the cache."""
    tok = paligemma_tokenizer()
    state = _noised_state(tiny["path"])
    jb = tiny["jb"]
    jgen = JaxGenerator(jb, jb.convert_hf(state), tok,
                        jax_template(jb.template), JaxGenCfg(**GEN))
    tb = bundle_from_pretrained(tiny["path"], precision=FULL_PRECISION)
    tgen = VLMGenerator(tb, tb.convert_hf(state, device="cpu"), tok,
                        get_template(tb.template), GeneratorConfig(**GEN),
                        device="cpu")
    enc = [tgen._encode_request(r["messages"], r["images"])
           for r in _requests()]
    jenc = [jgen._encode_request(r["messages"], r["images"])
            for r in _requests()]
    for (ids, patches, _), (jids, jpatches, _) in zip(enc, jenc):
        assert ids == list(jids)
        assert ids[:G2 + 1] == [tb.cfg.image_token_id] * G2 + [
            tok.bos_token_id]
        np.testing.assert_array_equal(patches[0], jpatches[0])
    want = jgen.engine.generate(jgen.params, jgen._collate(jenc),
                                jax.random.PRNGKey(0))
    got = tgen.engine.generate(tgen.params, tgen._collate(enc))
    for key in ("completion_ids", "completion_mask", "prompt_ids"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    ids = got["completion_ids"]
    assert len(set(ids[0].tolist())) > 2 and not torch.equal(ids[0], ids[1])


def tgen_ids_of(tb, tok, messages):
    """The port's encoding of ``messages`` before any length check."""
    ids = get_template(tb.template).encode_prompt(
        tok, expand_image_tokens(messages, [G2], "paligemma", "<image>"))
    return prepend_image_tokens(ids, None, [G2], tb.cfg.image_token_id)[0]


def test_over_long_prompt_keeps_its_image_run(tiny):
    """C.R3: a prompt longer than max_prompt_length.  The JAX generator
    cuts it from the left, so the prepended image run loses tokens and
    its features no longer fit the run; the port raises instead."""
    tok = paligemma_tokenizer()
    cfg = dict(GEN, max_prompt_length=80)
    jb, tb = tiny["jb"], tiny["tb"]
    long = [{"role": "user",
             "content": "<image>" + "Are there any defects? " * 8}]
    jgen = JaxGenerator(jb, tiny["jparams"], tok, jax_template(jb.template),
                        JaxGenCfg(**cfg))
    jids, _, _ = jgen._encode_request(long, [_image(30, 50, 0)])
    assert len(jids) == cfg["max_prompt_length"]
    assert list(jids).count(jb.cfg.image_token_id) < G2 < len(
        tgen_ids_of(tb, tok, long))
    tgen = VLMGenerator(tb, tiny["tparams"], tok, get_template(tb.template),
                        GeneratorConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="max_prompt_length"):
        tgen._encode_request(long, [_image(30, 50, 0)])
    ids, _, _ = tgen._encode_request(
        [{"role": "user", "content": "<image>No?"}], [_image(30, 50, 0)])
    assert ids.count(tb.cfg.image_token_id) == G2


# ---------------------------------------------------------------------------
# PA-SFT
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CUTOFF, CHUNK = 40, 64


@functools.lru_cache(maxsize=None)
def _sft_batches(path):
    """Eight examples (five with an image, its run prepended) packed by the
    port and batched by its VLMBatchBuilder: two batches of two rows."""
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    rng = np.random.default_rng(5)
    img_id = tb.cfg.image_token_id
    examples = []
    for i in range(8):
        prompt = [1] + rng.integers(10, 300, 3 + i % 3).tolist()
        answer = rng.integers(10, 300, 4 + 2 * i).tolist()
        ids, labels = prompt + answer, [-100] * len(prompt) + answer
        extra = {}
        if i % 3 != 2:
            p, grid, n = tb.preprocess_image(_image(30 + 5 * i, 40, 10 + i))
            ids, labels = prepend_image_tokens(ids, labels, [n], img_id)
            extra = {"extras": {"patches": [p], "grid_thw": [grid]}}
        examples.append({"input_ids": ids, "labels": labels, **extra})
    rows = pack_examples(examples, CUTOFF, 0)
    assert len(rows) >= 4
    collate = VLMBatchBuilder(tb, patch_budget=BUDGET)
    return tb, [collate(rows[i:i + 2]) for i in (0, 2)]


def test_sft_steps_match_jax(tiny):
    """Loss, grad norm of 3 steps and the parameters after 1 and 3 steps,
    on the port's batches; the port's step runs the recipes' remat modes
    (save_qkv, the tower's save_acts), JAX's none."""
    jb = tiny["jb"]
    tb, batches = _sft_batches(tiny["path"])
    jparams = jb.convert_hf(jax_load(tiny["path"]))
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstate = jax_state(jparams, jo)
    jfn = jax_step(lambda p, b: jb.hidden_fn(p, b, remat=False),
                   jb.head_kernel_fn, jo, jsched, donate=False,
                   chunk_size=CHUNK)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstate = create_train_state(params_from_jax(jparams, device="cpu"), to)
    tfn = make_chunked_sft_step(
        lambda p, b: tb.hidden_fn(p, b, remat="save_qkv",
                                  tower_remat="save_acts"),
        tb.head_kernel_fn, to, tsched, chunk_size=CHUNK)
    for step, i in enumerate([0, 1, 0], start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batches[i].items()
                                  if k != "tile_segments"})
        tstate, tm = tfn(tstate, batches[i])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {step} grad norm")
        if step in (1, 3):
            _assert_params_close(tstate.params, jstate.params, 5e-6,
                                 f"step {step}")


def _sft_job(tiny, tmp_path, cutoff, images=True):
    from helpers import build_iad_sft_dataset
    from iadr1_tpu_torch.cli.train_sft import SFTJobConfig
    from iadr1_tpu_torch.core.config import load_config

    data, img_dir = build_iad_sft_dataset(tmp_path)
    recipe = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "sft_qwen2_5_vl_7b.yaml")
    return load_config(SFTJobConfig, recipe, [
        f"model.model_name_or_path={tiny['path']}", f"data.dataset={data}",
        f"data.image_dir={img_dir}", "data.template=paligemma",
        f"data.cutoff_len={cutoff}"])


def test_prepare_rows_equals_jax_and_refuses_what_jax_drops(tiny, tmp_path):
    """The SFT CLI's prepare_rows on the IAD dataset: each image's run
    prepended, the text budgeted after it, rows equal to JAX's.  C.R4: at
    a cutoff the image run fills, JAX clamps the text's budget at 8
    tokens, its rows outgrow the cutoff and packing drops them; the
    port raises."""
    from iadr1_tpu.cli.train_sft import prepare_rows as jax_rows
    from iadr1_tpu_torch.cli.train_sft import prepare_rows

    tok = paligemma_tokenizer()
    job = _sft_job(tiny, tmp_path, 64)
    got = prepare_rows(job.data, tok, get_template("paligemma"), tiny["tb"])
    want = jax_rows(job.data, tok, jax_template("paligemma"), tiny["jb"])
    assert len(got) == len(want) > 0
    img_id = tiny["tb"].cfg.image_token_id
    for g, w in zip(got, want):
        for key in ("input_ids", "labels", "segment_ids", "position_ids"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert list(g["input_ids"][:G2]) == [img_id] * G2
    short = _sft_job(tiny, tmp_path, G2 + 4)
    assert jax_rows(short.data, tok, jax_template("paligemma"),
                    tiny["jb"]) == []
    with pytest.raises(ValueError, match="leave the text no room"):
        prepare_rows(dataclasses.replace(short.data, cutoff_len=G2 + 1),
                     tok, get_template("paligemma"), tiny["tb"])
    rows = prepare_rows(short.data, tok, get_template("paligemma"),
                        tiny["tb"])
    assert rows and all(len(r["input_ids"]) == G2 + 4 for r in rows)


# ---------------------------------------------------------------------------
# SC-GRPO: the dense update
# ---------------------------------------------------------------------------

GRPO_PROMPT_LEN = 24
GRPO_BUDGET = 2 * 2 * G2           # G = 2: the update holds 4 images


def grpo_examples(tb, seed=0):
    rng = np.random.default_rng(seed)
    examples = []
    for i in range(2):
        p, grid, n = tb.preprocess_image(_image(30 + 10 * i, 40, 20 + i))
        examples.append({
            "prompt_ids": ([tb.cfg.image_token_id] * n + [1]
                           + rng.integers(10, 300, 5 + 3 * i).tolist()),
            "patches": [p], "grid_thw": [grid], "solution": "ab"[i]})
    return examples


@pytest.fixture(scope="module")
def grpo_case(tiny):
    return record_grpo_case(tiny["jb"], tiny["tb"], tiny["jparams"],
                            grpo_examples(tiny["tb"]), GRPO_PROMPT_LEN,
                            GRPO_BUDGET)


def test_jax_update_batch_drops_the_tiles(grpo_case):
    """C.R9 reaches PaliGemma: the JAX update batch keeps the scatter
    indices but not the tiles, and nothing raises."""
    keys = grpo_case["jax_update_keys"]
    assert "tiles" not in keys
    assert {"scatter_rows", "scatter_cols", "input_ids"} <= keys


def test_dense_update_matches_jax_fed_the_port_batch(tiny, grpo_case):
    """The dense update (no shared path in either package): the port's
    G-repeated batch carries the tiles of every rollout (R9 repaired); one
    update on it matches JAX's update step fed the same batch."""
    check_update(tiny["jb"], tiny["tb"], grpo_case, shared=False)
    from test_torch_llava import port_update

    batch = port_update(tiny["tb"], grpo_case, shared=False)[1]
    assert batch["tiles"].shape[0] == 4
    assert int(batch["tile_segments"].sum()) == 4


def test_rl_prompts_prepend_the_image_run_as_jax(tiny, tmp_path):
    """cli/train_grpo.py's RL prompts: the paligemma template, the image
    run ahead of BOS, ids equal to the JAX CLI's."""
    from helpers import build_iad_rl_dataset
    from iadr1_tpu.cli.train_grpo import GRPODataSection as JaxData
    from iadr1_tpu_torch.cli.train_grpo import (
        GRPODataSection,
        encode_rl_examples,
    )
    data, img_dir = build_iad_rl_dataset(tmp_path)
    with open(data) as f:
        rows = json.load(f)[:3]
    tok = paligemma_tokenizer()
    got = encode_rl_examples(rows, GRPODataSection(image_path=img_dir),
                             tiny["tb"], tok, get_template("paligemma"))
    want = jax_encode_rl(rows, JaxData(image_path=img_dir), tiny["jb"], tok)
    assert [g["prompt_ids"] for g in got] == [list(w) for w in want]
    assert got[0]["prompt_ids"][:G2] == [tiny["tb"].cfg.image_token_id] * G2


def jax_encode_rl(rows, data, jb, tok):
    """The JAX CLI's RL prompt encoding (its main's loop)."""
    from PIL import Image

    from iadr1_tpu.train.prompts import make_conversation

    template = jax_template("paligemma")
    out = []
    for row in rows:
        conv = make_conversation(row, image_path=data.image_path,
                                 use_system_prompt=data.use_system_prompt,
                                 single_img=data.single_img)
        seqlens = [jb.preprocess_image(Image.open(img))[2]
                   for img in conv["images"]]
        messages = jax_expand(conv["messages"], seqlens, "paligemma",
                              "<image>")
        ids = template.encode_prompt(tok, messages, system=conv["system"])
        out.append(jax_prepend(ids, None, seqlens,
                               jb.cfg.image_token_id)[0])
    return out
