"""The port's PA-SFT path (packing, collator, chunked CE, AdamW, remat)
against the JAX package on tiny Qwen2-VL and text-Qwen2 configs.

Parameters come from JAX's ``init_params`` through ``params_from_jax``;
examples are drawn with numpy from a seed and go through both packages'
``pack_examples`` and batch builders, whose outputs must be equal.  Both
steps run FULL_PRECISION (f32); the JAX side uses ``attention="xla"``,
whose gradients equal flash's for SFT (dlse = 0).  Loss and grad norm
agree to rtol 1e-5 and parameters after 1 and 3 steps to atol 2e-6 (f32:
the two differ in summation order only, and AdamW's normalised step
turns a relative gradient difference of ~1e-6 into ~1e-6 of the learning
rate 1e-3).  The decoder's k bias gets atol 2e-5: a bias shared by every
key shifts a row's logits by nearly a constant, which softmax ignores, so
its gradient nearly cancels, f32 summation noise is a large part of it,
and Adam's normalised step carries that noise at the learning rate's
scale (measured up to 8e-6 after 3 steps).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.collator import VLMBatchBuilder as JaxBuilder
from iadr1_tpu.data.collator import text_batch as jax_text_batch
from iadr1_tpu.data.packing import pack_examples as jax_pack
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.metrics import ThroughputMeter
from iadr1_tpu_torch.core.precision import FULL_PRECISION, Precision
from iadr1_tpu_torch.data.collator import VLMBatchBuilder, text_batch
from iadr1_tpu_torch.data.packing import pack_examples
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.loop import LoopConfig, batch_iterator, run_sft_loop
from iadr1_tpu_torch.train.sft import (
    chunked_sft_loss,
    make_chunked_sft_step,
    sft_loss,
)
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves
from iadr1_tpu_torch.vision.preprocess import patchify_image

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=True)
VLM = dict(
    architectures=["Qwen2VLForConditionalGeneration"],
    text_config=dict(TEXT, rope_scaling={"type": "mrope",
                                         "mrope_section": [4, 6, 6]}),
    vision_config=dict(depth=2, embed_dim=64, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, video_token_id=8,
    vision_start_token_id=5, vision_end_token_id=6,
)
QWEN2 = dict(TEXT, architectures=["Qwen2ForCausalLM"],
             tie_word_embeddings=False)
OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CUTOFF, PATCH_BUDGET, CHUNK = 48, 256, 32
IMAGES = [(56, 56), (56, 84), (84, 56), (56, 56), (84, 84), (56, 56)]


def _examples(vision: bool, seed: int = 0):
    """Chatml-shaped rows: prompt (with one image) masked, answer labeled."""
    rng = np.random.default_rng(seed)
    examples = []
    for i, (h, w) in enumerate(IMAGES):
        prompt = [1, 2] + rng.integers(10, 512, 3 + i % 3).tolist()
        extras = {}
        if vision:
            flat, grid = patchify_image(rng.random((h, w, 3), np.float32))
            prompt += [5] + [7] * (int(np.prod(grid)) // 4) + [6]
            extras = {"extras": {"patches": [flat], "grid_thw": [grid]}}
        answer = rng.integers(10, 512, 5 + 2 * i).tolist()
        examples.append({"input_ids": prompt + answer,
                         "labels": [-100] * len(prompt) + answer, **extras})
    return examples


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for key in ("input_ids", "labels", "segment_ids", "position_ids"):
            np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)
        assert len(ra["extras"]) == len(rb["extras"])
        for ea, eb in zip(ra["extras"], rb["extras"]):
            for pa, pb in zip(ea["patches"], eb["patches"]):
                np.testing.assert_array_equal(pa, pb)


@functools.lru_cache(maxsize=None)
def _setup(family: str) -> dict:
    vision = family == "qwen2_vl"
    hf = VLM if vision else QWEN2
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    examples = _examples(vision)
    rows = pack_examples(examples, CUTOFF, 0)
    jrows = jax_pack(examples, CUTOFF, 0)
    if vision:
        batches = [VLMBatchBuilder(tb, PATCH_BUDGET)(rows[i:i + 2])
                   for i in (0, 2)]
        jbatches = [JaxBuilder(jb, PATCH_BUDGET)(jrows[i:i + 2])
                    for i in (0, 2)]
    else:
        batches = [text_batch(rows[i:i + 2]) for i in (0, 2)]
        jbatches = [jax_text_batch(jrows[i:i + 2]) for i in (0, 2)]
    return dict(vision=vision, jb=jb, tb=tb, rows=rows, jrows=jrows,
                batches=batches, jbatches=jbatches,
                jparams=jb.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(params=["qwen2_vl", "qwen2"])
def setup(request):
    return _setup(request.param)


@pytest.fixture
def vlm():
    return _setup("qwen2_vl")


@pytest.mark.parametrize("hf", [VLM, QWEN2], ids=["qwen2_vl", "qwen2"])
def test_bundle_stores_parameters_in_param_dtype(hf):
    """init_params with no dtype stores every leaf in the bundle's
    precision.param_dtype (f32 by default); a dtype the caller names wins."""
    def dtypes(bundle, **kw):
        return {t.dtype for t in tree_leaves(
            bundle.init_params(seed=0, device="cpu", **kw))}

    bf16 = bundle_from_hf_config(hf, precision=Precision(
        param_dtype=torch.bfloat16))
    assert dtypes(bf16) == {torch.bfloat16}
    assert dtypes(bf16, dtype=torch.float32) == {torch.float32}
    assert dtypes(bundle_from_hf_config(hf)) == {torch.float32}


def test_packing_and_batches_equal_jax(setup):
    _rows_equal(setup["rows"], setup["jrows"])
    assert len(setup["rows"]) >= 3
    assert max(int(r["segment_ids"].max()) for r in setup["rows"]) >= 2
    for got, want in zip(setup["batches"], setup["jbatches"]):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_steps_match_jax(setup):
    """Loss, grad norm and learning rate of steps 1-3, and parameters after
    1 and after 3 steps."""
    jb, tb = setup["jb"], setup["tb"]
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstate = jax_state(setup["jparams"], jo)
    jfn = jax_step(lambda p, b: jb.hidden_fn(p, b, remat=False),
                   jb.head_kernel_fn, jo, jsched, donate=False,
                   chunk_size=CHUNK)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstate = create_train_state(params_from_jax(setup["jparams"],
                                                device="cpu"), to)
    tfn = make_chunked_sft_step(tb.hidden_fn, tb.head_kernel_fn, to, tsched,
                                chunk_size=CHUNK)
    order = [0, 1, 0]
    for step, i in enumerate(order, start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in
                                  setup["jbatches"][i].items()})
        tstate, tm = tfn(tstate, setup["batches"][i])
        for key in ("loss", "grad_norm", "learning_rate", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {key}")
        assert float(tm["n_label_tokens"]) == float(jm["n_label_tokens"])
        if step in (1, 3):
            want = dict(_leaves(jstate.params))
            got = dict(_leaves(tstate.params))
            assert got.keys() == want.keys()
            for name, t in got.items():
                np.testing.assert_allclose(
                    t.detach().numpy(), np.asarray(want[name]),
                    atol=2e-5 if name.endswith("/k/bias") else 2e-6,
                    rtol=0, err_msg=f"step {step} {name}")
    assert tstate.step == 3


def _grads(tb, params, batch, **kw):
    from iadr1_tpu_torch.train.sft import batch_to_device
    from iadr1_tpu_torch.train.state import tree_leaves

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    b = batch_to_device(batch, "cpu")
    loss, _ = chunked_sft_loss(tb.hidden_fn(params, b, **kw),
                               tb.head_kernel_fn(params), b["labels"], CHUNK)
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def _check_same_grads(setup, base_kw, kw):
    """A remat mode against no remat: the same arithmetic replayed, so
    atol 1e-7 (f32)."""
    tb = setup["tb"]
    params = params_from_jax(setup["jparams"], device="cpu")
    base = _grads(tb, params, setup["batches"][0], **base_kw)
    got = _grads(tb, params, setup["batches"][0], **kw)
    for g, w in zip(got, base):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("mode", [True, "save_qkv", "full"])
def test_decoder_remat_modes_give_the_same_gradients(setup, mode):
    tower = {"tower_remat": False} if setup["vision"] else {}
    _check_same_grads(setup, dict(remat=False, **tower),
                      dict(remat=mode, **tower))


@pytest.mark.parametrize("mode", [True, "save_acts"])
def test_tower_remat_modes_give_the_same_gradients(vlm, mode):
    _check_same_grads(vlm, dict(remat=False, tower_remat=False),
                      dict(remat=False, tower_remat=mode))


def test_chunked_loss_equals_full_loss():
    """chunked_sft_loss (chunk 24 over 2 x 39 tokens: a padded last chunk)
    against sft_loss on the full logits; f32, rtol 1e-6."""
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.standard_normal((2, 40, 16), np.float32))
    kernel = torch.from_numpy(rng.standard_normal((16, 50), np.float32))
    labels = torch.from_numpy(rng.integers(0, 50, (2, 40)))
    labels[0, :11] = -100
    labels[1, 30:] = -100
    loss, m = chunked_sft_loss(hidden, kernel, labels, chunk_size=24)
    ref, rm = sft_loss(hidden @ kernel, labels)
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    assert float(m["accuracy"]) == pytest.approx(float(rm["accuracy"]))
    assert int(m["n_label_tokens"]) == int(rm["n_label_tokens"]) == 58


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(kind):
    """make_schedule against the JAX one (optax) at every step of a
    warmup + decay horizon and past its end; rtol 1e-6 (f32 in optax)."""
    kw = dict(learning_rate=2e-5, schedule=kind, total_steps=20,
              warmup_ratio=0.1, min_lr_ratio=0.1)
    ours = topt.make_schedule(topt.OptimizerConfig(**kw))
    ref = jopt.make_schedule(jopt.OptimizerConfig(**kw))
    for step in [0, 1, 2, 3, 7, 19, 20, 25]:
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                           abs=1e-12), step


@pytest.mark.parametrize("mu_dtype,max_norm",
                         [(None, 1.0), ("bfloat16", 0.5), (None, 100.0)])
def test_adamw_matches_optax(mu_dtype, max_norm):
    """Three updates of the in-place AdamW against optax's chain (clip,
    adamw with weight decay and a bf16 first moment) on the same
    gradients; f32, atol 4e-7 on parameters of magnitude up to ~2 (a few
    ulps: one rounding per operation, some fused differently), and the
    moments' stored dtype."""
    import optax

    rng = np.random.default_rng(5)
    shapes = {"a": (5, 7), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(learning_rate=1e-2, total_steps=5, warmup_steps=1,
              weight_decay=0.1, mu_dtype=mu_dtype, max_grad_norm=max_norm)
    jo, _ = jopt.make_optimizer(jopt.OptimizerConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jo.init(jparams)
    to, _ = topt.make_optimizer(topt.OptimizerConfig(**kw))
    leaves = [torch.from_numpy(params[k].copy()) for k in shapes]
    tst = to.init(leaves)
    for g in grads:
        updates, jst = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jst, jparams)
        jparams = optax.apply_updates(jparams, updates)
        to.apply(leaves, [torch.from_numpy(g[k]) for k in shapes], tst)
    for k, t in zip(shapes, leaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                   atol=4e-7, rtol=0, err_msg=k)
    want_mu = torch.bfloat16 if mu_dtype else torch.float32
    assert all(m.dtype == want_mu for m in tst["mu"]) and tst["count"] == 3


def test_other_optimizers_wait_for_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="A.14"):
        topt.make_optimizer(topt.OptimizerConfig(optimizer="lion"))


def test_run_sft_loop_logs_falling_loss(tmp_path, vlm):
    """The loop over batch_iterator on a repeated stream: the loss falls
    within 6 steps at lr 1e-3, and trainer_log.jsonl has every step."""
    setup = vlm
    tb = setup["tb"]
    opt, sched = topt.make_optimizer(topt.OptimizerConfig(
        learning_rate=1e-3, schedule="constant", warmup_steps=0,
        total_steps=6))
    state = create_train_state(params_from_jax(setup["jparams"],
                                               device="cpu"), opt)
    step = make_chunked_sft_step(tb.hidden_fn, tb.head_kernel_fn, opt, sched,
                                 chunk_size=CHUNK)
    rows = setup["rows"][:2]
    cfg = LoopConfig(output_dir=str(tmp_path), max_steps=6, batch_size=2,
                     logging_steps=1)
    meter = ThroughputMeter(flops_per_token_fwd=1e6, peak_flops=1e12)
    state, history = run_sft_loop(
        state, step, batch_iterator(rows, 2, 0, VLMBatchBuilder(
            tb, PATCH_BUDGET)), cfg, meter=meter)
    losses = [h["loss"] for h in history]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert meter.tokens == 6 * 2 * CUTOFF and history[-1]["mfu"] > 0
    assert losses[-1] < losses[0]
    assert len((tmp_path / "trainer_log.jsonl").read_text().splitlines()) == 6
