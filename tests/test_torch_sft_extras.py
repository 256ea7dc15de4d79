"""The SFT leftovers of the port against the JAX package's: the fused
chunked CE (``make_fused_chunked_ce`` and ``make_chunked_sft_step(...,
fused_ce=True)``), the unchunked ``make_sft_step`` and
``IterativeSFTTrainer``, on a tiny text Qwen2 in f32.

Both packages get the same parameters (JAX's ``init_params`` carried
across by ``params_from_jax``) and the same seeded batches.  Tolerances
are those of tests/test_torch_sft.py, for the same reason (f32, the two
differ in summation order only): loss, grad norm and learning rate rtol
1e-5; parameters after each step (2, the trainer's 3) atol 2e-6, the k
bias 2e-5 (its gradient nearly cancels).  The fused CE against the port's own chunked CE:
loss rtol 1e-6, d_hidden and d_W atol 1e-6 (the same products summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train import sft as jsft
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch import train as ttrain
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import (
    IterativeSFTTrainer,
    chunked_sft_loss,
    make_chunked_sft_step,
    make_fused_chunked_ce,
    make_sft_step,
)
from iadr1_tpu_torch.train.state import create_train_state
import torch_threads  # noqa: F401  (one intra-op thread)

from helpers import tiny_qwen_tokenizer

QWEN2 = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=1e6,
             tie_word_embeddings=False, architectures=["Qwen2ForCausalLM"])
OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)
CHUNK = 24


def _batches(seed=0, B=2, T=40):
    """Two batches of B rows of T tokens: two packed segments a row, a
    prompt third of each masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ids = rng.integers(1, QWEN2["vocab_size"], (B, T)).astype(np.int32)
        labels = ids.copy()
        labels[:, :T // 3] = -100
        labels[:, T // 2:T // 2 + 4] = -100
        segs = np.where(np.arange(T) < T // 2, 1, 2).astype(np.int32)
        segs = np.broadcast_to(segs, (B, T)).copy()
        segs[1, -5:] = 0
        labels[1, -5:] = -100
        pos = np.where(np.arange(T) < T // 2, np.arange(T),
                       np.arange(T) - T // 2).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels, "segment_ids": segs,
                    "position_ids": np.broadcast_to(pos, (B, T)).copy()})
    return out


@pytest.fixture(scope="module")
def setup():
    jb = jax_bundle(QWEN2, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(QWEN2, precision=FULL_PRECISION)
    return dict(jb=jb, tb=tb, jparams=jb.init_params(jax.random.PRNGKey(0)),
                batches=_batches())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _check_metrics(tm, jm, step, keys=("loss", "grad_norm", "learning_rate",
                                       "accuracy")):
    for key in keys:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {step} {key}")


def _check_params(tparams, jparams, step):
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(
            t.detach().numpy(), np.asarray(want[name]),
            atol=2e-5 if name.endswith("/k/bias") else 2e-6, rtol=0,
            err_msg=f"step {step} {name}")


def _states(setup, **over):
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT, **over))
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT, **over))
    return (jax_state(jax.tree.map(jnp.copy, setup["jparams"]), jo), jo,
            jsched, create_train_state(
                params_from_jax(setup["jparams"], device="cpu"), to),
            to, tsched)


def _run(setup, jfn, tfn, jstate, tstate):
    for step, batch in enumerate(setup["batches"], start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        tstate, tm = tfn(tstate, batch)
        _check_metrics(tm, jm, step)
        assert int(tm["n_label_tokens"]) == int(jm["n_label_tokens"])
        _check_params(tstate.params, jstate.params, step)
    return tm


def _ce_inputs(seed=3):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((2, 41, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 41))
    labels[0, :11] = -100
    labels[1, 30:] = -100
    return hidden, kernel, labels


def _grads(fn, hidden, kernel, labels):
    """d(3 loss + 2 metrics["loss"]) / d(hidden, kernel): both cotangents
    reach the gradients."""
    h = torch.tensor(hidden, requires_grad=True)
    k = torch.tensor(kernel, requires_grad=True)
    loss, m = fn(h, k, torch.tensor(labels))
    dh, dk = torch.autograd.grad(3 * loss + 2 * m["loss"], (h, k))
    return loss, m, dh, dk


def test_fused_ce_equals_the_chunked_ce():
    """Loss, metrics, d_hidden and d_W of the fused CE against autograd
    through the port's chunked CE (81 tokens in chunks of 24: a padded
    last chunk)."""
    args = _ce_inputs()
    loss, m, dh, dk = _grads(make_fused_chunked_ce(CHUNK), *args)
    ref, rm, rdh, rdk = _grads(
        lambda h, k, t: chunked_sft_loss(h, k, t, CHUNK), *args)
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    assert float(m["accuracy"]) == float(rm["accuracy"])
    assert int(m["n_label_tokens"]) == int(rm["n_label_tokens"]) == int(
        (args[2][:, 1:] != -100).sum())
    torch.testing.assert_close(dh, rdh, atol=1e-6, rtol=0)
    torch.testing.assert_close(dk, rdk, atol=1e-6, rtol=0)
    assert not dh[:, -1].any()                # the last position predicts none


def test_fused_ce_equals_jax_fused_ce():
    """The same against JAX's make_fused_chunked_ce (f32: loss rtol 1e-6,
    gradients atol 1e-6)."""
    hidden, kernel, labels = _ce_inputs(seed=4)
    loss, m, dh, dk = _grads(make_fused_chunked_ce(CHUNK), hidden, kernel,
                             labels)
    fused = jsft.make_fused_chunked_ce(CHUNK)

    def obj(h, k):
        jl, jm = fused(h, k, jnp.asarray(labels))
        return 3 * jl + 2 * jm["loss"], (jl, jm)

    (_, (jl, jm)), (jdh, jdk) = jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                           jnp.asarray(kernel))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    assert int(m["n_label_tokens"]) == int(jm["n_label_tokens"])
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=1e-6)


def test_fused_ce_without_gradients_gives_the_loss_only():
    hidden, kernel, labels = _ce_inputs(seed=5)
    with torch.no_grad():
        loss, m = make_fused_chunked_ce(CHUNK)(
            torch.tensor(hidden), torch.tensor(kernel), torch.tensor(labels))
    ref, _ = chunked_sft_loss(torch.tensor(hidden), torch.tensor(kernel),
                              torch.tensor(labels), CHUNK)
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    assert m["loss"].item() == loss.item()


def test_fused_step_matches_jax(setup):
    """Two steps of make_chunked_sft_step(fused_ce=True) against JAX's."""
    jstate, jo, jsched, tstate, to, tsched = _states(setup)
    jb, tb = setup["jb"], setup["tb"]
    jfn = jsft.make_chunked_sft_step(
        lambda p, b: jb.hidden_fn(p, b, remat=False), jb.head_kernel_fn, jo,
        jsched, donate=False, chunk_size=CHUNK, fused_ce=True)
    tfn = make_chunked_sft_step(tb.hidden_fn, tb.head_kernel_fn, to, tsched,
                                chunk_size=CHUNK, fused_ce=True)
    _run(setup, jfn, tfn, jstate, tstate)


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_the_aux_loss_branch_matches_jax(setup, fused):
    """aux_loss_coef > 0 under both CE settings: hidden_fn returns (hidden,
    aux), here aux = the mean of hidden^2 over the real tokens in both
    packages."""
    jstate, jo, jsched, tstate, to, tsched = _states(setup)
    jb, tb = setup["jb"], setup["tb"]

    # the padding's hidden states differ between the packages (a row with
    # no valid key: 0 from the port's attention), so the aux, like the
    # MoE's, reads the real tokens only
    def jhidden(p, b):
        h = jb.hidden_fn(p, b, remat=False)
        real = (b["segment_ids"] > 0)[..., None]
        return h, jnp.sum(jnp.where(real, h ** 2, 0.0)) / (
            real.sum() * h.shape[-1])

    def thidden(p, b):
        h = tb.hidden_fn(p, b)
        real = (b["segment_ids"] > 0)[..., None]
        return h, torch.where(real, h ** 2, 0.0).sum() / (
            real.sum() * h.shape[-1])

    jfn = jsft.make_chunked_sft_step(
        jhidden, jb.head_kernel_fn, jo, jsched, donate=False,
        chunk_size=CHUNK, aux_loss_coef=0.01, fused_ce=fused)
    tfn = make_chunked_sft_step(thidden, tb.head_kernel_fn, to, tsched,
                                chunk_size=CHUNK, aux_loss_coef=0.01,
                                fused_ce=fused)
    tm = _run(setup, jfn, tfn, jstate, tstate)
    assert "aux_loss" in tm


def test_unchunked_step_matches_jax(setup):
    """make_sft_step over the bundles' full logits (``forward``)."""
    jstate, jo, jsched, tstate, to, tsched = _states(setup)
    jb, tb = setup["jb"], setup["tb"]
    jfn = jsft.make_sft_step(lambda p, b: jb.forward(p, b, remat=False), jo,
                             jsched, donate=False)
    tfn = make_sft_step(tb.forward, to, tsched)
    _run(setup, jfn, tfn, jstate, tstate)


def test_train_exports_what_jax_train_exports():
    import iadr1_tpu.train as jtrain

    names = [n for n in dir(jtrain) if not n.startswith("_")
             and not isinstance(getattr(jtrain, n), type(jtrain))]
    assert [n for n in names if not hasattr(ttrain, n)] == []
    assert ttrain.make_sft_step is make_sft_step
    assert ttrain.IterativeSFTTrainer is IterativeSFTTrainer


def _trainers(setup, tok):
    """Both trainers from the same state.  Adam's eps is 1e-6: the repeated
    texts make a few gradient entries nearly cancel, and at eps 1e-8 Adam's
    normalised step carries their f32 noise to the learning rate's scale
    (one q-kernel entry of 8192 differed by 4.9e-6 after 3 steps)."""
    jb, tb = setup["jb"], setup["tb"]
    jstate, jo, jsched, tstate, to, tsched = _states(setup, eps=1e-6)
    kw = dict(max_length=24, ce_chunk=CHUNK)
    return (jsft.IterativeSFTTrainer(jb, tok, jo, jsched, state=jstate, **kw),
            IterativeSFTTrainer(tb, tok, to, tsched, state=tstate, **kw))


def test_iterative_trainer_matches_jax(setup):
    """Two steps from texts (one cut at max_length, rows of unequal
    length), then one from input_ids with labels that mask a prompt: the
    metrics of each, then the parameters, against JAX's trainer."""
    tok = tiny_qwen_tokenizer()
    jt, tt = _trainers(setup, tok)
    texts = ["No defects were found in this sample.",
             "Are there any defects in the image? " * 3,
             "<answer>No</answer>"]
    prompt = tok.encode("Are there any defects?", add_special_tokens=False)
    answer = tok.encode("<answer>No</answer>", add_special_tokens=False)
    ids = [prompt + answer, answer]
    labels = [[-100] * len(prompt) + answer, answer]
    for kw in (dict(texts=texts), dict(texts=texts[::-1]),
               dict(input_ids=ids, labels=labels)):
        tm, jm = tt.step(**kw), jt.step(**kw)
        assert tm.keys() == jm.keys()
        _check_metrics(tm, jm, len(tt.metrics_history))
        assert tm["n_label_tokens"] == jm["n_label_tokens"]
    assert tt.metrics_history[-1]["n_label_tokens"] == 2 * len(answer) - 1
    assert len(tt.metrics_history) == len(jt.metrics_history) == 3
    _check_params(tt.state.params, jt.state.params, 3)
    with pytest.raises(ValueError, match="texts or input_ids"):
        tt.step()


def test_iterative_trainer_builds_its_state_where_asked(setup, monkeypatch):
    """With no state it draws bundle.init_params(seed=0) on the device
    asked for; with no device and no card it raises, as every entry point
    does."""
    tok = tiny_qwen_tokenizer()
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tb = setup["tb"]
    trainer = IterativeSFTTrainer(tb, tok, to, tsched, max_length=16,
                                  ce_chunk=CHUNK, device="cpu")
    want = tb.init_params(seed=0, device="cpu")
    for (name, got), (_, ref) in zip(_leaves(trainer.state.params),
                                     _leaves(want)):
        assert torch.equal(got.detach(), ref), name
    assert np.isfinite(trainer.step(texts=["No defects."])["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IterativeSFTTrainer(tb, tok, to, tsched)
