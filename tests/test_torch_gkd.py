"""The port's GKD (train/gkd.py) against the JAX package on the CPU: the
per-token generalized JSD at beta 0, 1/2 and 1, the chunked JSD loss at
chunk sizes that do not divide the token count (loss and gradients), one
make_gkd_step against JAX's (metrics rtol 1e-4, parameters atol 1e-5) on
a tiny text Qwen2 student with a teacher from another seed, and the
trainer's on-policy and dataset branches under one seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.train import gkd as jgkd
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.train import gkd as tgkd
from iadr1_tpu_torch.train.grpo import bundle_score_fn
from iadr1_tpu_torch.train.state import create_train_state
from test_torch_grpo import Tok
from test_torch_preference import (
    assert_metrics_close,
    assert_params_close,
    jax_score_fn,
    jbatch,
    optimizers,
    rows_batch,
    setup,
    states,
)
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def models():
    """(JAX bundle, port bundle, student params, teacher params)."""
    jb, tb, jparams = setup()
    return jb, tb, jparams, jb.init_params(jax.random.PRNGKey(7))


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_token_jsd_matches_jax(beta):
    rng = np.random.default_rng(0)
    s = (rng.standard_normal((6, 50)) * 2).astype(np.float32)
    t = (rng.standard_normal((6, 50)) * 2).astype(np.float32)
    got = tgkd._token_jsd(torch.as_tensor(s), torch.as_tensor(t), beta)
    want = np.asarray(jgkd._token_jsd(jnp.asarray(s), jnp.asarray(t), beta))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert (got >= -1e-6).all()


@pytest.mark.parametrize("chunk", [5, 7, 64])
def test_chunked_jsd_loss_matches_jax(chunk):
    """B (T-1) = 3 x 11 = 33 tokens, of which the labeled ones count;
    chunks of 5 and 7 leave a partial last chunk.  The loss, the count
    and the student's gradients (hidden and head) match JAX's."""
    rng = np.random.default_rng(chunk)
    B, T, H, V = 3, 12, 16, 40
    sh = rng.standard_normal((B, T, H)).astype(np.float32)
    th = rng.standard_normal((B, T, H)).astype(np.float32)
    sk = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    tk = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, T))
    labels[:, :4] = IGNORE_INDEX
    labels[1, 9:] = IGNORE_INDEX
    kw = dict(beta=0.5, temperature=0.9, chunk_size=chunk)

    def jax_loss(sh_, sk_):
        return jgkd.chunked_jsd_loss(sh_, jnp.asarray(th), sk_,
                                     jnp.asarray(tk), jnp.asarray(labels),
                                     **kw)

    want, want_n = jax_loss(jnp.asarray(sh), jnp.asarray(sk))
    gh, gk = jax.grad(lambda a, b: jax_loss(a, b)[0], argnums=(0, 1))(
        jnp.asarray(sh), jnp.asarray(sk))
    sh_t = torch.as_tensor(sh).requires_grad_(True)
    sk_t = torch.as_tensor(sk).requires_grad_(True)
    got, n = tgkd.chunked_jsd_loss(sh_t, torch.as_tensor(th), sk_t,
                                   torch.as_tensor(tk),
                                   torch.as_tensor(labels), **kw)
    got.backward()
    assert float(n) == float(want_n) == float((labels[:, 1:] != -100).sum())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(sh_t.grad.numpy(), np.asarray(gh), atol=1e-6)
    np.testing.assert_allclose(sk_t.grad.numpy(), np.asarray(gk), atol=1e-6)


def test_gkd_step_matches_jax(models):
    """Two steps of make_gkd_step on 3 ragged rows: the metrics (the
    loss, the label count) and the parameters; the teacher is untouched."""
    jb, tb, jparams, jteacher = models
    (jo, jsched), (to, tsched) = optimizers()
    cfg = dict(beta=0.5, temperature=0.9, logit_chunk_size=7)
    jstep = jgkd.make_gkd_step(jax_score_fn(jb, remat=False),
                               jax_score_fn(jb, remat=False), jo,
                               jgkd.GKDConfig(**cfg), jsched)
    tstep = tgkd.make_gkd_step(bundle_score_fn(tb, remat=False),
                               bundle_score_fn(tb, remat=False), to,
                               tgkd.GKDConfig(**cfg), tsched)
    jstate, tstate = states(jparams, jo, to)
    teacher = params_from_jax(jteacher, device="cpu")
    before = {k: v.clone() for k, v in teacher["embed"].items()}
    batch = rows_batch(3, seed=6)
    for i in (1, 2):
        jstate, jm = jstep(jstate, jteacher, jbatch(batch))
        tstate, tm = tstep(tstate, teacher, batch)
        assert_metrics_close(tm, jm, f"gkd step {i}")
        assert_params_close(tstate.params, jstate.params, msg=f"step {i}")
    assert all(torch.equal(before[k], teacher["embed"][k]) for k in before)


EXAMPLES = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "completion_ids": [20, 21]},
            {"prompt_ids": [11, 12, 13], "completion_ids": [22, 23, 24, 25,
                                                            26]}]


def _trainers(models, lmbda, seed):
    jb, tb, jparams, jteacher = models
    (jo, jsched), (to, tsched) = optimizers()
    cfg = dict(beta=0.5, lmbda=lmbda, max_prompt_length=8,
               max_completion_length=4, logit_chunk_size=8)
    jt = jgkd.GKDTrainer(jb, jb, Tok(), jo, jgkd.GKDConfig(**cfg),
                         states(jparams, jo, to)[0], jteacher,
                         schedule=jsched, seed=seed)
    tt = tgkd.GKDTrainer(tb, tb, Tok(), to, tgkd.GKDConfig(**cfg),
                         create_train_state(params_from_jax(
                             jparams, device="cpu"), to),
                         params_from_jax(jteacher, device="cpu"),
                         schedule=tsched, seed=seed, device="cpu")
    return jt, tt


def test_the_dataset_branch_matches_the_jax_trainer(models):
    """lmbda 0: every step takes the dataset completions (cut to 4): two
    trainer steps' metrics and parameters equal JAX's."""
    jt, tt = _trainers(models, 0.0, seed=3)
    for i in (1, 2):
        jm, tm = jt.step(EXAMPLES), tt.step(EXAMPLES)
        assert tm["on_policy"] == jm["on_policy"] == 0.0
        assert_metrics_close(tm, jm, f"gkd trainer step {i}")
    assert_params_close(tt.state.params, jt.state.params)
    assert tt._rollouts == 0


def test_the_branches_follow_the_host_draw(models):
    """lmbda 1/2 under seed 1: the branch of each step is the host
    generator's draw (np.random.default_rng(seed).random() <= lmbda, as
    JAX's); the on-policy steps roll out, each from its own stream."""
    _, tt = _trainers(models, 0.5, seed=1)
    want = np.random.default_rng(1).random(4) <= 0.5
    assert want.any() and not want.all()
    got = [tt.step(EXAMPLES) for _ in range(4)]
    assert [bool(m["on_policy"]) for m in got] == want.tolist()
    assert tt._rollouts == int(want.sum())
    for m in got:
        assert np.isfinite(m["loss"]) and m["n_label_tokens"] > 0
