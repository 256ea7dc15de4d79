"""The port's XPO, Nash-MD and mixture sampling (train/online_rl.py,
train/rollout.py) against the JAX package on a tiny text Qwen2, on the
CPU in f32 (FULL_PRECISION).

The XPO (sigmoid and ipo) and Nash-MD update steps are held to JAX's on
the same batch: every metric (rtol 1e-4) and every parameter after the
step (atol 1e-5).  The geometric mixture's first sampled distribution
is held to the one JAX's engine hands its sampler; greedy mixtures at
coefficient 0 and 1 are the policy's and the reference's own greedy
tokens.  Each trainer then steps on the port's own engine, with the tie
rules: a tie goes to the policy in XPO and counts 1/2 in Nash-MD.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.train import online_rl as jrl
from iadr1_tpu.train import rollout as jrollout
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.train import online_rl as trl
from iadr1_tpu_torch.train import rollout as trollout
from iadr1_tpu_torch.train.grpo import bundle_score_fn
from iadr1_tpu_torch.train.state import create_train_state
from test_torch_grpo import EOS, PAD, Tok, vowel_reward
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

EXAMPLES = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "solution": "a"},
            {"prompt_ids": [11, 12, 13], "solution": "b"}]


@pytest.fixture(scope="module")
def models():
    """(JAX bundle, port bundle, policy params, reference params): the
    tiny Qwen2 at two seeds (numpy trees)."""
    jb, tb, jparams = setup()
    ref = jb.init_params(jax.random.PRNGKey(1))
    return jb, tb, jparams, ref


# ---------------------------------------------------------------------------
# the update steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["sigmoid", "ipo"])
def test_xpo_update_step_matches_jax(models, loss_type):
    """2 prompts: rows 0-1 the policy's completions, 2-3 the reference's;
    the policy wins the first pair and loses the second.  A large alpha
    makes the exploration term count."""
    jb, tb, jparams, jref = models
    (jo, jsched), (to, tsched) = optimizers()
    kw = dict(beta=0.1, alpha=0.05, loss_type=loss_type, logp_chunk_size=8)
    jstep = jrl.make_xpo_update_step(jax_score_fn(jb, remat=False), jo,
                                     jrl.XPOConfig(**kw), jsched)
    tstep = trl.make_xpo_update_step(bundle_score_fn(tb, remat=False), to,
                                     trl.XPOConfig(**kw), tsched)
    jstate, tstate = states(jparams, jo, to)
    batch = dict(rows_batch(4, seed=3), chosen_mask=np.asarray([True, False]))
    jstate, jm = jstep(jstate, jref, jbatch(batch))
    tstate, tm = tstep(tstate, params_from_jax(jref, device="cpu"), batch)
    assert_metrics_close(tm, jm, loss_type)
    assert_params_close(tstate.params, jstate.params, msg=loss_type)
    assert float(tm["loss/xpo"]) != 0


def test_xpo_rejects_another_loss_type():
    with pytest.raises(ValueError, match="invalid XPO loss type"):
        trl.make_xpo_update_step(None, None, trl.XPOConfig(loss_type="hinge"))


def test_nash_md_update_step_matches_jax(models):
    """3 completions judged won, lost and tied (p = 1, 0, 1/2), two
    steps: the second's log-ratios are no longer 0."""
    jb, tb, jparams, jref = models
    (jo, jsched), (to, tsched) = optimizers()
    kw = dict(beta=0.1, mixture_coef=0.5, logp_chunk_size=8)
    jstep = jrl.make_nash_md_update_step(jax_score_fn(jb, remat=False), jo,
                                         jrl.NashMDConfig(**kw), jsched)
    tstep = trl.make_nash_md_update_step(bundle_score_fn(tb, remat=False),
                                         to, trl.NashMDConfig(**kw), tsched)
    jstate, tstate = states(jparams, jo, to)
    tref = params_from_jax(jref, device="cpu")
    batch = dict(rows_batch(3, seed=4),
                 probability=np.asarray([1.0, 0.0, 0.5], np.float32))
    for i in (1, 2):
        jstate, jm = jstep(jstate, jref, jbatch(batch))
        tstate, tm = tstep(tstate, tref, batch)
        assert_metrics_close(tm, jm, f"nash_md step {i}")
        assert_params_close(tstate.params, jstate.params, msg=f"step {i}")


# ---------------------------------------------------------------------------
# mixture sampling
# ---------------------------------------------------------------------------


def _prompt_batch():
    ids = np.full((2, 8), PAD, np.int64)
    mask = np.zeros((2, 8), np.int64)
    for i, ex in enumerate(EXAMPLES):
        ids[i, 8 - len(ex["prompt_ids"]):] = ex["prompt_ids"]
        mask[i, 8 - len(ex["prompt_ids"]):] = 1
    return ids, mask


def _sampling(module, **kw):
    return module.SamplingConfig(**dict(dict(
        max_new_tokens=4, temperature=1.0, top_p=1.0, top_k=0,
        eos_token_id=EOS, pad_token_id=PAD), **kw))


def _first_logits(monkeypatch, module):
    """Wrap ``module.sample_token`` to keep the logits of its first call:
    the port's eagerly; JAX's, inside its jitted engine, from the call
    site traced first (the prefill's) through ``jax.debug.callback``."""
    seen, traced = [], []
    sample = module.sample_token

    def run(*args, **kw):
        if module is jrollout:
            traced.append(None)
            if len(traced) == 1:
                jax.debug.callback(lambda x: seen.append(np.asarray(x)),
                                   args[1])
        elif not seen:
            seen.append(np.asarray(args[0]))
        return sample(*args, **kw)

    monkeypatch.setattr(module, "sample_token", run)
    return seen


@pytest.mark.parametrize("coef", [0.3, 0.5])
def test_the_mixture_first_step_matches_jax(models, monkeypatch, coef):
    """The mixed log-probs [B, V] the sampler is handed at the prefill's
    last position."""
    jb, tb, jparams, jref = models
    ids, mask = _prompt_batch()
    jseen = _first_logits(monkeypatch, jrollout)
    engine = jrollout.RolloutEngine(jb, _sampling(jrollout), max_len=12)
    jax.block_until_ready(engine.generate_mixture(
        jparams, jref, coef, {"input_ids": jnp.asarray(ids, jnp.int32),
                              "attention_mask": jnp.asarray(mask, jnp.int32)},
        jax.random.PRNGKey(0)))
    tseen = _first_logits(monkeypatch, trollout)
    tengine = trollout.RolloutEngine(tb, _sampling(trollout), max_len=12,
                                     device="cpu")
    out = tengine.generate_mixture(
        params_from_jax(jparams, device="cpu"),
        params_from_jax(jref, device="cpu"), coef,
        {"input_ids": torch.as_tensor(ids),
         "attention_mask": torch.as_tensor(mask)},
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tseen[0], jseen[0], rtol=1e-4, atol=1e-5)
    # log-probabilities of a distribution: logsumexp of the mixture <= 0
    assert np.all(np.log(np.exp(tseen[0]).sum(-1)) <= 1e-6)
    assert out["completion_ids"].shape == (2, 4)


def test_greedy_mixture_at_0_and_1_is_each_model_alone(models):
    jb, tb, jparams, jref = models
    ids, mask = _prompt_batch()
    batch = {"input_ids": torch.as_tensor(ids),
             "attention_mask": torch.as_tensor(mask)}
    engine = trollout.RolloutEngine(
        tb, _sampling(trollout, max_new_tokens=6, temperature=0.0),
        max_len=14, device="cpu")
    policy = params_from_jax(jparams, device="cpu")
    ref = params_from_jax(jref, device="cpu")
    for coef, alone in ((0.0, policy), (1.0, ref)):
        mixed = engine.generate_mixture(policy, ref, coef, batch)
        plain = engine.generate(alone, batch)
        assert torch.equal(mixed["completion_ids"], plain["completion_ids"])
    assert not torch.equal(engine.generate(policy, batch)["completion_ids"],
                           engine.generate(ref, batch)["completion_ids"])
    with pytest.raises(ValueError, match="group_size"):
        engine._generate(policy, batch, None, 2, None, (ref, 0.5))


# ---------------------------------------------------------------------------
# the trainers on the port's engine
# ---------------------------------------------------------------------------


class _Recorded:
    """Around an update step: keeps the batches it was given."""

    def __init__(self, step):
        self.step, self.batches = step, []

    def __call__(self, state, ref_params, batch):
        self.batches.append({k: np.asarray(v) for k, v in batch.items()})
        return self.step(state, ref_params, batch)


def _trainer(kind, tb, policy, ref, reward, seed=5):
    (_, _), (to, tsched) = optimizers()
    cfg = (trl.XPOConfig(alpha=0.01) if kind == "xpo"
           else trl.NashMDConfig(mixture_coef=0.5))
    cls = trl.XPOTrainer if kind == "xpo" else trl.NashMDTrainer
    trainer = cls(tb, Tok(), to, cfg, [reward],
                  create_train_state(params_from_jax(policy, device="cpu"),
                                     to),
                  params_from_jax(ref, device="cpu"), max_prompt_length=8,
                  max_completion_length=4,
                  sampling_overrides={"temperature": 1.0}, schedule=tsched,
                  device="cpu", seed=seed)
    trainer.update_step = _Recorded(trainer.update_step)
    return trainer


def _tie(completions, **kwargs):
    return [1.0] * len(completions)


@pytest.mark.parametrize("kind", ["xpo", "nash_md"])
def test_each_trainer_steps_on_its_own_engine(models, kind):
    """Two steps with a dense reward: finite metrics, two rollouts a step
    (the policy's and the reference's or the mixture's, each its own
    stream), the update rows (4 for XPO, 2 for Nash-MD) labeled on the
    completions; the decisions follow the scores."""
    jb, tb, jparams, jref = models
    trainer = _trainer(kind, tb, jparams, jref, vowel_reward)
    history = [trainer.step(EXAMPLES) for _ in range(2)]
    for m in history:
        assert all(np.isfinite(v) for v in m.values()), m
    assert trainer.state.step == 2 and trainer._rollouts == 4
    batch = trainer.update_step.batches[0]
    rows = 4 if kind == "xpo" else 2
    assert batch["input_ids"].shape == (rows, 8 + 4)
    assert (batch["labels"][:, :8] == -100).all()
    if kind == "xpo":
        assert batch["chosen_mask"].dtype == bool
        assert "objective/ref_scores" in history[0]
    else:
        assert set(batch["probability"]) <= {0.0, 0.5, 1.0}
        assert "objective/mixture_scores" in history[0]


@pytest.mark.parametrize("kind", ["xpo", "nash_md"])
def test_the_tie_rules(models, kind):
    """A reward that scores every completion alike: XPO's pairs all go to
    the policy (chosen_mask True), Nash-MD's probabilities are all 1/2."""
    jb, tb, jparams, jref = models
    trainer = _trainer(kind, tb, jparams, jref, _tie)
    trainer.step(EXAMPLES)
    batch = trainer.update_step.batches[0]
    if kind == "xpo":
        assert batch["chosen_mask"].tolist() == [True, True]
    else:
        assert batch["probability"].tolist() == [0.5, 0.5]
        # the score term vanishes at p = 1/2; the first step's KL is that
        # of a policy against another model's weights
        assert trainer.metrics_history[0]["objective/score"] == 0.0
