"""The port's PPO (train/ppo.py) against the JAX package on tiny text
Qwen2 and Qwen2-VL configs, on the CPU in f32 (FULL_PRECISION).

The host arithmetic (GAE, whitening, the KL controllers, the running
moments) must equal JAX's exactly; the experience pass and the update
step are held to JAX's on the same batch (metrics rtol 1e-4, parameters
after AdamW atol 1e-5); a whole ``PPOTrainer.step`` is held to JAX's on a
rollout the JAX engine drew and the port's trainer replays (sampled
tokens cannot agree across the packages); and the port's trainer runs on
its own engine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import ppo as jppo
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import ppo as tppo
from iadr1_tpu_torch.train.grpo import bundle_score_fn
from iadr1_tpu_torch.train.state import create_train_state
from test_torch_grpo import QWEN2, VLM, RecordingEngine, ReplayEngine, Tok
from test_torch_preference import (
    assert_metrics_close,
    assert_params_close,
    optimizers,
)
import torch_threads  # noqa: F401  (one intra-op thread)


# ---------------------------------------------------------------------------
# the host arithmetic, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9)])
def test_compute_gae_and_whitening_equal_jax(gamma, lam):
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(3, 7))
    values = rng.normal(size=(3, 7))
    mask = np.ones((3, 7))
    mask[1, 4:] = 0
    mask[2, 1:] = 0
    got = tppo.compute_gae(rewards, values, mask, gamma, lam)
    want = jppo.compute_gae(rewards, values, mask, gamma, lam)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for shift in (True, False):
        np.testing.assert_array_equal(
            tppo.masked_whiten(rewards, mask, shift),
            jppo.masked_whiten(rewards, mask, shift))


def test_kl_controllers_and_running_moments_equal_jax():
    ta = tppo.AdaptiveKLController(0.2, 6.0, 10000.0)
    ja = jppo.AdaptiveKLController(0.2, 6.0, 10000.0)
    tf, jf = tppo.FixedKLController(0.05), jppo.FixedKLController(0.05)
    trun, jrun = tppo.RunningMoments(), jppo.RunningMoments()
    rng = np.random.default_rng(1)
    for kl, n in ((0.3, 2), (9.0, 4), (6.2, 1), (-1.0, 3)):
        for t, j in ((ta, ja), (tf, jf)):
            t.update(kl, n)
            j.update(kl, n)
            assert t.value == j.value
        xs = rng.normal(size=n)
        assert trun.update(xs) == jrun.update(xs)
        assert (trun.mean, trun.std, trun.var, trun.count) == (
            jrun.mean, jrun.std, jrun.var, jrun.count)
    assert ta.value != 0.2 and tf.value == 0.05


# ---------------------------------------------------------------------------
# the experience pass and the update step
# ---------------------------------------------------------------------------


def _ppo_batch(seed=0, B=2, P=6, N=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (B, P + N))
    segs = np.ones((B, P + N), np.int64)
    segs[1, :2] = 0                       # a left-padded prompt
    comp_mask = np.ones((B, N), np.int64)
    comp_mask[0, 2:] = 0                  # an early EOS
    segs[:, P:] = comp_mask
    return {"input_ids": ids, "segment_ids": segs,
            "position_ids": np.clip(np.cumsum(segs, 1) - 1, 0, None),
            "completion_ids": ids[:, P:], "completion_mask": comp_mask,
            "prompt_len": P}


def _jbatch(batch):
    return {k: (v if k == "prompt_len" else jnp.asarray(v))
            for k, v in batch.items()}


def _setups(hf=QWEN2, seed=0):
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, attention="flash",
                               precision=FULL_PRECISION)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    return jb, tb, jparams


def test_experience_and_update_step_match_jax():
    """The experience pass (old logps, reference logps, values) against
    JAX's; then two update steps with advantages of both signs and
    returns off the values (the value clip engages): metrics, parameters
    (the value head's among them)."""
    jb, tb, jparams = _setups()
    cfg = dict(logp_chunk_size=4, cliprange_value=0.05)
    jtree = jppo.make_ppo_state_params(jparams, 64, jax.random.PRNGKey(2))
    jref = jax.tree.map(lambda x: x * 0.999, jparams)   # a reference apart
    tref = params_from_jax(jref, device="cpu")
    (jo, jsched), (to, tsched) = optimizers()
    jstate = jax_state(jax.tree.map(jnp.copy, jtree), jo)
    tstate = create_train_state(params_from_jax(jtree, device="cpu"), to)

    def jscore(p, batch, _aux):
        return jb.hidden_fn(p, batch, remat=False), jb.head_kernel_fn(p)

    batch = _ppo_batch()
    want = jppo.make_experience_fn(jscore, jppo.PPOConfig(**cfg))(
        jstate.params, jref, _jbatch(batch))
    got = tppo.make_experience_fn(bundle_score_fn(tb, remat=False),
                                  tppo.PPOConfig(**cfg))(
        tstate.params, tref, batch)
    mask = batch["completion_mask"].astype(bool)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask],
                                   atol=2e-5, rtol=0)
    assert float((got[0] - got[1]).abs().max()) > 1e-4

    old_logps, _, values = (np.asarray(w) for w in want)
    batch.update(old_logps=old_logps, old_values=values,
                 advantages=np.asarray([[1.0] * 4, [-1.0] * 4], np.float32),
                 returns=(values + 0.5).astype(np.float32))
    jstep = jppo.make_ppo_update_step(jscore, jo, jppo.PPOConfig(**cfg),
                                      jsched)
    tstep = tppo.make_ppo_update_step(bundle_score_fn(tb, remat=False), to,
                                      tppo.PPOConfig(**cfg), tsched)
    for i in (1, 2):
        jstate, jm = jstep(jstate, jref, _jbatch(batch))
        tstate, tm = tstep(tstate, tref, batch)
        assert_metrics_close(tm, jm, f"ppo update {i}")
        assert_params_close(tstate.params, jstate.params, msg=f"update {i}")
    # off-policy at step 2: the ratio leaves 1
    assert float(tm["approx_kl"]) > 0


# ---------------------------------------------------------------------------
# a whole trainer step
# ---------------------------------------------------------------------------


def _reward_fn(texts, examples):
    """Dense: each completion's vowels and length, per example."""
    return [sum(ch in "aeiou" for ch in t) / 4.0 + len(t) / 16.0
            for t in texts]


PPO_KW = dict(max_prompt_length=12, max_completion_length=4,
              mini_batch_size=2, ppo_epochs=2, temperature=1.0, top_k=0,
              top_p=1.0, logp_chunk_size=8, score_norm=True,
              whiten_rewards=True, remat=False)
EXAMPLES = [{"prompt_ids": [5, 6, 7, 8, 9, 10]}, {"prompt_ids": [11, 12, 13]},
            {"prompt_ids": [14, 15, 16, 17]}, {"prompt_ids": [18, 19]}]


@pytest.mark.parametrize("family", ["qwen2", "qwen2_vl"])
def test_trainer_step_matches_jax_on_a_recorded_rollout(family):
    """Collation (M-RoPE positions for Qwen2-VL), rewards with score
    normalization, KL shaping, whitening, GAE and 2 epochs x 2 minibatches
    of updates: every metric of the step, the KL coefficient after it and
    every parameter."""
    jb, tb, jparams = _setups(VLM if family == "qwen2_vl" else QWEN2, 1)
    jtree = jppo.make_ppo_state_params(jparams, 64, jax.random.PRNGKey(2))
    jref = jax.tree.map(lambda x: x * 0.999, jparams)
    (jo, jsched), (to, tsched) = optimizers()
    tok = Tok()
    jt = jppo.PPOTrainer(jb, tok, jo, jppo.PPOConfig(**PPO_KW), _reward_fn,
                         jax_state(jax.tree.map(jnp.copy, jtree), jo), jref,
                         schedule=jsched)
    jt.engine = RecordingEngine(jt.engine)
    jm = jt.step(EXAMPLES)

    tt = tppo.PPOTrainer(tb, tok, to, tppo.PPOConfig(**PPO_KW), _reward_fn,
                         create_train_state(params_from_jax(jtree,
                                                            device="cpu"), to),
                         params_from_jax(jref, device="cpu"),
                         schedule=tsched, device="cpu")
    tt.engine = ReplayEngine(jt.engine.out)
    tm = tt.step(EXAMPLES)
    assert tt.engine.calls == 1 and tt.state.step == 4
    assert tm["completion_length"] < 4
    assert_metrics_close(tm, jm, family)
    assert tt.kl_ctl.value == jt.kl_ctl.value
    assert_params_close(tt.state.params, jt.state.params, msg=family)
    assert tt.metrics_history == [tm]


def test_trainer_runs_on_its_own_engine():
    """Three steps on the port's engine: finite metrics, the state moved
    by ppo_epochs x minibatches a step, step 1 on-policy (kl 0 against a
    reference equal to the policy) and the adaptive coefficient moving."""
    tb = bundle_from_hf_config(QWEN2, attention="flash",
                               precision=FULL_PRECISION)
    params = tb.init_params(seed=0, device="cpu")
    ref = tb.init_params(seed=0, device="cpu")
    (_, _), (to, tsched) = optimizers()
    state = create_train_state(tppo.make_ppo_state_params(params, 64), to)
    trainer = tppo.PPOTrainer(
        tb, Tok(), to, tppo.PPOConfig(**dict(PPO_KW, whiten_rewards=False)),
        _reward_fn, state, ref, schedule=tsched, device="cpu", seed=3)
    history = [trainer.step(EXAMPLES) for _ in range(3)]
    for m in history:
        assert all(np.isfinite(v) for v in m.values()), m
    assert trainer.state.step == 3 * 2 * 2
    assert abs(history[0]["kl"]) < 1e-5
    assert history[-1]["kl_coef"] != 0.2
    assert trainer.state.params["vhead"]["kernel"].shape == (64, 1)
    head = tppo.make_ppo_state_params(params, 64)["vhead"]
    assert head["kernel"].device == torch.device("cpu")
