"""The port's RLOO and online DPO (train/online_rl.py) against the JAX
package on tiny text Qwen2 and Qwen2-VL configs, on the CPU in f32
(FULL_PRECISION).

The advantages must equal JAX's exactly.  Whole trainer steps are held to
JAX's on a rollout the JAX engine drew (``RecordingEngine``, which ends
two rows early) and the port's trainer replays: the online DPO pairing,
its update batch (exactly), the step's metrics (rtol 1e-4) and the
parameters after it (atol 1e-5).  Each trainer then runs on the port's
own engine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import grpo as jgrpo
from iadr1_tpu.train import online_rl as jrl
from iadr1_tpu.train import preference as jpref
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import grpo as tgrpo
from iadr1_tpu_torch.train import online_rl as trl
from iadr1_tpu_torch.train import preference as tpref
from iadr1_tpu_torch.train.state import create_train_state
from test_torch_grpo import (
    QWEN2,
    VLM,
    RecordingEngine,
    ReplayEngine,
    Tok,
    solution_reward,
    vowel_reward,
)
from test_torch_preference import (
    assert_metrics_close,
    assert_params_close,
    optimizers,
)

EXAMPLES = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "solution": "a"},
            {"prompt_ids": [11, 12, 13], "solution": "b"}]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_rloo_advantages_equal_jax(k, normalize):
    rng = np.random.default_rng(k)
    rewards = rng.random(3 * k) * 2
    rewards[:k] = 0.5                      # a group of equal rewards
    got = trl.rloo_advantages(rewards, k, normalize)
    want = jrl.rloo_advantages(rewards, k, normalize)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if not normalize:
        assert np.all(got[:k] == 0)
    with pytest.raises(ValueError, match="at least 2"):
        trl.rloo_advantages(rewards, 1)


def test_online_dpo_order_picks_the_higher_score_ties_to_the_first():
    scores = np.asarray([1.0, 0.0, 0.0, 1.0, 0.5, 0.5])
    np.testing.assert_array_equal(trl.online_dpo_order(scores),
                                  [0, 3, 4, 1, 2, 5])


def _bundles(hf, seed=1):
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, attention="flash",
                               precision=FULL_PRECISION)
    return jb, tb, jb.init_params(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
@pytest.mark.parametrize("family", ["qwen2", "qwen2_vl"])
def test_rloo_step_matches_jax_on_a_recorded_rollout(family, shared):
    """The RLOO trainer (the GRPO trainer with the leave-one-out hook) on
    the same completions: every metric and every parameter after the
    step, through the shared-prompt and the dense update.  Text prompts
    on an M-RoPE model make the JAX dense update raise (ROADMAP C.R24):
    there the port's dense update is held to JAX's shared one."""
    G, P, N = 4, 12, 4
    jb, tb, jparams = _bundles(VLM if family == "qwen2_vl" else QWEN2)
    kw = dict(num_generations=G, beta=0.04, temperature=1.0, top_k=0,
              top_p=1.0, max_prompt_length=P, max_completion_length=N,
              logp_chunk_size=8, shared_prompt_scoring=shared, remat=False)
    rewards = [vowel_reward, solution_reward]
    (jo, jsched), (to, tsched) = optimizers()

    def jax_trainer(**over):
        return jrl.RLOOTrainer(
            jb, Tok(), jo, jgrpo.GRPOConfig(**dict(kw, **over)), rewards,
            jax_state(jax.tree.map(jnp.copy, jparams), jo),
            jax.tree.map(jnp.copy, jparams), schedule=jsched,
            normalize_advantages=True)

    jt = jax_trainer()
    jt.engine = _Recording(jt.engine)
    if family == "qwen2_vl" and not shared:
        with pytest.raises(ValueError, match="broadcast"):
            jt.step(EXAMPLES)
        recorded = jt.engine
        jt = jax_trainer(shared_prompt_scoring=True)
        jt.engine = recorded.replay()
    jm = jt.step(EXAMPLES)
    tt = trl.RLOOTrainer(tb, Tok(), to, tgrpo.GRPOConfig(**kw), rewards,
                         create_train_state(params_from_jax(
                             jparams, device="cpu"), to),
                         params_from_jax(jparams, device="cpu"),
                         schedule=tsched, device="cpu",
                         normalize_advantages=True)
    assert tt._shared == shared
    tt.engine = ReplayEngine(jt.engine.out)
    tm = tt.step(EXAMPLES)
    assert tt.engine.calls == 1 and tt.state.step == 1
    assert_metrics_close(tm, jm, family, extra=())
    assert_params_close(tt.state.params, jt.state.params, msg=family)


class _Recording(RecordingEngine):
    """RecordingEngine that can hand its rollout to another JAX trainer."""

    def replay(self):
        engine = _Recording(None)
        engine.out = self.out
        engine.generate = lambda *args, **kw: {
            k: jnp.asarray(v) for k, v in self.out.items()}
        return engine


class _Recorded:
    """Around an update step: keeps the batch it was given."""

    def __init__(self, step):
        self.step, self.batch = step, None

    def __call__(self, state, ref_params, batch):
        self.batch = {k: np.asarray(v) for k, v in batch.items()}
        return self.step(state, ref_params, batch)


@pytest.mark.parametrize("loss_type", ["sigmoid", "simpo"])
@pytest.mark.parametrize("family", ["qwen2", "qwen2_vl"])
def test_online_dpo_step_matches_jax_on_a_recorded_rollout(family, loss_type):
    """Online DPO on the same 2 x 2 completions (two of them ended early,
    so one pair has a clear winner and the missing-EOS penalty bites on
    the rest): the chosen-first ordering and the update batch exactly
    (M-RoPE positions broadcast to [3, 2B, T] for Qwen2-VL), the metrics
    and the parameters."""
    jb, tb, jparams = _bundles(VLM if family == "qwen2_vl" else QWEN2)
    kw = dict(max_prompt_length=12, max_completion_length=4,
              sampling_overrides={"temperature": 1.0},
              missing_eos_penalty=0.25)
    (jo, jsched), (to, tsched) = optimizers()
    dpo = dict(beta=0.1, loss_type=loss_type, logp_chunk_size=8)
    use_ref = tpref.DPOConfig(**dpo).use_ref_model
    jt = jrl.OnlineDPOTrainer(
        jb, Tok(), jo, jpref.DPOConfig(**dpo), [vowel_reward],
        jax_state(jax.tree.map(jnp.copy, jparams), jo),
        jax.tree.map(jnp.copy, jparams) if use_ref else {}, schedule=jsched,
        **kw)
    jt.engine = RecordingEngine(jt.engine)
    jt.update_step = _Recorded(jt.update_step)
    jm = jt.step(EXAMPLES)
    tt = trl.OnlineDPOTrainer(
        tb, Tok(), to, tpref.DPOConfig(**dpo), [vowel_reward],
        create_train_state(params_from_jax(jparams, device="cpu"), to),
        params_from_jax(jparams, device="cpu") if use_ref else {},
        schedule=tsched, device="cpu", **kw)
    tt.engine = ReplayEngine(jt.engine.out)
    tt.update_step = _Recorded(tt.update_step)
    tm = tt.step(EXAMPLES)

    got, want = tt.update_step.batch, jt.update_step.batch
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    T = 12 + 4
    assert got["position_ids"].shape == ((3, 4, T) if family == "qwen2_vl"
                                         else (4, T))
    assert_metrics_close(tm, jm, family)
    assert_params_close(tt.state.params, jt.state.params, msg=family)


def test_each_trainer_steps_on_its_own_engine():
    """Two steps each of RLOO and online DPO on the port's engine:
    finite metrics, step 1 on-policy (kl and the implicit rewards 0
    against a reference equal to the policy), the rollout stream
    advancing."""
    tb = bundle_from_hf_config(QWEN2, attention="flash",
                               precision=FULL_PRECISION)
    (_, _), (to, tsched) = optimizers()

    def fresh():
        return (create_train_state(tb.init_params(seed=0, device="cpu"), to),
                tb.init_params(seed=0, device="cpu"))

    rloo = trl.RLOOTrainer(
        tb, Tok(), to, tgrpo.GRPOConfig(
            num_generations=2, max_prompt_length=8, max_completion_length=4,
            temperature=1.0, top_k=0, top_p=1.0), [vowel_reward], *fresh(),
        schedule=tsched, device="cpu", seed=5)
    dpo = trl.OnlineDPOTrainer(
        tb, Tok(), to, tpref.DPOConfig(), [vowel_reward], *fresh(),
        max_prompt_length=8, max_completion_length=4, schedule=tsched,
        device="cpu", seed=5)
    for trainer, zero in ((rloo, "kl"), (dpo, "rewards/chosen")):
        history = [trainer.step(EXAMPLES) for _ in range(2)]
        for m in history:
            assert all(np.isfinite(v) for v in m.values()), m
        assert abs(history[0][zero]) < 1e-5
        assert trainer.state.step == 2 and trainer._rollouts == 2
