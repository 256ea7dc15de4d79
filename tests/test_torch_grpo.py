"""The port's SC-GRPO (train/grpo.py, cli/train_grpo.py) against the JAX
package on tiny text-Qwen2 and Qwen2-VL configs, on the CPU in f32
(FULL_PRECISION), and the port's own trainer with its own engine in the
loop.

Parameters come from JAX's ``init_params`` through ``params_from_jax``;
batches come from a seed through numpy.  The JAX side runs
``attention="xla"``: its flash VJP drops the lse cotangent, which the
shared-prompt update needs, so only its dense attention gives reference
gradients.  Sampled tokens cannot agree across the packages (different
generators), so the whole-step comparison records the JAX engine's rollout
and hands the port's trainer an engine that returns the same arrays.

Tolerances: metrics rtol 1e-4; parameters after AdamW steps at lr 1e-3
atol 1e-5 (the two differ in summation order only).  Positions after a
rollout's EOS are compared nowhere: there the JAX dense oracle attends
uniformly and the port's flash twin returns zeros, and the loss masks
them.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.cli.train_grpo import GRPODataSection as JaxDataSection
from iadr1_tpu.cli.train_grpo import make_vlm_prompt_collator as jax_collator
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import grpo as jgrpo
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.cli.train_grpo import (
    GRPODataSection,
    GRPOJobConfig,
    make_vlm_prompt_collator,
)
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import grpo as tgrpo
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.rollout import (
    RolloutEngine,
    SamplingConfig,
    cast_dense_params,
)
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

TEXT = dict(vocab_size=600, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, tie_word_embeddings=True)
QWEN2 = dict(TEXT, architectures=["Qwen2ForCausalLM"])
VLM = dict(
    architectures=["Qwen2VLForConditionalGeneration"],
    text_config=dict(TEXT, rope_scaling={"type": "mrope",
                                         "mrope_section": [4, 6, 6]}),
    vision_config=dict(depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, video_token_id=8,
    vision_start_token_id=5, vision_end_token_id=6,
)
# Adam's eps is 1e-4 here: with the default 1e-8 an element whose gradient
# is nearly zero (a k bias: softmax ignores a shift shared by every key)
# takes a step of the full learning rate in the direction of its f32
# summation noise, and the parameter comparison would measure that noise
OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
           max_grad_norm=1.0, eps=1e-4)
EOS, PAD = 3, 2


class Tok:
    """The three attributes the trainer needs; ids decode to letters."""
    eos_token_id, pad_token_id = EOS, PAD

    def batch_decode(self, seqs, skip_special_tokens=True):
        return ["".join(chr(97 + int(t) % 26) for t in s
                        if int(t) not in (EOS, PAD)) for s in seqs]


def vowel_reward(completions, **kwargs):
    """Dense: nearly every completion scores differently."""
    return [sum(ch in "aeiou" for ch in c[0]["content"]) / 4.0
            + len(c[0]["content"]) / 16.0 for c in completions]


def solution_reward(completions, solution, **kwargs):
    """Reads the ``solution`` column (repeated G times per example)."""
    return [float(c[0]["content"][:1] == s) for c, s in
            zip(completions, solution)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_params_close(tparams, jparams, atol, msg):
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[name]),
                                   atol=atol, rtol=0, err_msg=f"{msg} {name}")


def _assert_metrics_close(tm, jm, msg):
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{msg} {key}")


# ---------------------------------------------------------------------------
# advantages and the update step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [True, False])
def test_group_advantages_match_jax(scale):
    rng = np.random.default_rng(0)
    rewards = rng.random(12) * 3
    rewards[4:8] = 1.5                    # a group of equal rewards
    got = tgrpo.group_advantages(rewards, 4, scale)
    want = jgrpo.group_advantages(rewards, 4, scale)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.all(got[4:8] == 0)


def _dense_update_batch(seed=0, B=4, P=8, N=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (B, P + N))
    segs = np.ones((B, P + N), np.int64)
    segs[1, :3] = 0                       # left padding
    comp_mask = np.ones((B, N), np.int64)
    comp_mask[0, 2:] = 0                  # ragged: the reductions differ
    segs[:, P:] = comp_mask
    return {
        "input_ids": ids, "segment_ids": segs,
        "position_ids": np.clip(np.cumsum(segs, 1) - 1, 0, None),
        "completion_ids": ids[:, P:], "completion_mask": comp_mask,
        "advantages": np.asarray([1.0, -1.0, 0.5, -0.5], np.float32),
        "prompt_len": P,
    }


@functools.lru_cache(maxsize=None)
def _text_setup():
    jb = jax_bundle(QWEN2, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(QWEN2, attention="flash",
                               precision=FULL_PRECISION)
    return jb, tb, jb.init_params(jax.random.PRNGKey(0))


def _jbatch(batch):
    return {k: (v if k == "prompt_len" else jnp.asarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("off_policy", [False, True],
                         ids=["on_policy", "old_logps"])
@pytest.mark.parametrize("loss_type", ["grpo", "bnpo", "dr_grpo"])
def test_update_step_matches_jax(loss_type, off_policy):
    """make_grpo_update_step against the JAX step (dense attention) on one
    update batch, beta 0.04: loss, kl, clip_ratio, grad_norm, learning
    rate and completion length of steps 1-3, parameters after 1 and 3."""
    jb, tb, jparams = _text_setup()
    kw = dict(num_generations=2, beta=0.04, loss_type=loss_type,
              max_completion_length=4, logp_chunk_size=8, epsilon=0.2)
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstep = jgrpo.make_grpo_update_step(
        jgrpo.bundle_score_fn(jb, remat=False), jo, jgrpo.GRPOConfig(**kw),
        jsched)
    jstate = jax_state(jax.tree.map(jnp.copy, jparams), jo)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstep = tgrpo.make_grpo_update_step(
        tgrpo.bundle_score_fn(tb, remat=False), to, tgrpo.GRPOConfig(**kw),
        tsched)
    tstate = create_train_state(params_from_jax(jparams, device="cpu"), to)
    tref = params_from_jax(jparams, device="cpu")
    batch = _dense_update_batch()
    if off_policy:
        # generation-time logps some way off the current ones, so that the
        # ratio leaves [1 - eps, 1 + eps] on part of the tokens
        base = np.asarray(jgrpo.make_grpo_logps_eval(
            jgrpo.bundle_score_fn(jb, remat=False), jgrpo.GRPOConfig(**kw))(
                jparams, jparams, _jbatch(batch)))
        got = tgrpo.make_grpo_logps_eval(
            tgrpo.bundle_score_fn(tb, remat=False), tgrpo.GRPOConfig(**kw))(
                tref, batch)
        m = batch["completion_mask"].astype(bool)
        np.testing.assert_allclose(got.numpy()[m], base[m], atol=2e-5, rtol=0)
        noise = np.random.default_rng(1).standard_normal(base.shape)
        batch["old_logps"] = (base + 0.3 * noise).astype(np.float32)
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jparams, _jbatch(batch))
        tstate, tm = tstep(tstate, tref, batch)
        _assert_metrics_close(tm, jm, f"step {step}")
        if step == 1:
            assert (float(tm["clip_ratio"]) > 0) == off_policy
            assert abs(float(tm["kl"])) < 1e-6
        if step in (1, 3):
            _assert_params_close(tstate.params, jstate.params, 1e-5,
                                 f"step {step}")
    assert tstate.step == 3 and float(tm["kl"]) > 0


def test_update_step_rejects_an_unknown_loss_type():
    _, tb, _ = _text_setup()
    with pytest.raises(ValueError, match="unknown loss_type"):
        tgrpo.make_grpo_update_step(
            tgrpo.bundle_score_fn(tb), None, tgrpo.GRPOConfig(loss_type="x"))


def test_chunked_token_logps_equal_full_logits():
    """An uneven last chunk, against log_softmax of the full product
    (f32, atol 1e-5)."""
    rng = np.random.default_rng(2)
    hidden = torch.from_numpy(rng.standard_normal((3, 7, 16), np.float32))
    kernel = torch.from_numpy(rng.standard_normal((16, 50), np.float32))
    targets = torch.from_numpy(rng.integers(0, 50, (3, 7)))
    want = torch.log_softmax(hidden @ kernel, -1).gather(
        -1, targets[..., None])[..., 0]
    for chunk in (4, 21, 64):
        got = tgrpo.chunked_token_logps(hidden, kernel, targets, chunk)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# a whole trainer step on a recorded rollout
# ---------------------------------------------------------------------------


class RecordingEngine:
    """Around the JAX engine: keeps what ``generate`` returned, after
    cutting two rollouts short (an EOS, then padding), so that the update
    has rows that end early."""

    def __init__(self, engine):
        self.engine, self.out = engine, None

    def generate(self, *args, **kw):
        out = {k: np.array(v) for k, v in
               self.engine.generate(*args, **kw).items()}
        ids, mask = out["completion_ids"], out["completion_mask"]
        for row, stop in ((1, 1), (2, 0)):
            ids[row, stop], ids[row, stop + 1:] = EOS, PAD
            mask[row, :stop + 1], mask[row, stop + 1:] = 1, 0
        self.out = out
        return out


class ReplayEngine:
    """The port trainer's engine, replaced: returns a recorded rollout."""

    def __init__(self, recorded):
        self.recorded, self.calls = recorded, 0

    def generate(self, params, batch, generator=None, group_size=1):
        self.calls += 1
        assert isinstance(generator, torch.Generator)
        # the rollout reads the policy in the compute dtype, detached
        assert not any(p.requires_grad for p in tree_leaves(params))
        return {k: torch.as_tensor(v) for k, v in self.recorded.items()}


def _vlm_examples(seed=0):
    rng = np.random.default_rng(seed)
    examples = []
    for i in range(2):
        examples.append({
            "prompt_ids": ([1, 5] + [7] * 4 + [6]
                           + rng.integers(10, 500, 6 + 3 * i).tolist()),
            "patches": [rng.standard_normal((16, 3 * 2 * 14 * 14))
                        .astype(np.float32)],
            "grid_thw": [(1, 4, 4)],
            "solution": "ab"[i],
        })
    return examples


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
@pytest.mark.parametrize("family", ["qwen2", "qwen2_vl"])
def test_trainer_step_matches_jax_on_a_recorded_rollout(family, shared):
    """Collation, rewards, advantages, the update batch (factored and
    dense) and the update: every metric of the step and every parameter
    after it.  The VLM prompts go through both packages'
    ``make_vlm_prompt_collator``; with shared scoring both collate once at
    G = 1, where patch_budget // G holds the two images exactly."""
    G, P, N = 2, 24, 4
    hf = VLM if family == "qwen2_vl" else QWEN2
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, attention="flash", precision=FULL_PRECISION)
    jparams = jb.init_params(jax.random.PRNGKey(1))
    kw = dict(num_generations=G, beta=0.04, temperature=1.0, top_k=0,
              top_p=1.0, max_prompt_length=P, max_completion_length=N,
              logp_chunk_size=8, shared_prompt_scoring=shared, remat=False)
    rewards = [vowel_reward, solution_reward]
    tok = Tok()
    if family == "qwen2_vl":
        examples = _vlm_examples()
        data = dict(patch_budget=32 * G)
        jcollate = jax_collator(jb, tok, None, JaxDataSection(**data), P, G)
        tcollate = make_vlm_prompt_collator(tb, tok, None,
                                            GRPODataSection(**data), P, G)
    else:
        examples = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "solution": "a"},
                    {"prompt_ids": [11, 12, 13], "solution": "b"}]
        jcollate = tcollate = None

    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jt = jgrpo.GRPOTrainer(
        jb, tok, jo, jgrpo.GRPOConfig(**kw), rewards,
        jax_state(jax.tree.map(jnp.copy, jparams), jo),
        jax.tree.map(jnp.copy, jparams), schedule=jsched,
        prompt_collator=jcollate)
    jt.engine = RecordingEngine(jt.engine)
    jm = jt.step(examples)

    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tt = tgrpo.GRPOTrainer(
        tb, tok, to, tgrpo.GRPOConfig(**kw), rewards,
        create_train_state(params_from_jax(jparams, device="cpu"), to),
        params_from_jax(jparams, device="cpu"), schedule=tsched,
        prompt_collator=tcollate, device="cpu")
    assert tt._shared == jt._shared == shared
    tt.engine = ReplayEngine(jt.engine.out)
    tm = tt.step(examples)

    assert tt.engine.calls == 1 and tt.state.step == 1
    assert tm["reward_std"] > 0 and tm["completion_length"] < N
    _assert_metrics_close(tm, jm, family)
    assert all(np.isfinite(v) for v in tm.values())
    _assert_params_close(tt.state.params, jt.state.params, 1e-5, family)
    assert tt.metrics_history == [tm]


def test_vlm_collator_matches_jax_and_scales_the_patch_budget():
    """Both collations (G = 1 for the rollout, G for the dense update)
    equal the JAX collator's arrays; the G = 1 patch stream is
    patch_budget // num_generations long; video frame stacks (which
    Qwen2-VL takes through its patch stream) and prompts that would be cut
    through their image tokens are refused."""
    G, P = 2, 24
    jb = jax_bundle(VLM, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(VLM, precision=FULL_PRECISION)
    tok, examples = Tok(), _vlm_examples()
    jcollate = jax_collator(jb, tok, None, JaxDataSection(patch_budget=64),
                            P, G)
    tcollate = make_vlm_prompt_collator(
        tb, tok, None, GRPODataSection(patch_budget=64), P, G)
    for g, n_patches in ((1, 32), (G, 64)):
        got, want = tcollate(examples, g), jcollate(examples, g)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
        assert got["patches"].shape[0] == n_patches
        assert got["input_ids"].shape == (2 * g, P)
    with pytest.raises(ValueError, match="grid_thw"):
        tcollate([dict(examples[0], video_patches=[np.zeros((4, 4))])], 1)
    long = dict(examples[0], prompt_ids=examples[0]["prompt_ids"] + [9] * P)
    with pytest.raises(ValueError, match="max_prompt_length"):
        tcollate([long], 1)
    assert GRPOJobConfig().grpo.reward_funcs == ["accuracy", "format"]


# ---------------------------------------------------------------------------
# the port's own engine in the loop
# ---------------------------------------------------------------------------


def _trainer(cfg, rewards, seed=0, lr=1e-3, hf=QWEN2, state=None, **kw):
    bundle = bundle_from_hf_config(hf, attention="flash",
                                   precision=FULL_PRECISION)
    opt, sched = topt.make_optimizer(topt.OptimizerConfig(
        learning_rate=lr, total_steps=100, warmup_ratio=0.0,
        schedule="constant", max_grad_norm=1.0))
    params = bundle.init_params(seed=seed, device="cpu")
    ref = copy.deepcopy(params)
    if state is None:
        state = create_train_state(params, opt)
    return tgrpo.GRPOTrainer(bundle, Tok(), opt, cfg, rewards, state, ref,
                             schedule=sched, device="cpu", **kw)


SAMPLE_ALL = dict(temperature=1.0, top_k=0, top_p=1.0)
EXAMPLES = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "solution": ""},
            {"prompt_ids": [5, 6, 7, 8], "solution": ""},
            {"prompt_ids": [5, 6, 7, 8, 9], "solution": ""},
            {"prompt_ids": [6, 7, 8, 9, 10], "solution": ""}]


def test_trainer_learns_a_dense_reward():
    """24 steps on a reward every completion scores differently: the mean
    reward of the last 6 steps is above that of the first 6."""
    cfg = tgrpo.GRPOConfig(num_generations=4, beta=0.0, max_prompt_length=8,
                           max_completion_length=4, **SAMPLE_ALL)
    trainer = _trainer(cfg, [vowel_reward], seed=3, lr=2e-2)
    assert trainer._shared
    metrics = [trainer.step(EXAMPLES) for _ in range(24)]
    rewards = [m["reward"] for m in metrics]
    assert np.isfinite(rewards).all()
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert "rewards/vowel_reward" in metrics[0]
    assert np.mean(rewards[-6:]) > np.mean(rewards[:6]), rewards


def test_truncation_metric_and_warning():
    cfg = tgrpo.GRPOConfig(num_generations=2, max_prompt_length=8,
                           max_completion_length=4, logp_chunk_size=8)

    def zero_reward(completions, **kwargs):
        return [0.0] * len(completions)

    trainer = _trainer(cfg, [zero_reward])
    with pytest.warns(UserWarning, match="truncated"):
        m = trainer.step(EXAMPLES[:2])
    assert m["completion_truncated_frac"] > 0.5


def test_sync_ref_model_mixes_the_policy_into_the_reference():
    cfg = tgrpo.GRPOConfig(num_generations=2, max_prompt_length=8,
                           max_completion_length=2, sync_ref_model=True,
                           ref_model_sync_steps=2, ref_model_mixup_alpha=0.6,
                           logp_chunk_size=8)
    trainer = _trainer(cfg, [vowel_reward], lr=5e-3)
    before = [r.clone() for r in tree_leaves(trainer.ref_params)]
    assert trainer.step(EXAMPLES[:1])["ref_synced"] == 0.0
    for r, b in zip(tree_leaves(trainer.ref_params), before):
        assert torch.equal(r, b)
    with torch.no_grad():
        for p in tree_leaves(trainer.state.params):
            p.add_(0.01)                 # the policy visibly leaves the ref
    assert trainer.step(EXAMPLES[:1])["ref_synced"] == 1.0
    for r, b, p in zip(tree_leaves(trainer.ref_params), before,
                       tree_leaves(trainer.state.params)):
        torch.testing.assert_close(r, 0.4 * b + 0.6 * p.detach(), atol=1e-6,
                                   rtol=0)
        assert not r.requires_grad


def test_image_prompt_truncation_guard():
    cfg = tgrpo.GRPOConfig(num_generations=2, max_prompt_length=4,
                           max_completion_length=2)
    trainer = _trainer(cfg, [], hf=VLM)
    with pytest.raises(ValueError, match="image"):
        trainer._collate_prompts([{"prompt_ids": [1, 7, 7, 3, 4, 5]}])
    batch = trainer._collate_prompts([{"prompt_ids": [1, 2, 3, 4, 5, 6]},
                                      {"prompt_ids": [9]}])
    np.testing.assert_array_equal(batch["input_ids"],
                                  [[3, 4, 5, 6], [PAD, PAD, PAD, 9]])
    # text prompts on an M-RoPE model: the three axes share one stream
    assert batch["position_ids"].shape == (3, 2, 4)
    np.testing.assert_array_equal(batch["mrope_deltas"], [0, -3])


def test_mu_iterations_take_two_updates_per_rollout():
    cfg = tgrpo.GRPOConfig(num_generations=2, beta=0.02, max_prompt_length=8,
                           max_completion_length=4, num_iterations=2,
                           **SAMPLE_ALL)
    trainer = _trainer(cfg, [vowel_reward], lr=5e-3)
    m1 = trainer.step(EXAMPLES[:2])
    m2 = trainer.step(EXAMPLES[:2])
    assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])
    assert trainer.state.step == 4 and "clip_ratio" in m1


def test_lora_mode_names_its_roadmap_item():
    """Named for the refusal it checked until ROADMAP A.12 was ported.
    LoRA mode is ported (tests/test_torch_adapters.py holds it to JAX);
    a base without a LoRA TuningConfig is refused, as
    the JAX trainer refuses it."""
    cfg = tgrpo.GRPOConfig(max_prompt_length=8, max_completion_length=2)
    with pytest.raises(ValueError, match="LoRA TuningConfig"):
        _trainer(cfg, [], base_params={})


def test_a_resumed_run_draws_what_an_uninterrupted_run_would():
    """The generator of trainer step k depends on (seed, k) alone: a
    trainer rebuilt from the state after step 2 and fast-forwarded by 2
    takes step 3 exactly as the uninterrupted one (equal metrics and
    parameters); another seed draws other tokens."""
    cfg = tgrpo.GRPOConfig(num_generations=2, beta=0.04, max_prompt_length=8,
                           max_completion_length=4, **SAMPLE_ALL)
    run = _trainer(cfg, [vowel_reward], seed=1)
    for _ in range(2):
        run.step(EXAMPLES[:2])
    saved, ref = copy.deepcopy(run.state), copy.deepcopy(run.ref_params)
    want = run.step(EXAMPLES[:2])

    resumed = _trainer(cfg, [vowel_reward], seed=1, state=saved)
    resumed.ref_params = ref
    resumed.fast_forward_rng(2)
    got = resumed.step(EXAMPLES[:2])
    assert got == want
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(run.state.params)):
        assert torch.equal(a, b)

    draws = []
    for seed in (0, 0, 1):
        t = _trainer(cfg, [vowel_reward])
        t.seed = seed
        t.fast_forward_rng(2)
        draws.append(torch.rand(8, generator=t._next_generator()))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_rollout_policy_copy_casts_only_the_dense_layers():
    """cast_dense_params: kernels and biases of dense layers in the
    compute dtype, norms and the embedding (the tied LM head reads it in
    the logits dtype) as stored; detached; the engine (bf16 compute) draws
    the same tokens from the copy as from the f32 parameters."""
    bundle = bundle_from_hf_config(VLM, precision=FULL_PRECISION)
    params = bundle.init_params(seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    cast = cast_dense_params(params, torch.bfloat16)
    flat = dict(_leaves(cast))
    assert not any(t.requires_grad for t in flat.values())
    for name, t in flat.items():
        layer = name.rsplit("/", 1)[0]
        dense = f"{layer}/kernel" in flat          # a norm has no kernel
        assert t.dtype == (torch.bfloat16 if dense else torch.float32), name
    assert flat["/vision/blocks/norm1/bias"].dtype == torch.float32
    assert flat["/text/embed/weight"].dtype == torch.float32
    assert flat["/text/layers/attn/q/kernel"].dtype == torch.bfloat16
    untied = bundle_from_hf_config(dict(QWEN2, tie_word_embeddings=False))
    cast = cast_dense_params(untied.init_params(seed=0, device="cpu"),
                             torch.bfloat16)
    assert cast["lm_head"]["kernel"].dtype == torch.float32

    bundle = bundle_from_hf_config(QWEN2)               # bf16 compute
    params = bundle.init_params(seed=0, device="cpu")
    engine = RolloutEngine(bundle, SamplingConfig(
        max_new_tokens=6, eos_token_id=EOS, pad_token_id=PAD), max_len=16,
        device="cpu")
    batch = {"input_ids": torch.tensor([[PAD, 5, 6, 7], [8, 9, 10, 11]]),
             "attention_mask": torch.tensor([[0, 1, 1, 1], [1, 1, 1, 1]])}
    outs = [engine.generate(p, batch, torch.Generator().manual_seed(4),
                            group_size=2)
            for p in (params, cast_dense_params(params, torch.bfloat16))]
    assert torch.equal(outs[0]["completion_ids"], outs[1]["completion_ids"])
    assert outs[0]["completion_ids"].shape == (4, 6)
