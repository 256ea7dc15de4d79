"""The port's preference stages (train/preference.py, the pairwise
encoding of data/tokenize.py) against the JAX package on a tiny text
Qwen2, on the CPU in f32 (FULL_PRECISION).

Parameters come from JAX's ``init_params`` through ``params_from_jax``;
batches from a seed through numpy.  JAX runs ``attention="xla"``, the
port its plain path.  Tolerances as in tests/test_torch_grpo.py: metrics
rtol 1e-4; parameters after AdamW at lr 1e-3 atol 1e-5.  The port's
steps report ``grad_norm`` besides the JAX step's metrics.

ROADMAP C.R22 is pinned here on both sides: where the cutoff binds, the
JAX package's two rows of a pair keep prompts of different lengths, the
port's one prompt.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_qwen_tokenizer
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.data.template import get_template as jax_template
from iadr1_tpu.data.tokenize import (
    encode_pairwise_example as jax_encode_pairwise,
)
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train import preference as jpref
from iadr1_tpu.train.grpo import bundle_score_fn as jax_score_fn
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.data.template import get_template
from iadr1_tpu_torch.data.tokenize import (
    IGNORE_INDEX,
    encode_pairwise_example,
    infer_seqlen,
)
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train import preference as tpref
from iadr1_tpu_torch.train.grpo import bundle_score_fn
from iadr1_tpu_torch.train.state import create_train_state
import torch_threads  # noqa: F401  (one intra-op thread)

QWEN2 = dict(vocab_size=600, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=10000.0,
             tie_word_embeddings=True, architectures=["Qwen2ForCausalLM"])
# Adam's eps 1e-4: see tests/test_torch_grpo.py (an element whose gradient
# is nearly 0 would step by the full lr in the direction of f32 noise)
OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0,
           max_grad_norm=1.0, eps=1e-4)
LOSS_TYPES = ["sigmoid", "hinge", "ipo", "orpo", "simpo", "cpo"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_params_close(tparams, jparams, atol=1e-5, msg=""):
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[name]),
                                   atol=atol, rtol=0, err_msg=f"{msg} {name}")


def assert_metrics_close(tm, jm, msg="", extra=("grad_norm",)):
    """Every JAX metric within rtol 1e-4; the port adds ``extra``."""
    assert set(tm) == set(jm) | set(extra), (sorted(tm), sorted(jm))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{msg} {key}")


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX bundle, port bundle, JAX parameters) on the tiny Qwen2."""
    jb = jax_bundle(QWEN2, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(QWEN2, attention="flash",
                               precision=FULL_PRECISION)
    return jb, tb, jb.init_params(jax.random.PRNGKey(0))


def optimizers():
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    return (jo, jsched), (to, tsched)


def states(jparams, jo, to, jax_tree=None):
    """A JAX state and a port state from the same parameters (``jax_tree``
    wraps them, e.g. with a head)."""
    tree = jparams if jax_tree is None else jax_tree
    return (jax_state(jax.tree.map(jnp.copy, tree), jo),
            create_train_state(params_from_jax(tree, device="cpu"), to))


def rows_batch(n_rows, T=16, seed=0, prefix=""):
    """Right-padded rows of ragged length: a masked prompt, a labeled
    response, padding (segment 0) after it; 1-D positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 500, (n_rows, T))
    labels = ids.copy()
    segs = np.ones((n_rows, T), np.int64)
    for i in range(n_rows):
        prompt, length = 3 + i % 3, T - (i * 3) % 7
        labels[i, :prompt] = IGNORE_INDEX
        labels[i, length:] = IGNORE_INDEX
        segs[i, length:] = 0
        ids[i, length:] = 0
    pos = np.broadcast_to(np.arange(T), (n_rows, T)).copy()
    return {f"{prefix}input_ids": ids, f"{prefix}labels": labels,
            f"{prefix}segment_ids": segs, f"{prefix}position_ids": pos}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the losses and the sequence logps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_preference_loss_matches_jax(loss_type, label_smoothing):
    rng = np.random.default_rng(3)
    # length-averaged logps lie in (-inf, 0): orpo takes log1p(-exp(x))
    pol_c, pol_r, ref_c, ref_r = (-rng.random(6) * 3 - 0.05 for _ in range(4))
    jcfg = jpref.DPOConfig(beta=0.1, loss_type=loss_type,
                           label_smoothing=label_smoothing)
    tcfg = tpref.DPOConfig(beta=0.1, loss_type=loss_type,
                           label_smoothing=label_smoothing)
    want = jpref.preference_loss(jcfg, *(jnp.asarray(x, jnp.float32) for x in
                                         (pol_c, pol_r, ref_c, ref_r)))
    got = tpref.preference_loss(tcfg, *(torch.tensor(x, dtype=torch.float32)
                                        for x in (pol_c, pol_r, ref_c, ref_r)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert tcfg.use_ref_model == jcfg.use_ref_model
    assert tcfg.average_logps == jcfg.average_logps


def test_unknown_dpo_loss_type_raises():
    with pytest.raises(ValueError, match="unknown DPO loss type"):
        tpref.preference_loss(tpref.DPOConfig(loss_type="x"),
                              *[torch.zeros(1)] * 4)
    with pytest.raises(ValueError, match="unknown DPO loss type"):
        tpref.make_dpo_step(None, None, tpref.DPOConfig(loss_type="x"))


def test_sequence_logps_matches_jax():
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((3, 9, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 9))
    labels[:, :4] = IGNORE_INDEX
    labels[2, :] = IGNORE_INDEX               # a row with no label: n = 1
    want_seq, want_n = jpref.sequence_logps(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(labels), 5)
    got_seq, got_n = tpref.sequence_logps(
        torch.from_numpy(hidden), torch.from_numpy(kernel),
        torch.from_numpy(labels), 5)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert float(got_seq[2]) == 0.0


# ---------------------------------------------------------------------------
# the steps against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ftx", [0.0, 0.5], ids=["no_ftx", "ftx"])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_dpo_step_matches_jax(loss_type, ftx):
    """Step 1 of make_dpo_step on 2 pairs (4 ragged rows) against JAX's:
    every metric and every parameter after it.  The reference-free losses
    are handed no reference on either side."""
    jb, tb, jparams = setup()
    (jo, jsched), (to, tsched) = optimizers()
    kw = dict(beta=0.1, loss_type=loss_type, ftx=ftx, logp_chunk_size=8,
              label_smoothing=0.1 if loss_type == "sigmoid" else 0.0)
    jstep = jpref.make_dpo_step(jax_score_fn(jb, remat=False), jo,
                                jpref.DPOConfig(**kw), jsched)
    tstep = tpref.make_dpo_step(bundle_score_fn(tb, remat=False), to,
                                tpref.DPOConfig(**kw), tsched)
    jstate, tstate = states(jparams, jo, to)
    use_ref = tpref.DPOConfig(**kw).use_ref_model
    jref = jparams if use_ref else {}
    tref = params_from_jax(jparams, device="cpu") if use_ref else {}
    batch = rows_batch(4, seed=1)
    jstate, jm = jstep(jstate, jref, jbatch(batch))
    tstate, tm = tstep(tstate, tref, batch)
    assert_metrics_close(tm, jm, loss_type)
    assert_params_close(tstate.params, jstate.params, msg=loss_type)
    assert tstate.step == 1


def test_kto_step_matches_jax():
    """Two KTO steps on target and KL rows with mixed tags: metrics (the
    clipped kl among them) and parameters."""
    jb, tb, jparams = setup()
    (jo, jsched), (to, tsched) = optimizers()
    kw = dict(beta=0.1, desirable_weight=1.0, undesirable_weight=1.33,
              logp_chunk_size=8)
    jstep = jpref.make_kto_step(jax_score_fn(jb, remat=False), jo,
                                jpref.KTOConfig(**kw), jsched)
    tstep = tpref.make_kto_step(bundle_score_fn(tb, remat=False), to,
                                tpref.KTOConfig(**kw), tsched)
    jstate, tstate = states(jparams, jo, to)
    tref = params_from_jax(jparams, device="cpu")
    batch = {**rows_batch(3, seed=2), **rows_batch(3, seed=5, prefix="kl_"),
             "tags": np.asarray([1, 0, 1])}
    for i in (1, 2):
        jstate, jm = jstep(jstate, jparams, jbatch(batch))
        tstate, tm = tstep(tstate, tref, batch)
        assert_metrics_close(tm, jm, f"kto step {i}")
        assert_params_close(tstate.params, jstate.params, msg=f"step {i}")
    assert float(tm["kl"]) >= 0


def test_bco_steps_and_running_moments_match_jax():
    """Three BCO steps, each fed the running mean of the one before: the
    metrics, the parameters, and the RunningMoments streams, which take
    the same numbers and must agree exactly."""
    jb, tb, jparams = setup()
    (jo, jsched), (to, tsched) = optimizers()
    jstep = jpref.make_bco_step(jax_score_fn(jb, remat=False), jo,
                                jpref.BCOConfig(beta=0.1, logp_chunk_size=8),
                                jsched)
    tstep = tpref.make_bco_step(bundle_score_fn(tb, remat=False), to,
                                tpref.BCOConfig(beta=0.1, logp_chunk_size=8),
                                tsched)
    jstate, tstate = states(jparams, jo, to)
    tref = params_from_jax(jparams, device="cpu")
    jrun, trun = jpref.RunningMoments(), tpref.RunningMoments()
    for i in (1, 2, 3):
        batch = {**rows_batch(3, seed=10 + i), "tags": np.asarray([1, 0, 0])}
        jstate, jm = jstep(jstate, jparams, jbatch(batch),
                           jnp.asarray(jrun.mean, jnp.float32))
        tstate, tm = tstep(tstate, tref, batch, trun.mean)
        assert_metrics_close(tm, jm, f"bco step {i}")
        stats = [float(jm[k]) for k in ("reward_mean", "reward_var",
                                        "reward_count")]
        assert jrun.update(*stats) == trun.update(*stats)
        assert jrun.state_dict() == trun.state_dict()
    assert_params_close(tstate.params, jstate.params, msg="bco")
    restored = tpref.RunningMoments()
    restored.load_state_dict(trun.state_dict())
    assert restored.update(0.5, 0.1, 3.0) == trun.update(0.5, 0.1, 3.0)


def test_rm_step_matches_jax():
    jb, tb, jparams = setup()
    (jo, jsched), (to, tsched) = optimizers()
    tree = {"model": jparams,
            "value_head": jpref.init_value_head(jax.random.PRNGKey(1), 64)}
    jstate, tstate = states(jparams, jo, to, tree)
    jstep = jpref.make_rm_step(lambda p, b: jb.hidden_fn(p, b), jo, jsched)
    tstep = tpref.make_rm_step(lambda p, b: tb.hidden_fn(p, b), to, tsched)
    batch = rows_batch(4, seed=6)
    for i in (1, 2):
        jstate, jm = jstep(jstate, jbatch(batch))
        tstate, tm = tstep(tstate, batch)
        assert_metrics_close(tm, jm, f"rm step {i}")
    assert_params_close(tstate.params, jstate.params, msg="rm")


def test_prm_step_matches_jax():
    jb, tb, jparams = setup()
    (jo, jsched), (to, tsched) = optimizers()
    tree = {"model": jparams,
            "prm_head": jpref.init_prm_head(jax.random.PRNGKey(1), 64)}
    jstate, tstate = states(jparams, jo, to, tree)
    jstep = jpref.make_prm_step(lambda p, b: jb.hidden_fn(p, b), jo, jsched)
    tstep = tpref.make_prm_step(lambda p, b: tb.hidden_fn(p, b), to, tsched)
    batch = rows_batch(3, seed=7)
    # step labels: 0/1 at a few real (not padding) positions of each row,
    # IGNORE_INDEX elsewhere
    labels = np.full_like(batch["labels"], IGNORE_INDEX)
    labels[:, [4, 6, 9]] = np.random.default_rng(8).integers(0, 2, (3, 3))
    batch["labels"] = labels
    jstate, jm = jstep(jstate, jbatch(batch))
    tstate, tm = tstep(tstate, batch)
    assert_metrics_close(tm, jm, "prm")
    assert_params_close(tstate.params, jstate.params, msg="prm")


def test_heads_are_seeded_by_the_generator():
    gen = functools.partial(torch.Generator().manual_seed, 1)
    a = tpref.init_value_head(gen(), 8)
    b = tpref.init_value_head(gen(), 8)
    assert a["kernel"].shape == (8, 1) and torch.equal(a["kernel"],
                                                       b["kernel"])
    prm = tpref.init_prm_head(gen(), 8, 3, dtype=torch.bfloat16)
    assert prm["kernel"].shape == (8, 3) and prm["bias"].dtype == torch.bfloat16
    assert float(prm["bias"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("last_only", [False, True])
def test_encode_prm_example_equals_jax(last_only):
    args = ([1, 2, 3], [[4, 5], [6], [7, 8, 9]], [True, False, True], [10, 11])
    assert tpref.encode_prm_example(*args, last_only) == \
        jpref.encode_prm_example(*args, last_only)


def _words(n, offset=0):
    return " ".join(f"w{(i + offset) % 50}" for i in range(n))


@functools.lru_cache(maxsize=None)
def _tokenizer():
    return tiny_qwen_tokenizer()


@pytest.mark.parametrize("system", [None, "Be brief."])
def test_encode_pairwise_example_equals_jax_under_the_cutoff(system):
    """Where the cutoff does not bind, both rows equal JAX's exactly."""
    tok = _tokenizer()
    prompt = [{"role": "user", "content": _words(12)}]
    args = (_words(5, 3), _words(9, 7))
    got = encode_pairwise_example(prompt, *args, get_template("qwen2_vl"),
                                  tok, system=system, cutoff_len=512)
    want = jax_encode_pairwise(prompt, *args, jax_template("qwen2_vl"), tok,
                               system=system, cutoff_len=512)
    assert got == tuple(tuple(side) for side in want)
    assert got[0][0][:20] == got[1][0][:20]


def _prompt_run(ids, labels):
    """The ids before the first labeled token."""
    first = next(i for i, x in enumerate(labels) if x != IGNORE_INDEX)
    return ids[:first]


def test_encode_pairwise_example_cuts_the_prompt_once():
    """ROADMAP C.R22 on both sides: a 120-word prompt, a 1-word chosen, a
    100-word rejected and cutoff_len 96.  JAX cuts each side's prompt on
    its own (here 92 prompt tokens kept beside the chosen, 54 beside the
    rejected: each side's own ``infer_seqlen``); the port cuts it once,
    against the longer response, and gives both responses the same
    budget."""
    tok = _tokenizer()
    prompt = [{"role": "user", "content": _words(120)}]
    chosen, rejected = _words(1, 9), _words(100, 11)
    jc, jr = jax_encode_pairwise(prompt, chosen, rejected,
                                 jax_template("qwen2_vl"), tok, cutoff_len=96)
    jc_prompt, jr_prompt = _prompt_run(*jc), _prompt_run(*jr)
    assert (len(jc_prompt), len(jr_prompt)) == (92, 54)
    assert jc_prompt != jr_prompt

    tc, tr = encode_pairwise_example(prompt, chosen, rejected,
                                     get_template("qwen2_vl"), tok,
                                     cutoff_len=96)
    tc_prompt, tr_prompt = _prompt_run(*tc), _prompt_run(*tr)
    assert tc_prompt == tr_prompt == jr_prompt[:len(tc_prompt)]
    full_prompt = get_template("qwen2_vl").encode_multiturn(
        tok, prompt + [{"role": "assistant", "content": rejected}])[0][0]
    chosen_ids = get_template("qwen2_vl").encode_multiturn(
        tok, prompt + [{"role": "assistant", "content": chosen}])[0][1]
    rejected_ids = get_template("qwen2_vl").encode_multiturn(
        tok, prompt + [{"role": "assistant", "content": rejected}])[0][1]
    assert [len(jc_prompt), len(jr_prompt)] == [
        infer_seqlen(len(full_prompt), len(ids), 96)[0]
        for ids in (chosen_ids, rejected_ids)]
    src, tgt = infer_seqlen(len(full_prompt), len(rejected_ids), 96)
    assert len(tc_prompt) == src
    assert tc[0] == full_prompt[:src] + chosen_ids[:tgt]
    assert tr[0] == full_prompt[:src] + rejected_ids[:tgt]
    assert len(tr[0]) <= 96 and len(tc[0]) <= 96
    assert tc[1][src:] == chosen_ids[:tgt] and tr[1][src:] == rejected_ids[:tgt]
