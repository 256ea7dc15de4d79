"""The port's Qwen2-MoE decoder against the JAX decoder and transformers.

A tiny ``Qwen2MoeForCausalLM`` (2 layers, hidden 64, 4 experts, top 2,
the config of tests/test_qwen2_moe_parity.py) built by transformers from a
seed; its weights go to JAX through ``convert_hf`` and on to the port
through ``params_from_jax``.  JAX runs at ``capacity_factor`` 100, where
its capacity dispatch drops nothing; the port's dispatch is dropless at
any factor.  Everything is f32.  Tolerances: logits atol 1e-4 against
both (summation order only), the aux loss rtol 1e-5 and its gradient atol
1e-6 against transformers, SFT and GRPO metrics rtol 1e-5 and parameters
atol 2e-6 after AdamW steps at lr 1e-3, as tests/test_torch_sft.py.

Also pinned here (ROADMAP C): C.R19 (JAX's capacity dispatch drops routed
tokens at a decode step of B = 4 at E = 60, K = 4; the port's never),
C.R20 (JAX's aux is not transformers'; the port's is) and C.R21 (JAX's
shared-expert adapters get no gradient; the port's apply).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.cli.train_sft import main as jax_sft_main
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import common as jcommon
from iadr1_tpu.models import qwen2 as jq
from iadr1_tpu.models import qwen2_moe as jmoe
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu.models.params_io import hf_state_from_torch
from iadr1_tpu.train import adapters as jad
from iadr1_tpu.train import grpo as jgrpo
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.cli.train_sft import main as sft_main
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import qwen2_moe as tmoe
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.models.params_export import export_params
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import (
    bundle_from_hf_config,
    bundle_from_pretrained,
)
from iadr1_tpu_torch.train import adapters as tad
from iadr1_tpu_torch.train import grpo as tgrpo
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
from iadr1_tpu_torch.train.sft import make_chunked_sft_step
from iadr1_tpu_torch.train.state import create_train_state
from tests.helpers import build_iad_sft_dataset, build_tiny_moe_checkpoint

TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=512,
    tie_word_embeddings=False, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=48, shared_expert_intermediate_size=80,
    norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
)
HF = dict(TINY, architectures=["Qwen2MoeForCausalLM"], capacity_factor=100.0)
ATOL = 1e-4
OPT = dict(learning_rate=1e-3, total_steps=4, warmup_steps=1,
           weight_decay=0.01, max_grad_norm=1.0)


@functools.lru_cache(maxsize=None)
def _hf_model():
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

    torch.manual_seed(0)
    return Qwen2MoeForCausalLM(Qwen2MoeConfig(
        **TINY, attention_dropout=0.0)).eval()


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jmoe.config_from_hf(HF)
    jparams = jmoe.convert_hf(hf_state_from_torch(_hf_model()), jcfg)
    tb = bundle_from_hf_config(HF, precision=FULL_PRECISION)
    return jcfg, jparams, tb


def _tparams():
    return params_from_jax(_setup()[1], device="cpu")


def _batch(B=2, T=12, pad=3, seed=0):
    """Left padding on row 1 (segment 0), positions counting real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (B, T))
    segs = np.ones((B, T), np.int32)
    segs[1, :pad] = 0
    pos = np.clip(np.cumsum(segs, 1) - 1, 0, None)
    return ids, pos, segs


def _port_logits(tb, params, ids, pos, segs, **kw):
    h, _ = tb.apply(params, {"input_ids": torch.as_tensor(ids),
                             "position_ids": torch.as_tensor(pos),
                             "segment_ids": torch.as_tensor(segs)}, **kw)
    return tb.logits_fn(params, h)


def test_bundle_builds_from_the_hf_config_and_keeps_capacity_factor():
    tb = bundle_from_hf_config(dict(TINY, model_type="qwen2_moe"))
    assert tb.family == "qwen2_moe" and tb.shared_pred_fn is None
    assert tb.cfg.capacity_factor == 2.0 and tb.cfg.router_aux_loss_coef == 0.001
    jcfg = jmoe.config_from_hf(TINY)
    assert {f.name: getattr(tb.cfg, f.name) for f in
            dataclasses.fields(tb.cfg)} == dataclasses.asdict(jcfg) | {
                "attention_bias": True, "rms_norm_offset": 0.0,
                "hidden_act": "silu", "scale_embeds": False}
    for bad in ({"mlp_only_layers": [1]}, {"decoder_sparse_step": 2}):
        with pytest.raises(NotImplementedError):
            bundle_from_hf_config(dict(TINY, model_type="qwen2_moe", **bad))


def test_logits_match_jax_and_transformers():
    jcfg, jparams, tb = _setup()
    ids, pos, segs = _batch()
    full = np.ones_like(segs)
    fpos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape)
    with torch.no_grad():
        hf = _hf_model()(torch.as_tensor(ids)).logits.numpy()
        got = _port_logits(tb, _tparams(), ids, fpos, full).numpy()
        got_pad = _port_logits(tb, _tparams(), ids, pos, segs).numpy()
    np.testing.assert_allclose(got, hf, atol=ATOL, rtol=0)
    h, _ = jmoe.apply(jparams, jcfg, jnp.asarray(ids),
                      position_ids=jnp.asarray(pos),
                      segment_ids=jnp.asarray(segs), precision=JAX_FULL)
    want = np.asarray(jmoe.logits(jparams, jcfg, h, JAX_FULL))
    live = segs.astype(bool)          # rows that attend no key differ
    np.testing.assert_allclose(got_pad[live], want[live], atol=ATOL, rtol=0)


def test_prefill_and_decode_match_the_uncached_forward():
    """The three cache modes: a prefill of 9 tokens, then 3 single-token
    decode steps (K4's twin) and one 1-token extend, against the logits
    of the whole sequence at each position."""
    _, _, tb = _setup()
    params = _tparams()
    ids, pos, segs = _batch(T=13)
    with torch.no_grad():
        whole = _port_logits(tb, params, ids, pos, segs).numpy()
        cache = tmoe.init_cache(tb.cfg, 2, 16, torch.float32, "cpu")
        P = 9

        def run(lo, hi, mode):
            b = {"input_ids": torch.as_tensor(ids[:, lo:hi]),
                 "position_ids": torch.as_tensor(pos[:, lo:hi]),
                 "segment_ids": torch.as_tensor(segs[:, lo:hi])}
            h, _ = tb.apply(params, b, cache=cache, cache_mode=mode)
            return tb.logits_fn(params, h).numpy()

        got = [run(0, P, "prefill")]
        for t in range(P, 12):
            got.append(run(t, t + 1, "decode"))
        got.append(run(12, 13, "extend"))
    got = np.concatenate(got, axis=1)
    live = segs.astype(bool)
    np.testing.assert_allclose(got[live], whole[live], atol=ATOL, rtol=0)


def _hf_aux(ids, segs):
    """transformers' aux loss and its gradient at the routers."""
    model = _hf_model()
    model.zero_grad()
    out = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(segs),
                output_router_logits=True)
    out.aux_loss.backward()
    grads = [model.model.layers[i].mlp.gate.weight.grad.T.clone()
             for i in range(TINY["num_hidden_layers"])]
    model.zero_grad()
    return float(out.aux_loss), torch.stack(grads)


def test_aux_loss_is_transformers_load_balancing_loss():
    """C.R20, the port's side: masked by the segments, pooled over the
    layers, K slots counted, times E: transformers' value and gradient."""
    _, _, tb = _setup()
    ids, pos, segs = _batch()
    want, want_grad = _hf_aux(ids, segs)
    params = _tparams()
    router = params["layers"]["mlp"]["router"]["kernel"].requires_grad_(True)
    _, _, aux = tb.apply(params, {"input_ids": torch.as_tensor(ids),
                                  "position_ids": torch.as_tensor(pos),
                                  "segment_ids": torch.as_tensor(segs)},
                         return_aux=True)
    (grad,) = torch.autograd.grad(aux, [router])
    np.testing.assert_allclose(float(aux), want, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), atol=1e-6,
                               rtol=0)


def test_jax_aux_is_not_transformers():
    """C.R20, the JAX side: its aux averages the routings over the K slots
    too and counts padding; at near-uniform routing it reads about 1/K of
    transformers' (here K = 2)."""
    jcfg, jparams, _ = _setup()
    ids, pos, segs = _batch()
    want, _ = _hf_aux(ids, segs)
    _, _, aux = jmoe.apply(jparams, jcfg, jnp.asarray(ids),
                           position_ids=jnp.asarray(pos),
                           segment_ids=jnp.asarray(segs), precision=JAX_FULL,
                           return_aux=True)
    assert abs(float(aux) * TINY["num_experts_per_tok"] - want) < 0.2 * want
    assert abs(float(aux) - want) > 0.4 * want
    other = ids.copy()
    other[1, :3] = (ids[1, :3] + 7) % TINY["vocab_size"]   # padding tokens
    _, _, aux2 = jmoe.apply(jparams, jcfg, jnp.asarray(other),
                            position_ids=jnp.asarray(pos),
                            segment_ids=jnp.asarray(segs), precision=JAX_FULL,
                            return_aux=True)
    assert float(aux2) != float(aux)     # padding counts in JAX


@pytest.mark.parametrize("seed", range(5))
def test_decode_dispatch_drops_nothing(seed):
    """C.R19: one decode step of B = 4 at Qwen1.5-MoE's E = 60, K = 4
    (hidden 64).  JAX's capacity dispatch at its default factor 2.0 gives
    C = 1: two rows that share an expert lose a contribution.  The port's
    block equals JAX's at factor 100 (dropless) on every draw."""
    rng = np.random.default_rng(seed)
    hf = dict(TINY, num_experts=60, num_experts_per_tok=4)
    mp = {
        "router": {"kernel": rng.standard_normal((64, 60)) * 0.5},
        "experts": {n: {"kernel": rng.standard_normal(s) * 0.1}
                    for n, s in (("gate", (60, 64, 48)), ("up", (60, 64, 48)),
                                 ("down", (60, 48, 64)))},
        "shared": {n: {"kernel": rng.standard_normal(s) * 0.1}
                   for n, s in (("gate", (64, 80)), ("up", (64, 80)),
                                ("down", (80, 64)))},
        "shared_gate": {"kernel": rng.standard_normal((64, 1)) * 0.1},
    }
    mp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), mp)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    outs = {f: np.asarray(jmoe.moe_block(
        jmoe.config_from_hf(dict(hf, capacity_factor=f)), jnp.asarray(x),
        mp)[0]) for f in (2.0, 100.0)}
    got, _ = tmoe.moe_block(tmoe.config_from_hf(hf), torch.as_tensor(x),
                            params_from_jax(mp, device="cpu"))
    np.testing.assert_allclose(got.numpy(), outs[100.0], atol=1e-5, rtol=0)
    _, sel = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x[:, 0]) @ mp["router"]["kernel"]), 4)
    shared_expert = len(set(np.asarray(sel).ravel())) < 16
    dropped = np.abs(outs[2.0] - outs[100.0]).max() > 1e-3
    assert dropped == shared_expert


def _jax_hidden_hf_aux(jcfg):
    """The JAX reference with transformers' aux: JAX's own layers (the
    attention block, the sparse block at factor 100) run one at a time,
    the routing statistics pooled as ``load_balancing_loss_func`` pools
    them."""
    E, K, L = jcfg.num_experts, jcfg.num_experts_per_tok, \
        jcfg.num_hidden_layers

    def hidden_fn(params, batch):
        ids, pos, segs = (batch["input_ids"], batch["position_ids"],
                          batch["segment_ids"])
        B, T = ids.shape
        h = params["embed"]["weight"][ids]
        cos, sin = jcommon.rope_cos_sin(pos, jcfg.head_dim_, jcfg.rope_theta)
        idx = jnp.broadcast_to(jnp.arange(T), (B, T))
        mask = jcommon.make_attention_mask(segs, segs, idx, idx, causal=True)
        attn = lambda q, k, v: jcommon.xla_attention(q, k, v, mask)
        m = (segs.reshape(-1) > 0).astype(jnp.float32)[:, None]
        counts = probs_sum = 0.0
        for i in range(L):
            lp = jax.tree.map(lambda a: a[i], params["layers"])
            h, _, _ = jq._attn_block(jcfg, h, lp, cos, sin, None, None, attn)
            x = jcommon.rms_norm(h, lp["post_attn_norm"], jcfg.rms_norm_eps)
            out, _ = jmoe.moe_block(jcfg, x, lp["mlp"])
            probs = jax.nn.softmax(x.reshape(B * T, -1)
                                   @ lp["mlp"]["router"]["kernel"], axis=-1)
            _, sel = jax.lax.top_k(probs, K)
            counts = counts + (jax.nn.one_hot(sel, E).sum(1) * m).sum(0)
            probs_sum = probs_sum + (probs * m).sum(0)
            h = h + out
        n = L * m.sum()
        aux = E * jnp.sum((counts / n) * (probs_sum / n))
        return (jcommon.rms_norm(h, params["final_norm"], jcfg.rms_norm_eps),
                aux)

    return hidden_fn


def _sft_batches():
    out = []
    for seed in (1, 2):
        ids, pos, segs = _batch(B=2, T=16, pad=4, seed=seed)
        labels = np.where(segs > 0, ids, -100)
        labels[:, :5] = -100
        out.append({"input_ids": ids, "position_ids": pos,
                    "segment_ids": segs, "labels": labels})
    return out


def test_sft_steps_with_the_aux_loss_match_the_jax_step():
    """3 steps of the chunked-CE step with ``router_aux_loss_coef`` 0.05
    (large, so that the aux moves the parameters): the port against JAX's
    step whose hidden_fn pools the aux as transformers does (C.R20)."""
    jcfg, jparams, tb = _setup()
    coef = 0.05
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstate = jax_state(jparams, jo)
    jfn = jax_step(_jax_hidden_hf_aux(jcfg), lambda p: p["lm_head"]["kernel"],
                   jo, jsched, donate=False, chunk_size=8,
                   aux_loss_coef=coef)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstate = create_train_state(_tparams(), to)

    def hidden_fn(params, batch):
        h, _, aux = tb.apply(params, batch, remat=True, return_aux=True)
        return h, aux

    tfn = make_chunked_sft_step(hidden_fn, tb.head_kernel_fn, to, tsched,
                                chunk_size=8, aux_loss_coef=coef)
    batches = _sft_batches()
    for step, i in enumerate((0, 1, 0), start=1):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v)
                                  for k, v in batches[i].items()})
        tstate, tm = tfn(tstate, batches[i])
        for key in ("loss", "aux_loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {key}")
        if step in (1, 3):
            want = jax.tree_util.tree_leaves_with_path(jstate.params)
            got = dict(_flat(tstate.params))
            for path, leaf in want:
                name = "/".join(str(getattr(k, "key", k)) for k in path)
                np.testing.assert_allclose(
                    got[name].detach().numpy(), np.asarray(leaf),
                    atol=2e-6, rtol=0, err_msg=f"step {step} {name}")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.mark.parametrize("mode", [True, "save_qkv", "full"])
def test_remat_modes_give_the_same_gradients(mode):
    _, _, tb = _setup()
    batch = {k: torch.as_tensor(v) for k, v in _sft_batches()[0].items()}
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(64),
                        dtype=torch.float32)

    def grads(remat):
        params = _tparams()
        leaves = [p.requires_grad_(True) for n, p in _flat(params)
                  if n != "lm_head/kernel"]          # no logits here
        h, _, aux = tb.apply(params, batch, remat=remat, return_aux=True)
        return torch.autograd.grad((h * r).sum() + aux, leaves)

    for got, want in zip(grads(mode), grads(False)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_greedy_generation_matches_transformers():
    """8 greedy tokens of two left-padded prompts through the rollout
    engine (prefill, then K4's twin a step) against ``generate``."""
    _, _, tb = _setup()
    ids, _, segs = _batch(T=10, pad=3, seed=4)
    with torch.no_grad():
        want = _hf_model().generate(
            torch.as_tensor(ids), attention_mask=torch.as_tensor(segs),
            max_new_tokens=8, do_sample=False, pad_token_id=0,
            eos_token_id=None)[:, ids.shape[1]:].numpy()
    engine = RolloutEngine(tb, SamplingConfig(
        max_new_tokens=8, temperature=0.0, eos_token_id=127,
        pad_token_id=0), max_len=18, cache_dtype=torch.float32,
        device="cpu")
    out = engine.generate(_tparams(), {
        "input_ids": torch.as_tensor(ids),
        "attention_mask": torch.as_tensor(segs)})
    np.testing.assert_array_equal(out["completion_ids"].numpy(), want)


def test_grpo_update_matches_jax():
    """One dense SC-GRPO update (no shared-prompt path, no aux, as in
    JAX) on a recorded batch with left padding and a ragged completion."""
    from tests.test_torch_grpo import _dense_update_batch, _jbatch

    jcfg, jparams, tb = _setup()
    jb = jax_registry.bundle_from_hf_config(HF, attention="xla",
                                            precision=JAX_FULL)
    kw = dict(num_generations=2, beta=0.04, max_completion_length=4,
              logp_chunk_size=8)
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    jstep = jgrpo.make_grpo_update_step(
        jgrpo.bundle_score_fn(jb, remat=False), jo, jgrpo.GRPOConfig(**kw),
        jsched)
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    tstep = tgrpo.make_grpo_update_step(
        tgrpo.bundle_score_fn(tb, remat=True), to, tgrpo.GRPOConfig(**kw),
        tsched)
    batch = _dense_update_batch()
    batch["input_ids"] = batch["input_ids"] % TINY["vocab_size"]
    batch["completion_ids"] = batch["input_ids"][:, batch["prompt_len"]:]
    jstate, jm = jstep(jax_state(jax.tree.map(jnp.copy, jparams), jo),
                       jparams, _jbatch(batch))
    tstate, tm = tstep(create_train_state(_tparams(), to), _tparams(), batch)
    for key in ("loss", "kl", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    got = dict(_flat(tstate.params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(leaf), atol=2e-6, rtol=0,
                                   err_msg=name)


def _lora_cfg_pair():
    return (jad.TuningConfig(finetuning_type="lora", lora_rank=4),
            tad.TuningConfig(finetuning_type="lora", lora_rank=4))


def test_jax_shared_expert_adapters_get_no_gradient():
    """C.R21, the JAX side: init_lora makes adapters for the shared
    expert's kernels (and none for the 4-D expert kernels), but the sparse
    block never applies them: their gradient is exactly 0."""
    jcfg, jparams, _ = _setup()
    jcfg_l, _ = _lora_cfg_pair()
    lora = jad.init_lora_params(jax.random.PRNGKey(1), jparams, jcfg_l)
    mlp = lora["layers"]["mlp"]
    assert mlp["experts"]["gate"]["kernel"] is None
    assert mlp["shared"]["gate"]["kernel"]["a"].shape == (2, 64, 4)
    ids, pos, segs = _batch()

    def loss(lora):
        h, _ = jmoe.apply(jparams, jcfg, jnp.asarray(ids),
                          position_ids=jnp.asarray(pos),
                          segment_ids=jnp.asarray(segs), precision=JAX_FULL,
                          lora=lora, lora_scale=2.0)
        return jnp.sum(h * jnp.linspace(-1, 1, 64))

    g = jax.grad(loss)(lora)["layers"]
    for name in ("gate", "up", "down"):
        assert not np.asarray(g["mlp"]["shared"][name]["kernel"]["b"]).any()
    assert np.asarray(g["attn"]["q"]["kernel"]["b"]).any()


def test_port_shared_expert_adapters_apply():
    """C.R21, the port's side: the shared expert's adapters act as the
    merged weights would, their gradient is not 0, and the 4-D expert
    kernels have none (as in JAX)."""
    _, _, tb = _setup()
    params = _tparams()
    _, tcfg = _lora_cfg_pair()
    lora = tad.init_lora_params(torch.Generator().manual_seed(1), params,
                                tcfg)
    mlp = lora["layers"]["mlp"]
    assert mlp["experts"]["gate"]["kernel"] is None
    for node in (mlp["shared"][n]["kernel"] for n in ("gate", "up", "down")):
        node["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    ids, pos, segs = _batch()
    batch = {"input_ids": torch.as_tensor(ids),
             "position_ids": torch.as_tensor(pos),
             "segment_ids": torch.as_tensor(segs)}
    merged = tad.merge_lora(params, lora, tcfg)
    with torch.no_grad():
        got, _ = tb.apply(params, batch, lora=lora,
                          lora_scale=tcfg.lora_scale)
        want, _ = tb.apply(merged, batch)
        base, _ = tb.apply(params, batch)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert (got - base).abs().max() > 1e-3
    b = mlp["shared"]["up"]["kernel"]["b"].requires_grad_(True)
    h, _ = tb.apply(params, batch, lora=lora, lora_scale=tcfg.lora_scale)
    (grad,) = torch.autograd.grad(h.sum(), [b])
    assert grad.abs().max() > 0


def test_bundle_from_pretrained_reads_an_hf_moe_checkpoint(tmp_path):
    path = build_tiny_moe_checkpoint(str(tmp_path / "moe"))
    tb = bundle_from_pretrained(path, precision=FULL_PRECISION)
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from transformers import Qwen2MoeForCausalLM

    params = tb.convert_hf(load_safetensors_path(path), device="cpu")
    assert params["layers"]["mlp"]["experts"]["up"]["kernel"].shape == (
        2, 4, 64, 48)
    assert "lm_head" not in params                 # tied
    ids = np.random.default_rng(5).integers(1, 600, (1, 7))
    with torch.no_grad():
        want = Qwen2MoeForCausalLM.from_pretrained(path).eval()(
            torch.as_tensor(ids)).logits.numpy()
        got = _port_logits(tb, params, ids, np.arange(7)[None],
                           np.ones((1, 7), np.int32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the export refuses the family, as JAX's export_params does
    with pytest.raises(ValueError, match="qwen2_moe"):
        export_params(tb, params)


def _cli_cfg(ckpt, data_path, img_dir, out_dir):
    return {
        "model": {"model_name_or_path": ckpt},
        "data": {"dataset": data_path, "image_dir": img_dir,
                 "template": "qwen2_vl", "cutoff_len": 64},
        "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                  "total_steps": 3},
        "train": {"output_dir": out_dir, "max_steps": 3, "batch_size": 2,
                  "logging_steps": 1, "save_steps": 0},
    }


def _cli_run(main, cfg, path, device):
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path)] + (["--device", device] if device else [])
    assert main(argv) == 0
    with open(os.path.join(cfg["train"]["output_dir"],
                           "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(jax_registry, "bundle_from_hf_config",
                        functools.partial(jax_registry.bundle_from_hf_config,
                                          precision=JAX_FULL))
    monkeypatch.setattr(registry, "bundle_from_hf_config", functools.partial(
        registry.bundle_from_hf_config, precision=FULL_PRECISION))


def test_sft_cli_on_an_hf_moe_checkpoint_matches_the_jax_cli(tmp_path,
                                                             f32_compute):
    """The SFT CLI on ``build_tiny_moe_checkpoint``: with the router aux
    coefficient set to 0 the port's steps 1-3 equal the JAX CLI's (loss,
    accuracy, grad norm, learning rate rtol 1e-5); at the checkpoint's
    0.001 both logs carry ``aux_loss`` and the port's loss is CE + 0.001
    aux.  The JAX capacity dispatch drops nothing here (C = S at E = 4,
    K = 2, factor 2)."""
    path = build_tiny_moe_checkpoint(str(tmp_path / "moe"))
    data_path, img_dir = build_iad_sft_dataset(tmp_path)
    cfg_file = os.path.join(path, "config.json")
    with open(cfg_file) as f:
        hf = json.load(f)
    logs = {}
    for coef in (0.0, 0.001):
        with open(cfg_file, "w") as f:
            json.dump(dict(hf, router_aux_loss_coef=coef), f)
        for side, main, device in (("port", sft_main, "cpu"),
                                   ("jax", jax_sft_main, None)):
            if side == "jax" and coef:
                continue
            cfg = _cli_cfg(path, data_path, img_dir,
                           str(tmp_path / f"{side}{coef}"))
            cfg["model"]["attention"] = "auto" if side == "port" else "xla"
            if side == "jax":
                cfg["mesh"] = {"dp": 1, "fsdp": 4, "tp": 2}
            logs[side, coef] = _cli_run(main, cfg,
                                        tmp_path / f"{side}{coef}.json",
                                        device)
    port, jax_log = logs["port", 0.0], logs["jax", 0.0]
    assert len(port) == len(jax_log) == 3
    for got, want in zip(port, jax_log):
        assert sorted(got) == sorted(want)
        for key in ("loss", "accuracy", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    with_aux = logs["port", 0.001]
    assert all("aux_loss" in r for r in with_aux)
    np.testing.assert_allclose(with_aux[0]["loss"],
                               port[0]["loss"] + 0.001 * with_aux[0]
                               ["aux_loss"], rtol=1e-6)
