"""The port's weight-only quantization (iadr1_tpu_torch/models/quant.py)
and GPTQ/AWQ import (models/params_io.py) against the JAX package's, case
by case as tests/test_quant.py drives the JAX side.

Quantized values, scales, GPTQ/AWQ conversions and dequantized kernels are
held bit for bit (the same f32 division, round half to even, the NF4
midpoint bisection, the nibble order).  Forwards and training run both
packages in f32 (FULL_PRECISION; JAX with ``attention="xla"``) on the same
weights, carried over with ``params_from_jax``: hidden states and logits
agree to 2e-4, losses to rtol 1e-4 (f32, summation order only; an
unfused dequantize differs from XLA's fused one by nothing, both compute
``q * s`` in f32).  Inputs come from numpy seeds.

The quantized ``dense`` and ``lora_dense`` on the card are held in
tests/test_torch_cuda_kernels.py (the card's machine has no JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import params_io as jio
from iadr1_tpu.models import quant as jq
from iadr1_tpu.models.registry import make_qwen2_bundle as jax_bundle
from iadr1_tpu.train import adapters as jad
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import params_io as tio
from iadr1_tpu_torch.models import quant as tq
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import make_qwen2_bundle
from iadr1_tpu_torch.train import adapters as tad

TINY = dict(
    vocab_size=600, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10000.0, tie_word_embeddings=True,
    architectures=["Qwen2ForCausalLM"],
)
ATOL = 2e-4


def _same(jax_dict, torch_dict):
    assert sorted(jax_dict) == sorted(torch_dict)
    for k in jax_dict:
        want = np.asarray(jax_dict[k])
        got = torch_dict[k].cpu().numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _both(w, fmt, block=64):
    """(JAX quant dict, port quant dict) of one f32 numpy kernel."""
    return (jq.quantize_kernel(jnp.asarray(w), fmt=fmt, block_size=block),
            tq.quantize_kernel(torch.as_tensor(w), fmt, block))


def _bundles(hf=TINY):
    return (jax_bundle(hf, attention="xla", precision=JAX_FULL),
            make_qwen2_bundle(hf, attention="xla", precision=FULL_PRECISION))


def _batches(B, T, vocab, seed=0, labels_from=None):
    ids = np.random.default_rng(seed).integers(1, vocab, (B, T))
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    jb = {"input_ids": jnp.asarray(ids, jnp.int32),
          "segment_ids": jnp.ones((B, T), jnp.int32),
          "position_ids": jnp.asarray(pos, jnp.int32)}
    tb = {"input_ids": torch.as_tensor(ids),
          "segment_ids": torch.ones((B, T), dtype=torch.int32),
          "position_ids": torch.as_tensor(pos)}
    if labels_from is not None:
        labels = np.where(np.arange(T) < labels_from, -100, ids)
        jb["labels"] = jnp.asarray(labels, jnp.int32)
        tb["labels"] = torch.as_tensor(labels)
    return jb, tb


def _forward_logits(jb, tb, jparams, tparams, jbatch, tbatch):
    want = np.asarray(jb.forward(jparams, jbatch), np.float64)
    h = tb.hidden_fn(tparams, tbatch, remat=False)
    got = tb.logits_fn(tparams, h).detach().double().numpy()
    return want, got


def test_kernel_roundtrip():
    w = (np.random.default_rng(0).standard_normal((3, 32, 48)) * 0.2
         ).astype(np.float32)
    jqk, tqk = _both(w, "int8")
    _same(jqk, tqk)
    assert tqk["qvalues"].dtype == torch.int8
    assert tuple(tqk["scales"].shape) == (3, 1, 48)
    deq = tq.dequantize_kernel(tqk).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jq.dequantize_kernel(jqk)))
    bound = tqk["scales"].numpy() / 2 + 1e-7
    assert (np.abs(deq - w) <= bound).all()
    # an all-zero channel gets scale 1, as in JAX
    w[:, :, 3] = 0
    _same(*_both(w, "int8"))


def test_quantize_tree_targets():
    jbun, tbun = _bundles()
    jparams = jbun.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jqp = jq.quantize_tree(jparams)
    tqp = tq.quantize_tree(params_from_jax(jparams, device="cpu"))
    for group, name in (("mlp", "up"), ("attn", "q")):
        assert tq.is_quantized(tqp["layers"][group][name]["kernel"])
        _same(jqp["layers"][group][name]["kernel"],
              tqp["layers"][group][name]["kernel"])
    # the embeddings (and the tied head) stay full precision
    assert tqp["embed"]["weight"].dtype == torch.bfloat16
    now, bf16 = tq.quantized_bytes(tqp)
    assert (now, bf16) == jq.quantized_bytes(jqp) and now < bf16


def test_quantized_forward_close():
    jbun, tbun = _bundles()
    jparams = jbun.init_params(jax.random.PRNGKey(0))
    jqp = jq.quantize_tree(jparams)
    tqp = tq.quantize_tree(params_from_jax(jparams, device="cpu"))
    jbatch, tbatch = _batches(2, 16, 600)
    want, got = _forward_logits(jbun, tbun, jqp, tqp, jbatch, tbatch)
    np.testing.assert_allclose(got, want, atol=ATOL)
    full = np.asarray(jbun.forward(jparams, jbatch), np.float64)
    assert np.abs(full - got).max() / np.abs(full).max() < 0.15
    assert (full.argmax(-1) == got.argmax(-1)).mean() > 0.9


def test_int4_roundtrip_and_layout():
    w = (np.random.default_rng(1).standard_normal((3, 64, 48)) * 0.2
         ).astype(np.float32)
    jqk, tqk = _both(w, "int4", 32)
    _same(jqk, tqk)
    assert tuple(tqk["q4"].shape) == (3, 32, 48)
    assert tuple(tqk["scales"].shape) == (3, 2, 48)
    assert tq.quantized_shape(tqk) == (3, 64, 48)
    deq = tq.dequantize_kernel(tqk).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jq.dequantize_kernel(jqk)))
    scales = tqk["scales"].numpy()[:, :, None, :]
    err = np.abs(deq - w).reshape(3, 2, 32, 48)
    assert (err <= scales / 14 + 1e-6).all()
    # grid values round-trip, and a value halfway between two steps
    # rounds to the even one in both packages
    grid = ((np.repeat(np.arange(-7, 8), 2) / 7.0)[None, :, None]
            * np.full((1, 30, 4), 0.3)).astype(np.float32)
    grid[0, 1, 1] = np.float32(0.5 / 7.0 * 0.3)
    jg, tg = _both(grid[0], "int4", 30)
    _same(jg, tg)
    # an odd block size shrinks to an even divisor, as in JAX
    _same(*_both(w[0, :60], "int4", 64))


def test_nf4_roundtrip():
    w = (np.random.default_rng(2).standard_normal((128, 32)) * 0.1
         ).astype(np.float32)
    jqk, tqk = _both(w, "nf4")
    _same(jqk, tqk)
    assert tuple(tqk["nf4"].shape) == (64, 32)
    assert tuple(tqk["scales"].shape) == (2, 32)
    deq = tq.dequantize_kernel(tqk).numpy()
    gaps = np.diff(np.asarray(tq.NF4_CODE))
    err = np.abs(deq - w).reshape(2, 64, 32)
    assert (err <= tqk["scales"].numpy()[:, None, :] * gaps.max() / 2
            + 1e-6).all()
    code = (np.asarray(tq.NF4_CODE)[None, :, None]
            * np.full((1, 16, 4), 0.7)).astype(np.float32)
    _same(*_both(code[0], "nf4", 16))
    np.testing.assert_allclose(
        tq.dequantize_kernel(tq.quantize_kernel(torch.as_tensor(code[0]),
                                                "nf4", 16)).numpy(),
        code[0], rtol=1e-6, atol=1e-7)
    # values exactly on the codebook's midpoints (the block's absmax is 1,
    # so the normed values are the midpoints themselves): the tie takes
    # the lower code in both packages
    c = np.asarray(tq.NF4_CODE, np.float32)
    mids = ((c[:-1] + c[1:]) / np.float32(2.0)).astype(np.float32)
    tie = np.concatenate([mids, [1.0]]).astype(np.float32)[:, None]
    _same(*_both(np.repeat(tie, 2, axis=1), "nf4", 16))


def test_nf4_forward_close():
    jbun, tbun = _bundles()
    jparams = jbun.init_params(jax.random.PRNGKey(0))
    jqp = jq.quantize_tree(jparams, fmt="nf4")
    tqp = tq.quantize_tree(params_from_jax(jparams, device="cpu"), fmt="nf4")
    _same(jqp["layers"]["mlp"]["down"]["kernel"],
          tqp["layers"]["mlp"]["down"]["kernel"])
    now, bf16 = tq.quantized_bytes(tqp)
    assert now < bf16
    qk = tqp["layers"]["mlp"]["up"]["kernel"]
    kb_now = qk["nf4"].numel() + qk["scales"].numel() * 4
    assert kb_now <= (2 * 2 * 64 * 128) * (0.25 + 4 / 64 / 2 + 0.01)
    jbatch, tbatch = _batches(2, 16, 600)
    want, got = _forward_logits(jbun, tbun, jqp, tqp, jbatch, tbatch)
    np.testing.assert_allclose(got, want, atol=ATOL)
    full = np.asarray(jbun.forward(jparams, jbatch), np.float64)
    assert np.abs(full - got).max() / np.abs(full).max() < 0.25
    assert (full.argmax(-1) == got.argmax(-1)).mean() > 0.8


def _adam_losses(loss_fn, params, steps, lr):
    opt = torch.optim.Adam(params, lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def test_qlora_trains_on_quantized_base():
    """int4 base + factored LoRA, f32: 8 Adam steps track JAX's optax.adam
    loss for loss (rtol 1e-4), only the adapters move, and the merged
    export's forward equals the factored one's (2e-4)."""
    import optax

    from iadr1_tpu.train.sft import chunked_sft_loss as jax_loss
    from iadr1_tpu_torch.train.sft import chunked_sft_loss

    jbun, tbun = _bundles()
    jparams = jbun.init_params(jax.random.PRNGKey(0))
    jbase = jq.quantize_tree(jparams, fmt="int4")
    tbase = params_from_jax(jbase, device="cpu")
    _same(jbase["layers"]["mlp"]["gate"]["kernel"],
          tq.quantize_tree(params_from_jax(jparams, device="cpu"),
                           fmt="int4")["layers"]["mlp"]["gate"]["kernel"])
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=4)
    jlora = jad.init_lora_params(jax.random.PRNGKey(1), jbase,
                                 jad.TuningConfig(finetuning_type="lora",
                                                  lora_rank=4))
    tlora = params_from_jax(jlora, device="cpu")
    assert tlora["layers"]["attn"]["q"]["kernel"]["a"].shape[-1] == 4
    # the port's own init gives the same structure, shapes and dtypes
    own = tad.init_lora_params(torch.Generator().manual_seed(1), tbase, tcfg)
    assert ({k: tuple(v.shape) for k, v in tad._adapters_by_path(own).items()
             for v in [v["a"]]}
            == {k: tuple(v["a"].shape)
                for k, v in tad._adapters_by_path(tlora).items()})
    jbatch, tbatch = _batches(2, 24, 600, labels_from=8)

    def jloss(lo):
        h = jbun.hidden_fn(jbase, jbatch, remat=False, lora=lo,
                           lora_scale=tcfg.lora_scale)
        return jax_loss(h, jbun.head_kernel_fn(jbase), jbatch["labels"],
                        chunk_size=16)[0]

    opt = optax.adam(5e-3)

    @jax.jit
    def jstep(lo, state):
        loss, g = jax.value_and_grad(jloss)(lo)
        upd, state = opt.update(g, state, lo)
        return optax.apply_updates(lo, upd), state, loss

    state = opt.init(jlora)
    want = []
    for _ in range(8):
        jlora, state, loss = jstep(jlora, state)
        want.append(float(loss))

    from iadr1_tpu_torch.train.state import tree_leaves

    leaves = tree_leaves(tlora)
    for p in leaves:
        p.requires_grad_(True)
    before = {k: v.clone() for k, v in tbase["layers"]["attn"]["q"][
        "kernel"].items()}

    def tloss():
        h = tbun.hidden_fn(tbase, tbatch, remat=False, lora=tlora,
                           lora_scale=tcfg.lora_scale)
        return chunked_sft_loss(h, tbun.head_kernel_fn(tbase),
                                tbatch["labels"], chunk_size=16)[0]

    got = _adam_losses(tloss, leaves, 8, 5e-3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for k, v in tbase["layers"]["attn"]["q"]["kernel"].items():
        assert torch.equal(v, before[k])

    merged = tad.merge_lora(tbase, tlora, tcfg)
    assert not tq.is_quantized(merged["layers"]["attn"]["q"]["kernel"])
    with torch.no_grad():
        h_lora = tbun.hidden_fn(tbase, tbatch, remat=False, lora=tlora,
                                lora_scale=tcfg.lora_scale)
        h_merged = tbun.hidden_fn(merged, tbatch, remat=False)
    np.testing.assert_allclose(h_lora.numpy(), h_merged.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_quantized_generation_runs():
    """int8 base, greedy f32 rollouts: the port's tokens equal JAX's."""
    from iadr1_tpu.train.rollout import RolloutEngine as JaxEngine
    from iadr1_tpu.train.rollout import SamplingConfig as JaxSampling
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig

    jbun, tbun = _bundles()
    jqp = jq.quantize_tree(jbun.init_params(jax.random.PRNGKey(0)))
    tqp = params_from_jax(jqp, device="cpu")
    kw = dict(max_new_tokens=4, temperature=0.0, eos_token_id=-1,
              pad_token_id=0)
    prompt = np.asarray([[5, 6, 7, 8], [0, 9, 10, 11]])
    mask = (prompt != 0).astype(np.int32)
    want = JaxEngine(jbun, JaxSampling(**kw), max_len=16,
                     cache_dtype=jnp.float32).generate(
        jqp, {"input_ids": jnp.asarray(prompt, jnp.int32),
              "attention_mask": jnp.asarray(mask)},
        jax.random.PRNGKey(0))["completion_ids"]
    got = RolloutEngine(tbun, SamplingConfig(**kw), max_len=16,
                        cache_dtype=torch.float32, device="cpu").generate(
        tqp, {"input_ids": torch.as_tensor(prompt),
              "attention_mask": torch.as_tensor(mask)})["completion_ids"]
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# GPTQ / AWQ import
# ---------------------------------------------------------------------------


def _pack_gptq(q, zeros, scales):
    """GPTQ packing: q uint4 [in, out] -> qweight int32 [in/8, out] (low
    nibble first); the zero point z stored as qzeros = z - 1."""
    in_dim, out = q.shape
    qweight = np.zeros((in_dim // 8, out), np.int64)
    for j in range(8):
        qweight |= q[j::8].astype(np.int64) << (4 * j)
    zm1 = (zeros - 1).astype(np.int64)
    qzeros = np.zeros((zeros.shape[0], out // 8), np.int64)
    for j in range(8):
        qzeros |= zm1[:, j::8] << (4 * j)
    return (qweight.astype(np.int32), qzeros.astype(np.int32),
            scales.astype(np.float16))


def _pack_awq(q, zeros, scales):
    """AWQ GEMM packing: columns interleaved [0, 2, 4, 6, 1, 3, 5, 7]."""
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    in_dim, out = q.shape
    qweight = np.zeros((in_dim, out // 8), np.int64)
    qzeros = np.zeros((zeros.shape[0], out // 8), np.int64)
    for j, col in enumerate(order):
        qweight |= q[:, col::8].astype(np.int64) << (4 * j)
        qzeros |= zeros[:, col::8].astype(np.int64) << (4 * j)
    return (qweight.astype(np.int32), qzeros.astype(np.int32),
            scales.astype(np.float16))


def _random_asym(in_dim, out, group, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (in_dim, out), np.uint8)
    nb = in_dim // group
    zeros = rng.integers(1, 15, (nb, out), np.uint8)
    scales = (rng.random((nb, out), np.float32) * 0.05 + 0.01)
    expected = ((q.reshape(nb, group, out).astype(np.float32)
                 - zeros[:, None].astype(np.float32))
                * scales[:, None]).reshape(in_dim, out)
    return q, zeros, scales, expected


def test_gptq_import_exact():
    q, zeros, scales, expected = _random_asym(32, 16, 8, seed=0)
    qweight, qzeros, qscales = _pack_gptq(q, zeros, scales)
    name = "model.layers.0.self_attn.q_proj."
    state = {name + "qweight": qweight, name + "qzeros": qzeros,
             name + "scales": qscales,
             name + "g_idx": (np.arange(32) // 8).astype(np.int32)}
    want = jio.convert_prequantized_state(dict(state))[name + "weight"]
    out = tio.convert_prequantized_state(
        {k: torch.as_tensor(v) for k, v in state.items()})
    got = out[name + "weight"]
    _same(want, got)
    assert tq.is_quantized(got)
    np.testing.assert_allclose(tq.dequantize_kernel(got).numpy(),
                               expected.astype(np.float16), atol=1e-3)
    assert not any(k.endswith(".qweight") for k in out)


def test_gptq_desc_act_rejected():
    q, zeros, scales, _ = _random_asym(32, 16, 8, seed=1)
    packed = _pack_gptq(q, zeros, scales)
    perm = (np.random.default_rng(0).permutation(32) // 8).astype(np.int32)
    for convert in (jio.gptq_layer_to_quant, tio.gptq_layer_to_quant):
        with pytest.raises(NotImplementedError, match="desc_act"):
            convert(*packed, g_idx=perm)


def test_awq_import_exact():
    q, zeros, scales, expected = _random_asym(32, 16, 8, seed=2)
    packed = _pack_awq(q, zeros, scales)
    got = tio.awq_layer_to_quant(*(torch.as_tensor(a) for a in packed))
    _same(jio.awq_layer_to_quant(*packed), got)
    np.testing.assert_allclose(tq.dequantize_kernel(got).numpy(),
                               expected.astype(np.float16), atol=1e-3)


def test_gptq_checkpoint_trains_lora(tmp_path):
    """A synthetic GPTQ Qwen2 checkpoint through load_safetensors_path and
    convert_hf: the port's stacked quant dicts equal JAX's, and one LoRA
    SFT step over it gives JAX's loss and grad norm (rtol 1e-4)."""
    from safetensors.numpy import save_file

    from iadr1_tpu.train import OptimizerConfig as JaxOptCfg
    from iadr1_tpu.train import make_optimizer as jax_make_optimizer
    from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
    from iadr1_tpu.train.state import create_train_state as jax_state
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.sft import make_chunked_sft_step
    from iadr1_tpu_torch.train.state import create_train_state

    hid, inter, vocab, L, group = 64, 96, 256, 2, 32
    rng = np.random.default_rng(3)
    state = {}
    shapes = {"self_attn.q_proj": (hid, hid), "self_attn.k_proj": (hid, 32),
              "self_attn.v_proj": (hid, 32), "self_attn.o_proj": (hid, hid),
              "mlp.gate_proj": (hid, inter), "mlp.up_proj": (hid, inter),
              "mlp.down_proj": (inter, hid)}
    for i in range(L):
        for j, (proj, (i_d, o_d)) in enumerate(shapes.items()):
            name = f"model.layers.{i}.{proj}"
            q, zeros, scales, _ = _random_asym(i_d, o_d, group,
                                               seed=10 * i + j)
            qw, qz, sc = _pack_gptq(q, zeros, scales)
            state.update({f"{name}.qweight": qw, f"{name}.qzeros": qz,
                          f"{name}.scales": sc, f"{name}.g_idx": (
                              np.arange(i_d) // group).astype(np.int32)})
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"model.layers.{i}.{norm}.weight"] = np.ones(hid,
                                                               np.float32)
    state["model.embed_tokens.weight"] = (
        rng.standard_normal((vocab, hid)).astype(np.float32) * 0.02)
    state["model.norm.weight"] = np.ones(hid, np.float32)
    save_file(state, str(tmp_path / "model.safetensors"))

    hf = dict(architectures=["Qwen2ForCausalLM"], vocab_size=vocab,
              hidden_size=hid, intermediate_size=inter, num_hidden_layers=L,
              num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
              tie_word_embeddings=True, attention_bias=False)
    jbun, tbun = _bundles(hf)
    jparams = jbun.convert_hf(jio.load_safetensors_path(str(tmp_path)))
    tparams = tbun.convert_hf(tio.load_safetensors_path(str(tmp_path)),
                              device="cpu")
    for group_name, name in (("mlp", "gate"), ("attn", "v")):
        _same(jparams["layers"][group_name][name]["kernel"],
              tparams["layers"][group_name][name]["kernel"])

    jcfg = jad.TuningConfig(finetuning_type="lora", lora_rank=4)
    jlora = jad.init_lora_params(jax.random.PRNGKey(0), jparams, jcfg)
    tlora = params_from_jax(jlora, device="cpu")
    scale = jcfg.lora_scale
    jbatch, tbatch = _batches(2, 32, vocab, seed=4, labels_from=8)
    opt_kw = dict(learning_rate=1e-2, total_steps=4, warmup_ratio=0.0)
    jopt, jsched = jax_make_optimizer(JaxOptCfg(**opt_kw))
    jstep = jax_step(
        lambda lp, b: jbun.hidden_fn(jparams, b, remat=False, lora=lp,
                                     lora_scale=scale),
        lambda _lp: jbun.head_kernel_fn(jparams), jopt, jsched,
        chunk_size=16)
    _, jm = jstep(jax_state(jlora, jopt), jbatch)
    topt, tsched = make_optimizer(OptimizerConfig(**opt_kw))
    tstep = make_chunked_sft_step(
        lambda lp, b: tbun.hidden_fn(tparams, b, remat=False, lora=lp,
                                     lora_scale=scale),
        lambda _lp: tbun.head_kernel_fn(tparams), topt, tsched,
        chunk_size=16)
    _, tm = tstep(create_train_state(tlora, topt), tbatch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4)
    assert float(tm["grad_norm"]) > 1e-8
