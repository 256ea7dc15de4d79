"""The port's tuning modes and adapters (iadr1_tpu_torch/train/adapters.py,
``lora_dense`` in models/qwen2.py) against the JAX package's, case by case
as tests/test_adapters.py drives the JAX side, then the LoRA paths of the
slice: SFT steps, an SC-GRPO step in reference-elision mode, a greedy
rollout, and the LoRA and QLoRA exports.

Tiny Qwen2 / Qwen2-VL configs, weights from JAX's ``init_params`` and
adapters from JAX's ``init_lora_params``, carried over with
``params_from_jax`` (the two packages draw different random numbers);
batches from numpy seeds.  Everything runs in f32 (FULL_PRECISION; JAX
with ``attention="xla"``, whose gradients are the reference since its
flash VJP drops the lse cotangent, ROADMAP C.R1).  Tolerances: hidden
states and gradients atol 2e-5 (f32 summation order only), losses and
metrics rtol 1e-4, parameters after AdamW steps at lr 1e-3 atol 1e-5
(the normalised step carries a relative gradient difference of ~1e-6 at
the learning rate's scale), PiSSA factors exactly (both run the same
float64 numpy), exports atol 1e-6.

One JAX hazard is pinned, ROADMAP C.R12: ``optax.masked`` passes a
frozen leaf's gradient through as its update, so under the JAX
``apply_tuning`` a frozen leaf that receives a gradient moves by +grad;
the port's ``MaskedOptimizer`` leaves it exactly as it is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import quant as jq
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.train import adapters as jad
from iadr1_tpu.train import optimizers as jopt
from iadr1_tpu.train.sft import make_chunked_sft_step as jax_step
from iadr1_tpu.train.state import create_train_state as jax_state
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.qwen2 import lora_dense
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.train import adapters as tad
from iadr1_tpu_torch.train import optimizers as topt
from iadr1_tpu_torch.train.sft import make_chunked_sft_step
from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

TEXT = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10000.0, tie_word_embeddings=True,
    architectures=["Qwen2ForCausalLM"],
)
VLM = dict(
    architectures=["Qwen2VLForConditionalGeneration"],
    text_config=dict(**{k: v for k, v in TEXT.items()
                        if k not in ("architectures", "num_hidden_layers")},
                     num_hidden_layers=2,
                     rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]}),
    vision_config=dict(depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, vision_start_token_id=5, vision_end_token_id=6,
)
# Adam's eps 1e-4: with 1e-8 an element whose gradient is nearly zero
# takes a full learning-rate step in the direction of its f32 summation
# noise (as tests/test_torch_grpo.py sets it)
OPT = dict(learning_rate=1e-3, total_steps=5, warmup_ratio=0.0, eps=1e-4)
ATOL = 2e-5


def _bundles(hf):
    return (jax_bundle(hf, attention="xla", precision=JAX_FULL),
            bundle_from_hf_config(hf, attention="xla",
                                  precision=FULL_PRECISION))


def _batch(B=2, T=32, vocab=128, seed=0):
    ids = np.random.default_rng(seed).integers(1, vocab, (B, T))
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    jb = {"input_ids": jnp.asarray(ids, jnp.int32),
          "labels": jnp.asarray(ids, jnp.int32),
          "segment_ids": jnp.ones((B, T), jnp.int32),
          "position_ids": jnp.asarray(pos, jnp.int32)}
    tb = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(ids),
          "segment_ids": torch.ones((B, T), dtype=torch.int32),
          "position_ids": torch.as_tensor(pos)}
    return jb, tb


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree}


def _close(got_tree, want_tree, atol, msg=""):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=atol, rtol=0, err_msg=f"{msg}{name}")


def _steps(jb, tb, jparams, tparams, n, jopt_wrap, topt_wrap, jhidden=None,
           thidden=None, jhead=None, thead=None, batch=None):
    """n chunked SFT steps in both packages from the same parameters;
    returns (JAX state, port state, [(jax metrics, port metrics)])."""
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**OPT))
    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    jo, to = jopt_wrap(jo), topt_wrap(to)
    jstep = jax.jit(jax_step(
        jhidden or (lambda p, b: jb.hidden_fn(p, b, remat=False)),
        jhead or jb.head_kernel_fn, jo, jsched, chunk_size=16))
    tstep = make_chunked_sft_step(
        thidden or (lambda p, b: tb.hidden_fn(p, b, remat=False)),
        thead or tb.head_kernel_fn, to, tsched, chunk_size=16)
    js, ts = jax_state(jparams, jo), create_train_state(tparams, to)
    jbatch, tbatch = batch or _batch()
    metrics = []
    for _ in range(n):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, tbatch)
        metrics.append((jm, tm))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4)
    return js, ts, metrics


# ---------------------------------------------------------------------------
# tests/test_adapters.py, case by case
# ---------------------------------------------------------------------------


def test_vision_tower_frozen():
    jb, tb = _bundles(VLM)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jparams, device="cpu")
    cfg = tad.TuningConfig(freeze_vision_tower=True)
    mask = tad.trainable_mask(tparams, cfg)
    assert _flat(mask) == _flat(jad.trainable_mask(jparams, jad.TuningConfig()))
    assert mask["vision"]["blocks"]["attn"]["qkv"]["kernel"] is False
    assert mask["vision"]["patch_embed"]["kernel"] is False
    assert mask["vision"]["merger"]["fc1"]["kernel"] is True
    assert mask["text"]["layers"]["attn"]["q"]["kernel"] is True
    before = {k: v.clone() for k, v in _flat(tparams).items()}
    js, ts, _ = _steps(
        jb, tb, jparams, tparams, 1,
        lambda o: jad.apply_tuning(o, jparams, jad.TuningConfig()),
        lambda o: tad.apply_tuning(o, tparams, cfg))
    after = _flat(ts.params)
    for name, was in before.items():            # the frozen tower stays
        if name.startswith("/vision") and "merger" not in name:
            assert torch.equal(after[name], was), name
    # the trainable leaves took JAX's step
    _close(ts.params["text"], js.params["text"], 1e-5)
    # the moments cover the trainable leaves alone
    n_trainable = sum(bool(m) for m in _flat(mask).values())
    assert len(ts.opt_state["mu"]) == n_trainable < len(before)


def test_layerwise_freeze():
    jb, tb = _bundles(TEXT)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jparams, device="cpu")
    jcfg = jad.TuningConfig(finetuning_type="freeze", freeze_trainable_layers=2)
    tcfg = tad.TuningConfig(finetuning_type="freeze", freeze_trainable_layers=2)
    before = {k: v.clone() for k, v in _flat(tparams).items()}
    js, ts, _ = _steps(jb, tb, jparams, tparams, 1,
                       lambda o: jad.apply_tuning(o, jparams, jcfg, 4),
                       lambda o: tad.apply_tuning(o, tparams, tcfg, 4))
    kern = ts.params["layers"]["mlp"]["gate"]["kernel"]
    was = before["/layers/mlp/gate/kernel"]
    # the first two layers frozen, the last two train, as JAX's
    assert torch.equal(kern[:2], was[:2]) and not torch.equal(kern[2:],
                                                              was[2:])
    np.testing.assert_allclose(
        kern.detach().numpy(),
        np.asarray(js.params["layers"]["mlp"]["gate"]["kernel"]), atol=1e-5)
    # C.R12: the frozen (tied) embedding receives a gradient; JAX's masked
    # optimizer adds it to the weights, the port leaves it as it was
    assert torch.equal(ts.params["embed"]["weight"], before["/embed/weight"])
    assert not np.allclose(np.asarray(js.params["embed"]["weight"]),
                           np.asarray(jparams["embed"]["weight"]))


def test_lora_training():
    """The merged route (``make_lora_forward``): 4 AdamW steps, JAX's loss
    and grad norm at every step, JAX's adapters after them."""
    jb, tb = _bundles(TEXT)
    jbase = jb.init_params(jax.random.PRNGKey(0))
    tbase = params_from_jax(jbase, device="cpu")
    jcfg = jad.TuningConfig(finetuning_type="lora", lora_rank=4)
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=4)
    jlora = jad.init_lora_params(jax.random.PRNGKey(1), jbase, jcfg)
    tlora = params_from_jax(jlora, device="cpu")
    assert len(tree_leaves(tlora)) == len(jax.tree.leaves(jlora)) > 0
    merged = tad.merge_lora(tbase, tlora, tcfg)      # B = 0: the base
    assert torch.equal(merged["layers"]["attn"]["q"]["kernel"],
                       tbase["layers"]["attn"]["q"]["kernel"])
    jfwd = jad.make_lora_forward(
        lambda p, b: jb.hidden_fn(p, b, remat=False), jbase, jcfg)
    tfwd = tad.make_lora_forward(
        lambda p, b: tb.hidden_fn(p, b, remat=False), tbase, tcfg)
    js, ts, metrics = _steps(
        jb, tb, jlora, tlora, 4, lambda o: o, lambda o: o, jfwd, tfwd,
        lambda _: jb.head_kernel_fn(jbase), lambda _: tb.head_kernel_fn(tbase))
    losses = [float(tm["loss"]) for _, tm in metrics]
    assert losses[-1] < losses[0]
    assert ts.params["layers"]["attn"]["q"]["kernel"]["b"].abs().max() > 0
    _close(ts.params, js.params, 1e-5)


def test_factored_lora_matches_merged_forward():
    hf = dict(TEXT, vocab_size=256, num_hidden_layers=2)
    jb, tb = _bundles(hf)
    jbase = jb.init_params(jax.random.PRNGKey(0))
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=4,
                            lora_alpha=8.0)
    jlora = jax.tree.map(lambda x: x + 0.03, jad.init_lora_params(
        jax.random.PRNGKey(1), jbase, jad.TuningConfig(
            finetuning_type="lora", lora_rank=4, lora_alpha=8.0)))
    tbase, tlora = (params_from_jax(t, device="cpu") for t in (jbase, jlora))
    jbatch, tbatch = _batch(T=16, vocab=250)
    scale = tcfg.lora_scale
    with torch.no_grad():
        h = tb.hidden_fn(tbase, tbatch, remat=False, lora=tlora,
                         lora_scale=scale)
        h_merged = tb.hidden_fn(tad.merge_lora(tbase, tlora, tcfg), tbatch,
                                remat=False)
        h_base = tb.hidden_fn(tbase, tbatch, remat=False)
    np.testing.assert_allclose(h.numpy(), h_merged.numpy(), atol=ATOL)
    want = jb.hidden_fn(jbase, jbatch, remat=False, lora=jlora,
                        lora_scale=scale)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=ATOL)
    assert not np.allclose(h.numpy(), h_base.numpy())


def test_dora_factored_norms_match_merged_oracle():
    from iadr1_tpu.models.qwen2 import _lora_dense as jax_lora_dense

    rng = np.random.default_rng(0)
    IN, OUT, R, B = 16, 12, 4, 5
    arrs = {"x": rng.standard_normal((B, IN)), "w": rng.standard_normal((IN, OUT)),
            "bias": rng.standard_normal(OUT),
            "a": rng.standard_normal((IN, R)) * 0.1,
            "b": rng.standard_normal((R, OUT)) * 0.1, "m": rng.random(OUT) + 0.5}
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arrs.items()}
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrs.items()}
    scale = 2.0
    got = lora_dense(t["x"], t["w"], t["bias"],
                     {k: t[k] for k in "abm"}, scale)
    merged = arrs["w"] + scale * arrs["a"] @ arrs["b"]
    want = ((arrs["x"] @ merged) * (arrs["m"] / np.sqrt((merged ** 2).sum(0)))
            + arrs["bias"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_lora_dense(
            j["x"], j["w"], j["bias"], {k: j[k] for k in "abm"}, scale)),
        atol=ATOL)
    # over a quantized base the norm reads the dequantized kernel
    qw = jq.quantize_kernel(j["w"], fmt="nf4", block_size=8)
    got_q = lora_dense(t["x"], params_from_jax(qw, device="cpu"), None,
                       {k: t[k] for k in "abm"}, scale)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(jax_lora_dense(
        j["x"], qw, None, {k: j[k] for k in "abm"}, scale)), atol=ATOL)


def test_dora_init_identity_and_trains():
    """At init (B = 0, m = ||W||) DoRA is the plain model; the gradients
    of m, A and B (the norm detached) are JAX's, to 1e-5 of each leaf's
    largest (through the remat path on the port's side)."""
    hf = dict(TEXT, hidden_size=32, intermediate_size=64, num_hidden_layers=2)
    jb, tb = _bundles(hf)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jparams, device="cpu")
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=4,
                            use_dora=True)
    own = tad.init_lora_params(torch.Generator().manual_seed(1), tparams,
                               tcfg)
    jlora = jad.init_lora_params(jax.random.PRNGKey(1), jparams,
                                 jad.TuningConfig(finetuning_type="lora",
                                                  lora_rank=4, use_dora=True))
    ab = tad._adapters_by_path(own)
    assert ab and all("m" in v for v in ab.values())
    # the magnitudes start at the column norms, as JAX's
    jab = tad._adapters_by_path(params_from_jax(jlora, device="cpu"))
    _close({k: v["m"] for k, v in ab.items()},
           {k: v["m"].numpy() for k, v in jab.items()}, 1e-6)
    jbatch, tbatch = _batch(T=16, seed=2)
    scale = tcfg.lora_scale
    with torch.no_grad():
        plain = tb.hidden_fn(tparams, tbatch, remat=False)
        dora0 = tb.hidden_fn(tparams, tbatch, remat=False, lora=own,
                             lora_scale=scale)
    np.testing.assert_allclose(dora0.numpy(), plain.numpy(), rtol=3e-5,
                               atol=3e-5)

    # gradients at a point away from init (B, m perturbed), against JAX
    jl = jax.tree.map(lambda x: x + 0.02, jlora)
    tl = params_from_jax(jl, device="cpu")
    leaves = tree_leaves(tl)
    for p in leaves:
        p.requires_grad_(True)
    # a linear read-out of the hidden states: sum(h * h) would cancel
    # its large terms in f32 and bury these small gradients in rounding
    r = np.random.default_rng(5).standard_normal(
        (2, 16, 32)).astype(np.float32)
    h = tb.hidden_fn(tparams, tbatch, remat=True, lora=tl, lora_scale=scale)
    grads = torch.autograd.grad((h * torch.as_tensor(r)).sum(), leaves)
    want = _flat(jax.jit(jax.grad(lambda lo: jnp.sum(jb.hidden_fn(
        jparams, jbatch, remat=False, lora=lo, lora_scale=scale) * r)))(jl))
    assert list(want) == list(_flat(tl))
    for g, (name, w) in zip(grads, want.items()):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    m_grads = [g for g, name in zip(grads, _flat(tl)) if name.endswith("/m")]
    assert m_grads and any(float(g.abs().max()) > 0 for g in m_grads)


def test_pissa_init_principal_components():
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((32, 6)), rng.standard_normal((6, 24))
    w = ((u * [50, 20, 10, 1, 0.5, 0.1]) @ v).astype(np.float32)
    jparams = {"layers": {"attn": {"q": {"kernel": jnp.asarray(w)}}}}
    tparams = {"layers": {"attn": {"q": {"kernel": torch.as_tensor(w)}}}}
    kw = dict(finetuning_type="lora", lora_rank=3, lora_alpha=6.0)
    jlora, jres = jad.pissa_init(jparams, jad.TuningConfig(**kw), niter=8)
    tlora, tres = tad.pissa_init(tparams, tad.TuningConfig(**kw), niter=8)
    # the same float64 numpy in both: exactly equal
    for got, want in ((tlora, jlora), (tres, jres)):
        for name, t in _flat(got).items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(_flat(want)[name]))
    ab = tlora["layers"]["attn"]["q"]["kernel"]
    res = tres["layers"]["attn"]["q"]["kernel"].numpy()
    recon = res + tad.TuningConfig(**kw).lora_scale * (ab["a"] @ ab["b"]).numpy()
    np.testing.assert_allclose(recon, w, rtol=1e-4, atol=1e-4)
    s = np.linalg.svd(w, compute_uv=False)
    assert np.linalg.norm(res) <= np.sqrt((s[3:] ** 2).sum()) * 1.05
    with pytest.raises(ValueError, match="use_dora"):
        tad.pissa_init(tparams, tad.TuningConfig(finetuning_type="lora",
                                                 use_dora=True,
                                                 pissa_init=True))


def test_resize_embeddings():
    rng = np.random.default_rng(0)
    old_v, dim = 100, 16
    embed = torch.as_tensor(rng.standard_normal((old_v, dim)),
                            dtype=torch.float32)
    head = torch.as_tensor(rng.standard_normal((dim, old_v)),
                           dtype=torch.float32)
    params = {"embed": {"weight": embed}, "lm_head": {"kernel": head}}
    gen = torch.Generator().manual_seed(0)
    out, padded = tad.resize_embeddings(params, 130, gen)
    jout, jpadded = jad.resize_embeddings(
        {"embed": {"weight": jnp.asarray(embed.numpy())},
         "lm_head": {"kernel": jnp.asarray(head.numpy())}},
        130, jax.random.PRNGKey(0))
    assert padded == jpadded == 192
    assert out["embed"]["weight"].shape == jout["embed"]["weight"].shape
    assert out["lm_head"]["kernel"].shape == (dim, 192)
    assert torch.equal(out["embed"]["weight"][:old_v], embed)
    assert torch.equal(out["lm_head"]["kernel"][:, :old_v], head)
    np.testing.assert_allclose(out["embed"]["weight"][old_v:].mean(0).numpy(),
                               embed.mean(0).numpy(), atol=0.3)
    same, v = tad.resize_embeddings(params, 80, gen)
    assert v == old_v and same is params
    nested = {"text": params, "vision": {"x": torch.zeros(3)}}
    out2, _ = tad.resize_embeddings(nested, 130, gen)
    assert out2["text"]["embed"]["weight"].shape == (192, dim)
    assert out2["vision"]["x"].shape == (3,)


def test_pissa_convert_roundtrip():
    w = np.random.default_rng(1).standard_normal((20, 14)).astype(np.float32)
    kw = dict(finetuning_type="lora", lora_rank=3, lora_alpha=6.0)
    jlora0, jres = jad.pissa_init({"attn": {"q": {"kernel": jnp.asarray(w)}}},
                                  jad.TuningConfig(**kw), niter=6)
    lora0, residual = tad.pissa_init(
        {"attn": {"q": {"kernel": torch.as_tensor(w)}}},
        tad.TuningConfig(**kw), niter=6)
    noise = np.random.default_rng(2)
    trained = {"attn": {"q": {"kernel": {
        k: v + 0.1 * torch.as_tensor(noise.standard_normal(v.shape),
                                     dtype=v.dtype)
        for k, v in lora0["attn"]["q"]["kernel"].items()}}}}
    converted = tad.pissa_convert(trained, lora0)
    jconverted = jad.pissa_convert(
        {"attn": {"q": {"kernel": {k: jnp.asarray(v.numpy()) for k, v in
                                   trained["attn"]["q"]["kernel"].items()}}}},
        jlora0)
    ab = converted["attn"]["q"]["kernel"]
    assert ab["a"].shape == (20, 6) and ab["b"].shape == (6, 14)
    for k in ("a", "b"):
        np.testing.assert_array_equal(
            ab[k].numpy(), np.asarray(jconverted["attn"]["q"]["kernel"][k]))
    scale = tad.TuningConfig(**kw).lora_scale
    tab = trained["attn"]["q"]["kernel"]
    eff_trained = (residual["attn"]["q"]["kernel"]
                   + scale * tab["a"] @ tab["b"]).numpy()
    np.testing.assert_allclose(w + scale * (ab["a"] @ ab["b"]).numpy(),
                               eff_trained, rtol=1e-5, atol=1e-5)
    merged = tad.merge_lora({"attn": {"q": {"kernel": torch.as_tensor(w)}}},
                            converted,
                            tad.TuningConfig(finetuning_type="lora",
                                             lora_rank=6, lora_alpha=12.0))
    np.testing.assert_allclose(merged["attn"]["q"]["kernel"].numpy(),
                               eff_trained, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant,dora", [("none", False), ("none", True),
                                        ("int8", False), ("nf4", False)],
                         ids=["lora", "dora", "int8", "nf4"])
def test_in_place_merge_matches_jax(quant, dora):
    """merge_lora(inplace=True), the export's merge: each layer-stacked
    kernel is merged one layer at a time, over its dense base (the very
    tensor) or in place of its quant dict; the result equals the JAX
    package's merge of the same tree to 1e-6."""
    from iadr1_tpu_torch.models.quant import quantize_tree

    rng = np.random.default_rng(11)
    jparams = {"layers": {name: {"kernel": jnp.asarray(
        0.05 * rng.standard_normal((3, 64, 48)), jnp.float32)}
        for name in ("up", "down")}, "norm": jnp.ones((3, 64))}
    tparams = params_from_jax(jparams, device="cpu")
    if quant != "none":
        tparams = quantize_tree(tparams, fmt=quant)
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    kw = dict(finetuning_type="lora", lora_rank=4, lora_alpha=8.0,
              use_dora=dora)
    jlora = jax.tree.map(lambda x: x + 0.02, jad.init_lora_params(
        jax.random.PRNGKey(5), jparams, jad.TuningConfig(**kw)))
    before = tparams["layers"]["up"]["kernel"]
    got = tad.merge_lora(tparams, params_from_jax(jlora, device="cpu"),
                         tad.TuningConfig(**kw), inplace=True)
    want = jad.merge_lora(jparams, jlora, jad.TuningConfig(**kw))
    for name in ("up", "down"):
        np.testing.assert_allclose(
            got["layers"][name]["kernel"].numpy(),
            np.asarray(want["layers"][name]["kernel"]), atol=1e-6, rtol=0)
    assert (got["layers"]["up"]["kernel"] is before) == (quant == "none")
    assert got["norm"] is tparams["norm"]


# ---------------------------------------------------------------------------
# the slice's LoRA paths
# ---------------------------------------------------------------------------


def _vlm_lora(rank=4, dora=False, add=0.0):
    """A tiny Qwen2-VL base and a LoRA tree over it (vision adapters
    included, as JAX makes them), JAX's and the port's."""
    jb, tb = _bundles(VLM)
    jbase = jb.init_params(jax.random.PRNGKey(0))
    jcfg = jad.TuningConfig(finetuning_type="lora", lora_rank=rank,
                            use_dora=dora)
    jlora = jad.init_lora_params(jax.random.PRNGKey(1), jbase, jcfg)
    if add:
        jlora = jax.tree.map(lambda x: x + add, jlora)
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=rank,
                            use_dora=dora)
    return (jb, tb, jbase, params_from_jax(jbase, device="cpu"), jlora,
            params_from_jax(jlora, device="cpu"), tcfg)


@pytest.mark.parametrize("dora", [False, True], ids=["lora", "dora"])
def test_lora_sft_steps_match_jax(dora):
    """3 factored LoRA (DoRA) SFT steps on Qwen2-VL through the port's
    AdamW (the port with its default remat, JAX without): loss and grad
    norm at every step, the adapters after them; the base is untouched,
    and the optimizer holds moments for the adapters alone."""
    jb, tb, jbase, tbase, jlora, tlora, tcfg = _vlm_lora(dora=dora)
    assert len(tree_leaves(tlora)) == len(jax.tree.leaves(jlora))
    scale = tcfg.lora_scale
    before = [t.clone() for t in tree_leaves(tbase)]
    js, ts, metrics = _steps(
        jb, tb, jlora, tlora, 3, lambda o: o, lambda o: o,
        lambda lo, b: jb.hidden_fn(jbase, b, remat=False, lora=lo,
                                   lora_scale=scale),
        lambda lo, b: tb.hidden_fn(tbase, b, lora=lo, lora_scale=scale),
        lambda _: jb.head_kernel_fn(jbase), lambda _: tb.head_kernel_fn(tbase))
    assert float(metrics[-1][1]["loss"]) < float(metrics[0][1]["loss"])
    _close(ts.params, js.params, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tbase), before))
    assert len(ts.opt_state["mu"]) == len(tree_leaves(tlora))


class _LoraReplayEngine:
    """The port trainer's engine, replaced: checks that it is handed the
    frozen base and the adapters, and returns a recorded rollout."""

    def __init__(self, recorded, base):
        self.recorded, self.base, self.calls = recorded, base, 0

    def generate(self, params, batch, generator=None, group_size=1,
                 lora=None):
        self.calls += 1
        assert params is self.base and lora is not None
        assert not any(p.requires_grad for p in tree_leaves(lora))
        return {k: torch.as_tensor(v) for k, v in self.recorded.items()}


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "dense"])
def test_lora_grpo_step_with_reference_elision_matches_jax(shared):
    """One SC-GRPO trainer step in LoRA mode (the base rides the reference
    slot, the policy is base + factored adapters, the KL reference the bare
    base) on a recorded JAX rollout: every metric and every adapter after
    the step (tests/test_torch_grpo.py's tolerances); the base is the same
    tensors, unchanged, and the state holds the adapters alone."""
    from test_torch_grpo import (
        EOS,
        OPT as GRPO_OPT,
        RecordingEngine,
        Tok,
        _assert_metrics_close,
        solution_reward,
        vowel_reward,
    )

    from iadr1_tpu.train import grpo as jgrpo
    from iadr1_tpu_torch.train import grpo as tgrpo

    hf = dict(TEXT, vocab_size=600, num_hidden_layers=2)
    jb, tb = _bundles(hf)
    jbase = jb.init_params(jax.random.PRNGKey(1))
    tbase = params_from_jax(jbase, device="cpu")
    jcfg = jad.TuningConfig(finetuning_type="lora", lora_rank=4)
    tcfg = tad.TuningConfig(finetuning_type="lora", lora_rank=4)
    # B away from zero, so that the policy starts off the reference
    jlora = jax.tree.map(lambda x: x + 0.01, jad.init_lora_params(
        jax.random.PRNGKey(2), jbase, jcfg))
    kw = dict(num_generations=2, beta=0.04, temperature=1.0, top_k=0,
              top_p=1.0, max_prompt_length=12, max_completion_length=4,
              logp_chunk_size=8, shared_prompt_scoring=shared, remat=False)
    examples = [{"prompt_ids": [5, 6, 7, 8, 9, 10], "solution": "a"},
                {"prompt_ids": [11, 12, 13], "solution": "b"}]
    rewards = [vowel_reward, solution_reward]
    tlora = params_from_jax(jlora, device="cpu")     # JAX donates its state
    jo, jsched = jopt.make_optimizer(jopt.OptimizerConfig(**GRPO_OPT))
    jt = jgrpo.GRPOTrainer(
        jb, Tok(), jo, jgrpo.GRPOConfig(**kw), rewards,
        jax_state(jlora, jo), {}, schedule=jsched, base_params=jbase,
        tuning_cfg=jcfg)
    jt.engine = RecordingEngine(jt.engine)
    jm = jt.step(examples)

    to, tsched = topt.make_optimizer(topt.OptimizerConfig(**GRPO_OPT))
    before = [t.clone() for t in tree_leaves(tbase)]
    tt = tgrpo.GRPOTrainer(
        tb, Tok(), to, tgrpo.GRPOConfig(**kw), rewards,
        create_train_state(tlora, to), None,
        schedule=tsched, base_params=tbase, tuning_cfg=tcfg, device="cpu")
    assert tt.ref_params is tbase and tt._shared == shared
    tt.engine = _LoraReplayEngine(jt.engine.out, tbase)
    tm = tt.step(examples)
    assert tt.engine.calls == 1 and EOS in jt.engine.out["completion_ids"]
    _assert_metrics_close(tm, jm, "lora")
    assert float(tm["kl"]) > 0
    _close(tt.state.params, jt.state.params, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tbase), before))
    assert tree_leaves(tt.state.params) and not any(
        any(p is b for b in tree_leaves(tbase))
        for p in tree_leaves(tt.state.params))


def test_lora_greedy_rollout_is_token_identical_to_jax():
    """RolloutEngine.generate(base, ..., lora=) in f32 (prefill, grouped
    decode): the JAX engine's tokens; without the adapters the tokens
    differ."""
    from iadr1_tpu.train.rollout import RolloutEngine as JaxEngine
    from iadr1_tpu.train.rollout import SamplingConfig as JaxSampling
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig

    hf = dict(TEXT, vocab_size=600, num_hidden_layers=2)
    jb, tb = _bundles(hf)
    jbase = jb.init_params(jax.random.PRNGKey(0))
    jlora = jax.tree.map(lambda x: x + 0.05, jad.init_lora_params(
        jax.random.PRNGKey(1), jbase, jad.TuningConfig(
            finetuning_type="lora", lora_rank=4)))
    scale = tad.TuningConfig(finetuning_type="lora", lora_rank=4).lora_scale
    kw = dict(max_new_tokens=6, temperature=0.0, eos_token_id=-1,
              pad_token_id=0)
    prompt = np.asarray([[5, 6, 7, 8, 9], [0, 0, 10, 11, 12]])
    mask = (prompt != 0).astype(np.int32)
    want = JaxEngine(jb, JaxSampling(**kw), max_len=16,
                     cache_dtype=jnp.float32, lora_scale=scale).generate(
        jbase, {"input_ids": jnp.asarray(prompt, jnp.int32),
                "attention_mask": jnp.asarray(mask)},
        jax.random.PRNGKey(0), lora=jlora, group_size=2)
    engine = RolloutEngine(tb, SamplingConfig(**kw), max_len=16,
                           cache_dtype=torch.float32, device="cpu",
                           lora_scale=scale)
    batch = {"input_ids": torch.as_tensor(prompt),
             "attention_mask": torch.as_tensor(mask)}
    tbase = params_from_jax(jbase, device="cpu")
    got = engine.generate(tbase, batch, group_size=2,
                          lora=params_from_jax(jlora, device="cpu"))
    np.testing.assert_array_equal(got["completion_ids"].numpy(),
                                  np.asarray(want["completion_ids"]))
    plain = engine.generate(tbase, batch, group_size=2)
    assert not torch.equal(plain["completion_ids"], got["completion_ids"])


@pytest.fixture(scope="module")
def tiny_base(tmp_path_factory):
    from helpers import build_tiny_vlm_checkpoint

    from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
    from iadr1_tpu.models.registry import (
        bundle_from_pretrained as jax_from_pretrained,
    )

    base = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("base")))
    jb = jax_from_pretrained(base, attention="xla")
    return base, jb, jb.convert_hf(jax_load(base))


@pytest.mark.parametrize("quant", ["none", "int4"], ids=["lora", "qlora"])
def test_export_run_merges_as_jax(quant, tiny_base, tmp_path):
    """export_run of a LoRA (QLoRA) GRPO run on a tiny Qwen2-VL checkpoint:
    the port's checkpoint holds the adapters alone; the export equals the
    JAX package's merge of the same adapters into the same base (quantized
    as training quantized it, the rest dequantized to bf16), exported by
    its ``export_params``, to 1e-6; and the JAX package loads it."""
    from safetensors.numpy import load_file

    from iadr1_tpu.models.params_export import export_params as jax_export
    from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
    from iadr1_tpu.models.registry import (
        bundle_from_pretrained as jax_from_pretrained,
    )
    from iadr1_tpu_torch.cli.pipeline import export_run
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager

    from iadr1_tpu_torch.models.quant import quantize_tree

    base, jb, jparams = tiny_base
    if quant != "none":
        # the port's quantization, bit for bit JAX's (test_torch_quant.py),
        # handed to the JAX merge as arrays: JAX's own compiles per shape
        jparams = jax.tree.map(
            lambda t: jnp.asarray(t.numpy()),
            quantize_tree(params_from_jax(jparams, device="cpu"), fmt=quant))
    finetuning = {"finetuning_type": "lora", "lora_rank": 4,
                  "lora_alpha": 8.0}
    jcfg = jad.TuningConfig(**finetuning)
    jlora = jax.tree.map(lambda x: x + 0.02, jad.init_lora_params(
        jax.random.PRNGKey(3), jparams, jcfg))
    tlora = params_from_jax(jlora, device="cpu")
    to, _ = topt.make_optimizer(topt.OptimizerConfig())
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(2, create_train_state(tlora, to))
    out = export_run(base, ckpt_dir, str(tmp_path / "out"),
                     finetuning=finetuning, quant=quant, device="cpu")
    merged = jad.merge_lora(jparams, jlora, jcfg)
    if quant != "none":
        merged = jq.dequantize_tree(merged, jnp.bfloat16)
    want = jax_export(jb, merged)
    got = load_file(f"{out}/model.safetensors")
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].astype(np.float32), w,
                                   atol=1e-6, rtol=0, err_msg=name)
    jax_from_pretrained(out).convert_hf(jax_load(out))
