"""The port's shared-prompt GRPO scoring (models/shared_prompt.py, the lse
dispatch of models/attention.py, the bundles' ``shared_pred_fn``) against
the JAX package and against the port's own dense path, on the CPU in f32
(FULL_PRECISION).

Inputs come from a seed through numpy; parameters come from JAX's
``init_params`` through ``params_from_jax``.  The batches have left padding
and rollouts that stop early, so completion rows after EOS are empty on
both sides of the merge (lse = +inf from the flash twin, -inf from the
dense oracle) in every layer.  The JAX side runs ``attention="xla"``: its
flash VJP drops the lse cotangent, so its flash gradients are not a
reference.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.kernels.flash_attention import (
    BlockSizes,
    flash_attention_with_lse,
)
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.models.shared_prompt import _merge_attention as jax_merge
from iadr1_tpu.train.grpo import chunked_token_logps as jax_token_logps
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models.attention import default_attention_with_lse
from iadr1_tpu_torch.models.params_io import params_from_jax
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.models.shared_prompt import merge_attention
from iadr1_tpu_torch.train.grpo import (
    bundle_score_fn,
    chunked_token_logps,
    completion_logps,
)
from iadr1_tpu_torch.train.sft import batch_to_device
from iadr1_tpu_torch.train.state import tree_leaves
from iadr1_tpu_torch.vision.mrope import get_mrope_positions
import torch_threads  # noqa: F401  (one intra-op thread)

TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, tie_word_embeddings=True)
QWEN2 = dict(TEXT, architectures=["Qwen2ForCausalLM"])
VLM = dict(
    architectures=["Qwen2VLForConditionalGeneration"],
    text_config=dict(TEXT, num_hidden_layers=2,
                     rope_scaling={"type": "mrope",
                                   "mrope_section": [4, 6, 6]}),
    vision_config=dict(depth=2, embed_dim=32, hidden_size=64, num_heads=4,
                       patch_size=14, spatial_merge_size=2,
                       temporal_patch_size=2),
    image_token_id=7, video_token_id=8,
    vision_start_token_id=5, vision_end_token_id=6,
)
CHUNK = 8
INF = float("inf")


# ---------------------------------------------------------------------------
# the merge and the lse dispatch
# ---------------------------------------------------------------------------


def _merge_inputs(seed=0):
    """Two partial attentions [2, 3, 6, 8] whose lses hold rows empty on
    the first side (+inf and -inf), on the second, and on both."""
    rng = np.random.default_rng(seed)
    o1, o2 = (rng.standard_normal((2, 3, 6, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 6)).astype(np.float32) * 3
              for _ in range(2))
    l1[0, :, 1], l1[1, :, 2] = INF, -INF        # empty on the first side
    l2[0, :, 3], l2[1, :, 4] = INF, -INF        # empty on the second
    l1[:, :, 5], l2[:, :, 5] = INF, -INF        # empty on both
    l1[1, 0, 0], l2[1, 0, 0] = INF, INF
    o1[~np.isfinite(l1)] = 0.0
    o2[~np.isfinite(l2)] = 0.0
    return o1, l1, o2, l2


def test_merge_attention_matches_jax():
    """atol 1e-6 (f32, the same operations in the same order)."""
    o1, l1, o2, l2 = _merge_inputs()
    want = np.asarray(jax_merge(*(jnp.asarray(a) for a in (o1, l1, o2, l2))))
    got = merge_attention(*(torch.from_numpy(a) for a in (o1, l1, o2, l2)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    both = ~np.isfinite(l1) & ~np.isfinite(l2)
    assert both.any() and np.all(got.numpy()[both] == 0)


def test_merge_attention_backward_is_finite_on_empty_rows():
    """A +inf lse must not reach exp(): the select after it would send
    0 * inf = NaN back.  Gradients of every input are finite, zero for the
    lses of empty sides, and equal autograd of the JAX merge (atol 1e-6)."""
    arrays = _merge_inputs(1)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        arrays[0].shape).astype(np.float32))
    grads = torch.autograd.grad((merge_attention(*leaves) * w).sum(), leaves)
    want = jax.grad(lambda *a: (jax_merge(*a) * jnp.asarray(w.numpy())).sum(),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    for g, j, a in zip(grads, want, arrays):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6, rtol=0)
    for g, lse in ((grads[1], arrays[1]), (grads[3], arrays[3])):
        assert np.all(g.numpy()[~np.isfinite(lse)] == 0)


def _cross_inputs(seed=3, B=2, H=4, Hkv=2, T=72, S=136, D=64):
    """The cross call's shape: T != S, kv ids left-padded, q ids with
    trailing zeros (rows after EOS)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q_seg = np.ones((B, T), np.int32)
    q_seg[0, 50:], q_seg[1, 9:] = 0, 0
    kv_seg = np.ones((B, S), np.int32)
    kv_seg[0, :40], kv_seg[1, :3] = 0, 0
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("kind", ["flash", "auto", "xla"])
def test_lse_dispatch_matches_pallas_forward(kind):
    """(out, lse) of the dispatch on the CPU against the Pallas flash
    forward in interpret mode, non-causal at T != S: atol 2e-5 on the rows
    with a valid key.  Rows with none are the port's to define (the Pallas
    kernel leaves a large negative finite lse there): out 0, and lse +inf
    from the flash wrapper, -inf from the dense oracle."""
    q, k, v, q_seg, kv_seg = _cross_inputs()
    out_j, lse_j = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg),
        causal=False, blocks=BlockSizes(*([64] * 6)), interpret=True)
    qs, ks = torch.from_numpy(q_seg), torch.from_numpy(kv_seg)
    mask = ((qs[:, :, None] == ks[:, None, :]) & (ks[:, None, :] != 0))[:, None]
    out, lse = default_attention_with_lse(kind)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=mask, q_segments=qs, kv_segments=ks, causal=False)
    rows = np.broadcast_to((q_seg != 0)[:, None, :], lse.shape)
    assert lse.dtype == torch.float32 and (~rows).any()
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(out_j)[rows],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy()[rows], np.asarray(lse_j)[rows],
                               atol=2e-5, rtol=0)
    assert np.all(out.numpy()[~rows] == 0)
    if kind == "xla":
        assert np.all(np.isneginf(lse.numpy()[~rows]))
    else:
        assert np.all(np.isposinf(lse.numpy()[~rows]))


def test_lse_dispatch_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown attention kind"):
        default_attention_with_lse("dense")


# ---------------------------------------------------------------------------
# the factored forward against JAX and against the dense path
# ---------------------------------------------------------------------------


def _text_case(seed=0, n=2, G=2, P=12, N=6):
    """The shapes of the JAX package's shared-prompt test: left padding on
    the second prompt, two rollouts with an early EOS."""
    rng = np.random.default_rng(seed)
    prompt_ids = np.zeros((n, P), np.int64)
    prompt_segs = np.zeros((n, P), np.int64)
    for i, L in enumerate([P, P - 4]):
        prompt_ids[i, P - L:] = rng.integers(2, 250, L)
        prompt_segs[i, P - L:] = 1
    comp_ids = rng.integers(2, 250, (n * G, N))
    comp_mask = np.ones((n * G, N), np.int64)
    comp_mask[1, 4:] = 0
    comp_mask[3, 2:] = 0
    comp_pos = (np.repeat(prompt_segs.sum(1), G)[:, None] + np.arange(N)[None])
    shared = {
        "prompt_ids": prompt_ids, "prompt_segments": prompt_segs,
        "prompt_positions": np.clip(np.cumsum(prompt_segs, 1) - 1, 0, None),
        "completion_ids": comp_ids, "completion_mask": comp_mask,
        "completion_positions": comp_pos,
    }
    full_segs = np.concatenate([np.repeat(prompt_segs, G, 0), comp_mask], 1)
    dense = {
        "input_ids": np.concatenate([np.repeat(prompt_ids, G, 0), comp_ids], 1),
        "segment_ids": full_segs,
        "position_ids": np.clip(np.cumsum(full_segs, 1) - 1, 0, None),
        "completion_ids": comp_ids, "completion_mask": comp_mask,
        "prompt_len": P,
    }
    return shared, dense


def _vlm_case(bundle, seed=0, n=2, G=2, P=24, N=5):
    """Two prompts of one 4x4-patch image each (4 features), the second
    left-padded by 4; M-RoPE grids; two rollouts with an early EOS."""
    rng = np.random.default_rng(seed)
    grid, n_feats = (1, 4, 4), 4
    prompt_ids = np.zeros((n, P), np.int64)
    prompt_segs = np.zeros((n, P), np.int64)
    for i in range(n):
        L = P - 4 * i
        row = ([1, 5] + [7] * n_feats + [6]
               + rng.integers(10, 250, L - 3 - n_feats).tolist())
        prompt_ids[i, P - L:] = row
        prompt_segs[i, P - L:] = 1
    patches = [rng.standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
               for _ in range(n)]
    comp_ids = rng.integers(10, 250, (n * G, N))
    comp_mask = np.ones((n * G, N), np.int64)
    comp_mask[0, 3:] = 0
    comp_mask[3, 1:] = 0

    def collate(ids, segs, patch_list):
        pos, deltas = get_mrope_positions(
            ids, np.asarray([grid] * len(patch_list)), 7, 5,
            attention_mask=segs)
        return pos, deltas, bundle.vision_arrays(
            ids, patch_list, [grid] * len(patch_list), 16 * len(patch_list))

    steps = np.arange(N)[None, :]
    pos_u, deltas_u, arrays_u = collate(prompt_ids, prompt_segs, patches)
    shared = {
        "prompt_ids": prompt_ids, "prompt_segments": prompt_segs,
        "prompt_positions": pos_u,
        "completion_ids": comp_ids, "completion_mask": comp_mask,
        "completion_positions": np.broadcast_to(
            P + np.repeat(deltas_u, G)[:, None] + steps, (3, n * G, N)).copy(),
        **arrays_u,
    }
    rep_ids, rep_segs = np.repeat(prompt_ids, G, 0), np.repeat(prompt_segs, G, 0)
    pos_r, deltas_r, arrays_r = collate(
        rep_ids, rep_segs, [p for p in patches for _ in range(G)])
    comp_pos = np.broadcast_to(P + deltas_r[:, None] + steps, (3, n * G, N))
    dense = {
        "input_ids": np.concatenate([rep_ids, comp_ids], 1),
        "segment_ids": np.concatenate([rep_segs, comp_mask], 1),
        "position_ids": np.concatenate([pos_r, comp_pos], -1),
        "completion_ids": comp_ids, "completion_mask": comp_mask,
        "prompt_len": P, **arrays_r,
    }
    return shared, dense


@functools.lru_cache(maxsize=None)
def _setup(family: str) -> dict:
    hf = VLM if family == "qwen2_vl" else QWEN2
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    bundles = {kind: bundle_from_hf_config(hf, attention=kind,
                                           precision=FULL_PRECISION)
               for kind in ("xla", "flash")}
    shared, dense = (_vlm_case(bundles["xla"]) if family == "qwen2_vl"
                     else _text_case())
    return dict(jb=jb, bundles=bundles, shared=shared, dense=dense,
                jparams=jb.init_params(jax.random.PRNGKey(0)), G=2)


@pytest.fixture(params=["qwen2", "qwen2_vl"])
def setup(request):
    return _setup(request.param)


def _to_torch(batch):
    out = batch_to_device({k: v for k, v in batch.items()
                           if k != "prompt_len"}, "cpu")
    if "prompt_len" in batch:
        out["prompt_len"] = batch["prompt_len"]
    return out


def _shared_logps(bundle, params, batch, G, remat=False):
    pred = bundle.shared_pred_fn(params, batch, G, remat=remat)
    return chunked_token_logps(pred, bundle.head_kernel_fn(params),
                               batch["completion_ids"], CHUNK)


@pytest.mark.parametrize("kind", ["xla", "flash"])
def test_shared_logps_match_jax(setup, kind):
    """shared_pred_fn -> chunked_token_logps against the JAX functions on
    the same parameters and batch: atol 2e-4, rtol 1e-4 on the unmasked
    positions (the JAX package's own bound for shared against dense)."""
    jb, G = setup["jb"], setup["G"]
    jbatch = {k: jnp.asarray(v) for k, v in setup["shared"].items()}
    want = np.asarray(jax_token_logps(
        jb.shared_pred_fn(setup["jparams"], jbatch, G, remat=False),
        jb.head_kernel_fn(setup["jparams"]), jbatch["completion_ids"], CHUNK))
    params = params_from_jax(setup["jparams"], device="cpu")
    with torch.no_grad():
        got = _shared_logps(setup["bundles"][kind], params,
                            _to_torch(setup["shared"]), G).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    m = setup["shared"]["completion_mask"].astype(bool)
    np.testing.assert_allclose(got[m], want[m], atol=2e-4, rtol=1e-4)


def _weighted_grads(logps_fn, params, batch):
    """Gradients of a seeded weighting of the unmasked logps."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    lp = logps_fn(params, batch)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(lp.shape)).astype(np.float32))
    loss = (lp * w * batch["completion_mask"]).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return lp.detach(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("kind", ["xla", "flash"])
def test_shared_path_matches_dense_path(setup, kind):
    """The port's factored path against its own dense path on the
    G-repeated batch, with the dense oracle and with the flash Function
    (the twin on the CPU: its written-out backward takes dlse != 0 from
    the merge).  Logps atol 2e-5 on unmasked positions; the gradient of
    every parameter to 1e-5 of that gradient's largest entry, and finite."""
    bundle, G = setup["bundles"][kind], setup["G"]
    params = params_from_jax(setup["jparams"], device="cpu")
    lp_d, g_dense = _weighted_grads(
        lambda p, b: completion_logps(bundle_score_fn(bundle, remat=False),
                                      p, b, CHUNK),
        params, _to_torch(setup["dense"]))
    lp_s, g_shared = _weighted_grads(
        lambda p, b: _shared_logps(bundle, p, b, G),
        params, _to_torch(setup["shared"]))
    m = torch.from_numpy(setup["shared"]["completion_mask"].astype(bool))
    assert (~m).any()
    torch.testing.assert_close(lp_s[m], lp_d[m], atol=2e-5, rtol=0)
    assert any(float(g.abs().max()) > 0 for g in g_dense)
    for g, w in zip(g_shared, g_dense):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(
            g, w, atol=1e-5 * max(float(w.abs().max()), 1e-3), rtol=0)


@pytest.mark.parametrize("kind", ["xla", "flash"])
@pytest.mark.parametrize("mode", [True, "save_flash", "full"])
def test_shared_remat_modes_give_the_same_gradients(setup, kind, mode):
    """Each remat mode against no remat: the same arithmetic replayed, so
    atol 1e-6 (f32)."""
    bundle, G = setup["bundles"][kind], setup["G"]
    params = params_from_jax(setup["jparams"], device="cpu")
    batch = _to_torch(setup["shared"])
    _, base = _weighted_grads(
        lambda p, b: _shared_logps(bundle, p, b, G, remat=False), params, batch)
    _, got = _weighted_grads(
        lambda p, b: _shared_logps(bundle, p, b, G, remat=mode), params, batch)
    for g, w in zip(got, base):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_shared_prompt_rejects_an_unknown_remat_mode():
    s = _setup("qwen2")
    params = params_from_jax(s["jparams"], device="cpu")
    with pytest.raises(ValueError, match="unknown remat mode"):
        s["bundles"]["xla"].shared_pred_fn(params, _to_torch(s["shared"]), 2,
                                           remat="save_qkv")


def test_last_valid_prompt_position_under_right_padding():
    """The prediction of completion token 0 reads the prompt's last VALID
    hidden state: with right padding that is not column P-1, and a row of
    equal flags must not pick another index.  Against the JAX function,
    atol 2e-5."""
    s = _setup("qwen2")
    batch = dict(s["shared"])
    segs = np.ones_like(batch["prompt_segments"])
    segs[1, -5:] = 0                                   # right padding
    batch["prompt_segments"] = segs
    batch["prompt_positions"] = np.clip(np.cumsum(segs, 1) - 1, 0, None)
    jb = s["jb"]
    want = np.asarray(jb.shared_pred_fn(
        s["jparams"], {k: jnp.asarray(v) for k, v in batch.items()}, 2,
        remat=False))
    params = params_from_jax(s["jparams"], device="cpu")
    with torch.no_grad():
        got = s["bundles"]["xla"].shared_pred_fn(params, _to_torch(batch), 2,
                                                 remat=False).numpy()
    m = batch["completion_mask"].astype(bool)
    np.testing.assert_allclose(got[m], want[m], atol=2e-5, rtol=0)
