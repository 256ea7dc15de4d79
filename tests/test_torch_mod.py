"""Mixture-of-Depths in the port against the JAX package's ``apply_mod``.

A tiny Qwen2 decoder (2 layers, hidden 64, GQA 4:2) from JAX's init,
converted by both packages' ``convert_to_mod``, then given random routers
(zero routers tie every score; repeated tokens still tie, and both break
ties toward the lower index).  Rows of 64 with packed segments and padding; capacity
0.25 (k = 16).  f32: hidden states atol 1e-4, and gradients within 1e-6
of each leaf's largest (the embedding's reaches 2e3 at this init),
against JAX over its dense attention, for the port over the dense
attention and over the flash twin (K1-K3's plain versions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import mod as jmod
from iadr1_tpu.models import qwen2 as jq
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import mod as tmod
from iadr1_tpu_torch.models import qwen2 as tq
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_io import params_from_jax

KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          rope_theta=10000.0)


def _setup(seed=0):
    jcfg, tcfg = jq.Qwen2Config(**KW), tq.Qwen2Config(**KW)
    jparams = jmod.convert_to_mod(jax.random.PRNGKey(seed),
                                  jq.init_params(jax.random.PRNGKey(seed),
                                                 jcfg), jcfg)
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((2, 64, 1)).astype(np.float32)
    jparams["layers"]["mod_router"]["kernel"] = jnp.asarray(router)
    tparams = tmod.convert_to_mod(params_from_jax(
        {k: v for k, v in jparams.items()}, device="cpu"), tcfg)
    tparams["layers"]["mod_router"]["kernel"] = torch.as_tensor(router)
    segs = np.ones((2, 64), np.int32)
    segs[0, 40:] = 2
    segs[1, :10] = 0                       # left padding
    segs[1, 60:] = 0
    pos = np.zeros((2, 64), np.int64)
    for b in range(2):
        for s in (1, 2):
            idx = np.nonzero(segs[b] == s)[0]
            pos[b, idx] = np.arange(len(idx))
    ids = rng.integers(1, 256, (2, 64))
    return jcfg, tcfg, jparams, tparams, ids, pos, segs


def test_convert_to_mod_adds_zero_routers():
    jcfg, tcfg, *_ = _setup()
    params = tmod.convert_to_mod(tq.init_params(
        torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu"), tcfg)
    router = params["layers"]["mod_router"]["kernel"]
    assert router.shape == (2, 64, 1) and not router.any()


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("remat", [False, True])
def test_apply_mod_matches_jax(attention, remat):
    jcfg, tcfg, jparams, tparams, ids, pos, segs = _setup()
    r = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    live = segs.astype(bool)

    def jloss(p):
        h = jmod.apply_mod(p, jcfg, jnp.asarray(ids),
                           position_ids=jnp.asarray(pos),
                           segment_ids=jnp.asarray(segs), capacity=0.25,
                           precision=JAX_FULL, remat=False)
        return jnp.sum(jnp.where(jnp.asarray(live)[..., None], h * r, 0.0)), h

    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in _named(tparams)
              if k != "lm_head/kernel"}              # no logits here
    th = tmod.apply_mod(tparams, tcfg, torch.as_tensor(ids),
                        position_ids=torch.as_tensor(pos),
                        segment_ids=torch.as_tensor(segs), capacity=0.25,
                        precision=FULL_PRECISION,
                        attention_fn=default_attention(attention),
                        remat=remat)
    np.testing.assert_allclose(th.detach().numpy()[live],
                               np.asarray(jh)[live], atol=1e-4, rtol=0)
    loss = (torch.where(torch.as_tensor(live)[..., None],
                        th * torch.as_tensor(r), 0.0)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = dict(_named(jg))
    for (name, _), g in zip(leaves.items(), grads):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=name,
                                   atol=1e-6 * float(np.abs(w).max()))
    assert np.abs(np.asarray(want["layers/mod_router/kernel"])).max() > 0


def _named(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named(v, name)
        elif v is not None:
            yield name, v


def test_a_row_shorter_than_k_matches_jax():
    """Capacity 0.5 (k = 32) over a row of 16 real tokens: the padding
    rows picked add nothing (their multiplier is 0), as in JAX."""
    jcfg, tcfg, jparams, tparams, ids, pos, segs = _setup(1)
    segs = segs.copy()
    segs[1, :44] = 0
    live = segs.astype(bool)
    jh = jmod.apply_mod(jparams, jcfg, jnp.asarray(ids),
                        position_ids=jnp.asarray(pos),
                        segment_ids=jnp.asarray(segs), capacity=0.5,
                        precision=JAX_FULL)
    with torch.no_grad():
        th = tmod.apply_mod(tparams, tcfg, torch.as_tensor(ids),
                            position_ids=torch.as_tensor(pos),
                            segment_ids=torch.as_tensor(segs), capacity=0.5,
                            precision=FULL_PRECISION,
                            attention_fn=default_attention("flash"))
    np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live],
                               atol=1e-4, rtol=0)
