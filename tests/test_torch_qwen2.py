"""The port's Qwen2 decoder against the JAX decoder, in f32.

A tiny config (2 layers, hidden 64, GQA 4:2) with weights from
``qwen2.init_params`` in JAX, carried over by ``params_from_jax``; inputs
drawn with numpy from a seed.  Both run FULL_PRECISION (f32 compute, f32
cache); the port's attention is the K1/K4 twin, the JAX side's the XLA
oracle.  Logits agree to atol 1e-4 (f32 through two layers and a 512-wide
head; only summation order differs).  Rows that attend no key (padding)
are excluded: the twin returns 0 there, the oracle a uniform mix.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import qwen2 as jq
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import qwen2 as tq
from iadr1_tpu_torch.models.attention import (
    default_attention,
    default_decode_attention,
)
from iadr1_tpu_torch.models.params_io import params_from_jax

ATOL = 1e-4


def _cfgs(mrope):
    kw = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, rope_theta=10000.0,
              tie_word_embeddings=mrope,
              mrope_section=(2, 3, 3) if mrope else None)
    return jq.Qwen2Config(**kw), tq.Qwen2Config(**kw)


def _models(mrope, seed=0):
    jcfg, tcfg = _cfgs(mrope)
    jparams = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    # the init zeroes the biases: give them values so they are exercised
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + 0.02 * rng.standard_normal(x.shape), jnp.float32),
        jparams)
    return jcfg, jparams, tcfg, params_from_jax(jparams, device="cpu")


def _jax_logits(jcfg, jparams, ids, pos, segs):
    h, _ = jq.apply(jparams, jcfg, jnp.asarray(ids),
                    position_ids=jnp.asarray(pos),
                    segment_ids=None if segs is None else jnp.asarray(segs),
                    precision=JAX_FULL)
    return np.asarray(jq.logits(jparams, jcfg, h, JAX_FULL))


def _torch_logits(tcfg, tparams, ids, pos, segs, attention="auto"):
    h, _ = tq.apply(tparams, tcfg, torch.as_tensor(ids),
                    position_ids=torch.as_tensor(pos),
                    segment_ids=None if segs is None else torch.as_tensor(segs),
                    precision=FULL_PRECISION,
                    attention_fn=default_attention(attention))
    return tq.logits(tparams, tcfg, h, FULL_PRECISION).numpy()


def _packed_segments(B, T):
    segs = np.zeros((B, T), np.int32)
    segs[:, :9], segs[:, 9:20], segs[:, 20:T - 3] = 1, 2, 3
    pos = np.zeros((B, T), np.int64)
    for b in range(B):
        for s in (1, 2, 3):
            idx = np.nonzero(segs[b] == s)[0]
            pos[b, idx] = np.arange(len(idx))    # positions restart
    return segs, pos


@pytest.mark.parametrize("kind", ["gqa", "gqa_oracle", "packed", "mrope"])
def test_logits_match_jax(kind):
    """"gqa_oracle" runs the port's dense masked oracle instead of the
    twin."""
    B, T = 2, 24
    rng = np.random.default_rng(1)
    jcfg, jparams, tcfg, tparams = _models(mrope=kind == "mrope")
    ids = rng.integers(0, 512, (B, T)).astype(np.int32)
    segs, rows = None, np.ones((B, T), bool)
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    if kind == "packed":
        segs, pos = _packed_segments(B, T)
        rows = segs != 0
    elif kind == "mrope":
        # image-like spans: repeated temporal, 2-D h/w grids
        pos = np.broadcast_to(np.arange(T), (3, B, T)).copy()
        pos[1, :, 4:12] = 4 + np.repeat(np.arange(2), 4)
        pos[2, :, 4:12] = 4 + np.tile(np.arange(4), 2)
        pos[0, :, 4:12] = 4
    ref = _jax_logits(jcfg, jparams, ids, pos, segs)
    got = _torch_logits(tcfg, tparams, ids, pos, segs,
                        "xla" if kind == "gqa_oracle" else "auto")
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATOL, rtol=0)


def test_prefill_then_decode_equals_no_cache_forward():
    """Left-padded prefill of P tokens, then one-token decode steps through
    the K4 twin, reproduces the no-cache forward of the whole sequence."""
    B, P, N = 2, 12, 5
    rng = np.random.default_rng(2)
    _, _, tcfg, tparams = _models(mrope=True)
    ids = rng.integers(0, 512, (B, P + N))
    mask = np.ones((B, P + N), np.int32)
    mask[0, :4] = 0                                  # row 0 left-padded
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    t = lambda a: torch.as_tensor(a)
    kw = dict(precision=FULL_PRECISION, attention_fn=default_attention(),
              decode_attention_fn=default_decode_attention())

    h, _ = tq.apply(tparams, tcfg, t(ids), position_ids=t(pos),
                    segment_ids=t(mask), **kw)
    full = tq.logits(tparams, tcfg, h, FULL_PRECISION)

    cache = tq.init_cache(tcfg, B, P + N, torch.float32, "cpu")
    h, cache = tq.apply(tparams, tcfg, t(ids[:, :P]), position_ids=t(pos[:, :P]),
                        segment_ids=t(mask[:, :P]), cache=cache,
                        cache_mode="prefill", **kw)
    steps = [tq.logits(tparams, tcfg, h[:, -1:], FULL_PRECISION)]
    for i in range(P, P + N - 1):
        h, cache = tq.apply(tparams, tcfg, t(ids[:, i:i + 1]),
                            position_ids=t(pos[:, i:i + 1]),
                            segment_ids=t(mask[:, i:i + 1]), cache=cache,
                            cache_mode="decode", **kw)
        steps.append(tq.logits(tparams, tcfg, h, FULL_PRECISION))
    assert cache["write_idx"] == P + N - 1
    torch.testing.assert_close(torch.cat(steps, 1), full[:, P - 1:P + N - 1],
                               atol=ATOL, rtol=0)


def test_extend_mode_matches_decode_mode():
    """The dense "extend" path over the whole cache and the K4 path agree
    for a one-token step."""
    B, P = 2, 10
    rng = np.random.default_rng(3)
    _, _, tcfg, tparams = _models(mrope=False)
    ids = torch.as_tensor(rng.integers(0, 512, (B, P + 1)))
    pos = torch.arange(P + 1).expand(B, P + 1)
    outs = []
    for mode in ("decode", "extend"):
        cache = tq.init_cache(tcfg, B, P + 4, torch.float32, "cpu")
        kw = dict(precision=FULL_PRECISION, attention_fn=default_attention(),
                  decode_attention_fn=default_decode_attention())
        _, cache = tq.apply(tparams, tcfg, ids[:, :P], position_ids=pos[:, :P],
                            cache=cache, cache_mode="prefill", **kw)
        h, _ = tq.apply(tparams, tcfg, ids[:, P:], position_ids=pos[:, P:],
                        cache=cache, cache_mode=mode, **kw)
        outs.append(h)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
