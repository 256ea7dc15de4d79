"""K4 twin (iadr1_tpu_torch decode_attention_ref) against the JAX Pallas
ragged decode kernel in interpret mode.

Inputs are drawn with numpy from a seed.  f32, atol 2e-5 (as
tests/test_decode_attention.py).  Lengths fall inside, at and past the
JAX kernel's 16-slot block edges; dead slots (segment 0) sit at the left
and in the middle of the cache.  Rows with no valid slot are excluded from
the comparison (the Pallas kernel returns a mean of masked slots there);
the port defines them as 0, checked separately.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iadr1_tpu.kernels.decode_attention import decode_attention as jax_decode
from iadr1_tpu_torch.kernels.decode_attention import decode_attention


def _inputs(B, Hkv, G, S, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    seg = np.ones((B, S), np.int32)
    seg[0, :3] = 0            # left padding on row 0
    seg[1, 20:26] = 0         # dead slots mid-cache on row 1
    return q, k, v, seg


@pytest.mark.parametrize("length", [4, 7, 15, 16, 17, 31, 32, 40, 64])
def test_twin_matches_pallas_decode(length):
    q, k, v, seg = _inputs(B=3, Hkv=2, G=3, S=64, D=64, seed=length)
    out_j = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(seg), jnp.int32(length), block_k=16,
                       interpret=True)
    out_t = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(seg),
                             length)
    live = (seg[:, :length] != 0).any(axis=1)
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               atol=2e-5)


def test_row_without_valid_slot_is_zero():
    q, k, v, seg = _inputs(B=3, Hkv=2, G=3, S=64, D=64, seed=1)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(seg), 3)
    assert torch.all(out[0] == 0)          # row 0's first 3 slots are dead
    assert torch.all(out[1:] != 0)


def test_slots_past_length_are_ignored():
    q, k, v, seg = _inputs(B=3, Hkv=1, G=2, S=64, D=32, seed=2)
    args = [torch.from_numpy(a) for a in (q, k, v, seg)]
    ref = decode_attention(*args, 20)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 20:] = 1e4
    v2[:, :, 20:] = np.nan
    out = decode_attention(args[0], torch.from_numpy(k2), torch.from_numpy(v2),
                           args[3], 20)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
