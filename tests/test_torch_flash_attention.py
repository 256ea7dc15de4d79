"""K1 twin (iadr1_tpu_torch flash_attention_ref) against the JAX Pallas
flash forward in interpret mode.

Inputs are drawn with numpy from a seed and fed to both.  f32, atol and
rtol 2e-5 (as tests/test_flash_attention.py): the two compute the same
softmax in f32 and differ only in summation order.  Rows with no valid key
are excluded from the comparison (the TPU kernels disagree on them); the
port defines them as out = 0, lse = +inf, which is checked separately.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iadr1_tpu.kernels.flash_attention import (
    BlockSizes,
    flash_attention_with_lse,
)
from iadr1_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

BLOCKS = BlockSizes(*([64] * 6))
TOL = dict(atol=2e-5, rtol=2e-5)


def _segments(kind, B, n, rng):
    if kind == "ones":
        return np.ones((B, n), np.int32)
    if kind == "packed":      # three packed segments + trailing padding
        a, b = n // 3, n // 3 + n // 4
        row = np.zeros(n, np.int32)
        row[:a], row[a:b], row[b:n - 9] = 1, 2, 3
        return np.tile(row, (B, 1))
    if kind == "leftpad":     # per-row left padding, as the prefill sees it
        segs = np.ones((B, n), np.int32)
        for b in range(B):
            segs[b, :int(rng.integers(1, n // 2))] = 0
        return segs
    if kind == "images":      # four image segments + padding (the tower)
        row = np.zeros(n, np.int32)
        edges = np.linspace(0, n - 11, 5).astype(int)
        for i in range(4):
            row[edges[i]:edges[i + 1]] = i + 1
        return np.tile(row, (B, 1))
    raise ValueError(kind)


def _valid_rows(q_seg, kv_seg, causal):
    T, S = q_seg.shape[1], kv_seg.shape[1]
    ok = (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
    if causal:
        ok &= np.arange(S)[None, None, :] <= np.arange(T)[None, :, None]
    return ok.any(-1)                                    # [B, T]


CASES = [
    # B, H, Hkv, T, S, D, causal, q segments, kv segments
    (2, 4, 4, 128, 128, 64, True, "ones", None),
    (2, 4, 4, 128, 128, 64, False, "ones", None),
    (1, 4, 2, 100, 100, 80, True, "packed", None),
    (2, 6, 1, 96, 96, 128, True, "leftpad", None),
    (1, 6, 1, 96, 96, 128, False, "packed", None),
    (1, 4, 2, 72, 136, 64, False, "ones", "packed"),
    (1, 4, 2, 136, 72, 80, True, "ones", "ones"),
    (1, 2, 2, 150, 150, 80, False, "images", None),
    # D = 72 (SigLIP): partial tiles, the tower's 729 (one segment a tile,
    # non-causal), and causal with packed segments
    (1, 4, 2, 100, 100, 72, False, "ones", None),
    (2, 2, 2, 729, 729, 72, False, "ones", None),
    (1, 4, 2, 100, 100, 72, True, "packed", None),
]


@pytest.mark.parametrize("seed", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_twin_matches_pallas_forward(seed):
    B, H, Hkv, T, S, D, causal, qkind, kvkind = CASES[seed]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q_seg = _segments(qkind, B, T, rng)
    kv_seg = q_seg if kvkind is None else _segments(kvkind, B, S, rng)

    out_j, lse_j = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg),
        causal=causal, blocks=BLOCKS, interpret=True)
    out_t, lse_t = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=torch.from_numpy(q_seg),
        kv_segment_ids=torch.from_numpy(kv_seg), causal=causal)

    valid = _valid_rows(q_seg, kv_seg, causal)             # [B, T]
    rows = np.broadcast_to(valid[:, None, :], (B, H, T))
    np.testing.assert_allclose(out_t.numpy()[rows], np.asarray(out_j)[rows],
                               **TOL)
    np.testing.assert_allclose(lse_t.numpy()[rows], np.asarray(lse_j)[rows],
                               **TOL)
    # rows with no valid key: out 0, lse +inf (the port's definition)
    assert np.all(out_t.numpy()[~rows] == 0)
    assert np.all(np.isposinf(lse_t.numpy()[~rows]))


def test_wrapper_takes_twin_on_cpu_and_defaults_segments():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 8, 64)).astype(np.float32))
    out, lse = flash_attention(q, k, k, causal=True)
    ones = torch.ones((1, 8), dtype=torch.int32)
    ref_out, ref_lse = flash_attention_ref(q, k, k, ones, ones, causal=True,
                                           scale=64 ** -0.5)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
