"""The flash backward's plain version (iadr1_tpu_torch
flash_attention_bwd_ref) against the JAX Pallas backward ``_bwd`` in
interpret mode, and the autograd Function around K1-K3 on the CPU.

Inputs are drawn with numpy from a seed.  Both backwards get the same q,
k, v, out, lse and cotangent (out and lse from the port's forward twin),
so the comparison is of the backward functions alone.  f32, atol and rtol
5e-5: the two compute the same sums in f32 and differ in summation order
and in exp vs exp2 of the rebased lse.  With dlse = 0, as the JAX VJP
assumes.  The lse cotangent (which the JAX VJP drops) is held against
autograd of the forward twin instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from iadr1_tpu.kernels.flash_attention import BlockSizes, _bwd
from iadr1_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from test_torch_flash_attention import _segments
import torch_threads  # noqa: F401  (one intra-op thread)

BLOCKS = BlockSizes(*([64] * 6))
TOL = dict(atol=5e-5, rtol=5e-5)

CASES = [
    # B, H, Hkv, T, S, D, causal, q segments, kv segments
    (1, 2, 2, 128, 128, 64, True, "ones", None),        # GQA 1
    (1, 4, 2, 100, 100, 80, False, "packed", None),     # GQA 2, partial
    (1, 7, 1, 96, 96, 128, True, "leftpad", None),      # GQA 7, empty rows
    (1, 4, 2, 72, 136, 64, False, "ones", "packed"),    # T < S
    (1, 4, 2, 136, 72, 80, True, "ones", "ones"),       # T > S, top-left
    (1, 2, 1, 150, 150, 128, False, "images", None),    # tower-like
    # D = 72 (SigLIP): partial tiles, the tower's 729, causal with segments
    (1, 4, 2, 100, 100, 72, False, "ones", None),
    (1, 2, 2, 729, 729, 72, False, "ones", None),
    (1, 4, 2, 100, 100, 72, True, "packed", None),
]


def _inputs(case, seed):
    B, H, Hkv, T, S, D, causal, qkind, kvkind = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, T, D)).astype(np.float32)
    dlse = rng.standard_normal((B, H, T)).astype(np.float32)
    q_seg = _segments(qkind, B, T, rng)
    kv_seg = q_seg if kvkind is None else _segments(kvkind, B, S, rng)
    return q, k, v, do, dlse, q_seg, kv_seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_bwd_ref_matches_pallas_backward(idx):
    case = CASES[idx]
    causal, D = case[6], case[5]
    q, k, v, do, _, q_seg, kv_seg = _inputs(case, idx)
    tq, tk, tv, tdo, tqs, tks = _t(q, k, v, do, q_seg, kv_seg)
    out, lse = flash_attention_ref(tq, tk, tv, tqs, tks, causal=causal,
                                   scale=D ** -0.5)
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, tqs, tks, out, lse, tdo,
                                         None, causal=causal,
                                         scale=D ** -0.5)
    jdq, jdk, jdv = _bwd(
        *(jnp.asarray(a) for a in (q, k, v, q_seg, kv_seg, out.numpy(),
                                   lse.numpy(), do)),
        scale=D ** -0.5, causal=causal, blocks=BLOCKS, interpret=True)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    # rows with no valid key (lse = +inf) get dq = 0
    assert (dq[torch.isposinf(lse)] == 0).all()


@pytest.mark.parametrize("idx", [0, 3, 4])
def test_bwd_ref_takes_the_lse_cotangent(idx):
    """dlse != 0 against autograd of the forward twin (cases with no empty
    row, where lse is finite everywhere).  f32, atol/rtol 5e-5."""
    case = CASES[idx]
    causal, D = case[6], case[5]
    q, k, v, do, dlse, q_seg, kv_seg = _inputs(case, 10 + idx)
    tq, tk, tv, tdo, tdl, tqs, tks = _t(q, k, v, do, dlse, q_seg, kv_seg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, lse = flash_attention_ref(*leaves, tqs, tks, causal=causal,
                                   scale=D ** -0.5)
    assert torch.isfinite(lse).all()
    want = torch.autograd.grad((out * tdo).sum() + (lse * tdl).sum(), leaves)
    got = flash_attention_bwd_ref(tq, tk, tv, tqs, tks, out.detach(),
                                  lse.detach(), tdo, tdl, causal=causal,
                                  scale=D ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL)


def test_function_passes_gradients_to_qkv():
    """flash_attention on CPU tensors is differentiable through both
    outputs, and its gradients are flash_attention_bwd_ref's (exact: the
    Function's CPU backward is that function)."""
    q, k, v, do, dlse, q_seg, kv_seg = _inputs(CASES[2], 7)
    tq, tk, tv, tdo, tdl, tqs, tks = _t(q, k, v, do, dlse, q_seg, kv_seg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, lse = flash_attention(*leaves, segment_ids=tqs, kv_segment_ids=tks,
                               causal=True)
    assert out.grad_fn is not None and lse.grad_fn is not None
    finite = torch.isfinite(lse)
    tdl = torch.where(finite, tdl, 0.0)
    got = torch.autograd.grad(
        (out * tdo).sum() + torch.where(finite, lse * tdl, 0.0).sum(), leaves)
    want = flash_attention_bwd_ref(tq, tk, tv, tqs, tks, out.detach(),
                                   lse.detach(), tdo, tdl, causal=True,
                                   scale=128 ** -0.5)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=0, rtol=0)
