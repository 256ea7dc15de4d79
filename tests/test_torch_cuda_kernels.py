"""The hand-written CUDA kernels (K1 flash forward, K2 and K3 flash
backward, K4 ragged decode) against their plain PyTorch twins, on a CUDA
card.

Marked ``cuda``: the kernels have no CPU or interpret mode, so these tests
skip without a card.  Run on the card (which has no JAX, hence no
conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
bf16 inputs, identical for kernel and twin; out atol/rtol 2e-2 (the kernel
rounds p to bf16 before p @ v, both round the output to bf16), lse atol
1e-3 (f32 statistics, summation order only).  K2/K3: dq, dk, dv within
2e-2 relative plus 1e-2 of the reference's largest magnitude (the kernels
round p and ds to bf16 before their products and the gradients to bf16;
the gradients' scale depends on the softmax width, hence the scaled atol).
"""

import pytest
import torch

from iadr1_tpu_torch.kernels import decode_attention as k4
from iadr1_tpu_torch.kernels import flash_attention as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


FLASH_CASES = [
    # B, H, Hkv, T, S, D, causal, packed segments
    (2, 4, 4, 256, 256, 64, True, False),
    (2, 4, 4, 256, 256, 64, False, False),
    (1, 14, 2, 200, 200, 128, True, True),       # GQA 7, partial tiles
    (2, 6, 3, 129, 65, 80, False, False),        # T != S
    (1, 4, 2, 65, 190, 80, True, True),          # T != S, top-left causal
    (1, 16, 16, 300, 300, 80, False, True),      # tower-like
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
def test_flash_kernel_matches_twin(card, case):
    B, H, Hkv, T, S, D, causal, packed = case
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (_rand(gen, (B, H, T, D), card), _rand(gen, (B, Hkv, S, D), card),
               _rand(gen, (B, Hkv, S, D), card))
    q_seg = torch.ones((B, T), dtype=torch.int32, device=card)
    kv_seg = torch.ones((B, S), dtype=torch.int32, device=card)
    if packed:
        q_seg = torch.randint(0, 3, (B, T), generator=gen, device=card,
                              dtype=torch.int32).sort(dim=1).values
        kv_seg = q_seg if S == T else torch.randint(
            0, 3, (B, S), generator=gen, device=card,
            dtype=torch.int32).sort(dim=1).values
    before = k1.KERNEL.launches
    out, lse = k1.flash_attention(q, k, v, segment_ids=q_seg,
                                  kv_segment_ids=kv_seg, causal=causal)
    assert k1.KERNEL.launches == before + 1
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, q_seg, kv_seg,
                                              causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    assert (out[~valid] == 0).all() and torch.isposinf(lse[~valid]).all()


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        k1.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        k1.flash_attention(q[..., :64].float().contiguous(),
                           q[..., :64].float().contiguous(),
                           q[..., :64].float().contiguous())


BWD_CASES = [
    # B, H, Hkv, T, S, D, causal, segments, dlse != 0
    (2, 4, 4, 256, 256, 64, True, "ones", False),
    (2, 4, 4, 256, 256, 64, False, "ones", True),
    (1, 14, 2, 200, 200, 128, True, "packed", False),   # GQA 7, partial
    (2, 6, 3, 129, 65, 80, False, "ones", True),         # T != S
    (1, 4, 2, 65, 190, 80, True, "packed", False),       # top-left causal
    (1, 16, 16, 300, 300, 80, False, "packed", True),    # tower-like
    (2, 12, 2, 128, 128, 128, True, "leftpad", True),    # empty rows
]


def _bwd_segments(kind, B, n, gen, card):
    seg = torch.ones((B, n), dtype=torch.int32, device=card)
    if kind == "packed":
        seg = torch.randint(0, 3, (B, n), generator=gen, device=card,
                            dtype=torch.int32).sort(dim=1).values
    elif kind == "leftpad":
        for b in range(B):
            seg[b, :17 + 30 * b] = 0
    return seg


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["-".join(map(str, c)) for c in BWD_CASES])
def test_flash_backward_kernels_match_plain(card, case):
    B, H, Hkv, T, S, D, causal, kind, with_dlse = case
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (_rand(gen, (B, H, T, D), card), _rand(gen, (B, Hkv, S, D), card),
               _rand(gen, (B, Hkv, S, D), card))
    do = _rand(gen, (B, H, T, D), card)
    q_seg = _bwd_segments(kind, B, T, gen, card)
    kv_seg = q_seg if S == T else _bwd_segments(kind, B, S, gen, card)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = k1.flash_attention(*leaves, segment_ids=q_seg,
                                  kv_segment_ids=kv_seg, causal=causal)
    finite = torch.isfinite(lse)
    dlse = (torch.randn(lse.shape, generator=gen, device=card) * finite
            if with_dlse else torch.zeros_like(lse))
    before = (k1.DQ_KERNEL.launches, k1.DKV_KERNEL.launches)
    got = torch.autograd.grad(
        (out.float() * do.float()).sum()
        + torch.where(finite, lse * dlse, 0.0).sum(), leaves)
    assert (k1.DQ_KERNEL.launches, k1.DKV_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want = k1.flash_attention_bwd_ref(q, k, v, q_seg, kv_seg, out.detach(),
                                      lse.detach(), do, dlse, causal=causal,
                                      scale=D ** -0.5)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)
    assert (got[0][~finite] == 0).all()        # rows with no valid key


def test_flash_function_refuses_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device=card,
                    requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        k1.flash_attention(q, q, q)
    f = torch.zeros((1, 2, 8, 64), device=card, requires_grad=True)
    with pytest.raises(TypeError):
        k1.flash_attention(f, f, f)


@pytest.mark.parametrize("length", [0, 1, 7, 64, 65, 300, 513])
def test_decode_kernel_matches_twin(card, length):
    B, Hkv, G, S, D = 3, 2, 6, 513, 128
    gen = torch.Generator(device=card).manual_seed(length)
    q = _rand(gen, (B, Hkv * G, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[0, :5] = 0
    seg[2, 40:90] = 0
    v[:, :, length:] = float("nan")             # never read past length
    before = k4.KERNEL.launches
    out = k4.decode_attention(q, k, v, seg, length)
    assert k4.KERNEL.launches == before + 1
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
