"""The hand-written CUDA kernels (K1 flash forward, K4 ragged decode)
against their plain PyTorch twins, on a CUDA card.

Marked ``cuda``: the kernels have no CPU or interpret mode, so these tests
skip without a card.  Run on the card (which has no JAX, hence no
conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
bf16 inputs, identical for kernel and twin; out atol/rtol 2e-2 (the kernel
rounds p to bf16 before p @ v, both round the output to bf16), lse atol
1e-3 (f32 statistics, summation order only).
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
