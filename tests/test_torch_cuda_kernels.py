"""The hand-written CUDA kernels (K1 flash forward, K2 and K3 flash
backward, K4 ragged decode) against their plain PyTorch twins, on a CUDA
card: the main path's layouts, and the edges of the flash kernels' dead-tile
skipping (unsorted ids, all-padding blocks, left padding, stacked query rows
that run from one head into the next, tiles that skip the mask).

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


def _bwd_grads(q, k, v, do, q_seg, kv_seg, causal):
    """dq, dk, dv through the kernels (K2 and K3 directly), and the plain
    backward, on K1's out and lse."""
    D = q.shape[-1]
    with torch.no_grad():
        out, lse = k1.flash_attention(q, k, v, segment_ids=q_seg,
                                      kv_segment_ids=kv_seg, causal=causal)
    delta = k1._delta(out, do, None).contiguous()
    args = (q, k, v, q_seg, kv_seg, lse, delta, do)
    kw = dict(causal=causal, scale=D ** -0.5)
    dq = k1.flash_bwd_dq(*args, **kw)
    dk, dv = k1.flash_bwd_dkv(*args, **kw)
    want = k1.flash_attention_bwd_ref(q, k, v, q_seg, kv_seg, out, lse, do,
                                      None, **kw)
    return (dq, dk, dv), want, args, kw


SKIP_CASES = [
    # B, H, Hkv, T, S, D, causal, segments
    (2, 12, 2, 256, 256, 128, True, "unsorted"),
    (2, 4, 4, 300, 300, 80, False, "unsorted"),
    (1, 6, 1, 190, 333, 64, True, "unsorted"),      # T < S
    (1, 16, 16, 1024, 1024, 80, False, "tower"),    # 4 images + padding
    (1, 12, 2, 1024, 1024, 128, True, "tower"),
    # K1/K2's stacked rows wrap from one head into the next (GQA 6, T=200)
    (2, 12, 2, 200, 200, 128, True, "ones"),
    (2, 12, 2, 200, 333, 64, True, "unsorted"),     # wrap, T < S
    (4, 12, 2, 1024, 1024, 128, True, "leftpad"),   # prefill's layout
    (2, 6, 1, 256, 256, 64, False, "allpad"),       # all-padding blocks
    (1, 4, 4, 256, 256, 80, True, "ones"),          # unmasked full tiles
]


def _skip_segments(kind, B, n, gen, card):
    if kind == "unsorted":
        return torch.randint(0, 4, (B, n), generator=gen, device=card,
                             dtype=torch.int32)
    seg = torch.zeros((B, n), dtype=torch.int32, device=card)
    if kind == "ones":
        seg[:] = 1
    elif kind == "leftpad":       # prompts of 292, 283, 306, 297 tokens
        for b in range(B):
            seg[b, n - (292, 283, 306, 297)[b % 4]:] = 1
    elif kind == "allpad":        # row 0 all padding, row 1 from 150 on
        seg[1:, 150:] = 2
    else:
        for i, (a, b) in enumerate([(0, 256), (256, 496), (496, 752),
                                    (752, 992)]):
            seg[:, a:b] = i + 1
    return seg


@pytest.mark.parametrize("case", SKIP_CASES,
                         ids=["-".join(map(str, c)) for c in SKIP_CASES])
def test_flash_forward_skips_only_dead_tiles(card, case):
    B, H, Hkv, T, S, D, causal, kind = case
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v = (_rand(gen, (B, H, T, D), card), _rand(gen, (B, Hkv, S, D), card),
               _rand(gen, (B, Hkv, S, D), card))
    q_seg = _skip_segments(kind, B, T, gen, card)
    kv_seg = q_seg if S == T else _skip_segments(kind, B, S, gen, card)
    out, lse = k1.flash_attention(q, k, v, segment_ids=q_seg,
                                  kv_segment_ids=kv_seg, causal=causal)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, q_seg, kv_seg,
                                              causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    assert (out[~valid] == 0).all() and torch.isposinf(lse[~valid]).all()


@pytest.mark.parametrize("case", SKIP_CASES,
                         ids=["-".join(map(str, c)) for c in SKIP_CASES])
def test_flash_dkv_skips_only_dead_tiles(card, case):
    B, H, Hkv, T, S, D, causal, kind = case
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (_rand(gen, (B, H, T, D), card), _rand(gen, (B, Hkv, S, D), card),
               _rand(gen, (B, Hkv, S, D), card))
    do = _rand(gen, (B, H, T, D), card)
    q_seg = _skip_segments(kind, B, T, gen, card)
    kv_seg = q_seg if S == T else _skip_segments(kind, B, S, gen, card)
    got, want, _, _ = _bwd_grads(q, k, v, do, q_seg, kv_seg, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


@pytest.mark.parametrize("group", [1, 6])
def test_flash_dkv_is_deterministic(card, group):
    B, Hkv, T, D = 2, 2, 512, 128
    gen = torch.Generator(device=card).manual_seed(3)
    q = _rand(gen, (B, Hkv * group, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    do = _rand(gen, (B, Hkv * group, T, D), card)
    seg = _bwd_segments("packed", B, T, gen, card)
    (_, dk, dv), _, args, kw = _bwd_grads(q, k, v, do, seg, seg, True)
    dk2, dv2 = k1.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("group", [1, 6])
def test_flash_dq_is_deterministic(card, group):
    B, Hkv, T, D = 2, 2, 500, 128
    gen = torch.Generator(device=card).manual_seed(5)
    q = _rand(gen, (B, Hkv * group, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    do = _rand(gen, (B, Hkv * group, T, D), card)
    seg = _bwd_segments("packed", B, T, gen, card)
    (dq, _, _), _, args, kw = _bwd_grads(q, k, v, do, seg, seg, True)
    dq2 = k1.flash_bwd_dq(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)


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


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("G", [1, 6, 8])
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 200, 520])
def test_decode_kernel_split_edges(card, length, G, D):
    """The chunk edges of the split (64 slots), an all-dead chunk, and
    slots past ``length`` filled with NaN (never read)."""
    B, Hkv, S = 3, 2, 520
    gen = torch.Generator(device=card).manual_seed(length + 10 * G + D)
    q = _rand(gen, (B, Hkv * G, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[0, :130] = 0              # chunks 0 and 1 all dead, 2 partly
    seg[1, 64:128] = 0            # one whole dead chunk mid-cache
    seg[2, 3:5] = 0
    k[:, :, length:] = float("nan")
    v[:, :, length:] = float("nan")
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("D,aligned", [(36, True), (128, False)])
def test_decode_kernel_takes_rows_it_cannot_copy_by_16_bytes(card, D,
                                                             aligned):
    """Head dims that are no multiple of 8, and a cache that starts off a
    16-byte boundary, go through the kernel's plain-load path."""
    B, Hkv, G, S, length = 2, 2, 6, 200, 170
    gen = torch.Generator(device=card).manual_seed(D)
    q = _rand(gen, (B, Hkv * G, D), card)
    n = B * Hkv * S * D
    k, v = (_rand(gen, (n + 1,), card)[(0 if aligned else 1):][:n]
            .view(B, Hkv, S, D) for _ in range(2))
    assert k.is_contiguous() and (k.data_ptr() % 16 == 0) == aligned
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[0, :70] = 0
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
