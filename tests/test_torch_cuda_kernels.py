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
import torch_threads  # noqa: F401  (one intra-op thread)

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
@pytest.mark.parametrize("G", [1, 6, 7, 8])
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


# the SC-GRPO update's calls at small size, GQA 6: the completions' cross
# attention to the prompt (T != S, non-causal, kv ids left-padded per
# prompt and repeated over the group, q ids with trailing zeros after an
# early EOS) and their causal self attention, both feeding a merge that
# sends dlse != 0 back
GRPO_CASES = [
    # name, T, S, D, causal
    ("cross", 150, 333, 128, False),
    ("cross", 64, 200, 64, False),
    ("self", 150, 150, 128, True),
]


@pytest.mark.parametrize("case", GRPO_CASES,
                         ids=["-".join(map(str, c)) for c in GRPO_CASES])
def test_flash_kernels_at_the_grpo_update_shapes(card, case):
    name, T, S, D, causal = case
    n, G, H, Hkv = 2, 3, 12, 2
    B = n * G
    gen = torch.Generator(device=card).manual_seed(T + S)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    q_seg = torch.ones((B, T), dtype=torch.int32, device=card)
    for b, stop in enumerate((T, 1, 70, T - 1, 0, 33)):   # 0: an empty row
        q_seg[b, stop:] = 0
    if name == "cross":
        kv_seg = torch.ones((n, S), dtype=torch.int32, device=card)
        kv_seg[0, :130], kv_seg[1, :1] = 0, 0
        kv_seg = kv_seg.repeat_interleave(G, dim=0)
        k, v = (_rand(gen, (n, Hkv, S, D), card).repeat_interleave(G, dim=0)
                for _ in range(2))
    else:
        kv_seg = q_seg
        k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = k1.flash_attention(*leaves, segment_ids=q_seg,
                                  kv_segment_ids=kv_seg, causal=causal)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, q_seg, kv_seg,
                                              causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    live = (q_seg != 0)[:, None, :].expand(B, H, T)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(out[live].float(), ref_out[live].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    # a row whose q id is 0: out = 0, lse = +inf, and dq = 0 below
    assert (out[~live] == 0).all() and torch.isposinf(lse[~live]).all()

    dlse = torch.randn(lse.shape, generator=gen, device=card) * live
    got = torch.autograd.grad(
        (out.float() * do.float()).sum()
        + torch.where(live, lse * dlse, 0.0).sum(), leaves)
    want = k1.flash_attention_bwd_ref(q, k, v, q_seg, kv_seg, out.detach(),
                                      lse.detach(), do, dlse, causal=causal,
                                      scale=D ** -0.5)
    no_dlse = k1.flash_attention_bwd_ref(q, k, v, q_seg, kv_seg, out.detach(),
                                         lse.detach(), do, None,
                                         causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    for label, g, w, w0 in zip(("dq", "dk", "dv"), got, want, no_dlse):
        assert torch.isfinite(g).all(), label
        atol = 1e-2 * float(w.float().abs().max()) + 1e-6
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=atol,
                                   msg=label)
        if label != "dv":        # dv does not read delta; dq and dk do
            assert float((w.float() - w0.float()).abs().max()) > 4 * atol
    assert (got[0][~live] == 0).all()


def test_decode_kernel_over_a_fanned_out_cache(card):
    """The grouped rollout's cache: each prompt prefilled once (left
    padding), its K/V rows and segment ids repeated G ways, then each
    rollout's own decode slots after the shared prefix, some already
    frozen at EOS (segment 0)."""
    n, G, Hkv, group, P, D = 2, 4, 2, 6, 200, 128
    S, length = P + 64, P + 37
    B = n * G
    gen = torch.Generator(device=card).manual_seed(5)
    k, v = (_rand(gen, (n, Hkv, S, D), card).repeat_interleave(G, dim=0)
            for _ in range(2))
    seg = torch.ones((n, S), dtype=torch.int32, device=card)
    seg[1, :90] = 0
    seg = seg.repeat_interleave(G, dim=0)
    k[:, :, P:] = _rand(gen, (B, Hkv, S - P, D), card)    # own suffixes
    v[:, :, P:] = _rand(gen, (B, Hkv, S - P, D), card)
    seg[2, P + 5:] = 0
    seg[7, P:] = 0
    assert torch.equal(k[0, :, :P], k[3, :, :P]) and k.is_contiguous()
    q = _rand(gen, (B, Hkv * group, D), card)
    before = k4.KERNEL.launches
    out = k4.decode_attention(q, k, v, seg, length)
    assert k4.KERNEL.launches == before + 1
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert not torch.equal(out[0], out[1])       # a group's rows differ


# head dim 72 (SigLIP's tower): the kernels stage rows at a width of 80
# with zeroed padding columns.  The tower's own shape is T = S = 729
# (11 whole 64-row tiles and one of 25), one segment per tile, non-causal;
# the causal and GQA cases hold the same code under the decoder's masks.
D72_CASES = [
    # B, H, Hkv, T, causal
    (3, 4, 4, 729, False),
    (2, 4, 2, 729, False),
    (2, 4, 4, 729, True),
    (1, 4, 2, 729, True),
]


def _d72_inputs(B, H, Hkv, T, seed, card, cols=None):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, do = _rand(gen, (B, H, T, 72), card), _rand(gen, (B, H, T, 72), card)
    k, v = _rand(gen, (B, Hkv, T, 72), card), _rand(gen, (B, Hkv, T, 72), card)
    if cols is not None:          # data only in these columns
        for t in (q, k, v, do):
            keep = torch.zeros(72, dtype=torch.bool, device=card)
            keep[cols] = True
            t.masked_fill_(~keep, 0.0)
    return q, k, v, do


def _flash_grads(q, k, v, do, causal):
    """(out, lse, dq, dk, dv) of the flash Function: K1, then K2 and K3."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = k1.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad((out.float() * do.float()).sum(), leaves)
    return (out.detach(), lse.detach(), *grads)


def _pad_to_80(q, k, v, do, causal):
    """The wrapper-padding design: q, k, v and dO zero-padded to 80
    columns, the D = 80 kernels at 72's scale, the outputs cut to 72."""
    pad = [torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v, do)]
    leaves = [t.clone().requires_grad_(True) for t in pad[:3]]
    out, lse = k1.flash_attention(*leaves, causal=causal, scale=72 ** -0.5)
    grads = torch.autograd.grad((out.float() * pad[3].float()).sum(), leaves)
    return (out.detach()[..., :72], lse.detach(),
            *(g[..., :72] for g in grads))


def _check_against_plain(got, q, k, v, do, causal):
    out, lse, *grads = got
    seg = torch.ones(q.shape[:1] + q.shape[2:3], dtype=torch.int32,
                     device=q.device)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg,
                                              causal=causal, scale=72 ** -0.5)
    want = k1.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, do, None,
                                      causal=causal, scale=72 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


@pytest.mark.parametrize("pad", ["in-kernel", "wrapper"])
@pytest.mark.parametrize("case", D72_CASES,
                         ids=["-".join(map(str, c)) for c in D72_CASES])
def test_flash_kernels_at_head_dim_72(card, case, pad):
    """K1, K2 and K3 at D = 72 against the plain versions; the in-kernel
    padding (the port's design) and the wrapper padding to 80 (the
    design it was timed against) are held to the same limits."""
    B, H, Hkv, T, causal = case
    q, k, v, do = _d72_inputs(B, H, Hkv, T, 72 + T + H, card)
    before = (k1.KERNEL.launches, k1.DQ_KERNEL.launches,
              k1.DKV_KERNEL.launches)
    run = _flash_grads if pad == "in-kernel" else _pad_to_80
    got = run(q, k, v, do, causal)
    assert (k1.KERNEL.launches, k1.DQ_KERNEL.launches,
            k1.DKV_KERNEL.launches) == tuple(n + 1 for n in before)
    _check_against_plain(got, q, k, v, do, causal)


@pytest.mark.parametrize("group", [1, 2])
def test_flash_kernels_reduce_over_columns_64_to_71(card, group):
    """Data only in columns 64-71 of q, k, v and dO: a kernel that reduced
    over the first 64 columns only would give uniform softmax rows, zero
    dq and dk, and out, dv without those columns' values."""
    q, k, v, do = _d72_inputs(2, 4, 4 // group, 300, 7 + group, card,
                              cols=slice(64, 72))
    got = _flash_grads(q * 4, k * 4, v, do, causal=False)
    assert float(got[2].float().abs().max()) > 0          # dq
    _check_against_plain(got, q * 4, k * 4, v, do, causal=False)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_at_gqa_group_7(card, D):
    """The decoder of LLaVA-OneVision-0.5B (14 heads over 2 KV heads):
    stacked query rows of a 64-row block cross a head boundary at every
    T that is not a multiple of 64; packed segments with padding."""
    B, H, Hkv, T = 2, 14, 2, 300
    gen = torch.Generator(device=card).manual_seed(70 + D)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    seg = torch.randint(0, 3, (B, T), generator=gen, device=card,
                        dtype=torch.int32).sort(dim=1).values
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = k1.flash_attention(*leaves, segment_ids=seg, causal=True)
    got = torch.autograd.grad((out.float() * do.float()).sum(), leaves)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg, causal=True,
                                              scale=D ** -0.5)
    want = k1.flash_attention_bwd_ref(q, k, v, seg, seg, out.detach(),
                                      lse.detach(), do, None, causal=True,
                                      scale=D ** -0.5)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


def _qwen25_tower_segments(kind, card):
    """Qwen2.5-VL's window-ordered tower stream at its published window
    (112 pixels: 8 x 8 patches): a 448 x 448 image (every window whole,
    each 64-row block one window) and a 336 x 504 one (its last window
    column cut to 32 patches, so blocks span two windows), padded to 2048;
    the per-window or the per-image segment ids."""
    import numpy as np

    from iadr1_tpu_torch.models.qwen25_vl import (
        Qwen25VLVisionConfig,
        qwen25vl_vision_arrays,
    )

    grids = {"aligned": [(1, 32, 32), (1, 32, 32)],
             "partial": [(1, 24, 36), (1, 32, 32)]}
    arrs = qwen25vl_vision_arrays(np.asarray(grids[kind[0]]),
                                  Qwen25VLVisionConfig(), pad_to=2048)
    seg = arrs["window_segs" if kind[1] == "window" else "full_segs"]
    return torch.as_tensor(seg, dtype=torch.int32, device=card)[None]


@pytest.mark.parametrize("kind", [("aligned", "window"),
                                  ("partial", "window"),
                                  ("partial", "full")],
                         ids=["-".join(k) for k in (("aligned", "window"),
                                                    ("partial", "window"),
                                                    ("partial", "full"))])
def test_flash_kernels_at_the_qwen25_vl_tower(card, kind):
    """K1-K3 over Qwen2.5-VL's tower stream (16 heads, D = 80,
    non-causal): window segments whose edges fall on the 64-row blocks and
    key tiles, windows cut at an image's edge, and whole images."""
    seg = _qwen25_tower_segments(kind, card)
    T, D = seg.shape[1], 80
    gen = torch.Generator(device=card).manual_seed(90)
    q, k, v, do = (_rand(gen, (1, 16, T, D), card) for _ in range(4))
    out, lse = k1.flash_attention(q, k, v, segment_ids=seg, causal=False)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg,
                                              causal=False, scale=D ** -0.5)
    (dq, dk, dv), want, _, _ = _bwd_grads(q, k, v, do, seg, seg, False)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    assert valid.sum() == 16 * int((seg != 0).sum())
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    assert (out[~valid] == 0).all()
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


@pytest.mark.parametrize("H,Hkv", [(28, 4), (16, 2)], ids=["gqa7", "gqa8"])
def test_flash_kernels_at_the_qwen25_vl_decoders(card, H, Hkv):
    """K1-K3 at Qwen2.5-VL-7B's (28 heads over 4) and -3B's (16 over 2)
    decoder attention, D = 128: left-padded rows, causal, T = 300 (stacked
    query rows cross a head boundary inside a 64-row block)."""
    B, T, D = 2, 300, 128
    gen = torch.Generator(device=card).manual_seed(H)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    seg = _bwd_segments("leftpad", B, T, gen, card)
    out, lse = k1.flash_attention(q, k, v, segment_ids=seg, causal=True)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg, causal=True,
                                              scale=D ** -0.5)
    (dq, dk, dv), want, _, _ = _bwd_grads(q, k, v, do, seg, seg, True)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


@pytest.mark.parametrize("B,H,Hkv,S", [(4, 28, 4, 1152), (8, 16, 2, 4608)],
                         ids=["7b-serve", "3b-grpo-fan-out"])
def test_decode_kernel_at_the_qwen25_vl_decoders(card, B, H, Hkv, S):
    """K4 at GQA 7 (the 7B serving cache) and GQA 8 (the 3B SC-GRPO cache,
    P + N = 4096 + 512), D = 128, at a length inside the last chunk, left
    padding and a dead span."""
    D, length = 128, S - 37
    gen = torch.Generator(device=card).manual_seed(S)
    q = _rand(gen, (B, H, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[:, :100] = 0
    seg[1, 500:700] = 0
    v[:, :, length:] = float("nan")             # never read past length
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def _check_flash(q, k, v, do, seg, causal):
    """K1-K3 through the flash Function against the plain versions; rows
    with no valid key come out 0."""
    D = q.shape[-1]
    out, lse = k1.flash_attention(q, k, v, segment_ids=seg, causal=causal)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg,
                                              causal=causal, scale=D ** -0.5)
    (dq, dk, dv), want, _, _ = _bwd_grads(q, k, v, do, seg, seg, causal)
    torch.cuda.synchronize()
    valid = torch.isfinite(ref_lse)
    torch.testing.assert_close(out[valid].float(), ref_out[valid].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-3, rtol=0)
    assert (out[~valid] == 0).all() and torch.isposinf(lse[~valid]).all()
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)
    return valid


def test_flash_kernels_at_the_clip_tower(card):
    """K1-K3 at LLaVA-1.5/NeXT's CLIP-L tower: each tile its own sequence
    of 577 tokens (576 patches + CLS: nine 64-row blocks and one row), 16
    heads, D = 64, non-causal; three image tiles and two padding tiles,
    the latter at segment 0 (out 0, no gradient)."""
    B, H, T, D = 5, 16, 577, 64
    gen = torch.Generator(device=card).manual_seed(577)
    q, k, v, do = (_rand(gen, (B, H, T, D), card) for _ in range(4))
    seg = torch.zeros((B, T), dtype=torch.int32, device=card)
    seg[:3] = 1
    valid = _check_flash(q, k, v, do, seg, causal=False)
    assert valid[:3].all() and not valid[3:].any()


@pytest.mark.parametrize("H,Hkv", [(32, 8), (32, 32)],
                         ids=["gqa4-llama3", "gqa1-vicuna"])
def test_flash_kernels_at_the_llava_decoders(card, H, Hkv):
    """K1-K3 at LLaMA-3-8B's (32 heads over 8: GQA 4) and Vicuna-7B's (32
    over 32) decoder attention, D = 128: left-padded rows, causal, T =
    300 (stacked query rows cross a head boundary inside a block)."""
    B, T, D = 2, 300, 128
    gen = torch.Generator(device=card).manual_seed(H + Hkv)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    _check_flash(q, k, v, do, _bwd_segments("leftpad", B, T, gen, card),
                 causal=True)


@pytest.mark.parametrize("B,H,Hkv,S,D", [(4, 32, 8, 4224, 128),
                                         (4, 32, 32, 1152, 128),
                                         (8, 14, 2, 4608, 64)],
                         ids=["llama3-serve", "vicuna-serve",
                              "onevision-grpo-fan-out"])
def test_decode_kernel_at_the_llava_decoders(card, B, H, Hkv, S, D):
    """K4 at GQA 4 (LLaVA-NeXT-8B's serving cache), GQA 1 (LLaVA-1.5-7B's)
    and over LLaVA-OneVision-0.5B's SC-GRPO fan-out (GQA 7, D = 64, P + N
    = 4096 + 512), at a length inside the last chunk, left padding and a
    dead span."""
    length = S - 37
    gen = torch.Generator(device=card).manual_seed(S + H)
    q = _rand(gen, (B, H, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[:, :100] = 0
    seg[1, 500:700] = 0
    v[:, :, length:] = float("nan")             # never read past length
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_full_precision_forward_raises_under_auto_and_runs_under_xla(card):
    """The kernels take bf16 only: a FULL_PRECISION bundle under 'auto'
    raises on the card (naming attention="xla") instead of giving way to
    the dense path, and the same bundle built with attention="xla" runs
    its prefill and a decode step in f32 and launches no kernel."""
    from iadr1_tpu_torch.core.precision import FULL_PRECISION
    from iadr1_tpu_torch.models import qwen2
    from iadr1_tpu_torch.models.registry import make_qwen2_bundle

    hf = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, tie_word_embeddings=True)
    ids = torch.randint(0, 256, (2, 40), device=card)
    batch = {"input_ids": ids,
             "position_ids": torch.arange(40, device=card).expand(2, 40),
             "segment_ids": torch.ones_like(ids, dtype=torch.int32)}
    auto = make_qwen2_bundle(hf, precision=FULL_PRECISION)
    params = auto.init_params(seed=0, device=card)
    with torch.no_grad(), pytest.raises(TypeError, match='attention="xla"'):
        auto.apply(params, batch)

    bundle = make_qwen2_bundle(hf, attention="xla", precision=FULL_PRECISION)
    before = (k1.KERNEL.launches, k4.KERNEL.launches)
    cache = qwen2.init_cache(bundle.cfg, 2, 41, torch.float32, card)
    with torch.no_grad():
        h, cache = bundle.apply(params, batch, cache=cache,
                                cache_mode="prefill")
        h1, _ = bundle.apply(
            params, {"input_ids": ids[:, :1],
                     "position_ids": torch.full((2, 1), 40, device=card),
                     "segment_ids": torch.ones((2, 1), dtype=torch.int32,
                                               device=card)},
            cache=cache, cache_mode="decode")
    torch.cuda.synchronize()
    assert h.dtype == torch.float32 and torch.isfinite(h).all()
    assert torch.isfinite(h1).all()
    assert (k1.KERNEL.launches, k4.KERNEL.launches) == before


# ---------------------------------------------------------------------------
# the quantized dense and the factored LoRA dense (plain PyTorch on the
# card, no hand kernel: the JAX package runs them outside Pallas) in bf16
# against their f32 versions on the CPU; bf16 activations round to 2^-8
# relative a few times over, so 3e-2 of the reference's largest value
# ---------------------------------------------------------------------------


def _rel(got, want):
    return float((got.float().cpu() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("fmt", ["int8", "int4", "nf4"])
def test_quantized_dense_on_the_card(card, fmt):
    from iadr1_tpu_torch.models import quant
    from iadr1_tpu_torch.models.common import dense

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((512, 384), generator=gen) * 0.05
    x = torch.randn((4, 64, 512), generator=gen)
    qk = quant.quantize_kernel(w, fmt)
    on_card = quant.quantize_kernel(w.to(card), fmt)
    for k in qk:                  # the card quantizes bit for bit alike
        assert torch.equal(on_card[k].cpu(), qk[k]), k
    got = dense(x.to(card, torch.bfloat16), on_card)
    assert got.dtype == torch.bfloat16
    assert _rel(got, dense(x, qk)) < 3e-2


@pytest.mark.parametrize("dora", [False, True], ids=["lora", "dora"])
def test_lora_dense_on_the_card(card, dora):
    from iadr1_tpu_torch.models import quant
    from iadr1_tpu_torch.models.qwen2 import lora_dense

    gen = torch.Generator().manual_seed(1)
    w = torch.randn((256, 192), generator=gen) * 0.05
    ab = {"a": torch.randn((256, 8), generator=gen) * 0.05,
          "b": torch.randn((8, 192), generator=gen) * 0.05}
    if dora:
        ab["m"] = torch.rand((192,), generator=gen) + 0.5
    x = torch.randn((2, 32, 256), generator=gen)
    bias = torch.randn((192,), generator=gen) * 0.1
    qk = quant.quantize_kernel(w, "nf4")
    want = lora_dense(x, qk, bias, ab, 2.0)
    got = lora_dense(x.to(card, torch.bfloat16),
                     {k: v.to(card) for k, v in qk.items()},
                     bias.to(card, torch.bfloat16),
                     {k: v.to(card, torch.bfloat16) for k, v in ab.items()},
                     2.0)
    assert _rel(got, want) < 3e-2


def test_flash_kernels_at_the_internvit_tower(card):
    """K1-K3 at InternVL's InternViT tower: 24 tiles, each its own
    sequence of 1025 tokens (1024 patches + CLS: sixteen 64-row blocks and
    one row), 16 heads, D = 64, non-causal; the last tile pads the budget
    at segment 0 (out 0, lse +inf, no gradient); the backward also takes
    a non-zero lse cotangent."""
    B, H, T, D = 24, 16, 1025, 64
    gen = torch.Generator(device=card).manual_seed(1025)
    q, k, v, do = (_rand(gen, (B, H, T, D), card) for _ in range(4))
    seg = torch.ones((B, T), dtype=torch.int32, device=card)
    seg[-1] = 0
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = k1.flash_attention(*leaves, segment_ids=seg, causal=False)
    ref_out, ref_lse = k1.flash_attention_ref(q, k, v, seg, seg, causal=False,
                                              scale=D ** -0.5)
    torch.cuda.synchronize()
    live = (seg != 0)[:, None, :].expand(B, H, T)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(out[live].float(), ref_out[live].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    assert (out[~live] == 0).all()
    dlse = torch.randn(lse.shape, generator=gen, device=card) * live
    got = torch.autograd.grad(
        (out.float() * do.float()).sum()
        + torch.where(live, lse * dlse, 0.0).sum(), leaves)
    want = k1.flash_attention_bwd_ref(q, k, v, seg, seg, out.detach(),
                                      lse.detach(), do, dlse, causal=False,
                                      scale=D ** -0.5)
    torch.cuda.synchronize()
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), label
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=label)
        assert (g[-1] == 0).all(), label


def test_video_frame_rollout_tokens_equal_the_plain_path(card, monkeypatch):
    """A LLaVA-NeXT-Video rollout on the card (a small config at the
    kernels' head dims: tower D = 64, decoder D = 128), two video prompts
    of 3 frames through the GRPO prompt collator, greedy: the tokens of
    the kernel path (K1 over the frames and the prefill, K4 a decode step)
    equal those of the plain versions on the same weights."""
    import types

    from iadr1_tpu_torch.cli.train_grpo import (
        GRPODataSection,
        make_vlm_prompt_collator,
    )
    from iadr1_tpu_torch.models import attention
    from iadr1_tpu_torch.models.registry import bundle_from_hf_config
    from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
    from iadr1_tpu_torch.train.sft import batch_to_device

    hf = dict(architectures=["LlavaNextVideoForConditionalGeneration"],
              text_config=dict(model_type="llama", vocab_size=64,
                               hidden_size=256, intermediate_size=512,
                               num_hidden_layers=2, num_attention_heads=2,
                               num_key_value_heads=2),
              vision_config=dict(hidden_size=128, intermediate_size=256,
                                 num_hidden_layers=3, num_attention_heads=2,
                                 image_size=56, patch_size=14),
              image_token_index=5, video_token_index=6,
              spatial_pool_stride=2)
    bundle = bundle_from_hf_config(hf)
    params = bundle.init_params(seed=0, dtype=torch.bfloat16, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    for leaf in (params["text"]["embed"]["weight"],
                 params["text"]["lm_head"]["kernel"]):
        leaf.add_(torch.randn(leaf.shape, generator=gen, device=card,
                              dtype=leaf.dtype))
    g = torch.Generator().manual_seed(1)
    examples = []
    for i in range(2):
        frames = torch.rand((3, 16, 588), generator=g).numpy()
        ids = ([1] + torch.randint(7, 64, (3 + i,), generator=g).tolist()
               + [6] * 12 + torch.randint(7, 64, (4,), generator=g).tolist())
        examples.append({"prompt_ids": ids, "video_patches": [frames]})
    tok = types.SimpleNamespace(eos_token_id=2, pad_token_id=0)
    batch = batch_to_device(make_vlm_prompt_collator(
        bundle, tok, None, GRPODataSection(patch_budget=6 * 16), 32, 1)(
            examples, 1), card)
    engine = RolloutEngine(bundle, SamplingConfig(
        max_new_tokens=6, temperature=0.0, eos_token_id=-1, pad_token_id=0),
        max_len=38, device=card)
    launches = k1.KERNEL.launches
    got = engine.generate(params, batch)["completion_ids"]
    assert k1.KERNEL.launches > launches

    def plain_flash(q, k, v, *, segment_ids=None, kv_segment_ids=None,
                    causal=True, scale=None):
        segs = k1._default_segments(q, k, segment_ids, kv_segment_ids)
        return k1.flash_attention_ref(q, k, v, *segs, causal=causal,
                                      scale=q.shape[-1] ** -0.5)

    def plain_decode(q, k, v, seg, length):
        return k4.decode_attention_ref(q, k, v, seg, length,
                                       scale=q.shape[-1] ** -0.5)

    monkeypatch.setattr(attention, "flash_attention", plain_flash)
    monkeypatch.setattr(attention, "decode_attention", plain_decode)
    launches = (k1.KERNEL.launches, k4.KERNEL.launches)
    want = engine.generate(params, batch)["completion_ids"]
    assert (k1.KERNEL.launches, k4.KERNEL.launches) == launches
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 200, 520])
def test_decode_kernel_at_head_dim_256_group_8(card, length):
    """K4 at its largest head dim and group together (PaliGemma's Gemma-2B
    decode: 8 heads over 1, D = 256, about 78 KB of shared memory a
    block): the chunk edges, whole dead chunks, and slots past ``length``
    filled with NaN (never read)."""
    B, H, Hkv, S, D = 3, 8, 1, 520, 256
    gen = torch.Generator(device=card).manual_seed(length + 256)
    q = _rand(gen, (B, H, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[0, :130] = 0
    seg[1, 64:128] = 0
    seg[2, 3:5] = 0
    k[:, :, length:] = float("nan")
    v[:, :, length:] = float("nan")
    before = k4.KERNEL.launches
    out = k4.decode_attention(q, k, v, seg, length)
    assert k4.KERNEL.launches == before + 1
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,S", [(4, 2176), (8, 4608)],
                         ids=["paligemma-serve", "paligemma-grpo-fan-out"])
def test_decode_kernel_at_the_paligemma_decoder(card, B, S):
    """K4 at PaliGemma-3B's serving cache (P + N = 2048 + 128) and over its
    SC-GRPO fan-out (8 rows of 4096 + 512), D = 256, group 8, left padding
    and a dead span."""
    H, Hkv, D, length = 8, 1, 256, S - 37
    gen = torch.Generator(device=card).manual_seed(S + B)
    q = _rand(gen, (B, H, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    seg[:, :100] = 0
    seg[1, 500:700] = 0
    v[:, :, length:] = float("nan")
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_flash_kernels_at_the_siglip_448_tower(card):
    """K1-K3 at PaliGemma-448's SigLIP tower: each tile its own sequence
    of 1024 patches (sixteen whole 64-row blocks), 16 heads, D = 72
    (staged at 80), non-causal; the last two tiles pad the budget at
    segment 0 (out 0, no gradient)."""
    B, H, T, D = 6, 16, 1024, 72
    gen = torch.Generator(device=card).manual_seed(448)
    q, k, v, do = (_rand(gen, (B, H, T, D), card) for _ in range(4))
    seg = torch.zeros((B, T), dtype=torch.int32, device=card)
    seg[:4] = 1
    valid = _check_flash(q, k, v, do, seg, causal=False)
    assert valid[:4].all() and not valid[4:].any()


def test_flash_kernels_over_the_pixtral_patch_stream(card):
    """K1-K3 at Pixtral's tower: one row holding the batch's packed patch
    stream (images of 1024, 735, 735 and 3072 patches, one segment each,
    the budget's tail at 0), 16 heads, D = 64, non-causal: segments that
    end inside a 64-row block, a block-diagonal mask far from the
    diagonal's tiles."""
    H, D, sizes, budget = 16, 64, (1024, 735, 735, 3072), 6144
    gen = torch.Generator(device=card).manual_seed(5566)
    q, k, v, do = (_rand(gen, (1, H, budget, D), card) for _ in range(4))
    seg = torch.zeros((1, budget), dtype=torch.int32, device=card)
    off = 0
    for i, n in enumerate(sizes):
        seg[0, off:off + n] = i + 1
        off += n
    valid = _check_flash(q, k, v, do, seg, causal=False)
    assert valid[0, :, :off].all() and not valid[0, :, off:].any()


def test_flash_kernels_at_the_pixtral_decoder(card):
    """K1-K3 at Mistral-NeMo's decoder attention (Pixtral-12B: 32 heads
    over 8, head_dim 128): left-padded rows, causal, T = 1100 (a last
    block of 12 rows)."""
    B, H, Hkv, T, D = 2, 32, 8, 1100, 128
    gen = torch.Generator(device=card).manual_seed(12)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    _check_flash(q, k, v, do, _bwd_segments("leftpad", B, T, gen, card),
                 causal=True)


def test_flash_kernels_at_the_qwen15_moe_decoder(card):
    """K1-K3 at Qwen1.5-MoE-A2.7B's attention (16 heads over 16, head_dim
    128, no GQA): left-padded rows, causal, T = 1100."""
    B, H, T, D = 2, 16, 1100, 128
    gen = torch.Generator(device=card).manual_seed(15)
    q, k, v, do = (_rand(gen, (B, H, T, D), card) for _ in range(4))
    _check_flash(q, k, v, do, _bwd_segments("leftpad", B, T, gen, card),
                 causal=True)


@pytest.mark.parametrize("B,S", [(4, 1152), (8, 1152)],
                         ids=["serve", "grpo_fanout"])
def test_decode_kernel_at_the_qwen15_moe_decoder(card, B, S):
    """K4 at group 1, D = 128 over Qwen1.5-MoE's serving cache (P = 1024 +
    128) and its SC-GRPO fan-out, left padding in every row."""
    H = Hkv = 16
    D, length = 128, S - 5
    gen = torch.Generator(device=card).manual_seed(B + S)
    q = _rand(gen, (B, H, D), card)
    k, v = _rand(gen, (B, Hkv, S, D), card), _rand(gen, (B, Hkv, S, D), card)
    seg = torch.ones((B, S), dtype=torch.int32, device=card)
    for b in range(B):
        seg[b, :40 * b] = 0
    out = k4.decode_attention(q, k, v, seg, length)
    ref = k4.decode_attention_ref(q, k, v, seg, length, scale=D ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_longlora_runs_k1_to_k3_on_the_grouped_views(card):
    """LongLoRA's shift-short attention over the flash Function (32 heads
    over 8, D = 128, T = 2048 in groups of 512: each half 16 heads over 4
    on [4, 512] views, the rolled half's last group wrapping into the
    first) against the same over the dense attention, from the same bf16
    inputs; out and the gradients within 2e-2 plus 1e-2 of the largest."""
    from iadr1_tpu_torch.models import attention as tattn

    B, T, H, Hkv, D = 1, 2048, 32, 8, 128
    gen = torch.Generator(device=card).manual_seed(2048)
    q, do = _rand(gen, (B, T, H, D), card), _rand(gen, (B, T, H, D), card)
    k, v = _rand(gen, (B, T, Hkv, D), card), _rand(gen, (B, T, Hkv, D), card)
    seg = torch.ones((B, T), dtype=torch.int32, device=card)
    seg[0, 1500:] = 2                               # two packed examples

    def run(inner):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = tattn.make_longlora_attention(inner)(
            *leaves, q_segments=seg, kv_segments=seg, causal=True)
        return [out] + list(torch.autograd.grad(out, leaves, do))

    got, want = run(tattn.flash_attn), run(tattn.xla_attn)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2e-2,
            atol=1e-2 * float(w.float().abs().max()) + 1e-6, msg=name)


def test_flash_kernels_at_mod_gathered_rows(card):
    """K1-K3 at Mixture-of-Depths' gathered rows of Qwen2-VL-2B's decoder
    (12 heads over 2, D = 128): k = 512 rows picked from packed rows of
    4096, so each row holds the sorted runs of its segments, padding
    picked last at segment 0."""
    B, H, Hkv, T, D = 2, 12, 2, 512, 128
    gen = torch.Generator(device=card).manual_seed(512)
    q, do = _rand(gen, (B, H, T, D), card), _rand(gen, (B, H, T, D), card)
    k, v = _rand(gen, (B, Hkv, T, D), card), _rand(gen, (B, Hkv, T, D), card)
    seg = torch.ones((B, T), dtype=torch.int32, device=card)
    seg[0, 200:] = 2
    seg[0, 350:] = 3
    seg[1, 480:] = 0
    _check_flash(q, k, v, do, seg, causal=True)


# ---------------------------------------------------------------------------
# preference updates: a DPO step and a PPO minibatch update through K1-K3
# against the same steps over the dense attention (the plain path), from
# the same f32 parameters and batch in bf16 compute; each attention call
# rounds at other places (2^-8 relative), so metrics within 2e-2 relative
# ---------------------------------------------------------------------------


PREF_HF = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, tie_word_embeddings=True)


def _pref_steps(card, make_step, batch, tree_of, ref_seed=0):
    """Step 1 of ``make_step(score_fn, optimizer)`` over the kernels and
    over the dense attention: (metrics, metrics), and the kernels'
    launches during the first.  The reference (a teacher for GKD) is the
    bf16 parameters of ``ref_seed``."""
    from iadr1_tpu_torch.models.registry import make_qwen2_bundle
    from iadr1_tpu_torch.train.grpo import bundle_score_fn
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state

    out = []
    for attention in ("flash", "xla"):
        bundle = make_qwen2_bundle(PREF_HF, attention=attention)
        params = bundle.init_params(seed=0, device=card)
        opt, _ = make_optimizer(OptimizerConfig(learning_rate=1e-4,
                                                total_steps=4))
        state = create_train_state(tree_of(params), opt)
        ref = bundle.init_params(seed=ref_seed, dtype=torch.bfloat16,
                                 device=card)
        before = k1.KERNEL.launches
        _, m = make_step(bundle_score_fn(bundle), opt)(state, ref, batch)
        torch.cuda.synchronize()
        out.append(({k: float(v) for k, v in m.items()},
                    k1.KERNEL.launches - before))
    return out


def _check_pref_metrics(got, want, keys):
    for key in keys:
        assert abs(got[key] - want[key]) <= 2e-2 * abs(want[key]) + 1e-4, (
            key, got[key], want[key])


def test_dpo_step_on_the_kernels_matches_the_plain_path(card):
    """2 pairs of 200-token rows (ragged, right-padded): the sigmoid loss
    with a bf16 reference; K1 runs once a layer for the reference and once
    for the policy."""
    from iadr1_tpu_torch.train.preference import DPOConfig, make_dpo_step

    gen = torch.Generator(device=card).manual_seed(15)
    T = 200
    ids = torch.randint(3, 512, (4, T), generator=gen, device=card)
    labels = ids.clone()
    segs = torch.ones((4, T), dtype=torch.int32, device=card)
    for i in range(4):
        labels[i, :60] = -100
        labels[i, T - 13 * i:] = -100
        segs[i, T - 13 * i:] = 0
    batch = {"input_ids": ids, "labels": labels, "segment_ids": segs,
             "position_ids": torch.arange(T, device=card).expand(4, T)}
    (got, launches), (want, dense) = _pref_steps(
        card, lambda score, opt: make_dpo_step(score, opt, DPOConfig()),
        batch, lambda p: p)
    assert launches == 2 * PREF_HF["num_hidden_layers"] and dense == 0
    _check_pref_metrics(got, want, ("loss", "grad_norm", "rewards/chosen",
                                    "rewards/rejected"))


def test_ppo_update_on_the_kernels_matches_the_plain_path(card):
    """One PPO minibatch row of P + N = 96 + 64 (a left-padded prompt, an
    early EOS), clipped surrogate and value loss."""
    from iadr1_tpu_torch.train.ppo import (
        PPOConfig,
        make_ppo_state_params,
        make_ppo_update_step,
    )

    gen = torch.Generator(device=card).manual_seed(16)
    P, N = 96, 64
    ids = torch.randint(3, 512, (1, P + N), generator=gen, device=card)
    segs = torch.ones((1, P + N), dtype=torch.int32, device=card)
    segs[0, :20] = 0
    mask = torch.ones((1, N), dtype=torch.int32, device=card)
    mask[0, 40:] = 0
    segs[0, P:] = mask[0]

    def noise(scale):
        return torch.randn((1, N), generator=gen, device=card) * scale

    batch = {"input_ids": ids, "segment_ids": segs,
             "position_ids": (segs.cumsum(1) - 1).clamp(min=0),
             "completion_ids": ids[:, P:], "completion_mask": mask,
             "prompt_len": P, "old_logps": noise(0.1) - 6.0,
             "old_values": noise(0.5), "advantages": noise(1.0),
             "returns": noise(1.0)}
    (got, launches), (want, _) = _pref_steps(
        card, lambda score, opt: make_ppo_update_step(score, opt,
                                                      PPOConfig()),
        batch, lambda p: make_ppo_state_params(p, PREF_HF["hidden_size"]))
    assert launches == PREF_HF["num_hidden_layers"]
    _check_pref_metrics(got, want, ("loss", "pg_loss", "vf_loss",
                                    "grad_norm"))


def _ragged_rows(card, seed, n, P, N):
    """n rows of P + N: a left-padded prompt and a completion that ends
    early, the completion labeled."""
    gen = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(3, 512, (n, P + N), generator=gen, device=card)
    segs = torch.ones((n, P + N), dtype=torch.int32, device=card)
    for i in range(n):
        segs[i, :10 + 15 * i] = 0
        segs[i, P + N - 9 * (i + 1):] = 0
    labels = torch.where(segs.bool(), ids, -100)
    labels[:, :P] = -100
    return {"input_ids": ids, "labels": labels, "segment_ids": segs,
            "position_ids": (segs.cumsum(1) - 1).clamp(min=0)}


def test_xpo_step_on_the_kernels_matches_the_plain_path(card):
    """XPO's update rows (the policy's 2 completions, then the
    reference's), sigmoid loss, a bf16 reference: K1 once a layer for the
    reference and once for the policy."""
    from iadr1_tpu_torch.train.online_rl import XPOConfig, make_xpo_update_step

    batch = _ragged_rows(card, 17, 4, 96, 64)
    batch["chosen_mask"] = torch.tensor([True, False], device=card)
    (got, launches), (want, dense) = _pref_steps(
        card, lambda score, opt: make_xpo_update_step(
            score, opt, XPOConfig(alpha=0.05)), batch, lambda p: p)
    assert launches == 2 * PREF_HF["num_hidden_layers"] and dense == 0
    _check_pref_metrics(got, want, ("loss", "loss/dpo", "loss/xpo",
                                    "grad_norm"))


def test_gkd_step_on_the_kernels_matches_the_plain_path(card):
    """GKD's chunked JSD against a teacher of another seed: K1 once a
    layer for the teacher and once for the student."""
    from iadr1_tpu_torch.train.gkd import GKDConfig, make_gkd_step

    batch = _ragged_rows(card, 18, 2, 96, 64)
    (got, launches), (want, dense) = _pref_steps(
        card, lambda score, opt: make_gkd_step(
            score, score, opt, GKDConfig(logit_chunk_size=100)), batch,
        lambda p: p, ref_seed=1)
    assert launches == 2 * PREF_HF["num_hidden_layers"] and dense == 0
    _check_pref_metrics(got, want, ("loss", "n_label_tokens", "grad_norm"))


def test_mixture_decode_step_on_the_kernels_matches_the_plain_path(
        card, monkeypatch):
    """generate_mixture over the kernels (K1 for both prefills, K4 over
    both caches each decode step) against the dense attention: the mixed
    log-probabilities of the prefill and of the first decode step, both
    paths fed the same tokens (the sampler replaced by fixed ones: in
    bf16 a greedy choice between near-equal logits may differ)."""
    from iadr1_tpu_torch.models.registry import make_qwen2_bundle
    from iadr1_tpu_torch.train import rollout

    gen = torch.Generator(device=card).manual_seed(19)
    P = 48
    ids = torch.randint(3, 512, (2, P), generator=gen, device=card)
    mask = torch.ones((2, P), dtype=torch.int64, device=card)
    mask[1, :17] = 0
    batch = {"input_ids": ids, "attention_mask": mask}
    seen = {}
    mix = rollout.mix_log_probs

    def record(*args):
        out = mix(*args)
        seen.setdefault(attention, []).append(out.float())
        return out

    monkeypatch.setattr(rollout, "mix_log_probs", record)
    monkeypatch.setattr(rollout, "sample_token", lambda logits, *a: (
        torch.tensor([5, 7], device=logits.device)))
    L = PREF_HF["num_hidden_layers"]
    for attention in ("flash", "xla"):
        bundle = make_qwen2_bundle(PREF_HF, attention=attention)
        policy = bundle.init_params(seed=0, dtype=torch.bfloat16, device=card)
        ref = bundle.init_params(seed=1, dtype=torch.bfloat16, device=card)
        engine = rollout.RolloutEngine(
            bundle, rollout.SamplingConfig(max_new_tokens=2, temperature=0.0,
                                           eos_token_id=1, pad_token_id=0),
            max_len=P + 2, device=card)
        before = (k1.KERNEL.launches, k4.KERNEL.launches)
        out = engine.generate_mixture(policy, ref, 0.5, batch)
        torch.cuda.synchronize()
        if attention == "flash":
            assert (k1.KERNEL.launches - before[0],
                    k4.KERNEL.launches - before[1]) == (
                2 * L, 2 * L * out["num_decode_steps"])
    assert len(seen["flash"]) == len(seen["xla"]) == 3
    for got, want in zip(seen["flash"][:2], seen["xla"][:2]):
        assert (got - want).abs().max() < 5e-2
