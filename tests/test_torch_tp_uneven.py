"""The tp rollout where tp divides nothing, DoRA under it, and the MoE's
experts over tp: every rank's ``tp_local_params`` copy (an adapter tree's
through ``tp_local_lora``) run as tp = 4 ranks one after another in one
process (``core.tensor_parallel.run_sequential_ranks``, the rank-ordered
sum as the all-reduce), against the unsharded rollout on the same
parameters.

The tiny decoder has 6 query heads over 2 KV heads of 16 (shares 2, 2, 1,
1; the KV heads each rank's queries read), a vocabulary of 250 (shares of
63, the last 61, each padded to 63), an MLP of 90 (23, 23, 22, 22) and,
for the int4 base, down kernels in 9 blocks of 10 rows (3, 2, 2, 2
blocks; DoRA's factors over it split by the same blocks).  The MoE's 5 experts split 2, 1, 1, 1.  Each rank must draw the
unsharded rollout's sampled tokens (an f32 cache on both sides) and give
its prefill logits within ``UNEVEN_LOGITS_ATOL``; dropping the last rank's
partial sums must move them 100x past it.
"""

import numpy as np
import pytest
import torch

from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry
import torch_threads  # noqa: F401  (one intra-op thread)

# the prefill logits against the unsharded rollout's: about 3x the largest
# reading over the five cases (8.9e-7, the int4 base's; the logits reach
# 1.9, the controls move them by 1.07-1.67)
UNEVEN_LOGITS_ATOL = 3e-6
TP = 4

TEXT = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
            vocab_size=250, hidden_size=48, intermediate_size=90,
            num_hidden_layers=2, num_attention_heads=6,
            num_key_value_heads=2, head_dim=16, tie_word_embeddings=False)
MOE = dict(TEXT, architectures=["Qwen2MoeForCausalLM"],
           model_type="qwen2_moe", num_experts=5, num_experts_per_tok=2,
           moe_intermediate_size=24, shared_expert_intermediate_size=90,
           norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[])


def _case(name):
    """(bundle, base parameters, adapter tree or None, the lora scale)."""
    from iadr1_tpu_torch.models.quant import quantize_tree
    from iadr1_tpu_torch.train.adapters import TuningConfig, init_lora_params

    bundle = registry.bundle_from_hf_config(MOE if name == "moe" else TEXT,
                                            precision=FULL_PRECISION)
    params = bundle.init_params(seed=0, dtype=torch.float32, device="cpu")
    if name.startswith("int4"):
        params = quantize_tree(params, fmt="int4", block_size=16)
    if not name.endswith("dora"):
        return bundle, params, None, 1.0
    tuning = TuningConfig(finetuning_type="lora", lora_rank=4,
                          lora_alpha=8.0, use_dora=True)
    gen = torch.Generator().manual_seed(2)
    lora = init_lora_params(gen, params, tuning)

    def perturb(tree):
        # B away from 0 and m away from the base's norms, so that the
        # direction and its column norms both move
        if isinstance(tree, dict):
            if "m" in tree:
                tree["b"] = torch.randn(tree["b"].shape, generator=gen) * 0.1
                tree["m"] = tree["m"] * (1 + 0.1 * torch.rand(
                    tree["m"].shape, generator=gen))
                return
            for v in tree.values():
                perturb(v)

    perturb(lora)
    return bundle, params, lora, tuning.lora_scale


@pytest.mark.parametrize("name", ["dense", "int4", "dora", "int4_dora",
                                  "moe"])
def test_the_uneven_tp_rollout_as_sequential_ranks_equals_the_unsharded(
        name):
    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks
    from iadr1_tpu_torch.train.rollout import (
        RolloutEngine,
        SamplingConfig,
        tp_local_lora,
        tp_local_params,
    )

    bundle, params, lora, scale = _case(name)
    gen = torch.Generator().manual_seed(1)
    B, P = 3, 7
    mask = torch.ones(B, P, dtype=torch.int64)
    mask[0, :2] = 0
    batch = {"input_ids": torch.randint(3, 250, (B, P), generator=gen),
             "attention_mask": mask}
    sampling = SamplingConfig(max_new_tokens=6, temperature=1.0, top_k=20,
                              top_p=0.95, eos_token_id=1, pad_token_id=0)
    engine = RolloutEngine(bundle, sampling, max_len=16,
                           cache_dtype=torch.float32, device="cpu",
                           lora_scale=scale)
    want = engine.generate(params, batch, torch.Generator().manual_seed(5),
                           group_size=2, lora=lora)
    want_logits, _ = engine.prefill(params, batch, lora=lora)
    axes = bundle.logical_axes()

    def copies(group):
        base = tp_local_params(params, axes, bundle.cfg, group.rank,
                               group.size, torch.float32)
        return base, (None if lora is None else tp_local_lora(
            lora, params, base, axes, bundle.cfg, group, torch.float32,
            scale))

    def rank(group):
        base, adapters = copies(group)
        out = engine.generate(base, batch, torch.Generator().manual_seed(5),
                              group_size=2, lora=adapters, tp=group)
        logits, cache = engine.prefill(base, batch, lora=adapters)
        return out["completion_ids"], logits, cache["k"].shape[2], base

    results = run_sequential_ranks(rank, TP)
    for r, (ids, logits, kv, base) in enumerate(results):
        assert torch.equal(ids, want["completion_ids"]), r
        torch.testing.assert_close(logits, want_logits, rtol=0,
                                   atol=UNEVEN_LOGITS_ATOL)
        # each rank's KV heads: those its query heads (2, 2, 1, 1) read
        assert kv == [1, 2, 1, 1][r]
        # the vocabulary's shares of 63 rows, padded
        assert base["embed"]["weight"].shape[0] == 63
    if name == "moe":
        experts = [b["layers"]["mlp"]["experts"]["gate"]["kernel"].shape[1]
                   for *_, b in results]
        assert experts == [2, 1, 1, 1]
    elif name.startswith("int4"):
        rows = [b["layers"]["mlp"]["down"]["kernel"]["scales"].shape[-2]
                for *_, b in results]
        assert rows == [3, 2, 2, 2]
    else:
        cols = [b["layers"]["mlp"]["gate"]["kernel"].shape[-1]
                for *_, b in results]
        assert cols == [23, 23, 22, 22]

    def prefill(group):
        base, adapters = copies(group)
        return engine.prefill(base, batch, lora=adapters)[0]

    dropped = run_sequential_ranks(prefill, TP,
                                   reduce=lambda parts: sum(parts[:-1]))
    assert (dropped[0] - want_logits).abs().max() > 100 * UNEVEN_LOGITS_ATOL
    assert np.isfinite(dropped[0].numpy()).all()


def test_the_shares_are_contiguous_and_the_first_ranks_take_one_more():
    from iadr1_tpu_torch.core.tensor_parallel import split_range

    def sizes(n, size):
        return [split_range(n, size, r)[1] for r in range(size)]

    assert sizes(60, 8) == [8, 8, 8, 8, 7, 7, 7, 7]
    assert sizes(28, 8) == [4, 4, 4, 4, 3, 3, 3, 3]
    assert sizes(12, 8) == [2, 2, 2, 2, 1, 1, 1, 1]
    for n, size in ((60, 8), (5, 2), (90, 4), (7, 7)):
        firsts = [split_range(n, size, r)[0] for r in range(size)]
        assert firsts == list(np.cumsum([0] + sizes(n, size)[:-1]))
        assert sum(sizes(n, size)) == n


def test_moe_dispatch_over_expert_shares_sums_to_the_whole_block():
    """``moe_block`` on each rank's share of the experts (the tp rollout's
    slices) gives partial sums whose rank-ordered sum is the one-rank
    block within f32 rounding, for 5 experts over 2, 3 and 4 ranks."""
    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks
    from iadr1_tpu_torch.models import qwen2_moe
    from iadr1_tpu_torch.train.rollout import tp_local_params

    bundle, params, _, _ = _case("moe")
    cfg = bundle.cfg
    mp = qwen2_moe.qwen2.unstack_layers(params["layers"], 2)[0]["mlp"]
    x = torch.randn(2, 5, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(3))
    whole, _ = qwen2_moe.moe_block(cfg, x, mp)
    axes = bundle.logical_axes()
    for tp in (2, 3, 4):
        def rank(group):
            local = tp_local_params(params, axes, cfg, group.rank, group.size,
                                    torch.float32)
            lmp = qwen2_moe.qwen2.unstack_layers(local["layers"], 2)[0]["mlp"]
            part, _ = qwen2_moe.moe_block(cfg, x, lmp)
            return group.all_reduce(part)

        for got in run_sequential_ranks(rank, tp):
            torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
