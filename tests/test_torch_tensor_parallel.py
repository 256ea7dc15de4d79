"""Tensor parallelism for the repo's two tp = 4 recipes, on real Gloo
processes on the CPU (tests/torch_mesh_worker.py, one process a rank;
tests/torch_mesh_runs.py starts them):

* the SFT CLI of each recipe family -- Qwen2.5-VL
  (configs/sft_qwen2_5_vl_72b.yaml) and LLaVA-NeXT
  (configs/grpo_llava_next_34b.yaml) -- on its tiny checkpoint at (dp,
  fsdp, tp) = (1, 1, 2) and (1, 2, 2): the logged loss, accuracy, label
  count and gradient norm within ``LOSS_RTOL`` (1e-5, the mesh tests'
  own) of the one-process port run and of the JAX CLI on the same
  virtual mesh, and
  every attention call of the decoder and the tower given H / tp heads
  (or every head, where the KV heads do not divide);
* the tp-local rollout step (``train/rollout.py tp_local_params``) run as
  sequential ranks in one process with a summing reduce: the unsharded
  step's tokens, its logits within ``TP_LOGITS_ATOL``; the sequential
  ranks under contention and when one fails.

The sharded load is held in tests/test_torch_tensor_parallel_lora.py.
The four mesh runs are spawned one after another from the module's start
(``torch_mesh_runs.MeshJobs``), beside the one-process and JAX
references; each case stays its own test.

The JAX CLI reads two inputs as the port does: the Qwen2.5-VL tower's
attention masked by its segments (ROADMAP C.R8) and the LLaVA image runs
expanded through the port's ``expand_image_tokens`` (C.R6); each is a
hazard of the reference, not of the mesh.
"""

import functools

import numpy as np
import pytest
import torch

from helpers import build_iad_sft_dataset
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry
from torch_mesh_runs import (
    LOSS_RTOL,
    MeshJobs,
    _assert_logs_close,
    _jax_cli,
    _log,
    _port_one_process,
    cli_job,
)
import torch_threads  # noqa: F401  (one intra-op thread)

# the tp-local rollout's first-step logits against the unsharded step's,
# f32 (largest reading 6.0e-7: the row-parallel partial sums added in
# another order)
TP_LOGITS_ATOL = 2e-6
SFT_KEYS = ("loss", "accuracy", "n_label_tokens", "grad_norm")
MESHES = {"tp2": {"dp": 1, "fsdp": 1, "tp": 2},
          "fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}}


def _qwen25(path):
    from test_torch_qwen25_vl import build_tiny_qwen25_vl_checkpoint

    return build_tiny_qwen25_vl_checkpoint(path)


def _llava_next(path):
    from test_torch_llava import build_tiny_llava_checkpoint

    return build_tiny_llava_checkpoint(path, "llava_next")


# family -> (checkpoint builder, template, cutoff_len, patch budget)
FAMILIES = {"qwen2_5_vl": (_qwen25, "qwen2_vl", 128, 64),
            "llava_next": (_llava_next, "llava_next", 512, 1024)}
# family -> ((decoder heads, KV heads), tower heads) of its tiny checkpoint
FAMILY_HEADS = {"qwen2_5_vl": ((4, 2), 4), "llava_next": ((8, 2), 2)}


def _family_cfg(family, ckpt, data, out_dir):
    _, template, cutoff, budget = FAMILIES[family]
    return {"model": {"model_name_or_path": ckpt},
            "data": {"dataset": data[0], "image_dir": data[1],
                     "template": template, "cutoff_len": cutoff,
                     "patch_budget": budget, "min_pixels": 56 * 56,
                     "max_pixels": 56 * 56 * 4},
            "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1,
                      "save_steps": 0}}


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """Per family: its config maker, the one-process port run's log (made
    once, shared by both meshes), its checkpoint, and the mesh runs of
    every family and mesh (``MeshJobs``, started with the module)."""
    root = tmp_path_factory.mktemp("families")
    inputs = {family: (FAMILIES[family][0](str(root / family / "ckpt")),
                       build_iad_sft_dataset(root / family))
              for family in FAMILIES}
    # one job a (family, mesh), in the order the tests read them
    jobs = MeshJobs(root, [
        (int(np.prod(list(MESHES[mesh_id].values()))), [cli_job(
            f"{family}_{mesh_id}", "train_sft", MESHES[mesh_id],
            _family_cfg(family, *inputs[family],
                        root / f"{family}_{mesh_id}_out"), root)])
        for family in FAMILIES for mesh_id in MESHES])
    runs = {}

    def get(family):
        if family not in runs:
            ckpt, data = inputs[family]
            cfg = functools.partial(_family_cfg, family, ckpt, data)
            with pytest.MonkeyPatch.context() as mp:
                for name in ("bundle_from_hf_config",
                             "bundle_from_pretrained"):
                    mp.setattr(registry, name, functools.partial(
                        getattr(registry, name), precision=FULL_PRECISION))
                one = _port_one_process(
                    "train_sft", cfg(root / family / "one"),
                    root / family / "one.json")
            runs[family] = (cfg, one, ckpt)
        return runs[family]

    get.jobs, get.root = jobs, root
    yield get
    jobs.close()


def _jax_reads_as_the_port(monkeypatch, family):
    """The JAX CLI given the port's reading of C.R8 (Qwen2.5-VL) and C.R6
    (LLaVA)."""
    if family == "qwen2_5_vl":
        from iadr1_tpu.models import registry as jax_registry
        from test_torch_qwen25_vl import jax_segment_xla

        monkeypatch.setattr(jax_registry, "default_attention",
                            lambda kind: jax_segment_xla)
    else:
        import iadr1_tpu.data.mm as jax_mm

        from iadr1_tpu_torch.data.mm import expand_image_tokens

        monkeypatch.setattr(jax_mm, "expand_image_tokens",
                            expand_image_tokens)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_recipe_family_sft_on_tp_matches_one_process_and_jax(
        family, mesh_id, family_runs, monkeypatch, tmp_path):
    mesh = MESHES[mesh_id]
    cfg, one, ckpt = family_runs(family)
    _jax_reads_as_the_port(monkeypatch, family)
    jax_log = _jax_cli(monkeypatch, "train_sft", mesh, cfg(tmp_path / "jax"),
                       tmp_path / "jax.json")
    ranks = family_runs.jobs.result(f"{family}_{mesh_id}")
    got = _log(family_runs.root / f"{family}_{mesh_id}_out")
    _assert_logs_close(got, one, SFT_KEYS, LOSS_RTOL)
    _assert_logs_close(got, jax_log, SFT_KEYS, LOSS_RTOL)
    assert got[-1]["loss"] != got[0]["loss"]
    # every attention call, the decoder's and the tower's, on H / tp
    # heads: the decoder's on this rank's rows with Hkv / tp KV heads
    (H, Hkv), tower_heads = FAMILY_HEADS[family]
    rows = 4 // mesh["fsdp"]
    for r in ranks:
        assert r["mesh"] == mesh
        shapes = [tuple(map(tuple, s)) for s in r["flash_shapes"]]
        assert ((rows, H // 2), Hkv // 2) in {(q[:2], k[1])
                                             for q, k, _ in shapes}, shapes
        assert {q[1] for q, _, _ in shapes} == {H // 2, tower_heads // 2}


# ---------------------------------------------------------------------------
# the tp-local rollout step
# ---------------------------------------------------------------------------


# (H, Hkv, tp, the KV heads a rank's cache holds)
@pytest.mark.parametrize("heads", [(8, 2, 2, 1), (8, 2, 4, 1), (6, 3, 2, 3)],
                         ids=["H8_Hkv2_tp2", "kv_replicated_tp4",
                              "kv_per_query_tp2"])
def test_the_tp_local_rollout_as_sequential_ranks_equals_the_unsharded(
        heads):
    """A text decoder's rollout (prefill, then sampled decode steps, G = 2)
    on each rank's ``tp_local_params`` copy, the ranks run one after
    another in one process (``run_sequential_ranks``) with the
    rank-ordered sum as the all-reduce: every rank draws the unsharded
    run's tokens and its prefill logits are within ``TP_LOGITS_ATOL``;
    each rank's cache holds its own KV heads (Hkv / tp, or the KV heads
    its query heads read where Hkv does not divide).  Dropping one rank's
    partial sum changes the logits."""
    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks
    from iadr1_tpu_torch.train.rollout import (
        RolloutEngine,
        SamplingConfig,
        tp_local_params,
    )

    H, Hkv, tp, kv_local = heads
    hf = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
              vocab_size=128, hidden_size=48, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=H,
              num_key_value_heads=Hkv, head_dim=8,
              tie_word_embeddings=False)
    bundle = registry.bundle_from_hf_config(hf, precision=FULL_PRECISION)
    params = bundle.init_params(seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    B, P = 3, 7
    mask = torch.ones(B, P, dtype=torch.int64)
    mask[0, :2] = 0
    batch = {"input_ids": torch.randint(3, 128, (B, P), generator=gen),
             "attention_mask": mask}
    sampling = SamplingConfig(max_new_tokens=6, temperature=1.0, top_k=20,
                              top_p=0.95, eos_token_id=1, pad_token_id=0)
    engine = RolloutEngine(bundle, sampling, max_len=16,
                           cache_dtype=torch.float32, device="cpu")
    want = engine.generate(params, batch, torch.Generator().manual_seed(5),
                           group_size=2)
    want_logits, _ = engine.prefill(params, batch)

    def rank(group):
        local = tp_local_params(params, bundle.logical_axes(), bundle.cfg,
                                group.rank, group.size, torch.float32)
        out = engine.generate(local, batch,
                              torch.Generator().manual_seed(5), group_size=2,
                              tp=group)
        logits, cache = engine.prefill(local, batch)
        return out["completion_ids"], logits, cache["k"].shape[2]

    results = run_sequential_ranks(rank, tp)
    for ids, logits, kv in results:
        assert torch.equal(ids, want["completion_ids"])
        torch.testing.assert_close(logits, want_logits, rtol=0,
                                   atol=TP_LOGITS_ATOL)
        assert kv == kv_local
    dropped = run_sequential_ranks(
        lambda g: engine.prefill(tp_local_params(
            params, bundle.logical_axes(), bundle.cfg, g.rank, g.size,
            torch.float32), batch)[0], tp,
        reduce=lambda parts: sum(parts[:-1]))
    assert (dropped[0] - want_logits).abs().max() > 100 * TP_LOGITS_ATOL
    assert np.isfinite(dropped[0].numpy()).all()


def test_sequential_ranks_hold_their_turns_under_contention():
    """More ranks than cores, the interpreter switching threads every
    microsecond: each of 40 collectives a rank (all-reduces and
    all-gathers in turn) returns the rank-ordered result of that very
    collective, and every rank finishes."""
    import sys

    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks

    ranks, rounds = 16, 40

    def rank(group):
        seen = []
        for i in range(rounds):
            x = torch.tensor([float(100 * i + group.rank)])
            if i % 2:
                seen.append(group.all_gather(x, dim=0).tolist())
            else:
                seen.append(group.all_reduce(x).item())
        return seen

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = run_sequential_ranks(rank, ranks, timeout=60)
    finally:
        sys.setswitchinterval(interval)
    want = [[float(100 * i + r) for r in range(ranks)] if i % 2
            else float(sum(100 * i + r for r in range(ranks)))
            for i in range(rounds)]
    assert results == [want] * ranks


def test_a_failing_sequential_rank_stops_every_rank():
    """A rank that raises before a collective stops the others, which
    would wait for its part, and the error reaches the caller; a rank
    that skips a collective is found out, whichever rank it is."""
    from iadr1_tpu_torch.core.tensor_parallel import run_sequential_ranks

    def rank(group):
        if group.rank == 2:
            raise ValueError("rank 2 fails")
        return group.all_reduce(torch.ones(1))

    with pytest.raises(ValueError, match="rank 2 fails"):
        run_sequential_ranks(rank, 4, timeout=60)

    for skipper in (0, 1):
        def skipping(group, skipper=skipper):
            if group.rank != skipper:
                return group.all_reduce(torch.ones(1))
            return None

        with pytest.raises(RuntimeError, match="collectives differ"):
            run_sequential_ranks(skipping, 2, timeout=60)
