"""What runs on a mesh since the port's last mesh refusals went, on 2 Gloo
processes against one process (and the JAX CLI where it runs the same):

* the MoE at tp = 2 with 5 experts (3 and 2 a rank, ``moe_block``: each
  rank's own experts' pairs, the shared expert's row-parallel partial, one
  all-reduce a layer) through the SFT CLI: the logged loss, accuracy and
  grad norm within ``LOSS_RTOL`` of one process and of the JAX CLI (the
  router aux coefficient 0, since the packages' aux losses differ, C.R20;
  JAX's capacity factor 100, where its capacity dispatch drops nothing;
  JAX on one device, since it places no 5 experts on tp = 2),
  the parameters after 2 steps within ``TP_PARAM_ATOL`` of one process;
  again with the aux coefficient 0.001 against one process;
* the MoE under SC-GRPO at tp = 2: the tp rollout (each rank's experts
  sliced, plain tensors) draws the one-process tokens;
* PiSSA's initialization at fsdp = 2 and at tp = 2 through the GRPO CLI:
  every rank's adapters and residual base bitwise one process's
  ``pissa_init`` in f32 (both under one ``PYTHONHASHSEED``: a kernel's
  seed is its path's ``hash``), and the step's adapters within
  ``TP_PARAM_ATOL`` of one process's;
* the one-call chain (``cli/pipeline.py``) at fsdp = 2: both exports and
  the summary CSV byte for byte a one-process chain's, and only rank 0
  writes them (the other rank opens no file under the chain's directory).
  Its stages train at learning rate 0, so that the exports are bitwise
  comparable; the stages' updates on a mesh are held to one process by
  the other mesh tests.

Every mesh run of the file is one spawned 2-process job (``mesh_job``,
``torch_mesh_worker.case_jobs``), started with the first test and running
beside the one-process references; each case stays its own test.  The one-process PiSSA run is a worker process with no group under
the same hash seed.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from helpers import (
    build_benchmark_json,
    build_iad_rl_dataset,
    build_iad_sft_dataset,
    build_tiny_vlm_checkpoint,
)
import torch_mesh_worker
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    LOSS_RTOL,
    _assert_logs_close,
    _final_params,
    _jax_cli,
    _log,
    _port_one_process,
    f32_port,
    run_ranks,
)
import torch_threads  # noqa: F401  (one intra-op thread)

# the parameters after tp = 2 steps against one process: the row-parallel
# products add their partial sums in another order (the bound of
# tests/test_torch_tensor_parallel_lora.py)
TP_PARAM_ATOL = 1.5e-5
HASH_SEED = {"PYTHONHASHSEED": "0"}
TP2 = {"dp": 1, "fsdp": 1, "tp": 2}
FSDP2 = {"dp": 1, "fsdp": 2, "tp": 1}
ONE = {"dp": 1, "fsdp": 1, "tp": 1}


def build_moe5_checkpoint(dirpath: str, aux_coef: float) -> str:
    """A tiny Qwen2-MoE checkpoint of 5 experts (top 2), which tp = 2 does
    not divide; JAX's capacity factor 100 in its config."""
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

    from helpers import tiny_qwen_tokenizer

    tok = tiny_qwen_tokenizer()
    tok.save_pretrained(dirpath)
    torch.manual_seed(0)
    cfg = Qwen2MoeConfig(
        vocab_size=max(tok.vocab_size, 600), hidden_size=64,
        intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=True, max_position_embeddings=512,
        num_experts=5, num_experts_per_tok=2, moe_intermediate_size=48,
        shared_expert_intermediate_size=80, norm_topk_prob=False,
        decoder_sparse_step=1, mlp_only_layers=[],
        router_aux_loss_coef=aux_coef)
    Qwen2MoeForCausalLM(cfg).save_pretrained(dirpath)
    with open(os.path.join(dirpath, "config.json")) as f:
        hf = json.load(f)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(dict(hf, capacity_factor=100.0), f)
    return dirpath


def _sft_cfg(ckpt, data, img_dir, out_dir):
    return {"model": {"model_name_or_path": ckpt},
            "data": {"dataset": data, "image_dir": img_dir,
                     "template": "qwen", "cutoff_len": 128},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1, "save_steps": 0}}


def _grpo_cfg(ckpt, data, img_dir, out_dir, **extra):
    return {"model": {"model_name_or_path": ckpt, "dtype": "float32"},
            "data": {"dataset_name": data, "image_path": img_dir,
                     "patch_budget": 256},
            "grpo": {"num_generations": 2, "max_prompt_length": 200,
                     "max_completion_length": 6, "beta": 0.04},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 1,
                      "batch_size": 2, "logging_steps": 1, "save_steps": 0},
            **extra}


PISSA = {"finetuning_type": "lora", "lora_rank": 4, "lora_alpha": 8.0,
         "pissa_init": True}


def _chain_cfg(root, inputs):
    """The chain of tests/test_torch_pipeline.py, shortened (1 SFT step,
    1 GRPO step of 4 tokens, one benchmark of 4 items), at learning rate
    0."""
    lr0 = {"learning_rate": 0.0, "warmup_ratio": 0.0}
    return {
        "model_name_or_path": inputs["vlm"], "output_dir": str(root),
        "sft": {"data": {"dataset": inputs["sft"][0],
                         "image_dir": inputs["sft"][1],
                         "template": "qwen2_vl", "cutoff_len": 128,
                         "patch_budget": 64, "min_pixels": 56 * 56,
                         "max_pixels": 56 * 56 * 4},
                "optim": lr0,
                "train": {"max_steps": 1, "batch_size": 4,
                          "logging_steps": 1, "save_steps": 0}},
        "grpo": {"model": {"ref_dtype": "float32"},
                 "data": {"dataset_name": inputs["rl"][0],
                          "image_path": inputs["rl"][1],
                          "template": "qwen2_vl", "patch_budget": 128,
                          "min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4},
                 "grpo": {"num_generations": 2, "max_prompt_length": 128,
                          "max_completion_length": 4, "beta": 0.02},
                 "optim": lr0,
                 "train": {"max_steps": 1, "batch_size": 2,
                           "logging_steps": 1, "save_steps": 0}},
        "eval": {"benchmarks": [{"test_data": inputs["bench"][0],
                                 "image_dir": inputs["bench"][1],
                                 "max_samples": 4}],
                 "num_shot": 0, "batch_size": 2, "max_prompt_length": 128,
                 "max_new_tokens": 4, "patch_budget": 64,
                 "max_pixels": 56 * 56 * 4}}


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    return {"moe": build_moe5_checkpoint(str(root / "moe"), 0.0),
            "moe_aux": build_moe5_checkpoint(str(root / "moe_aux"), 0.001),
            "vlm": build_tiny_vlm_checkpoint(str(root / "vlm")),
            "sft": build_iad_sft_dataset(root / "sft"),
            "rl": build_iad_rl_dataset(root / "rl"),
            "bench": build_benchmark_json(root / "bench", n=4),
            "root": root}


@pytest.fixture(scope="module")
def mesh_job(inputs, tmp_path_factory):
    """A function returning ({job: [rank 0's result, rank 1's]} of the one
    2-process job that runs every mesh case of the file, the one-process
    PiSSA run's result, their directory); both run in the background from
    the first test on, beside its one-process references."""
    root = tmp_path_factory.mktemp("mesh")
    sft, rl = inputs["sft"], inputs["rl"]
    pissa = {f"pissa_{name}": _write(root / f"pissa_{name}.json", dict(
        _grpo_cfg(inputs["vlm"], *rl, root / f"pissa_{name}_out",
                  finetuning=PISSA), mesh=mesh))
        for name, mesh in (("fsdp2", FSDP2), ("tp2", TP2))}
    jobs = [
        {"name": "moe_sft", "case": "cli", "args": {
            "cli": "train_sft", "f32": True, "config": _write(
                root / "moe_sft.json", dict(_sft_cfg(
                    inputs["moe"], *sft, root / "moe_sft_out"), mesh=TP2))}},
        {"name": "moe_sft_aux", "case": "cli", "args": {
            "cli": "train_sft", "f32": True, "config": _write(
                root / "moe_sft_aux.json", dict(_sft_cfg(
                    inputs["moe_aux"], *sft, root / "moe_sft_aux_out"),
                    mesh=TP2))}},
        {"name": "moe_grpo", "case": "cli", "args": {
            "cli": "train_grpo", "f32": True, "record_tokens": True,
            "length_reward": True, "f32_cache": True, "config": _write(
                root / "moe_grpo.json", dict(_grpo_cfg(
                    inputs["moe"], *rl, root / "moe_grpo_out"), mesh=TP2))}},
        *({"name": name, "case": "cli", "args": {
            "cli": "train_grpo", "f32": True, "record_pissa": True,
            "length_reward": True, "record_tokens": True, "config": path}}
          for name, path in pissa.items()),
        # no mesh section: fsdp fills the 2 ranks in both training stages
        {"name": "chain", "case": "pipeline", "args": {
            "root": str(root / "chain"), "config": _write(
                root / "chain.json", _chain_cfg(root / "chain", inputs))}},
    ]
    one = root / "pissa_one.json"
    one_cfg = _grpo_cfg(inputs["vlm"], *rl, root / "pissa_one_out",
                        finetuning=PISSA)
    _write(one, one_cfg)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        "mesh": pool.submit(run_ranks, "jobs", 2, root / "ranks",
                            {"jobs": jobs}, timeout=900, env=HASH_SEED),
        "one": pool.submit(run_ranks, "cli", 1, root / "one", {
            "cli": "train_grpo", "f32": True, "record_pissa": True,
            "length_reward": True, "record_tokens": True,
            "config": str(one), "no_group": True}, env=HASH_SEED)}

    def get():
        ranks = futures["mesh"].result()
        return ({name: [r[name] for r in ranks] for name in ranks[0]},
                futures["one"].result()[0], root)

    yield get
    pool.shutdown(wait=True)


def test_the_moe_sft_at_tp2_matches_one_process_and_jax(
        inputs, mesh_job, f32_port, monkeypatch, tmp_path):
    """5 experts over 2 ranks (3 and 2): the loss, accuracy and grad norm
    of 2 steps against both references, the parameters against one
    process."""
    sft = inputs["sft"]
    one = _port_one_process("train_sft", _sft_cfg(
        inputs["moe"], *sft, tmp_path / "one"), tmp_path / "one.json")
    # JAX places no 5 experts on tp = 2 (device_put wants the dims
    # divisible): its CLI runs on one device, the same arithmetic
    jax_log = _jax_cli(monkeypatch, "train_sft", ONE, _sft_cfg(
        inputs["moe"], *sft, tmp_path / "jax"), tmp_path / "jax.json")
    results, _, root = mesh_job()
    got = _log(root / "moe_sft_out")
    keys = ("loss", "accuracy", "grad_norm")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    _assert_logs_close(got, jax_log, keys, LOSS_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]
    _assert_close(_final_params(root / "moe_sft_out"),
                  _final_params(tmp_path / "one"))
    for r in results["moe_sft"]:
        assert r["mesh"] == TP2
        # the attention's 4 heads over 2 KV heads: 2 over 1 a rank
        assert all(q[1] == 2 and k[1] == 1 for q, k, _ in r["flash_shapes"])


def test_the_moe_router_loss_at_tp2_matches_one_process(
        inputs, mesh_job, f32_port, tmp_path):
    """The router statistics (replicated over tp) and their aux loss."""
    one = _port_one_process("train_sft", _sft_cfg(
        inputs["moe_aux"], *inputs["sft"], tmp_path / "one"),
        tmp_path / "one.json")
    _, _, root = mesh_job()
    got = _log(root / "moe_sft_aux_out")
    _assert_logs_close(got, one, ("loss", "aux_loss", "grad_norm"),
                       LOSS_RTOL)
    assert all(r["aux_loss"] > 0 for r in got)
    _assert_close(_final_params(root / "moe_sft_aux_out"),
                  _final_params(tmp_path / "one"))


def test_the_moe_sc_grpo_at_tp2_draws_the_one_process_tokens(
        inputs, mesh_job, f32_port, monkeypatch, tmp_path):
    tokens = torch_mesh_worker.record_tokens(monkeypatch.setattr)
    torch_mesh_worker.length_reward(monkeypatch.setattr)
    torch_mesh_worker.f32_cache(monkeypatch.setattr)
    one = _port_one_process("train_grpo", _grpo_cfg(
        inputs["moe"], *inputs["rl"], tmp_path / "one"),
        tmp_path / "one.json")
    results, _, root = mesh_job()
    got = _log(root / "moe_grpo_out")
    for r in results["moe_grpo"]:
        # both tp ranks decode the whole batch, each its own experts
        assert r["tokens"] == [t.tolist() for t in tokens]
        # 2 of the 4 query heads, 1 of the 2 KV heads a decode call
        assert [[q[1], k[1]] for q, k, _ in r["decode_shapes"]] == [[2, 1]]
    _assert_logs_close(got, one, ("loss", "kl", "grad_norm", "reward"),
                       LOSS_RTOL)
    _assert_close(_final_params(root / "moe_grpo_out"),
                  _final_params(tmp_path / "one"))


@pytest.mark.parametrize("mesh", ["fsdp2", "tp2"])
def test_pissa_on_a_mesh_is_one_process_s_pissa_init(mesh, mesh_job):
    results, one, root = mesh_job()
    want = torch.load(root / "one" / "pissa0.pt")
    name = f"pissa_{mesh}"
    assert want["lora"] and want["residual"]
    for rank in range(2):
        got = torch.load(root / "ranks" / name / f"pissa{rank}.pt")
        for side in ("lora", "residual"):
            assert got[side].keys() == want[side].keys()
            for key, t in want[side].items():
                assert t.dtype == torch.float32
                assert torch.equal(got[side][key], t), (rank, side, key)
    # the step: the one-process tokens, its adapters within the bound
    ranks = results[name]
    if mesh == "tp2":
        assert ranks[0]["tokens"] == ranks[1]["tokens"] == one["tokens"]
    else:
        assert [row for r in ranks for row in r["tokens"][0]] == \
            one["tokens"][0]
    got = _final_params(root / f"pissa_{mesh}_out")
    assert all(k.endswith((".a", ".b")) for k in got)
    _assert_close(got, _final_params(root / "pissa_one_out"))


def test_the_chain_on_two_processes_writes_the_one_process_files(
        inputs, mesh_job, tmp_path):
    from iadr1_tpu_torch.cli import pipeline

    cfg = _chain_cfg(tmp_path / "one", inputs)
    path = tmp_path / "chain.json"
    path.write_text(json.dumps(cfg))
    assert pipeline.main(["--config", str(path), "--device", "cpu"]) == 0
    results, _, root = mesh_job()
    ranks = results["chain"]
    bench = pipeline._bench_name(pipeline.BenchmarkSpec(
        inputs["bench"][0]))
    for name in ("sft_export/model.safetensors",
                 "grpo_export/model.safetensors",
                 "results/summary_0_shot.csv",
                 f"results/{bench}/answers_0_shot.json"):
        got = (root / "chain" / name).read_bytes()
        assert got == (tmp_path / "one" / name).read_bytes(), name
    assert ranks[0]["rc"] == ranks[1]["rc"] == 0
    assert ranks[0]["exports"] == 2 and ranks[0]["evals"] == 1
    assert "pipeline_manifest.json" in ranks[0]["files"]
    assert "results/summary_0_shot.csv" in ranks[0]["files"]
    # rank 1 trained on the mesh and wrote nothing of the chain's
    assert ranks[1]["exports"] == ranks[1]["evals"] == 0
    assert ranks[1]["files"] == []
    with open(root / "chain" / "pipeline_manifest.json") as f:
        manifest = json.load(f)
    assert manifest["sft_export"] == str(root / "chain" / "sft_export")


def _assert_close(got, want):
    assert got.keys() == want.keys() and got
    worst = max(float((got[k] - want[k]).abs().max()) for k in got)
    assert worst <= TP_PARAM_ATOL, worst
    assert np.isfinite(worst)
