"""The port on a mesh: real multi-process Gloo runs on the CPU.

Each case starts one process a rank (tests/torch_mesh_worker.py, one
intra-op thread, joined through a ``file://`` under the test's tmp dir so
that pytest-xdist workers never race for a port, each run under its own
timeout) and holds what they compute to a one-process port run and,
where the JAX package has the step at that mesh, to the JAX CLI run on
``build_mesh(MeshConfig(...), devices=jax.devices()[:n])``:

* the K1-K3 twins (with an lse cotangent) and the K4 twin behind the
  sharding rule at fsdp = 2 and at tp = 2, bitwise equal to the unsharded
  calls (which tests/test_torch_flash_backward.py and
  tests/test_torch_decode_attention.py hold to Pallas);
* the SFT CLI on the tiny Qwen2-VL checkpoint with images at fsdp = 2 and
  at (dp, fsdp, tp) = (1, 2, 2) on 4 processes, and the tiny MoE (router
  aux loss on) at fsdp = 2: the logged loss within rel 1e-5 of both
  references, the parameters after 2 steps within atol 1e-5 of the
  one-process run, under tp the kernels given H / tp heads, and the
  decoder's layers gathered one at a time;
* the GRPO CLI at fsdp = 2: the completions equal the one-process run's
  token for token, and the logs and parameters match it (JAX's rollouts
  draw other random numbers, so its tokens differ by design);
* DPO through cli/train_pref.py at fsdp = 2 and at tp = 2;
* do_predict after the SFT CLI at fsdp = 2: the one-process files;
* one update of every optimizer at fsdp = 2, (2, 2, 1) and (1, 2, 2);
* a global batch's placements and each rank's rows at (1, 2, 2);
* a checkpoint saved on 2 ranks, byte for byte the one-process file, and
  restored onto the mesh and onto one process; the HF export likewise;
* the refusals that name ROADMAP A.11b (the MoE's expert axis on tp).

Each stated tolerance is about 3x the largest sound reading, which the
constants below name.
"""

import functools
import json

import numpy as np
import pytest
import torch

from helpers import (
    build_iad_rl_dataset,
    build_iad_sft_dataset,
    build_tiny_moe_checkpoint,
    build_tiny_vlm_checkpoint,
)
from iadr1_tpu_torch.models import registry
import torch_mesh_worker
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    LOSS_RTOL,
    _assert_logs_close,
    _assert_params_close,
    _final_params,
    _jax_cli,
    _port_on_mesh,
    _port_one_process,
    f32_port,
    run_ranks,
)
import torch_threads  # noqa: F401  (one intra-op thread)

# ---------------------------------------------------------------------------
# the kernels' sharding rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 1, 2)],
                         ids=["fsdp2", "tp2"])
def test_the_kernel_twins_behind_the_rule_equal_the_unsharded_calls(
        mesh, tmp_path):
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(3)
    B, H, Hkv, T, D, S = 4, 4, 2, 40, 64, 48

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    seg = torch.ones(B, T, dtype=torch.int32)
    seg[1, 25:] = 2
    seg[3, 30:] = 0
    cseg = (torch.arange(S)[None] < torch.tensor([[40], [33], [20], [45]])
            ).to(torch.int32)
    inputs = {"q": rnd(B, H, T, D), "k": rnd(B, Hkv, T, D),
              "v": rnd(B, Hkv, T, D), "seg": seg, "do": rnd(B, H, T, D),
              "dlse": rnd(B, H, T), "dq": rnd(B, H, D),
              "ck": rnd(B, Hkv, S, D), "cv": rnd(B, Hkv, S, D),
              "cseg": cseg, "length": 45}
    torch.save(inputs, tmp_path / "inputs.pt")
    results = run_ranks("kernels", int(np.prod(mesh)), tmp_path / "ranks",
                        {"mesh": list(mesh),
                         "inputs": str(tmp_path / "inputs.pt")})

    q, k, v = (inputs[n].clone().requires_grad_() for n in ("q", "k", "v"))
    out, lse = flash_attention(q, k, v, segment_ids=seg, kv_segment_ids=seg,
                               causal=True)
    torch.autograd.backward([out, lse], [inputs["do"], inputs["dlse"]])
    want = {"out": out, "lse": lse, "dq": q.grad, "dk": k.grad,
            "dv": v.grad,
            "decode": decode_attention(inputs["dq"], inputs["ck"],
                                       inputs["cv"], cseg, 45)}
    for rank in range(len(results)):
        got = torch.load(tmp_path / "ranks" / f"kernels{rank}.pt")
        for name, ref in want.items():
            assert torch.equal(got[name], ref.detach()), (rank, name)
    b, h, hkv = B // mesh[1], H // mesh[2], Hkv // mesh[2]
    for r in results:
        # each rank's kernel call: its batch rows and its heads, no more
        assert r["flash_calls"] == 1 and r["decode_calls"] == 1
        assert r["flash_shapes"] == [[[b, h, T, D], [b, hkv, T, D],
                                      [b, hkv, T, D]]]
        assert r["decode_shapes"] == [[[b, h, D], [b, hkv, S, D],
                                       [b, hkv, S, D]]]


# ---------------------------------------------------------------------------
# the training CLIs on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("vlm")))


def _sft_cfg(ckpt, data, img_dir, out_dir):
    return {"model": {"model_name_or_path": ckpt},
            "data": {"dataset": data, "image_dir": img_dir,
                     "template": "qwen2_vl", "cutoff_len": 128,
                     "patch_budget": 64, "min_pixels": 56 * 56,
                     "max_pixels": 56 * 56 * 4},
            "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1, "save_steps": 0}}


@pytest.mark.parametrize("mesh", [{"dp": 1, "fsdp": 2, "tp": 1},
                                  {"dp": 1, "fsdp": 2, "tp": 2}],
                         ids=["fsdp2", "fsdp2_tp2"])
def test_sft_cli_on_a_mesh_matches_one_process_and_jax(
        mesh, vlm_checkpoint, f32_port, monkeypatch, tmp_path):
    data, img_dir = build_iad_sft_dataset(tmp_path)
    cfg = functools.partial(_sft_cfg, vlm_checkpoint, data, img_dir)
    ranks, got = _port_on_mesh("train_sft", mesh, cfg(tmp_path / "mesh"),
                               tmp_path, "mesh")
    one = _port_one_process("train_sft", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    jax_log = _jax_cli(monkeypatch, "train_sft", mesh,
                       cfg(tmp_path / "jax"), tmp_path / "jax.json")
    keys = ("loss", "accuracy", "n_label_tokens", "grad_norm")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    _assert_logs_close(got, jax_log, keys, LOSS_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))
    for r in ranks:
        assert r["mesh"] == mesh
        # the decoder gathered its 2 layers one at a time, inside the
        # checkpoints, in the forward and again in the replay: the q/k/v
        # piece's norm and projections, the output piece's layer; 2 steps
        assert r["layer_gathers"] == (2 + 1) * 2 * 2 * 2
        if mesh["tp"] == 1:
            assert r["flash_calls"] == 0     # tp = 1: plain local tensors
            continue
        # the decoder's 4 heads over 2 KV heads on each rank's 2 of the 4
        # rows, and the tower's 4 heads over its packed patch stream
        shapes = {tuple(map(tuple, s)) for s in r["flash_shapes"]}
        assert ((2, 2, 128, 16), (2, 1, 128, 16), (2, 1, 128, 16)) in shapes
        assert all(q[1] == 2 for q, _, _ in shapes)


def test_do_predict_on_a_mesh_writes_the_one_process_files(
        vlm_checkpoint, f32_port, tmp_path):
    """``predict.do_predict`` at fsdp = 2 (learning rate 0): every rank
    gathers the parameters, rank 0 generates off the mesh; its
    generated_predictions.jsonl and predict_results.json are the
    one-process run's byte for byte."""
    data, img_dir = build_iad_sft_dataset(tmp_path)

    def cfg(out_dir):
        c = _sft_cfg(vlm_checkpoint, data, img_dir, out_dir)
        c["optim"]["learning_rate"] = 0.0
        c["train"]["max_steps"] = 1
        c["predict"] = {"do_predict": True, "max_samples": 3,
                        "max_new_tokens": 6, "batch_size": 2}
        return c

    _port_on_mesh("train_sft", {"dp": 1, "fsdp": 2, "tp": 1},
                  cfg(tmp_path / "mesh"), tmp_path, "mesh")
    _port_one_process("train_sft", cfg(tmp_path / "one"),
                      tmp_path / "one.json")
    for name in ("generated_predictions.jsonl", "predict_results.json"):
        got, want = (open(tmp_path / side / name, "rb").read()
                     for side in ("mesh", "one"))
        assert got == want, name
    assert len(want) and len(open(tmp_path / "one" / (
        "generated_predictions.jsonl")).readlines()) == 3


def test_moe_sft_with_its_router_loss_at_fsdp2_matches_one_process(
        f32_port, tmp_path):
    """The router's load-balancing loss is a global statistic: the ranks
    pool their routings before the loss (``core.mesh.batch_share``)."""
    ckpt = build_tiny_moe_checkpoint(str(tmp_path / "moe"))
    data, img_dir = build_iad_sft_dataset(tmp_path)

    def cfg(out_dir):
        c = _sft_cfg(ckpt, data, img_dir, out_dir)
        c["data"]["template"] = "qwen"
        return c

    mesh = {"dp": 1, "fsdp": 2, "tp": 1}
    _, got = _port_on_mesh("train_sft", mesh, cfg(tmp_path / "mesh"),
                           tmp_path, "mesh")
    one = _port_one_process("train_sft", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    _assert_logs_close(got, one, ("loss", "aux_loss", "grad_norm"),
                       LOSS_RTOL)
    assert all(r["aux_loss"] > 0 for r in got)
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))


def test_grpo_cli_at_fsdp2_draws_the_one_process_tokens(
        vlm_checkpoint, f32_port, monkeypatch, tmp_path):
    data, img_dir = build_iad_rl_dataset(tmp_path)

    def cfg(out_dir):
        return {"model": {"model_name_or_path": vlm_checkpoint,
                          "dtype": "float32"},
                "data": {"dataset_name": data, "image_path": img_dir,
                         "patch_budget": 256},
                "grpo": {"num_generations": 2, "max_prompt_length": 200,
                         "max_completion_length": 6, "beta": 0.04},
                "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                          "total_steps": 4},
                "train": {"output_dir": str(out_dir), "max_steps": 2,
                          "batch_size": 2, "logging_steps": 1,
                          "save_steps": 0}}

    mesh = {"dp": 1, "fsdp": 2, "tp": 1}
    ranks, got = _port_on_mesh("train_grpo", mesh, cfg(tmp_path / "mesh"),
                               tmp_path, "mesh", record_tokens=True,
                               length_reward=True)
    tokens = torch_mesh_worker.record_tokens(monkeypatch.setattr)
    torch_mesh_worker.length_reward(monkeypatch.setattr)
    one = _port_one_process("train_grpo", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    # rank r decoded rows r of every step's global batch, in order
    per_rank = [r["tokens"] for r in ranks]
    for step, want in enumerate(tokens):
        assert [row for r in per_rank for row in r[step]] == want.tolist()
    keys = ("loss", "kl", "grad_norm", "reward", "reward_std",
            "completion_length")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    assert any(r["reward_std"] > 0 for r in got)    # nonzero advantages
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))


@pytest.mark.parametrize("mesh", [{"dp": 1, "fsdp": 2, "tp": 1},
                                  {"dp": 1, "fsdp": 1, "tp": 2}],
                         ids=["fsdp2", "tp2"])
def test_dpo_through_the_launcher_on_a_mesh(mesh, vlm_checkpoint, f32_port,
                                            monkeypatch, tmp_path):
    rows = [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "chosen": "<think>clear surface</think><answer>No</answer>",
             "rejected": {"role": "assistant",
                          "content": "maybe?" * (i + 1)}}
            for i in range(6)]
    (tmp_path / "pairs.json").write_text(json.dumps(rows))

    def cfg(out_dir):
        return {"stage": "dpo",
                "model": {"model_name_or_path": vlm_checkpoint},
                "data": {"dataset_name": str(tmp_path / "pairs.json"),
                         "template": "qwen2_vl", "cutoff_len": 96},
                "pref": {"beta": 0.1, "ref_dtype": "float32"},
                "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0},
                "train": {"output_dir": str(out_dir), "max_steps": 2,
                          "batch_size": 2, "logging_steps": 1,
                          "save_steps": 0}}

    _, got = _port_on_mesh("train_pref", mesh, cfg(tmp_path / "mesh"),
                           tmp_path, "mesh")
    one = _port_one_process("train_pref", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    jax_log = _jax_cli(monkeypatch, "train_pref", mesh,
                       cfg(tmp_path / "jax"), tmp_path / "jax.json")
    keys = ("loss", "rewards/chosen", "rewards/rejected", "rewards/margins",
            "grad_norm")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    # the JAX step logs no grad norm
    _assert_logs_close(got, jax_log, keys[:-1], LOSS_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))


# ---------------------------------------------------------------------------
# optimizers, checkpoints, refusals
# ---------------------------------------------------------------------------

OPTIMIZERS = ("adamw", "sgd", "lion", "adafactor", "galore", "apollo",
              "badam", "adam_mini", "muon")


def _opt_tree():
    """A small decoder-shaped tree (paths the path-reading optimizers know)
    with its logical axes, and gradients for it."""
    gen = torch.Generator().manual_seed(5)
    params = {"embed": {"weight": torch.randn(16, 8, generator=gen)},
              "layers": {"attn": {"q": {"kernel": torch.randn(
                  2, 8, 12, generator=gen)}},
                  "mlp": {"up": {"kernel": torch.randn(2, 8, 24,
                                                       generator=gen)}},
                  "input_norm": torch.ones(2, 8)},
              "final_norm": torch.ones(8)}
    axes = {"embed": {"weight": ("vocab", "embed")},
            "layers": {"attn": {"q": {"kernel": (None, "embed", "heads")}},
                       "mlp": {"up": {"kernel": (None, "embed", "mlp")}},
                       "input_norm": (None, "norm")},
            "final_norm": ("norm",)}
    from iadr1_tpu_torch.train.state import tree_leaves

    grads = [torch.randn(p.shape, generator=gen) * 0.1
             for p in tree_leaves(params)]
    return params, axes, grads


def _optim_cfg(name):
    return {"optimizer": name, "learning_rate": 1e-2, "total_steps": 4,
            "warmup_ratio": 0.0, "galore_rank": 2, "apollo_rank": 2,
            "badam_num_layers": 2}


OPTIMIZER_MESHES = {"fsdp2": (1, 2, 1), "dp2_fsdp2": (2, 2, 1),
                    "fsdp2_tp2": (1, 2, 2)}


@pytest.fixture(scope="module")
def optimizer_runs(tmp_path_factory):
    """Every optimizer's one update on each mesh, one run a mesh."""
    runs = {}

    def run(mesh_id):
        if mesh_id not in runs:
            tmp = tmp_path_factory.mktemp(f"optim_{mesh_id}")
            params, axes, grads = _opt_tree()
            torch.save({"params": params, "axes": axes, "grads": grads},
                       tmp / "inputs.pt")
            mesh = OPTIMIZER_MESHES[mesh_id]
            run_ranks("optimizer", int(np.prod(mesh)), tmp / "ranks",
                      {"mesh": list(mesh), "inputs": str(tmp / "inputs.pt"),
                       "optims": {n: _optim_cfg(n) for n in OPTIMIZERS}})
            runs[mesh_id] = torch.load(tmp / "ranks" / "params.pt")
        return runs[mesh_id]

    return run


@pytest.mark.parametrize("mesh_id", list(OPTIMIZER_MESHES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_optimizer_updates_a_sharded_leaf_as_one_process(
        name, mesh_id, optimizer_runs):
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    params, _, grads = _opt_tree()
    opt, _ = make_optimizer(OptimizerConfig(**_optim_cfg(name)))
    state = create_train_state(params, opt)
    state.apply_gradients(grads, opt)
    got = optimizer_runs(mesh_id)[name]
    want = [p.detach() for p in tree_leaves(state.params)]
    for g, w in zip(got, want, strict=True):
        # AdamW's shards are updated in place, the others on whole leaves:
        # the same arithmetic, the global norm summed in another order
        # (bitwise equal in every run so far)
        torch.testing.assert_close(g, w, rtol=0, atol=3e-7)


def test_a_checkpoint_saved_on_two_ranks_is_the_one_process_file(tmp_path):
    """... restored onto the mesh and onto one process; the HF export of
    sharded parameters is the one-process export too."""
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state, tree_leaves

    params, axes, _ = _opt_tree()
    gen = torch.Generator().manual_seed(9)
    mu = [torch.randn(p.shape, generator=gen) for p in tree_leaves(params)]
    torch.save({"params": params, "axes": axes, "mu": mu},
               tmp_path / "inputs.pt")
    hf = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
              vocab_size=128, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, tie_word_embeddings=False)
    ranks = run_ranks("checkpoint", 2, tmp_path / "ranks",
                      {"mesh": [1, 2, 1], "inputs": str(tmp_path / "inputs.pt"),
                       "dir": str(tmp_path / "mesh"), "hf": hf,
                       "export": str(tmp_path / "export_mesh")})
    assert all(r["restored"] and r["step"] == 3 and r["count"] == 3
               for r in ranks)

    opt, _ = make_optimizer(OptimizerConfig(total_steps=4))
    state = create_train_state(params, opt)
    with torch.no_grad():
        for t, m in zip(state.opt_state["mu"], mu):
            t.copy_(m)
    state.opt_state["count"] = 3
    CheckpointManager(str(tmp_path / "one")).save(3, state._replace(step=3))
    mesh_file = (tmp_path / "mesh" / "3.safetensors").read_bytes()
    assert mesh_file == (tmp_path / "one" / "3.safetensors").read_bytes()

    fresh = create_train_state(
        torch_mesh_worker.zeros_like_tree(_opt_tree()[0]), opt)
    fresh = CheckpointManager(str(tmp_path / "mesh")).restore(fresh)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert fresh.step == 3 and fresh.opt_state["count"] == 3

    # the export: rank 0 wrote the file one process writes
    from iadr1_tpu_torch.models.params_export import save_pretrained

    bundle = registry.bundle_from_hf_config(hf)
    save_pretrained(bundle, bundle.init_params(
        seed=0, dtype=torch.float32, device="cpu"), str(tmp_path / "export"))
    assert ((tmp_path / "export_mesh" / "model.safetensors").read_bytes()
            == (tmp_path / "export" / "model.safetensors").read_bytes())


def test_a_global_batch_places_each_rank_s_rows(tmp_path):
    """(dp, fsdp, tp) = (1, 2, 2): the batch splits over fsdp alone, the
    tp ranks of a slice hold the same rows, the vision plans replicate."""
    ranks = run_ranks("batch", 4, tmp_path / "ranks", {"mesh": [1, 2, 2]})
    for rank, r in enumerate(ranks):
        slice_ = rank // 2                    # the fsdp coordinate
        assert r["local"] == {"input_ids": [2, 6], "position_ids": [3, 2, 6],
                              "patches": [5, 3]}
        assert r["first_id"] == 12 * slice_
        assert r["rows"] == [2 * slice_, 2 * slice_ + 2]
        assert r["global"] == [4, 6] and r["global_equal"]
        assert r["unarmed"] and r["armed"]
        assert r["placements"] == {"w": ["R", "S(0)", "S(1)"],
                                   "n": ["R", "R", "R"]}


def test_the_moe_expert_axis_on_tp_is_refused_naming_a11b(tmp_path):
    ckpt = build_tiny_moe_checkpoint(str(tmp_path / "moe"))
    data, img_dir = build_iad_sft_dataset(tmp_path)
    cfg = _sft_cfg(ckpt, data, img_dir, tmp_path / "out")
    cfg["mesh"] = {"dp": 1, "fsdp": 1, "tp": 2}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    ranks = run_ranks("cli", 2, tmp_path / "ranks",
                      {"cli": "train_sft", "config": str(tmp_path / "cfg.json")})
    for r in ranks:
        assert "A.11b" in r["refused"] and "expert" in r["refused"]
