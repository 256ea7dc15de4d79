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
* two updates of every optimizer at fsdp = 2, (2, 2, 1) and (1, 2, 2) on
  the ranks' shards: the parameters those of one process, each rank's
  optimizer state no larger than JAX's largest per-device state on the
  same tree and mesh, the state shaped like a parameter placed as it, and
  no gather larger than one matrix (none for the elementwise ones);
* a global batch's placements and each rank's rows at (1, 2, 2);
* a checkpoint saved on 2 ranks, byte for byte the one-process file, and
  restored onto the mesh and onto one process; the HF export likewise;
  every optimizer's state likewise, its next update on the mesh after the
  restore that of one process;
* the SFT steps gather the Qwen2-VL tower one block at a time.

The file's mesh runs are four spawned jobs of 2 and 4 processes
(``torch_mesh_runs.MeshJobs``), run one after another from the module's
start, beside the tests' one-process and JAX references; each case stays
its own test.  The MoE at tp > 1 is tests/test_torch_mesh_moe_pissa_chain.py's.

Each stated tolerance is about 3x the largest sound reading, which the
constants below name.
"""

import functools
import json
import os

import pytest
import torch

from helpers import (
    build_iad_rl_dataset,
    build_iad_sft_dataset,
    build_tiny_moe_checkpoint,
    build_tiny_vlm_checkpoint,
)
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.train.state import tree_leaves
import torch_mesh_worker
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    LOSS_RTOL,
    MeshJobs,
    _assert_logs_close,
    _assert_params_close,
    _final_params,
    _jax_cli,
    _log,
    _port_one_process,
    cli_job,
    f32_port,
)
import torch_threads  # noqa: F401  (one intra-op thread)

KERNEL_MESHES = {"fsdp2": (1, 2, 1), "tp2": (1, 1, 2)}
SFT_MESHES = {"fsdp2": {"dp": 1, "fsdp": 2, "tp": 1},
              "fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}}
DPO_MESHES = {"fsdp2": {"dp": 1, "fsdp": 2, "tp": 1},
              "tp2": {"dp": 1, "fsdp": 1, "tp": 2}}
FSDP2 = {"dp": 1, "fsdp": 2, "tp": 1}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's inputs, the same for the mesh runs and the tests'
    references."""
    root = tmp_path_factory.mktemp("inputs")
    torch.save(_kernel_inputs(), root / "kernels.pt")
    params, axes, grads = _opt_tree()
    torch.save({"params": params, "axes": axes, "grads": grads},
               root / "optim.pt")
    gen = torch.Generator().manual_seed(9)
    torch.save({"params": params, "axes": axes, "grads": grads,
                "mu": [torch.randn(p.shape, generator=gen)
                       for p in tree_leaves(params)]}, root / "ckpt.pt")
    (root / "pairs.json").write_text(json.dumps(_pairs()))
    return {"root": root,
            "vlm": build_tiny_vlm_checkpoint(str(root / "vlm")),
            "moe": build_tiny_moe_checkpoint(str(root / "moe")),
            "sft": build_iad_sft_dataset(root / "sft"),
            "rl": build_iad_rl_dataset(root / "rl")}


@pytest.fixture(scope="module")
def jobs(inputs, tmp_path_factory):
    """The file's mesh runs (``MeshJobs``), one after another from the
    module's start."""
    root = tmp_path_factory.mktemp("mesh")
    i = inputs["root"]

    def out(name):
        return root / f"{name}_out"

    kernels = [{"name": f"kernels_{m}", "case": "kernels",
                "args": {"mesh": list(KERNEL_MESHES[m]),
                         "inputs": str(i / "kernels.pt")}}
               for m in KERNEL_MESHES]
    optim = {m: {"name": f"optim_{m}", "case": "optimizer",
                 "args": {"mesh": list(mesh), "inputs": str(i / "optim.pt"),
                          "optims": {n: _optim_cfg(n) for n in OPTIMIZERS}}}
             for m, mesh in OPTIMIZER_MESHES.items()}

    def sft(mesh_id):
        return cli_job(f"sft_{mesh_id}", "train_sft", SFT_MESHES[mesh_id],
                       _sft_cfg(inputs["vlm"], *inputs["sft"],
                                out(f"sft_{mesh_id}")), root)

    # one job at a time, in the order the tests read them
    runs = MeshJobs(root, [
        (2, [*kernels, sft("fsdp2")]),
        (4, [sft("fsdp2_tp2")]),
        (2, [cli_job("do_predict", "train_sft", FSDP2,
                     _predict_cfg(inputs, out("do_predict")), root),
             cli_job("moe", "train_sft", FSDP2,
                     _moe_cfg(inputs, out("moe")), root),
             cli_job("grpo", "train_grpo", FSDP2,
                     _grpo_cfg(inputs, out("grpo")), root,
                     record_tokens=True, length_reward=True),
             *(cli_job(f"dpo_{m}", "train_pref", DPO_MESHES[m],
                       _dpo_cfg(inputs, out(f"dpo_{m}")), root)
               for m in DPO_MESHES),
             optim["fsdp2"],
             {"name": "checkpoint", "case": "checkpoint",
              "args": {"mesh": [1, 2, 1], "inputs": str(i / "ckpt.pt"),
                       "dir": str(out("checkpoint")), "hf": TINY_QWEN2,
                       "export": str(out("export")),
                       "optims": {n: _optim_cfg(n) for n in OPTIMIZERS}}}]),
        (4, [optim["dp2_fsdp2"], optim["fsdp2_tp2"],
             {"name": "batch", "case": "batch",
              "args": {"mesh": [1, 2, 2]}}])])
    runs.outputs = out
    yield runs
    runs.close()


# ---------------------------------------------------------------------------
# the kernels' sharding rule
# ---------------------------------------------------------------------------


def _kernel_inputs():
    gen = torch.Generator().manual_seed(3)
    B, H, Hkv, T, D, S = 4, 4, 2, 40, 64, 48

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    seg = torch.ones(B, T, dtype=torch.int32)
    seg[1, 25:] = 2
    seg[3, 30:] = 0
    cseg = (torch.arange(S)[None] < torch.tensor([[40], [33], [20], [45]])
            ).to(torch.int32)
    return {"q": rnd(B, H, T, D), "k": rnd(B, Hkv, T, D),
            "v": rnd(B, Hkv, T, D), "seg": seg, "do": rnd(B, H, T, D),
            "dlse": rnd(B, H, T), "dq": rnd(B, H, D),
            "ck": rnd(B, Hkv, S, D), "cv": rnd(B, Hkv, S, D),
            "cseg": cseg, "length": 45}


@pytest.mark.parametrize("mesh_id", list(KERNEL_MESHES))
def test_the_kernel_twins_behind_the_rule_equal_the_unsharded_calls(
        mesh_id, jobs):
    from iadr1_tpu_torch.kernels.decode_attention import decode_attention
    from iadr1_tpu_torch.kernels.flash_attention import flash_attention

    mesh = KERNEL_MESHES[mesh_id]
    inputs = _kernel_inputs()
    seg, cseg = inputs["seg"], inputs["cseg"]
    B, H, T, D = inputs["q"].shape
    Hkv, S = inputs["ck"].shape[1:3]
    q, k, v = (inputs[n].clone().requires_grad_() for n in ("q", "k", "v"))
    out, lse = flash_attention(q, k, v, segment_ids=seg, kv_segment_ids=seg,
                               causal=True)
    torch.autograd.backward([out, lse], [inputs["do"], inputs["dlse"]])
    want = {"out": out, "lse": lse, "dq": q.grad, "dk": k.grad,
            "dv": v.grad,
            "decode": decode_attention(inputs["dq"], inputs["ck"],
                                       inputs["cv"], cseg, 45)}
    job = f"kernels_{mesh_id}"
    results = jobs.result(job)
    for rank in range(len(results)):
        got = torch.load(os.path.join(jobs.out(job), f"kernels{rank}.pt"))
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


@pytest.mark.parametrize("mesh_id", list(SFT_MESHES))
def test_sft_cli_on_a_mesh_matches_one_process_and_jax(
        mesh_id, inputs, jobs, f32_port, monkeypatch, tmp_path):
    mesh = SFT_MESHES[mesh_id]
    cfg = functools.partial(_sft_cfg, inputs["vlm"], *inputs["sft"])
    one = _port_one_process("train_sft", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    jax_log = _jax_cli(monkeypatch, "train_sft", mesh,
                       cfg(tmp_path / "jax"), tmp_path / "jax.json")
    ranks = jobs.result(f"sft_{mesh_id}")
    got = _log(jobs.outputs(f"sft_{mesh_id}"))
    keys = ("loss", "accuracy", "n_label_tokens", "grad_norm")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    _assert_logs_close(got, jax_log, keys, LOSS_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]
    _assert_params_close(_final_params(jobs.outputs(f"sft_{mesh_id}")),
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


@pytest.mark.parametrize("mesh_id", list(SFT_MESHES))
def test_sft_on_a_mesh_gathers_the_qwen2_vl_tower_a_block_at_a_time(
        mesh_id, jobs):
    """The tower's stacked blocks stay sharded through ``compute_view``
    and each block is gathered inside its checkpoint: its 2 blocks, in
    the forward and again in the replay, 2 steps; no gather larger than
    one block's leaves, and no earlier block's weights alive when a block
    starts."""
    for r in jobs.result(f"sft_{mesh_id}"):
        towers = r["tower_gathers"]
        assert towers["calls"] == 2 * 2 * 2
        assert 0 < towers["largest"] <= towers["block"]
        assert towers["held"] == 0


def _predict_cfg(inputs, out_dir):
    c = _sft_cfg(inputs["vlm"], *inputs["sft"], out_dir)
    c["optim"]["learning_rate"] = 0.0
    c["train"]["max_steps"] = 1
    c["predict"] = {"do_predict": True, "max_samples": 3,
                    "max_new_tokens": 6, "batch_size": 2}
    return c


def test_do_predict_on_a_mesh_writes_the_one_process_files(
        inputs, jobs, f32_port, tmp_path):
    """``predict.do_predict`` at fsdp = 2 (learning rate 0): every rank
    gathers the parameters, rank 0 generates off the mesh; its
    generated_predictions.jsonl and predict_results.json are the
    one-process run's byte for byte."""
    _port_one_process("train_sft", _predict_cfg(inputs, tmp_path / "one"),
                      tmp_path / "one.json")
    jobs.result("do_predict")
    for name in ("generated_predictions.jsonl", "predict_results.json"):
        got, want = (open(side / name, "rb").read() for side in (
            jobs.outputs("do_predict"), tmp_path / "one"))
        assert got == want, name
    assert len(want) and len(open(tmp_path / "one" / (
        "generated_predictions.jsonl")).readlines()) == 3


def _moe_cfg(inputs, out_dir):
    c = _sft_cfg(inputs["moe"], *inputs["sft"], out_dir)
    c["data"]["template"] = "qwen"
    return c


def test_moe_sft_with_its_router_loss_at_fsdp2_matches_one_process(
        inputs, jobs, f32_port, tmp_path):
    """The router's load-balancing loss is a global statistic: the ranks
    pool their routings before the loss (``core.mesh.batch_share``)."""
    one = _port_one_process("train_sft", _moe_cfg(inputs, tmp_path / "one"),
                            tmp_path / "one.json")
    jobs.result("moe")
    got = _log(jobs.outputs("moe"))
    _assert_logs_close(got, one, ("loss", "aux_loss", "grad_norm"),
                       LOSS_RTOL)
    assert all(r["aux_loss"] > 0 for r in got)
    _assert_params_close(_final_params(jobs.outputs("moe")),
                         _final_params(tmp_path / "one"))


def _grpo_cfg(inputs, out_dir):
    data, img_dir = inputs["rl"]
    return {"model": {"model_name_or_path": inputs["vlm"],
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


def test_grpo_cli_at_fsdp2_draws_the_one_process_tokens(
        inputs, jobs, f32_port, monkeypatch, tmp_path):
    tokens = torch_mesh_worker.record_tokens(monkeypatch.setattr)
    torch_mesh_worker.length_reward(monkeypatch.setattr)
    one = _port_one_process("train_grpo", _grpo_cfg(inputs, tmp_path / "one"),
                            tmp_path / "one.json")
    ranks = jobs.result("grpo")
    got = _log(jobs.outputs("grpo"))
    # rank r decoded rows r of every step's global batch, in order
    per_rank = [r["tokens"] for r in ranks]
    for step, want in enumerate(tokens):
        assert [row for r in per_rank for row in r[step]] == want.tolist()
    keys = ("loss", "kl", "grad_norm", "reward", "reward_std",
            "completion_length")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    assert any(r["reward_std"] > 0 for r in got)    # nonzero advantages
    _assert_params_close(_final_params(jobs.outputs("grpo")),
                         _final_params(tmp_path / "one"))


def _pairs():
    return [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "chosen": "<think>clear surface</think><answer>No</answer>",
             "rejected": {"role": "assistant",
                          "content": "maybe?" * (i + 1)}}
            for i in range(6)]


def _dpo_cfg(inputs, out_dir):
    return {"stage": "dpo",
            "model": {"model_name_or_path": inputs["vlm"]},
            "data": {"dataset_name": str(inputs["root"] / "pairs.json"),
                     "template": "qwen2_vl", "cutoff_len": 96},
            "pref": {"beta": 0.1, "ref_dtype": "float32"},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 2, "logging_steps": 1,
                      "save_steps": 0}}


@pytest.mark.parametrize("mesh_id", list(DPO_MESHES))
def test_dpo_through_the_launcher_on_a_mesh(mesh_id, inputs, jobs, f32_port,
                                            monkeypatch, tmp_path):
    mesh = DPO_MESHES[mesh_id]
    one = _port_one_process("train_pref", _dpo_cfg(inputs, tmp_path / "one"),
                            tmp_path / "one.json")
    jax_log = _jax_cli(monkeypatch, "train_pref", mesh,
                       _dpo_cfg(inputs, tmp_path / "jax"),
                       tmp_path / "jax.json")
    jobs.result(f"dpo_{mesh_id}")
    got = _log(jobs.outputs(f"dpo_{mesh_id}"))
    keys = ("loss", "rewards/chosen", "rewards/rejected", "rewards/margins",
            "grad_norm")
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    # the JAX step logs no grad norm
    _assert_logs_close(got, jax_log, keys[:-1], LOSS_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]
    _assert_params_close(_final_params(jobs.outputs(f"dpo_{mesh_id}")),
                         _final_params(tmp_path / "one"))


# ---------------------------------------------------------------------------
# optimizers, checkpoints
# ---------------------------------------------------------------------------

OPTIMIZERS = ("adamw", "sgd", "lion", "adafactor", "galore", "apollo",
              "badam", "adam_mini", "muon", "loraplus")
# the updates that read no whole matrix
NO_GATHERS = ("adamw", "sgd", "lion", "adafactor", "badam", "adam_mini",
              "loraplus")


def _opt_tree():
    """A small decoder-shaped tree (paths the path-reading optimizers know)
    with its logical axes, and two updates' gradients for it.  Adafactor
    factors the embedding and the q and up kernels (both dims at least
    128); k's 3 heads of 32 (Adam-mini's ``head_dim``) straddle the two tp
    ranks' 48 columns each."""
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    params = {"embed": {"weight": rnd(256, 128)},
              "layers": {"attn": {"q": {"kernel": rnd(2, 128, 256)},
                                  "k": {"kernel": rnd(2, 128, 96)}},
                         "mlp": {"up": {"kernel": rnd(2, 128, 512)}},
                         "input_norm": torch.ones(2, 128)},
              "final_norm": torch.ones(128)}
    axes = {"embed": {"weight": ("vocab", "embed")},
            "layers": {"attn": {"q": {"kernel": (None, "embed", "heads")},
                                "k": {"kernel": (None, "embed",
                                                 "kv_heads")}},
                       "mlp": {"up": {"kernel": (None, "embed", "mlp")}},
                       "input_norm": (None, "norm")},
            "final_norm": ("norm",)}
    grads = [[rnd(*p.shape) * 0.1 for p in tree_leaves(params)]
             for _ in range(2)]
    return params, axes, grads


# the largest matrix of the tree: one layer of the MLP kernel, f32
MATRIX_BYTES = 128 * 512 * 4


def _optim_cfg(name):
    cfg = {"optimizer": name, "learning_rate": 1e-2, "total_steps": 4,
           "warmup_ratio": 0.0, "galore_rank": 2, "apollo_rank": 2,
           "badam_num_layers": 2, "adam_mini_head_dim": 32}
    if name == "loraplus":
        cfg.update(optimizer="adamw", loraplus_lr_ratio=16.0)
    return cfg


OPTIMIZER_MESHES = {"fsdp2": (1, 2, 1), "dp2_fsdp2": (2, 2, 1),
                    "fsdp2_tp2": (1, 2, 2)}


@pytest.fixture(scope="module")
def optimizer_runs(jobs):
    """Every optimizer's two updates on each mesh, one run a mesh: (the
    parameters after them, each rank's records)."""
    runs = {}

    def run(mesh_id):
        if mesh_id not in runs:
            ranks = jobs.result(f"optim_{mesh_id}")
            runs[mesh_id] = (torch.load(os.path.join(
                jobs.out(f"optim_{mesh_id}"), "params.pt")),
                [r["optims"] for r in ranks])
        return runs[mesh_id]

    return run


def _one_process_updates(name, grads, checkpoint=None):
    """The parameters of ``_opt_tree`` after ``grads``' updates on one
    process; from the state saved under ``checkpoint`` (a directory)
    when given, restored into a state of zeros."""
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state

    opt, _ = make_optimizer(OptimizerConfig(**_optim_cfg(name)))
    params = _opt_tree()[0]
    if checkpoint is None:
        state = create_train_state(params, opt)
    else:
        state = CheckpointManager(checkpoint).restore(create_train_state(
            torch_mesh_worker.zeros_like_tree(params), opt))
    for g in grads:
        state = state.apply_gradients(g, opt)
    return [p.detach() for p in tree_leaves(state.params)]


@pytest.mark.parametrize("mesh_id", list(OPTIMIZER_MESHES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_optimizer_updates_a_sharded_leaf_as_one_process(
        name, mesh_id, optimizer_runs):
    """Each side clips by its own ``global_norm``: the ranks' over their
    shards and the mesh, one process's over the whole leaves, which must
    agree bitwise (one ulp of the clip factor, APOLLO's channel scales
    turn into 3.6e-7 after two updates)."""
    from iadr1_tpu_torch.train.optimizers import global_norm

    grads = _opt_tree()[2]
    want = _one_process_updates(name, grads)
    got, ranks = optimizer_runs(mesh_id)
    for g, w in zip(got[name], want, strict=True):
        # each rank updates its shards: Adafactor's and Adam-mini's
        # reductions over a sharded dim sum in another order than one
        # process's (the others bitwise equal in every run so far)
        torch.testing.assert_close(g, w, rtol=0, atol=3e-7)
    for r in ranks:
        torch.testing.assert_close(
            torch.tensor(r[name]["grad_norms"]),
            torch.stack([global_norm(g) for g in grads]), rtol=0, atol=0)


@pytest.mark.parametrize("mesh_id", list(OPTIMIZER_MESHES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_optimizer_keeps_its_state_on_the_shards(name, mesh_id,
                                                      optimizer_runs):
    """The state shaped like a parameter is a DTensor placed as it; an
    update gathers no matrix (the elementwise ones, Adafactor) or one at a
    time, and only where a mesh axis shards the leaf's matrices: GaLore
    and APOLLO each target matrix's gradient (6 an update), GaLore its
    kept projections too after the refresh (6 more at update 2), Muon its
    6 sharded matrices an update (the unsharded input norms take one
    batched call).  Adam-mini's head means, k's straddling heads
    included, reduce a [*, 1, heads] row and gather nothing."""
    for r in optimizer_runs(mesh_id)[1]:
        rec = r[name]
        assert rec["placed"]
        if name in NO_GATHERS:
            assert rec["gathers"] == 0
        else:
            assert 0 < rec["largest_gather"] <= MATRIX_BYTES
        want = {"galore": 18, "apollo": 12, "muon": 12}
        if name in want:
            assert rec["gathers"] == want[name]


def _jax_state_bytes(shape) -> dict:
    """{optimizer: [the largest per-device bytes of its state after update
    1, after update 2]} in JAX: ``create_sharded_state`` and a jitted
    ``apply_gradients`` on the first devices of the conftest's 8, the
    tree placed by its logical axes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iadr1_tpu.core.mesh import MeshConfig, build_mesh, shard_pytree
    from iadr1_tpu.core.mesh import set_kernel_mesh
    from iadr1_tpu.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu.train.state import create_sharded_state
    from iadr1_tpu_torch.train.state import named_leaves, unflatten

    params, axes, grads = _opt_tree()
    names = [n for n, _ in named_leaves(params)]
    mesh = build_mesh(MeshConfig(*shape),
                      devices=jax.devices()[:int(np.prod(shape))])
    set_kernel_mesh(None)

    def placed(leaves):
        tree = unflatten({n: jnp.asarray(t.numpy())
                          for n, t in zip(names, leaves)})
        return shard_pytree(tree, axes, mesh)

    def per_device(tree):
        held = {}
        for leaf in jax.tree.leaves(tree):
            for shard in getattr(leaf, "addressable_shards", ()):
                held[shard.device] = held.get(shard.device, 0) + (
                    shard.data.nbytes)
        return max(held.values())

    jparams = placed(tree_leaves(params))
    jgrads = [placed(g) for g in grads]
    out = {}
    for name in OPTIMIZERS:
        opt, _ = make_optimizer(OptimizerConfig(**_optim_cfg(name)))
        state = create_sharded_state(jparams, opt)
        step = jax.jit(lambda s, g, opt=opt: s.apply_gradients(g, opt))
        out[name] = []
        for g in jgrads:
            state = step(state, g)
            out[name].append(per_device(state.opt_state))
    return out


@pytest.fixture(scope="module")
def jax_state_bytes():
    runs = {}

    def run(mesh_id):
        if mesh_id not in runs:
            runs[mesh_id] = _jax_state_bytes(OPTIMIZER_MESHES[mesh_id])
        return runs[mesh_id]

    return run


@pytest.mark.parametrize("mesh_id", list(OPTIMIZER_MESHES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_optimizer_holds_no_more_state_a_rank_than_jax(
        name, mesh_id, optimizer_runs, jax_state_bytes):
    """Each rank's optimizer-state bytes after updates 1 and 2 against
    JAX's largest per-device bytes on the same tree and mesh (whose
    propagation shards the state from the first update on; its step
    counts are device arrays, the port's a Python int)."""
    want = jax_state_bytes(mesh_id)[name]
    for r in optimizer_runs(mesh_id)[1]:
        got = r[name]["state_bytes"]
        assert len(got) == 2
        assert all(g <= w for g, w in zip(got, want)), (got, want)


TINY_QWEN2 = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
                  vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, tie_word_embeddings=False)


def test_a_checkpoint_saved_on_two_ranks_is_the_one_process_file(
        inputs, jobs, tmp_path):
    """... restored onto the mesh and onto one process; the HF export of
    sharded parameters is the one-process export too."""
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state

    params = _opt_tree()[0]
    mu = torch.load(inputs["root"] / "ckpt.pt")["mu"]
    hf = TINY_QWEN2
    ranks = jobs.result("checkpoint")
    mesh_dir, export_mesh = (jobs.outputs("checkpoint"),
                             jobs.outputs("export"))
    assert all(r["restored"] and r["step"] == 3 and r["count"] == 3
               for r in ranks)

    opt, _ = make_optimizer(OptimizerConfig(total_steps=4))
    state = create_train_state(params, opt)
    with torch.no_grad():
        for t, m in zip(state.opt_state["mu"], mu):
            t.copy_(m)
    state.opt_state["count"] = 3
    CheckpointManager(str(tmp_path / "one")).save(3, state._replace(step=3))
    mesh_file = (mesh_dir / "3.safetensors").read_bytes()
    assert mesh_file == (tmp_path / "one" / "3.safetensors").read_bytes()

    fresh = create_train_state(
        torch_mesh_worker.zeros_like_tree(_opt_tree()[0]), opt)
    fresh = CheckpointManager(str(mesh_dir)).restore(fresh)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert fresh.step == 3 and fresh.opt_state["count"] == 3

    # the export: rank 0 wrote the file one process writes
    from iadr1_tpu_torch.models.params_export import save_pretrained

    bundle = registry.bundle_from_hf_config(hf)
    save_pretrained(bundle, bundle.init_params(
        seed=0, dtype=torch.float32, device="cpu"), str(tmp_path / "export"))
    assert ((export_mesh / "model.safetensors").read_bytes()
            == (tmp_path / "export" / "model.safetensors").read_bytes())


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_every_optimizer_s_checkpoint_on_two_ranks_is_the_one_process_file(
        name, jobs, tmp_path):
    """Its state (``torch_mesh_worker.fill_state``) saved from fsdp = 2 is
    the one-process file byte for byte; restored onto the mesh it equals
    what was saved, and the next update there is that of one process
    restored from the same file."""
    from iadr1_tpu_torch.train.checkpoint import CheckpointManager
    from iadr1_tpu_torch.train.optimizers import OptimizerConfig, make_optimizer
    from iadr1_tpu_torch.train.state import create_train_state

    assert all(r["optims"][name] for r in jobs.result("checkpoint"))
    params, _, grads = _opt_tree()
    opt, _ = make_optimizer(OptimizerConfig(**_optim_cfg(name)))
    state = create_train_state(params, opt)
    torch_mesh_worker.fill_state(state.opt_state)
    CheckpointManager(str(tmp_path / name)).save(1, state._replace(step=1))
    mesh_dir = jobs.outputs("checkpoint") / name
    assert ((mesh_dir / "1.safetensors").read_bytes()
            == (tmp_path / name / "1.safetensors").read_bytes())
    want = _one_process_updates(name, grads[1:], str(mesh_dir))
    got = torch.load(os.path.join(jobs.out("checkpoint"),
                                  f"params_{name}.pt"))
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=3e-7)


def test_a_global_batch_places_each_rank_s_rows(jobs):
    """(dp, fsdp, tp) = (1, 2, 2): the batch splits over fsdp alone, the
    tp ranks of a slice hold the same rows, the vision plans replicate."""
    ranks = jobs.result("batch")
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
