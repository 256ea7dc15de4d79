"""The sharded load, LoRA, quantized bases and SC-GRPO on a
tensor-parallel mesh, on real Gloo processes on the CPU
(tests/torch_mesh_worker.py):

* the sharded load of the 72B recipe's family (Qwen2.5-VL) at (dp,
  fsdp, tp) = (1, 2, 2): every rank holds exactly the slices
  ``shard_pytree`` cuts from the whole converted tree, and no leaf whole
  on its device;

and, each held to the one-process port run in f32:

* LoRA SFT through the library (``train/adapters.py lora_training_fns``)
  on the 72B recipe's family (Qwen2.5-VL) at (dp, fsdp, tp) = (1, 2, 2):
  the base loaded sharded and bitwise unchanged, the adapters and their
  AdamW moments sharded by ``lora_logical_axes``;
* LoRA SC-GRPO on configs/grpo_llava_next_34b.yaml itself (its LoRA
  rank 16, alpha 32, its template) on the tiny LLaVA-NeXT at (1, 2, 2),
  with its f32 base sharded, and again over an nf4 base,
  which replicates: the one-process tokens, logs and adapters, the base
  bitwise unchanged, the rollout tensor-parallel;
* full-parameter SC-GRPO on the tiny Qwen2.5-VL at tp = 2: the
  one-process tokens, logs and parameters.

The logs are held within ``LOSS_RTOL`` (1e-5, the mesh tests' own),
LoRA SFT's adapters within ``PARAM_ATOL`` (5e-6), both stated in
tests/torch_mesh_runs.py, and the SC-GRPO runs' parameters within
``TP_PARAM_ATOL`` (below).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from helpers import build_iad_rl_dataset
import torch_mesh_worker
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    LOSS_RTOL,
    _assert_logs_close,
    _assert_params_close,
    _final_params,
    _port_on_mesh,
    _port_one_process,
    f32_port,
    run_ranks,
)
import torch_threads  # noqa: F401  (one intra-op thread)

GRPO_KEYS = ("loss", "kl", "grad_norm", "reward", "reward_std",
             "completion_length")
# SC-GRPO under tp, the parameters (or adapters) after 2 AdamW steps at lr
# 1e-3 against one process (largest readings 5.07e-6, the full-parameter
# run's Qwen2.5-VL merger fc1, and 5.46e-6, the nf4 LoRA run's adapters):
# the row-parallel products add their partial sums in another order, and
# Adam's normalized update carries the difference into the weights
TP_PARAM_ATOL = 1.5e-5
RECIPE = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                      "grpo_llava_next_34b.yaml")
MESH = {"dp": 1, "fsdp": 2, "tp": 2}


@pytest.fixture(scope="module")
def qwen25_checkpoint(tmp_path_factory):
    from test_torch_qwen25_vl import build_tiny_qwen25_vl_checkpoint

    return build_tiny_qwen25_vl_checkpoint(
        str(tmp_path_factory.mktemp("qwen25")))


@pytest.fixture(scope="module")
def llava_next_checkpoint(tmp_path_factory):
    from test_torch_llava import build_tiny_llava_checkpoint

    return build_tiny_llava_checkpoint(str(tmp_path_factory.mktemp("next")),
                                       "llava_next")


# ---------------------------------------------------------------------------
# the sharded load, then LoRA and SC-GRPO on a mesh
# ---------------------------------------------------------------------------


def test_the_sharded_load_places_exactly_each_rank_s_slices(
        qwen25_checkpoint, tmp_path):
    """The 72B recipe's family at (1, 2, 2): ``load_sharded`` converts one
    leaf at a time on the host and keeps this rank's shard, which equals
    ``shard_pytree``'s of the whole converted tree, leaf by leaf, placement
    by placement.  The largest tensor a rank puts on its device is its
    largest shard, smaller than the largest leaf, which is the largest the
    host converts."""
    ckpt = qwen25_checkpoint
    ranks = run_ranks("load", 4, tmp_path / "ranks",
                      {"mesh": [1, 2, 2], "ckpt": ckpt})
    with open(os.path.join(ckpt, "config.json")) as f:
        text = json.load(f)["text_config"]
    for rank, r in enumerate(ranks):
        assert r["names_equal"] and r["mismatched"] == [], r["mismatched"]
        stats = r["stats"]
        # the largest leaf converted on the host is the largest leaf; the
        # largest tensor put on the device is the largest shard, smaller
        assert stats["host_leaf_bytes"] == r["whole_leaf_bytes"]
        assert stats["device_shard_bytes"] == r["largest_shard_bytes"]
        assert stats["device_shard_bytes"] < r["whole_leaf_bytes"]
        # the embedding: its vocabulary over tp, its hidden over fsdp
        vocab, hidden = text["vocab_size"], text["hidden_size"]
        tp_index = rank % 2
        assert r["local"]["text.embed.weight"] == [
            min(-(-vocab // 2), vocab - tp_index * -(-vocab // 2)),
            hidden // 2]


def test_lora_sft_at_fsdp2_tp2_matches_one_process(qwen25_checkpoint,
                                                   f32_port, tmp_path):
    from iadr1_tpu_torch.cli.train_sft import load_checkpoint
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.train.state import named_leaves

    args = {"mesh": [1, 2, 2], "ckpt": qwen25_checkpoint, "steps": 3}
    ranks = run_ranks("lora_sft", 4, tmp_path / "ranks", args)

    bundle = bundle_from_pretrained(qwen25_checkpoint)
    base = load_checkpoint(bundle, qwen25_checkpoint, torch.float32, "cpu")
    state, step, batches = torch_mesh_worker.lora_sft_setup(bundle, base,
                                                            args)
    want = []
    for batch in batches:
        state, m = step(state, batch)
        want.append({k: float(v) for k, v in m.items()})
    got = torch.load(tmp_path / "ranks" / "lora.pt")
    one = {name: t.detach() for name, t in named_leaves(state.params)}
    for r in ranks:
        assert r["base_unchanged"] and r["sharded"]
        _assert_logs_close(r["metrics"], want, ("loss", "accuracy",
                                                "n_label_tokens",
                                                "grad_norm"), LOSS_RTOL)
    assert want[-1]["loss"] < want[0]["loss"]
    _assert_params_close(got, one)


def _recipe_cfg(ckpt, data, img_dir, out_dir, **model):
    """configs/grpo_llava_next_34b.yaml with the tiny checkpoint, the test
    data and sizes, in f32, its LoRA section and template as they are."""
    with open(RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(model_name_or_path=ckpt, dtype="float32", **model)
    cfg["data"].update(dataset_name=data, image_path=img_dir,
                       patch_budget=256)
    cfg["grpo"].update(num_generations=2, max_prompt_length=200,
                       max_completion_length=6)
    cfg["optim"].update(learning_rate=1e-3, warmup_ratio=0.0, total_steps=4)
    cfg["train"].update(output_dir=str(out_dir), max_steps=2, batch_size=2,
                        save_steps=0)
    return cfg


def _grpo_against_one_process(cfg, mesh, tmp_path, monkeypatch):
    """The GRPO CLI on ``mesh`` and in one process, rewards that vary with
    the completion's length: (ranks' results, mesh log, one-process log),
    the tokens checked equal."""
    ranks, got = _port_on_mesh("train_grpo", mesh, cfg(tmp_path / "mesh"),
                               tmp_path, "mesh", record_tokens=True,
                               length_reward=True, record_base=True)
    tokens = torch_mesh_worker.record_tokens(monkeypatch.setattr)
    torch_mesh_worker.length_reward(monkeypatch.setattr)
    one = _port_one_process("train_grpo", cfg(tmp_path / "one"),
                            tmp_path / "one.json")
    # the tp ranks of a batch slice draw the same tokens; batch slice s
    # decoded rows s of every step's global batch, in order
    tp = mesh["tp"]
    for r in range(len(ranks)):
        assert ranks[r]["tokens"] == ranks[r - r % tp]["tokens"]
    for step, want in enumerate(tokens):
        assert [row for r in ranks[::tp] for row in r["tokens"][step]] == \
            want.tolist()
    _assert_logs_close(got, one, GRPO_KEYS, LOSS_RTOL)
    return ranks, got, one


@pytest.mark.parametrize("quant", ["none", "nf4"])
def test_lora_sc_grpo_recipe_at_fsdp2_tp2_matches_one_process(
        quant, llava_next_checkpoint, f32_port, monkeypatch, tmp_path):
    """The 34B recipe's own LoRA mode with reference elision; the nf4
    base (blocks of 16 along the contraction, so that each tp rank's
    slice of the row-parallel kernels holds whole blocks) replicates."""
    data, img_dir = build_iad_rl_dataset(tmp_path)
    model = {} if quant == "none" else {"quant": quant, "quant_block": 16}

    def cfg(out_dir):
        return _recipe_cfg(llava_next_checkpoint, data, img_dir, out_dir,
                           **model)

    ranks, got, _ = _grpo_against_one_process(cfg, MESH, tmp_path,
                                              monkeypatch)
    assert any(r["reward_std"] > 0 for r in got)       # nonzero advantages
    for r in ranks:
        assert r["base_unchanged"]
        # a quantized base whole on every rank, any other sharded
        assert all(r["base_sharded"]) == (quant == "none")
        assert not any(r["base_sharded"]) or quant == "none"
        # the rollout decoded each rank's prompt (G = 2 rows) on its 4 of
        # the 8 query heads and 1 of the 2 KV heads, its cache holding
        # them alone
        assert r["decode_shapes"] == [[[2, 4, 8], [2, 1, 206, 8],
                                       [2, 1, 206, 8]]]
    mesh_params = _final_params(tmp_path / "mesh")
    assert all(k.endswith((".a", ".b")) for k in mesh_params)
    _assert_tp_params_close(mesh_params, _final_params(tmp_path / "one"))


def test_sc_grpo_at_tp2_draws_the_one_process_tokens(
        qwen25_checkpoint, f32_port, monkeypatch, tmp_path):
    """Full-parameter SC-GRPO on the 72B recipe's family at tp = 2: the
    rollout decodes tensor-parallel on each rank's plain slice (no
    DTensor), the update runs on the sharded state."""
    data, img_dir = build_iad_rl_dataset(tmp_path)

    def cfg(out_dir):
        return {"model": {"model_name_or_path": qwen25_checkpoint,
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

    mesh = {"dp": 1, "fsdp": 1, "tp": 2}
    ranks, got, _ = _grpo_against_one_process(cfg, mesh, tmp_path,
                                              monkeypatch)
    assert any(r["reward_std"] > 0 for r in got)
    assert np.isfinite([r["loss"] for r in got]).all()
    for r in ranks:
        # 2 of the 4 query heads, 1 of the 2 KV heads on every decode call
        assert {tuple(map(tuple, s)) for s in r["decode_shapes"]} == {
            ((4, 2, 16), (4, 1, 206, 16), (4, 1, 206, 16))}
    _assert_tp_params_close(_final_params(tmp_path / "mesh"),
                            _final_params(tmp_path / "one"))


def _assert_tp_params_close(got, want):
    assert got.keys() == want.keys() and got
    worst = max(float((got[k] - want[k]).abs().max()) for k in got)
    assert worst <= TP_PARAM_ATOL, worst
