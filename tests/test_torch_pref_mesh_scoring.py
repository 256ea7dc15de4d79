"""The preference launcher's scoring stages on a mesh: KTO, BCO, RM and
PRM through cli/train_pref.py on 2 Gloo processes (tests/torch_mesh_worker.py),
each held to the same launcher's one-process run and to the JAX CLI on the
same mesh (``build_mesh(MeshConfig(...), devices=jax.devices()[:2])``):
the logged metrics within ``LOSS_RTOL`` of both, the parameters after 2
steps within ``PARAM_ATOL`` of the one-process run's
(tests/torch_mesh_runs.py).  Each stage runs at fsdp 2 or at tp 2 in the
fast tier, the two meshes alternating, and at the other under ``slow``.

Both launchers draw their own heads (RM's value head, PRM's head): the
port's runs read the JAX launcher's draws, written to a file.  KTO's KL
rows differ between the packages by design (ROADMAP C.R23), so the runs
held to JAX pair them the JAX way (``torch_mesh_worker.jax_kl_pairing``);
``test_kto_kl_partners_across_ranks`` holds the port's own pairing on the
mesh, where a row's partner lies on the other rank.

Adam's eps is 1e-4: RM's loss reads a pair's score difference, so the
value head's bias has a gradient of rounding noise, which at eps 1e-8
Adam scales up to a step of the learning rate in a direction the
summation order picks (0.000547 in one run, one process against the
mesh and JAX).
"""

import json

import numpy as np
import pytest
import torch

import jax

from helpers import build_tiny_vlm_checkpoint
from iadr1_tpu_torch.cli import train_pref
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
)
import torch_threads  # noqa: F401  (one intra-op thread)

FSDP2 = {"dp": 1, "fsdp": 2, "tp": 1}
TP2 = {"dp": 1, "fsdp": 1, "tp": 2}


def feedback_rows():
    return [{"messages": [{"role": "user", "content": f"Check sample {i}."},
                          {"role": "assistant", "content":
                           "<answer>No</answer>" + " ok" * i if i % 2
                           else "bad " * (i + 1)}],
             "label": bool(i % 2)} for i in range(8)]


def ranking_rows():
    return [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "chosen": "<think>clear surface</think><answer>No</answer>",
             "rejected": {"role": "assistant", "content": "maybe?" * (i + 1)}}
            for i in range(6)]


def prm_rows():
    return [{"prompt": f"Solve {i} + 1.",
             "completions": [f"Step one for {i}.", "Step two.", "Done."],
             "labels": [True, i % 2 == 0, True]} for i in range(6)]


# stage: (rows, the logged keys held to both references)
STAGES = {
    "kto": (feedback_rows, ("loss", "kl", "rewards/chosen",
                            "rewards/rejected")),
    "bco": (feedback_rows, ("loss", "delta", "rewards/chosen",
                            "rewards/rejected", "reward_mean", "reward_var",
                            "reward_count")),
    "rm": (ranking_rows, ("loss", "accuracy", "chosen_score",
                          "rejected_score")),
    "prm": (prm_rows, ("loss", "accuracy", "n_label_tokens")),
}


@pytest.fixture(scope="module")
def vlm_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("vlm")))


@pytest.fixture(scope="module")
def heads_file(tmp_path_factory):
    """The JAX launcher's heads (its PRNGKey(1) draws at the tiny model's
    width), as the port reads them."""
    from iadr1_tpu.train import preference as jax_preference
    from iadr1_tpu_torch.models.params_io import params_from_jax

    key = jax.random.PRNGKey(1)
    heads = {"value_head": jax_preference.init_value_head(key, 64),
             "prm_head": jax_preference.init_prm_head(key, 64)}
    path = tmp_path_factory.mktemp("heads") / "heads.pt"
    torch.save({k: params_from_jax(v, device="cpu") for k, v in heads.items()},
               path)
    return str(path)


def _cfg(stage, ckpt, data, out_dir):
    return {"stage": stage,
            "model": {"model_name_or_path": ckpt},
            "data": {"dataset_name": data, "template": "qwen2_vl",
                     "cutoff_len": 96},
            "pref": {"beta": 0.1, "ref_dtype": "float32"},
            "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                      "eps": 1e-4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1, "save_steps": 0}}


def _mesh_cases():
    cases = []
    for i, stage in enumerate(STAGES):
        fast, other = (FSDP2, TP2) if i % 2 == 0 else (TP2, FSDP2)
        for mesh, marks in ((fast, ()), (other, (pytest.mark.slow,))):
            name = "fsdp2" if mesh is FSDP2 else "tp2"
            cases.append(pytest.param(stage, mesh, marks=marks,
                                      id=f"{stage}-{name}"))
    return cases


@pytest.mark.parametrize("stage,mesh", _mesh_cases())
def test_scoring_stage_on_a_mesh_matches_one_process_and_jax(
        stage, mesh, vlm_checkpoint, heads_file, f32_port, monkeypatch,
        tmp_path):
    rows, keys = STAGES[stage]
    data = tmp_path / "data.json"
    data.write_text(json.dumps(rows()))

    def cfg(side):
        return _cfg(stage, vlm_checkpoint, str(data), tmp_path / side)

    extra = {"heads": heads_file, "jax_kl_pairing": stage == "kto"}
    ranks, got = _port_on_mesh("train_pref", mesh, cfg("mesh"), tmp_path,
                               "mesh", **extra)
    torch_mesh_worker.given_heads(heads_file, monkeypatch.setattr)
    if stage == "kto":
        torch_mesh_worker.jax_kl_pairing(monkeypatch.setattr)
    one = _port_one_process("train_pref", cfg("one"), tmp_path / "one.json")
    jax_log = _jax_cli(monkeypatch, "train_pref", mesh, cfg("jax"),
                       tmp_path / "jax.json")
    _assert_logs_close(got, one, keys + ("grad_norm",), LOSS_RTOL)
    # the JAX steps log no grad norm
    _assert_logs_close(got, jax_log, keys, LOSS_RTOL)
    assert got[-1]["loss"] != got[0]["loss"]
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))
    for r in ranks:
        assert r["mesh"] == mesh
        # the model and every head added to it are DTensors
        assert r["leaf_kinds"]["state"] == [True]


def test_kto_kl_partners_across_ranks(vlm_checkpoint, f32_port, monkeypatch,
                                      tmp_path):
    """KTO at fsdp 2 with the port's own KL rows, 4 rows a step: the rows
    are collated over the whole sampled batch before each rank takes its
    two, so global row 2 (rank 1's first) pairs with the completion of
    row 1 (rank 0's) and row 0 with that of row 3.  Each rank's batch is
    its slice of the one-process batch, which a per-rank collation would
    not give; the logs and parameters match the one-process run."""
    data = tmp_path / "data.json"
    data.write_text(json.dumps(feedback_rows()))

    def cfg(side):
        return _cfg("kto", vlm_checkpoint, str(data), tmp_path / side)

    ranks, got = _port_on_mesh("train_pref", FSDP2, cfg("mesh"), tmp_path,
                               "mesh", record_kto=True)
    seen = torch_mesh_worker.record_kto_batches(monkeypatch.setattr)
    one = _port_one_process("train_pref", cfg("one"), tmp_path / "one.json")
    for step, whole in enumerate(seen):
        for rank, r in enumerate(ranks):
            part = r["kto_batches"][step]
            rows = slice(2 * rank, 2 * rank + 2)
            for key, value in whole.items():
                assert part[key] == value[rows].tolist(), (step, rank, key)
        # the whole batch's pairing, which a per-rank collation (rank 1
        # pairing prompt 2 with completion 3) would not give
        prompts, completions = zip(*(_split(whole, r) for r in range(4)))
        whole_rows = train_pref.kl_rows(list(prompts), list(completions), 96)
        rank_rows = train_pref.kl_rows(list(prompts[2:]),
                                       list(completions[2:]), 96)
        assert _ids(whole, "kl_", 2) == whole_rows[2][0]
        assert whole_rows[2][0] != rank_rows[0][0]
    _assert_logs_close(got, one, STAGES["kto"][1] + ("grad_norm",),
                       LOSS_RTOL)
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))


def _ids(batch, prefix, r):
    n = int(np.asarray(batch[f"{prefix}segment_ids"][r]).sum())
    return list(batch[f"{prefix}input_ids"][r][:n])


def _split(batch, r):
    """(prompt ids, completion ids) of target row ``r``: the unlabeled
    head and the labeled tail."""
    from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX

    ids = _ids(batch, "", r)
    labels = list(batch["labels"][r][:len(ids)])
    first = next(k for k, x in enumerate(labels) if x != IGNORE_INDEX)
    return ids[:first], ids[first:]
