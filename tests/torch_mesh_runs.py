"""What the mesh tests share (pytest does not collect this file):
starting one Gloo process a rank (tests/torch_mesh_worker.py), the
one-process port run and the JAX CLI run of the same config, the
comparisons of their logs and parameters, and the check of a preference
rollout stage on a mesh (``check_rollout_stage``).  ``f32_port`` is a
fixture: a test module imports it by name.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import registry

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
# the logs against both references (largest reading 7.1e-6, DPO's
# rewards/chosen against JAX), the parameters after 2 steps against one
# process (largest reading 1.44e-6, at (1, 2, 2))
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-6


def run_ranks(case: str, world: int, out_dir, args: dict,
              timeout: int = 240) -> list[dict]:
    """``world`` worker processes of ``case``; every rank's result."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, "init")
    env = dict(os.environ, OMP_NUM_THREADS="1", USE_TF="0",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(WORKER)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    logs = [open(os.path.join(out_dir, f"log{r}.txt"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(world), str(r), init, out_dir,
         json.dumps(args)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        if rc:
            with open(os.path.join(out_dir, f"log{r}.txt")) as f:
                pytest.fail(f"rank {r} exited {rc}:\n{f.read()[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _log(out_dir):
    with open(os.path.join(out_dir, "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _final_params(out_dir):
    from safetensors.torch import load_file

    from iadr1_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    state = load_file(mgr.path(mgr.latest_step()))
    return {k: v for k, v in state.items() if k.startswith("params.")}


@pytest.fixture
def f32_port(monkeypatch):
    """The one-process port run computes in f32, as the ranks do."""
    for name in ("bundle_from_hf_config", "bundle_from_pretrained"):
        monkeypatch.setattr(registry, name, functools.partial(
            getattr(registry, name), precision=FULL_PRECISION))


def _jax_cli(monkeypatch, module, mesh, cfg, path):
    """The JAX CLI ``module`` on ``mesh`` over the first n virtual devices,
    f32 compute, the dense attention."""
    import importlib

    from iadr1_tpu import core as jax_core
    from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
    from iadr1_tpu.models import registry as jax_registry

    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"]
    monkeypatch.setattr(jax_core, "build_mesh", functools.partial(
        jax_core.build_mesh, devices=jax.devices()[:n]))
    for name in ("bundle_from_hf_config", "bundle_from_pretrained"):
        monkeypatch.setattr(jax_registry, name, functools.partial(
            getattr(jax_registry, name), precision=JAX_FULL))
    cfg = dict(cfg, mesh=mesh, model=dict(cfg["model"], attention="xla"))
    path.write_text(json.dumps(cfg))
    main = importlib.import_module(f"iadr1_tpu.cli.{module}").main
    assert main(["--config", str(path)]) == 0
    return _log(cfg["train"]["output_dir"])


def _port_one_process(module, cfg, path):
    import importlib

    cfg = dict(cfg, mesh={})
    path.write_text(json.dumps(cfg))
    main = importlib.import_module(f"iadr1_tpu_torch.cli.{module}").main
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    return _log(cfg["train"]["output_dir"])


def _port_on_mesh(module, mesh, cfg, tmp_path, name, **extra):
    cfg = dict(cfg, mesh=mesh)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    world = mesh["dp"] * mesh["fsdp"] * mesh["tp"]
    results = run_ranks("cli", world, tmp_path / f"{name}_ranks",
                        {"cli": module, "config": str(path), "f32": True,
                         **extra})
    return results, _log(cfg["train"]["output_dir"])


def _assert_logs_close(got, want, keys, rtol):
    """Within ``rtol``, or within the logs' rounding to 6 decimals."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=1e-6,
                                       err_msg=key)


def _assert_params_close(a, b):
    assert a.keys() == b.keys()
    worst = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    assert worst <= PARAM_ATOL, worst


# ---------------------------------------------------------------------------
# the preference launcher's rollout stages on a mesh
# (tests/test_torch_pref_mesh_rollout.py, tests/test_torch_pref_mesh_nash_gkd.py)
# ---------------------------------------------------------------------------

FSDP2 = {"dp": 1, "fsdp": 2, "tp": 1}
TP2 = {"dp": 1, "fsdp": 1, "tp": 2}
# the logger's own fields, which no step computes
LOGGER_KEYS = {"current_steps", "total_steps", "percentage", "elapsed_time",
               "remaining_time"}


def prompt_rows():
    return [{"messages": [{"role": "user",
                           "content": f"Are there defects in sample {i}?"}],
             "solution": "<answer>No</answer>"} for i in range(8)]


def conversation_rows():
    return [{"messages": [{"role": "user", "content": f"Check sample {i}."},
                          {"role": "assistant",
                           "content": "<answer>No</answer>" + " ok" * i}]}
            for i in range(8)]


# stage: (rows, the pref section, the ppo section), in the order whose
# index alternates the fast tier's mesh (even fsdp 2, odd tp 2)
ROLLOUT_STAGES = {
    "ppo": (prompt_rows, {}, {"max_prompt_length": 32,
                              "max_completion_length": 8,
                              "mini_batch_size": 2, "ppo_epochs": 2}),
    "rloo": (prompt_rows, {"num_generations": 2, "max_completion_length": 8},
             {}),
    "online_dpo": (prompt_rows, {"max_completion_length": 8,
                                 "missing_eos_penalty": 0.1}, {}),
    "xpo": (prompt_rows, {"max_completion_length": 8}, {}),
    "nash_md": (prompt_rows, {"max_completion_length": 8}, {}),
    "gkd": (conversation_rows, {"max_completion_length": 8,
                                "gkd_lmbda": 0.5}, {}),
}


def rollout_cases(stages):
    """(stage, mesh, ppo overrides) parameters of ``stages``: each at fsdp
    2 or tp 2 in the fast tier by its index in ROLLOUT_STAGES, at the
    other under ``slow``."""
    order = list(ROLLOUT_STAGES)
    cases = []
    for stage in stages:
        fast, other = ((FSDP2, TP2) if order.index(stage) % 2 == 0
                       else (TP2, FSDP2))
        for mesh, marks in ((fast, ()), (other, (pytest.mark.slow,))):
            name = "fsdp2" if mesh is FSDP2 else "tp2"
            cases.append(pytest.param(stage, mesh, {}, marks=marks,
                                      id=f"{stage}-{name}"))
    return cases


def _batch_rank_tokens(ranks, mesh):
    """Every rollout's rows in the global order: each batch slice's rows
    (its first tp rank's; the others' must equal them), in rank order."""
    tp = mesh["tp"]
    slices = [ranks[i:i + tp] for i in range(0, len(ranks), tp)]
    for group in slices:
        assert all(r["tokens"] == group[0]["tokens"] for r in group)
    n = len(slices[0][0]["tokens"])
    return [[row for group in slices for row in group[0]["tokens"][k]]
            for k in range(n)]


def check_rollout_stage(stage, mesh, ppo, ckpt, teacher, monkeypatch,
                        tmp_path):
    """``stage`` through cli/train_pref.py on ``mesh`` (2 Gloo processes)
    against the one-process run: every rollout's completions token for
    token, every logged metric within LOSS_RTOL, the parameters after 2
    steps within PARAM_ATOL, the state (heads included) and GKD's teacher
    DTensors.  Both sides reward a completion by its length and keep the
    rollouts' KV cache in f32 (``torch_mesh_worker.f32_cache``)."""
    import torch_mesh_worker

    rows, pref, ppo_cfg = ROLLOUT_STAGES[stage]
    data = tmp_path / "data.json"
    data.write_text(json.dumps(rows()))
    pref = dict(pref, beta=0.1, ref_dtype="float32")
    if stage == "gkd":
        pref["teacher_model_name_or_path"] = teacher

    def cfg(side):
        return {"stage": stage,
                "model": {"model_name_or_path": ckpt},
                "data": {"dataset_name": str(data), "template": "qwen2_vl",
                         "cutoff_len": 64},
                "pref": pref, "ppo": {**ppo_cfg, **ppo},
                "optim": {"learning_rate": 1e-3, "warmup_ratio": 0.0,
                          "eps": 1e-4},
                "train": {"output_dir": str(tmp_path / side), "max_steps": 2,
                          "batch_size": 4, "logging_steps": 1,
                          "save_steps": 0, "seed": 0}}

    ranks, got = _port_on_mesh("train_pref", mesh, cfg("mesh"), tmp_path,
                               "mesh", record_tokens=True,
                               length_reward=True, f32_cache=True)
    tokens = torch_mesh_worker.record_tokens(monkeypatch.setattr)
    torch_mesh_worker.length_reward(monkeypatch.setattr)
    torch_mesh_worker.f32_cache(monkeypatch.setattr)
    one = _port_one_process("train_pref", cfg("one"), tmp_path / "one.json")
    assert _batch_rank_tokens(ranks, mesh) == [t.tolist() for t in tokens]
    assert len(tokens) >= (1 if stage == "gkd" else 2)
    keys = sorted(set(one[0]) - LOGGER_KEYS)
    assert set(got[0]) - LOGGER_KEYS == set(keys)
    _assert_logs_close(got, one, keys, LOSS_RTOL)
    assert got[-1]["loss"] != got[0]["loss"]
    _assert_params_close(_final_params(tmp_path / "mesh"),
                         _final_params(tmp_path / "one"))
    for r in ranks:
        assert r["mesh"] == mesh
        # the policy's state (with PPO's value head) and GKD's teacher
        # are DTensors
        assert r["leaf_kinds"]["state"] == [True]
        assert r["leaf_kinds"]["teacher"] == ([True] if stage == "gkd"
                                              else [])
    if stage == "gkd":
        assert [r["on_policy"] for r in got] == [0.0, 1.0]
