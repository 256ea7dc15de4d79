"""What the mesh tests share (pytest does not collect this file):
starting one Gloo process a rank (tests/torch_mesh_worker.py), the
one-process port run and the JAX CLI run of the same config, and the
comparisons of their logs and parameters.  ``f32_port`` is a fixture: a
test module imports it by name.
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
