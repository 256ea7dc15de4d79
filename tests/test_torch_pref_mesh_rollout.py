"""The preference launcher's PPO, RLOO, online DPO and XPO on a mesh, on
2 Gloo processes (tests/torch_mesh_worker.py), each held to the same
launcher's one-process run by ``torch_mesh_runs.check_rollout_stage``:
every completion token for token (each batch rank's rows of every
rollout, in rank order, are the one-process rows; the tp ranks of a batch
slice draw the same), every logged metric within ``LOSS_RTOL`` and the
parameters after 2 steps within ``PARAM_ATOL``.  The JAX rollouts draw
other random numbers, so their tokens differ by design and these stages
are not held to the JAX CLI.  The rollouts keep their KV cache in f32 on
both sides (``torch_mesh_worker.f32_cache``): at tp 2 the decode's
row-parallel sums round otherwise than one process's, and a bf16 cache
can turn that into a 2^-8 difference, which moved one of GKD's draws over
the whole vocabulary (row 2's last token, 427 against 594).

Each stage runs with a reward that varies with the completion's length
(``torch_mesh_worker.length_reward``), at fsdp 2 or at tp 2 in the fast
tier, the meshes alternating, and at the other under ``slow``.  PPO also
runs minibatches of 1 at fsdp 2, which the 2 batch ranks do not divide:
the JAX CLI runs that mesh and minibatch (its jitted update takes the
whole minibatch on every device), and so does the port, each rank taking
the whole minibatch and half of its loss.  Nash-MD and GKD are in
tests/test_torch_pref_mesh_nash_gkd.py, the fused CE in
tests/test_torch_fused_ce_mesh.py (each file kept short for tier-1).
"""

import pytest

from helpers import build_tiny_vlm_checkpoint
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    FSDP2,
    check_rollout_stage,
    f32_port,
    rollout_cases,
)
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def vlm_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("vlm")))


@pytest.mark.parametrize("stage,mesh,ppo", rollout_cases(
    ("ppo", "rloo", "online_dpo", "xpo")) + [
        pytest.param("ppo", FSDP2, {"mini_batch_size": 1},
                     id="ppo-fsdp2-minibatch1")])
def test_rollout_stage_on_a_mesh_matches_one_process(
        stage, mesh, ppo, vlm_checkpoint, f32_port, monkeypatch, tmp_path):
    check_rollout_stage(stage, mesh, ppo, vlm_checkpoint, None, monkeypatch,
                        tmp_path)
