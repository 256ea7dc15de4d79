"""The preference launcher's Nash-MD and GKD on a mesh, the two stages
that read a second model in their rollouts or their loss, on 2 Gloo
processes (tests/torch_mesh_worker.py), each held to the same launcher's
one-process run by ``torch_mesh_runs.check_rollout_stage`` as
tests/test_torch_pref_mesh_rollout.py holds the others: completions token
for token, metrics within ``LOSS_RTOL``, parameters within
``PARAM_ATOL``, fast at one mesh and ``slow`` at the other.  Nash-MD rolls
out the policy and the geometric mixture of the policy and the reference,
each from its rank's copy (under the tp group at tp 2).  GKD runs a
dataset step and an on-policy step (lmbda 1/2 under seed 0) against a
teacher of another seed, loaded sharded.
"""

import pytest
import torch

from helpers import build_tiny_vlm_checkpoint
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    check_rollout_stage,
    f32_port,
    rollout_cases,
)
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def vlm_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("vlm")))


@pytest.fixture(scope="module")
def teacher_dir(vlm_checkpoint, tmp_path_factory):
    """GKD's teacher: the tiny checkpoint's config (so its vocabulary)
    with weights drawn from another seed."""
    from transformers import (
        AutoTokenizer,
        Qwen2VLConfig,
        Qwen2VLForConditionalGeneration,
    )

    path = str(tmp_path_factory.mktemp("teacher"))
    torch.manual_seed(1)
    Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_pretrained(
        vlm_checkpoint)).save_pretrained(path)
    AutoTokenizer.from_pretrained(vlm_checkpoint).save_pretrained(path)
    return path


@pytest.mark.parametrize("stage,mesh,ppo", rollout_cases(("nash_md", "gkd")))
def test_rollout_stage_on_a_mesh_matches_one_process(
        stage, mesh, ppo, vlm_checkpoint, teacher_dir, f32_port, monkeypatch,
        tmp_path):
    check_rollout_stage(stage, mesh, ppo, vlm_checkpoint, teacher_dir,
                        monkeypatch, tmp_path)
