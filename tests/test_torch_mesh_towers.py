"""The vision towers on a mesh, gathered a block at a time: real Gloo runs
on the CPU (tests/torch_mesh_worker.py; two spawned jobs of 2 and 4
processes, ``torch_mesh_runs.MeshJobs``, started with the module and
running beside the one-process reference):

* ``compute_view`` of every family's whole tree at fsdp = 2
  (tests/test_torch_mesh.py's tiny configs) leaves each tower stack
  (``core/mesh.py`` TOWER_LAYERS) as its sharded DTensors and gathers
  every other leaf;
* LLaVA-OneVision's SFT CLI (the SigLIP tower) at fsdp = 2 and at (dp,
  fsdp, tp) = (1, 2, 2): the logged loss, accuracy, label count and
  gradient norm within ``LOSS_RTOL`` of the one-process port run in f32,
  the parameters after 2 steps within ``PARAM_ATOL``, and the tower
  gathered a block at a time inside its checkpoints, no gather larger
  than one block's leaves;
* the Qwen2-VL and SigLIP towers alone at the same two meshes, in bf16,
  under remat "save_acts" against remat off: bitwise the same output and
  gradients, and no earlier block's dense weights alive when a block
  starts (with remat off, autograd keeps them).

Qwen2-VL's tower on the same two meshes is tests/test_torch_distributed.py's
(its SFT jobs).
"""

import os

import pytest
import torch

from helpers import build_iad_sft_dataset
from iadr1_tpu_torch.models import registry
from test_torch_llava_onevision import build_tiny_llava_ov_checkpoint
from test_torch_mesh import FAMILIES
from torch_mesh_runs import (
    LOSS_RTOL,
    MeshJobs,
    _assert_logs_close,
    _assert_params_close,
    _final_params,
    _log,
    _port_one_process,
    cli_job,
)
import torch_threads  # noqa: F401  (one intra-op thread)

# the families with a vision tower
TOWER_FAMILIES = [f for f in FAMILIES if f not in ("qwen2", "qwen2_moe")]
SFT_MESHES = {"fsdp2": {"dp": 1, "fsdp": 2, "tp": 1},
              "fsdp2_tp2": {"dp": 1, "fsdp": 2, "tp": 2}}
SFT_KEYS = ("loss", "accuracy", "n_label_tokens", "grad_norm")
# the tower's 2 layers, each read in 2 checkpointed pieces (the q/k/v
# projections', then the o-projection's and the MLP's), in the forward and
# again in the replay; 2 steps
TOWER_GATHERS = 2 * 2 * 2 * 2
# the towers run alone under each remat mode (torch_mesh_worker's
# ``case_tower_remat``)
REMAT_FAMILIES = ("qwen2_vl", "llava_onevision")


def _sft_cfg(ckpt, data, out_dir):
    return {"model": {"model_name_or_path": ckpt},
            "data": {"dataset": data[0], "image_dir": data[1],
                     "template": registry.bundle_from_pretrained(
                         ckpt).template,
                     "cutoff_len": 384, "patch_budget": 1024,
                     "min_pixels": 56 * 56, "max_pixels": 56 * 56 * 4},
            "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1,
                      "save_steps": 0}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The OneVision checkpoint, the dataset and the mesh runs."""
    root = tmp_path_factory.mktemp("towers")
    ckpt = build_tiny_llava_ov_checkpoint(str(root / "ov"))
    data = build_iad_sft_dataset(root / "data")

    def sft(mesh_id):
        return cli_job(f"sft_{mesh_id}", "train_sft", SFT_MESHES[mesh_id],
                       _sft_cfg(ckpt, data, root / f"sft_{mesh_id}_out"),
                       root)

    def remat(mesh_id):
        m = SFT_MESHES[mesh_id]
        return {"name": f"remat_{mesh_id}", "case": "tower_remat",
                "args": {"mesh": [m["dp"], m["fsdp"], m["tp"]],
                         "families": {f: FAMILIES[f]
                                      for f in REMAT_FAMILIES}}}

    views = {"name": "views", "case": "tower_views",
             "args": {"mesh": [1, 2, 1],
                      "families": {f: FAMILIES[f] for f in TOWER_FAMILIES}}}
    jobs = MeshJobs(root, [(2, [views, remat("fsdp2"), sft("fsdp2")]),
                           (4, [remat("fsdp2_tp2"), sft("fsdp2_tp2")])])
    yield {"ckpt": ckpt, "data": data, "jobs": jobs, "root": root}
    jobs.close()


@pytest.mark.parametrize("family", TOWER_FAMILIES)
def test_compute_view_leaves_every_tower_stack_sharded(family, runs):
    want = (["vision/blocks"] if family.startswith("qwen2")
            else ["vision/layers", "video_tower/layers"]
            if family == "video_llava" else ["vision/layers"])
    for r in runs["jobs"].result("views"):
        got = r[family]
        assert got["stacks"] == want
        assert got["sharded"] and got["gathered"]


@pytest.fixture(scope="module")
def one_process(runs, tmp_path_factory):
    """The one-process run of the OneVision SFT, once for both meshes, in
    f32 as the ranks compute (``torch_mesh_runs.f32_port``'s patch, held
    for the module's one run)."""
    import functools

    from iadr1_tpu_torch.core.precision import FULL_PRECISION

    out = tmp_path_factory.mktemp("one")
    mp = pytest.MonkeyPatch()
    for name in ("bundle_from_hf_config", "bundle_from_pretrained"):
        mp.setattr(registry, name, functools.partial(
            getattr(registry, name), precision=FULL_PRECISION))
    try:
        log = _port_one_process("train_sft", _sft_cfg(
            runs["ckpt"], runs["data"], out / "run"), out / "one.json")
    finally:
        mp.undo()
    return log, out / "run"


@pytest.mark.parametrize("mesh_id", list(SFT_MESHES))
def test_onevision_sft_on_a_mesh_gathers_its_tower_a_block_at_a_time(
        mesh_id, runs, one_process):
    one, one_dir = one_process
    ranks = runs["jobs"].result(f"sft_{mesh_id}")
    out = runs["root"] / f"sft_{mesh_id}_out"
    got = _log(out)
    _assert_logs_close(got, one, SFT_KEYS, LOSS_RTOL)
    assert got[-1]["loss"] != got[0]["loss"]
    _assert_params_close(_final_params(out), _final_params(one_dir))
    for r in ranks:
        assert r["mesh"] == SFT_MESHES[mesh_id]
        towers = r["tower_gathers"]
        assert towers["calls"] == TOWER_GATHERS
        assert 0 < towers["largest"] <= towers["block"]
        assert towers["held"] == 0


@pytest.mark.parametrize("mesh_id", list(SFT_MESHES))
@pytest.mark.parametrize("family", REMAT_FAMILIES)
def test_save_acts_keeps_no_block_s_gathered_weights_for_the_backward(
        family, mesh_id, runs):
    """Under "save_acts" a block's dense layers' weights are gathered for
    its forward and again for its backward (``core/mesh.py``
    ``view_gathered_again``): when a block starts, nothing an earlier
    block's dense layers read (each kernel cast to bf16, as the layer
    casts it) is alive, where with remat off autograd keeps them; the
    tower's output and every gradient are bitwise those of remat off."""
    for r in runs["jobs"].result(f"remat_{mesh_id}"):
        acts, plain = r[family]["save_acts"], r[family]["False"]
        assert acts["held"] == 0 and acts["calls"] > 0
        assert plain["held"] > 0
    towers = torch.load(os.path.join(runs["jobs"].out(f"remat_{mesh_id}"),
                                     "towers.pt"))[family]
    for a, b in zip(towers["save_acts"], towers["False"], strict=True):
        assert torch.equal(a, b)
