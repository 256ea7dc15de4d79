"""The SFT CLI's fused CE on a mesh (``cli/train_sft.py``, its step made
by ``make_chunked_sft_step(fused_ce=True)``: ``torch_mesh_worker.fused_ce``)
on 2 Gloo processes (tests/torch_mesh_worker.py) with the tiny Qwen2-VL
and images: at tp 2 (fast; the vocabulary-sharded head's logsumexp,
target logit and argmax reduced over tp inside the loop) and at fsdp 2
(slow),
the loss, accuracy, label count and grad norm within ``LOSS_RTOL`` and
the parameters after 2 steps within ``PARAM_ATOL`` of the chunked CE on
the same mesh and of the fused CE in one process
(tests/torch_mesh_runs.py).
"""

import json

import numpy as np
import pytest
import torch

from helpers import build_iad_sft_dataset, build_tiny_vlm_checkpoint
from iadr1_tpu_torch.core.tensor_parallel import (
    rank_ordered_sum,
    run_sequential_ranks,
)
from iadr1_tpu_torch.data.tokenize import IGNORE_INDEX
from iadr1_tpu_torch.train.sft import _fused_ce
from torch_mesh_runs import (  # noqa: F401  (f32_port is a fixture)
    FSDP2,
    LOSS_RTOL,
    TP2,
    _assert_logs_close,
    _assert_params_close,
    _final_params,
    _log,
    _port_on_mesh,
    f32_port,
    run_ranks,
)
import torch_mesh_worker
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def vlm_checkpoint(tmp_path_factory):
    return build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("vlm")))


def _sft_cfg(ckpt, data, img_dir, out_dir):
    return {"model": {"model_name_or_path": ckpt},
            "data": {"dataset": data, "image_dir": img_dir,
                     "template": "qwen2_vl", "cutoff_len": 128,
                     "patch_budget": 64, "min_pixels": 56 * 56,
                     "max_pixels": 56 * 56 * 4, "ce_chunk": 48},
            "optim": {"learning_rate": 1e-4, "warmup_ratio": 0.0,
                      "total_steps": 4},
            "train": {"output_dir": str(out_dir), "max_steps": 2,
                      "batch_size": 4, "logging_steps": 1, "save_steps": 0}}


@pytest.mark.parametrize("mesh", [
    pytest.param(TP2, id="tp2"),
    pytest.param(FSDP2, id="fsdp2", marks=pytest.mark.slow)])
def test_fused_ce_on_a_mesh_matches_the_chunked_ce_and_one_process(
        mesh, vlm_checkpoint, f32_port, tmp_path, monkeypatch):
    """The chunks (48 rows) do not divide a rank's 2 x 127 predicting
    positions, so the last chunk is padded."""
    from iadr1_tpu_torch.cli import train_sft

    data, img_dir = build_iad_sft_dataset(tmp_path)

    def cfg(side):
        return _sft_cfg(vlm_checkpoint, data, img_dir, tmp_path / side)

    fused_ranks, fused = _port_on_mesh("train_sft", mesh, cfg("fused"),
                                       tmp_path, "fused",
                                       fused_ce=True)
    _, chunked = _port_on_mesh("train_sft", mesh, cfg("chunked"), tmp_path,
                               "chunked")
    path = tmp_path / "one.json"
    path.write_text(json.dumps(cfg("one")))
    torch_mesh_worker.fused_ce(monkeypatch.setattr)
    assert train_sft.main(["--config", str(path), "--device", "cpu"]) == 0
    one = _log(tmp_path / "one")
    keys = ("loss", "accuracy", "n_label_tokens", "grad_norm")
    _assert_logs_close(fused, chunked, keys, LOSS_RTOL)
    _assert_logs_close(fused, one, keys, LOSS_RTOL)
    assert fused[-1]["loss"] < fused[0]["loss"]
    got = _final_params(tmp_path / "fused")
    _assert_params_close(got, _final_params(tmp_path / "chunked"))
    _assert_params_close(got, _final_params(tmp_path / "one"))
    assert all(r["leaf_kinds"]["state"] == [True] for r in fused_ranks)


# the fused CE's vocabulary-sharded loop on its own: V = 130 columns, which
# 3 ranks do not divide, and chunks of 24 that do not divide 2 x 32 rows
HEAD_CHUNK = 24


def _head_inputs():
    """Rows, a head and labels: a prefix ignored, every other label the
    argmax of the logits that predict it, so that the correct count reads
    the sharded argmax (which lies on either rank's columns)."""
    rng = np.random.default_rng(0)
    B, T, H, V = 2, 33, 16, 130
    hidden = torch.tensor(rng.standard_normal((B, T, H)), dtype=torch.float32)
    kernel = torch.tensor(rng.standard_normal((H, V)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, V, (B, T)))
    top = torch.matmul(hidden[:, :-1], kernel).argmax(-1)
    labels[:, 1::2] = top[:, ::2]
    labels[:, :4] = IGNORE_INDEX
    return hidden, kernel, labels


def _assert_ranks_match_one(ranks, hidden, kernel, labels):
    """Every rank's loss and counts are one rank's loop's over the whole
    head, the ranks' d_hidden parts sum to its d_hidden and their d_W
    columns join to its d_W."""
    loss, correct, n, dh, dk = _fused_ce(hidden, kernel, labels, HEAD_CHUNK,
                                         torch.float32, True)
    assert int(correct) >= 16
    for r in ranks:
        np.testing.assert_allclose(float(r[0]), float(loss), rtol=LOSS_RTOL)
        assert (int(r[1]), int(r[2])) == (int(correct), int(n))
    np.testing.assert_allclose(rank_ordered_sum([r[3] for r in ranks]), dh,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(torch.cat([r[4] for r in ranks], dim=1), dk,
                               rtol=1e-5, atol=1e-7)


def test_the_vocabulary_sharded_fused_ce_on_gloo_equals_one_rank(tmp_path):
    """``_fused_ce`` on 2 Gloo ranks' columns of the head, reduced over
    the mesh's tp group by ``MeshTP`` (its collectives reduce in place)."""
    inputs = _head_inputs()
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    run_ranks("fused_ce", 2, tmp_path / "ranks",
              {"mesh": [1, 1, 2], "inputs": str(path), "chunk": HEAD_CHUNK})
    ranks = [torch.load(tmp_path / "ranks" / f"fused_ce{r}.pt")
             for r in range(2)]
    _assert_ranks_match_one(ranks, *inputs)


@pytest.mark.parametrize("tp", [2, 3])
def test_the_vocabulary_sharded_fused_ce_as_sequential_ranks_equals_one_rank(
        tp):
    """The same loop as ``tp`` ranks one after another in one process
    (``run_sequential_ranks``: the max, sum and min all-reduces in rank
    order), as phase 35e runs it on the card; at tp 3 the last rank holds
    fewer columns."""
    hidden, kernel, labels = _head_inputs()
    V = kernel.shape[1]
    per = -(-V // tp)

    def rank(group):
        lo = group.rank * per
        return _fused_ce(hidden, kernel[:, lo:lo + per], labels, HEAD_CHUNK,
                         torch.float32, True, (group, lo, V))

    _assert_ranks_match_one(run_sequential_ranks(rank, tp), hidden, kernel,
                            labels)
