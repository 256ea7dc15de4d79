"""The port's Qwen2-VL (tower, scatter, decoder) against the JAX package on
the tiny HF checkpoint of tests/helpers.py, in f32.

Both bundles load the same safetensors and run FULL_PRECISION; the port's
attention is the K1 twin, the JAX side's the XLA oracle.  Tolerance atol
1e-4 on tower features and logits (f32; summation order only).  Padding
patches and padding tokens attend no key and are excluded (twin 0, oracle
uniform).  The host precomputes (patchify, rotary tables, segments,
scatter indices, M-RoPE grids) are the port's own copies and must equal
the JAX package's exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import build_tiny_vlm_checkpoint
from iadr1_tpu.core.precision import FULL_PRECISION as JAX_FULL
from iadr1_tpu.models import qwen2_vl as jvl
from iadr1_tpu.models.params_io import load_safetensors_path as jax_load
from iadr1_tpu.models.registry import bundle_from_hf_config as jax_bundle
from iadr1_tpu.vision.mrope import get_mrope_positions as jax_mrope
from iadr1_tpu_torch.core.precision import FULL_PRECISION
from iadr1_tpu_torch.models import qwen2_vl as tvl
from iadr1_tpu_torch.models.attention import default_attention
from iadr1_tpu_torch.models.params_io import (
    load_safetensors_path,
    params_from_jax,
)
from iadr1_tpu_torch.models.registry import bundle_from_hf_config
from iadr1_tpu_torch.vision.mrope import get_mrope_positions
from iadr1_tpu_torch.vision.preprocess import patchify_image
import torch_threads  # noqa: F401  (one intra-op thread)

ATOL = 1e-4
IMAGES = [(56, 84), (84, 112)]         # pixels: 24 and 48 patches


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = build_tiny_vlm_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    jb = jax_bundle(hf, attention="xla", precision=JAX_FULL)
    tb = bundle_from_hf_config(hf, precision=FULL_PRECISION)
    state = load_safetensors_path(path)
    return hf, jb, jb.convert_hf(jax_load(path)), tb, tb.convert_hf(
        state, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_convert_hf_equals_jax_convert_then_params_from_jax(tiny):
    _, _, jparams, _, tparams = tiny
    want = dict(_leaves(params_from_jax(jparams, device="cpu")))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name]), name


def _batch(hf, jb, seed=0, pad=3):
    """Two left-padded prompts with one image each (two sizes), as the
    host builds them; returns numpy arrays and the real-patch count."""
    rng = np.random.default_rng(seed)
    ids_cfg = dict(img=hf["image_token_id"], vs=hf["vision_start_token_id"],
                   ve=hf["vision_end_token_id"])
    patches, grids, prompts = [], [], []
    for i, (h, w) in enumerate(IMAGES):
        flat, grid = patchify_image(rng.random((h, w, 3), dtype=np.float32))
        patches.append(flat)
        grids.append(grid)
        n = int(np.prod(grid)) // 4
        text = rng.integers(10, 300, 5 + 2 * i).tolist()
        prompts.append(text[:2] + [ids_cfg["vs"]] + [ids_cfg["img"]] * n
                       + [ids_cfg["ve"]] + text[2:])
    T = max(map(len, prompts)) + pad
    ids = np.zeros((2, T), np.int64)
    mask = np.zeros((2, T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):], mask[b, T - len(p):] = p, 1
    budget = sum(p.shape[0] for p in patches) + 8
    return ids, mask, patches, grids, budget


def test_host_precomputes_equal_jax(tiny):
    hf, jb, _, tb, _ = tiny
    ids, mask, patches, grids, budget = _batch(hf, jb)
    want = jb.vision_arrays(ids, patches, grids, budget)
    got = tb.vision_arrays(ids, patches, grids, budget)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    grid_thw = np.asarray(grids)
    args = (ids, grid_thw, hf["image_token_id"], hf["vision_start_token_id"])
    for a, b in zip(get_mrope_positions(*args, attention_mask=mask),
                    jax_mrope(*args, attention_mask=mask)):
        np.testing.assert_array_equal(a, b)


def test_tower_matches_jax(tiny):
    hf, jb, jparams, tb, tparams = tiny
    ids, _, patches, grids, budget = _batch(hf, jb)
    arrays = jb.vision_arrays(ids, patches, grids, budget)
    want = jvl.apply_vision(
        jparams["vision"], jb.cfg.vision,
        *(jnp.asarray(arrays[k]) for k in ("patches", "rot_cos", "rot_sin",
                                           "vision_segments")),
        precision=JAX_FULL)
    got = tvl.apply_vision(
        tparams["vision"], tb.cfg.vision,
        *(torch.as_tensor(arrays[k]) for k in ("patches", "rot_cos",
                                               "rot_sin", "vision_segments")),
        precision=FULL_PRECISION, attention_fn=default_attention())
    n_real = sum(p.shape[0] for p in patches) // 4
    np.testing.assert_allclose(got.numpy()[:n_real], np.asarray(want)[:n_real],
                               atol=ATOL, rtol=0)


def test_full_apply_matches_jax(tiny):
    hf, jb, jparams, tb, tparams = tiny
    ids, mask, patches, grids, budget = _batch(hf, jb, seed=1)
    pos, _ = get_mrope_positions(ids, np.asarray(grids), hf["image_token_id"],
                                 hf["vision_start_token_id"],
                                 attention_mask=mask)
    batch = {"input_ids": ids, "position_ids": pos, "segment_ids": mask,
             **tb.vision_arrays(ids, patches, grids, budget)}
    jh, _ = jb.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(jb.logits_fn(jparams, jh))
    th, _ = tb.apply(tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    got = tb.logits_fn(tparams, th).numpy()
    rows = mask.astype(bool)
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=0)
