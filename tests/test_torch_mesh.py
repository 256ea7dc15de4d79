"""The port's mesh tables against the JAX package's, in one process:
``MeshConfig.resolve`` with its errors, the logical-axis rules' placements
against JAX's ``PartitionSpec``s, every family's ``logical_axes`` tree at a
tiny config leaf for leaf (and parallel to the port's parameters), the
kernels' sharding rule over a grid of meshes and shapes against JAX's on
virtual CPU meshes, ``batch_shardings`` on a collated Qwen2-VL batch with
[3, B, T] positions, and the ``detect_distributed_mode`` table (JAX's
TPU-pod "auto" row has no counterpart: the port reads it as a single
process).  The multi-process runs are in tests/test_torch_distributed.py."""

import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from iadr1_tpu.core import distributed as jax_distributed
from iadr1_tpu.core import mesh as jax_mesh
from iadr1_tpu.kernels.flash_attention import _mesh_batch_heads as jax_rule
from iadr1_tpu.models import registry as jax_registry
from iadr1_tpu_torch.core import distributed, mesh
from iadr1_tpu_torch.kernels.flash_attention import (
    mesh_batch_heads,
    shard_slices,
)
from iadr1_tpu_torch.models import registry
from iadr1_tpu_torch.train.state import named_leaves
import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("config,n", [
    ((1, -1, 1), 8), ((2, -1, 2), 8), ((1, 2, 2), 4), ((2, 2, 2), 8),
    ((1, -1, 1), 1), ((-1, 2, 1), 6), ((1, 3, 1), 8), ((-1, -1, 1), 4),
    ((1, -1, 3), 8), ((2, 2, 1), 8)])
def test_mesh_config_resolves_as_jax_with_its_errors(config, n):
    def outcome(cls):
        try:
            return cls(*config).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(mesh.MeshConfig) == outcome(jax_mesh.MeshConfig)


LOGICAL = [(), ("embed",), (None, "embed", "heads"), ("vocab", "embed"),
           (None, "heads", "embed"), ("embed", "mlp"), ("norm",),
           (None, "expert", "embed", None), ("patch", "embed"),
           ("batch", "seq", "embed"), ("fsdp_batch", "seq", "head_dim"),
           ("qkv",), ("kv_heads", None)]


@pytest.mark.parametrize("logical", LOGICAL, ids=str)
def test_the_rules_place_as_jax_partitions(logical):
    spec = tuple(jax_mesh.logical_to_mesh_axes(logical))
    assert mesh.logical_to_spec(logical) == spec
    assert mesh.logical_to_mesh_axes(logical) == mesh.spec_placements(spec)
    with pytest.raises(KeyError, match="no sharding rule"):
        mesh.logical_to_mesh_axes(("no_such_axis",))


def test_placements_name_the_sharded_dim_on_each_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    assert mesh.logical_to_mesh_axes((None, "embed", "heads")) == (
        Replicate(), Shard(1), Shard(2))
    assert mesh.spec_placements(((("dp", "fsdp")), None)) == (
        Shard(0), Shard(0), Replicate())
    assert mesh.DEFAULT_RULES == jax_mesh.DEFAULT_RULES


# tiny configs of every family (the HF layouts both registries read)
TEXT = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=10000.0,
            max_position_embeddings=512)
MROPE = {"type": "mrope", "mrope_section": [4, 2, 2]}
CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=56, patch_size=14,
            hidden_act="quick_gelu", layer_norm_eps=1e-5)
SIGLIP = dict(hidden_size=144, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=56, patch_size=14)
PINPOINTS = [[56, 112], [112, 56], [112, 112]]
LLAMA = dict(TEXT, model_type="llama")
FAMILIES = {
    "qwen2": dict(TEXT, architectures=["Qwen2ForCausalLM"],
                  model_type="qwen2", tie_word_embeddings=False),
    "qwen2_moe": dict(TEXT, architectures=["Qwen2MoeForCausalLM"],
                      model_type="qwen2_moe", num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=48,
                      shared_expert_intermediate_size=80),
    "qwen2_vl": dict(
        architectures=["Qwen2VLForConditionalGeneration"],
        model_type="qwen2_vl", image_token_id=7, video_token_id=8,
        vision_start_token_id=5, vision_end_token_id=6,
        text_config=dict(TEXT, tie_word_embeddings=True, rope_scaling=MROPE),
        vision_config=dict(depth=2, embed_dim=32, hidden_size=64,
                           num_heads=4, patch_size=14, spatial_merge_size=2,
                           temporal_patch_size=2)),
    "qwen2_5_vl": dict(
        architectures=["Qwen2_5_VLForConditionalGeneration"],
        model_type="qwen2_5_vl", image_token_id=7, video_token_id=8,
        vision_start_token_id=5, vision_end_token_id=6,
        text_config=dict(TEXT, rope_scaling=MROPE),
        vision_config=dict(depth=3, hidden_size=64, intermediate_size=96,
                           out_hidden_size=64, num_heads=4, in_channels=3,
                           patch_size=14, spatial_merge_size=2,
                           temporal_patch_size=2, window_size=56,
                           fullatt_block_indexes=[1])),
    "llava": dict(architectures=["LlavaForConditionalGeneration"],
                  model_type="llava", vision_config=CLIP, text_config=LLAMA,
                  image_token_index=6, vision_feature_layer=-2,
                  vision_feature_select_strategy="default"),
    "llava_next": dict(architectures=["LlavaNextForConditionalGeneration"],
                       model_type="llava_next", vision_config=CLIP,
                       text_config=LLAMA, image_token_index=6,
                       image_grid_pinpoints=PINPOINTS,
                       vision_feature_layer=-2,
                       vision_feature_select_strategy="default"),
    "video_llava": dict(
        architectures=["VideoLlavaForConditionalGeneration"],
        model_type="video_llava", vision_config=CLIP, text_config=LLAMA,
        image_token_index=6, video_token_index=7, vision_feature_layer=-2,
        vision_feature_select_strategy="default"),
    "llava_onevision": dict(
        architectures=["LlavaOnevisionForConditionalGeneration"],
        model_type="llava_onevision",
        vision_config=dict(SIGLIP, hidden_act="gelu_pytorch_tanh"),
        text_config=dict(TEXT, model_type="qwen2"), image_token_index=6,
        video_token_index=0, image_grid_pinpoints=PINPOINTS,
        vision_aspect_ratio="anyres_max_9",
        vision_feature_select_strategy="full", vision_feature_layer=-1),
    "internvl": dict(
        architectures=["InternVLForConditionalGeneration"],
        model_type="internvl", image_token_id=6, downsample_ratio=0.5,
        vision_feature_layer=-1, vision_feature_select_strategy="default",
        projector_hidden_act="gelu",
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=[56, 56], patch_size=[14, 14],
                           use_qk_norm=True, norm_type="rms_norm"),
        text_config=dict(TEXT, model_type="qwen2")),
    "paligemma": dict(
        architectures=["PaliGemmaForConditionalGeneration"],
        model_type="paligemma", image_token_index=6, projection_dim=64,
        vision_config=SIGLIP,
        text_config=dict(TEXT, model_type="gemma", head_dim=16)),
    "pixtral": dict(
        architectures=["LlavaForConditionalGeneration"], model_type="llava",
        image_token_index=6, vision_feature_layer=-1,
        vision_feature_select_strategy="full", projector_hidden_act="gelu",
        vision_config=dict(model_type="pixtral", hidden_size=64,
                           intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=64,
                           patch_size=16),
        text_config=dict(TEXT, model_type="mistral", head_dim=16)),
}


def _jax_tree(tree):
    """A JAX logical tree with its tuples as plain tuples."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_has_the_jax_logical_axes(family):
    hf = FAMILIES[family]
    port = registry.bundle_from_hf_config(hf)
    want = _jax_tree(jax_registry.bundle_from_hf_config(hf).logical_axes())
    assert port.logical_axes() == want
    # parallel to the parameters, leaf for leaf, a name a dim
    params = port.init_params(seed=0, dtype=torch.float32, device="cpu")
    leaves = dict(named_leaves(params))
    axes = dict(named_leaves(port.logical_axes()))
    assert leaves.keys() == {k for k in axes if k in leaves}
    for name, t in leaves.items():
        assert len(axes[name]) == t.dim(), name


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                jax_mesh.MESH_AXES)


MESHES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (1, 2, 2),
          (2, 1, 2), (2, 2, 2), (1, 4, 2), (1, 8, 1), (1, 1, 8), (4, 1, 2)]
SHAPES = list(itertools.product((1, 2, 3, 4, 6, 8), (2, 4, 6, 12, 28),
                                (1, 2, 4)))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_the_kernels_rule_is_jax_over_a_grid(shape):
    jm = _jax_mesh(shape)
    sizes = dict(zip(mesh.MESH_AXES, shape))
    for B, H, Hkv in SHAPES:
        if H % Hkv:
            continue
        assert mesh_batch_heads(sizes, B, H, Hkv) == jax_rule(jm, B, H, Hkv)
        slices = shard_slices(sizes, B, H, Hkv)
        # the shards tile the call: every (row, head) once
        covered = np.zeros((B, H), int)
        for b, h, hk in slices:
            covered[b, h] += 1
            assert (hk.stop - hk.start) * H == (h.stop - h.start) * Hkv
        assert (covered == 1).all()


def test_the_rule_keeps_the_gqa_group_whole():
    # tp splits heads only when H and Hkv both divide
    assert mesh_batch_heads({"tp": 2}, 4, 12, 2) == (None, "tp")
    assert mesh_batch_heads({"tp": 4}, 4, 12, 2) == (None, None)
    # batch takes dp then fsdp, each only while it divides
    assert mesh_batch_heads({"dp": 2, "fsdp": 2}, 2, 4, 4) == (("dp",), None)
    assert mesh_batch_heads({"dp": 2, "fsdp": 2}, 3, 4, 4) == (None, None)


def test_batch_shardings_on_a_collated_qwen2_vl_batch():
    """The [3, B, T] M-RoPE positions split dim 1; the vision plans and a
    batch that does not divide replicate, as in JAX."""
    from jax.sharding import PartitionSpec as P

    B, T = 4, 16
    batch = {"input_ids": np.zeros((B, T), np.int32),
             "labels": np.zeros((B, T), np.int32),
             "segment_ids": np.ones((B, T), np.int32),
             "position_ids": np.zeros((3, B, T), np.int32),
             "patches": np.zeros((64, 1176), np.float32),
             "rot_cos": np.zeros((64, 40), np.float32),
             "scatter_rows": np.zeros((16,), np.int32),
             "mrope_deltas": np.zeros((B,), np.int32),
             "odd": np.zeros((3, 5), np.int32)}
    for shape in [(1, 2, 1), (2, 2, 2), (1, 8, 1), (1, 1, 8), (2, 1, 4)]:
        got = mesh.batch_shardings(dict(zip(mesh.MESH_AXES, shape)), batch)
        want = jax_mesh.batch_shardings(_jax_mesh(shape), batch)
        assert got.keys() == want.keys()
        for key, sharding in want.items():
            assert got[key] == mesh.spec_placements(tuple(sharding.spec)), (
                shape, key)
    # B = 4 splits over 2 x 2 but not over 8
    assert jax_mesh.batch_shardings(_jax_mesh((1, 8, 1)), batch)[
        "position_ids"].spec == P()
    assert jax_mesh.batch_shardings(_jax_mesh((2, 2, 2)), batch)[
        "position_ids"].spec == P(None, ("dp", "fsdp"))


ENVS = [
    {},
    {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
     "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"},
    {"COORDINATOR_ADDRESS": "host0:8476", "NUM_PROCESSES": "4",
     "PROCESS_ID": "2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "0"},
    {"COORDINATOR_ADDRESS": "host0:8476", "NUM_PROCESSES": "4"},
    {"TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"TPU_WORKER_HOSTNAMES": "a"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "x"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_detect_distributed_mode_is_jax_s_table(env):
    port = distributed.detect_distributed_mode(env)
    want = jax_distributed.detect_distributed_mode(env)
    if "RANK" in env:
        # torchrun's launch: the JAX package has no such row
        assert want is None
        assert port == ("torchrun", dict(init_method="env://", world_size=4,
                                         rank=1, local_rank=1))
    elif want is None or want[0] == "auto":
        # the TPU-pod auto row has no counterpart: one process
        assert port is None
    else:
        kw = want[1]
        assert port == ("explicit", dict(
            init_method=f"tcp://{kw['coordinator_address']}",
            world_size=kw["num_processes"], rank=kw["process_id"],
            local_rank=kw["process_id"]))


def test_without_a_group_there_is_no_mesh_and_one_batch_rank():
    assert mesh.build_mesh(mesh.MeshConfig()) is None
    assert mesh.kernel_mesh() is None
    assert mesh.batch_coordinate() == (0, 1)
    assert distributed.host_batch_slice(6) == slice(0, 6)
    assert distributed.topology().is_primary
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        mesh.build_mesh(mesh.MeshConfig(1, 2, 2))
    x = torch.arange(4.0)
    assert mesh.batch_total(x) is x and mesh.compute_view({"a": x})["a"] is x
