"""CLIP ViT vision tower (ViT-L/14-336 class), the tower of LLaVA-1.5 and
LLaVA-NeXT (counterpart of iadr1_tpu/models/clip_vit.py).

HF ``CLIPVisionModel`` semantics: a patch embedding without bias (a
strided convolution, here a dense layer over patchified tiles), a CLS
token in front, learned position embeddings, a pre-layernorm before the
encoder, pre-norm encoder layers with biased q/k/v/o projections and
QuickGELU MLPs.  LLaVA reads an intermediate layer (``vision_feature_layer``,
typically -2) without the post-layernorm and drops the CLS token
(strategy "default"): here, by running only the first ``num_layers``
layers.

Each tile (336 px: 24 x 24 = 576 patches + CLS = 577 tokens) attends only
to itself, non-causal, at head dim 1024 / 16 = 64.  The tiles are the
attention's batch; ``tile_segments`` gives each tile one segment id, 0 for
the zero tiles that pad the tile stream to its budget, so the kernels skip
those tiles (their features are 0 after the attention and are dropped by
the scatter).  The JAX tower attends densely over every tile, padding
included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, siglip
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import unstack_layers
from iadr1_tpu_torch.models.qwen2_vl import layer_norm, quick_gelu


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size ** 2


def init_params(gen, cfg: ClipVisionConfig, dtype, device) -> dict:
    L, E, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size

    def stack(i, o):
        return torch.stack([common.dense_init(gen, i, o, dtype, device)
                            for _ in range(L)])

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm(shape):
        return {"scale": full(shape, 1.0), "bias": full(shape, 0.0)}

    def proj(i, o):
        return {"kernel": stack(i, o), "bias": full((L, o), 0.0)}

    cls = torch.empty((E,), dtype=torch.float32, device=device)
    cls.normal_(generator=gen)
    return {
        "class_embed": cls.to(dtype),
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device)},
        "pos_embed": common.embed_init(gen, cfg.num_patches + 1, E, dtype,
                                       device),
        "pre_norm": norm((E,)),
        "layers": {
            "norm1": norm((L, E)),
            "norm2": norm((L, E)),
            "attn": {name: proj(E, E) for name in "qkvo"},
            "mlp": {"fc1": proj(E, I), "fc2": proj(I, E)},
        },
        "post_norm": norm((E,)),
    }


def convert_hf(state, cfg: ClipVisionConfig,
               prefix: str = "vision_tower.vision_model.",
               dtype=torch.float32, device=None) -> dict:
    """HF CLIP vision tensors (name -> array) under ``prefix`` -> the
    tower's parameter dict."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    lt = prefix + "encoder.layers.{i}."

    def stacked(name, transpose=False):
        return _stack_layers(state, lt + name, cfg.num_hidden_layers,
                             transpose, **kw)

    def linear(name):
        return {"kernel": stacked(name + ".weight", True),
                "bias": stacked(name + ".bias")}

    def norm(name):
        return {"scale": stacked(name + ".weight"),
                "bias": stacked(name + ".bias")}

    def top_norm(name):
        return {"scale": _get(state, prefix + name + ".weight", **kw),
                "bias": _get(state, prefix + name + ".bias", **kw)}

    pe = _get(state, prefix + "embeddings.patch_embedding.weight", **kw)
    return {
        "class_embed": _get(state, prefix + "embeddings.class_embedding",
                            **kw),
        # the convolution [E, C, ps, ps] with stride = kernel is a dense
        # layer over patches laid out channel first (anyres.patchify_tiles)
        "patch_embed": {"kernel": pe.reshape(pe.shape[0], -1).T.contiguous()},
        "pos_embed": _get(state,
                          prefix + "embeddings.position_embedding.weight",
                          **kw),
        # HF's spelling
        "pre_norm": top_norm("pre_layrnorm"),
        "layers": {
            "norm1": norm("layer_norm1"),
            "norm2": norm("layer_norm2"),
            "attn": {"q": linear("self_attn.q_proj"),
                     "k": linear("self_attn.k_proj"),
                     "v": linear("self_attn.v_proj"),
                     "o": linear("self_attn.out_proj")},
            "mlp": {"fc1": linear("mlp.fc1"), "fc2": linear("mlp.fc2")},
        },
        "post_norm": top_norm("post_layernorm"),
    }


def apply(params: dict, cfg: ClipVisionConfig,
          tiles: torch.Tensor,              # [N, num_patches, patch_dim]
          precision: Precision = DEFAULT_PRECISION,
          remat=False, num_layers: int | None = None,
          keep_cls: bool = False,
          attention_fn: Callable | None = None,
          tile_segments: torch.Tensor | None = None) -> torch.Tensor:
    """Tile batch -> features [N, num_patches (+1 with ``keep_cls``),
    hidden]: the hidden state after ``num_layers`` layers (all when None),
    with no post-layernorm.

    ``attention_fn`` has the model-level signature (q, k, v, *, mask,
    q_segments, kv_segments, causal), q [N, T, H, D]; it is called once per
    layer over all tiles, each tile its own sequence, non-causal, with
    ``tile_segments`` (``siglip.tile_attention``).  None: the dense oracle
    over every tile.

    ``remat``: the modes of ``siglip.apply``, whose encoder layers the
    tower shares (with QuickGELU): no attention call sits inside a
    checkpoint but under "full"."""
    N = tiles.shape[0]
    H, D, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    h = dense(tiles.to(precision.compute_dtype),
              params["patch_embed"]["kernel"])
    cls = params["class_embed"].to(h.dtype)[None, None, :].expand(
        N, 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1)
    h = h + params["pos_embed"][None].to(h.dtype)
    pre = params["pre_norm"]
    h = layer_norm(h, pre["scale"], pre["bias"], eps)
    attn = siglip.tile_attention(attention_fn, tile_segments, N, h.shape[1])
    layers = unstack_layers(params["layers"], cfg.num_hidden_layers)
    h = siglip.run_layers(layers[:num_layers], h, attn, H, D, eps, remat,
                          act=quick_gelu)
    return h if keep_cls else h[:, 1:]


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: ClipVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``logical_axes``)."""
    def norm():
        return {"scale": (None, "norm"), "bias": (None, "norm")}

    def proj(out):
        return {"kernel": (None, "embed", out), "bias": (None, out)}

    return {
        "class_embed": ("norm",),
        "patch_embed": {"kernel": ("patch", "embed")},
        "pos_embed": (None, "embed"),
        "pre_norm": {"scale": ("norm",), "bias": ("norm",)},
        "layers": {
            "norm1": norm(),
            "norm2": norm(),
            "attn": {
                "q": proj("heads"), "k": proj("heads"), "v": proj("heads"),
                "o": {"kernel": (None, "heads", "embed"),
                      "bias": (None, "norm")},
            },
            "mlp": {
                "fc1": proj("mlp"),
                "fc2": {"kernel": (None, "mlp", "embed"),
                        "bias": (None, "norm")},
            },
        },
        "post_norm": {"scale": ("norm",), "bias": ("norm",)},
    }
