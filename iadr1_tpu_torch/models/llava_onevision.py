"""LLaVA-OneVision: SigLIP tower + two-layer projector + Qwen2 decoder,
with anyres feature packing and newline embeddings (counterpart of
iadr1_tpu/models/llava_onevision.py).

HF ``LlavaOnevisionForConditionalGeneration`` semantics (the reference's
LLaVA-OneVision-SI-0.5B/7B, template llava_next_qwen).  The features are
the tower's last layer before its post-layernorm (select strategy
"full"), projected to the text width, then packed by the host-planned
weighted gather of ``vision/anyres.py`` (base tile, unpadded spatial grid,
a newline vector after each row, anyres_max_9), and scattered onto the
image tokens.  Positions are 1-D (no M-RoPE).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, qwen2, siglip
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get
from iadr1_tpu_torch.models.qwen2_vl import merge_image_features


@dataclasses.dataclass(frozen=True)
class LlavaOnevisionConfig:
    text: qwen2.Qwen2Config
    vision: siglip.SiglipVisionConfig
    image_token_id: int = 151646
    image_grid_pinpoints: tuple = ()
    vision_aspect_ratio: str = "anyres_max_9"
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = "full"

    @property
    def max_tiles(self) -> int:
        return int(self.vision_aspect_ratio.removeprefix("anyres_max_"))


def init_params(gen, cfg: LlavaOnevisionConfig, dtype, device) -> dict:
    hid, E = cfg.text.hidden_size, cfg.vision.hidden_size
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": siglip.init_params(gen, cfg.vision, dtype, device),
        "projector": {
            "fc1": {"kernel": common.dense_init(gen, E, hid, dtype, device),
                    "bias": zeros(hid)},
            "fc2": {"kernel": common.dense_init(gen, hid, hid, dtype,
                                                device),
                    "bias": zeros(hid)},
        },
        "image_newline": zeros(hid),
    }


def convert_hf(state, cfg: LlavaOnevisionConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF LLaVA-OneVision state dict (name -> array), in either key layout
    (``model.language_model.*`` of newer transformers, or
    ``language_model.model.*``) -> parameter dict."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    device = resolve_device(device)
    if any(k.startswith("model.language_model.") for k in state):
        lm, vt = "model.language_model.", "model.vision_tower.vision_model."
        proj, newline = "model.multi_modal_projector.", "model.image_newline"
    else:
        lm, vt = "language_model.model.", "vision_tower.vision_model."
        proj, newline = "multi_modal_projector.", "image_newline"
    kw = dict(dtype=dtype, device=device)

    def linear(name):
        return {"kernel": _get(state, proj + name + ".weight", True, **kw),
                "bias": _get(state, proj + name + ".bias", **kw)}

    return {
        "text": convert_qwen2(state, cfg.text, prefix=lm, **kw),
        "vision": siglip.convert_hf(state, cfg.vision, prefix=vt, **kw),
        "projector": {"fc1": linear("linear_1"), "fc2": linear("linear_2")},
        "image_newline": _get(state, newline, **kw),
    }


def project_and_pack(params: dict, tile_features: torch.Tensor,
                     pack_src: torch.Tensor, pack_weights: torch.Tensor,
                     newline_mask: torch.Tensor) -> torch.Tensor:
    """Projector (exact-erf gelu between its two layers), the anyres plan's
    weighted gather over the flattened tile features ([F, 4] sources and
    weights) and the newline rows -> [F, hid]."""
    p = params["projector"]
    h = dense(tile_features, p["fc1"]["kernel"], p["fc1"]["bias"])
    h = dense(F.gelu(h), p["fc2"]["kernel"], p["fc2"]["bias"])
    flat = h.reshape(-1, h.shape[-1])
    gathered = (flat[pack_src.long()]
                * pack_weights[..., None].to(flat.dtype)).sum(1)
    newline = params["image_newline"].to(gathered.dtype)
    return torch.where(newline_mask.bool()[:, None], newline[None, :],
                       gathered)


def compute_embeds(params, cfg: LlavaOnevisionConfig, input_ids, *,
                   tiles=None, tile_segments=None, pack_src=None,
                   pack_weights=None, newline_mask=None, scatter_rows=None,
                   scatter_cols=None,
                   precision: Precision = DEFAULT_PRECISION,
                   tower_attention_fn: Callable | None = None,
                   tower_remat=False):
    """Token embeddings with the packed image features scattered onto the
    image tokens (features for padding target the dropped row B); the
    tower skips the padding tiles (``tile_segments`` 0)."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    if tiles is not None:
        feats = siglip.apply(params["vision"], cfg.vision, tiles,
                             precision=precision, remat=tower_remat,
                             post_layernorm=False,
                             attention_fn=tower_attention_fn,
                             tile_segments=tile_segments)
        packed = project_and_pack(params, feats, pack_src, pack_weights,
                                  newline_mask)
        embeds = merge_image_features(embeds, packed, scatter_rows,
                                      scatter_cols)
    return embeds


def apply(params: dict, cfg: LlavaOnevisionConfig,
          input_ids: torch.Tensor,             # [B, T]
          position_ids: torch.Tensor,          # [B, T]
          *, tiles=None, tile_segments=None, pack_src=None,
          pack_weights=None, newline_mask=None, scatter_rows=None,
          scatter_cols=None, segment_ids=None, cache: dict | None = None,
          cache_mode: str = "extend",
          precision: Precision = DEFAULT_PRECISION,
          attention_fn: Callable | None = None,
          decode_attention_fn: Callable | None = None,
          tower_attention_fn: Callable | None = None,
          remat=False, tower_remat=None, lora: dict | None = None,
          lora_scale: float = 1.0):
    """Full forward -> (hidden [B, T, hid], cache).  ``remat`` is the
    decoder's mode; ``tower_remat`` the tower's, following ``remat`` when
    None, as in the JAX apply.  ``lora`` is the decoder's adapter tree
    (the "text" subtree of a whole-model one); the tower takes none."""
    embeds = compute_embeds(
        params, cfg, input_ids, tiles=tiles, tile_segments=tile_segments,
        pack_src=pack_src, pack_weights=pack_weights,
        newline_mask=newline_mask, scatter_rows=scatter_rows,
        scatter_cols=scatter_cols, precision=precision, tower_attention_fn=tower_attention_fn,
        tower_remat=remat if tower_remat is None else tower_remat)
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids, segment_ids=segment_ids, cache=cache,
        cache_mode=cache_mode, precision=precision, attention_fn=attention_fn,
        decode_attention_fn=decode_attention_fn, remat=remat, lora=lora,
        lora_scale=lora_scale)


def logits(params, cfg: LlavaOnevisionConfig, hidden,
           precision: Precision = DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: LlavaOnevisionConfig) -> dict:
    return {
        "text": qwen2.logical_axes(cfg.text),
        "vision": siglip.logical_axes(cfg.vision),
        "projector": {
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
        "image_newline": ("norm",),
    }
