"""LLaVA-1.5, LLaVA-NeXT (1.6), LLaVA-NeXT-Video and Video-LLaVA: the
CLIP tower(s), a two-layer projector and a llama-style decoder (the Qwen2
module with ``attention_bias=False``), counterpart of
iadr1_tpu/models/llava.py.

HF ``LlavaForConditionalGeneration`` semantics (one 336 x 336 tile per
image, 576 features: ``vision_feature_layer`` -2, strategy "default" drops
CLS), ``LlavaNextForConditionalGeneration`` (anyres tiles, the unpadded
spatial grid and a newline vector after each row, packed as LLaVA-OneVision
packs them but never downscaled), ``LlavaNextVideoForConditionalGeneration``
(anyres images, and video frames through the same tower, each frame's
feature grid average-pooled at stride 2 before the projector) and
``VideoLlavaForConditionalGeneration`` (separate image and video towers;
a frame keeps its CLS feature).  These are the reference's
LLaVA-1.5-7B/13B and LLaVA-1.6-8B/34B families and the video plugins'.
Positions are 1-D (no M-RoPE).  Frames are the tower's batch like tiles,
``video_tile_segments`` masking the zero frames that pad the frame stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import clip_vit, common, qwen2
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get
from iadr1_tpu_torch.models.qwen2_vl import merge_image_features


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    text: qwen2.Qwen2Config
    vision: clip_vit.ClipVisionConfig
    image_token_id: int = 32000
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"
    # LLaVA-NeXT only
    anyres: bool = False
    image_grid_pinpoints: tuple = ()
    # the video families
    video_token_id: int | None = None
    # LLaVA-NeXT-Video: each frame's feature grid average-pooled at this
    # stride before the projector (LlavaNextVideoPooler); 0: no pooling
    video_pool_stride: int = 0
    # Video-LLaVA: frames keep the CLS feature and run the separate
    # ``video_tower``
    video_keep_cls: bool = False
    separate_video_tower: bool = False

    @property
    def tower_layers(self) -> int:
        """The tower layers that run: ``vision_feature_layer`` -2 reads
        the output of layer L - 1."""
        return self.vision.num_hidden_layers + 1 + self.vision_feature_layer


def init_params(gen, cfg: LlavaConfig, dtype, device) -> dict:
    hid, E = cfg.text.hidden_size, cfg.vision.hidden_size
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    params = {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": clip_vit.init_params(gen, cfg.vision, dtype, device),
        "projector": {
            "fc1": {"kernel": common.dense_init(gen, E, hid, dtype, device),
                    "bias": zeros(hid)},
            "fc2": {"kernel": common.dense_init(gen, hid, hid, dtype,
                                                device),
                    "bias": zeros(hid)},
        },
    }
    if cfg.anyres:
        params["image_newline"] = zeros(hid)
    if cfg.separate_video_tower:
        params["video_tower"] = clip_vit.init_params(gen, cfg.vision, dtype,
                                                     device)
    return params


def convert_hf(state, cfg: LlavaConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF LLaVA / LLaVA-NeXT / LLaVA-NeXT-Video / Video-LLaVA state dict
    (name -> array), in either key layout (``model.language_model.*`` of
    newer transformers, or ``language_model.model.*``) -> parameter dict.
    Video-LLaVA names its towers ``image_tower`` and ``video_tower``."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    device = resolve_device(device)
    tower = "image_tower" if cfg.separate_video_tower else "vision_tower"
    top = ("model." if any(k.startswith("model.language_model.")
                           for k in state) else "")
    lm = "model.language_model." if top else "language_model.model."
    vt, video = (f"{top}{tower}.vision_model.",
                 f"{top}video_tower.vision_model.")
    proj, newline = f"{top}multi_modal_projector.", f"{top}image_newline"
    kw = dict(dtype=dtype, device=device)

    def linear(name):
        return {"kernel": _get(state, proj + name + ".weight", True, **kw),
                "bias": _get(state, proj + name + ".bias", **kw)}

    params = {
        "text": convert_qwen2(state, cfg.text, prefix=lm, **kw),
        "vision": clip_vit.convert_hf(state, cfg.vision, prefix=vt, **kw),
        "projector": {"fc1": linear("linear_1"), "fc2": linear("linear_2")},
    }
    if cfg.anyres:
        params["image_newline"] = _get(state, newline, **kw)
    if cfg.separate_video_tower:
        params["video_tower"] = clip_vit.convert_hf(state, cfg.vision,
                                                    prefix=video, **kw)
    return params


def project(params, feats):
    """The projector: exact (erf) GELU between its two layers."""
    p = params["projector"]
    h = dense(feats, p["fc1"]["kernel"], p["fc1"]["bias"])
    return dense(F.gelu(h), p["fc2"]["kernel"], p["fc2"]["bias"])


def pool_video_features(feats: torch.Tensor, stride: int) -> torch.Tensor:
    """Each frame's spatial average pool (kernel = stride, floor) over a
    [F, g*g, E] feature grid, before the projector (HF
    LlavaNextVideoPooler).  A window's features are summed in reading
    order, then divided by their count: at the published 24 x 24 grid and
    stride 2 that is the JAX package's sum bit for bit."""
    n_frames, n, E = feats.shape
    g = int(round(n ** 0.5))
    g2 = g // stride
    x = feats.reshape(n_frames, g, g, E)[:, :g2 * stride, :g2 * stride]
    x = x.reshape(n_frames, g2, stride, g2, stride, E)
    total = x[:, :, 0, :, 0]
    for i in range(stride):
        for j in range(stride):
            if i or j:
                total = total + x[:, :, i, :, j]
    return (total / (stride * stride)).reshape(n_frames, g2 * g2, E)


def compute_embeds(params, cfg: LlavaConfig, input_ids, *, tiles=None,
                   tile_segments=None, pack_src=None, pack_weights=None,
                   newline_mask=None, scatter_rows=None, scatter_cols=None,
                   video_tiles=None, video_tile_segments=None,
                   video_scatter_rows=None, video_scatter_cols=None,
                   precision: Precision = DEFAULT_PRECISION,
                   tower_attention_fn: Callable | None = None,
                   tower_remat=False):
    """Token embeddings with the image features scattered onto the image
    tokens (features of padding target the dropped row B): one tile per
    image (1.5), or the anyres plan's weighted gather with the newline
    rows (NeXT); then each video's frames through the tower (Video-LLaVA:
    its video tower, CLS kept), pooled (NeXT-Video), projected and
    scattered onto the video tokens."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    tower_kw = dict(precision=precision, remat=tower_remat,
                    num_layers=cfg.tower_layers,
                    attention_fn=tower_attention_fn)
    full = cfg.vision_feature_select_strategy == "full"
    if tiles is not None:
        feats = clip_vit.apply(params["vision"], cfg.vision, tiles,
                               keep_cls=full, tile_segments=tile_segments,
                               **tower_kw)
        feats = project(params, feats)
        flat = feats.reshape(-1, feats.shape[-1])
        if cfg.anyres:
            gathered = (flat[pack_src.long()]
                        * pack_weights[..., None].to(flat.dtype)).sum(1)
            newline = params["image_newline"].to(gathered.dtype)
            flat = torch.where(newline_mask.bool()[:, None],
                               newline[None, :], gathered)
        embeds = merge_image_features(embeds, flat, scatter_rows,
                                      scatter_cols)
    if video_tiles is not None:
        vfeats = clip_vit.apply(params.get("video_tower", params["vision"]),
                                cfg.vision, video_tiles,
                                keep_cls=cfg.video_keep_cls or full,
                                tile_segments=video_tile_segments,
                                **tower_kw)
        if cfg.video_pool_stride > 1:
            vfeats = pool_video_features(vfeats, cfg.video_pool_stride)
        vfeats = project(params, vfeats)
        embeds = merge_image_features(
            embeds, vfeats.reshape(-1, vfeats.shape[-1]),
            video_scatter_rows, video_scatter_cols)
    return embeds


def apply(params: dict, cfg: LlavaConfig,
          input_ids: torch.Tensor,             # [B, T]
          position_ids: torch.Tensor,          # [B, T]
          *, tiles=None, tile_segments=None, pack_src=None,
          pack_weights=None, newline_mask=None, scatter_rows=None,
          scatter_cols=None, video_tiles=None, video_tile_segments=None,
          video_scatter_rows=None, video_scatter_cols=None,
          segment_ids=None, cache: dict | None = None,
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
        scatter_cols=scatter_cols, video_tiles=video_tiles,
        video_tile_segments=video_tile_segments,
        video_scatter_rows=video_scatter_rows,
        video_scatter_cols=video_scatter_cols, precision=precision,
        tower_attention_fn=tower_attention_fn,
        tower_remat=remat if tower_remat is None else tower_remat)
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids, segment_ids=segment_ids, cache=cache,
        cache_mode=cache_mode, precision=precision, attention_fn=attention_fn,
        decode_attention_fn=decode_attention_fn, remat=remat, lora=lora,
        lora_scale=lora_scale)


def logits(params, cfg: LlavaConfig, hidden,
           precision: Precision = DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: LlavaConfig) -> dict:
    axes = {
        "text": qwen2.logical_axes(cfg.text),
        "vision": clip_vit.logical_axes(cfg.vision),
        "projector": {
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
    }
    if cfg.anyres:
        axes["image_newline"] = ("norm",)
    if cfg.separate_video_tower:
        axes["video_tower"] = clip_vit.logical_axes(cfg.vision)
    return axes
