"""PaliGemma: the SigLIP tower, one linear projector and the Gemma
decoder (the Qwen2 module with its Gemma knobs), counterpart of
iadr1_tpu/models/paligemma.py.

HF ``PaliGemmaForConditionalGeneration`` semantics: the tower's last
hidden state (post-layernorm) goes through one linear projection and is
divided by sqrt(text hidden); the decoder multiplies the merged embeddings
back by the same factor.  The features land on the image-token run that
the processor puts ahead of the text (``data/mm.py prepend_image_tokens``).
The decoder is a prefix LM: in training and scoring (no cache) every query
may attend the image tokens of its segment, in a prefill the whole prompt
block is bidirectional, and decode steps are causal.  Positions are
1-indexed.

The tower's attention is the port's dispatch, K1 on the card, each tile
its own sequence and the zero tiles that pad the stream masked out
(``tile_segments``).  The prefix-LM decoder attention is the dense masked
attention (``qwen2.prefix_lm_attention``) wherever the mask is not causal,
as in the JAX decoder; single-token decode runs K4.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, qwen2, siglip
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get
from iadr1_tpu_torch.models.qwen2_vl import merge_image_features


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    text: qwen2.Qwen2Config
    vision: siglip.SiglipVisionConfig
    image_token_id: int = 257152
    projection_dim: int | None = None     # the text hidden size when None

    @property
    def projection_dim_(self) -> int:
        return self.projection_dim or self.text.hidden_size


def init_params(gen, cfg: PaliGemmaConfig, dtype, device) -> dict:
    E, P = cfg.vision.hidden_size, cfg.projection_dim_
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": siglip.init_params(gen, cfg.vision, dtype, device),
        "projector": {
            "kernel": common.dense_init(gen, E, P, dtype, device),
            "bias": torch.zeros((P,), dtype=dtype, device=device),
        },
    }


def convert_hf(state, cfg: PaliGemmaConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF PaliGemma state dict (name -> array), in either key layout
    (``model.language_model.*`` of newer transformers, or
    ``language_model.model.*``) -> parameter dict."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    device = resolve_device(device)
    top = ("model." if any(k.startswith("model.language_model.")
                           for k in state) else "")
    lm = "model.language_model." if top else "language_model.model."
    proj = f"{top}multi_modal_projector.linear."
    kw = dict(dtype=dtype, device=device)
    return {
        "text": convert_qwen2(state, cfg.text, prefix=lm, **kw),
        "vision": siglip.convert_hf(
            state, cfg.vision, prefix=f"{top}vision_tower.vision_model.",
            **kw),
        "projector": {"kernel": _get(state, proj + "weight", True, **kw),
                      "bias": _get(state, proj + "bias", **kw)},
    }


def compute_embeds(params, cfg: PaliGemmaConfig, input_ids, *, tiles=None,
                   tile_segments=None, scatter_rows=None, scatter_cols=None,
                   precision: Precision = DEFAULT_PRECISION,
                   tower_attention_fn: Callable | None = None,
                   tower_remat=False):
    """Token embeddings with the projected SigLIP features, divided by
    sqrt(text hidden), scattered onto the image tokens (features of the
    padding tiles target the dropped row B)."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    if tiles is not None:
        feats = siglip.apply(params["vision"], cfg.vision, tiles, precision,
                             remat=tower_remat,
                             attention_fn=tower_attention_fn,
                             tile_segments=tile_segments)
        p = params["projector"]
        feats = dense(feats, p["kernel"], p["bias"])
        feats = feats * torch.tensor(cfg.text.hidden_size ** -0.5,
                                     dtype=feats.dtype)
        embeds = merge_image_features(
            embeds, feats.reshape(-1, feats.shape[-1]), scatter_rows,
            scatter_cols)
    return embeds


def apply(params: dict, cfg: PaliGemmaConfig,
          input_ids: torch.Tensor,             # [B, T]
          position_ids: torch.Tensor,          # [B, T], 0-indexed
          *, tiles=None, tile_segments=None, scatter_rows=None,
          scatter_cols=None, segment_ids=None, cache: dict | None = None,
          cache_mode: str = "extend",
          precision: Precision = DEFAULT_PRECISION,
          decode_attention_fn: Callable | None = None,
          tower_attention_fn: Callable | None = None,
          remat=False, tower_remat=None, lora: dict | None = None,
          lora_scale: float = 1.0):
    """Full forward -> (hidden [B, T, hid], cache).  The prefix-LM flags,
    as the JAX apply sets them: with no cache (training, scoring) the
    image-token columns, in a prefill the whole block, none in "decode"
    (K4) or "extend" (the dense causal path over the cache).  The decoder
    takes no flash attention.  ``lora`` is the decoder's
    adapter tree; the tower takes none."""
    embeds = compute_embeds(
        params, cfg, input_ids, tiles=tiles, tile_segments=tile_segments,
        scatter_rows=scatter_rows, scatter_cols=scatter_cols,
        precision=precision, tower_attention_fn=tower_attention_fn,
        tower_remat=remat if tower_remat is None else tower_remat)
    if cache is None:
        bidir = (input_ids == cfg.image_token_id).to(torch.int32)
    elif cache_mode == "prefill":
        bidir = torch.ones(input_ids.shape, dtype=torch.int32,
                           device=input_ids.device)
    else:
        bidir = None
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids + 1, segment_ids=segment_ids,
        bidirectional_mask=bidir, cache=cache, cache_mode=cache_mode,
        precision=precision, decode_attention_fn=decode_attention_fn,
        remat=remat, lora=lora, lora_scale=lora_scale)


def logits(params, cfg: PaliGemmaConfig, hidden,
           precision: Precision = DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: PaliGemmaConfig) -> dict:
    return {
        "text": qwen2.logical_axes(cfg.text),
        "vision": siglip.logical_axes(cfg.vision),
        "projector": {"kernel": ("embed", "mlp"), "bias": ("norm",)},
    }
