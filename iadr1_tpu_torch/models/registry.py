"""Model bundles (counterpart of iadr1_tpu/models/registry.py) for every
family of the JAX package: Qwen2 and Qwen2-MoE (text), Qwen2-VL and
Qwen2.5-VL (images and videos), LLaVA-OneVision, LLaVA-1.5 / LLaVA-NeXT
(images), LLaVA-NeXT-Video and Video-LLaVA (images and videos), InternVL,
PaliGemma and Pixtral.

A bundle carries the config and the functions the rollout engine, the
generator and the SFT step call: ``apply(params, batch, cache=None,
cache_mode=..., remat=False, lora=None, lora_scale=1.0)``,
``hidden_fn(params, batch, remat=True, lora=..., lora_scale=...)``,
``head_kernel_fn(params)``, ``logits_fn(params, hidden)``,
``shared_pred_fn(params, batch, group_size, remat=True, lora=None,
lora_scale=1.0)`` (GRPO's shared-prompt scoring; None for PaliGemma and
Pixtral, which have none in JAX either: their SC-GRPO update is the dense
one),
``init_params(seed, dtype, device)``,
``convert_hf(state, dtype, device)`` and, for the multimodal families,
the host-side ``vision_arrays`` and ``preprocess_image`` (and, for the
LLaVA video families, ``preprocess_video``).  ``lora`` is an
adapter tree parallel to the parameters (``train/adapters.py``); the VLM
bundles hand its "text" subtree to the decoder, and their towers take no
adapters.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np
import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import (
    clip_vit,
    common,
    internvl,
    llava,
    llava_onevision,
    paligemma,
    pixtral,
    qwen2,
    qwen2_vl,
    qwen25_vl,
    siglip,
)
from iadr1_tpu_torch.models.attention import (
    default_attention,
    default_attention_with_lse,
    default_decode_attention,
    tower_attention,
)
from iadr1_tpu_torch.models.shared_prompt import shared_prompt_pred_hidden


@dataclasses.dataclass
class ModelBundle:
    family: str
    cfg: Any
    multimodal: bool
    # dtype=None stores the parameters in the bundle's precision.param_dtype
    init_params: Callable    # (seed=0, dtype=None, device=None) -> params
    convert_hf: Callable     # (state, dtype=None, device=None) -> params
    apply: Callable   # (params, batch, cache=None, cache_mode=..., remat=...)
    logits_fn: Callable      # (params, hidden) -> logits
    vision_arrays: Callable | None = None
    # (pil_image, min_pixels=..., max_pixels=...) -> (patches, grid, seqlen)
    preprocess_image: Callable | None = None
    template: str = "chatml"
    precision: Precision = DEFAULT_PRECISION
    # (frames: [PIL]) -> (frame patches, meta, feature count); the LLaVA
    # video families only (the Qwen families take a video's patches and
    # (t, h, w) grid through the image stream, as in JAX)
    preprocess_video: Callable | None = None
    # shared-prompt GRPO scoring (models/shared_prompt.py): (params, batch,
    # group_size, remat=True) -> the hidden states [n*G, N, hid] that
    # predict the completion tokens; None for a family with no such path
    shared_pred_fn: Callable | None = None
    # () -> the logical-axis tree parallel to the parameters
    # (core/mesh.py shard_pytree places them by it)
    logical_axes: Callable | None = None

    # the training path: final hidden states and the LM-head kernel for
    # the chunked CE loss (train/sft.py); extra kwargs (tower_remat=) pass
    # through to apply
    def hidden_fn(self, params, batch, remat=True, **kw):
        h, _ = self.apply(params, batch, remat=remat, **kw)
        return h

    def head_kernel_fn(self, params):
        tcfg = getattr(self.cfg, "text", self.cfg)
        return qwen2.head_kernel(params.get("text", params), tcfg)

    # the unchunked training path (train/sft.py make_sft_step): the logits
    # [B, T, V] of the batch
    def forward(self, params, batch, remat=True, **kw):
        return self.logits_fn(params, self.hidden_fn(params, batch,
                                                      remat=remat, **kw))


def _generator(seed: int, device) -> tuple[torch.Generator, torch.device]:
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed), device


def _text_lora(lora):
    """A VLM adapter tree's decoder part (the JAX bundles' lora.get("text"))."""
    return lora.get("text") if lora else None


# transformers.LlamaConfig's defaults: what a published LLaMA text config
# means by a field it leaves out (older transformers wrote a nested
# text_config with only the fields that differ from these).  The JAX
# package fills a missing rope_theta with Qwen2's 1e6 instead (ROADMAP
# C.R10), and every position of such a decoder rotates wrongly there.
LLAMA_TEXT_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, rms_norm_eps=1e-6,
    rope_theta=10000.0, tie_word_embeddings=False)


# transformers.MistralConfig's defaults, for the same reason: Pixtral-12B's
# published text_config leaves out num_attention_heads (32), and a sparse
# one without rope_theta means 1e4.  The JAX package reads the heads as a
# required key and fills rope_theta with 1e6 (ROADMAP C.R17).
MISTRAL_TEXT_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False)
TEXT_DEFAULTS = {"llama": LLAMA_TEXT_DEFAULTS,
                 "mistral": MISTRAL_TEXT_DEFAULTS}


def _parse_rope_scaling(hf: dict) -> qwen2.RopeScaling | None:
    """A text config's ``rope_scaling`` as the decoder's RopeScaling (None
    for none, "default" and M-RoPE, whose sections are read apart).
    Dynamic NTK keys its base to ``max_position_embeddings``, as
    transformers' ``_compute_dynamic_ntk_parameters`` does, whatever the
    dict's ``original_max_position_embeddings`` says."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    rtype = rs.get("rope_type", rs.get("type"))
    if rtype in (None, "mrope", "default"):
        return None
    if rtype not in ("linear", "dynamic", "llama3"):
        raise NotImplementedError(f"rope scaling type {rtype!r} is not "
                                  "supported (linear, dynamic, llama3)")
    if rtype == "dynamic":
        orig = int(hf.get("max_position_embeddings", 32768))
    else:
        orig = int(rs.get("original_max_position_embeddings",
                          hf.get("max_position_embeddings", 32768)))
    return qwen2.RopeScaling(
        type=rtype, factor=float(rs.get("factor", 1.0)),
        original_max_position_embeddings=orig,
        low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
        high_freq_factor=float(rs.get("high_freq_factor", 4.0)))


def _is_mrope(text_hf: dict) -> bool:
    rs = text_hf.get("rope_scaling") or {}
    return ("mrope_section" in rs
            or rs.get("rope_type", rs.get("type")) == "mrope")


def configure_rope_scaling(hf_config: dict, rope_scaling: str,
                           model_max_length: int | None) -> dict:
    """A copy of an HF config dict set up for context extension (the
    reference's configure_rope, model_utils/rope.py:34-71): the factor is
    ceil(model_max_length / max_position_embeddings) when extending, 1.0
    when not, and 2.0 with no length given.  The scaling and the new
    maximum go into ``text_config`` where the config has one, since every
    family with a nested text config reads its decoder from there (the JAX
    package writes them at the top level, where a VLM decoder never reads
    them: ROADMAP C.R18).  An M-RoPE decoder (Qwen2-VL, Qwen2.5-VL) raises:
    its ``rope_scaling`` holds the M-RoPE sections, which a scaling dict
    would replace."""
    import math

    out = dict(hf_config)
    nested = isinstance(out.get("text_config"), dict)
    text = dict(out["text_config"]) if nested else out
    if _is_mrope(text):
        raise ValueError(
            "rope scaling over an M-RoPE decoder would replace its "
            "mrope_section (ROADMAP C.R18); M-RoPE takes no scaling")
    current_max = text.get("max_position_embeddings", 32768)
    rs: dict = {"rope_type": rope_scaling}
    if model_max_length:
        if model_max_length > current_max:
            rs["factor"] = float(math.ceil(model_max_length / current_max))
            text["max_position_embeddings"] = model_max_length
        else:
            rs["factor"] = 1.0
    else:
        rs["factor"] = 2.0
    if rope_scaling in ("dynamic", "llama3"):
        rs["original_max_position_embeddings"] = current_max
    if rope_scaling == "llama3" and model_max_length:
        rs["low_freq_factor"], rs["high_freq_factor"] = 1.0, 4.0
    text["rope_scaling"] = rs
    if nested:
        out["text_config"] = text
    return out


def _qwen2_text_cfg(hf: dict, attention_bias: bool = True
                    ) -> qwen2.Qwen2Config:
    hf = {**TEXT_DEFAULTS.get(hf.get("model_type"), {}), **hf}
    rs = hf.get("rope_scaling") or {}
    return qwen2.Qwen2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads",
                                   hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1000000.0),
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=attention_bias,
        mrope_section=(tuple(rs["mrope_section"]) if "mrope_section" in rs
                       else None),
        rope_scaling=_parse_rope_scaling(hf),
    )


def _qwen_preprocess_image(vcfg):
    def preprocess(pil, min_pixels=56 * 56, max_pixels=480000):
        from iadr1_tpu_torch.vision.preprocess import qwen2vl_preprocess

        flat, grid = qwen2vl_preprocess(
            pil, patch_size=vcfg.patch_size,
            merge_size=vcfg.spatial_merge_size,
            temporal_patch_size=vcfg.temporal_patch_size,
            min_pixels=min_pixels, max_pixels=max_pixels,
        )
        seqlen = int(np.prod(grid)) // (vcfg.spatial_merge_size ** 2)
        return flat, grid, seqlen

    return preprocess


def _scatter_indices(input_ids: np.ndarray, image_token_id: int,
                     n_feat_budget: int, feature_order=None,
                     video_token_id: int | None = None,
                     n_expected: int | None = None):
    """Feature -> (row, col) scatter indices; padded features target the
    sentinel row B (dropped by merge_image_features).  Features come in
    reading order, or in the order ``feature_order`` gives (the reading-
    order index of each feature, Qwen2.5-VL's window order).  Video tokens
    are matched too only when the image tokens alone fall short of
    ``n_expected`` features (some checkpoints reuse ordinary token ids as
    the video token); a video's patches ride the image stream, so its
    features follow it in reading order."""
    B = input_ids.shape[0]
    match = input_ids == image_token_id
    if (video_token_id is not None and video_token_id != image_token_id
            and n_expected is not None and int(match.sum()) < n_expected):
        match = match | (input_ids == video_token_id)
    rows_idx, cols_idx = np.nonzero(match)
    if len(rows_idx) > n_feat_budget:
        raise ValueError(
            f"{len(rows_idx)} image tokens exceed the feature budget "
            f"{n_feat_budget}")
    if feature_order is not None:
        rows_idx, cols_idx = rows_idx[feature_order], cols_idx[feature_order]
    srows = np.full(n_feat_budget, B, np.int64)
    scols = np.zeros(n_feat_budget, np.int64)
    srows[: len(rows_idx)] = rows_idx
    scols[: len(cols_idx)] = cols_idx
    return srows, scols


def _vlm_shared_pred(module, cfg, precision: Precision, attention: str,
                     batch_keys: tuple):
    """Shared-prompt GRPO scoring of a decoder VLM whose apply builds its
    input embeddings with ``module.compute_embeds`` (LLaVA-OneVision,
    LLaVA-1.5/NeXT): the tower, the packing and the scatter run once per
    unique prompt, over the batch's ``batch_keys``; the completions attend
    the shared prompt K/V.  The tower follows ``remat`` (True keeps its
    attention outside the checkpoints); its attention and the decoder's
    are the port's dispatch, K1 on the card."""
    tower_attn = default_attention(attention)
    attn_lse = default_attention_with_lse(attention)

    def shared_pred(params, batch, group_size, remat=True, lora=None,
                    lora_scale=1.0):
        embeds = module.compute_embeds(
            params, cfg, batch["prompt_ids"],
            **{k: batch[k] for k in batch_keys if k in batch},
            precision=precision, tower_attention_fn=tower_attn,
            tower_remat=bool(remat))
        return shared_prompt_pred_hidden(
            params["text"], cfg.text, batch, group_size,
            attention_fn=attn_lse, precision=precision, remat=remat,
            prompt_embeds=embeds, lora=_text_lora(lora),
            lora_scale=lora_scale)

    return shared_pred


def _anyres_arrays(input_ids: np.ndarray, patches_list, grids,
                   patch_budget: int, g: int, patch_dim: int,
                   image_token_id: int, max_tiles: int | None) -> dict:
    """The anyres families' host precompute for one batch (numpy): the
    tile stream padded with zero tiles to the static budget
    ``patch_budget // g**2`` tiles, each tile's segment id (``_tile_segments``),
    the anyres pack plans offset into the stream, and the scatter indices
    of the image tokens in reading order (features past the last image
    target the dropped row B).  ``patches_list``:
    [n_tiles_i, g*g, patch_dim] per image; ``grids``: (n_h, n_w, height,
    width) per image; ``max_tiles`` None: no anyres_max downscale."""
    from iadr1_tpu_torch.vision import anyres

    B = input_ids.shape[0]
    tile_budget = patch_budget // (g * g)
    feat_budget = tile_budget * (g * g + g)          # + newline headroom
    tiles = np.zeros((tile_budget, g * g, patch_dim), np.float32)
    src = np.zeros((feat_budget, 4), np.int64)
    wts = np.zeros((feat_budget, 4), np.float32)
    newline = np.zeros(feat_budget, bool)
    srows = np.full(feat_budget, B, np.int64)
    scols = np.zeros(feat_budget, np.int64)
    rows_idx, cols_idx = np.nonzero(input_ids == image_token_id)
    tile_off = feat_off = 0
    for p, (n_h, n_w, oh, ow) in zip(patches_list, grids):
        n = p.shape[0]
        if tile_off + n > tile_budget:
            raise ValueError(f"tile stream exceeds the budget of "
                             f"{tile_budget} tiles")
        tiles[tile_off:tile_off + n] = p
        plan = anyres.onevision_pack_plan((oh, ow), (n_h, n_w), g, max_tiles)
        F = plan["length"]
        if feat_off + F > feat_budget:
            raise ValueError("feature stream exceeds the budget")
        at = slice(feat_off, feat_off + F)
        src[at] = plan["src"] + tile_off * g * g
        wts[at] = plan["weights"]
        newline[at] = plan["newline"]
        tile_off += n
        feat_off += F
    # every image token takes one feature, in reading order: a cut image
    # run (or a stray image token) would scatter features onto the wrong
    # tokens
    if len(rows_idx) != feat_off:
        raise ValueError(f"{len(rows_idx)} image tokens for "
                         f"{feat_off} image features")
    srows[:feat_off], scols[:feat_off] = rows_idx, cols_idx
    return {"tiles": tiles, "tile_segments": _tile_segments(tile_budget,
                                                            tile_off),
            "pack_src": src, "pack_weights": wts, "newline_mask": newline,
            "scatter_rows": srows, "scatter_cols": scols}


def _tile_segments(tile_budget: int, n_real: int) -> np.ndarray:
    """Each tile's segment id in a stream of ``tile_budget`` tiles whose
    first ``n_real`` hold images: 1, and 0 for the zero tiles that pad it,
    which the towers' kernels skip (their features are dropped by the
    scatter)."""
    segs = np.zeros(tile_budget, np.int32)
    segs[:n_real] = 1
    return segs


def make_qwen2_bundle(hf_config: dict, attention: str = "auto",
                      precision: Precision = DEFAULT_PRECISION) -> ModelBundle:
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    cfg = _qwen2_text_cfg(hf_config)
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              lora=None, lora_scale=1.0):
        return qwen2.apply(
            params, cfg, batch["input_ids"],
            position_ids=batch["position_ids"],
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, remat=remat, lora=lora,
            lora_scale=lora_scale,
        )

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return qwen2.init_params(gen, cfg, dtype or precision.param_dtype,
                                 device)

    attn_lse = default_attention_with_lse(attention)

    def shared_pred(params, batch, group_size, remat=True, lora=None,
                    lora_scale=1.0):
        return shared_prompt_pred_hidden(
            params, cfg, batch, group_size, attention_fn=attn_lse,
            precision=precision, remat=remat, lora=lora,
            lora_scale=lora_scale)

    return ModelBundle(
        logical_axes=lambda: qwen2.logical_axes(cfg),
        family="qwen2", cfg=cfg, multimodal=False,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: convert_qwen2(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: qwen2.logits(params, cfg, h, precision),
        template="chatml",
        shared_pred_fn=shared_pred, precision=precision,
    )


def make_qwen2_moe_bundle(hf_config: dict, attention: str = "auto",
                          precision: Precision = DEFAULT_PRECISION
                          ) -> ModelBundle:
    """Qwen2-MoE (Qwen1.5-MoE-A2.7B): the sparse-MoE decoder
    (``models/qwen2_moe.py``).  ``apply(..., return_aux=True)`` also
    returns the router's load-balancing loss, which the SFT step adds
    (``router_aux_loss_coef``).  No shared-prompt scoring, as in JAX: its
    SC-GRPO update is the dense one."""
    from iadr1_tpu_torch.models import qwen2_moe

    cfg = qwen2_moe.config_from_hf(hf_config)
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              lora=None, lora_scale=1.0, return_aux=False):
        return qwen2_moe.apply(
            params, cfg, batch["input_ids"],
            position_ids=batch["position_ids"],
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, remat=remat, lora=lora,
            lora_scale=lora_scale, return_aux=return_aux)

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return qwen2_moe.init_params(gen, cfg, dtype or precision.param_dtype,
                                     device)

    return ModelBundle(
        logical_axes=lambda: qwen2_moe.logical_axes(cfg),
        family="qwen2_moe", cfg=cfg, multimodal=False,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: qwen2_moe.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: qwen2_moe.logits(params, cfg, h,
                                                     precision),
        template="chatml", precision=precision,
    )


def make_qwen2_vl_bundle(hf_config: dict, attention: str = "auto",
                         precision: Precision = DEFAULT_PRECISION
                         ) -> ModelBundle:
    from iadr1_tpu_torch.vision import preprocess as vp

    text_hf = hf_config.get("text_config", hf_config)
    vis_hf = hf_config["vision_config"]
    tcfg = _qwen2_text_cfg(text_hf)
    vcfg = qwen2_vl.Qwen2VLVisionConfig(
        depth=vis_hf.get("depth", 32),
        embed_dim=vis_hf.get("embed_dim", 1280),
        hidden_size=vis_hf.get("hidden_size", tcfg.hidden_size),
        num_heads=vis_hf.get("num_heads", 16),
        patch_size=vis_hf.get("patch_size", 14),
        spatial_merge_size=vis_hf.get("spatial_merge_size", 2),
        temporal_patch_size=vis_hf.get("temporal_patch_size", 2),
        mlp_ratio=vis_hf.get("mlp_ratio", 4.0),
    )
    cfg = qwen2_vl.Qwen2VLConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_id", 151655),
        vision_start_token_id=hf_config.get("vision_start_token_id", 151652),
        video_token_id=hf_config.get("video_token_id", 151656),
    )
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return qwen2_vl.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            patches=batch.get("patches"),
            rot_cos=batch.get("rot_cos"), rot_sin=batch.get("rot_sin"),
            vision_segments=batch.get("vision_segments"),
            scatter_rows=batch.get("scatter_rows"),
            scatter_cols=batch.get("scatter_cols"),
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, vision_attention_fn=attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale,
        )

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch: the padded patch stream, rotary
        tables, per-image segment ids and scatter indices (numpy)."""
        grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
        flat = (np.concatenate(patches_list, axis=0) if patches_list
                else np.zeros((0, vcfg.patch_dim), np.float32))
        n = flat.shape[0]
        if n > patch_budget:
            raise ValueError(f"patch stream {n} exceeds budget {patch_budget}")
        pad = patch_budget - n
        flat = np.concatenate(
            [flat, np.zeros((pad, vcfg.patch_dim), np.float32)])
        cos, sin = vp.vision_rotary_tables(grid_thw, vcfg.head_dim)
        cos = np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])
        sin = np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])
        merge_unit = vcfg.spatial_merge_size ** 2
        srows, scols = _scatter_indices(
            input_ids, cfg.image_token_id, patch_budget // merge_unit,
            video_token_id=cfg.video_token_id, n_expected=n // merge_unit)
        return {
            "patches": flat.astype(np.float32), "rot_cos": cos,
            "rot_sin": sin,
            "vision_segments": vp.vision_segment_ids(grid_thw,
                                                     pad_to=patch_budget),
            "scatter_rows": srows, "scatter_cols": scols,
        }

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return qwen2_vl.init_params(gen, cfg, dtype or precision.param_dtype,
                                    device)

    attn_lse = default_attention_with_lse(attention)

    def shared_pred(params, batch, group_size, remat=True, lora=None,
                    lora_scale=1.0):
        """The tower and the feature scatter run once per UNIQUE prompt;
        the completions attend the shared prompt K/V.  The tower follows
        ``remat`` as a plain checkpoint of each block, as in JAX."""
        embeds = common.embed_lookup(
            params["text"]["embed"]["weight"], batch["prompt_ids"]
        ).to(precision.compute_dtype)
        if batch.get("patches") is not None:
            feats = qwen2_vl.apply_vision(
                params["vision"], cfg.vision, batch["patches"],
                batch["rot_cos"], batch["rot_sin"], batch["vision_segments"],
                precision=precision, attention_fn=attn, remat=bool(remat))
            embeds = qwen2_vl.merge_image_features(
                embeds, feats, batch["scatter_rows"], batch["scatter_cols"])
        return shared_prompt_pred_hidden(
            params["text"], tcfg, batch, group_size, attention_fn=attn_lse,
            precision=precision, remat=remat, prompt_embeds=embeds,
            lora=_text_lora(lora), lora_scale=lora_scale)

    return ModelBundle(
        logical_axes=lambda: qwen2_vl.logical_axes(cfg),
        family="qwen2_vl", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: qwen2_vl.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: qwen2_vl.logits(params, cfg, h, precision),
        vision_arrays=vision_arrays,
        preprocess_image=_qwen_preprocess_image(vcfg),
        template="qwen2_vl",
        shared_pred_fn=shared_pred, precision=precision,
    )


def make_qwen25_vl_bundle(hf_config: dict, attention: str = "auto",
                          precision: Precision = DEFAULT_PRECISION
                          ) -> ModelBundle:
    """Qwen2.5-VL: the windowed tower over a window-ordered patch stream,
    the merger, the Qwen2 decoder with M-RoPE.  Both the window blocks and
    the full-attention blocks of the tower are segment-masked, non-causal
    calls of the decoder's dispatch (K1 on the card, D = 80)."""
    text_hf = hf_config.get("text_config", hf_config)
    vis_hf = hf_config["vision_config"]
    tcfg = _qwen2_text_cfg(text_hf)
    vcfg = qwen25_vl.Qwen25VLVisionConfig(
        depth=vis_hf.get("depth", 32),
        hidden_size=vis_hf.get("hidden_size", 1280),
        intermediate_size=vis_hf.get("intermediate_size", 3420),
        out_hidden_size=vis_hf.get("out_hidden_size", tcfg.hidden_size),
        num_heads=vis_hf.get("num_heads", 16),
        patch_size=vis_hf.get("patch_size", 14),
        spatial_merge_size=vis_hf.get("spatial_merge_size", 2),
        temporal_patch_size=vis_hf.get("temporal_patch_size", 2),
        window_size=vis_hf.get("window_size", 112),
        fullatt_block_indexes=tuple(
            vis_hf.get("fullatt_block_indexes", (7, 15, 23, 31))),
        tokens_per_second=vis_hf.get("tokens_per_second", 2),
    )
    cfg = qwen25_vl.Qwen25VLConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_id", 151655),
        video_token_id=hf_config.get("video_token_id", 151656),
        vision_start_token_id=hf_config.get("vision_start_token_id", 151652),
        vision_end_token_id=hf_config.get("vision_end_token_id", 151653),
    )
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return qwen25_vl.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            patches=batch.get("patches"),
            rot_cos=batch.get("rot_cos"), rot_sin=batch.get("rot_sin"),
            full_segs=batch.get("full_segs"),
            window_segs=batch.get("window_segs"),
            scatter_rows=batch.get("scatter_rows"),
            scatter_cols=batch.get("scatter_cols"),
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, vision_attention_fn=attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale,
        )

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch (numpy): the patch stream permuted
        into window order and padded to the budget, its rotary tables, the
        per-image and per-window segment ids, and scatter indices that
        send each window-ordered feature to its image token."""
        grid_thw = np.asarray(grids, np.int64).reshape(-1, 3)
        flat = (np.concatenate(patches_list, axis=0) if patches_list
                else np.zeros((0, vcfg.patch_dim), np.float32))
        n = flat.shape[0]
        if n > patch_budget:
            raise ValueError(f"patch stream {n} exceeds budget {patch_budget}")
        merge_unit = vcfg.spatial_merge_size ** 2
        if not n:                        # no image: every feature dropped
            head, n_feat = vcfg.head_dim, patch_budget // merge_unit
            return {
                "patches": np.zeros((patch_budget, vcfg.patch_dim),
                                    np.float32),
                "rot_cos": np.ones((patch_budget, head), np.float32),
                "rot_sin": np.zeros((patch_budget, head), np.float32),
                "full_segs": np.zeros(patch_budget, np.int32),
                "window_segs": np.zeros(patch_budget, np.int32),
                "scatter_rows": np.full(n_feat, input_ids.shape[0],
                                        np.int64),
                "scatter_cols": np.zeros(n_feat, np.int64),
            }
        arrs = qwen25_vl.qwen25vl_vision_arrays(grid_thw, vcfg,
                                                pad_to=patch_budget)
        flat = np.concatenate([flat[arrs["patch_perm"]], np.zeros(
            (patch_budget - n, vcfg.patch_dim), np.float32)])
        srows, scols = _scatter_indices(
            input_ids, cfg.image_token_id, patch_budget // merge_unit,
            feature_order=arrs["feature_order"],
            video_token_id=cfg.video_token_id, n_expected=n // merge_unit)
        return {
            "patches": flat.astype(np.float32),
            "rot_cos": arrs["rot_cos"], "rot_sin": arrs["rot_sin"],
            "full_segs": arrs["full_segs"],
            "window_segs": arrs["window_segs"],
            "scatter_rows": srows, "scatter_cols": scols,
        }

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return qwen25_vl.init_params(gen, cfg, dtype or precision.param_dtype,
                                     device)

    attn_lse = default_attention_with_lse(attention)

    def shared_pred(params, batch, group_size, remat=True, lora=None,
                    lora_scale=1.0):
        """The tower and the feature scatter run once per UNIQUE prompt;
        the completions attend the shared prompt K/V."""
        embeds = common.embed_lookup(
            params["text"]["embed"]["weight"], batch["prompt_ids"]
        ).to(precision.compute_dtype)
        if batch.get("patches") is not None:
            feats = qwen25_vl.apply_vision(
                params["vision"], vcfg, batch["patches"], batch["rot_cos"],
                batch["rot_sin"], batch["full_segs"], batch["window_segs"],
                precision=precision, attention_fn=attn, remat=bool(remat))
            embeds = qwen2_vl.merge_image_features(
                embeds, feats, batch["scatter_rows"], batch["scatter_cols"])
        return shared_prompt_pred_hidden(
            params["text"], tcfg, batch, group_size, attention_fn=attn_lse,
            precision=precision, remat=remat, prompt_embeds=embeds,
            lora=_text_lora(lora), lora_scale=lora_scale)

    return ModelBundle(
        logical_axes=lambda: qwen25_vl.logical_axes(cfg),
        family="qwen2_5_vl", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: qwen25_vl.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: qwen25_vl.logits(params, cfg, h,
                                                     precision),
        vision_arrays=vision_arrays,
        preprocess_image=_qwen_preprocess_image(vcfg),
        template="qwen2_vl",
        shared_pred_fn=shared_pred, precision=precision,
    )


# the collated arrays the LLaVA families' compute_embeds read (the pack
# plans are the anyres modes', the video arrays the video families')
ONEVISION_BATCH_KEYS = ("tiles", "tile_segments", "pack_src",
                        "pack_weights", "newline_mask", "scatter_rows",
                        "scatter_cols")
LLAVA_BATCH_KEYS = ONEVISION_BATCH_KEYS + (
    "video_tiles", "video_tile_segments", "video_scatter_rows",
    "video_scatter_cols")

# the JAX bundle's fallback grid pinpoints, used when a config names none
# (six entries up to 1152; not HF LlavaOnevisionConfig's 36-entry default,
# which a config carries in image_grid_pinpoints)
ONEVISION_DEFAULT_PINPOINTS = ((384, 384), (384, 768), (768, 384),
                               (768, 768), (1152, 384), (384, 1152))


def make_llava_onevision_bundle(hf_config: dict, attention: str = "auto",
                                precision: Precision = DEFAULT_PRECISION
                                ) -> ModelBundle:
    """LLaVA-OneVision: the SigLIP tower over anyres tiles, the projector
    and anyres packing, the Qwen2 decoder with 1-D positions.

    The tower's attention takes the same dispatch as the decoder's: under
    'auto' / 'flash' it is K1 on the card (D = 72 at so400m's width),
    under 'xla' the dense oracle.  The JAX bundle defaults its tower to the
    dense path, after a v5e measurement that does not carry over to this
    card; its ``tower_attention_fn=flash_attn`` override is the
    counterpart the tests hold this path to."""
    from iadr1_tpu_torch.vision import anyres

    tcfg = _qwen2_text_cfg(hf_config["text_config"])
    vis_hf = hf_config["vision_config"]
    vcfg = siglip.SiglipVisionConfig(
        hidden_size=vis_hf.get("hidden_size", 1152),
        intermediate_size=vis_hf.get("intermediate_size", 4304),
        num_hidden_layers=vis_hf.get("num_hidden_layers", 27),
        num_attention_heads=vis_hf.get("num_attention_heads", 16),
        image_size=vis_hf.get("image_size", 384),
        patch_size=vis_hf.get("patch_size", 14),
        layer_norm_eps=vis_hf.get("layer_norm_eps", 1e-6),
    )
    cfg = llava_onevision.LlavaOnevisionConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_index",
                                     hf_config.get("image_token_id", 151646)),
        image_grid_pinpoints=tuple(
            tuple(p) for p in hf_config.get("image_grid_pinpoints") or ()
        ) or ONEVISION_DEFAULT_PINPOINTS,
        vision_aspect_ratio=hf_config.get("vision_aspect_ratio",
                                          "anyres_max_9"),
    )
    attn = default_attention(attention)
    tower_attn = tower_attention(attention)
    decode_attn = default_decode_attention(attention)
    g = vcfg.grid
    stats = _image_stats(hf_config)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return llava_onevision.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            **{k: batch.get(k) for k in ONEVISION_BATCH_KEYS},
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, tower_attention_fn=tower_attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale,
        )

    def preprocess_image(pil, min_pixels=None, max_pixels=None):
        """PIL image -> (patches [n_tiles, g*g, patch_dim], (n_h, n_w,
        height, width), packed feature count); the pixel bounds are the
        Qwen2-VL family's and are not read."""
        tiles, grid = anyres.onevision_tiles(pil, cfg.image_grid_pinpoints,
                                             vcfg.image_size, *stats)
        patches = anyres.patchify_tiles(tiles, vcfg.patch_size)
        seqlen = anyres.onevision_feature_len((pil.height, pil.width), grid,
                                              g, cfg.max_tiles)
        return patches, (grid[0], grid[1], pil.height, pil.width), seqlen

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch (numpy, ``_anyres_arrays``):
        ``patches_list`` [n_tiles_i, g*g, patch_dim] and ``grids`` (n_h,
        n_w, height, width) per image."""
        return _anyres_arrays(input_ids, patches_list, grids, patch_budget,
                              g, vcfg.patch_dim, cfg.image_token_id,
                              cfg.max_tiles)

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return llava_onevision.init_params(
            gen, cfg, dtype or precision.param_dtype, device)

    return ModelBundle(
        logical_axes=lambda: llava_onevision.logical_axes(cfg),
        family="llava_onevision", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None:
            llava_onevision.convert_hf(
                state, cfg, dtype=dtype or precision.param_dtype,
                device=device),
        apply=apply,
        logits_fn=lambda params, h: llava_onevision.logits(params, cfg, h,
                                                           precision),
        vision_arrays=vision_arrays,
        preprocess_image=preprocess_image,
        template="llava_next_qwen",
        shared_pred_fn=_vlm_shared_pred(llava_onevision, cfg, precision,
                                        attention, ONEVISION_BATCH_KEYS),
        precision=precision,
    )


# the JAX bundle's fallback LLaVA-NeXT pinpoints (those of
# llava-v1.6-vicuna-7b, at 336 a tile)
LLAVA_NEXT_DEFAULT_PINPOINTS = ((336, 672), (672, 336), (672, 672),
                                (1008, 336), (336, 1008))


def make_llava_bundle(hf_config: dict, attention: str = "auto",
                      precision: Precision = DEFAULT_PRECISION
                      ) -> ModelBundle:
    """LLaVA-1.5, LLaVA-NeXT, LLaVA-NeXT-Video and Video-LLaVA: the CLIP
    tower (its first ``tower_layers`` layers) over one center-cropped tile
    per image (1.5, Video-LLaVA) or anyres tiles packed as LLaVA-OneVision
    packs them without the anyres_max downscale (NeXT, NeXT-Video), the
    projector, a llama-style decoder with 1-D positions; the video
    families' frames, each center-cropped to one tile, through the same
    tower (NeXT-Video, pooled at ``spatial_pool_stride``) or Video-LLaVA's
    video tower.  The tower's attention is the decoder's dispatch, K1 on
    the card (D = 64 at CLIP-L's width), each tile or frame its own
    sequence and the zero tiles that pad a stream masked out
    (``tile_segments``, ``video_tile_segments``).  A pixtral
    ``vision_config`` makes it Pixtral (``make_pixtral_bundle``)."""
    from iadr1_tpu_torch.vision import anyres

    archs = list(hf_config.get("architectures") or [])
    mt = hf_config.get("model_type")
    vis_hf = hf_config.get("vision_config") or {}
    # HF ships Pixtral as LlavaForConditionalGeneration with a pixtral
    # vision_config: another tower and decoder
    if vis_hf.get("model_type") == "pixtral":
        return make_pixtral_bundle(hf_config, attention, precision)
    lnv_mode = ("LlavaNextVideoForConditionalGeneration" in archs
                or mt == "llava_next_video")
    videollava_mode = ("VideoLlavaForConditionalGeneration" in archs
                       or mt == "video_llava")
    anyres_mode = lnv_mode or ("LlavaNextForConditionalGeneration" in archs
                               or mt == "llava_next")
    if lnv_mode and hf_config.get("spatial_pool_mode",
                                  "average") != "average":
        raise ValueError("only spatial_pool_mode='average' is supported "
                         "(every released LLaVA-NeXT-Video checkpoint "
                         "uses it)")
    text_hf = hf_config.get("text_config") or {"model_type": "llama"}
    tcfg = _qwen2_text_cfg(text_hf, attention_bias=False)
    vcfg = clip_vit.ClipVisionConfig(
        hidden_size=vis_hf.get("hidden_size", 1024),
        intermediate_size=vis_hf.get("intermediate_size", 4096),
        num_hidden_layers=vis_hf.get("num_hidden_layers", 24),
        num_attention_heads=vis_hf.get("num_attention_heads", 16),
        image_size=vis_hf.get("image_size", 336),
        patch_size=vis_hf.get("patch_size", 14),
        layer_norm_eps=vis_hf.get("layer_norm_eps", 1e-5),
    )
    video_mode = lnv_mode or videollava_mode
    cfg = llava.LlavaConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_index",
                                     hf_config.get("image_token_id", 32000)),
        vision_feature_layer=hf_config.get("vision_feature_layer", -2),
        vision_feature_select_strategy=hf_config.get(
            "vision_feature_select_strategy", "default"),
        anyres=anyres_mode,
        image_grid_pinpoints=tuple(
            tuple(p) for p in hf_config.get("image_grid_pinpoints") or ()
        ) or LLAVA_NEXT_DEFAULT_PINPOINTS,
        video_token_id=(hf_config.get("video_token_index",
                                      hf_config.get("video_token_id"))
                        if video_mode else None),
        video_pool_stride=(hf_config.get("spatial_pool_stride", 2)
                           if lnv_mode else 0),
        video_keep_cls=videollava_mode,
        separate_video_tower=videollava_mode,
    )
    attn = default_attention(attention)
    tower_attn = tower_attention(attention)
    decode_attn = default_decode_attention(attention)
    g = vcfg.grid
    stats = _image_stats(hf_config)
    if cfg.video_pool_stride > 1:
        feats_per_frame = (g // cfg.video_pool_stride) ** 2
    else:
        feats_per_frame = g * g + (1 if cfg.video_keep_cls else 0)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return llava.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            **{k: batch.get(k) for k in LLAVA_BATCH_KEYS},
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, tower_attention_fn=tower_attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale,
        )

    def preprocess_image(pil, min_pixels=None, max_pixels=None):
        """PIL image -> (patches [n_tiles, g*g, patch_dim], (n_h, n_w,
        height, width), feature count): anyres tiles (NeXT), or one
        center-cropped tile of g*g features (1.5).  The pixel bounds are
        the Qwen2-VL family's and are not read."""
        if anyres_mode:
            tiles, grid = anyres.llava_next_tiles(
                pil, cfg.image_grid_pinpoints, vcfg.image_size, *stats)
            seqlen = anyres.onevision_feature_len(
                (pil.height, pil.width), grid, g, max_tiles=None)
        else:
            tiles = anyres.clip_resize_center_crop(pil, vcfg.image_size,
                                                   *stats)[None]
            grid, seqlen = (1, 1), g * g
        patches = anyres.patchify_tiles(tiles, vcfg.patch_size)
        return patches, (grid[0], grid[1], pil.height, pil.width), seqlen

    def preprocess_video(frames):
        """Sampled PIL frames -> (patches [n_frames, g*g, patch_dim],
        ("video", n_frames), feature count): each frame center-cropped to
        one tile; a frame gives (g / stride)^2 features (NeXT-Video), g*g
        + 1 (Video-LLaVA, CLS kept) or g*g."""
        arr = np.stack([anyres.clip_resize_center_crop(f, vcfg.image_size,
                                                       *stats)
                        for f in frames])
        patches = anyres.patchify_tiles(arr, vcfg.patch_size)
        return patches, ("video", len(frames)), feats_per_frame * len(frames)

    def video_arrays(input_ids, videos, patch_budget):
        """The frame stream of ``videos`` ([n_frames, g*g, patch_dim]
        each) padded with zero frames to ``patch_budget // g**2`` frames,
        each frame's segment id, and the scatter indices of the video
        tokens in reading order, ``feats_per_frame`` a frame."""
        B = input_ids.shape[0]
        frame_budget = max(patch_budget // (g * g), 1)
        frames = np.zeros((frame_budget, g * g, vcfg.patch_dim), np.float32)
        n_frames = 0
        for v in videos or ():
            n = v.shape[0]
            if n_frames + n > frame_budget:
                raise ValueError(f"the frame stream exceeds the budget of "
                                 f"{frame_budget} frames")
            frames[n_frames:n_frames + n] = v
            n_frames += n
        rows_idx, cols_idx = np.nonzero(input_ids == cfg.video_token_id)
        if len(rows_idx) != n_frames * feats_per_frame:
            raise ValueError(f"{len(rows_idx)} video tokens for "
                             f"{n_frames * feats_per_frame} video features")
        n_feats = frame_budget * feats_per_frame
        vrows = np.full(n_feats, B, np.int64)
        vcols = np.zeros(n_feats, np.int64)
        vrows[:len(rows_idx)], vcols[:len(cols_idx)] = rows_idx, cols_idx
        return {"video_tiles": frames,
                "video_tile_segments": _tile_segments(frame_budget,
                                                      n_frames),
                "video_scatter_rows": vrows, "video_scatter_cols": vcols}

    def image_arrays(input_ids, patches_list, grids, patch_budget):
        if anyres_mode:
            return _anyres_arrays(input_ids, patches_list, grids,
                                  patch_budget, g, vcfg.patch_dim,
                                  cfg.image_token_id, None)
        B = input_ids.shape[0]
        tile_budget = patch_budget // (g * g)
        n_tiles = len(patches_list)
        if n_tiles > tile_budget:
            raise ValueError(f"{n_tiles} images exceed the budget of "
                             f"{tile_budget} tiles")
        tiles = np.zeros((tile_budget, g * g, vcfg.patch_dim),
                         np.float32)
        for i, p in enumerate(patches_list):
            tiles[i] = p[0]
        rows_idx, cols_idx = np.nonzero(input_ids == cfg.image_token_id)
        if len(rows_idx) != n_tiles * g * g:
            raise ValueError(f"{len(rows_idx)} image tokens for "
                             f"{n_tiles * g * g} image features")
        srows = np.full(tile_budget * g * g, B, np.int64)
        scols = np.zeros(tile_budget * g * g, np.int64)
        srows[:len(rows_idx)], scols[:len(cols_idx)] = rows_idx, cols_idx
        return {"tiles": tiles,
                "tile_segments": _tile_segments(tile_budget, n_tiles),
                "scatter_rows": srows, "scatter_cols": scols}

    def vision_arrays(input_ids, patches_list, grids, patch_budget,
                      videos=None):
        """Host precompute for one batch (numpy): the tile stream padded
        with zero tiles to ``patch_budget // g**2`` tiles, each tile's
        segment id (``_tile_segments``), and the scatter indices of the
        image tokens in reading order; NeXT's are ``_anyres_arrays``, with
        the anyres pack plans.  For 1.5 the tile stream's features map one
        to one onto the image tokens.  The video families add the frame
        stream of ``videos`` (``video_arrays``), sized by the same
        budget."""
        out = image_arrays(input_ids, patches_list, grids, patch_budget)
        if video_mode:
            out.update(video_arrays(input_ids, videos, patch_budget))
        elif videos:
            raise ValueError(f"family {family} takes no videos")
        return out

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return llava.init_params(gen, cfg, dtype or precision.param_dtype,
                                 device)

    if lnv_mode:
        family = "llava_next_video"
    elif videollava_mode:
        family = "video_llava"
    else:
        family = "llava_next" if anyres_mode else "llava"
    return ModelBundle(
        logical_axes=lambda: llava.logical_axes(cfg),
        family=family, cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: llava.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: llava.logits(params, cfg, h, precision),
        vision_arrays=vision_arrays,
        preprocess_image=preprocess_image,
        preprocess_video=preprocess_video if video_mode else None,
        template=family,
        shared_pred_fn=_vlm_shared_pred(llava, cfg, precision, attention,
                                        LLAVA_BATCH_KEYS),
        precision=precision,
    )


# the collated arrays InternVL's compute_embeds reads
INTERNVL_BATCH_KEYS = ("tiles", "tile_segments", "scatter_rows",
                       "scatter_cols")


def _first(v):
    """A config size that may be written as a pair (HF InternVL's)."""
    return v[0] if isinstance(v, (list, tuple)) else v


def make_internvl_bundle(hf_config: dict, attention: str = "auto",
                         precision: Precision = DEFAULT_PRECISION
                         ) -> ModelBundle:
    """InternVL: the InternViT tower over aspect-optimal tiles (plus a
    thumbnail), pixel shuffle and the MLP projector, the Qwen2 decoder
    with 1-D positions.  The tower's attention is the decoder's dispatch,
    K1 on the card (D = 64 at InternViT-300M's width, 1025 tokens a tile),
    each tile its own sequence and the zero tiles that pad the stream
    masked out (``tile_segments``)."""
    text_hf, vis_hf = hf_config["text_config"], hf_config["vision_config"]
    tcfg = _qwen2_text_cfg(text_hf)
    vcfg = internvl.InternVLVisionConfig(
        hidden_size=vis_hf.get("hidden_size", 1024),
        intermediate_size=vis_hf.get("intermediate_size", 4096),
        num_hidden_layers=vis_hf.get("num_hidden_layers", 24),
        num_attention_heads=vis_hf.get("num_attention_heads", 16),
        image_size=_first(vis_hf.get("image_size", 448)),
        patch_size=_first(vis_hf.get("patch_size", 14)),
        layer_norm_eps=vis_hf.get("layer_norm_eps", 1e-6),
        attention_bias=vis_hf.get("attention_bias", True),
        use_qk_norm=vis_hf.get("use_qk_norm", False),
        norm_type=vis_hf.get("norm_type", "layer_norm"),
    )
    cfg = internvl.InternVLConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_id", 151667),
        downsample_ratio=hf_config.get("downsample_ratio", 0.5),
        max_tiles=hf_config.get("max_tiles", 12),
    )
    attn = default_attention(attention)
    tower_attn = tower_attention(attention)
    decode_attn = default_decode_attention(attention)
    g, fpt = vcfg.grid, cfg.features_per_tile
    mean, std = _image_stats(hf_config)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return internvl.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            **{k: batch.get(k) for k in INTERNVL_BATCH_KEYS},
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, tower_attention_fn=tower_attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale,
        )

    def preprocess_image(pil, min_pixels=None, max_pixels=None):
        """PIL image -> (patches [n_tiles, g*g, patch_dim], (n_tiles,),
        feature count); the pixel bounds are the Qwen2-VL family's and are
        not read."""
        from iadr1_tpu_torch.vision.anyres import patchify_tiles

        tiles, n = internvl.internvl_tiles(pil, vcfg.image_size,
                                           cfg.min_tiles, cfg.max_tiles,
                                           mean=mean, std=std)
        return patchify_tiles(tiles, vcfg.patch_size), (n,), n * fpt

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch (numpy): the tile stream padded
        with zero tiles to ``patch_budget // g**2`` tiles, each tile's
        segment id (``_tile_segments``), and the scatter indices of the
        image tokens in reading order, ``features_per_tile`` a tile."""
        B = input_ids.shape[0]
        tile_budget = patch_budget // (g * g)
        tiles = np.zeros((tile_budget, g * g, vcfg.patch_dim), np.float32)
        n_tiles = 0
        for p in patches_list:
            n = p.shape[0]
            if n_tiles + n > tile_budget:
                raise ValueError(f"tile stream exceeds the budget of "
                                 f"{tile_budget} tiles")
            tiles[n_tiles:n_tiles + n] = p
            n_tiles += n
        rows_idx, cols_idx = np.nonzero(input_ids == cfg.image_token_id)
        if len(rows_idx) != n_tiles * fpt:
            raise ValueError(f"{len(rows_idx)} image tokens for "
                             f"{n_tiles * fpt} image features")
        srows = np.full(tile_budget * fpt, B, np.int64)
        scols = np.zeros(tile_budget * fpt, np.int64)
        srows[:len(rows_idx)], scols[:len(cols_idx)] = rows_idx, cols_idx
        return {"tiles": tiles,
                "tile_segments": _tile_segments(tile_budget, n_tiles),
                "scatter_rows": srows, "scatter_cols": scols}

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return internvl.init_params(gen, cfg, dtype or precision.param_dtype,
                                    device)

    return ModelBundle(
        logical_axes=lambda: internvl.logical_axes(cfg),
        family="internvl", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: internvl.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: internvl.logits(params, cfg, h,
                                                    precision),
        vision_arrays=vision_arrays,
        preprocess_image=preprocess_image,
        template="intern_vl",
        shared_pred_fn=_vlm_shared_pred(internvl, cfg, precision, attention,
                                        INTERNVL_BATCH_KEYS),
        precision=precision,
    )


# the collated arrays PaliGemma's and Pixtral's compute_embeds read
PALIGEMMA_BATCH_KEYS = ("tiles", "tile_segments", "scatter_rows",
                        "scatter_cols")
PIXTRAL_BATCH_KEYS = ("patch_stream", "patch_pos_ids", "patch_segments",
                      "scatter_rows", "scatter_cols")


def make_paligemma_bundle(hf_config: dict, attention: str = "auto",
                          precision: Precision = DEFAULT_PRECISION
                          ) -> ModelBundle:
    """PaliGemma: the SigLIP tower over one square tile per image, the
    linear projector, the Gemma decoder (the Qwen2 module with
    ``rms_norm_offset``, ``gelu_pytorch_tanh`` and ``scale_embeds``) as a
    prefix LM with 1-indexed positions.  The tower's attention is the
    dispatch, K1 on the card (D = 72 at so400m's width, (image_size /
    14)^2 tokens a tile), with the budget's padding tiles at segment 0.
    The decoder's prefill, training and scoring attention is prefix-LM,
    hence dense (``qwen2.prefix_lm_attention``), as in the JAX bundle;
    its single-token decode is K4 (D = 256, 8 heads over 1 at Gemma-2B's
    width).  No shared-prompt scoring (none in JAX)."""
    text_hf, vis_hf = hf_config["text_config"], hf_config["vision_config"]
    tcfg = dataclasses.replace(
        _qwen2_text_cfg({**text_hf,
                         "rope_theta": text_hf.get("rope_theta", 10000.0),
                         "tie_word_embeddings": text_hf.get(
                             "tie_word_embeddings", True)}),
        attention_bias=bool(text_hf.get("attention_bias", False)),
        rms_norm_offset=1.0,
        hidden_act=(text_hf.get("hidden_act",
                                text_hf.get("hidden_activation"))
                    or "gelu_pytorch_tanh"),
        scale_embeds=True)
    vcfg = siglip.SiglipVisionConfig(
        hidden_size=vis_hf.get("hidden_size", 1152),
        intermediate_size=vis_hf.get("intermediate_size", 4304),
        num_hidden_layers=vis_hf.get("num_hidden_layers", 27),
        num_attention_heads=vis_hf.get("num_attention_heads", 16),
        image_size=vis_hf.get("image_size", 224),
        patch_size=vis_hf.get("patch_size", 14),
        layer_norm_eps=vis_hf.get("layer_norm_eps", 1e-6),
    )
    cfg = paligemma.PaliGemmaConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_index",
                                     hf_config.get("image_token_id", 257152)),
        projection_dim=vis_hf.get("projection_dim",
                                  hf_config.get("projection_dim")))
    tower_attn = tower_attention(attention)
    decode_attn = default_decode_attention(attention)
    g = vcfg.grid
    mean = np.asarray(hf_config.get("image_mean", (0.5, 0.5, 0.5)),
                      np.float32)
    std = np.asarray(hf_config.get("image_std", (0.5, 0.5, 0.5)), np.float32)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return paligemma.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            **{k: batch.get(k) for k in PALIGEMMA_BATCH_KEYS},
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision,
            decode_attention_fn=decode_attn, tower_attention_fn=tower_attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale)

    def preprocess_image(pil, min_pixels=None, max_pixels=None):
        """PIL image -> (patches [1, g*g, patch_dim], (1, 1, height,
        width), g*g): SiglipImageProcessor's plain bicubic resize to the
        square input, mean and std 0.5 (the checkpoint's where
        ``bundle_from_pretrained`` found them); the pixel bounds are the
        Qwen2-VL family's and are not read."""
        from iadr1_tpu_torch.vision import anyres

        arr = anyres.normalize(anyres.to_array(
            pil, (vcfg.image_size, vcfg.image_size)), mean, std)
        patches = anyres.patchify_tiles(arr[None], vcfg.patch_size)
        return patches, (1, 1, pil.height, pil.width), g * g

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch (numpy): one tile per image,
        padded with zero tiles to ``patch_budget // g**2`` tiles (at least
        one), each tile's segment id (``_tile_segments``), and the scatter
        indices of the image tokens in reading order, one feature a token
        (the prepended runs)."""
        B = input_ids.shape[0]
        tile_budget = max(patch_budget // (g * g), 1)
        n_tiles = len(patches_list)
        if n_tiles > tile_budget:
            raise ValueError(f"{n_tiles} images exceed the budget of "
                             f"{tile_budget} tiles")
        tiles = np.zeros((tile_budget, g * g, vcfg.patch_dim), np.float32)
        for i, p in enumerate(patches_list):
            tiles[i] = p[0]
        rows_idx, cols_idx = np.nonzero(input_ids == cfg.image_token_id)
        if len(rows_idx) != n_tiles * g * g:
            raise ValueError(f"{len(rows_idx)} image tokens for "
                             f"{n_tiles * g * g} image features")
        srows = np.full(tile_budget * g * g, B, np.int64)
        scols = np.zeros(tile_budget * g * g, np.int64)
        srows[:len(rows_idx)], scols[:len(cols_idx)] = rows_idx, cols_idx
        return {"tiles": tiles,
                "tile_segments": _tile_segments(tile_budget, n_tiles),
                "scatter_rows": srows, "scatter_cols": scols}

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return paligemma.init_params(gen, cfg, dtype or precision.param_dtype,
                                     device)

    return ModelBundle(
        logical_axes=lambda: paligemma.logical_axes(cfg),
        family="paligemma", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None:
            paligemma.convert_hf(state, cfg,
                                 dtype=dtype or precision.param_dtype,
                                 device=device),
        apply=apply,
        logits_fn=lambda params, h: paligemma.logits(params, cfg, h,
                                                     precision),
        vision_arrays=vision_arrays,
        preprocess_image=preprocess_image,
        template="paligemma",
        precision=precision,
    )


def pixtral_resize_hw(height: int, width: int, longest_edge: int,
                      patch_size: int) -> tuple[int, int]:
    """transformers' PixtralImageProcessor size: an image longer than
    ``longest_edge`` is scaled to fit, each side FLOORED, then each side
    rounded up to whole patches.  The JAX bundle rounds the scaled sides
    up (``math.ceil``, ROADMAP C.R2), which can add a row or column of
    patches."""
    ratio = max(height / longest_edge, width / longest_edge)
    if ratio > 1:
        height = int(np.floor(height / ratio))
        width = int(np.floor(width / ratio))
    return (-(-height // patch_size) * patch_size,
            -(-width // patch_size) * patch_size)


def make_pixtral_bundle(hf_config: dict, attention: str = "auto",
                        precision: Precision = DEFAULT_PRECISION
                        ) -> ModelBundle:
    """Pixtral: the 2-D-RoPE tower over one packed patch stream (each
    image its own segment, the budget's padding at 0), the LLaVA
    projector, the Mistral decoder with 1-D positions.  HF ships it as
    ``LlavaForConditionalGeneration`` with a pixtral ``vision_config``
    (``make_llava_bundle`` routes here).  Each tower layer is one
    non-causal, segment-masked K1 call over the stream (D = 64 at
    Pixtral-ViT's width); the decoder runs K1-K4.  No shared-prompt
    scoring (none in JAX)."""
    text_hf, vis_hf = hf_config["text_config"], hf_config["vision_config"]
    tcfg = _qwen2_text_cfg(text_hf, attention_bias=False)
    vcfg = pixtral.PixtralVisionConfig(
        hidden_size=vis_hf.get("hidden_size", 1024),
        intermediate_size=vis_hf.get("intermediate_size", 4096),
        num_hidden_layers=vis_hf.get("num_hidden_layers", 24),
        num_attention_heads=vis_hf.get("num_attention_heads", 16),
        image_size=vis_hf.get("image_size", 1024),
        patch_size=vis_hf.get("patch_size", 16),
        rope_theta=vis_hf.get("rope_theta", 10000.0),
    )
    cfg = pixtral.PixtralConfig(
        text=tcfg, vision=vcfg,
        image_token_id=hf_config.get("image_token_index",
                                     hf_config.get("image_token_id", 10)))
    attn = default_attention(attention)
    tower_attn = tower_attention(attention)
    decode_attn = default_decode_attention(attention)
    ps, max_side = vcfg.patch_size, vcfg.max_side
    mean, std = _image_stats(hf_config)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None, lora=None, lora_scale=1.0):
        return pixtral.apply(
            params, cfg, batch["input_ids"], batch["position_ids"],
            **{k: batch.get(k) for k in PIXTRAL_BATCH_KEYS},
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, tower_attention_fn=tower_attn,
            remat=remat, tower_remat=tower_remat, lora=_text_lora(lora),
            lora_scale=lora_scale)

    def preprocess_image(pil, min_pixels=None, max_pixels=None):
        """PIL image -> (patches [rows * cols, patch_dim], (rows, cols),
        (rows, cols)): ``pixtral_resize_hw``, a bicubic resize, OpenAI-CLIP
        statistics (the checkpoint's where ``bundle_from_pretrained`` found
        them).  The feature count is the grid: the pixtral expansion is
        rows of [IMG] with [IMG_BREAK] / [IMG_END], not a flat run."""
        from iadr1_tpu_torch.vision import anyres

        h, w = pixtral_resize_hw(pil.height, pil.width, vcfg.image_size, ps)
        arr = anyres.normalize(anyres.to_array(pil, (h, w)), mean, std)
        patches = anyres.patchify_tiles(arr[None], ps)[0]
        return patches, (h // ps, w // ps), (h // ps, w // ps)

    def vision_arrays(input_ids, patches_list, grids, patch_budget):
        """Host precompute for one batch (numpy): every image's patches in
        one stream of ``patch_budget`` rows, each patch's meshgrid id
        (row * max_side + col) and its image's segment id (1, 2, ...; 0
        for the padding), and the scatter indices of the [IMG] tokens in
        reading order, one patch a token."""
        B = input_ids.shape[0]
        stream = np.zeros((patch_budget, vcfg.patch_dim), np.float32)
        pos = np.zeros(patch_budget, np.int64)
        segs = np.zeros(patch_budget, np.int32)
        off = 0
        for i, (p, (gh, gw)) in enumerate(zip(patches_list, grids)):
            n = p.shape[0]
            if off + n > patch_budget:
                raise ValueError(f"the patch stream exceeds its budget of "
                                 f"{patch_budget}")
            stream[off:off + n] = p
            pos[off:off + n] = (np.arange(gh)[:, None] * max_side
                                + np.arange(gw)).ravel()
            segs[off:off + n] = i + 1
            off += n
        rows_idx, cols_idx = np.nonzero(input_ids == cfg.image_token_id)
        if len(rows_idx) != off:
            raise ValueError(f"{len(rows_idx)} image tokens for {off} "
                             "image features")
        srows = np.full(patch_budget, B, np.int64)
        scols = np.zeros(patch_budget, np.int64)
        srows[:off], scols[:off] = rows_idx, cols_idx
        return {"patch_stream": stream, "patch_pos_ids": pos,
                "patch_segments": segs, "scatter_rows": srows,
                "scatter_cols": scols}

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return pixtral.init_params(gen, cfg, dtype or precision.param_dtype,
                                   device)

    return ModelBundle(
        logical_axes=lambda: pixtral.logical_axes(cfg),
        family="pixtral", cfg=cfg, multimodal=True,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: pixtral.convert_hf(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: pixtral.logits(params, cfg, h, precision),
        vision_arrays=vision_arrays,
        preprocess_image=preprocess_image,
        template="pixtral",
        precision=precision,
    )


FAMILY_BUILDERS = {
    "Qwen2ForCausalLM": make_qwen2_bundle,
    "qwen2": make_qwen2_bundle,
    "Qwen2MoeForCausalLM": make_qwen2_moe_bundle,
    "qwen2_moe": make_qwen2_moe_bundle,
    "Qwen2VLForConditionalGeneration": make_qwen2_vl_bundle,
    "qwen2_vl": make_qwen2_vl_bundle,
    "Qwen2_5_VLForConditionalGeneration": make_qwen25_vl_bundle,
    "qwen2_5_vl": make_qwen25_vl_bundle,
    "LlavaOnevisionForConditionalGeneration": make_llava_onevision_bundle,
    "llava_onevision": make_llava_onevision_bundle,
    "LlavaForConditionalGeneration": make_llava_bundle,
    "LlavaNextForConditionalGeneration": make_llava_bundle,
    "llava": make_llava_bundle,
    "llava_next": make_llava_bundle,
    "LlavaNextVideoForConditionalGeneration": make_llava_bundle,
    "VideoLlavaForConditionalGeneration": make_llava_bundle,
    "llava_next_video": make_llava_bundle,
    "video_llava": make_llava_bundle,
    "InternVLForConditionalGeneration": make_internvl_bundle,
    "internvl": make_internvl_bundle,
    "PaliGemmaForConditionalGeneration": make_paligemma_bundle,
    "paligemma": make_paligemma_bundle,
    "pixtral": make_pixtral_bundle,
}

# ported families whose SC-GRPO path waits for a later slice (none now)
GRPO_NOT_YET_PORTED: dict[str, str] = {}

# families of the JAX package that wait for a later slice (none now)
NOT_YET_PORTED: dict[str, str] = {}


def bundle_from_hf_config(hf_config: dict, **kw) -> ModelBundle:
    names = list(hf_config.get("architectures") or [])
    names.append(hf_config.get("model_type"))
    for name in names:
        if name in FAMILY_BUILDERS:
            return FAMILY_BUILDERS[name](hf_config, **kw)
    for name in names:
        if name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"model family {name} is not ported yet "
                f"({NOT_YET_PORTED[name]})")
    raise ValueError(f"unsupported model family: {names}")


def bundle_from_pretrained(path: str, **kw) -> ModelBundle:
    """Resolve a bundle from a local HF checkpoint directory.  The image
    statistics of its ``preprocessor_config.json`` (``image_mean``,
    ``image_std``), where it has them, go into the config the LLaVA
    families' and InternVL's preprocessing reads (ROADMAP C.R11 and
    C.R13: the JAX package normalises with OpenAI-CLIP's whatever the
    checkpoint says; InternVL-2.5's is ImageNet's)."""
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    proc = os.path.join(path, "preprocessor_config.json")
    if os.path.exists(proc):
        with open(proc) as f:
            stats = json.load(f)
        hf_config.update({k: stats[k] for k in ("image_mean", "image_std")
                          if k in stats})
    return bundle_from_hf_config(hf_config, **kw)


def _image_stats(hf_config: dict):
    """(mean, std) f32 [3] for the anyres, center-crop, InternVL tile and
    Pixtral preprocessing: the checkpoint's own where ``bundle_from_pretrained``
    found them, else OpenAI-CLIP's (HF's LLaVA processors' defaults, and
    the JAX InternVL bundle's)."""
    from iadr1_tpu_torch.vision import anyres

    return (np.asarray(hf_config.get("image_mean", anyres.DEFAULT_MEAN),
                       np.float32),
            np.asarray(hf_config.get("image_std", anyres.DEFAULT_STD),
                       np.float32))
