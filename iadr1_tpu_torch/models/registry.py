"""Model bundles (counterpart of iadr1_tpu/models/registry.py) for the two
families of the serving slice: Qwen2 (text) and Qwen2-VL.

A bundle carries the config and the functions the rollout engine, the
generator and the SFT step call: ``apply(params, batch, cache=None,
cache_mode=..., remat=False)``, ``hidden_fn(params, batch, remat=True)``,
``head_kernel_fn(params)``, ``logits_fn(params, hidden)``,
``shared_pred_fn(params, batch, group_size, remat=True)`` (GRPO's
shared-prompt scoring), ``init_params(seed, dtype, device)``,
``convert_hf(state, dtype, device)`` and, for Qwen2-VL, the host-side
``vision_arrays`` and ``preprocess_image``.
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
from iadr1_tpu_torch.models import common, qwen2, qwen2_vl
from iadr1_tpu_torch.models.attention import (
    default_attention,
    default_attention_with_lse,
    default_decode_attention,
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
    # shared-prompt GRPO scoring (models/shared_prompt.py): (params, batch,
    # group_size, remat=True) -> the hidden states [n*G, N, hid] that
    # predict the completion tokens; None for a family with no such path
    shared_pred_fn: Callable | None = None

    # the training path: final hidden states and the LM-head kernel for
    # the chunked CE loss (train/sft.py); extra kwargs (tower_remat=) pass
    # through to apply
    def hidden_fn(self, params, batch, remat=True, **kw):
        h, _ = self.apply(params, batch, remat=remat, **kw)
        return h

    def head_kernel_fn(self, params):
        tcfg = getattr(self.cfg, "text", self.cfg)
        return qwen2.head_kernel(params.get("text", params), tcfg)


def _generator(seed: int, device) -> tuple[torch.Generator, torch.device]:
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed), device


def _qwen2_text_cfg(hf: dict) -> qwen2.Qwen2Config:
    rs = hf.get("rope_scaling") or {}
    if rs.get("rope_type", rs.get("type")) not in (None, "mrope", "default"):
        raise NotImplementedError(
            "RoPE scaling is not ported yet (ROADMAP A.13)")
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
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        mrope_section=(tuple(rs["mrope_section"]) if "mrope_section" in rs
                       else None),
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
                     n_feat_budget: int):
    """Feature -> (row, col) scatter indices in reading order; padded
    features target the sentinel row B (dropped by merge_image_features)."""
    B = input_ids.shape[0]
    rows_idx, cols_idx = np.nonzero(input_ids == image_token_id)
    if len(rows_idx) > n_feat_budget:
        raise ValueError(
            f"{len(rows_idx)} image tokens exceed the feature budget "
            f"{n_feat_budget}")
    srows = np.full(n_feat_budget, B, np.int64)
    scols = np.zeros(n_feat_budget, np.int64)
    srows[: len(rows_idx)] = rows_idx
    scols[: len(cols_idx)] = cols_idx
    return srows, scols


def make_qwen2_bundle(hf_config: dict, attention: str = "auto",
                      precision: Precision = DEFAULT_PRECISION) -> ModelBundle:
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    cfg = _qwen2_text_cfg(hf_config)
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False):
        return qwen2.apply(
            params, cfg, batch["input_ids"],
            position_ids=batch["position_ids"],
            segment_ids=batch.get("segment_ids"), cache=cache,
            cache_mode=cache_mode, precision=precision, attention_fn=attn,
            decode_attention_fn=decode_attn, remat=remat,
        )

    def init_params(seed=0, dtype=None, device=None):
        gen, device = _generator(seed, device)
        return qwen2.init_params(gen, cfg, dtype or precision.param_dtype,
                                 device)

    attn_lse = default_attention_with_lse(attention)

    def shared_pred(params, batch, group_size, remat=True):
        return shared_prompt_pred_hidden(
            params, cfg, batch, group_size, attention_fn=attn_lse,
            precision=precision, remat=remat)

    return ModelBundle(
        family="qwen2", cfg=cfg, multimodal=False,
        init_params=init_params,
        convert_hf=lambda state, dtype=None, device=None: convert_qwen2(
            state, cfg, dtype=dtype or precision.param_dtype, device=device),
        apply=apply,
        logits_fn=lambda params, h: qwen2.logits(params, cfg, h, precision),
        template="chatml",
        shared_pred_fn=shared_pred, precision=precision,
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
    )
    attn = default_attention(attention)
    decode_attn = default_decode_attention(attention)

    def apply(params, batch, cache=None, cache_mode="extend", remat=False,
              tower_remat=None):
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
            remat=remat, tower_remat=tower_remat,
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
        srows, scols = _scatter_indices(input_ids, cfg.image_token_id,
                                        patch_budget // merge_unit)
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

    def shared_pred(params, batch, group_size, remat=True):
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
            precision=precision, remat=remat, prompt_embeds=embeds)

    return ModelBundle(
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


FAMILY_BUILDERS = {
    "Qwen2ForCausalLM": make_qwen2_bundle,
    "qwen2": make_qwen2_bundle,
    "Qwen2VLForConditionalGeneration": make_qwen2_vl_bundle,
    "qwen2_vl": make_qwen2_vl_bundle,
}

# families of the JAX package that wait for a later slice
NOT_YET_PORTED = {
    "Qwen2_5_VLForConditionalGeneration": "ROADMAP A.10",
    "qwen2_5_vl": "ROADMAP A.10",
    "LlavaOnevisionForConditionalGeneration": "ROADMAP A.9",
    "llava_onevision": "ROADMAP A.9",
    "Qwen2MoeForCausalLM": "ROADMAP A.13",
    "qwen2_moe": "ROADMAP A.13",
    "LlavaForConditionalGeneration": "ROADMAP A.13",
    "LlavaNextForConditionalGeneration": "ROADMAP A.13",
    "LlavaNextVideoForConditionalGeneration": "ROADMAP A.13",
    "VideoLlavaForConditionalGeneration": "ROADMAP A.13",
    "llava": "ROADMAP A.13",
    "llava_next": "ROADMAP A.13",
    "llava_next_video": "ROADMAP A.13",
    "video_llava": "ROADMAP A.13",
    "InternVLForConditionalGeneration": "ROADMAP A.13",
    "internvl": "ROADMAP A.13",
    "PaliGemmaForConditionalGeneration": "ROADMAP A.13",
    "paligemma": "ROADMAP A.13",
    "pixtral": "ROADMAP A.13",
}


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
    """Resolve a bundle from a local HF checkpoint directory."""
    with open(os.path.join(path, "config.json")) as f:
        return bundle_from_hf_config(json.load(f), **kw)
