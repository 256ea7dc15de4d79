"""Qwen2-VL: dynamic-resolution ViT tower + patch merger + Qwen2 decoder
(counterpart of iadr1_tpu/models/qwen2_vl.py).

The patch stream is padded to a static budget and the tower's attention is
masked by per-image segment ids, non-causal, through the K1 wrapper.
Rotary tables, segment ids, scatter indices and M-RoPE grids are numpy
host precomputes (``iadr1_tpu_torch/vision/``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.mesh import (
    compute_view,
    run_replicated,
    view_gathered_again,
)
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, qwen2
from iadr1_tpu_torch.models.common import dense, rotate_half
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.models.params_io import _as_tensor, _get, _stack_layers


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 1536            # output dim (text model hidden)
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: float = 4.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: qwen2.Qwen2Config
    vision: Qwen2VLVisionConfig
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    video_token_id: int = 151656


def layer_norm(x, scale, bias, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def init_vision_params(gen, cfg: Qwen2VLVisionConfig, dtype, device) -> dict:
    L, E, M = cfg.depth, cfg.embed_dim, cfg.mlp_dim

    def stack(i, o):
        return torch.stack([common.dense_init(gen, i, o, dtype, device)
                            for _ in range(L)])

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm(shape):
        return {"scale": full(shape, 1.0), "bias": full(shape, 0.0)}

    return {
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device)},
        "blocks": {
            "norm1": norm((L, E)),
            "norm2": norm((L, E)),
            "attn": {
                "qkv": {"kernel": stack(E, 3 * E), "bias": full((L, 3 * E), 0.0)},
                "proj": {"kernel": stack(E, E), "bias": full((L, E), 0.0)},
            },
            "mlp": {
                "fc1": {"kernel": stack(E, M), "bias": full((L, M), 0.0)},
                "fc2": {"kernel": stack(M, E), "bias": full((L, E), 0.0)},
            },
        },
        "merger": {
            "ln_q": norm((E,)),
            "fc1": {"kernel": common.dense_init(gen, cfg.merge_dim,
                                                cfg.merge_dim, dtype, device),
                    "bias": full((cfg.merge_dim,), 0.0)},
            "fc2": {"kernel": common.dense_init(gen, cfg.merge_dim,
                                                cfg.hidden_size, dtype, device),
                    "bias": full((cfg.hidden_size,), 0.0)},
        },
    }


def init_params(gen, cfg: Qwen2VLConfig, dtype, device) -> dict:
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": init_vision_params(gen, cfg.vision, dtype, device),
    }


def _tower_attention(lp, x, cos, sin, attn, H: int, D: int, dtype):
    """Normed hidden -> qkv projection, rotary in f32, attention
    -> [P, H*D]."""
    P = x.shape[0]
    qkv = dense(x, lp["attn"]["qkv"]["kernel"], lp["attn"]["qkv"]["bias"])
    q, k, v = (t.reshape(1, P, H, D) for t in qkv.chunk(3, dim=-1))
    # rotary in f32, then back to the compute dtype
    qf, kf = q.float(), k.float()
    q = (qf * cos + rotate_half(qf) * sin).to(dtype)
    k = (kf * cos + rotate_half(kf) * sin).to(dtype)
    return attn(q, k, v).reshape(P, H * D)


def _tower_block(lp, h, cos, sin, attn, H: int, D: int):
    """One block.  On a mesh ``lp`` is the block's shards, gathered here
    (``compute_view``): inside the block's checkpoint under remat."""
    lp = compute_view(lp)
    x = layer_norm(h, lp["norm1"]["scale"], lp["norm1"]["bias"])
    out = _tower_attention(lp, x, cos, sin, attn, H, D, h.dtype)
    h = h + dense(out, lp["attn"]["proj"]["kernel"], lp["attn"]["proj"]["bias"])
    x = layer_norm(h, lp["norm2"]["scale"], lp["norm2"]["bias"])
    x = quick_gelu(dense(x, lp["mlp"]["fc1"]["kernel"], lp["mlp"]["fc1"]["bias"]))
    return h + dense(x, lp["mlp"]["fc2"]["kernel"], lp["mlp"]["fc2"]["bias"])


def _tower_block_save_acts(lp, h, cos, sin, attn, H: int, D: int):
    """The block under remat "save_acts": the flash Function's residuals
    and the dense layers' inputs (the qkv and fc1 inputs, the attention
    output, the fc1 output and its gelu) are kept; the backward recomputes
    only the two layer norms and the gelu, and never the attention
    forward.  On a mesh each norm's checkpoint gathers its weights, and
    the dense layers' weights are gathered for the forward and again for
    the backward (``view_gathered_again``)."""
    def norm(key, h):
        n = compute_view(lp[key])
        return layer_norm(h, n["scale"], n["bias"])

    x = ckpt(functools.partial(norm, "norm1"), h)
    with view_gathered_again(lp, "attn", "mlp") as w:
        out = _tower_attention(w, x, cos, sin, attn, H, D, h.dtype)
        h = h + dense(out, w["attn"]["proj"]["kernel"],
                      w["attn"]["proj"]["bias"])
        x = ckpt(functools.partial(norm, "norm2"), h)
        f = dense(x, w["mlp"]["fc1"]["kernel"], w["mlp"]["fc1"]["bias"])
        return h + dense(ckpt(quick_gelu, f), w["mlp"]["fc2"]["kernel"],
                         w["mlp"]["fc2"]["bias"])


def apply_vision(
    params: dict,
    cfg: Qwen2VLVisionConfig,
    patches: torch.Tensor,        # [P, patch_dim] (padded to the budget)
    rot_cos: torch.Tensor,        # [P, head_dim] f32
    rot_sin: torch.Tensor,
    segment_ids: torch.Tensor,    # [P] 1-based per image, 0 = padding
    precision: Precision = DEFAULT_PRECISION,
    attention_fn: Callable | None = None,
    remat=False,
) -> torch.Tensor:
    """Patch stream -> merged image features [P // merge**2, hidden_size];
    attention stays within each image (segment ids, non-causal).

    ``remat``: False; True (a plain checkpoint of each block, whose
    backward re-runs the attention forward, as in JAX); or "save_acts"
    (``_tower_block_save_acts``).  Any other true mode (a decoder mode
    that the tower follows) is a plain checkpoint, as in JAX."""
    H, D = cfg.num_heads, cfg.head_dim
    h = dense(patches.to(precision.compute_dtype),
              params["patch_embed"]["kernel"])
    cos = rot_cos.float()[None, :, None, :]
    sin = rot_sin.float()[None, :, None, :]
    segs = segment_ids.to(torch.int32)[None, :]
    seg_mask = ((segs[:, :, None] == segs[:, None, :])
                & (segs[:, None, :] != 0))[:, None]
    if attention_fn is None:
        attn = lambda q, k, v: common.xla_attention(q, k, v, seg_mask)
    else:
        attn = functools.partial(attention_fn, mask=seg_mask, q_segments=segs,
                                 kv_segments=segs, causal=False)

    for lp in qwen2.unstack_layers(params["blocks"], cfg.depth):
        if remat == "save_acts":
            h = _tower_block_save_acts(lp, h, cos, sin, attn, H, D)
        elif remat:
            # partial binds this layer: the replay runs after the loop
            h = ckpt(functools.partial(_tower_block, lp, cos=cos, sin=sin,
                                       attn=attn, H=H, D=D), h)
        else:
            h = _tower_block(lp, h, cos, sin, attn, H, D)

    m = params["merger"]
    h = layer_norm(h, m["ln_q"]["scale"], m["ln_q"]["bias"])
    h = h.reshape(-1, cfg.merge_dim)
    h = F.gelu(dense(h, m["fc1"]["kernel"], m["fc1"]["bias"]))
    return dense(h, m["fc2"]["kernel"], m["fc2"]["bias"])


def merge_image_features(inputs_embeds, image_features, scatter_rows,
                         scatter_cols):
    """Scatter image features into the token stream at image-token slots;
    padded features target the sentinel row B, which is dropped.  Under
    tp (DTensors) the scatter runs on the replicated local copies."""
    return run_replicated(_merge_image_features, inputs_embeds,
                          image_features, scatter_rows, scatter_cols)


def _merge_image_features(inputs_embeds, image_features, scatter_rows,
                          scatter_cols):
    B, T, Hd = inputs_embeds.shape
    padded = torch.zeros((B + 1, T, Hd), dtype=inputs_embeds.dtype,
                         device=inputs_embeds.device)
    padded[:B] = inputs_embeds
    padded[scatter_rows.long(), scatter_cols.long()] = image_features.to(
        inputs_embeds.dtype)
    return padded[:B]


def apply(
    params: dict,
    cfg: Qwen2VLConfig,
    input_ids: torch.Tensor,           # [B, T]
    position_ids: torch.Tensor,        # [3, B, T] M-RoPE grids
    *,
    patches: torch.Tensor | None = None,
    rot_cos: torch.Tensor | None = None,
    rot_sin: torch.Tensor | None = None,
    vision_segments: torch.Tensor | None = None,
    scatter_rows: torch.Tensor | None = None,
    scatter_cols: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    cache: dict | None = None,
    cache_mode: str = "extend",
    precision: Precision = DEFAULT_PRECISION,
    attention_fn: Callable | None = None,
    decode_attention_fn: Callable | None = None,
    vision_attention_fn: Callable | None = None,
    remat=False,
    tower_remat=None,
    lora: dict | None = None,
    lora_scale: float = 1.0,
):
    """Full VLM forward -> (hidden [B, T, hid], cache).  ``remat`` is the
    decoder's mode; ``tower_remat`` the tower's, following ``remat`` when
    None, as in the JAX apply.  ``lora`` is the decoder's adapter tree
    (the "text" subtree of a whole-model one); the tower takes none."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    if patches is not None:
        feats = apply_vision(params["vision"], cfg.vision, patches, rot_cos,
                             rot_sin, vision_segments, precision=precision,
                             attention_fn=vision_attention_fn,
                             remat=remat if tower_remat is None else tower_remat)
        embeds = merge_image_features(embeds, feats, scatter_rows,
                                      scatter_cols)
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids, segment_ids=segment_ids, cache=cache,
        cache_mode=cache_mode, precision=precision, attention_fn=attention_fn,
        decode_attention_fn=decode_attention_fn, remat=remat, lora=lora,
        lora_scale=lora_scale,
    )


def logits(params, cfg: Qwen2VLConfig, hidden, precision=DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


def convert_vision(state, cfg: Qwen2VLVisionConfig, prefix="visual.",
                   dtype=torch.float32, device=None) -> dict:
    """HF vision-tower tensors -> the tower's parameter dict."""
    device = resolve_device(device)
    L = cfg.depth
    bt = prefix + "blocks.{i}."
    kw = dict(dtype=dtype, device=device)

    def stacked(name, transpose=False):
        return _stack_layers(state, bt + name, L, transpose, **kw)

    def single(name, transpose=False):
        return _get(state, prefix + name, transpose, **kw)

    pe_w = _as_tensor(state[prefix + "patch_embed.proj.weight"])  # [E,C,t,p,p]
    return {
        "patch_embed": {"kernel": pe_w.to(**kw).reshape(
            pe_w.shape[0], -1).T.contiguous()},
        "blocks": {
            "norm1": {"scale": stacked("norm1.weight"),
                      "bias": stacked("norm1.bias")},
            "norm2": {"scale": stacked("norm2.weight"),
                      "bias": stacked("norm2.bias")},
            "attn": {
                "qkv": {"kernel": stacked("attn.qkv.weight", True),
                        "bias": stacked("attn.qkv.bias")},
                "proj": {"kernel": stacked("attn.proj.weight", True),
                         "bias": stacked("attn.proj.bias")},
            },
            "mlp": {
                "fc1": {"kernel": stacked("mlp.fc1.weight", True),
                        "bias": stacked("mlp.fc1.bias")},
                "fc2": {"kernel": stacked("mlp.fc2.weight", True),
                        "bias": stacked("mlp.fc2.bias")},
            },
        },
        "merger": {
            "ln_q": {"scale": single("merger.ln_q.weight"),
                     "bias": single("merger.ln_q.bias")},
            "fc1": {"kernel": single("merger.mlp.0.weight", True),
                    "bias": single("merger.mlp.0.bias")},
            "fc2": {"kernel": single("merger.mlp.2.weight", True),
                    "bias": single("merger.mlp.2.bias")},
        },
    }


def convert_hf(state, cfg: Qwen2VLConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF Qwen2-VL state dict (name -> numpy array) -> parameter dict."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    if any(k.startswith("model.language_model.") for k in state):
        text_prefix, vis_prefix = "model.language_model.", "model.visual."
    elif any(k.startswith("language_model.") for k in state):
        text_prefix, vis_prefix = "language_model.model.", "visual."
    else:
        text_prefix, vis_prefix = "model.", "visual."
    return {
        "text": convert_qwen2(state, cfg.text, prefix=text_prefix,
                              dtype=dtype, device=device),
        "vision": convert_vision(state, cfg.vision, prefix=vis_prefix,
                                 dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def vision_logical_axes(cfg: Qwen2VLVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``vision_logical_axes``)."""
    return {
        "patch_embed": {"kernel": ("patch", "embed")},
        "blocks": {
            "norm1": {"scale": (None, "norm"), "bias": (None, "norm")},
            "norm2": {"scale": (None, "norm"), "bias": (None, "norm")},
            "attn": {
                "qkv": {"kernel": (None, "embed", "qkv"),
                        "bias": (None, "qkv")},
                "proj": {"kernel": (None, "heads", "embed"),
                         "bias": (None, "norm")},
            },
            "mlp": {
                "fc1": {"kernel": (None, "embed", "mlp"),
                        "bias": (None, "mlp")},
                "fc2": {"kernel": (None, "mlp", "embed"),
                        "bias": (None, "norm")},
            },
        },
        "merger": {
            "ln_q": {"scale": ("norm",), "bias": ("norm",)},
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
    }


def logical_axes(cfg: Qwen2VLConfig) -> dict:
    return {"text": qwen2.logical_axes(cfg.text),
            "vision": vision_logical_axes(cfg.vision)}
