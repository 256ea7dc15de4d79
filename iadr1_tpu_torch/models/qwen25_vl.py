"""Qwen2.5-VL: windowed ViT tower (RMSNorm pre-norm, biased SwiGLU MLPs) +
RMSNorm/GELU patch merger + the Qwen2 decoder (counterpart of
iadr1_tpu/models/qwen25_vl.py; HF ``Qwen2_5_VLForConditionalGeneration``
semantics, the reference's 3B/7B/72B family).

Most tower blocks attend within windows of ``window_size`` pixels a side,
the blocks of ``fullatt_block_indexes`` over each whole image.  The window
permutation, both segment-id arrays (per image and per window) and the
feature order are host precomputes (``qwen25vl_vision_arrays``): the patch
stream arrives in window order and each block picks, in Python, which
segment array masks its attention.  Either kind is one segment-masked,
non-causal call of the K1 wrapper over the whole stream.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.mesh import (
    compute_view,
    compute_view_of,
    view_gathered_again,
)
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, qwen2
from iadr1_tpu_torch.models.common import dense, rms_norm, rotate_half
from iadr1_tpu_torch.models.params_io import _as_tensor, _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import ckpt
from iadr1_tpu_torch.models.qwen2_vl import merge_image_features


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280            # internal width
    intermediate_size: int = 3420
    out_hidden_size: int = 2048        # text model hidden
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    # a video's temporal M-RoPE step per second (vision/mrope.py); 2 in the
    # published configs and transformers' default
    tokens_per_second: float = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_dim(self) -> int:
        return self.hidden_size * self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    text: qwen2.Qwen2Config
    vision: Qwen25VLVisionConfig
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


# ---------------------------------------------------------------------------
# host precompute: the window permutation and the segment arrays
# ---------------------------------------------------------------------------


def window_partition(grid_thw, cfg: Qwen25VLVisionConfig):
    """-> (patch_perm [P], window_segs [P], feature_order [P // m^2]).

    ``patch_perm`` reorders the patch stream into window order (the
    spatial_merge_size**2 patches of a merged feature move together, as
    HF's get_window_index orders them); ``window_segs`` numbers each
    window 1..; ``feature_order`` is the reading-order index of each
    window-ordered merged feature."""
    m = cfg.spatial_merge_size
    unit = m * m
    win = cfg.window_size // m // cfg.patch_size   # window side in features
    perm_units, window_sizes = [], []
    base = 0
    for t, h, w in grid_thw:
        t, gh, gw = int(t), int(h) // m, int(w) // m
        padded = np.full((t, -(-gh // win) * win, -(-gw // win) * win), -1,
                         np.int64)
        padded[:, :gh, :gw] = np.arange(t * gh * gw).reshape(t, gh, gw)
        nh, nw = padded.shape[1] // win, padded.shape[2] // win
        windows = padded.reshape(t, nh, win, nw, win).transpose(
            0, 1, 3, 2, 4).reshape(t * nh * nw, win * win)
        for row in windows:
            kept = row[row != -1]
            if len(kept):
                perm_units.append(kept + base)
                window_sizes.append(len(kept))
        base += t * gh * gw
    feature_order = np.concatenate(perm_units)
    patch_perm = (feature_order[:, None] * unit + np.arange(unit)).reshape(-1)
    window_segs = np.repeat(np.arange(1, len(window_sizes) + 1),
                            np.asarray(window_sizes) * unit).astype(np.int32)
    return patch_perm.astype(np.int64), window_segs, feature_order


def qwen25vl_vision_arrays(grid_thw, cfg: Qwen25VLVisionConfig,
                           pad_to: int | None = None) -> dict:
    """The tower's host arrays in window order: patch_perm, rot_cos,
    rot_sin, full_segs, window_segs and feature_order, the per-patch ones
    padded to ``pad_to`` patches (cos 1, sin 0, segment 0)."""
    from iadr1_tpu_torch.vision import preprocess as vp

    patch_perm, window_segs, feature_order = window_partition(grid_thw, cfg)
    cos, sin = vp.vision_rotary_tables(grid_thw, cfg.head_dim,
                                       cfg.spatial_merge_size, cfg.rope_theta)
    cos, sin = cos[patch_perm], sin[patch_perm]
    full_segs = vp.vision_segment_ids(grid_thw)[patch_perm]
    pad = (pad_to or 0) - len(patch_perm)
    if pad > 0:
        cos = np.concatenate([cos, np.ones((pad, cos.shape[1]), np.float32)])
        sin = np.concatenate([sin, np.zeros((pad, sin.shape[1]), np.float32)])
        full_segs = np.concatenate([full_segs, np.zeros(pad, np.int32)])
        window_segs = np.concatenate([window_segs, np.zeros(pad, np.int32)])
    return {"patch_perm": patch_perm, "rot_cos": cos, "rot_sin": sin,
            "full_segs": full_segs, "window_segs": window_segs,
            "feature_order": feature_order}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_vision_params(gen, cfg: Qwen25VLVisionConfig, dtype, device) -> dict:
    L, E, I = cfg.depth, cfg.hidden_size, cfg.intermediate_size

    def stack(i, o):
        return torch.stack([common.dense_init(gen, i, o, dtype, device)
                            for _ in range(L)])

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def proj(i, o):
        return {"kernel": stack(i, o), "bias": full((L, o), 0.0)}

    return {
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device)},
        "blocks": {
            "norm1": full((L, E), 1.0),
            "norm2": full((L, E), 1.0),
            "attn": {"qkv": proj(E, 3 * E), "proj": proj(E, E)},
            "mlp": {"gate": proj(E, I), "up": proj(E, I), "down": proj(I, E)},
        },
        "merger": {
            "ln_q": full((E,), 1.0),
            "fc1": {"kernel": common.dense_init(gen, cfg.merge_dim,
                                                cfg.merge_dim, dtype, device),
                    "bias": full((cfg.merge_dim,), 0.0)},
            "fc2": {"kernel": common.dense_init(gen, cfg.merge_dim,
                                                cfg.out_hidden_size, dtype,
                                                device),
                    "bias": full((cfg.out_hidden_size,), 0.0)},
        },
    }


def init_params(gen, cfg: Qwen25VLConfig, dtype, device) -> dict:
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": init_vision_params(gen, cfg.vision, dtype, device),
    }


def convert_vision(state, cfg: Qwen25VLVisionConfig, prefix="visual.",
                   dtype=torch.float32, device=None) -> dict:
    """HF vision-tower tensors -> the tower's parameter dict."""
    device = resolve_device(device)
    bt = prefix + "blocks.{i}."
    kw = dict(dtype=dtype, device=device)

    def stacked(name, transpose=False):
        return _stack_layers(state, bt + name, cfg.depth, transpose, **kw)

    def linear(name):
        return {"kernel": stacked(name + ".weight", True),
                "bias": stacked(name + ".bias")}

    def single(name, transpose=False):
        return _get(state, prefix + name, transpose, **kw)

    pe_w = _as_tensor(state[prefix + "patch_embed.proj.weight"])  # [E,C,t,p,p]
    return {
        "patch_embed": {"kernel": pe_w.to(**kw).reshape(
            pe_w.shape[0], -1).T.contiguous()},
        "blocks": {
            "norm1": stacked("norm1.weight"),
            "norm2": stacked("norm2.weight"),
            "attn": {"qkv": linear("attn.qkv"), "proj": linear("attn.proj")},
            "mlp": {"gate": linear("mlp.gate_proj"),
                    "up": linear("mlp.up_proj"),
                    "down": linear("mlp.down_proj")},
        },
        "merger": {
            "ln_q": single("merger.ln_q.weight"),
            "fc1": {"kernel": single("merger.mlp.0.weight", True),
                    "bias": single("merger.mlp.0.bias")},
            "fc2": {"kernel": single("merger.mlp.2.weight", True),
                    "bias": single("merger.mlp.2.bias")},
        },
    }


def convert_hf(state, cfg: Qwen25VLConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF Qwen2.5-VL state dict (name -> array), under either key layout:
    ``model.language_model.`` / ``model.visual.`` (transformers' own
    modules) or ``model.`` / ``visual.`` (what save_pretrained writes)."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    if any(k.startswith("model.language_model.") for k in state):
        text_prefix, vis_prefix = "model.language_model.", "model.visual."
    else:
        text_prefix, vis_prefix = "model.", "visual."
    return {
        "text": convert_qwen2(state, cfg.text, prefix=text_prefix,
                              dtype=dtype, device=device),
        "vision": convert_vision(state, cfg.vision, prefix=vis_prefix,
                                 dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def _rope(qkv, cos, sin, H: int, D: int):
    """The qkv projection's output [P, 3*H*D] -> q, k, v [1, P, H, D],
    rotary on q and k in f32, then back to the compute dtype."""
    P = qkv.shape[0]
    q, k, v = (t.reshape(1, P, H, D) for t in qkv.chunk(3, dim=-1))
    qf, kf = q.float(), k.float()
    return ((qf * cos + rotate_half(qf) * sin).to(qkv.dtype),
            (kf * cos + rotate_half(kf) * sin).to(qkv.dtype), v)


def _qkv(lp, h, cos, sin, H: int, D: int, eps: float):
    a = lp["attn"]["qkv"]
    x = rms_norm(h, lp["norm1"], eps)
    return _rope(dense(x, a["kernel"], a["bias"]), cos, sin, H, D)


def _swiglu(g, u):
    return F.silu(g) * u


def _post_attention(lp, h, out, eps: float):
    """The attention output [1, P, H, D] through the o-projection and the
    residual, then the SwiGLU MLP block."""
    p, m = lp["attn"]["proj"], lp["mlp"]
    h = h + dense(out.reshape(h.shape[0], -1), p["kernel"], p["bias"])
    x = rms_norm(h, lp["norm2"], eps)
    g = dense(x, m["gate"]["kernel"], m["gate"]["bias"])
    u = dense(x, m["up"]["kernel"], m["up"]["bias"])
    return h + dense(_swiglu(g, u), m["down"]["kernel"], m["down"]["bias"])


def _block(lp, h, cos, sin, attn, H: int, D: int, eps: float):
    """One block.  On a mesh ``lp`` is the block's shards: each piece
    gathers what it reads (``compute_view``), inside its checkpoint under
    a remat mode."""
    lp = compute_view(lp)
    return _post_attention(lp, h, attn(*_qkv(lp, h, cos, sin, H, D, eps)),
                           eps)


def _block_save_flash(lp, h, cos, sin, attn, H: int, D: int, eps: float):
    """The block under remat True (and the decoder's modes the tower
    follows): the attention call stays outside every checkpoint, so the
    flash Function's residuals survive and its forward runs once; the norm,
    projection and rotary before it and the o-projection and MLP after it
    are checkpointed apart."""
    q, k, v = ckpt(lambda h: _qkv(compute_view_of(lp, "norm1", "attn"), h,
                                  cos, sin, H, D, eps), h)
    out = attn(q, k, v)
    return ckpt(lambda h, out: _post_attention(compute_view(lp), h, out,
                                               eps), h, out)


def _block_save_acts(lp, h, cos, sin, attn, H: int, D: int, eps: float):
    """The block under remat "save_acts" (the JAX policy that saves
    "act_qkv", "act_attn" and "act_fc1" besides the flash residuals): the
    qkv projection's output, the attention output and the gate and up
    projections' outputs are kept; the backward recomputes the two norms,
    the rotary and the SwiGLU product, and never the attention forward.
    On a mesh the dense layers' weights are gathered for the forward and
    again for the backward (``view_gathered_again``)."""
    x = ckpt(lambda h: rms_norm(h, compute_view(lp["norm1"]), eps), h)
    with view_gathered_again(lp, "attn", "mlp") as w:
        a, p, m = w["attn"]["qkv"], w["attn"]["proj"], w["mlp"]
        qkv = dense(x, a["kernel"], a["bias"])
        q, k, v = ckpt(lambda t: _rope(t, cos, sin, H, D), qkv)
        out = attn(q, k, v).reshape(h.shape[0], -1)
        h = h + dense(out, p["kernel"], p["bias"])
        x = ckpt(lambda h: rms_norm(h, compute_view(lp["norm2"]), eps), h)
        g = dense(x, m["gate"]["kernel"], m["gate"]["bias"])
        u = dense(x, m["up"]["kernel"], m["up"]["bias"])
        return h + dense(ckpt(_swiglu, g, u), m["down"]["kernel"],
                         m["down"]["bias"])


def apply_vision(
    params: dict,
    cfg: Qwen25VLVisionConfig,
    patches: torch.Tensor,        # [P, patch_dim] in window order
    rot_cos: torch.Tensor,        # [P, head_dim] f32
    rot_sin: torch.Tensor,
    full_segs: torch.Tensor,      # [P] per-image segments, 0 = padding
    window_segs: torch.Tensor,    # [P] per-window segments
    precision: Precision = DEFAULT_PRECISION,
    attention_fn: Callable | None = None,
    remat=False,
) -> torch.Tensor:
    """Window-ordered patch stream -> merged features [P // merge**2,
    out_hidden_size], in window order (the caller's scatter indices follow
    ``feature_order``).  Blocks of ``fullatt_block_indexes`` attend within
    each image, the others within each window, non-causal.

    ``remat``: False; "save_acts" (``_block_save_acts``); any other true
    mode keeps the attention outside the checkpoints
    (``_block_save_flash``).  No mode puts an attention call inside a
    checkpoint."""
    H, D, eps = cfg.num_heads, cfg.head_dim, cfg.rms_norm_eps
    h = dense(patches.to(precision.compute_dtype),
              params["patch_embed"]["kernel"])
    cos = rot_cos.float()[None, :, None, :]
    sin = rot_sin.float()[None, :, None, :]

    def attention(segs):
        segs = segs.to(torch.int32)[None, :]
        mask = ((segs[:, :, None] == segs[:, None, :])
                & (segs[:, None, :] != 0))[:, None]
        if attention_fn is None:
            return lambda q, k, v: common.xla_attention(q, k, v, mask)
        return functools.partial(attention_fn, mask=mask, q_segments=segs,
                                 kv_segments=segs, causal=False)

    full_attn, window_attn = attention(full_segs), attention(window_segs)
    block = (_block_save_acts if remat == "save_acts"
             else _block_save_flash if remat else _block)
    for i, lp in enumerate(qwen2.unstack_layers(params["blocks"], cfg.depth)):
        attn = full_attn if i in cfg.fullatt_block_indexes else window_attn
        h = block(lp, h, cos, sin, attn, H, D, eps)

    m = params["merger"]
    h = rms_norm(h, m["ln_q"], eps).reshape(-1, cfg.merge_dim)
    h = F.gelu(dense(h, m["fc1"]["kernel"], m["fc1"]["bias"]))
    return dense(h, m["fc2"]["kernel"], m["fc2"]["bias"])


# ---------------------------------------------------------------------------
# the VLM
# ---------------------------------------------------------------------------


def apply(
    params: dict,
    cfg: Qwen25VLConfig,
    input_ids: torch.Tensor,           # [B, T]
    position_ids: torch.Tensor,        # [3, B, T] M-RoPE grids
    *,
    patches: torch.Tensor | None = None,
    rot_cos: torch.Tensor | None = None,
    rot_sin: torch.Tensor | None = None,
    full_segs: torch.Tensor | None = None,
    window_segs: torch.Tensor | None = None,
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
                             rot_sin, full_segs, window_segs,
                             precision=precision,
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


def logits(params, cfg: Qwen25VLConfig, hidden, precision=DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def vision_logical_axes(cfg: Qwen25VLVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``vision_logical_axes``)."""
    return {
        "patch_embed": {"kernel": ("patch", "embed")},
        "blocks": {
            "norm1": (None, "norm"),
            "norm2": (None, "norm"),
            "attn": {
                "qkv": {"kernel": (None, "embed", "qkv"),
                        "bias": (None, "qkv")},
                "proj": {"kernel": (None, "heads", "embed"),
                         "bias": (None, "norm")},
            },
            "mlp": {
                "gate": {"kernel": (None, "embed", "mlp"),
                         "bias": (None, "mlp")},
                "up": {"kernel": (None, "embed", "mlp"),
                       "bias": (None, "mlp")},
                "down": {"kernel": (None, "mlp", "embed"),
                         "bias": (None, "norm")},
            },
        },
        "merger": {
            "ln_q": ("norm",),
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
    }


def logical_axes(cfg: Qwen25VLConfig) -> dict:
    return {"text": qwen2.logical_axes(cfg.text),
            "vision": vision_logical_axes(cfg.vision)}
