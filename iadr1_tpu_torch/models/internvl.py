"""InternVL (2.5 class): the InternViT tower, pixel shuffle, an MLP
projector and a Qwen2 decoder (counterpart of iadr1_tpu/models/internvl.py).

HF ``InternVLForConditionalGeneration`` semantics (the reference's
InternVL-2.5-4B family):

* tower: a conv patch embedding with bias, a CLS token and absolute
  position embeddings; pre-norm blocks (layer_norm or rms_norm) with the
  layer scales ``lambda1``/``lambda2``, an optional QK RMSNorm, exact-GELU
  MLPs, and no final norm;
* features: drop CLS, the spatial grid pixel-shuffled down by
  ``downsample_ratio`` (0.5: four times the channels), LayerNorm, then a
  two-layer MLP projector;
* images: aspect-optimal tiling into 448 x 448 tiles (at most 12) plus a
  thumbnail (GOT-OCR2's ``crop_to_patches``, which HF's InternVL processor
  uses), done on the host.

Each tile (448 px: 32 x 32 = 1024 patches + CLS = 1025 tokens) attends
only to itself, non-causal, at head dim 1024 / 16 = 64.  The tiles are the
attention's batch; ``tile_segments`` gives each tile one segment id, 0 for
the zero tiles that pad the stream to its budget, so the kernels skip
those tiles (their features are dropped by the scatter).  The JAX tower
attends densely over every tile, padding included.
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
from iadr1_tpu_torch.models import common, qwen2, siglip
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import ckpt, unstack_layers
from iadr1_tpu_torch.models.qwen2_vl import layer_norm, merge_image_features


@dataclasses.dataclass(frozen=True)
class InternVLVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    attention_bias: bool = True
    use_qk_norm: bool = False
    norm_type: str = "layer_norm"

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


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    text: qwen2.Qwen2Config
    vision: InternVLVisionConfig
    image_token_id: int = 151667
    downsample_ratio: float = 0.5
    min_tiles: int = 1
    max_tiles: int = 12

    @property
    def features_per_tile(self) -> int:
        side = int(self.vision.grid * self.downsample_ratio)
        return side * side


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_vision_params(gen, cfg: InternVLVisionConfig, dtype, device) -> dict:
    L, E, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size

    def stack(i, o):
        return torch.stack([common.dense_init(gen, i, o, dtype, device)
                            for _ in range(L)])

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm():
        out = {"scale": full((L, E), 1.0)}
        if cfg.norm_type == "layer_norm":
            out["bias"] = full((L, E), 0.0)
        return out

    attn = {n: {"kernel": stack(E, E)} for n in "qkvo"}
    attn["o"]["bias"] = full((L, E), 0.0)
    if cfg.attention_bias:
        for n in "qkv":
            attn[n]["bias"] = full((L, E), 0.0)
    if cfg.use_qk_norm:
        attn["q_norm"] = full((L, E), 1.0)
        attn["k_norm"] = full((L, E), 1.0)
    return {
        "cls_token": full((E,), 0.0),
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device),
                        "bias": full((E,), 0.0)},
        "pos_embed": common.embed_init(gen, cfg.num_patches + 1, E, dtype,
                                       device),
        "layers": {
            "norm1": norm(), "norm2": norm(),
            # InternViT's initializer_factor
            "lambda1": full((L, E), 0.1), "lambda2": full((L, E), 0.1),
            "attn": attn,
            "mlp": {"fc1": {"kernel": stack(E, I), "bias": full((L, I), 0.0)},
                    "fc2": {"kernel": stack(I, E), "bias": full((L, E), 0.0)}},
        },
    }


def init_params(gen, cfg: InternVLConfig, dtype, device) -> dict:
    hid = cfg.text.hidden_size
    E4 = cfg.vision.hidden_size * int(1 / cfg.downsample_ratio) ** 2
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": init_vision_params(gen, cfg.vision, dtype, device),
        "projector": {
            "norm": {"scale": torch.ones((E4,), dtype=dtype, device=device),
                     "bias": zeros(E4)},
            "fc1": {"kernel": common.dense_init(gen, E4, hid, dtype, device),
                    "bias": zeros(hid)},
            "fc2": {"kernel": common.dense_init(gen, hid, hid, dtype,
                                                device),
                    "bias": zeros(hid)},
        },
    }


def convert_vision(state, cfg: InternVLVisionConfig,
                   prefix: str = "model.vision_tower.", dtype=torch.float32,
                   device=None) -> dict:
    """HF InternViT tensors (name -> array) under ``prefix`` -> the tower's
    parameter dict."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    lt = prefix + "encoder.layer.{i}."

    def stacked(name, transpose=False):
        return _stack_layers(state, lt + name, cfg.num_hidden_layers,
                             transpose, **kw)

    def norm(name):
        out = {"scale": stacked(name + ".weight")}
        if cfg.norm_type == "layer_norm":
            out["bias"] = stacked(name + ".bias")
        return out

    def linear(name, bias=True):
        out = {"kernel": stacked(name + ".weight", True)}
        if bias:
            out["bias"] = stacked(name + ".bias")
        return out

    attn = {n: linear(f"attention.{n}_proj", cfg.attention_bias)
            for n in "qkv"}
    attn["o"] = linear("attention.projection_layer")
    if cfg.use_qk_norm:
        attn["q_norm"] = stacked("attention.q_norm.weight")
        attn["k_norm"] = stacked("attention.k_norm.weight")
    emb = prefix + "embeddings."
    pe = _get(state, emb + "patch_embeddings.projection.weight", **kw)
    return {
        "cls_token": _get(state, emb + "cls_token", **kw).reshape(-1),
        # the convolution [E, C, ps, ps] with stride = kernel is a dense
        # layer over patches laid out channel first (anyres.patchify_tiles)
        "patch_embed": {
            "kernel": pe.reshape(pe.shape[0], -1).T.contiguous(),
            "bias": _get(state, emb + "patch_embeddings.projection.bias",
                         **kw)},
        "pos_embed": _get(state, emb + "position_embeddings", **kw)[0],
        "layers": {
            "norm1": norm("layernorm_before"),
            "norm2": norm("layernorm_after"),
            "lambda1": stacked("lambda_1"),
            "lambda2": stacked("lambda_2"),
            "attn": attn,
            "mlp": {"fc1": linear("mlp.fc1"), "fc2": linear("mlp.fc2")},
        },
    }


def convert_hf(state, cfg: InternVLConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF InternVL state dict (name -> array), in either key layout
    (``model.language_model.*`` of newer transformers, or
    ``language_model.model.*``) -> parameter dict."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    device = resolve_device(device)
    if any(k.startswith("model.language_model.") for k in state):
        lm, vt, proj = ("model.language_model.", "model.vision_tower.",
                        "model.multi_modal_projector.")
    else:
        lm, vt, proj = ("language_model.model.", "vision_tower.",
                        "multi_modal_projector.")
    kw = dict(dtype=dtype, device=device)

    def linear(name):
        return {"kernel": _get(state, proj + name + ".weight", True, **kw),
                "bias": _get(state, proj + name + ".bias", **kw)}

    return {
        "text": convert_qwen2(state, cfg.text, prefix=lm, **kw),
        "vision": convert_vision(state, cfg.vision, prefix=vt, **kw),
        "projector": {
            "norm": {"scale": _get(state, proj + "layer_norm.weight", **kw),
                     "bias": _get(state, proj + "layer_norm.bias", **kw)},
            "fc1": linear("linear_1"), "fc2": linear("linear_2")},
    }


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def _norm(p, x, cfg: InternVLVisionConfig):
    if cfg.norm_type == "rms_norm":
        return common.rms_norm(x, p["scale"], cfg.layer_norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.layer_norm_eps)


def _project_qkv(lp, x):
    a = lp["attn"]
    return tuple(dense(x, a[n]["kernel"], a[n].get("bias")) for n in "qkv")


def _heads(lp, q, k, v, cfg: InternVLVisionConfig):
    """The QK RMSNorm (over the whole width, where the config has it) and
    the split into heads [N, T, H, D]."""
    if cfg.use_qk_norm:
        a, eps = lp["attn"], cfg.layer_norm_eps
        q = common.rms_norm(q, a["q_norm"], eps)
        k = common.rms_norm(k, a["k_norm"], eps)
    N, T, _ = q.shape
    H, D = cfg.num_attention_heads, cfg.head_dim
    return tuple(t.reshape(N, T, H, D) for t in (q, k, v))


def _attend(lp, h, out):
    """The attention output through the o-projection and ``lambda1``,
    added to ``h``."""
    o = lp["attn"]["o"]
    a = dense(out.reshape(*h.shape[:2], -1), o["kernel"], o["bias"])
    return h + a * lp["lambda1"].to(a.dtype)


def _mlp(lp, x):
    m = lp["mlp"]
    x = F.gelu(dense(x, m["fc1"]["kernel"], m["fc1"]["bias"]))
    return dense(x, m["fc2"]["kernel"], m["fc2"]["bias"])


def _post_attention(lp, h, cfg):
    x = _mlp(lp, _norm(lp["norm2"], h, cfg))
    return h + x * lp["lambda2"].to(x.dtype)


def _block(lp, h, attn, cfg):
    """One block.  On a mesh ``lp`` is the block's shards: each piece
    gathers what it reads (``compute_view``), inside its checkpoint under
    a remat mode."""
    lp = compute_view(lp)
    qkv = _heads(lp, *_project_qkv(lp, _norm(lp["norm1"], h, cfg)), cfg)
    return _post_attention(lp, _attend(lp, h, attn(*qkv)), cfg)


def _block_save_flash(lp, h, attn, cfg):
    """The block under remat True: the attention call stays outside every
    checkpoint, so the flash Function's residuals survive and its forward
    runs once; the norm and projections before it and the o-projection and
    MLP after it are checkpointed apart."""
    def qkv(h):
        w = compute_view_of(lp, "norm1", "attn")
        return _heads(w, *_project_qkv(w, _norm(w["norm1"], h, cfg)), cfg)

    def post(h, out):
        w = compute_view(lp)
        return _post_attention(w, _attend(w, h, out), cfg)

    return ckpt(post, h, attn(*ckpt(qkv, h)))


def _block_save_acts(lp, h, attn, cfg):
    """The block under remat "save_acts" (the JAX policy that saves
    "act_qkv", "act_attn" and "act_fc1"): the q/k/v projections, the
    attention output and the pre-gelu fc1 output are kept; the backward
    recomputes the norms, the QK norm and the activation, never the
    attention forward.  On a mesh the other weights are gathered for the
    forward and again for the backward (``view_gathered_again``); the QK
    norms' checkpoint gathers its own."""
    def qk_norm(q, k, v):
        norms = compute_view_of(lp["attn"], "q_norm", "k_norm")
        return _heads({"attn": norms}, q, k, v, cfg)

    x = ckpt(lambda h: _norm(compute_view(lp["norm1"]), h, cfg), h)
    with view_gathered_again(lp, "attn", "mlp", "lambda1", "lambda2") as w:
        q, k, v = _project_qkv(w, x)
        if cfg.use_qk_norm:
            qkv = ckpt(qk_norm, q, k, v)
        else:
            qkv = _heads(w, q, k, v, cfg)
        h = _attend(w, h, attn(*qkv))
        x = ckpt(lambda h: _norm(compute_view(lp["norm2"]), h, cfg), h)
        m = w["mlp"]
        f = dense(x, m["fc1"]["kernel"], m["fc1"]["bias"])
        y = dense(ckpt(F.gelu, f), m["fc2"]["kernel"], m["fc2"]["bias"])
        return h + y * w["lambda2"].to(y.dtype)


def apply_vision(params: dict, cfg: InternVLVisionConfig,
                 tiles: torch.Tensor,          # [N, num_patches, patch_dim]
                 precision: Precision = DEFAULT_PRECISION, remat=False,
                 attention_fn: Callable | None = None,
                 tile_segments: torch.Tensor | None = None) -> torch.Tensor:
    """Tile batch -> last hidden state [N, num_patches + 1, hidden].

    ``attention_fn`` has the model-level signature (q, k, v, *, mask,
    q_segments, kv_segments, causal), q [N, T, H, D]; it is called once per
    layer over all tiles, each tile its own sequence, non-causal, with
    ``tile_segments`` (``siglip.tile_attention``).  None: the dense oracle
    over every tile.

    ``remat``: False; "save_acts" (``_block_save_acts``); "full" (a plain
    checkpoint of each block, whose backward re-runs the attention
    forward); any other true mode keeps the attention outside the
    checkpoints (``_block_save_flash``)."""
    N = tiles.shape[0]
    pe = params["patch_embed"]
    h = dense(tiles.to(precision.compute_dtype), pe["kernel"], pe["bias"])
    cls = params["cls_token"].to(h.dtype)[None, None, :].expand(
        N, 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1)
    h = h + params["pos_embed"][None].to(h.dtype)
    attn = siglip.tile_attention(attention_fn, tile_segments, N, h.shape[1])
    for lp in unstack_layers(params["layers"], cfg.num_hidden_layers):
        if remat == "full":
            h = ckpt(functools.partial(_block, lp, attn=attn, cfg=cfg), h)
        elif remat == "save_acts":
            h = _block_save_acts(lp, h, attn, cfg)
        elif remat:
            h = _block_save_flash(lp, h, attn, cfg)
        else:
            h = _block(lp, h, attn, cfg)
    return h


def pixel_shuffle(features: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[N, W, H, C] -> [N, W*s, H*s, C/s^2] (HF InternVL's ordering)."""
    N, W, H, C = features.shape
    x = features.reshape(N, W, int(H * scale), int(C / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(N, int(H * scale), int(W * scale), int(C / scale ** 2))
    return x.permute(0, 2, 1, 3)


def image_features(params, cfg: InternVLConfig, tiles,
                   precision: Precision = DEFAULT_PRECISION, remat=False,
                   attention_fn: Callable | None = None,
                   tile_segments=None) -> torch.Tensor:
    """Tiles -> projected features [N * features_per_tile, hid]: CLS
    dropped, pixel shuffle, LayerNorm (eps 1e-5), fc1 -> GELU -> fc2."""
    h = apply_vision(params["vision"], cfg.vision, tiles, precision, remat,
                     attention_fn, tile_segments)[:, 1:]
    N, C, E = h.shape
    f = int(C ** 0.5)
    h = pixel_shuffle(h.reshape(N, f, f, E), cfg.downsample_ratio)
    h = h.reshape(N, -1, h.shape[-1])
    p = params["projector"]
    h = layer_norm(h, p["norm"]["scale"], p["norm"]["bias"], 1e-5)
    h = F.gelu(dense(h, p["fc1"]["kernel"], p["fc1"]["bias"]))
    h = dense(h, p["fc2"]["kernel"], p["fc2"]["bias"])
    return h.reshape(-1, h.shape[-1])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def compute_embeds(params, cfg: InternVLConfig, input_ids, *, tiles=None,
                   tile_segments=None, scatter_rows=None, scatter_cols=None,
                   precision: Precision = DEFAULT_PRECISION,
                   tower_attention_fn: Callable | None = None,
                   tower_remat=False):
    """Token embeddings with the InternViT features scattered onto the
    image tokens (features of padding tiles target the dropped row B)."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    if tiles is None:
        return embeds
    feats = image_features(params, cfg, tiles, precision, tower_remat,
                           tower_attention_fn, tile_segments)
    return merge_image_features(embeds, feats, scatter_rows, scatter_cols)


def apply(params: dict, cfg: InternVLConfig,
          input_ids: torch.Tensor,             # [B, T]
          position_ids: torch.Tensor,          # [B, T]
          *, tiles=None, tile_segments=None, scatter_rows=None,
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
        scatter_rows=scatter_rows, scatter_cols=scatter_cols,
        precision=precision, tower_attention_fn=tower_attention_fn,
        tower_remat=remat if tower_remat is None else tower_remat)
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids, segment_ids=segment_ids, cache=cache,
        cache_mode=cache_mode, precision=precision, attention_fn=attention_fn,
        decode_attention_fn=decode_attention_fn, remat=remat, lora=lora,
        lora_scale=lora_scale)


def logits(params, cfg: InternVLConfig, hidden,
           precision: Precision = DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# dynamic tiling (host)
# ---------------------------------------------------------------------------


def optimal_tile_grid(height: int, width: int, tile: int, min_tiles: int,
                      max_tiles: int) -> tuple[int, int]:
    """(columns, rows) whose aspect ratio is closest to the image's
    (GOT-OCR2's ``get_optimal_tiled_canvas``): among equally close grids,
    a larger one wins while the image covers more than half of it."""
    grids = sorted(((c, r) for c in range(1, max_tiles + 1)
                    for r in range(1, max_tiles + 1)
                    if min_tiles <= c * r <= max_tiles),
                   key=lambda g: g[0] * g[1])
    aspect, area = width / height, width * height
    best, best_diff = (1, 1), float("inf")
    for cols, rows in grids:
        diff = abs(aspect - cols / rows)
        if diff < best_diff:
            best_diff, best = diff, (cols, rows)
        elif diff == best_diff and area > 0.5 * tile * tile * cols * rows:
            best = (cols, rows)
    return best


def internvl_tiles(image, tile_size: int = 448, min_tiles: int = 1,
                   max_tiles: int = 12, use_thumbnail: bool = True,
                   mean=None, std=None):
    """PIL image -> (tiles [n, 3, ts, ts] normalized, n): the aspect-optimal
    grid, a bicubic squash to the tile canvas, row-major crops, and the
    whole image squashed into one more tile last when there is more than
    one.  ``mean``/``std`` default to OpenAI-CLIP's statistics, the JAX
    package's (the published InternVL-2.5 preprocessing uses ImageNet's,
    which ``registry.bundle_from_pretrained`` reads from a checkpoint's
    preprocessor_config.json: ROADMAP C.R13)."""
    from PIL import Image

    from iadr1_tpu_torch.vision.anyres import DEFAULT_MEAN, DEFAULT_STD

    mean = DEFAULT_MEAN if mean is None else np.asarray(mean, np.float32)
    std = DEFAULT_STD if std is None else np.asarray(std, np.float32)
    if image.mode != "RGB":
        image = image.convert("RGB")
    cols, rows = optimal_tile_grid(image.height, image.width, tile_size,
                                   min_tiles, max_tiles)
    resized = image.resize((cols * tile_size, rows * tile_size),
                           resample=Image.Resampling.BICUBIC)
    arr = np.asarray(resized, np.float32) / 255.0
    tiles = [arr[r * tile_size:(r + 1) * tile_size,
                 c * tile_size:(c + 1) * tile_size]
             for r in range(rows) for c in range(cols)]
    if use_thumbnail and len(tiles) != 1:
        thumb = image.resize((tile_size, tile_size),
                             resample=Image.Resampling.BICUBIC)
        tiles.append(np.asarray(thumb, np.float32) / 255.0)
    out = (np.stack(tiles) - mean) / std
    return out.transpose(0, 3, 1, 2), len(tiles)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def vision_logical_axes(cfg: InternVLVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``vision_logical_axes``)."""
    def norm():
        out = {"scale": (None, "norm")}
        if cfg.norm_type == "layer_norm":
            out["bias"] = (None, "norm")
        return out

    axes = {
        "cls_token": ("norm",),
        "patch_embed": {"kernel": ("patch", "embed"), "bias": ("norm",)},
        "pos_embed": (None, "embed"),
        "layers": {
            "norm1": norm(),
            "norm2": norm(),
            "lambda1": (None, "norm"),
            "lambda2": (None, "norm"),
            "attn": {
                "q": {"kernel": (None, "embed", "heads")},
                "k": {"kernel": (None, "embed", "heads")},
                "v": {"kernel": (None, "embed", "heads")},
                "o": {"kernel": (None, "heads", "embed"),
                      "bias": (None, "norm")},
            },
            "mlp": {
                "fc1": {"kernel": (None, "embed", "mlp"),
                        "bias": (None, "mlp")},
                "fc2": {"kernel": (None, "mlp", "embed"),
                        "bias": (None, "norm")},
            },
        },
    }
    if cfg.attention_bias:
        for name in ("q", "k", "v"):
            axes["layers"]["attn"][name]["bias"] = (None, "heads")
    if cfg.use_qk_norm:
        axes["layers"]["attn"]["q_norm"] = (None, "norm")
        axes["layers"]["attn"]["k_norm"] = (None, "norm")
    return axes


def logical_axes(cfg: InternVLConfig) -> dict:
    return {
        "text": qwen2.logical_axes(cfg.text),
        "vision": vision_logical_axes(cfg.vision),
        "projector": {
            "norm": {"scale": ("norm",), "bias": ("norm",)},
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
    }
