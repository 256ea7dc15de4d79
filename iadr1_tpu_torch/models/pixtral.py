"""Pixtral: the variable-resolution 2-D-RoPE vision tower, the LLaVA
projector and the Mistral decoder (the Qwen2 module with
``attention_bias=False``), counterpart of iadr1_tpu/models/pixtral.py.

HF ``LlavaForConditionalGeneration`` with a ``PixtralVisionModel`` tower:
a patch convolution without bias over images of any patch-multiple size,
``ln_pre`` RMSNorm (eps 1e-5), pre-norm layers (RMSNorm, unbiased q/k/v/o,
silu-gated MLP) with 2-D rotary embeddings indexed by each patch's (row,
col) in a ``max_side`` meshgrid, and no final norm.  Every image attends
within itself only.

The host packs all images of a batch into one patch stream with each
patch's meshgrid position id and its image's segment id (0 pads the
stream to its budget); each tower layer's attention is ONE non-causal,
segment-masked call of the port's dispatch over the whole stream, K1 on
the card.  The projector's features land on the ``[IMG]`` tokens only
(``[IMG_BREAK]`` and ``[IMG_END]`` stay text).
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
from iadr1_tpu_torch.models import common, llava, qwen2
from iadr1_tpu_torch.models.common import apply_rope, dense, rms_norm
from iadr1_tpu_torch.models.params_io import _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import ckpt, unstack_layers
from iadr1_tpu_torch.models.qwen2_vl import merge_image_features

_NORM_EPS = 1e-5        # fixed in HF's PixtralAttentionLayer and ln_pre


@dataclasses.dataclass(frozen=True)
class PixtralVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 1024        # the longest edge; inputs vary
    patch_size: int = 16
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def max_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class PixtralConfig:
    text: qwen2.Qwen2Config
    vision: PixtralVisionConfig
    image_token_id: int = 10


def rope_half_table(cfg: PixtralVisionConfig) -> np.ndarray:
    """[max_side**2, head_dim // 2] f32 2-D rotary half-frequencies (HF
    PixtralRotaryEmbedding): the row position drives the even base
    frequencies, the column position the odd ones, concatenated; indexed
    by the flat position id row * max_side + col."""
    d = cfg.head_dim
    freqs = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2, np.float64) / d)
    s = cfg.max_side
    pos = np.arange(s, dtype=np.float64)
    fh = np.outer(pos, freqs[0::2])                   # [s, d/4]
    fw = np.outer(pos, freqs[1::2])                   # [s, d/4]
    table = np.concatenate(
        [np.broadcast_to(fh[:, None, :], (s, s, fh.shape[1])),
         np.broadcast_to(fw[None, :, :], (s, s, fw.shape[1]))],
        axis=-1).reshape(s * s, d // 2)
    return table.astype(np.float32)


def init_tower_params(gen, cfg: PixtralVisionConfig, dtype, device) -> dict:
    L, E, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size

    def stack(i, o):
        return {"kernel": torch.stack([common.dense_init(gen, i, o, dtype,
                                                         device)
                                       for _ in range(L)])}

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device)},
        "ln_pre": ones((E,)),
        "layers": {
            "attention_norm": ones((L, E)),
            "ffn_norm": ones((L, E)),
            "attn": {name: stack(E, E) for name in "qkvo"},
            "mlp": {"gate": stack(E, I), "up": stack(E, I),
                    "down": stack(I, E)},
        },
    }


def convert_tower_hf(state, cfg: PixtralVisionConfig,
                     prefix: str = "vision_tower.", dtype=torch.float32,
                     device=None) -> dict:
    """HF PixtralVisionModel tensors under ``prefix`` -> the tower's
    parameter dict."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    lt = prefix + "transformer.layers.{i}."

    def stacked(name, transpose=False):
        return _stack_layers(state, lt + name, cfg.num_hidden_layers,
                             transpose, **kw)

    def linear(name):
        return {"kernel": stacked(name + ".weight", True)}

    pe = _get(state, prefix + "patch_conv.weight", **kw)
    return {
        # the convolution [E, C, ps, ps] with stride = kernel and no bias
        # is a dense layer over channel-first patches
        "patch_embed": {"kernel": pe.reshape(pe.shape[0], -1).T.contiguous()},
        "ln_pre": _get(state, prefix + "ln_pre.weight", **kw),
        "layers": {
            "attention_norm": stacked("attention_norm.weight"),
            "ffn_norm": stacked("ffn_norm.weight"),
            "attn": {n: linear(f"attention.{n}_proj") for n in "qkvo"},
            "mlp": {n: linear(f"feed_forward.{n}_proj")
                    for n in ("gate", "up", "down")},
        },
    }


def _qkv(lp, h, cos, sin, H: int, D: int):
    x = rms_norm(h, lp["attention_norm"], _NORM_EPS)
    a = lp["attn"]
    B, N, _ = x.shape
    q, k, v = (dense(x, a[n]["kernel"]).reshape(B, N, H, D) for n in "qkv")
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _gate_up(lp, h):
    x = rms_norm(h, lp["ffn_norm"], _NORM_EPS)
    m = lp["mlp"]
    return dense(x, m["gate"]["kernel"]), dense(x, m["up"]["kernel"])


def _post_attention(lp, h, out):
    """The o-projection and its residual, then the silu-gated MLP."""
    h = h + dense(out.reshape(*h.shape[:2], -1), lp["attn"]["o"]["kernel"])
    gate, up = _gate_up(lp, h)
    return h + dense(F.silu(gate) * up, lp["mlp"]["down"]["kernel"])


def _block(lp, h, cos, sin, attn, H, D):
    """One layer.  On a mesh ``lp`` is the layer's shards: each piece
    gathers what it reads (``compute_view``), inside its checkpoint under
    a remat mode."""
    lp = compute_view(lp)
    return _post_attention(lp, h, attn(*_qkv(lp, h, cos, sin, H, D)))


def _block_save_flash(lp, h, cos, sin, attn, H, D):
    """Remat True: the attention call outside every checkpoint (its
    flash residuals survive, its forward runs once); the pieces before
    and after it checkpointed apart."""
    q, k, v = ckpt(lambda h: _qkv(compute_view_of(
        lp, "attention_norm", "attn"), h, cos, sin, H, D), h)
    out = attn(q, k, v)
    return ckpt(lambda h, out: _post_attention(compute_view(lp), h, out), h,
                out)


def _block_save_acts(lp, h, cos, sin, attn, H, D):
    """Remat "save_acts" (the JAX policy that saves "act_qkv", "act_attn"
    and "act_fc1"): the q/k/v projections, the attention output and the
    MLP's gate are kept; the backward recomputes the norms, the rotation,
    the up projection and the activation, never the attention.  On a mesh
    the dense layers' weights are gathered for the forward and again for
    the backward (``view_gathered_again``); the up projection's
    checkpoint gathers its own."""
    m = lp["mlp"]

    def up(x, gate):
        kernel = compute_view(m["up"])["kernel"]
        return F.silu(gate) * dense(x, kernel)

    x = ckpt(lambda h: rms_norm(h, compute_view(lp["attention_norm"]),
                                _NORM_EPS), h)
    dense_layers = {"attn": lp["attn"], "gate": m["gate"], "down": m["down"]}
    with view_gathered_again(dense_layers, "attn", "gate", "down") as w:
        a = w["attn"]
        B, N, _ = x.shape
        q, k, v = (dense(x, a[n]["kernel"]).reshape(B, N, H, D)
                   for n in "qkv")
        q, k = ckpt(apply_rope, q, k, cos, sin)
        out = attn(q, k, v)
        h = h + dense(out.reshape(B, N, -1), a["o"]["kernel"])
        x = ckpt(lambda h: rms_norm(h, compute_view(lp["ffn_norm"]),
                                    _NORM_EPS), h)
        gate = dense(x, w["gate"]["kernel"])
        return h + dense(ckpt(up, x, gate), w["down"]["kernel"])


def tower_apply(params: dict, cfg: PixtralVisionConfig,
                patch_stream: torch.Tensor,    # [N, patch_dim] (0 = pad)
                patch_pos_ids: torch.Tensor,   # [N] row * max_side + col
                patch_segments: torch.Tensor,  # [N] image ids (0 = pad)
                precision: Precision = DEFAULT_PRECISION, remat=False,
                attention_fn: Callable | None = None) -> torch.Tensor:
    """The packed patch stream -> features [N, hidden] (the last layer's,
    no final norm).  ``attention_fn`` has the model-level signature and is
    called once a layer over the whole stream as one sequence, non-causal,
    segment-masked (block-diagonal over the images, the padding at 0);
    None: the dense oracle under the same mask.  ``remat``: False, True
    (the attention outside the checkpoints), "save_acts", or "full" (a
    plain checkpoint of each layer, whose backward re-runs the
    attention)."""
    H, D = cfg.num_attention_heads, cfg.head_dim
    h = dense(patch_stream.to(precision.compute_dtype)[None],
              params["patch_embed"]["kernel"])             # [1, N, E]
    h = rms_norm(h, params["ln_pre"], _NORM_EPS)
    table = torch.as_tensor(rope_half_table(cfg), device=h.device)
    half = table[patch_pos_ids.long()]
    emb = torch.cat([half, half], dim=-1)[None]            # [1, N, D]
    cos, sin = emb.cos(), emb.sin()
    segs = patch_segments.to(torch.int32)[None].contiguous()
    if attention_fn is None:
        mask = common.make_attention_mask(segs, segs, None, None,
                                          causal=False)
        attn = lambda q, k, v: common.xla_attention(q, k, v, mask)
    else:
        attn = functools.partial(attention_fn, mask=None, q_segments=segs,
                                 kv_segments=segs, causal=False)
    for lp in unstack_layers(params["layers"], cfg.num_hidden_layers):
        if remat == "full":
            h = ckpt(functools.partial(_block, lp, cos=cos, sin=sin,
                                       attn=attn, H=H, D=D), h)
        elif remat == "save_acts":
            h = _block_save_acts(lp, h, cos, sin, attn, H, D)
        elif remat:
            h = _block_save_flash(lp, h, cos, sin, attn, H, D)
        else:
            h = _block(lp, h, cos, sin, attn, H, D)
    return h[0]


def init_params(gen, cfg: PixtralConfig, dtype, device) -> dict:
    hid, E = cfg.text.hidden_size, cfg.vision.hidden_size
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    return {
        "text": qwen2.init_params(gen, cfg.text, dtype, device),
        "vision": init_tower_params(gen, cfg.vision, dtype, device),
        "projector": {
            "fc1": {"kernel": common.dense_init(gen, E, hid, dtype, device),
                    "bias": zeros(hid)},
            "fc2": {"kernel": common.dense_init(gen, hid, hid, dtype,
                                                device),
                    "bias": zeros(hid)},
        },
    }


def convert_hf(state, cfg: PixtralConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF Pixtral (``LlavaForConditionalGeneration``) state dict, in either
    key layout, -> parameter dict."""
    from iadr1_tpu_torch.models.params_io import convert_qwen2

    device = resolve_device(device)
    top = ("model." if any(k.startswith("model.language_model.")
                           for k in state) else "")
    lm = "model.language_model." if top else "language_model.model."
    proj = f"{top}multi_modal_projector."
    kw = dict(dtype=dtype, device=device)

    def linear(name):
        return {"kernel": _get(state, proj + name + ".weight", True, **kw),
                "bias": _get(state, proj + name + ".bias", **kw)}

    return {
        "text": convert_qwen2(state, cfg.text, prefix=lm, **kw),
        "vision": convert_tower_hf(state, cfg.vision,
                                   prefix=f"{top}vision_tower.", **kw),
        "projector": {"fc1": linear("linear_1"), "fc2": linear("linear_2")},
    }


def compute_embeds(params, cfg: PixtralConfig, input_ids, *,
                   patch_stream=None, patch_pos_ids=None,
                   patch_segments=None, scatter_rows=None, scatter_cols=None,
                   precision: Precision = DEFAULT_PRECISION,
                   tower_attention_fn: Callable | None = None,
                   tower_remat=False):
    """Token embeddings with the projected tower features scattered onto
    the ``[IMG]`` tokens (the stream's padding targets the dropped row
    B)."""
    embeds = common.embed_lookup(params["text"]["embed"]["weight"],
                                 input_ids).to(precision.compute_dtype)
    if patch_stream is not None:
        feats = tower_apply(params["vision"], cfg.vision, patch_stream,
                            patch_pos_ids, patch_segments, precision,
                            remat=tower_remat,
                            attention_fn=tower_attention_fn)
        embeds = merge_image_features(embeds, llava.project(params, feats),
                                      scatter_rows, scatter_cols)
    return embeds


def apply(params: dict, cfg: PixtralConfig,
          input_ids: torch.Tensor,             # [B, T]
          position_ids: torch.Tensor,          # [B, T]
          *, patch_stream=None, patch_pos_ids=None, patch_segments=None,
          scatter_rows=None, scatter_cols=None, segment_ids=None,
          cache: dict | None = None, cache_mode: str = "extend",
          precision: Precision = DEFAULT_PRECISION,
          attention_fn: Callable | None = None,
          decode_attention_fn: Callable | None = None,
          tower_attention_fn: Callable | None = None,
          remat=False, tower_remat=None, lora: dict | None = None,
          lora_scale: float = 1.0):
    """Full forward -> (hidden [B, T, hid], cache).  ``remat`` is the
    decoder's mode, ``tower_remat`` the tower's (``remat`` when None);
    ``lora`` is the decoder's adapter tree, the tower takes none."""
    embeds = compute_embeds(
        params, cfg, input_ids, patch_stream=patch_stream,
        patch_pos_ids=patch_pos_ids, patch_segments=patch_segments,
        scatter_rows=scatter_rows, scatter_cols=scatter_cols,
        precision=precision, tower_attention_fn=tower_attention_fn,
        tower_remat=remat if tower_remat is None else tower_remat)
    return qwen2.apply(
        params["text"], cfg.text, inputs_embeds=embeds,
        position_ids=position_ids, segment_ids=segment_ids, cache=cache,
        cache_mode=cache_mode, precision=precision, attention_fn=attention_fn,
        decode_attention_fn=decode_attention_fn, remat=remat, lora=lora,
        lora_scale=lora_scale)


def logits(params, cfg: PixtralConfig, hidden,
           precision: Precision = DEFAULT_PRECISION):
    return qwen2.logits(params["text"], cfg.text, hidden, precision)


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def tower_logical_axes(cfg: PixtralVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``tower_logical_axes``)."""
    return {
        "patch_embed": {"kernel": ("patch", "embed")},
        "ln_pre": ("norm",),
        "layers": {
            "attention_norm": (None, "norm"),
            "ffn_norm": (None, "norm"),
            "attn": {
                "q": {"kernel": (None, "embed", "heads")},
                "k": {"kernel": (None, "embed", "heads")},
                "v": {"kernel": (None, "embed", "heads")},
                "o": {"kernel": (None, "heads", "embed")},
            },
            "mlp": {
                "gate": {"kernel": (None, "embed", "mlp")},
                "up": {"kernel": (None, "embed", "mlp")},
                "down": {"kernel": (None, "mlp", "embed")},
            },
        },
    }


def logical_axes(cfg: PixtralConfig) -> dict:
    return {
        "text": qwen2.logical_axes(cfg.text),
        "vision": tower_logical_axes(cfg.vision),
        "projector": {
            "fc1": {"kernel": ("embed", "mlp"), "bias": ("mlp",)},
            "fc2": {"kernel": ("mlp", "embed"), "bias": ("norm",)},
        },
    }
