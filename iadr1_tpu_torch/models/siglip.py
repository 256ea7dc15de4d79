"""SigLIP vision tower (so400m class), the tower of LLaVA-OneVision
(counterpart of iadr1_tpu/models/siglip.py).

HF ``SiglipVisionModel`` semantics: a patch embedding (a strided
convolution, here a dense layer over patchified tiles) plus learned
position embeddings, no CLS token; pre-norm encoder layers with biased
q/k/v/o projections and tanh-gelu MLPs; a final post-layernorm.  Square
tiles of a fixed size (384 px: 27 x 27 = 729 patches) are batched over
the anyres tiles, and every tile attends only to itself, non-causal.  At
so400m's width the head dim is 1152 / 16 = 72, which K1-K3 stage at 80.
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
    compute_view_of,
    view_gathered_again,
)
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import ckpt, unstack_layers
from iadr1_tpu_torch.models.qwen2_vl import layer_norm


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

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


def init_params(gen, cfg: SiglipVisionConfig, dtype, device) -> dict:
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

    return {
        "patch_embed": {"kernel": common.dense_init(gen, cfg.patch_dim, E,
                                                    dtype, device),
                        "bias": full((E,), 0.0)},
        "pos_embed": common.embed_init(gen, cfg.num_patches, E, dtype,
                                       device),
        "layers": {
            "norm1": norm((L, E)),
            "norm2": norm((L, E)),
            "attn": {name: proj(E, E) for name in "qkvo"},
            "mlp": {"fc1": proj(E, I), "fc2": proj(I, E)},
        },
        "post_norm": norm((E,)),
    }


def convert_hf(state, cfg: SiglipVisionConfig,
               prefix: str = "vision_tower.vision_model.",
               dtype=torch.float32, device=None) -> dict:
    """HF SigLIP vision tensors (name -> array) under ``prefix`` -> the
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

    pe = _get(state, prefix + "embeddings.patch_embedding.weight", **kw)
    return {
        # the convolution [E, C, ps, ps] with stride = kernel is a dense
        # layer over patches laid out channel first (anyres.patchify_tiles)
        "patch_embed": {
            "kernel": pe.reshape(pe.shape[0], -1).T.contiguous(),
            "bias": _get(state, prefix + "embeddings.patch_embedding.bias",
                         **kw)},
        "pos_embed": _get(state,
                          prefix + "embeddings.position_embedding.weight",
                          **kw),
        "layers": {
            "norm1": norm("layer_norm1"),
            "norm2": norm("layer_norm2"),
            "attn": {"q": linear("self_attn.q_proj"),
                     "k": linear("self_attn.k_proj"),
                     "v": linear("self_attn.v_proj"),
                     "o": linear("self_attn.out_proj")},
            "mlp": {"fc1": linear("mlp.fc1"), "fc2": linear("mlp.fc2")},
        },
        "post_norm": {"scale": _get(state, prefix + "post_layernorm.weight",
                                    **kw),
                      "bias": _get(state, prefix + "post_layernorm.bias",
                                   **kw)},
    }


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _qkv(lp, x, H: int, D: int):
    a = lp["attn"]
    N, T, _ = x.shape
    return tuple(dense(x, a[n]["kernel"], a[n]["bias"]).reshape(N, T, H, D)
                 for n in "qkv")


def _attend(lp, h, q, k, v, attn):
    """The attention output through the o-projection, added to ``h``."""
    N, T = h.shape[:2]
    o = lp["attn"]["o"]
    return h + dense(attn(q, k, v).reshape(N, T, -1), o["kernel"], o["bias"])


def _mlp(lp, x, act):
    m = lp["mlp"]
    x = act(dense(x, m["fc1"]["kernel"], m["fc1"]["bias"]))
    return dense(x, m["fc2"]["kernel"], m["fc2"]["bias"])


def _post_attention(lp, h, eps: float, act):
    x = layer_norm(h, lp["norm2"]["scale"], lp["norm2"]["bias"], eps)
    return h + _mlp(lp, x, act)


def _block(lp, h, attn, H: int, D: int, eps: float, act):
    """One block.  On a mesh ``lp`` is the block's shards: each piece
    gathers what it reads (``compute_view``), inside its checkpoint under
    a remat mode."""
    lp = compute_view(lp)
    x = layer_norm(h, lp["norm1"]["scale"], lp["norm1"]["bias"], eps)
    return _post_attention(lp, _attend(lp, h, *_qkv(lp, x, H, D), attn), eps,
                           act)


def _block_save_flash(lp, h, attn, H: int, D: int, eps: float, act):
    """The block under remat True (and the decoder's modes the tower
    follows): the attention call stays outside every checkpoint, so the
    flash Function's residuals survive and its forward runs once (the
    role of the JAX FLASH_REMAT_POLICY); the norm and projections before
    it and the o-projection and MLP after it are checkpointed apart."""
    def qkv(h):
        w = compute_view_of(lp, "norm1", "attn")
        return _qkv(w, layer_norm(h, w["norm1"]["scale"], w["norm1"]["bias"],
                                  eps), H, D)

    def post(h, out):
        w = compute_view(lp)
        o = w["attn"]["o"]
        return _post_attention(w, h + dense(out.reshape(*h.shape[:2], -1),
                                            o["kernel"], o["bias"]), eps, act)

    q, k, v = ckpt(qkv, h)
    return ckpt(post, h, attn(q, k, v))


def _block_save_acts(lp, h, attn, H: int, D: int, eps: float, act):
    """The block under remat "save_acts" (the JAX policy that saves
    "act_qkv", "act_attn" and "act_fc1" besides the flash residuals): the
    q/k/v projections, the attention output and the pre-gelu fc1 output
    are kept; the backward recomputes only the two layer norms and the
    activation, and never the attention forward.  On a mesh the dense
    layers' weights are gathered for the forward and again for the
    backward (``view_gathered_again``)."""
    def norm(key, h):
        n = compute_view(lp[key])
        return layer_norm(h, n["scale"], n["bias"], eps)

    x = ckpt(functools.partial(norm, "norm1"), h)
    with view_gathered_again(lp, "attn", "mlp") as w:
        h = _attend(w, h, *_qkv(w, x, H, D), attn)
        x = ckpt(functools.partial(norm, "norm2"), h)
        m = w["mlp"]
        f = dense(x, m["fc1"]["kernel"], m["fc1"]["bias"])
        return h + dense(ckpt(act, f), m["fc2"]["kernel"],
                         m["fc2"]["bias"])


def run_layers(layers: list, h, attn, H: int, D: int, eps: float, remat,
               act=gelu_tanh):
    """Pre-norm encoder layers (the per-layer views of ``unstack_layers``)
    over ``h`` under a remat mode (see ``apply``), the MLP's activation
    ``act``; the CLIP tower shares them with QuickGELU."""
    for lp in layers:
        if remat == "full":
            # partial binds this layer: the replay runs after the loop
            h = ckpt(functools.partial(_block, lp, attn=attn, H=H, D=D,
                                       eps=eps, act=act), h)
        elif remat == "save_acts":
            h = _block_save_acts(lp, h, attn, H, D, eps, act)
        elif remat:
            h = _block_save_flash(lp, h, attn, H, D, eps, act)
        else:
            h = _block(lp, h, attn, H, D, eps, act)
    return h


def tile_attention(attention_fn: Callable | None, tile_segments, N: int,
                   T: int):
    """The towers' attention over N tiles of T tokens, each tile its own
    sequence, non-causal: ``attention_fn`` (the model-level signature)
    with ``tile_segments`` [N] (0: a zero tile that pads the stream to its
    budget, which the kernels skip) spread over each tile's tokens, or
    none; ``attention_fn`` None: the dense oracle over every tile."""
    if attention_fn is None:
        return lambda q, k, v: common.xla_attention(q, k, v, None)
    segs = None
    if tile_segments is not None:
        segs = tile_segments.to(torch.int32)[:, None].expand(N, T)
        segs = segs.contiguous()
    return functools.partial(attention_fn, mask=None, q_segments=segs,
                             kv_segments=segs, causal=False)


def apply(params: dict, cfg: SiglipVisionConfig,
          tiles: torch.Tensor,              # [N, num_patches, patch_dim]
          precision: Precision = DEFAULT_PRECISION,
          remat=False, post_layernorm: bool = True,
          attention_fn: Callable | None = None,
          tile_segments: torch.Tensor | None = None) -> torch.Tensor:
    """Tile batch -> features [N, num_patches, hidden].

    ``attention_fn`` has the model-level signature (q, k, v, *, mask,
    q_segments, kv_segments, causal), q [N, T, H, D]; it is called once per
    layer over all tiles, each tile its own sequence, non-causal, with
    ``tile_segments`` (``tile_attention``).  None: the dense oracle.

    ``remat``: False; "full" (a plain checkpoint of each block, whose
    backward re-runs the attention forward); "save_acts"
    (``_block_save_acts``); any other true mode keeps the attention
    outside the checkpoints (``_block_save_flash``)."""
    H, D, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    pe = params["patch_embed"]
    h = dense(tiles.to(precision.compute_dtype), pe["kernel"], pe["bias"])
    h = h + params["pos_embed"][None].to(h.dtype)
    attn = tile_attention(attention_fn, tile_segments, *h.shape[:2])
    h = run_layers(unstack_layers(params["layers"], cfg.num_hidden_layers),
                   h, attn, H, D, eps, remat)
    if post_layernorm:
        n = params["post_norm"]
        h = layer_norm(h, n["scale"], n["bias"], eps)
    return h


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: SiglipVisionConfig) -> dict:
    """The tower's logical-axis tuples (the JAX ``logical_axes``)."""
    def norm():
        return {"scale": (None, "norm"), "bias": (None, "norm")}

    def proj(out):
        return {"kernel": (None, "embed", out), "bias": (None, out)}

    return {
        "patch_embed": {"kernel": ("patch", "embed"), "bias": ("norm",)},
        "pos_embed": (None, "embed"),
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
