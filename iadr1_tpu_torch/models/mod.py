"""Mixture-of-Depths over the Qwen2 decoder (counterpart of
iadr1_tpu/models/mod.py; arXiv 2404.02258).

Each layer runs on the top ``capacity`` share of a row's tokens by its
router's score; the others ride the residual stream.  The routing is a
static top-k: k = max(int(T * capacity), 1) is fixed by the shapes, the
chosen indices are sorted (so causality by sequence order holds among the
gathered rows), padding scores -inf, and the layer runs on the gathered
[B, k, hidden] rows with their gathered RoPE tables and segment ids,
causal, through the model's attention (K1 on the card, K2 and K3 in the
backward).  The layer's delta scatters back scaled by sigmoid(score), so
the router is on the gradient path; a padding row picked because a row
holds fewer than k real tokens gets 0.  ``convert_to_mod`` adds zero
routers: every block starts at sigmoid(0) = 1/2.  Training and scoring
only, as in JAX (no cache).
"""

from __future__ import annotations

import functools

import torch

from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common
from iadr1_tpu_torch.models.common import make_attention_mask, xla_attention
from iadr1_tpu_torch.models.qwen2 import (
    Qwen2Config,
    _layer,
    _remat_layer,
    norm,
    unstack_layers,
)


def convert_to_mod(params: dict, cfg: Qwen2Config) -> dict:
    """A shallow copy of ``params`` with a zero router [L, hidden, 1] (f32,
    on the parameters' device) in its layers."""
    out = dict(params)
    layers = dict(params["layers"])
    device = params["final_norm"].device
    layers["mod_router"] = {"kernel": torch.zeros(
        (cfg.num_hidden_layers, cfg.hidden_size, 1), dtype=torch.float32,
        device=device)}
    out["layers"] = layers
    return out


def top_rows(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of each row's k best scores, in sequence order [B, k].
    A stable sort breaks ties (repeated tokens score alike) toward the
    lower index, as JAX's top_k does."""
    return scores.sort(dim=1, descending=True, stable=True).indices[
        :, :k].sort(dim=1).values


def _mod_layer(cfg, h, lp, cos, sin, segment_ids, attention_fn,
               capacity: float, remat):
    B, T, _ = h.shape
    k = max(int(T * capacity), 1)
    scores = (h.float() @ lp["mod_router"]["kernel"].float())[..., 0]
    scores = torch.where(segment_ids > 0, scores, float("-inf"))
    top_idx = top_rows(scores, k)

    def gather(x):
        idx = top_idx.reshape(top_idx.shape + (1,) * (x.dim() - 2))
        return x.gather(1, idx.expand(top_idx.shape + x.shape[2:]))

    h_sel = gather(h)
    segs_sel = segment_ids.gather(1, top_idx)
    cos_sel, sin_sel = gather(cos), gather(sin)
    r = scores.gather(1, top_idx)[..., None]
    mask = make_attention_mask(segs_sel, segs_sel, top_idx, top_idx,
                               causal=True)
    if attention_fn is None:
        attn = lambda q, kk, vv: xla_attention(q, kk, vv, mask)
    else:
        attn = functools.partial(attention_fn, mask=mask,
                                 q_segments=segs_sel, kv_segments=segs_sel,
                                 causal=True)
    if remat:
        out_sel, _ = _remat_layer(cfg, h_sel, lp, cos_sel, sin_sel, attn,
                                  remat)
    else:
        out_sel, _ = _layer(cfg, h_sel, lp, cos_sel, sin_sel, None, None,
                            attn, False)
    # -inf scores (padding) are picked only when a row holds fewer than k
    # real tokens: their multiplier is 0, so the scatter adds nothing
    mult = torch.where(torch.isfinite(r), torch.sigmoid(r),
                       torch.zeros_like(r)).to(h.dtype)
    delta = (out_sel - h_sel) * mult
    return h.scatter_add(1, top_idx[..., None].expand_as(delta), delta)


def apply_mod(params: dict, cfg: Qwen2Config, input_ids: torch.Tensor, *,
              position_ids: torch.Tensor,
              segment_ids: torch.Tensor | None = None,
              capacity: float = 0.125,
              precision: Precision = DEFAULT_PRECISION,
              attention_fn=None, remat=True) -> torch.Tensor:
    """The MoD forward over the whole stack; returns the final hidden
    states [B, T, hidden].  ``params`` carry the routers
    (``convert_to_mod``); ``attention_fn`` None runs the dense masked
    attention over the gathered rows' own positions; ``remat`` a mode of
    ``qwen2.apply`` (True keeps the attention outside the checkpoints)."""
    h = common.embed_lookup(params["embed"]["weight"], input_ids)
    h = h.to(precision.compute_dtype)
    B, T, _ = h.shape
    if segment_ids is None:
        segment_ids = torch.ones((B, T), dtype=torch.int32, device=h.device)
    segment_ids = segment_ids.to(torch.int32)
    cos, sin = common.rope_cos_sin(position_ids, cfg.head_dim_,
                                   cfg.rope_theta, cfg.rope_scaling)
    for lp in unstack_layers(params["layers"], cfg.num_hidden_layers):
        h = _mod_layer(cfg, h, lp, cos, sin, segment_ids, attention_fn,
                       capacity, remat)
    return norm(cfg, h, params["final_norm"])
