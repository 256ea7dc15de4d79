"""Tuning modes: full, freeze and LoRA (with DoRA, rsLoRA and PiSSA),
vision-tower freezing and projector-only training; the port's own copy of
iadr1_tpu/train/adapters.py.

Parameters stay the nested dict of tensors the models read.  A mask is a
dict of the same shape holding bools; ``apply_tuning`` wraps the AdamW
optimizer so that it holds moments for, and updates, only the trainable
tensors.  LoRA keeps the base frozen and trains a separate adapter tree
(``init_lora_params``): parallel to the parameters, {"a": [..., in, r],
"b": [..., r, out]} (and DoRA's "m": [..., out]) at each targeted kernel
and None everywhere else.  The models apply it factored
(``models/qwen2.py lora_dense``); ``merge_lora`` folds it in for export.

Random draws take an explicit ``torch.Generator``; the tests carry the
JAX package's draws across with ``params_from_jax`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from iadr1_tpu_torch.core.mesh import full, is_dtensor, local
from iadr1_tpu_torch.models.quant import (
    dequantize_kernel,
    is_quantized,
    quantized_shape,
)
from iadr1_tpu_torch.train.optimizers import global_norm
from iadr1_tpu_torch.train.state import tree_leaves


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    finetuning_type: str = "full"      # full | freeze | lora
    freeze_vision_tower: bool = True
    train_mm_proj_only: bool = False
    # freeze mode: train only the last N decoder layers
    freeze_trainable_layers: int = 2
    # lora
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_target: tuple = ("q", "k", "v", "o", "gate", "up", "down")
    # DoRA: a trainable per-column magnitude over the direction
    # (W + scale * A @ B) / ||.||_col, the norms computed factored
    use_dora: bool = False
    # rsLoRA: scale alpha / sqrt(r) instead of alpha / r
    use_rslora: bool = False
    # PiSSA: A/B from the principal singular vectors of each target
    # kernel, trained against the residual base (``pissa_init``)
    pissa_init: bool = False

    @property
    def lora_scale(self) -> float:
        return (self.lora_alpha / math.sqrt(self.lora_rank)
                if self.use_rslora else self.lora_alpha / self.lora_rank)


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths "/"-joined as the JAX
    tree paths; quant dicts and None are leaves."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _target_name(path: str) -> str:
    parts = path.split("/")
    return parts[-2] if len(parts) >= 2 else ""


def trainable_mask(params: Any, cfg: TuningConfig,
                   num_layers: int | None = None) -> Any:
    """A dict of bools parallel to ``params``: True = trainable."""

    def decide(p, leaf):
        if cfg.train_mm_proj_only:
            return p.startswith("projector") or "merger" in p
        if cfg.freeze_vision_tower and p.startswith("vision"):
            # the merger stays trainable with a frozen tower
            if "merger" not in p:
                return False
        if cfg.finetuning_type == "full":
            return True
        if cfg.finetuning_type == "freeze":
            if "layers" in p and num_layers is not None:
                # stacked layers: ``layerwise_freeze`` picks the rows
                return True
            return not p.startswith("embed")
        if cfg.finetuning_type == "lora":
            return False        # the base is frozen; adapters train apart
        raise ValueError(cfg.finetuning_type)

    return _map_with_path(decide, params)


class MaskedOptimizer:
    """An optimizer over the trainable leaves alone: ``init`` holds
    moments for them only, and ``apply`` updates them only, with the
    gradient norm of the trainable subset (optax.masked hands its inner
    chain, clip_by_global_norm included, that subset).  A frozen leaf is
    left exactly as it is.

    ``keep_from`` (freeze mode): of every trainable leaf whose first axis
    is the ``num_layers`` stacked layers, the rows before ``keep_from``
    keep their values (the JAX ``layerwise_freeze_transform`` zeroes
    their updates after the optimizer)."""

    def __init__(self, inner, mask_leaves: list[bool],
                 num_layers: int | None = None, keep_from: int = 0):
        self.inner = inner
        self.mask = list(mask_leaves)
        self.num_layers = num_layers
        self.keep_from = keep_from

    def _pick(self, leaves):
        if len(leaves) != len(self.mask):
            raise ValueError(f"{len(leaves)} leaves for a mask of "
                             f"{len(self.mask)}")
        return [x for x, m in zip(leaves, self.mask) if m]

    def init(self, params, paths=None):
        return self.inner.init(self._pick(params),
                               None if paths is None else self._pick(paths))

    @torch.no_grad()
    def apply(self, params, grads, state, grad_norm=None) -> None:
        params, grads = self._pick(params), self._pick(grads)
        kept = []
        if self.num_layers is not None and self.keep_from > 0:
            # the layer axis is never sharded: a shard holds every layer
            kept = [(local(p), local(p)[:self.keep_from].clone())
                    for p in params
                    if p.dim() >= 1 and p.shape[0] == self.num_layers]
        self.inner.apply(params, grads, state, global_norm(grads))
        for p, rows in kept:
            p[:self.keep_from].copy_(rows)


def masked_optimizer(optimizer, params: Any, mask: Any) -> MaskedOptimizer:
    """``optimizer`` over the leaves ``mask`` marks trainable."""
    return MaskedOptimizer(optimizer, _mask_flags(params, mask))


def _mask_flags(params, mask) -> list[bool]:
    """The mask's flag of every leaf of ``tree_leaves(params)``, in order
    (a quant dict's fields share its flag)."""
    if is_quantized(params):
        return [bool(mask)] * len(tree_leaves(params))
    if isinstance(params, dict):
        return [f for k, v in params.items() for f in _mask_flags(v, mask[k])]
    return [] if params is None else [bool(mask)]


def layerwise_freeze(optimizer: MaskedOptimizer, num_layers: int,
                     trainable_layers: int) -> MaskedOptimizer:
    """Freeze all but the last ``trainable_layers`` stacked layers (the
    JAX ``layerwise_freeze_transform``)."""
    optimizer.num_layers = num_layers
    optimizer.keep_from = num_layers - trainable_layers
    return optimizer


def apply_tuning(optimizer, params, cfg: TuningConfig,
                 num_layers: int | None = None):
    """``optimizer`` wrapped with the tuning mode's mask; LoRA trains only
    its adapter tree, so the optimizer is returned as it is."""
    if cfg.finetuning_type == "lora":
        return optimizer
    opt = masked_optimizer(optimizer, params,
                           trainable_mask(params, cfg, num_layers))
    if cfg.finetuning_type == "freeze" and num_layers is not None:
        opt = layerwise_freeze(opt, num_layers, cfg.freeze_trainable_layers)
    return opt


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def init_lora_params(gen: torch.Generator, params: Any,
                     cfg: TuningConfig) -> Any:
    """LoRA factors for every targeted kernel, in a tree parallel to
    ``params`` (None at every other leaf).  A ~ N(0, 1) * 0.01, B = 0, so
    the adapted model starts as the base.  Stacked [L, in, out] kernels
    get stacked factors.  The factors take the base leaf's dtype (a bf16
    base gets bf16 adapters, as in JAX) and device; over a quant dict
    (QLoRA) the shape is the logical one and the dtype the scales' (f32).
    DoRA's magnitude starts at the base's column norms.  Over a sharded
    base (DTensors) the factors are whole on every rank, drawn as one
    process draws them; ``lora_logical_axes`` then places them."""

    def make(p, leaf):
        if leaf is None or not p.endswith("kernel"):
            return None
        if _target_name(p) not in cfg.lora_target:
            return None
        if is_quantized(leaf):
            shape, dtype = quantized_shape(leaf), leaf["scales"].dtype
            device = leaf["scales"].device
        else:
            shape, dtype, device = tuple(leaf.shape), leaf.dtype, leaf.device
        if len(shape) not in (2, 3):
            return None
        *lead, in_dim, out_dim = shape
        a = torch.randn((*lead, in_dim, cfg.lora_rank), generator=gen,
                        dtype=torch.float32, device=device).to(dtype) * 0.01
        b = torch.zeros((*lead, cfg.lora_rank, out_dim), dtype=dtype,
                        device=device)
        out = {"a": a, "b": b}
        if cfg.use_dora:
            w = dequantize_kernel(leaf) if is_quantized(leaf) else leaf
            # a sharded base's norms come back whole, as the factors are
            out["m"] = full(torch.sqrt(w.detach().float().square().sum(
                dim=-2) + 1e-12).to(dtype))
        return out

    return _map_with_path(make, params)


def lora_logical_axes(lora: Any, base_axes: Any) -> Any:
    """The logical axes of an adapter tree, parallel to it, from its
    base's (``bundle.logical_axes()``): over a kernel of axes (*lead, in,
    out), "a" [*lead, in, r] takes (*lead, in, None), "b" [*lead, r, out]
    (*lead, None, out) and DoRA's "m" [*lead, out] (*lead, out), so that on
    a mesh each factor splits as the product it joins (the rank axis is
    never split); None leaves stay None."""
    if lora is None:
        return None
    if "a" in lora:
        *lead, in_ax, out_ax = base_axes
        axes = {"a": (*lead, in_ax, None), "b": (*lead, None, out_ax)}
        if "m" in lora:
            axes["m"] = (*lead, out_ax)
        return axes
    return {k: lora_logical_axes(v, base_axes[k]) for k, v in lora.items()}


def _randomized_svd(w, r: int, niter: int = 4, seed: int = 0,
                    oversample: int = 8):
    """Top-r SVD by randomized range finding with power iterations (the
    peft "pissa_niter_K" fast path), in float64 numpy: the JAX package's
    function as it is, so PiSSA factors agree with it exactly."""
    rng = np.random.default_rng(seed)
    w = np.asarray(w, np.float64)
    k = min(r + oversample, *w.shape)
    y = w @ rng.standard_normal((w.shape[1], k))
    for _ in range(niter):
        y, _ = np.linalg.qr(y)
        y = w @ (w.T @ y)
    q, _ = np.linalg.qr(y)
    u_s, s, vt = np.linalg.svd(q.T @ w, full_matrices=False)
    u = q @ u_s
    return u[:, :r], s[:r], vt[:r]


def pissa_init(params: Any, cfg: TuningConfig, niter: int = 4):
    """(lora, residual_params): principal-singular-vector initialization.

    For each target kernel W: A = U_r sqrt(S_r / scale), B = sqrt(S_r /
    scale) V_r^T, and the base becomes the residual W - scale * A @ B, so
    the adapter starts exactly at the principal component.  The SVD runs
    on the host in float64, seeded per kernel from its path's ``hash`` as
    in JAX (so both packages draw alike within one process).

    On a mesh (DTensor leaves) each target kernel is gathered whole, one
    at a time, and rank 0 alone computes its factors and residual and
    broadcasts them, so every rank holds bitwise the same (a path's
    ``hash`` differs between processes); the residual is placed as its
    kernel was, and the adapters come back whole, for the caller to place
    by ``lora_logical_axes``."""
    if cfg.use_dora:
        raise ValueError("pissa_init + use_dora is unsupported (as in peft)")
    scale = cfg.lora_scale
    residual_by_path: dict[str, torch.Tensor] = {}

    def factor(w2d, seed):
        u, s, vt = _randomized_svd(w2d, cfg.lora_rank, niter=niter,
                                   seed=seed)
        root_s = np.sqrt(s / scale)
        a = (u * root_s[None, :]).astype(np.float32)
        b = (root_s[:, None] * vt).astype(np.float32)
        res = np.asarray(w2d, np.float32) - scale * (a @ b)
        return a, b, res

    def back(x, like):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            dtype=like.dtype, device=like.device)

    def compute(p, leaf):
        w = leaf.detach().float().cpu().numpy()
        if leaf.dim() == 2:
            outs = [factor(w, abs(hash(p)) % (2 ** 31))]
        else:
            outs = [factor(w[i], (abs(hash(p)) + i) % (2 ** 31))
                    for i in range(leaf.shape[0])]
        a, b, res = (np.stack([o[j] for o in outs]) for j in range(3))
        if leaf.dim() == 2:
            a, b, res = a[0], b[0], res[0]
        return back(a, leaf), back(b, leaf), back(res, leaf)

    def make(p, leaf):
        if (leaf is None or is_quantized(leaf) or not p.endswith("kernel")
                or _target_name(p) not in cfg.lora_target
                or leaf.dim() not in (2, 3)):
            return None
        if not is_dtensor(leaf):
            a, b, res = compute(p, leaf)
            residual_by_path[p] = res
            return {"a": a, "b": b}
        whole = full(leaf.detach())
        *lead, n_in, n_out = whole.shape
        r = min(cfg.lora_rank, n_in, n_out)
        if dist.get_rank() == 0:
            a, b, res = compute(p, whole)
        else:
            a = whole.new_empty((*lead, n_in, r))
            b = whole.new_empty((*lead, r, n_out))
            res = torch.empty_like(whole)
        for t in (a, b, res):
            dist.broadcast(t, src=0)
        del whole
        residual_by_path[p] = place_like(res, leaf)
        return {"a": a, "b": b}

    lora = _map_with_path(make, params)
    residual = _map_with_path(lambda p, leaf: residual_by_path.get(p, leaf),
                              params)
    return lora, residual


def place_like(whole: torch.Tensor, like):
    """``whole`` (the same on every rank) as a DTensor placed as ``like``:
    each rank keeps a copy of its own shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(whole, like.device_mesh, like.placements,
                          src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), like.device_mesh,
                              d.placements, run_check=False, shape=d.shape,
                              stride=d.stride())


def merge_lora(params: Any, lora: Any, cfg: TuningConfig,
               inplace: bool = False) -> Any:
    """Effective parameters W + scale * A @ B, leaf by leaf.  A quantized
    base is dequantized to the factors' dtype first (the QLoRA export:
    the merged model keeps the base's quantization error); DoRA merges to
    m * direction.

    ``inplace`` is for a tree the caller owns and drops, as the export's:
    each adapted kernel is merged one layer at a time and written over
    its dense base (a quantized one gives way to a dense kernel filled
    layer by layer), so the merge holds one layer's transients and never
    a second copy of the adapted kernels."""
    scale = cfg.lora_scale
    adapters = _adapters_by_path(lora)

    def combine(p, w):
        ab = adapters.get(p)
        if ab is None:
            return w
        if not inplace or ab["a"].dim() == 2:
            merged = _merge_kernel(w, ab, scale)
            if inplace and not is_quantized(w):
                return w.copy_(merged)
            return merged
        if is_quantized(w):
            out = torch.empty(quantized_shape(w), dtype=ab["a"].dtype,
                              device=ab["a"].device)
        else:
            out = w
        for i in range(out.shape[0]):
            out[i] = _merge_kernel(
                {k: v[i] for k, v in w.items()} if is_quantized(w) else w[i],
                {k: v[i] for k, v in ab.items()}, scale)
        return out

    return _map_with_path(combine, params)


def _merge_kernel(w, ab: dict, scale: float) -> torch.Tensor:
    """One kernel (dense or a quant dict, [in, out] or layer-stacked)
    merged with its factors."""
    if is_quantized(w):
        w = dequantize_kernel(w, ab["a"].dtype)
    delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"])
    merged = w + (scale * delta).to(w.dtype)
    if "m" in ab:
        norm = torch.sqrt(merged.float().square().sum(dim=-2, keepdim=True)
                          + 1e-12)
        merged = (merged.float() / norm
                  * ab["m"].float()[..., None, :]).to(w.dtype)
    return merged


def _adapters_by_path(lora, path: str = "") -> dict:
    """{path of the adapted kernel: its {"a", "b"(, "m")} node}."""
    if not isinstance(lora, dict):
        return {}
    if "a" in lora:
        return {path: lora}
    out = {}
    for k, v in lora.items():
        out.update(_adapters_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def lora_training_fns(bundle, base_params, cfg: TuningConfig, **kw):
    """(hidden_fn, head_kernel_fn) of the factored LoRA route for the
    chunked-CE step (``train/sft.py make_chunked_sft_step``) over the
    frozen base: both take the adapter tree, which the train state holds
    alone.  On a mesh the base is read through its compute view (gathered
    over dp and fsdp; its decoder's layers one at a time), as the state's
    own parameters are; ``kw`` (``remat=``) passes to ``hidden_fn``."""
    from iadr1_tpu_torch.core.mesh import compute_view

    def hidden_fn(lora, batch):
        return bundle.hidden_fn(compute_view(base_params), batch, lora=lora,
                                lora_scale=cfg.lora_scale, **kw)

    def head_kernel_fn(lora):
        return bundle.head_kernel_fn(compute_view(base_params))

    return hidden_fn, head_kernel_fn


def make_lora_forward(forward_fn, base_params, cfg: TuningConfig):
    """forward(lora_params, batch) over the frozen base merged with the
    adapters (the merged route; the models' ``lora=`` is the factored
    one)."""
    def forward(lora_params, batch, **kw):
        return forward_fn(merge_lora(base_params, lora_params, cfg), batch,
                          **kw)

    return forward


# ---------------------------------------------------------------------------
# embedding resize
# ---------------------------------------------------------------------------


def resize_embeddings(params: Any, new_vocab: int, gen: torch.Generator,
                      pad_to_multiple_of: int = 64):
    """Grow the vocabulary rows of the embedding (and an untied lm_head)
    to ``new_vocab`` rounded up to ``pad_to_multiple_of``, new rows the
    mean of the old plus N(0, 1/sqrt(dim)) noise; returns (params,
    padded_vocab), the params unchanged when the vocabulary fits."""
    text = params.get("text", params)
    old_vocab, dim = text["embed"]["weight"].shape
    if new_vocab <= old_vocab:
        return params, old_vocab
    padded = -(-new_vocab // pad_to_multiple_of) * pad_to_multiple_of
    n_new = padded - old_vocab

    def grow(weight, row_axis_first: bool):
        w32 = weight.detach().float()
        if not row_axis_first:          # the lm_head kernel is [dim, vocab]
            w32 = w32.T
        mean = w32.mean(dim=0, keepdim=True)
        noise = torch.randn((n_new, w32.shape[1]), generator=gen,
                            device=w32.device) / math.sqrt(dim)
        grown = torch.cat([w32, mean + noise], dim=0)
        if not row_axis_first:
            grown = grown.T
        return grown.to(weight.dtype).contiguous()

    text = dict(text)
    text["embed"] = {"weight": grow(text["embed"]["weight"], True)}
    if "lm_head" in text:
        text["lm_head"] = {"kernel": grow(text["lm_head"]["kernel"], False)}
    if "text" in params:
        return {**params, "text": text}, padded
    return text, padded


def pissa_convert(lora_trained: Any, lora_init: Any) -> Any:
    """A PiSSA-trained adapter re-expressed against the ORIGINAL base:
    W_res + s A'B' = W + s [A', A0] @ [B'; -B0], a rank-2r adapter."""
    if lora_trained is None:
        return None
    if isinstance(lora_trained, dict) and "a" in lora_trained:
        return {"a": torch.cat([lora_trained["a"], lora_init["a"]], dim=-1),
                "b": torch.cat([lora_trained["b"], -lora_init["b"]], dim=-2)}
    return {k: pissa_convert(v, lora_init[k])
            for k, v in lora_trained.items()}
