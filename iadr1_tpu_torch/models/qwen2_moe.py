"""Qwen2-MoE (Qwen1.5-MoE-A2.7B): the sparse-MoE decoder (counterpart of
iadr1_tpu/models/qwen2_moe.py and of transformers'
``Qwen2MoeSparseMoeBlock``).

The attention half of a layer is the Qwen2 decoder's; the MLP half is the
sparse block, plugged into ``qwen2.apply`` through its MLP hook: a softmax
router over ``num_experts`` in f32, the top ``num_experts_per_tok`` per
token (renormalised if ``norm_topk_prob``), each routed (token, slot) pair
through its expert's SwiGLU at ``moe_intermediate_size``, scaled by its
routing weight, plus a shared expert gated by a sigmoid.

Experts are stacked leaves ([L, E, H, I]), as in JAX.  The dispatch is
dropless, transformers' semantics: the (token, slot) pairs are sorted by
expert and each expert with any pair runs its three GEMMs over its rows
(``torch.matmul``; JAX computes these products outside any Pallas kernel
too).  The per-expert row counts come to the host once a layer
(``.tolist()``), a sync with the device.  JAX's ``capacity_factor`` (a
static-shape dispatch that drops the pairs past an expert's capacity,
ROADMAP C.R19) stays in the config so that configs load alike, and is
ignored here.  Under tp each rank runs its own contiguous share of the
experts, and one all-reduce a layer completes the output (``moe_block``).

The router's load-balancing loss is transformers' ``load_balancing_loss_func``
(ROADMAP C.R20): the routing statistics pooled over the layers' tokens
first, padding (segment 0) masked out, times E.  The shared expert's LoRA
adapters apply (C.R21); the 4-D expert kernels take none, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.mesh import (
    batch_ranks,
    batch_share,
    batch_total,
    full,
    is_dtensor,
)
from iadr1_tpu_torch.core.tensor_parallel import (
    copy_to_tp,
    reduce_from_tp,
    split_range,
    tp_group,
)
from iadr1_tpu_torch.models import qwen2
from iadr1_tpu_torch.models.common import dense
from iadr1_tpu_torch.models.params_io import _get, _stack_layers
from iadr1_tpu_torch.models.qwen2 import _ab, lora_dense


@dataclasses.dataclass(frozen=True)
class Qwen2MoeConfig(qwen2.Qwen2Config):
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.001
    # JAX's expert capacity knob, kept so configs load alike; the port's
    # dispatch is dropless and never reads it (ROADMAP C.R19)
    capacity_factor: float = 2.0


def config_from_hf(hf: dict) -> Qwen2MoeConfig:
    from iadr1_tpu_torch.models.registry import _qwen2_text_cfg

    if hf.get("mlp_only_layers"):
        raise NotImplementedError(
            "mlp_only_layers (mixed dense/sparse stacks) is not supported; "
            "all-sparse checkpoints only")
    if hf.get("decoder_sparse_step", 1) != 1:
        raise NotImplementedError("decoder_sparse_step != 1 not supported")
    base = _qwen2_text_cfg(hf)
    return Qwen2MoeConfig(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(qwen2.Qwen2Config)},
        num_experts=hf.get("num_experts", 60),
        num_experts_per_tok=hf.get("num_experts_per_tok", 4),
        moe_intermediate_size=hf.get("moe_intermediate_size", 1408),
        shared_expert_intermediate_size=hf.get(
            "shared_expert_intermediate_size", 5632),
        norm_topk_prob=hf.get("norm_topk_prob", False),
        router_aux_loss_coef=hf.get("router_aux_loss_coef", 0.001),
        capacity_factor=hf.get("capacity_factor", 2.0),
    )


def init_params(gen: torch.Generator, cfg: Qwen2MoeConfig, dtype,
                device) -> dict:
    """The Qwen2 decoder's init for everything but the MLP; the router,
    experts and shared expert ~ N(0, 0.02), as the JAX init, drawn a layer
    at a time in f32 into the stacked leaves."""
    # the dense MLP at width 1 (a few draws), replaced below
    params = qwen2.init_params(gen, dataclasses.replace(
        cfg, intermediate_size=1), dtype, device)
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    E, I = cfg.num_experts, cfg.moe_intermediate_size
    SI = cfg.shared_expert_intermediate_size

    def normal(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for layer in out:
            layer.copy_(torch.empty(layer.shape, dtype=torch.float32,
                                    device=device).normal_(
                0.0, 0.02, generator=gen))
        return out

    params["layers"]["mlp"] = {
        "router": {"kernel": normal(L, H, E)},
        "experts": {
            "gate": {"kernel": normal(L, E, H, I)},
            "up": {"kernel": normal(L, E, H, I)},
            "down": {"kernel": normal(L, E, I, H)},
        },
        "shared": {
            "gate": {"kernel": normal(L, H, SI)},
            "up": {"kernel": normal(L, H, SI)},
            "down": {"kernel": normal(L, SI, H)},
        },
        "shared_gate": {"kernel": normal(L, H, 1)},
    }
    return params


def convert_hf(state, cfg: Qwen2MoeConfig, dtype=torch.float32,
               device=None) -> dict:
    """HF ``Qwen2MoeForCausalLM`` state dict -> parameters: the experts
    stacked [L, E, in, out], qkv biases where present, an untied head."""
    device = resolve_device(device)
    L, E = cfg.num_hidden_layers, cfg.num_experts
    lt = "model.layers.{i}."
    kw = dict(dtype=dtype, device=device)

    def stacked(name, transpose=False):
        return _stack_layers(state, lt + name, L, transpose, **kw)

    def experts(name):
        return torch.stack([
            torch.stack([_get(state, f"model.layers.{i}.mlp.experts.{e}."
                              f"{name}_proj.weight", True, **kw)
                         for e in range(E)])
            for i in range(L)])

    attn = {n: {"kernel": stacked(f"self_attn.{n}_proj.weight", True)}
            for n in ("q", "k", "v", "o")}
    for n in ("q", "k", "v"):
        if f"model.layers.0.self_attn.{n}_proj.bias" in state:
            attn[n]["bias"] = stacked(f"self_attn.{n}_proj.bias")
    params = {
        "embed": {"weight": _get(state, "model.embed_tokens.weight", **kw)},
        "layers": {
            "input_norm": stacked("input_layernorm.weight"),
            "post_attn_norm": stacked("post_attention_layernorm.weight"),
            "attn": attn,
            "mlp": {
                "router": {"kernel": stacked("mlp.gate.weight", True)},
                "experts": {n: {"kernel": experts(n)}
                            for n in ("gate", "up", "down")},
                "shared": {n: {"kernel": stacked(
                    f"mlp.shared_expert.{n}_proj.weight", True)}
                    for n in ("gate", "up", "down")},
                "shared_gate": {"kernel": stacked(
                    "mlp.shared_expert_gate.weight", True)},
            },
        },
        "final_norm": _get(state, "model.norm.weight", **kw),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _get(state, "lm_head.weight", True,
                                            **kw)}
    return params


def route(cfg: Qwen2MoeConfig, xf: torch.Tensor, router_kernel):
    """Router probabilities [S, E] (f32) and each token's top-k weights and
    experts [S, K] (weights renormalised if ``norm_topk_prob``)."""
    probs = dense(xf, router_kernel).float().softmax(-1)
    weights, selected = probs.topk(cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    return probs, weights, selected


def local_experts(cfg: Qwen2MoeConfig, kernel) -> tuple[int, int]:
    """(first expert, count) that a rank's expert kernel [E_r, ...] holds:
    a DTensor's tp shard (training), a tp rank's slice of the rollout copy
    (``core.tensor_parallel.split_range``), or every expert."""
    if is_dtensor(kernel):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        shape, offset = compute_local_shape_and_global_offset(
            kernel.shape, kernel.device_mesh, kernel.placements)
        return offset[0], shape[0]
    group = tp_group()
    if group is None:
        return 0, cfg.num_experts
    first, count = split_range(cfg.num_experts, group.size, group.rank)
    if kernel.shape[0] != count:
        raise ValueError(f"tp rank {group.rank} holds {kernel.shape[0]} "
                         f"experts, its share of {cfg.num_experts} is {count}")
    return first, count


def moe_block(cfg: Qwen2MoeConfig, x: torch.Tensor, mp: dict, ml=None,
              scale: float = 1.0, *, segment_ids=None, with_aux=False):
    """The sparse MLP over [B, T, H] (``qwen2.apply``'s MLP hook); returns
    (out, aux): aux the layer's routing statistics [2, E] over the tokens
    of segment > 0 (the routings to each expert over the K slots, and the
    sum of its router probability), or None without ``with_aux``.

    Under tp every rank holds the same tokens and its own contiguous share
    of the experts: it routes every token (the router is replicated), runs
    the GEMM chain for its own experts' (token, slot) pairs only and adds
    the shared expert's row-parallel partial, so one all-reduce a layer
    completes the output.  In the tp rollout (plain slices) that reduce is
    the decoder's ``tp_sum``; in training (DTensors over the tp submesh)
    it is made here, forward only (Megatron's g), and the replicated
    inputs of the partial sum take their cotangents summed (f)."""
    B, T, H = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    ex = mp["experts"]
    first, n_own = local_experts(cfg, ex["gate"]["kernel"])
    group = None
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        tp_mesh, xd = x.device_mesh, x.reshape(-1, H)
        group = tp_mesh.get_group()
        # whole on every tp rank (DTensor may carry it sharded or partial)
        xf = xd.redistribute(tp_mesh, [Replicate()]).to_local()
        router = mp["router"]["kernel"].to_local()
        ex = {n: {"kernel": ex[n]["kernel"].to_local()}
              for n in ("gate", "up", "down")}
    else:
        xf = x.reshape(-1, H)
        router = mp["router"]["kernel"]
    probs, weights, selected = route(cfg, xf, router)

    # dropless dispatch: the (token, slot) pairs sorted by expert (stable,
    # so each expert's rows keep token order), one GEMM chain an expert of
    # this rank's; one host read of its experts' counts (and of the pairs
    # ahead of them)
    flat = selected.reshape(-1)
    order = flat.argsort(stable=True)
    per_expert = torch.bincount(flat, minlength=E)
    if (first, n_own) == (0, E):
        start, counts = 0, per_expert.tolist()          # syncs the host
    else:
        start, *counts = torch.cat([per_expert[:first].sum()[None],
                                    per_expert[first:first + n_own]]).tolist()
    own = order[start:start + sum(counts)]
    tokens = own // K
    xe = copy_to_tp(xf, group)
    rows = xe[tokens]
    gate, up, down = (ex[n]["kernel"].unbind(0) for n in ("gate", "up",
                                                          "down"))
    outs, at = [], 0
    for e, n in enumerate(counts):
        if n:
            xr = rows[at:at + n]
            outs.append(dense(F.silu(dense(xr, gate[e])) * dense(xr, up[e]),
                              down[e]))
            at += n
    # each pair's output times its routing weight in the activations'
    # dtype, summed per token in expert order (transformers' index_add_)
    out = torch.zeros_like(xf)
    if outs:
        w = copy_to_tp(weights, group).reshape(-1)[own].to(x.dtype)
        out = out.index_add(0, tokens, torch.cat(outs) * w[:, None])

    def shared(xs, name):
        return lora_dense(xs, mp["shared"][name]["kernel"], None,
                          _ab(ml, "shared", name, "kernel"), scale)

    if group is None:
        sh = shared(F.silu(shared(xf, "gate")) * shared(xf, "up"), "down")
        sg = torch.sigmoid(dense(xf, mp["shared_gate"]["kernel"]).float())
        out = (out + sg.to(sh.dtype) * sh).reshape(B, T, H)
    else:
        out = _shared_and_reduce(out, xd, shared, mp, group, tp_mesh)
        out = out.reshape(B, T, H)
    if not with_aux:
        return out, None
    m = (torch.ones(B * T, device=xf.device) if segment_ids is None
         else (segment_ids.reshape(-1) > 0).float())
    routed = F.one_hot(selected, E).float().sum(1)           # [S, E]
    return out, torch.stack([(routed * m[:, None]).sum(0),
                             (probs * m[:, None]).sum(0)])


def _shared_and_reduce(out, xd, shared, mp, group, tp_mesh):
    """Training under tp: the shared expert on the DTensors (its adapters
    and DoRA as every dense layer runs them), its row-parallel partial
    added to this rank's experts' ``out`` before the one all-reduce; the
    result replicated over ``tp_mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    sh = shared(F.silu(shared(xd, "gate")) * shared(xd, "up"), "down")
    sg = torch.sigmoid(dense(xd, mp["shared_gate"]["kernel"]).float())
    sg = sg.redistribute(tp_mesh, [Replicate()]).to_local()
    if sh.placements[0].is_partial():
        part = sh.to_local(grad_placements=[Replicate()])
        out = reduce_from_tp(out + copy_to_tp(sg, group).to(part.dtype)
                             * part, group)
    else:       # DTensor reduced (or laid out) the shared expert itself
        full_sh = sh.redistribute(tp_mesh, [Replicate()]).to_local()
        out = reduce_from_tp(out, group) + sg.to(full_sh.dtype) * full_sh
    return DTensor.from_local(out, tp_mesh, [Replicate()], run_check=False)


def load_balancing_loss(cfg: Qwen2MoeConfig, stats: torch.Tensor,
                        segment_ids: torch.Tensor | None,
                        n_tokens: int) -> torch.Tensor:
    """transformers' ``load_balancing_loss_func`` from the routing
    statistics summed over the layers ([2, E]): E * sum_e f_e * P_e, f_e
    the share of the valid (token, layer) routings to e (summed over the K
    slots) and P_e the mean router probability of e, both over every
    layer's valid tokens together (ROADMAP C.R20)."""
    n = batch_total(float(n_tokens) if segment_ids is None
                    else (segment_ids > 0).sum().float())
    denom = cfg.num_hidden_layers * torch.clamp(torch.as_tensor(
        n, device=stats.device), min=1.0)
    return cfg.num_experts * ((stats[0] / denom) * (stats[1] / denom)).sum()


def apply(params, cfg: Qwen2MoeConfig, input_ids=None, *, return_aux=False,
          **kw):
    """``qwen2.apply`` with the sparse MLP, the same cache modes and remat
    modes; ``return_aux``: (hidden, cache, the load-balancing loss)."""
    mlp = functools.partial(moe_block, with_aux=return_aux)
    out = qwen2.apply(params, cfg, input_ids, mlp_fn=mlp,
                      return_aux=return_aux, **kw)
    if not return_aux:
        return out
    h, cache, stats = out
    # on a mesh the statistics are the batch ranks' together, and each
    # rank's aux is its share of the loss they give
    aux = load_balancing_loss(cfg, batch_share(full(stats)),
                              kw.get("segment_ids"), h.shape[0] * h.shape[1])
    aux = aux / batch_ranks()
    if is_dtensor(h):
        # the statistics are plain (every tp rank's alike): the aux meets
        # the DTensor loss as a replicated DTensor, so that its cotangent
        # comes back plain
        from torch.distributed.tensor import DTensor, Replicate

        aux = DTensor.from_local(aux, h.device_mesh, [Replicate()],
                                 run_check=False)
    return h, cache, aux


head_kernel = qwen2.head_kernel
logits = qwen2.logits
init_cache = qwen2.init_cache


# ---------------------------------------------------------------------------
# logical axes (core/mesh.py maps them to the mesh)
# ---------------------------------------------------------------------------

def logical_axes(cfg: Qwen2MoeConfig) -> dict:
    """Logical-axis tuples parallel to ``init_params`` (the JAX
    ``logical_axes``): the expert axis takes tp (``moe_block``: each tp
    rank its contiguous share of the experts)."""
    axes = qwen2.logical_axes(cfg)
    axes["layers"]["mlp"] = {
        "router": {"kernel": (None, "embed", None)},
        "experts": {
            "gate": {"kernel": (None, "expert", "embed", None)},
            "up": {"kernel": (None, "expert", "embed", None)},
            "down": {"kernel": (None, "expert", None, "embed")},
        },
        "shared": {
            "gate": {"kernel": (None, "embed", "mlp")},
            "up": {"kernel": (None, "embed", "mlp")},
            "down": {"kernel": (None, "mlp", "embed")},
        },
        "shared_gate": {"kernel": (None, "embed", None)},
    }
    return axes
