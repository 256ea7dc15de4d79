"""Rollout engine: batched sampling over a static KV cache (counterpart of
iadr1_tpu/train/rollout.py).

Prompts are left-padded into a [B, P] block and prefilled in one pass
(flash kernel), then decoded one token per step (ragged decode kernel).
Sequences freeze at EOS: the emitted token becomes pad and the cache
segment mask stops growing.  The loop stops once every row is done (the
JAX engine's default ``early_stop``; the tokens are the same either way).
``generate(..., lora=...)`` samples from a base plus factored adapters
(LoRA SC-GRPO) without merging them.  ``generate_mixture`` samples from
the geometric mixture of two models (Nash-MD's opponent): each keeps its
own KV cache, and each step's logits are (1 - c) log_softmax(policy) +
c log_softmax(mixture) before temperature, top-k and top-p.

On a mesh (``core/mesh.py``) each batch rank decodes its own rows on a
plain copy of the parameters, the sampler draws for the global batch
(each rank's top-k candidates are gathered, every rank draws the same
tokens from the same generator and keeps its rows), so the tokens do not
depend on the mesh, and the loop stops only when every rank's rows are
done.  With tp = 1 the copy is gathered whole (``cast_dense_params``).
With tp > 1 it is gathered over dp and fsdp only (``tp_local_params``):
each rank keeps its tp slice of the decoder as plain local tensors and
decodes with explicit collectives (``core/tensor_parallel.py``, the
Megatron layout: an all-reduce after o and after down, a masked lookup
and an all-reduce for the vocabulary-sharded embedding, an all-gather of
the last position's vocabulary-sharded logits before the sampler), its KV
cache holding only its own KV heads.  Every tp rank then draws the same
tokens from the same generator.  The vision tower is gathered whole and
runs on every rank: it is under 1 GB in the tp recipes (CLIP-L-336 for
LLaVA-NeXT-34B, the Qwen2.5-VL tower for 72B), as ``compute_view`` also
gathers the towers whole for training.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.core.mesh import (
    all_done,
    batch_coordinate,
    full,
    gather_batch_rows,
    is_dtensor,
    kernel_mesh,
    logical_to_spec,
    mesh_shape,
)
from iadr1_tpu_torch.core.tensor_parallel import MeshTP, tp_group, tp_scope
from iadr1_tpu_torch.models import qwen2
from iadr1_tpu_torch.models.quant import is_quantized, quantized_shape


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 512
    temperature: float = 0.9
    top_p: float = 0.9
    top_k: int = 50
    eos_token_id: int = 0
    pad_token_id: int = 0
    # a TPU speed knob (approximate top-k) in the JAX package; the port
    # accepts it and samples exactly
    approx_top_k: bool = False

    def __post_init__(self):
        if self.approx_top_k:
            warnings.warn("approx_top_k is a TPU speed knob: the port samples "
                          "top-k exactly", stacklevel=3)


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """One sampling step over [B, V] logits -> [B] int64 token ids:
    greedy at temperature 0, else temperature, exact top-k, then top-p.
    On a mesh ``logits`` are this rank's rows: the draw is made over the
    batch ranks' rows together, as one process draws them."""
    if cfg.temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / cfg.temperature
    V = logits.shape[-1]
    k = min(cfg.top_k if cfg.top_k > 0 else V, V)
    top_logits, top_idx = logits.topk(k, dim=-1)           # sorted, desc
    rank, ranks = batch_coordinate()
    if ranks > 1:
        B = top_logits.shape[0]
        rows = slice(rank * B, (rank + 1) * B)
        top_logits = gather_batch_rows(top_logits)
    if cfg.top_p < 1.0:
        probs = top_logits.softmax(dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep tokens while the mass before them is < top_p
        keep = (cum - probs) < cfg.top_p
        top_logits = top_logits.masked_fill(~keep, float("-inf"))
    choice = torch.multinomial(top_logits.softmax(dim=-1), 1,
                               generator=generator)
    if ranks > 1:
        choice = choice[rows]
    return top_idx.gather(-1, choice)[:, 0]


def cast_dense_params(params: dict, dtype) -> dict:
    """A copy of ``params`` (detached) whose dense layers' kernels and
    biases are stored in ``dtype``, for a rollout from f32 training
    parameters: ``dense`` casts just those to the activations' dtype at
    every call, so the generated tokens are the same, and a decode step
    reads 2-byte weights instead of casting every 4-byte one.  Everything
    the model reads in f32 (norm scales, the embedding table, which a tied
    LM head reads in the logits dtype, and an untied ``lm_head``) keeps its
    dtype, and so does a quant dict (``dense`` dequantizes it to the
    activations' dtype itself).  A LoRA tree casts the same way: its
    factors sit under "kernel" keys, and its None leaves stay None.
    DTensor leaves (a mesh) are gathered whole, one at a time, into the
    plain copy."""
    def keep(node):
        if isinstance(node, dict):
            return {k: keep(v) for k, v in node.items()}
        return None if node is None else full(node.detach())

    def cast(node):
        if node is None or is_quantized(node):
            return keep(node)
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return full(node.detach()).to(dtype)

    def walk(node, name):
        if not isinstance(node, dict) or is_quantized(node):
            return keep(node)
        if "kernel" in node and name != "lm_head":      # a dense layer
            return {k: cast(v) for k, v in node.items()}
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params, "")


# the decoder leaves whose tp dim is the KV heads' (q's is the heads')
_KV_LEAVES = ("attn/k/", "attn/v/")


def tp_local_params(params: dict, axes: dict, text_cfg, rank: int,
                    size: int, dtype) -> dict:
    """tp rank ``rank``'s rollout copy of ``params`` (DTensors on a mesh,
    or plain tensors: a replicated quantized base, one process's whole
    tree), as plain tensors: the text decoder's leaves keep the slice of
    their tp dim (the dim whose logical axis ``axes`` maps to tp; a DTensor
    gathered over dp and fsdp only), every other leaf (the towers, the
    projector) whole.  Dense kernels and biases are cast to ``dtype`` as
    ``cast_dense_params`` casts them.  ``axes`` is the logical-axis tree
    parallel to ``params`` (``bundle.logical_axes()``, or
    ``train/adapters.py lora_logical_axes`` for an adapter tree).

    A quant dict is sliced field by field: along out for a
    column-parallel kernel, along in (its packed rows and block scales)
    for a row-parallel one.  When the KV heads do not divide by tp each
    rank keeps the KV heads its query heads read (replicated, as the
    flash rule replicates them in training).  A split the layout cannot
    make raises naming ROADMAP A.11b: query heads, a vocabulary, an MLP
    width or a quant block that does not divide by tp, and DoRA (its
    column norms of a row-parallel kernel would need a reduce of their
    own)."""
    H, Hkv = text_cfg.num_attention_heads, text_cfg.num_key_value_heads
    D = text_cfg.head_dim_
    if H % size:
        raise NotImplementedError(
            f"a tp rollout needs the {H} query heads to divide by tp={size} "
            "(ROADMAP A.11b)")
    kv_heads = None
    if Hkv % size:
        local_q, group = H // size, H // Hkv
        wanted = [(rank * local_q + j) // group for j in range(local_q)]
        kept = sorted(set(wanted))
        # each kept KV head serves the same number of local query heads:
        # keep them once; else one KV head per query head (group 1)
        kv_heads = kept if len({wanted.count(h) for h in kept}) == 1 \
            else wanted

    def fail(what):
        raise NotImplementedError(
            f"a tp rollout cannot split {what} over tp={size} "
            "(ROADMAP A.11b)")

    def chunk(t, dim, what):
        if t.shape[dim] % size:
            fail(f"{what} {tuple(t.shape)} along dim {dim}")
        n = t.shape[dim] // size
        return t.narrow(dim, rank * n, n)

    def select_kv(t):
        lead = t.shape[:-1]
        return t.reshape(*lead, Hkv, D)[..., kv_heads, :].reshape(*lead, -1)

    def keep_tp(t, dim):
        """A leaf's slice of its tp dim (``dim``, None: whole)."""
        if is_dtensor(t):
            if dim is None:
                return full(t)
            from torch.distributed.tensor import Replicate

            mesh = t.device_mesh
            placements = [p if name == "tp" else Replicate()
                          for name, p in zip(mesh.mesh_dim_names,
                                             t.placements)]
            return t.redistribute(mesh, placements).to_local()
        return t if dim is None else chunk(t, dim, "a leaf")

    def leaf(t, ax, path, in_text, cast):
        if t is None:
            return None
        spec = logical_to_spec(ax) if in_text else ()
        dims = [d for d, entry in enumerate(spec) if entry == "tp"]
        dim = dims[0] - len(spec) if dims else None       # from the end
        kv = kv_heads is not None and dim == -1 and any(
            k in path for k in _KV_LEAVES) and not path.endswith("/a")
        if kv and is_quantized(t):
            t = {k: select_kv(v) for k, v in t.items()}
        elif kv:
            t = select_kv(full(t.detach()))
        elif is_quantized(t):
            t = {k: (v if dim is None or (k == "scales" and v.shape[dim] == 1)
                     else chunk(v, dim, f"the quant field {k}"))
                 for k, v in t.items()}
        else:
            t = keep_tp(t.detach(), dim)
        if is_quantized(t):
            return t
        return (t.to(dtype) if cast else t).contiguous()

    def walk(node, ax, path, in_text, cast):
        if node is None:
            return None
        if isinstance(node, dict) and not is_quantized(node):
            if "m" in node and "a" in node:
                fail("DoRA's magnitudes")
            dense_node = "kernel" in node and not path.endswith("lm_head")
            return {k: walk(v, ax[k], f"{path}/{k}" if path else k,
                            in_text or (k == "text" and not path),
                            cast or dense_node) for k, v in node.items()}
        return leaf(node, ax, path, in_text, cast)

    text_model = "text" not in params
    return walk(params, axes, "", text_model, False)


def mesh_tp():
    """The tp group a rollout on the ambient mesh decodes over
    (``MeshTP``) when tp > 1; None without a mesh or at tp = 1."""
    mesh = kernel_mesh()
    if mesh is None or mesh_shape(mesh)["tp"] == 1:
        return None
    return MeshTP(mesh)


def rollout_copy(bundle, params: dict, tp=None, dtype=None) -> dict:
    """This rank's rollout copy of a model tree (the policy, a reference,
    a teacher): its tp slice as plain tensors under a tp group
    (``tp_local_params``), else ``cast_dense_params`` (gathered whole on a
    mesh).  Dense kernels and biases are cast to ``dtype``, the bundle's
    compute dtype by default; a tree's own dtype keeps it as stored."""
    dtype = bundle.precision.compute_dtype if dtype is None else dtype
    if tp is None:
        return cast_dense_params(params, dtype)
    return tp_local_params(params, bundle.logical_axes(),
                           getattr(bundle.cfg, "text", bundle.cfg), tp.rank,
                           tp.size, dtype)


def local_kv_heads(params: dict, text_cfg) -> int:
    """The KV heads a rollout copy's decoder holds (a tp rank's own)."""
    k = params.get("text", params)["layers"]["attn"]["k"]["kernel"]
    out = quantized_shape(k)[-1] if is_quantized(k) else k.shape[-1]
    return out // text_cfg.head_dim_


class RolloutEngine:
    """Batched ``generate`` over a model bundle with a KV cache."""

    def __init__(self, bundle, sampling: SamplingConfig, max_len: int,
                 cache_dtype=torch.bfloat16, device=None,
                 lora_scale: float = 1.0):
        self.bundle = bundle
        self.sampling = sampling
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.lora_scale = lora_scale

    @torch.no_grad()
    def generate(self, params, batch: dict, generator=None,
                 group_size: int = 1, lora=None, tp=None) -> dict:
        """batch: left-padded prompt tensors on the engine's device
        ("input_ids", "attention_mask" [B, P]; "position_ids" [3, B, P] and
        "mrope_deltas" [B] for M-RoPE; the vision arrays).  ``group_size``
        G > 1 prefills each prompt once and fans its KV cache out G ways.
        Returns {"completion_ids" [B*G, N], "completion_mask",
        "prompt_ids", "prompt_mask"}, prompts repeated G times
        consecutively, and "num_decode_steps" (the decode steps run).
        ``lora``: an adapter tree applied factored on top of ``params``
        (with the engine's ``lora_scale``), prefill and decode alike.
        ``tp``: a tensor-parallel group (``core/tensor_parallel.py``);
        ``params`` and ``lora`` are then its rank's ``tp_local_params``
        copies, and the decoder runs under ``tp_scope(tp)``."""
        with (tp_scope(tp) if tp is not None else contextlib.nullcontext()):
            return self._generate(params, batch, generator, group_size, lora)

    @torch.no_grad()
    def generate_mixture(self, params, mixture_params, mixture_coef: float,
                         batch: dict, generator=None, tp=None) -> dict:
        """Samples from the geometric mixture of ``params`` and
        ``mixture_params`` with weight ``mixture_coef`` on the second
        (TRL's GeometricMixtureWrapper): both prefill the batch, each into
        its own KV cache, and decode the same tokens.  Returns what
        ``generate`` returns.  ``tp``: as ``generate``'s, both trees its
        rank's copies."""
        with (tp_scope(tp) if tp is not None else contextlib.nullcontext()):
            return self._generate(params, batch, generator, 1, None,
                                  (mixture_params, float(mixture_coef)))

    def _positions(self, batch):
        """(position_ids, deltas) of a left-padded prompt batch: the next
        position of row b is P + deltas[b]."""
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        if tcfg.mrope_section is not None:
            return batch["position_ids"], batch["mrope_deltas"]
        P = batch["input_ids"].shape[1]
        position_ids = (batch["attention_mask"].cumsum(dim=1) - 1).clamp(
            min=0)
        return position_ids, position_ids[:, -1] + 1 - P

    def _lora_kw(self, lora) -> dict:
        return ({"lora": lora, "lora_scale": self.lora_scale}
                if lora is not None else {})

    @torch.no_grad()
    def prefill(self, params, batch: dict, lora=None):
        """(logits at the last prompt position [B, V], the KV cache): the
        prompts (and their vision arrays) prefilled into a fresh cache."""
        tcfg = getattr(self.bundle.cfg, "text", self.bundle.cfg)
        kv_heads = (local_kv_heads(params, tcfg) if tp_group() is not None
                    else None)
        cache = qwen2.init_cache(tcfg, batch["input_ids"].shape[0],
                                 self.max_len, self.cache_dtype, self.device,
                                 kv_heads=kv_heads)
        position_ids, _ = self._positions(batch)
        hidden, cache = self.bundle.apply(
            params, {**batch, "position_ids": position_ids,
                     "segment_ids": batch["attention_mask"].to(torch.int32)},
            cache=cache, cache_mode="prefill", **self._lora_kw(lora))
        return (full(self.bundle.logits_fn(params, hidden[:, -1:, :])[:, 0]),
                cache)

    def _generate(self, params, batch, generator, group_size, lora,
                  mixture=None) -> dict:
        sampling, bundle = self.sampling, self.bundle
        if mixture is not None and group_size > 1:
            raise ValueError("mixture sampling does not support "
                             "group_size > 1")
        lora_kw = self._lora_kw(lora)
        tcfg = getattr(bundle.cfg, "text", bundle.cfg)
        input_ids = batch["input_ids"]
        attn_mask = batch["attention_mask"]
        B, P = input_ids.shape
        if P + sampling.max_new_tokens > self.max_len:
            raise ValueError(f"prompt {P} + {sampling.max_new_tokens} new "
                             f"tokens exceed max_len {self.max_len}")
        mrope = tcfg.mrope_section is not None
        _, deltas = self._positions(batch)
        last_logits, cache = self.prefill(params, batch, lora)
        if mixture is not None:
            mix_params, coef = mixture
            mix_logits, mix_cache = self.prefill(mix_params, batch)
            last_logits = mix_log_probs(last_logits, mix_logits, coef)

        if group_size > 1:
            G = group_size
            cache["k"] = cache["k"].repeat_interleave(G, dim=1)
            cache["v"] = cache["v"].repeat_interleave(G, dim=1)
            cache["segment_ids"] = cache["segment_ids"].repeat_interleave(
                G, dim=0)
            last_logits = last_logits.repeat_interleave(G, dim=0)
            deltas = deltas.repeat_interleave(G, dim=0)
            input_ids = input_ids.repeat_interleave(G, dim=0)
            attn_mask = attn_mask.repeat_interleave(G, dim=0)
            B = B * G

        eos, pad = sampling.eos_token_id, sampling.pad_token_id
        token = sample_token(last_logits, sampling, generator)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        N = sampling.max_new_tokens
        tokens = torch.full((N, B), pad, dtype=torch.int64, device=self.device)
        steps = 0
        for t in range(N):
            if all_done(done):          # every row has emitted EOS
                break
            steps += 1
            token_in = torch.where(done, pad, token)
            # all three M-RoPE axes advance together after the prompt
            pos = (P + deltas + t).to(torch.int64)[:, None]
            if mrope:
                pos = pos[None].expand(3, B, 1)
            seg = (~done).to(torch.int32)[:, None]
            step_batch = {"input_ids": token_in[:, None],
                          "position_ids": pos, "segment_ids": seg}
            hidden, cache = bundle.apply(
                params, step_batch, cache=cache, cache_mode="decode",
                **lora_kw)
            logits = full(bundle.logits_fn(params, hidden)[:, 0])
            if mixture is not None:
                mix_hidden, mix_cache = bundle.apply(
                    mix_params, step_batch, cache=mix_cache,
                    cache_mode="decode")
                logits = mix_log_probs(
                    logits, bundle.logits_fn(mix_params, mix_hidden)[:, 0],
                    coef)
            next_token = sample_token(logits, sampling, generator)
            tokens[t] = torch.where(done, pad, token)
            done = done | (token == eos)
            token = torch.where(done, pad, next_token)
        completion_ids = tokens.T.contiguous()

        # mask: tokens up to and including the first EOS
        is_eos = completion_ids == eos
        first_eos = torch.where(is_eos.any(dim=1),
                                is_eos.int().argmax(dim=1),
                                torch.full_like(is_eos[:, 0], N,
                                                dtype=torch.int64))
        idx = torch.arange(N, device=self.device)[None, :]
        return {
            "completion_ids": completion_ids,
            "completion_mask": (idx <= first_eos[:, None]).to(torch.int32),
            "prompt_ids": input_ids,
            "prompt_mask": attn_mask.to(torch.int32),
            "num_decode_steps": steps,
        }


def mix_log_probs(logits, mix_logits, coef: float) -> torch.Tensor:
    """The geometric mixture's logits over [B, V]: (1 - coef) *
    log_softmax(logits) + coef * log_softmax(mix_logits), in f32."""
    return ((1.0 - coef) * torch.log_softmax(logits.float(), dim=-1)
            + coef * torch.log_softmax(mix_logits.float(), dim=-1))
