"""Shared-prompt forward for grouped-rollout scoring (GRPO updates);
counterpart of iadr1_tpu/models/shared_prompt.py.

In a GRPO update batch the G rollouts of one prompt share the whole
P-token prefix.  The unique prompts run once ([n, P]); the completions run
per rollout ([n*G, N]) and attend to

* the shared prompt K/V, repeated over the group (``repeat_interleave`` is
  differentiable, so the prompt-side gradients are the sum over the
  rollouts, the dense path's math), non-causal, T != S, and
* their own causal completion K/V,

and the two attention outputs are merged through their logsumexps (the
exact online-softmax composition).  The merge differentiates through both
lses, so the attention backward must take the lse cotangent: the flash
Function does (kernels/flash_attention.py), and so does autograd of the
dense oracle here.

All three attention calls go through one ``attention_fn`` with the
signature of ``models/attention.py``'s lse dispatch.  ``lora`` adds
factored adapters (``qwen2.lora_dense``) to both sides, as in the dense
decoder.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from iadr1_tpu_torch.core.mesh import compute_view, run_replicated
from iadr1_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from iadr1_tpu_torch.models import common, qwen2
from iadr1_tpu_torch.models.common import make_attention_mask, rms_norm
from iadr1_tpu_torch.models.qwen2 import _post_attention, _qkv, ckpt

_NEG_INF = float("-inf")


def attention_with_lse_xla(q, k, v, mask, scale: float | None = None):
    """[B,H,T,D] x [B,Hkv,S,D] -> (out [B,H,T,D], lse [B,H,T] f32).

    The dense oracle with a logsumexp output; a row with no valid key
    returns out = 0 and lse = -inf (the flash kernel and its twin mark such
    rows with +inf; ``merge_attention`` takes either)."""
    H, Hkv = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min * 0.5
    scores = torch.where(mask, scores, neg)
    lse = torch.logsumexp(scores, dim=-1)
    empty = lse <= neg / 4
    p = torch.where(empty[..., None], 0.0,
                    torch.exp(scores - lse[..., None])).to(v.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", p.float(), v.float()).to(q.dtype)
    return out, torch.where(empty, _NEG_INF, lse)


def merge_attention(o1, lse1, o2, lse2):
    """Exact online-softmax merge of two partial attentions over disjoint
    key sets ([B,H,T,D], [B,H,T]).  A +-inf lse (an empty key set) adds no
    mass; a row empty on both sides returns zeros.

    The order matters for the backward: a non-finite lse is first selected
    to -inf, and only then exponentiated.  exp of a +inf lse would be inf,
    and the select after it would send 0 * inf = NaN back."""
    l1 = torch.where(torch.isfinite(lse1), lse1, _NEG_INF)
    l2 = torch.where(torch.isfinite(lse2), lse2, _NEG_INF)
    m = torch.maximum(l1, l2)
    m0 = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(l1), torch.exp(l1 - m0), 0.0)
    w2 = torch.where(torch.isfinite(l2), torch.exp(l2 - m0), 0.0)
    denom = torch.clamp(w1 + w2, min=1e-30)
    o = (o1.float() * w1[..., None]
         + o2.float() * w2[..., None]) / denom[..., None]
    return o.to(o1.dtype)


def _rope_tables(cfg, positions, B, T):
    D = cfg.head_dim_
    if cfg.mrope_section is not None:
        if positions.dim() == 2:        # text only: all three axes agree
            positions = positions.expand(3, B, T)
        return common.mrope_cos_sin(positions, D, cfg.rope_theta,
                                    cfg.mrope_section)
    return common.rope_cos_sin(positions, D, cfg.rope_theta,
                               cfg.rope_scaling)


def _heads_first(*tensors):
    """[B, T, heads, D] -> the kernel layout [B, heads, T, D]."""
    return tuple(t.transpose(1, 2) for t in tensors)


def shared_prompt_hidden(
    params: dict,
    cfg: qwen2.Qwen2Config,
    *,
    prompt_ids: torch.Tensor,        # [n, P]
    prompt_segments: torch.Tensor,   # [n, P] (0 = left padding)
    prompt_positions: torch.Tensor,  # [n, P] or [3, n, P] (M-RoPE)
    comp_ids: torch.Tensor,          # [n*G, N]
    comp_segments: torch.Tensor,     # [n*G, N] (0 = past EOS)
    comp_positions: torch.Tensor,    # [n*G, N] or [3, n*G, N]
    group_size: int,
    attention_fn: Callable,
    precision: Precision = DEFAULT_PRECISION,
    remat=True,
    prompt_embeds: torch.Tensor | None = None,   # [n, P, hid] (VLM scatter)
    lora: dict | None = None,
    lora_scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (prompt_hidden [n, P, hid], comp_hidden [n*G, N, hid]), final-normed.

    The same math as ``qwen2.apply`` on the G-repeated concatenated
    [n*G, P+N] batch, factored: prompt -> prompt causal, completion ->
    (own prompt, own causal prefix).  ``prompt_embeds`` overrides the
    prompt embedding lookup (the VLM bundle splices image features in).

    ``remat``: False; True / "save_flash" (the three attention calls stay
    outside every checkpoint, so a flash Function's saved (out, lse)
    survive and its forward never re-runs; the projections before them,
    and the merge, output projection and MLP after them, are checkpointed
    apart); or "full" (one checkpoint around the layer: the backward
    re-runs the attention forwards too)."""
    if remat not in (False, True, "save_flash", "full"):
        raise ValueError(f"unknown remat mode {remat!r}")
    G = group_size
    n, P = prompt_ids.shape
    nG, N = comp_ids.shape
    device = prompt_ids.device
    eps = cfg.rms_norm_eps

    embed = params["embed"]["weight"]
    hp = (prompt_embeds if prompt_embeds is not None
          else common.embed_lookup(embed, prompt_ids)
          ).to(precision.compute_dtype)
    hc = common.embed_lookup(embed, comp_ids).to(precision.compute_dtype)
    rope_p = _rope_tables(cfg, prompt_positions, n, P)
    rope_c = _rope_tables(cfg, comp_positions, nG, N)

    p_seg = prompt_segments.to(torch.int32)
    c_seg = comp_segments.to(torch.int32)
    p_seg_rep = p_seg.repeat_interleave(G, dim=0)                # [nG, P]
    p_idx = torch.arange(P, device=device).expand(n, P)
    c_idx = torch.arange(N, device=device).expand(nG, N)
    mask_pp = make_attention_mask(p_seg, p_seg, p_idx, p_idx, causal=True)
    mask_cc = make_attention_mask(c_seg, c_seg, c_idx, c_idx, causal=True)
    # cross: every valid completion token sees every valid token of its own
    # prompt (the prompt lies wholly in the past: no causal term)
    mask_cp = make_attention_mask(c_seg, p_seg_rep, None, None, causal=False)

    def layer(hp, hc, lp, ll):
        # on a mesh ``lp`` and ``ll`` are the layer's shards: each piece
        # gathers them inside its checkpoint (``compute_view``, as
        # ``qwen2``'s layers)
        def project(h, rope):
            lv = compute_view(lp)
            return _heads_first(*_qkv(
                cfg, rms_norm(h, lv["input_norm"], eps), lv["attn"], *rope,
                compute_view(ll), lora_scale))

        def finish_prompt(h, out):
            return _post_attention(cfg, h, out.transpose(1, 2),
                                   compute_view(lp), compute_view(ll),
                                   lora_scale)

        def finish_completion(h, o1, lse1, o2, lse2):
            out = merge_attention(o1, lse1, o2, lse2)
            return _post_attention(cfg, h, out.transpose(1, 2),
                                   compute_view(lp), compute_view(ll),
                                   lora_scale)

        inner = remat and remat != "full"
        run = ckpt if inner else (lambda fn, *args: fn(*args))
        qp, kp, vp = run(lambda h: project(h, rope_p), hp)
        qc, kc, vc = run(lambda h: project(h, rope_c), hc)
        op, _ = attention_fn(qp, kp, vp, mask=mask_pp, q_segments=p_seg,
                             kv_segments=p_seg, causal=True)
        # the group's rollouts read one prompt's K/V: the backward sums
        # their gradients into it
        o1, lse1 = attention_fn(
            qc, kp.repeat_interleave(G, dim=0),
            vp.repeat_interleave(G, dim=0), mask=mask_cp, q_segments=c_seg,
            kv_segments=p_seg_rep, causal=False)
        o2, lse2 = attention_fn(qc, kc, vc, mask=mask_cc, q_segments=c_seg,
                                kv_segments=c_seg, causal=True)
        return (run(finish_prompt, hp, op),
                run(finish_completion, hc, o1, lse1, o2, lse2))

    L = cfg.num_hidden_layers
    layer_loras = (qwen2.unstack_layers(lora.get("layers", lora), L)
                   if lora is not None else [None] * L)
    for lp, ll in zip(qwen2.unstack_layers(params["layers"], L), layer_loras):
        if remat == "full":
            # lp and ll bind this layer: the replay runs after the loop
            hp, hc = ckpt(lambda hp, hc, lp=lp, ll=ll: layer(hp, hc, lp, ll),
                          hp, hc)
        else:
            hp, hc = layer(hp, hc, lp, ll)
    return (rms_norm(hp, params["final_norm"], eps),
            rms_norm(hc, params["final_norm"], eps))


def shared_prompt_pred_hidden(
    params, cfg, batch, group_size: int, *, attention_fn: Callable,
    precision: Precision = DEFAULT_PRECISION, remat=True,
    prompt_embeds: torch.Tensor | None = None, lora: dict | None = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """Hidden states that PREDICT the completion tokens: [n*G, N, hid].

    Prediction position t reads the hidden state at t-1: token 0 is
    predicted by the prompt's last valid hidden state (the same for the
    whole group, so taken from the shared prompt pass), tokens 1..N-1 by
    completion hiddens 0..N-2.

    batch fields: prompt_ids/prompt_segments/prompt_positions [n, ...],
    completion_ids/completion_mask/completion_positions [n*G, ...]."""
    hp, hc = shared_prompt_hidden(
        params, cfg,
        prompt_ids=batch["prompt_ids"],
        prompt_segments=batch["prompt_segments"],
        prompt_positions=batch["prompt_positions"],
        comp_ids=batch["completion_ids"],
        comp_segments=batch["completion_mask"],
        comp_positions=batch["completion_positions"],
        group_size=group_size, attention_fn=attention_fn,
        precision=precision, remat=remat, prompt_embeds=prompt_embeds,
        lora=lora, lora_scale=lora_scale,
    )
    # under tp (DTensors) the row pick runs on the replicated local copies
    return run_replicated(functools.partial(
        _predicting_rows, group_size=group_size),
        hp, hc, batch["prompt_segments"])


def _predicting_rows(hp, hc, prompt_segments, group_size: int):
    n, P, hid = hp.shape
    # the last VALID prompt token (P-1 under left padding; right-padded
    # inputs work too).  The largest valid index is unique, so no tie can
    # pick another; a row with no valid token reads P-1, as in JAX.
    valid = prompt_segments != 0
    idx = torch.where(valid, torch.arange(P, device=hp.device), -1).amax(1)
    last = torch.where(idx >= 0, idx, P - 1)
    hp_last = hp.gather(1, last[:, None, None].expand(n, 1, hid))
    hp_last = hp_last.repeat_interleave(group_size, dim=0)       # [nG, 1, hid]
    return torch.cat([hp_last, hc[:, :-1]], dim=1)               # [nG, N, hid]
