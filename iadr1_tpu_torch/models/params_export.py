"""Parameter dict -> HF safetensors export (the port's own copy of
iadr1_tpu/models/params_export.py: Qwen2, Qwen2-VL and Qwen2.5-VL).

The reverse of ``params_io.convert_*``: after PA-SFT or SC-GRPO, write an
HF-layout checkpoint the next stage, the eval harness, the JAX package or
HF ``transformers`` can load.  Layer-stacked leaves are unstacked to
``layers.{i}.`` entries and kernels transposed back to [out, in], under
the JAX export's names.  The state dict holds views of the parameters;
``save_safetensors`` makes each contiguous where it lies and copies it to
the host once.  Each tensor keeps its parameter's dtype (the f32
parameters of a training run export as f32, as in JAX, whose export casts
every tensor to f32; a bf16 model exports as bf16).
"""

from __future__ import annotations

import os
import shutil

import torch

# what save_pretrained copies from the source checkpoint
SOURCE_FILES = ("config.json", "generation_config.json",
                "tokenizer_config.json", "tokenizer.json", "vocab.json",
                "merges.txt", "special_tokens_map.json",
                "preprocessor_config.json", "chat_template.json")


def _unstack(state: dict, template: str, stacked: torch.Tensor,
             transpose: bool = False) -> None:
    for i, x in enumerate(stacked.detach().unbind(0)):
        state[template.format(i=i)] = x.T if transpose else x


def export_qwen2(params: dict, cfg, prefix: str = "model.") -> dict:
    """Qwen2 decoder parameters -> HF state dict (tensor views)."""
    state: dict = {}
    lt = prefix + "layers.{i}."
    state[prefix + "embed_tokens.weight"] = params["embed"]["weight"].detach()
    layers = params["layers"]
    _unstack(state, lt + "input_layernorm.weight", layers["input_norm"])
    _unstack(state, lt + "post_attention_layernorm.weight",
             layers["post_attn_norm"])
    for name in ("q", "k", "v", "o"):
        _unstack(state, lt + f"self_attn.{name}_proj.weight",
                 layers["attn"][name]["kernel"], transpose=True)
        if "bias" in layers["attn"][name]:
            _unstack(state, lt + f"self_attn.{name}_proj.bias",
                     layers["attn"][name]["bias"])
    for name in ("gate", "up", "down"):
        _unstack(state, lt + f"mlp.{name}_proj.weight",
                 layers["mlp"][name]["kernel"], transpose=True)
    state[prefix + "norm.weight"] = params["final_norm"].detach()
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = params["lm_head"]["kernel"].detach().T
    return state


def export_qwen2_vl_vision(params: dict, vcfg, prefix: str = "visual.") -> dict:
    """Qwen2-VL or Qwen2.5-VL vision tower parameters -> HF state dict
    (tensor views).  Qwen2-VL's blocks hold LayerNorms (scale and bias)
    and fc1/fc2 MLPs; Qwen2.5-VL's hold RMSNorms (a scale alone), SwiGLU
    MLPs and a scale-only merger norm."""
    state: dict = {}
    bt = prefix + "blocks.{i}."
    pk = params["patch_embed"]["kernel"].detach().T
    state[prefix + "patch_embed.proj.weight"] = pk.reshape(
        pk.shape[0], vcfg.in_channels, vcfg.temporal_patch_size,
        vcfg.patch_size, vcfg.patch_size)
    blocks = params["blocks"]
    for norm in ("norm1", "norm2"):
        if isinstance(blocks[norm], dict):          # Qwen2-VL LayerNorm
            _unstack(state, bt + f"{norm}.weight", blocks[norm]["scale"])
            _unstack(state, bt + f"{norm}.bias", blocks[norm]["bias"])
        else:                                       # Qwen2.5-VL RMSNorm
            _unstack(state, bt + f"{norm}.weight", blocks[norm])
    mlp = (("fc1", "fc1"), ("fc2", "fc2")) if "fc1" in blocks["mlp"] else (
        ("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down"))
    for hf, name, group in (("qkv", "qkv", "attn"), ("proj", "proj", "attn"),
                            *((hf, name, "mlp") for hf, name in mlp)):
        _unstack(state, bt + f"{group}.{hf}.weight",
                 blocks[group][name]["kernel"], True)
        _unstack(state, bt + f"{group}.{hf}.bias",
                 blocks[group][name]["bias"])
    merger = params["merger"]
    if isinstance(merger["ln_q"], dict):
        state[prefix + "merger.ln_q.weight"] = merger["ln_q"]["scale"].detach()
        state[prefix + "merger.ln_q.bias"] = merger["ln_q"]["bias"].detach()
    else:
        state[prefix + "merger.ln_q.weight"] = merger["ln_q"].detach()
    for hf, name in (("0", "fc1"), ("2", "fc2")):
        state[prefix + f"merger.mlp.{hf}.weight"] = (
            merger[name]["kernel"].detach().T)
        state[prefix + f"merger.mlp.{hf}.bias"] = merger[name]["bias"].detach()
    return state


def export_params(bundle, params: dict) -> dict:
    """Family dispatch -> HF state dict."""
    if bundle.family == "qwen2":
        return export_qwen2(params, bundle.cfg)
    if bundle.family in ("qwen2_vl", "qwen2_5_vl"):
        state = export_qwen2(params["text"], bundle.cfg.text,
                             prefix="model.language_model.")
        state.update(export_qwen2_vl_vision(
            params["vision"], bundle.cfg.vision, prefix="model.visual."))
        return state
    raise ValueError(f"export not implemented for family {bundle.family!r}")


def save_pretrained(bundle, params: dict, out_dir: str,
                    source_dir: str | None = None) -> None:
    """Write model.safetensors (+ config/tokenizer copied from source).
    On a mesh every rank calls it with its DTensor parameters: they are
    gathered whole, rank 0 writes what a single process writes, and the
    ranks wait for it.  Plain parameters are one process's call (rank 0's
    alone in a multi-process chain, ``cli/pipeline.py``, which waits)."""
    from iadr1_tpu_torch.core.distributed import barrier, is_primary
    from iadr1_tpu_torch.core.mesh import full, is_dtensor
    from iadr1_tpu_torch.models.params_io import save_safetensors

    sharded = []

    def gather(node):
        if isinstance(node, dict):
            return {k: gather(v) for k, v in node.items()}
        if node is not None and is_dtensor(node):
            sharded.append(True)
        return None if node is None else full(node.detach())

    params = gather(params)
    write = is_primary()
    if write:
        os.makedirs(out_dir, exist_ok=True)
        save_safetensors(os.path.join(out_dir, "model.safetensors"),
                         export_params(bundle, params), {"format": "pt"})
    if sharded:
        barrier()
    if source_dir and write:
        for name in SOURCE_FILES:
            src = os.path.join(source_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))
