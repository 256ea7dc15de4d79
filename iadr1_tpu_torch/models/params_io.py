"""Checkpoint -> parameter-dict converters (counterpart of
iadr1_tpu/models/params_io.py).

Parameters keep the JAX package's layout: layers stacked on axis 0, dense
kernels [in, out] (HF's [out, in] transposed).  ``params_from_jax`` carries
a JAX parameter pytree over as it is, which is how the tests make both
packages compute with the same weights.  GPTQ/AWQ import waits (ROADMAP).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from iadr1_tpu_torch.core.device import resolve_device


def load_safetensors_path(path: str) -> dict[str, torch.Tensor]:
    """One .safetensors file, or a (sharded) checkpoint directory, as a
    flat name -> CPU tensor dict (bf16 included, which numpy cannot
    hold)."""
    from safetensors.torch import load_file

    if os.path.isfile(path):
        return load_file(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    state: dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(os.path.join(path, f)))
    return state


# safetensors' names of the dtypes the port writes
_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16",
              torch.float16: "F16", torch.int64: "I64", torch.int32: "I32"}


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (views on any device) as one .safetensors file,
    one tensor at a time: each is made contiguous where it lies, copied
    to the host once and written, so host memory holds one tensor, not
    the file.  Tensors that share storage are written apart.  The file
    appears whole or not at all (written aside, then renamed)."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a))


def _tensor(a, transpose: bool, dtype, device) -> torch.Tensor:
    t = _as_tensor(a).to(device=device, dtype=dtype)
    return (t.T if transpose else t).contiguous()


def _stack_layers(state: Mapping, template: str, num_layers: int,
                  transpose: bool = False, *, dtype, device) -> torch.Tensor:
    return torch.stack([
        _tensor(state[template.format(i=i)], transpose, dtype, device)
        for i in range(num_layers)
    ])


def _get(state: Mapping, name: str, transpose: bool = False, *, dtype,
         device) -> torch.Tensor:
    return _tensor(state[name], transpose, dtype, device)


def convert_qwen2(state: Mapping, cfg, prefix: str = "model.",
                  dtype=torch.float32, device=None) -> dict:
    """HF Qwen2ForCausalLM (or the text half of Qwen2-VL) -> parameters."""
    device = resolve_device(device)
    L = cfg.num_hidden_layers
    lt = prefix + "layers.{i}."
    kw = dict(dtype=dtype, device=device)

    def stacked(name, transpose=False):
        return _stack_layers(state, lt + name, L, transpose, **kw)

    params = {
        "embed": {"weight": _get(state, prefix + "embed_tokens.weight", **kw)},
        "layers": {
            "input_norm": stacked("input_layernorm.weight"),
            "post_attn_norm": stacked("post_attention_layernorm.weight"),
            "attn": {
                "q": {"kernel": stacked("self_attn.q_proj.weight", True)},
                "k": {"kernel": stacked("self_attn.k_proj.weight", True)},
                "v": {"kernel": stacked("self_attn.v_proj.weight", True)},
                "o": {"kernel": stacked("self_attn.o_proj.weight", True)},
            },
            "mlp": {
                "gate": {"kernel": stacked("mlp.gate_proj.weight", True)},
                "up": {"kernel": stacked("mlp.up_proj.weight", True)},
                "down": {"kernel": stacked("mlp.down_proj.weight", True)},
            },
        },
        "final_norm": _get(state, prefix + "norm.weight", **kw),
    }
    if cfg.attention_bias and (lt.format(i=0) + "self_attn.q_proj.bias") in state:
        attn = params["layers"]["attn"]
        for name in ("q", "k", "v"):
            attn[name]["bias"] = stacked(f"self_attn.{name}_proj.bias")
    if not cfg.tie_word_embeddings:
        head_name = "lm_head.weight"
        if head_name not in state:
            head_name = prefix.split(".")[0] + ".lm_head.weight"
        params["lm_head"] = {"kernel": _get(state, head_name, True, **kw)}
    return params


def params_from_jax(tree, dtype=None, device=None):
    """A JAX parameter pytree (nested dicts of arrays, as numpy arrays or
    anything ``np.asarray`` takes) -> the same nested dict of tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when given."""
    device = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        t = torch.as_tensor(np.array(x))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)
