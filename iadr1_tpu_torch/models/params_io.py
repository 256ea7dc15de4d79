"""Checkpoint -> parameter-dict converters (counterpart of
iadr1_tpu/models/params_io.py).

Parameters keep the JAX package's layout: layers stacked on axis 0, dense
kernels [in, out] (HF's [out, in] transposed).  ``params_from_jax`` carries
a JAX parameter pytree over as it is (quant dicts and LoRA trees too),
which is how the tests make both packages compute with the same weights.
GPTQ/AWQ checkpoints load through ``load_safetensors_path``: their packed
linears are rewritten exactly into the asymmetric-uint4 quant dicts of
``models/quant.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Mapping

import numpy as np
import torch

from iadr1_tpu_torch.core.device import resolve_device


def load_safetensors_path(path: str) -> dict[str, torch.Tensor]:
    """One .safetensors file, or a (sharded) checkpoint directory, as a
    flat name -> CPU tensor dict (bf16 included, which numpy cannot
    hold).  GPTQ/AWQ linears come back as quant dicts under
    ``<name>.weight`` (``convert_prequantized_state``)."""
    from safetensors.torch import load_file

    if os.path.isfile(path):
        return _maybe_prequantized(load_file(path))
    state: dict[str, torch.Tensor] = {}
    for f in _safetensors_files(path):
        state.update(load_file(os.path.join(path, f)))
    return _maybe_prequantized(state)


def _maybe_prequantized(state: dict) -> dict:
    if any(k.endswith(".qweight") for k in state):
        return convert_prequantized_state(state)
    return state


# ---------------------------------------------------------------------------
# the sharded load: a family's converter run on deferred tensors
# ---------------------------------------------------------------------------


class DeferredTensor(torch.Tensor):
    """A tensor on the meta device that remembers how its values are made:
    every op on it runs on the meta device (the shapes) and records the
    op, so a family's converter run on a state of deferred tensors returns
    a tree of deferred leaves at no cost, and ``materialize`` makes one
    leaf at a time on the host.  Any device an op names is the meta device
    while recording and the host when replayed."""

    @staticmethod
    def __new__(cls, meta: torch.Tensor, make):
        t = torch.Tensor._make_subclass(cls, meta)
        t._meta, t._make = meta, make
        return t

    def materialize(self) -> torch.Tensor:
        """The values, made on the host."""
        with torch._C.DisableTorchFunctionSubclass():
            return self._make()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map

        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*_on_device(func, tree_map(_meta_of, args), "meta"),
                       **_on_device(func, tree_map(_meta_of, kwargs),
                                    "meta"))

        def make():
            return func(*_on_device(func, tree_map(_values_of, args), "cpu"),
                        **_on_device(func, tree_map(_values_of, kwargs),
                                     "cpu"))

        if isinstance(out, torch.Tensor):
            return cls(out, make)
        if isinstance(out, (tuple, list)) and out and all(
                isinstance(o, torch.Tensor) for o in out):
            return type(out)(cls(o, lambda i=i: make()[i])
                             for i, o in enumerate(out))
        return out          # a shape, a dtype, a count


def _meta_of(x):
    return x._meta if isinstance(x, DeferredTensor) else x


def _values_of(x):
    return x._make() if isinstance(x, DeferredTensor) else x


def _on_device(func, args, device):
    """``args`` (a tuple or a kwargs dict) with every device replaced by
    ``device``; a string counts as a device only as ``Tensor.to``'s."""
    def swap(x, key=None):
        if isinstance(x, torch.device) or key == "device" or (
                func is torch.Tensor.to and isinstance(x, str)):
            return torch.device(device) if x is not None else x
        return x

    if isinstance(args, dict):
        return {k: swap(v, k) for k, v in args.items()}
    return tuple(swap(a) for a in args)


class DeferredState(Mapping):
    """A checkpoint's tensors as ``DeferredTensor``s read from its
    memory-mapped safetensors files on demand (a file, or a directory
    with or without an index)."""

    def __init__(self, path: str):
        from safetensors import safe_open

        files = ([path] if os.path.isfile(path)
                 else [os.path.join(path, f) for f in _safetensors_files(path)])
        self._handles, self._where = [], {}
        for f in files:
            handle = safe_open(f, framework="pt", device="cpu")
            self._handles.append(handle)
            for name in handle.keys():
                self._where[name] = handle
        if any(k.endswith(".qweight") for k in self._where):
            raise ValueError(
                "a GPTQ/AWQ checkpoint is a quantized base, which replicates "
                "over the mesh (as in the JAX CLI): load it whole on each "
                "rank, not sharded")

    def __getitem__(self, name: str) -> DeferredTensor:
        handle = self._where[name]
        piece = handle.get_slice(name)
        meta = torch.empty(piece.get_shape(), device="meta",
                           dtype=_TORCH_DTYPES[piece.get_dtype()])
        return DeferredTensor(meta, lambda: handle.get_tensor(name))

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)


def _safetensors_files(path: str) -> list[str]:
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    return files


def _shard_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """(start, length) of part ``index`` of ``n`` split as a DTensor's
    ``Shard`` splits it (``torch.chunk``: parts of ceil(n / parts))."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(size, n - start)


def load_sharded(convert, path: str, logical_axes, mesh, dtype,
                 device=None, stats: dict | None = None):
    """A checkpoint loaded straight onto ``mesh``: the family's converter
    ``convert(state, dtype=, device=)`` runs on a ``DeferredState``, then
    one leaf at a time is converted on the host from the memory-mapped
    files and this rank puts only its own shard of it (placed by its
    logical axes, as ``core/mesh.py shard_pytree`` places a whole tree) on
    its card, as a DTensor (``DTensor.from_local``).  No rank holds a
    whole leaf on its card, nor a whole tree on the host.

    ``stats`` (a dict), when given, receives the largest converted leaf
    on the host and the largest shard put on the card, in bytes."""
    from torch.distributed.tensor import DTensor, Shard

    from iadr1_tpu_torch.core.mesh import logical_to_mesh_axes

    device = resolve_device(device)
    tree = convert(DeferredState(path), dtype=dtype, device=device)
    coord = mesh.get_coordinate()
    stats = {} if stats is None else stats
    stats.setdefault("host_leaf_bytes", 0)
    stats.setdefault("device_shard_bytes", 0)

    def place(leaf, axes):
        host = (leaf.materialize() if isinstance(leaf, DeferredTensor)
                else leaf.detach().cpu())
        placements = logical_to_mesh_axes(axes, None, mesh.mesh_dim_names)
        local = host
        for size, c, p in zip(mesh.shape, coord, placements):
            if isinstance(p, Shard):
                start, length = _shard_range(host.shape[p.dim], size, c)
                local = local.narrow(p.dim, start, length)
        local = local.to(device, copy=True).contiguous()
        stats["host_leaf_bytes"] = max(stats["host_leaf_bytes"],
                                       host.numel() * host.element_size())
        stats["device_shard_bytes"] = max(
            stats["device_shard_bytes"], local.numel() * local.element_size())
        del host
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())

    def walk(node, axes):
        if isinstance(node, dict):
            return {k: walk(v, axes[k]) for k, v in node.items()}
        return None if node is None else place(node, axes)

    return walk(tree, logical_axes)


# safetensors' names of the dtypes the port writes# safetensors' names of the dtypes the port writes
_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16",
              torch.float16: "F16", torch.int64: "I64", torch.int32: "I32"}
_TORCH_DTYPES = {**{v: k for k, v in _ST_DTYPES.items()},
                 "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Mapping[str, str] | None = None,
                     write: bool = True) -> None:
    """Write ``tensors`` (views on any device) as one .safetensors file,
    one tensor at a time: each is made contiguous where it lies, copied
    to the host once and written, so host memory holds one tensor, not
    the file.  Tensors that share storage are written apart.  The file
    appears whole or not at all (written aside, then renamed).

    A DTensor is gathered whole before its copy, which every rank of its
    mesh must take part in: on a mesh every rank calls this with the same
    tensors and only the one with ``write`` writes.  The file is the one
    a single process writes, byte for byte."""
    from iadr1_tpu_torch.core.mesh import full

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
    with (open(tmp, "wb") if write else contextlib.nullcontext()) as f:
        if write:
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
        for t in tensors.values():
            host = full(t.detach()).contiguous().cpu()
            if write:
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    if write:
        os.replace(tmp, path)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a))


def _tensor(a, transpose: bool, dtype, device) -> torch.Tensor:
    t = _as_tensor(a).to(device=device, dtype=dtype)
    return (t.T if transpose else t).contiguous()


def _stack_layers(state: Mapping, template: str, num_layers: int,
                  transpose: bool = False, *, dtype, device):
    entries = [state[template.format(i=i)] for i in range(num_layers)]
    if isinstance(entries[0], dict):
        # imported GPTQ/AWQ linears: already the [in, out] quant-dict
        # layout, stacked field by field as they are
        return {k: torch.stack([_as_tensor(e[k]) for e in entries]
                               ).to(device) for k in entries[0]}
    return torch.stack([_tensor(a, transpose, dtype, device)
                        for a in entries])


def _get(state: Mapping, name: str, transpose: bool = False, *, dtype,
         device):
    a = state[name]
    if isinstance(a, dict):         # an imported GPTQ/AWQ linear
        return {k: _as_tensor(v).to(device) for k, v in a.items()}
    return _tensor(a, transpose, dtype, device)


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
    ``device``.  Floating leaves are cast to ``dtype`` when given, except
    inside quant dicts, whose integer codes and f32 scales (and zeros)
    come over as they are; None leaves (a LoRA tree's) stay None."""
    from iadr1_tpu_torch.models.quant import is_quantized

    device = resolve_device(device)

    def convert(x, cast=True):
        if x is None:
            return None
        if isinstance(x, dict):
            cast = cast and not is_quantized(x)
            return {k: convert(v, cast) for k, v in x.items()}
        a = np.array(x)
        if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: same bits
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.as_tensor(a)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)


# ---------------------------------------------------------------------------
# pre-quantized checkpoint import (GPTQ / AWQ), in numpy as the JAX import
# ---------------------------------------------------------------------------
# The packed tensors are rewritten exactly (no requantization) into the
# asymmetric-uint4 blockwise quant dict {q4, zeros, scales}.  AWQ packs 8
# uint4 values per int32 in the interleaved column order [0, 2, 4, 6, 1,
# 3, 5, 7]; GPTQ packs 8 consecutive rows per int32, low nibble first.
_AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _numpy(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _unpack_rows_le(packed: np.ndarray) -> np.ndarray:
    """GPTQ qweight int32 [in/8, out] -> uint8 [in, out] (the low nibble
    is the word's first row)."""
    shifts = (4 * np.arange(8)).astype(np.uint32)
    vals = (packed[:, None, :].astype(np.uint32)
            >> shifts[None, :, None]) & 0xF
    return vals.reshape(-1, packed.shape[-1]).astype(np.uint8)


def _unpack_cols_awq(packed: np.ndarray) -> np.ndarray:
    """AWQ qweight/qzeros int32 [..., out/8] -> uint8 [..., out]
    (interleaved nibble order)."""
    shifts = (4 * np.arange(8)).astype(np.uint32)
    vals = (packed[..., :, None].astype(np.uint32) >> shifts) & 0xF
    out = np.empty_like(vals)
    out[..., _AWQ_ORDER] = vals
    return out.reshape(*packed.shape[:-1], -1).astype(np.uint8)


def _pack_uint4_pairs(q: np.ndarray) -> np.ndarray:
    """uint8 [in, out] (values 0..15) -> uint8 [in/2, out], even rows in
    the low nibble (``quant._unpack_nibbles``'s layout)."""
    if q.shape[0] % 2:
        raise ValueError(f"odd in_dim {q.shape[0]} cannot nibble-pack")
    return (q[0::2] | (q[1::2] << 4)).astype(np.uint8)


def _quant_dict(q4, zeros, scales) -> dict:
    return {"q4": torch.from_numpy(q4), "zeros": torch.from_numpy(zeros),
            "scales": torch.from_numpy(np.ascontiguousarray(scales))}


def gptq_layer_to_quant(qweight, qzeros, scales, g_idx=None) -> dict:
    """AutoGPTQ 4-bit tensors -> an asymmetric quant dict of tensors.

    qweight int32 [in/8, out]; qzeros int32 [nb, out/8] storing zero - 1
    (AutoGPTQ's convention: the dequant subtracts qzeros + 1); scales
    f16 [nb, out].  desc_act checkpoints (a permuted ``g_idx``) are
    refused: the stacked kernels need uniform blocks of rows."""
    qweight, qzeros = _numpy(qweight), _numpy(qzeros)
    scales = _numpy(scales).astype(np.float32)
    q = _unpack_rows_le(qweight)                       # [in, out]
    in_dim, nb = q.shape[0], scales.shape[0]
    if g_idx is not None:
        expect = np.arange(in_dim) // (in_dim // nb)
        if not np.array_equal(_numpy(g_idx), expect):
            raise NotImplementedError(
                "GPTQ desc_act=True (permuted g_idx) is unsupported; "
                "re-export the checkpoint with desc_act=False")
    shifts = (4 * np.arange(8)).astype(np.uint32)
    z = (qzeros[:, :, None].astype(np.uint32) >> shifts) & 0xF
    zeros = z.reshape(nb, -1).astype(np.float32) + 1.0  # the GPTQ + 1
    return _quant_dict(_pack_uint4_pairs(q), zeros, scales)


def awq_layer_to_quant(qweight, qzeros, scales) -> dict:
    """AWQ GEMM 4-bit tensors -> an asymmetric quant dict of tensors.

    qweight int32 [in, out/8], qzeros int32 [nb, out/8], scales f16
    [nb, out]; columns interleaved by ``_AWQ_ORDER``."""
    q = _unpack_cols_awq(_numpy(qweight))              # [in, out]
    zeros = _unpack_cols_awq(_numpy(qzeros)).astype(np.float32)
    return _quant_dict(_pack_uint4_pairs(q), zeros,
                       _numpy(scales).astype(np.float32))


def convert_prequantized_state(state: dict) -> dict:
    """Every packed GPTQ/AWQ linear of a flat HF state dict rewritten into
    a quant dict under ``<name>.weight``, so the family converters take it
    as they take a dense weight.  The format is read per tensor: GPTQ
    packs along in (qweight's columns equal the scales'), AWQ along out."""
    out = dict(state)
    for key in [k for k in state if k.endswith(".qweight")]:
        base = key[: -len("qweight")]
        qweight, qzeros = state[key], state[base + "qzeros"]
        scales = state[base + "scales"]
        if qweight.shape[-1] == scales.shape[-1]:
            qd = gptq_layer_to_quant(qweight, qzeros, scales,
                                     g_idx=state.get(base + "g_idx"))
        else:
            qd = awq_layer_to_quant(qweight, qzeros, scales)
        out[base + "weight"] = qd
        for suffix in ("qweight", "qzeros", "scales", "g_idx"):
            out.pop(base + suffix, None)
    return out
