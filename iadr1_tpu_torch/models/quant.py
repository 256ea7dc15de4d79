"""Weight-only quantization: int8 (serving) and int4 / nf4 (QLoRA bases);
the port's own copy of iadr1_tpu/models/quant.py.

Quantized kernels are plain dicts, in the JAX package's layouts, and
``common.dense`` takes any of them in place of a kernel:

    int8:  {"qvalues": int8 [..., in, out],  "scales": f32 [..., 1, out]}
    int4:  {"q4":  uint8 [..., in/2, out],   "scales": f32 [..., nb, out]}
    nf4:   {"nf4": uint8 [..., in/2, out],   "scales": f32 [..., nb, out]}
    GPTQ/AWQ imports (``params_io``):
           {"q4": uint8 [..., in/2, out], "zeros": f32 [..., nb, out],
            "scales": f32 [..., nb, out]},  w = (q - z) * s

int8 is per-output-channel symmetric.  int4 and nf4 are blockwise along
the contraction axis (block 64 by default), two values to a byte, even
rows in the low nibble; nf4 stores indices into the bitsandbytes
NormalFloat codebook.  The quantized values and scales are bit for bit
the JAX package's for the same f32 input: the same f32 division by the
scale (never a multiply by its reciprocal), round half to even, and the
nearest code by bisection over the codebook's midpoints (a value on a
midpoint takes the lower code, as ``searchsorted`` side "left" does).

The LM head and the embeddings stay in full precision.  Dequantizing is
plain PyTorch, run inside ``dense`` before the product, as the JAX package
leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

# bitsandbytes NF4 codebook (the QLoRA paper's appendix E): quantiles of
# N(0, 1) renormalized to [-1, 1], zero exactly representable
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

QUANT_FORMATS = ("int8", "int4", "nf4")


def _code(device) -> torch.Tensor:
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, rounded as a true division: PyTorch's CUDA kernel turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds differently from the JAX package's division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_kernel(w: torch.Tensor, fmt: str = "int8",
                    block_size: int = 64) -> dict:
    """[..., in, out] float kernel -> quantized dict (module layouts).
    Stacked [L, in, out] kernels are quantized one layer at a time, in
    every format (scales and blocks run along the contraction axis, so
    that is bit-identical), which keeps the f32 transients to one
    layer's."""
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"unknown quant format {fmt!r}")
    if w.dim() > 2:
        parts = [quantize_kernel(ws, fmt, block_size) for ws in w.unbind(0)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    if fmt == "int8":
        w32 = w.float()
        absmax = w32.abs().amax(dim=-2, keepdim=True)
        scales = torch.where(absmax == 0, torch.ones_like(absmax),
                             _div(absmax, 127.0))
        q = torch.clamp(torch.round(w32 / scales), -127, 127)
        return {"qvalues": q.to(torch.int8), "scales": scales}

    in_dim, out_dim = w.shape
    if in_dim % 2:
        raise ValueError(
            f"int4/nf4 packing needs an even contraction dim, got {in_dim}")
    if in_dim % block_size:
        # the largest even divisor <= block_size, so any in_dim quantizes
        block_size = next(b for b in range(min(block_size, in_dim), 0, -1)
                          if in_dim % b == 0 and (b % 2 == 0 or b == 1))
    nb = in_dim // block_size
    w32 = w.float().reshape(nb, block_size, out_dim)
    absmax = w32.abs().amax(dim=-2)                          # [nb, out]
    scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normed = w32 / scales[:, None, :]                        # in [-1, 1]
    if fmt == "int4":
        # symmetric round to nearest: codes 0..14 stand for -7..7
        q = torch.clamp(torch.round(normed * 7.0), -7, 7) + 7
    else:
        code = _code(w.device)
        mids = _div(code[:-1] + code[1:], 2.0)
        q = torch.searchsorted(mids, normed.contiguous(), right=False)
    q = q.reshape(in_dim, out_dim).to(torch.uint8)
    packed = q[0::2] | (q[1::2] << 4)                        # [in/2, out]
    return {("q4" if fmt == "int4" else "nf4"): packed, "scales": scales}


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> int32 [..., in, out] (even rows low)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    x = torch.stack([lo, hi], dim=-2)                 # [..., in/2, 2, out]
    return x.reshape(*packed.shape[:-2], -1, packed.shape[-1])


def dequantize_kernel(qk: dict, dtype=torch.float32) -> torch.Tensor:
    """Quant dict -> dense [..., in, out] kernel, computed in f32 and cast
    to ``dtype`` once, as the JAX producer does."""
    scales = qk["scales"].float()
    if "qvalues" in qk:
        return (qk["qvalues"].float() * scales).to(dtype)
    if "q4" in qk and "zeros" in qk:
        q = _unpack_nibbles(qk["q4"]).float()
        *lead, in_dim, out_dim = q.shape
        nb = scales.shape[-2]
        q = q.reshape(*lead, nb, in_dim // nb, out_dim)
        zeros = qk["zeros"].float()
        w = (q - zeros[..., :, None, :]) * scales[..., :, None, :]
        return w.reshape(*lead, in_dim, out_dim).to(dtype)
    if "q4" in qk:
        vals = _div((_unpack_nibbles(qk["q4"]) - 7).float(), 7.0)
    elif "nf4" in qk:
        idx = _unpack_nibbles(qk["nf4"])
        vals = _code(idx.device)[idx]
    else:
        raise ValueError(f"unrecognized quant dict keys {sorted(qk)}")
    *lead, in_dim, out_dim = vals.shape
    nb = scales.shape[-2]
    vals = vals.reshape(*lead, nb, in_dim // nb, out_dim)
    w = vals * scales[..., :, None, :]
    return w.reshape(*lead, in_dim, out_dim).to(dtype)


def is_quantized(kernel) -> bool:
    return isinstance(kernel, dict) and (
        "qvalues" in kernel or "q4" in kernel or "nf4" in kernel)


def quantized_shape(qk: dict) -> tuple[int, ...]:
    """Logical [..., in, out] shape of a quant dict."""
    if "qvalues" in qk:
        return tuple(qk["qvalues"].shape)
    packed = qk.get("q4", qk.get("nf4"))
    *lead, half, out = packed.shape
    return (*lead, half * 2, out)


def default_quant_predicate(path: str, leaf) -> bool:
    """Quantize decoder and tower linear kernels; keep the LM head, the
    embeddings (patch embeddings too) and every 1-D leaf in full
    precision."""
    return (path.endswith("kernel") and leaf.dim() >= 2
            and "lm_head" not in path and "embed" not in path)


def quantize_tree(params: Any,
                  predicate: Callable[[str, Any], bool] = default_quant_predicate,
                  fmt: str = "int8", block_size: int = 64) -> Any:
    """A copy of ``params`` with the targeted kernels replaced by quant
    dicts ("/"-joined dict keys are the paths the predicate reads, as the
    JAX tree paths); the other leaves are the same tensors.  Each kernel
    is quantized where it lies, on the card for a model on the card."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if node is not None and predicate(path, node):
            return quantize_kernel(node.detach(), fmt, block_size)
        return node

    return walk(params, "")


def dequantize_tree(tree: Any, dtype=torch.bfloat16) -> Any:
    """Every quant dict of ``tree`` replaced by a dense kernel carrying the
    quantization error (the base a QLoRA adapter trained against)."""
    if is_quantized(tree):
        return dequantize_kernel(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def quantized_bytes(tree: Any) -> tuple[int, int]:
    """(bytes now, bytes if every leaf were bf16), for reporting."""
    now = sum(t.numel() * t.element_size() for t in _leaves(tree))

    def bf16(node):
        if is_quantized(node):
            return 2 * math.prod(quantized_shape(node))
        if isinstance(node, dict):
            return sum(bf16(v) for v in node.values())
        return 0 if node is None else 2 * node.numel()

    return now, bf16(tree)
