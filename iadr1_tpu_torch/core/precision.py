"""Mixed-precision policy (counterpart of iadr1_tpu/core/precision.py):
bf16 matmul inputs and activations, f32 accumulation, f32 logits."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.bfloat16  # matmul inputs
    logits_dtype: torch.dtype = torch.float32    # final logits / softmax


DEFAULT_PRECISION = Precision()
FULL_PRECISION = Precision(compute_dtype=torch.float32)
