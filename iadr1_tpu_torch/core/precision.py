"""Mixed-precision policy (counterpart of iadr1_tpu/core/precision.py):
f32 parameters and optimizer state, bf16 matmul inputs and activations,
f32 logits.  The bundles store parameters in ``param_dtype`` unless a
caller names another dtype.  Matmuls accumulate in f32 always (cuBLAS
does for bf16 inputs), so the JAX ``accum_dtype`` has no counterpart."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32     # stored parameters
    compute_dtype: torch.dtype = torch.bfloat16  # matmul inputs
    logits_dtype: torch.dtype = torch.float32    # final logits / softmax


DEFAULT_PRECISION = Precision()
FULL_PRECISION = Precision(compute_dtype=torch.float32)
