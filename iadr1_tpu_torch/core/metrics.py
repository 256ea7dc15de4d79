"""Throughput and MFU accounting (the port's own copy of
iadr1_tpu/core/metrics.py): an analytic FLOPs model for decoder
transformers and ViT towers, and a meter that turns step timings into
tokens/s and MFU.  The peak FLOP/s is the caller's (989e12 for an H100
SXM's dense bf16 tensor cores); nothing here assumes a device."""

from __future__ import annotations

import dataclasses


def transformer_flops_per_token(
    hidden: int,
    intermediate: int,
    num_layers: int,
    vocab: int,
    seq_len: int,
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
    head_dim: int | None = None,
) -> float:
    """Forward FLOPs per token (multiply by 3 for fwd+bwd): 2 * matmul
    parameters + attention score/value FLOPs (causal halves the window)."""
    if head_dim is None:
        head_dim = hidden // (num_heads or 1)
    q_dim = (num_heads or hidden // head_dim) * head_dim
    kv_dim = (num_kv_heads or num_heads or hidden // head_dim) * head_dim
    per_layer = 2 * hidden * (q_dim + 2 * kv_dim)        # qkv proj
    per_layer += 2 * q_dim * hidden                      # o proj
    per_layer += 3 * 2 * hidden * intermediate           # gate/up/down
    per_layer += 2 * 2 * q_dim * (seq_len / 2)           # qk^T and pv, causal
    total = num_layers * per_layer
    total += 2 * hidden * vocab                          # lm head
    return float(total)


def vit_flops_per_patch(
    hidden: int,
    intermediate: int,
    num_layers: int,
    attn_window: int,
) -> float:
    """Forward FLOPs per ViT patch (qkv/o + MLP + windowed attention)."""
    per_layer = 2 * hidden * hidden * 4            # qkv + o proj
    per_layer += 2 * 2 * hidden * intermediate     # MLP (2 matmuls)
    per_layer += 2 * 2 * hidden * attn_window      # qk^T + pv, full window
    return float(num_layers * per_layer)


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates step timings -> tokens/s and MFU of one device against
    ``peak_flops`` (its dense peak, given by the caller)."""

    flops_per_token_fwd: float
    peak_flops: float
    backward: bool = True

    tokens: int = 0
    seconds: float = 0.0

    def update(self, n_tokens: int, dt: float) -> None:
        self.tokens += n_tokens
        self.seconds += dt

    @property
    def tokens_per_sec(self) -> float:
        if self.seconds == 0:
            return 0.0
        return self.tokens / self.seconds

    @property
    def mfu(self) -> float:
        mult = 3.0 if self.backward else 1.0
        return (self.tokens_per_sec * self.flops_per_token_fwd * mult
                / self.peak_flops)


# one H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
H100_PEAK_BF16_FLOPS = 989e12
