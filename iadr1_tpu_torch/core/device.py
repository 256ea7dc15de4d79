"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, else the card: ``cuda``, or under a
    multi-process launch ``cuda:{LOCAL_RANK}`` (one card a process).

    With no device given and no card present this raises: the entry
    points never carry on silently on the CPU (tests pass
    ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    from iadr1_tpu_torch.core.distributed import detect_distributed_mode

    mode = detect_distributed_mode()
    if mode is not None:
        return torch.device(f"cuda:{mode[1]['local_rank']}")
    return torch.device("cuda")
