"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, else ``cuda``.

    With no device given and no card present this raises: the entry
    points never carry on silently on the CPU (tests pass
    ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")
