"""The device an entry point runs on: ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA without a card raises (no silent CPU
fallback)."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA device "
                           "is available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return device
