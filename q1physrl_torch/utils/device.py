"""The device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ("resolve_device",)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device
