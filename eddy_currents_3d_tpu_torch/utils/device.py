"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; None means the current CUDA
    device, and raises when there is none (the package's entry points run
    on the card unless the caller asks for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
