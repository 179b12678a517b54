"""Where the port's entry points put their tensors.

Everything that builds device state (plans, models, the server) runs on the
card unless the caller asks for the CPU: ``device=None`` means the current
CUDA device, and there is no quiet fallback when no card is present.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a concrete ``torch.device``: ``None`` is the current
    CUDA device; raises when a CUDA device is asked for and none exists."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the card by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
