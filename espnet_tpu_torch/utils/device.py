"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one that is an error. The CPU is
    used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
