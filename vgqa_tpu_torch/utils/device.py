"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Without a
    visible CUDA device that raises: the caller asks for the CPU itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass device=\"cpu\" to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)
