"""Where the port's entry points run.

Every entry point takes ``device=None`` and then runs on the card.  The
CPU is used only when a caller names it (the tests do): without CUDA an
unnamed device is an error, never a quiet fall back to the host.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit CUDA index (so
    "cuda" and "cuda:0" name one residency), or the current card when
    ``device`` is None."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
