"""Sharding constraints the model code states as intent.

Model code never names a concrete mesh; it states intent
(``constrain(x, "batch", None, "model")``) and the helper resolves it
against the ambient mesh.  The port runs on one card, where there is no
mesh: ``_ambient_axes`` gives None and ``constrain`` returns its tensor,
so the model code is the reference's, line for line, at these calls.
"""
from __future__ import annotations

from typing import Optional

import torch


def _ambient_axes():
    """The ambient mesh, or None: one card has none."""
    return None


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """dims per tensor axis: "batch", "model", or None.  Without a mesh,
    ``x`` itself."""
    return x
