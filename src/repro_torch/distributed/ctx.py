"""The ambient mesh, and the sharding constraints model code states.

Model code never names a concrete mesh; it asks for the ambient one
(``_ambient_axes``), as the reference reads ``jax.sharding.set_mesh``'s.
``use_mesh(mesh)`` sets it for the calls inside its block: a
``DeviceMesh`` over the running process group (``distributed.mesh``), on
which ``moe.moe_ffn`` runs its expert-parallel path.

``constrain(x, "batch", None, "model")`` states layout intent.  It is the
identity: each rank holds local tensors, its own rows and its own slice
of the weights, so there is no global array to annotate, and the model
code is the reference's, line for line, at these calls.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_mesh",
                                                       default=None)


@dataclass(frozen=True)
class AmbientMesh:
    """The ambient mesh as model code reads it: the ``DeviceMesh``, its
    axis names, and each axis's size by name (``dict(am.shape)``, as the
    reference's ``Mesh.shape``)."""
    mesh: object
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh inside the
    block."""
    names = tuple(mesh.mesh_dim_names)
    token = _MESH.set(AmbientMesh(mesh, names, dict(zip(names,
                                                         mesh.shape))))
    try:
        yield
    finally:
        _MESH.reset(token)


def _ambient_axes() -> Optional[AmbientMesh]:
    """The ambient mesh, or None outside ``use_mesh``."""
    return _MESH.get()


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """dims per tensor axis: "batch", "model", or None.  ``x`` itself:
    a rank's tensors are already its local part."""
    return x
