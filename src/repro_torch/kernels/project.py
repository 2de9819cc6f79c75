"""Projection on the card: a*x1 + b*x2, optionally sigmoid (paper §4.1,
Q1/Q2; the opat chain's ``sub`` measure).

Wrapper of the hand-written CUDA kernel ``csrc/project.cu``, the port of
the Pallas TPU kernel ``repro/kernels/project.py::project``.  Without the
sigmoid it gives ``ref.project``'s bits; with it, within a few f32 ulps
(``expf``).

The opat pass calls it on a few hundred thousand rows, where a call costs
its fixed host path more than its bytes.  So the tensors are checked by
one cheap test (``build.streams_ok``; ``check_stream`` names what is
wrong when it fails), the arguments cross to C by one pointer, the C
side asks the runtime nothing but the launch, and the launch goes
through ``build.launch``.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.project``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_F32 = (torch.float32,)


class _Args(ctypes.Structure):
    """``project_launch``'s arguments (``csrc/project.cu``'s
    ``ProjectArgs``), passed by one pointer."""
    _fields_ = [("x1", ctypes.c_void_p), ("x2", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("a", ctypes.c_float), ("b", ctypes.c_float),
                ("sigmoid", ctypes.c_int)]


_SIGNATURES = {
    "project_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p])}


def library() -> ctypes.CDLL:
    return build.load("project", _SIGNATURES)


def project(x1: torch.Tensor, x2: torch.Tensor, a, b,
            sigmoid: bool = False) -> torch.Tensor:
    """(n,) f32 a*x1 + b*x2 (then 1 / (1 + exp(-y)) with ``sigmoid``) on
    x1's device; a and b are taken as f32."""
    global LAUNCHES
    if not x1.is_cuda:
        raise ValueError(f"project: no kernel for device {x1.device}")
    n = x1.shape[0]
    if not build.streams_ok(n, x1.get_device(), torch.float32, x1, x2):
        build.check_stream(x1, "x1", n, x1.device, _F32)
        build.check_stream(x2, "x2", n, x1.device, _F32)
    out = torch.empty_like(x1)
    if n == 0:
        return out
    lib = library()
    args = _Args(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), n, float(a),
                 float(b), bool(sigmoid))
    build.launch(lib, lib.project_launch, x1.device, "project",
                 ctypes.addressof(args))
    LAUNCHES += 1
    return out
