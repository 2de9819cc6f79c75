"""Projection on the card: a*x1 + b*x2, optionally sigmoid (paper §4.1,
Q1/Q2; the opat chain's ``sub`` measure).

Wrapper of the hand-written CUDA kernel ``csrc/project.cu``, the port of
the Pallas TPU kernel ``repro/kernels/project.py::project``.  Without the
sigmoid it gives ``ref.project``'s bits; with it, within a few f32 ulps
(``expf``).

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
_SIGNATURES = {"project_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])}


def library() -> ctypes.CDLL:
    return build.load("project", _SIGNATURES)


def project(x1: torch.Tensor, x2: torch.Tensor, a, b,
            sigmoid: bool = False) -> torch.Tensor:
    """(n,) f32 a*x1 + b*x2 (then 1 / (1 + exp(-y)) with ``sigmoid``) on
    x1's device; a and b are taken as f32."""
    global LAUNCHES
    if x1.device.type != "cuda":
        raise ValueError(f"project: no kernel for device {x1.device}")
    n = x1.shape[0]
    build.check_stream(x1, "x1", n, x1.device, _F32)
    build.check_stream(x2, "x2", n, x1.device, _F32)
    out = torch.empty_like(x1)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        rc = lib.project_launch(x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
                                n, float(a), float(b), int(bool(sigmoid)),
                                stream)
    build.check(lib, rc, "project")
    LAUNCHES += 1
    return out
