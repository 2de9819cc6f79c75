"""Selection scan on the card: SELECT y WHERE lo <= x <= hi, stable
(paper Fig. 4b, Q0/Q3; the opat chain's filter).

Wrapper of the hand-written CUDA kernel ``csrc/select_scan.cu``, the port
of the Pallas TPU kernel ``repro/kernels/select_scan.py::select_scan``.
Same contract as ``ref.select_scan``: (out (n,), count), the selected
entries in row order and zeros past the count, bit for bit.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.select_scan``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_X_TYPES = (torch.int32, torch.float32)
_Y_TYPES = (torch.int32, torch.float32, torch.uint32)
_SIGNATURES = {
    "select_scan_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "select_scan_tile_rows": (ctypes.c_longlong, []),
}


def library() -> ctypes.CDLL:
    return build.load("select_scan", _SIGNATURES)


def bound_bits(v, dtype: torch.dtype) -> int:
    """A bound as the 32-bit pattern of its value in x's type: f32
    rounding for a float x; an int32 x takes int32 bounds or raises."""
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", float(v)))[0]
    if v != int(v) or not -(1 << 31) <= int(v) < (1 << 31):
        raise ValueError(f"bound {v!r} is not an int32 value")
    return int(v)


def select_scan(x: torch.Tensor, y: torch.Tensor, lo, hi
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count 0-d int64), both
    on x's device.  x: (n,) int32 or f32; y: (n,) 4-byte."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"select_scan: no kernel for device {x.device}")
    n = x.shape[0]
    build.check_stream(x, "x", n, x.device, _X_TYPES)
    build.check_stream(y, "y", n, x.device, _Y_TYPES)
    if n >= 1 << 31:
        raise ValueError(f"select_scan takes under 2^31 rows, got {n}")
    lo_bits, hi_bits = bound_bits(lo, x.dtype), bound_bits(hi, x.dtype)
    out = torch.zeros_like(y)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    if n == 0:
        return out, count
    lib = library()
    tiles = -(-n // lib.select_scan_tile_rows())
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.select_scan_launch(
            x.data_ptr(), y.data_ptr(), n, lo_bits, hi_bits,
            int(x.dtype == torch.float32), scratch[0].data_ptr(),
            scratch[1].data_ptr(), out.data_ptr(), count.data_ptr(), stream)
    build.check(lib, rc, "select_scan")
    LAUNCHES += 1
    return out, count
