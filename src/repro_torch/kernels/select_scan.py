"""Selection scan on the card: SELECT y WHERE lo <= x <= hi, stable
(paper Fig. 4b, Q0/Q3; the opat chain's filter).

Wrappers of the hand-written CUDA kernels ``csrc/select_scan.cu``, the
port of the Pallas TPU kernels ``repro/kernels/select_scan.py::
select_scan``, ``select_scan_packed`` (the predicate column bit-packed,
decoded in registers) and ``select_scan_sparse`` (the paper's selective
load: y read only where a match is).  Same contract as
``ref.select_scan``, ``ref.select_scan_packed`` and
``ref.select_scan_sparse``: (out (n,), count), the selected entries in
row order and zeros past the count, bit for bit — the sparse scan's
output is ``select_scan``'s.

Each is one sweep of the card (``csrc/lookback.cuh``): a call is one
allocation (the output, the count and the kernel's status words), one
memset and one kernel, which also writes the zeros past the count; the
tensors are checked by one cheap test (``build.streams_ok``) and the
launch goes through ``build.launch``, as the opat pass's later filters
run on few rows, where the fixed cost is the time.  The sparse scan's
kernel is ``select_scan``'s under a name of its own
(``select_sparse_sweep``): its sweep already reads y only in the runs of
4 rows that hold a match, finer than the reference's 32-row unit.

The wrappers launch the kernel on CUDA tensors or raise; the choice of the
plain version for a CPU tensor is ``ops``' alone.  ``LAUNCHES`` counts the
plain kernel's launches of this process, ``PACKED_LAUNCHES`` the packed
kernel's and ``SPARSE_LAUNCHES`` the sparse one's.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.common import PHYS_WIDTHS

LAUNCHES = 0
PACKED_LAUNCHES = 0
SPARSE_LAUNCHES = 0

_X_TYPES = (torch.int32, torch.float32)
_Y_TYPES = (torch.int32, torch.float32, torch.uint32)


class _SelectArgs(ctypes.Structure):
    """``select_scan_launch``'s arguments (``csrc/select_scan.cu``'s
    ``SelectArgs``), passed by one pointer."""
    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("lo", ctypes.c_int),
                ("hi", ctypes.c_int), ("phys", ctypes.c_int),
                ("is_float", ctypes.c_int), ("sparse", ctypes.c_int),
                ("out", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("status", ctypes.c_void_p), ("blocks", ctypes.c_longlong)]


_SIGNATURES = {
    "select_scan_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "select_scan_shape": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p]),
    "select_scan_status_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "select_scan_tile_rows": (ctypes.c_longlong, []),
}


def library() -> ctypes.CDLL:
    return build.load("select_scan", _SIGNATURES)


def bound_bits(v, dtype: torch.dtype) -> int:
    """A bound as the 32-bit pattern of its value in x's type: f32
    rounding for a float x; an int32 x takes int32 bounds or raises
    (``ref.int32_bound``)."""
    if dtype == torch.float32:
        with np.errstate(over="ignore"):     # past f32's range: +-inf
            return int(np.float64(float(v)).astype(np.float32).view(np.int32))
    return ref.int32_bound(v)


def _sweep(x: torch.Tensor, y: torch.Tensor, n: int, lo_bits: int,
           hi_bits: int, phys: int, is_float: int, what: str,
           sparse: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep call: (out (n,) of y's type, count) from one allocation,
    one memset and one kernel on y's device."""
    lib = library()
    out, count, status = build.sweep_buffers(
        n, lib.select_scan_status_words(n), y.device, rows=1, dtype=y.dtype)
    args = _SelectArgs(x.data_ptr(), y.data_ptr(), n, lo_bits, hi_bits, phys,
                       is_float, sparse, out.data_ptr(), count.data_ptr(),
                       status, build.resident(
                           lib, "select_scan_shape", y.get_device(),
                           phys | is_float << 6 | sparse << 7))
    build.launch(lib, lib.select_scan_launch, y.device, what,
                 ctypes.addressof(args))
    return out[0], count


def _empty(device: torch.device, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((0,), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _plain(x: torch.Tensor, y: torch.Tensor, lo, hi, what: str
           ) -> Tuple[int, int, int]:
    """A plain scan's inputs checked -> (n, lo bits, hi bits)."""
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    n, index = x.shape[0], x.get_device()
    if not (x.dtype in _X_TYPES and y.dtype in _Y_TYPES and
            build.streams_ok(n, index, x.dtype, x) and
            build.streams_ok(n, index, y.dtype, y)):
        build.check_stream(x, "x", n, x.device, _X_TYPES)
        build.check_stream(y, "y", n, x.device, _Y_TYPES)
    if n >= 1 << 31:
        raise ValueError(f"{what} takes under 2^31 rows, got {n}")
    return n, bound_bits(lo, x.dtype), bound_bits(hi, x.dtype)


def select_scan(x: torch.Tensor, y: torch.Tensor, lo, hi
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count 0-d int64), both
    on x's device.  x: (n,) int32 or f32; y: (n,) 4-byte."""
    global LAUNCHES
    n, lo_bits, hi_bits = _plain(x, y, lo, hi, "select_scan")
    if n == 0:
        return _empty(x.device, y.dtype)
    got = _sweep(x, y, n, lo_bits, hi_bits, 32, int(x.dtype is torch.float32),
                 "select_scan")
    LAUNCHES += 1
    return got


def select_scan_sparse(x: torch.Tensor, y: torch.Tensor, lo, hi
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_scan``'s result, y read only where a match is -> (out
    (n,), count 0-d int64) on x's device.  x: (n,) int32 or f32; y: (n,)
    4-byte."""
    global SPARSE_LAUNCHES
    n, lo_bits, hi_bits = _plain(x, y, lo, hi, "select_scan_sparse")
    if n == 0:
        return _empty(x.device, y.dtype)
    got = _sweep(x, y, n, lo_bits, hi_bits, 32, int(x.dtype is torch.float32),
                 "select_scan_sparse", sparse=1)
    SPARSE_LAUNCHES += 1
    return got


def select_scan_packed(words: torch.Tensor, y: torch.Tensor, lo, hi,
                       phys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= decode(x) <= hi -> (out (n,), count 0-d
    int64), n = y.shape[0].  words: the packed int32 word stream of x at
    ``phys`` bits, ceil(n / (32 / phys)) words; lo, hi: int32 bounds in
    the encoded domain; y: (n,) 4-byte.  At phys 32 the words are a plain
    int32 x."""
    global PACKED_LAUNCHES
    if not words.is_cuda:
        raise ValueError(f"select_scan_packed: no kernel for device "
                         f"{words.device}")
    if phys not in PHYS_WIDTHS:
        raise ValueError(f"phys {phys} not in {PHYS_WIDTHS}")
    n, index = y.shape[0], words.get_device()
    n_words = -(-n // (32 // phys))
    if not (y.dtype in _Y_TYPES and
            build.streams_ok(n_words, index, torch.int32, words) and
            build.streams_ok(n, index, y.dtype, y)):
        build.check_stream(words, "words", n_words, words.device)
        build.check_stream(y, "y", n, words.device, _Y_TYPES)
    if n >= 1 << 31:
        raise ValueError(f"select_scan_packed takes under 2^31 rows, got {n}")
    lo_bits = bound_bits(lo, torch.int32)
    hi_bits = bound_bits(hi, torch.int32)
    if n == 0:
        return _empty(y.device, y.dtype)
    got = _sweep(words, y, n, lo_bits, hi_bits, phys, 0, "select_scan_packed")
    PACKED_LAUNCHES += 1
    return got
