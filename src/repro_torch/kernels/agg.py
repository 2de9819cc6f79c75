"""Aggregation on the card (paper Table 1, BlockAggregate), two kernels of
``csrc/agg.cu``:

``group_sum`` — SUM(vals) GROUP BY dense int32 ids (every SSB flight's
aggregate on the opat chain); the port of the Pallas TPU kernel
``repro/kernels/agg.py::group_sum``.  Same contract as
``ref.group_sum``: int32 values give wrapping int32 sums, bit for bit;
f32 values are summed in f64 in a fixed order and rounded to f32 once —
the same bits on every run, ``ref.group_sum``'s bits on integer-valued
data and within an f32 ulp of them otherwise.  An id outside
[0, n_groups) is dropped.

``reduce_sum`` — the global sum of an int32 or f32 column; the port of
``repro/kernels/agg.py::reduce_sum``.  Same contract as
``ref.reduce_sum``: an int32 sum wraps, bit for bit; an f32 sum is taken
in f64 in a fixed order and rounded once, with the same bits rule as
``group_sum`` (``ref.reduce_sum``'s bits when the f64 sum is exact,
within one f32 ulp otherwise).

The wrappers launch the kernels on CUDA tensors or raise; the choice of
the plain version for a CPU tensor is ``ops``'s alone.  ``LAUNCHES``
counts ``group_sum``'s launches of this process, ``SUM_LAUNCHES``
``reduce_sum``'s.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0
SUM_LAUNCHES = 0
SUM_ROWS_PER_BLOCK = 4 * 256      # one 16-byte load a thread (kSumThreads)

_VAL_TYPES = (torch.int32, torch.float32)
_SIGNATURES = {
    "group_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "group_sum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]),
    "reduce_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "reduce_sum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
}


def library() -> ctypes.CDLL:
    return build.load("agg", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _shape(device: int, n_groups: int, is_float: bool
           ) -> Tuple[int, int, int, int]:
    """The CUDA source's launch shape for one card and group count: (rows
    a block takes per grid step, blocks resident, partial grid rows a
    block writes, the most groups), asked once."""
    lib = library()
    shape = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        build.check(lib, lib.group_sum_shape(n_groups, int(is_float), shape),
                    "group_sum")
    return tuple(shape)


def group_sum(group_ids: torch.Tensor, vals: torch.Tensor,
              n_groups: int) -> torch.Tensor:
    """(n_groups,) sums in vals' dtype on vals' device.  group_ids: (n,)
    int32; vals: (n,) int32 or f32."""
    global LAUNCHES
    if vals.device.type != "cuda":
        raise ValueError(f"group_sum: no kernel for device {vals.device}")
    device, n = vals.device, vals.shape[0]
    build.check_stream(group_ids, "group_ids", n, device)
    build.check_stream(vals, "vals", n, device, _VAL_TYPES)
    if n_groups < 1:
        raise ValueError(f"n_groups={n_groups}: at least one group")
    is_float = vals.dtype == torch.float32
    step_rows, resident, block_rows, max_groups = _shape(
        device.index, n_groups, is_float)
    if n_groups > max_groups:
        raise ValueError(f"n_groups={n_groups}: one warp's f64 grid fits "
                         f"{max_groups} groups of shared memory")
    out = torch.zeros((n_groups,), dtype=vals.dtype, device=device)
    if n == 0:
        return out
    blocks = max(1, min(-(-n // step_rows), resident))
    partials = (torch.empty((blocks * block_rows, n_groups),
                            dtype=torch.float64, device=device)
                if is_float else None)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.group_sum_launch(
            group_ids.data_ptr(), vals.data_ptr(), n, n_groups,
            int(is_float), blocks, block_rows,
            0 if partials is None else partials.data_ptr(), out.data_ptr(),
            stream)
    build.check(lib, rc, "group_sum")
    LAUNCHES += 1
    return out


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """-> 0-d int32 (int32 x) or f32 (f32 x) on x's device.  x: (n,)."""
    global SUM_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"reduce_sum: no kernel for device {x.device}")
    device, n = x.device, x.shape[0]
    build.check_stream(x, "x", n, device, _VAL_TYPES)
    is_float = x.dtype == torch.float32
    out = torch.zeros((), dtype=x.dtype, device=device)
    if n == 0:
        return out
    lib = library()
    blocks = max(1, min(build.resident(lib, "reduce_sum_shape", device.index,
                                       int(is_float)),
                        -(-n // SUM_ROWS_PER_BLOCK)))
    partials = torch.empty((blocks,), dtype=torch.float64 if is_float
                           else torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.reduce_sum_launch(x.data_ptr(), n, int(is_float), blocks,
                                   partials.data_ptr(), out.data_ptr(),
                                   stream)
    build.check(lib, rc, "reduce_sum")
    SUM_LAUNCHES += 1
    return out
