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
from repro_torch.kernels import ref

LAUNCHES = 0
SUM_LAUNCHES = 0
SUM_ROWS_PER_BLOCK = 4 * 1024     # one 16-byte load a thread (kSumBlock)

_VAL_TYPES = (torch.int32, torch.float32)
_SIGNATURES = {
    "group_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "group_sum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
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
              n_groups: int, acc=None) -> torch.Tensor:
    """(n_groups,) sums in vals' dtype on vals' device.  group_ids: (n,)
    int32; vals: (n,) int32 or f32.  ``acc``: the running grid of a
    morsel fold, ``ref.group_acc_dtype``'s type (f64 for f32 vals, int32
    for int32): the sums are added to it unrounded and it is returned."""
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
    if acc is not None:
        ref.check_acc(acc, (n_groups,), device, ref.group_acc_dtype(vals))
    out = (acc if acc is not None and not is_float else
           torch.zeros((n_groups,), dtype=vals.dtype, device=device))
    if n == 0:
        return out if acc is None else acc
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
            acc.data_ptr() if acc is not None and is_float else 0, stream)
    build.check(lib, rc, "group_sum")
    LAUNCHES += 1
    return out if acc is None else acc


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """-> 0-d int32 (int32 x) or f32 (f32 x) on x's device.  x: (n,).
    One memset and one kernel a call: the kernel writes all of ``out``,
    and the partials and the ticket of its last block's finish lie in one
    scratch allocation of the call's own."""
    global SUM_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"reduce_sum: no kernel for device {x.device}")
    device, n = x.device, x.shape[0]
    build.check_stream(x, "x", n, device, _VAL_TYPES)
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=device)
    is_float = x.dtype == torch.float32
    lib = library()
    blocks = max(1, min(build.resident(lib, "reduce_sum_shape", device.index,
                                       int(is_float)),
                        -(-n // SUM_ROWS_PER_BLOCK)))
    out = torch.empty((), dtype=x.dtype, device=device)
    # an 8-byte partial a block, then the ticket
    scratch = torch.empty((blocks + 1,), dtype=torch.int64, device=device)
    build.launch(lib, lib.reduce_sum_launch, device, "reduce_sum",
                 x.data_ptr(), n, int(is_float), blocks, scratch.data_ptr(),
                 out.data_ptr())
    SUM_LAUNCHES += 1
    return out
