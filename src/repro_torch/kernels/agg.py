"""Aggregation on the card (paper Table 1, BlockAggregate), two kernels of
``csrc/agg.cu``:

``group_sum`` — SUM(vals) GROUP BY dense int32 ids (every SSB flight's
aggregate on the opat chain); the port of the Pallas TPU kernel
``repro/kernels/agg.py::group_sum``.  Same contract as
``ref.group_sum``: int32 values give wrapping int32 sums, bit for bit;
f32 values are summed exactly (in int64, where they are integers of
magnitude at most 2^31) or in f64 in a fixed order, and rounded to f32
once — the same bits on every run, ``ref.group_sum``'s bits on
integer-valued data and within an f32 ulp of them otherwise.  An id
outside [0, n_groups) is dropped.  A call is one cooperative launch,
sized by its rows (``group_grid``), which writes the output whole (or
adds into ``acc``); the blocks' partial rows, when there is more than
one block, are the call's only other allocation.

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
# group_sum's grid: a block for at least this many rows, and the blocks'
# partial rows at most 1 / PARTIAL_SHARE of the 8n bytes of ids and vals
GROUP_BLOCK_ROWS = 8 * 1024
PARTIAL_SHARE = 4

_VAL_TYPES = (torch.int32, torch.float32)
_SIGNATURES = {
    "group_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "group_sum_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "reduce_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "reduce_sum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
}


def library() -> ctypes.CDLL:
    return build.load("agg", _SIGNATURES)


class _GroupArgs(ctypes.Structure):
    """``group_sum_launch``'s arguments (``csrc/agg.cu``'s ``GroupArgs``),
    passed by one pointer."""
    _fields_ = [("ids", ctypes.c_void_p), ("vals", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("n_groups", ctypes.c_int),
                ("is_float", ctypes.c_int), ("blocks", ctypes.c_longlong),
                ("warps", ctypes.c_int), ("partials", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("acc", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _shape(device: int, n_groups: int, is_float: bool
           ) -> Tuple[int, int, int]:
    """The CUDA source's launch shape for one card and group count:
    (blocks resident, warps that own an f64 grid, the most groups),
    asked once."""
    lib = library()
    shape = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        build.check(lib, lib.group_sum_shape(n_groups, int(is_float), shape),
                    "group_sum")
    return tuple(shape)


def group_grid(n: int, n_groups: int, resident: int,
               partial_bytes: int) -> int:
    """Blocks of one ``group_sum`` launch over n rows: a block for every
    GROUP_BLOCK_ROWS rows, up to the ``resident`` blocks, and few enough
    that their partial rows (blocks x n_groups x ``partial_bytes``: 8 for
    the f64 sums of f32 values, 4 for int32) stay within 1 / PARTIAL_SHARE
    of the 8n bytes of ids and vals; at least one, which writes no partial
    row."""
    by_bytes = 8 * n // (PARTIAL_SHARE * n_groups * partial_bytes)
    return max(1, min(resident, n // GROUP_BLOCK_ROWS, by_bytes))


def group_sum(group_ids: torch.Tensor, vals: torch.Tensor,
              n_groups: int, acc=None) -> torch.Tensor:
    """(n_groups,) sums in vals' dtype on vals' device.  group_ids: (n,)
    int32; vals: (n,) int32 or f32.  ``acc``: the running grid of a
    morsel fold, ``ref.group_acc_dtype``'s type (f64 for f32 vals, int32
    for int32): the sums are added to it unrounded and it is returned."""
    global LAUNCHES
    if vals.device.type != "cuda":
        raise ValueError(f"group_sum: no kernel for device {vals.device}")
    device, n, index = vals.device, vals.shape[0], vals.get_device()
    if not (vals.dtype in _VAL_TYPES and
            build.streams_ok(n, index, torch.int32, group_ids) and
            build.streams_ok(n, index, vals.dtype, vals)):
        build.check_stream(group_ids, "group_ids", n, device)
        build.check_stream(vals, "vals", n, device, _VAL_TYPES)
    if n_groups < 1:
        raise ValueError(f"n_groups={n_groups}: at least one group")
    is_float = vals.dtype is torch.float32
    resident, warps, max_groups = _shape(index, n_groups, is_float)
    if n_groups > max_groups:
        raise ValueError(f"n_groups={n_groups}: one warp's f64 grid fits "
                         f"{max_groups} groups of shared memory")
    if acc is not None:
        ref.check_acc(acc, (n_groups,), device, ref.group_acc_dtype(vals))
        if n == 0:
            return acc
        out = None
    else:
        out = torch.empty((n_groups,), dtype=vals.dtype, device=device)
    width = 8 if is_float else 4
    blocks = group_grid(n, n_groups, resident, width)
    partials = (torch.empty((blocks * n_groups * width // 4,),
                            dtype=torch.int32, device=device)
                if blocks > 1 else None)
    lib = library()
    args = _GroupArgs(group_ids.data_ptr(), vals.data_ptr(), n, n_groups,
                      int(is_float), blocks, warps,
                      None if partials is None else partials.data_ptr(),
                      None if out is None else out.data_ptr(),
                      None if acc is None else acc.data_ptr())
    build.launch(lib, lib.group_sum_launch, device, "group_sum",
                 ctypes.addressof(args))
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
