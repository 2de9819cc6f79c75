"""Group-by sum on the card: SUM(vals) GROUP BY dense int32 ids (paper
Table 1, BlockAggregate; every SSB flight's aggregate on the opat chain).

Wrapper of the hand-written CUDA kernel ``csrc/agg.cu``, the port of the
Pallas TPU kernel ``repro/kernels/agg.py::group_sum``.  Same contract as
``ref.group_sum``: int32 values give wrapping int32 sums, bit for bit;
f32 values are summed in f64 in a fixed order and rounded to f32 once —
the same bits on every run, ``ref.group_sum``'s bits on integer-valued
data and within an f32 ulp of them otherwise.  An id outside
[0, n_groups) is dropped.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.group_sum``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_VAL_TYPES = (torch.int32, torch.float32)
_SIGNATURES = {
    "group_sum_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "group_sum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]),
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
