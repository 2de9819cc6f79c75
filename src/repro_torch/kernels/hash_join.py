"""Hash-join probes on the card (paper §4.3), two kernels of
``csrc/hash_join.cu``:

``probe_join`` — the rows whose key is found in a linear-probe table, as
stable compacted (payload, val) pairs (the opat chain's join); the port
of the Pallas TPU kernel ``repro/kernels/hash_join.py::probe_join``.  Same
contract as ``ref.probe_join``: (payload (n,), vals (n,), count), the
found rows in row order and zeros past the count, bit for bit.

``probe_agg`` — SUM(payload + v) over the found rows (the paper's join
microbenchmark); the port of ``repro/kernels/hash_join.py::probe_agg``.
Same contract as ``ref.probe_agg``: int32 sums wrap, bit for bit; f32
values are summed in f64 in a fixed order and rounded once (the same
bits on every run, ``ref.probe_agg``'s when the f64 sum is exact, as on
integer-valued data, and within one f32 ulp of them otherwise).

The wrappers launch the kernels on CUDA tensors or raise; the choice of
the plain version for a CPU tensor is ``ops``'s alone.  ``LAUNCHES``
counts ``probe_join``'s launches of this process, ``AGG_LAUNCHES``
``probe_agg``'s.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0
AGG_LAUNCHES = 0

_SIGNATURES = {
    "probe_join_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "probe_join_tile_rows": (ctypes.c_longlong, []),
    "probe_agg_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "probe_agg_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "probe_agg_tile_rows": (ctypes.c_longlong, []),
}
_VAL_TYPES = (torch.int32, torch.float32)


def library() -> ctypes.CDLL:
    return build.load("hash_join", _SIGNATURES)


def _check_table(ht_keys: torch.Tensor, ht_vals: torch.Tensor,
                 device: torch.device) -> int:
    """The table's slot count, checked: a power of two up to 2^32."""
    s = ht_keys.shape[0]
    build.check_stream(ht_keys, "ht_keys", s, device)
    build.check_stream(ht_vals, "ht_vals", s, device)
    if s < 1 or s & (s - 1) or s > 1 << 32:
        raise ValueError(f"slot count {s} is not a power of 2 up to 2^32")
    return s


def probe_agg(keys: torch.Tensor, vals: torch.Tensor,
              ht_keys: torch.Tensor, ht_vals: torch.Tensor) -> torch.Tensor:
    """-> 0-d tensor of vals' dtype on the keys' device.  keys: (n,)
    int32; vals: (n,) int32 or f32; ht_keys, ht_vals: (S,) int32
    open-addressing table, S a power of two."""
    global AGG_LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"probe_agg: no kernel for device {keys.device}")
    device, n = keys.device, keys.shape[0]
    build.check_stream(keys, "keys", n, device)
    build.check_stream(vals, "vals", n, device, _VAL_TYPES)
    s = _check_table(ht_keys, ht_vals, device)
    is_float = vals.dtype == torch.float32
    out = torch.zeros((), dtype=vals.dtype, device=device)
    if n == 0:
        return out
    lib = library()
    blocks = max(1, min(build.resident(lib, "probe_agg_shape", device.index,
                                       int(is_float)),
                        -(-n // lib.probe_agg_tile_rows())))
    partials = torch.empty((blocks,), dtype=torch.float64 if is_float
                           else torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.probe_agg_launch(
            keys.data_ptr(), vals.data_ptr(), n, int(is_float),
            ht_keys.data_ptr(), ht_vals.data_ptr(), s - 1, blocks,
            partials.data_ptr(), out.data_ptr(), stream)
    build.check(lib, rc, "probe_agg")
    AGG_LAUNCHES += 1
    return out


def probe_join(keys: torch.Tensor, vals: torch.Tensor,
               ht_keys: torch.Tensor, ht_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (payload (n,) int32, vals (n,) int32, count 0-d int64) on the
    keys' device.  keys, vals: (n,) int32; ht_keys, ht_vals: (S,) int32
    open-addressing table, S a power of two."""
    global LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"probe_join: no kernel for device {keys.device}")
    device, n = keys.device, keys.shape[0]
    build.check_stream(keys, "keys", n, device)
    build.check_stream(vals, "vals", n, device)
    s = _check_table(ht_keys, ht_vals, device)
    if n >= 1 << 31:
        raise ValueError(f"probe_join takes under 2^31 rows, got {n}")
    out = torch.zeros((2, n), dtype=torch.int32, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    if n == 0:
        return out[0], out[1], count
    lib = library()
    tiles = -(-n // lib.probe_join_tile_rows())
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.probe_join_launch(
            keys.data_ptr(), vals.data_ptr(), n, ht_keys.data_ptr(),
            ht_vals.data_ptr(), s - 1, scratch[0].data_ptr(),
            scratch[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            count.data_ptr(), stream)
    build.check(lib, rc, "probe_join")
    LAUNCHES += 1
    return out[0], out[1], count
