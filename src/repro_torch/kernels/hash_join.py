"""Probe-join on the card: the rows whose key is found in a linear-probe
table, as stable compacted (payload, val) pairs (paper §4.3; the opat
chain's join).

Wrapper of the hand-written CUDA kernel ``csrc/hash_join.cu``, the port of
the Pallas TPU kernel ``repro/kernels/hash_join.py::probe_join``.  Same
contract as ``ref.probe_join``: (payload (n,), vals (n,), count), the
found rows in row order and zeros past the count, bit for bit.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.probe_join``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_SIGNATURES = {
    "probe_join_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "probe_join_tile_rows": (ctypes.c_longlong, []),
}


def library() -> ctypes.CDLL:
    return build.load("hash_join", _SIGNATURES)


def probe_join(keys: torch.Tensor, vals: torch.Tensor,
               ht_keys: torch.Tensor, ht_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (payload (n,) int32, vals (n,) int32, count 0-d int64) on the
    keys' device.  keys, vals: (n,) int32; ht_keys, ht_vals: (S,) int32
    open-addressing table, S a power of two."""
    global LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"probe_join: no kernel for device {keys.device}")
    device, n, s = keys.device, keys.shape[0], ht_keys.shape[0]
    build.check_stream(keys, "keys", n, device)
    build.check_stream(vals, "vals", n, device)
    build.check_stream(ht_keys, "ht_keys", s, device)
    build.check_stream(ht_vals, "ht_vals", s, device)
    if s < 1 or s & (s - 1) or s > 1 << 32:
        raise ValueError(f"slot count {s} is not a power of 2 up to 2^32")
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
