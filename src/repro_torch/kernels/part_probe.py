"""Partitioned probe on the card: every partition of a radix-partitioned
join probed against its own table in one launch (paper §4.4, Fig. 8).

Wrapper of the hand-written CUDA kernel ``csrc/part_probe.cu``, the port
of the Pallas TPU kernel ``repro/kernels/part_probe.py::part_probe``.
Same contract as ``ref.part_probe``: (rowids (n,), groups + payload·mult
(n,), count), the matches in flat (partition-major) order and zeros past
the count, bit for bit.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops``' alone.  ``LAUNCHES`` counts
the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_SIGNATURES = {
    "part_probe_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]),
    "part_probe_tile_rows": (ctypes.c_longlong, []),
}


def library() -> ctypes.CDLL:
    return build.load("part_probe", _SIGNATURES)


def _pow2(v: int) -> bool:
    return v >= 1 and not v & (v - 1)


def part_probe(keys: torch.Tensor, rowids: torch.Tensor,
               groups: torch.Tensor, offs: torch.Tensor,
               counts: torch.Tensor, htk: torch.Tensor, htv: torch.Tensor,
               mult) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (rowids (n,) int32, groups (n,) int32, count 0-d int64) on the
    keys' device.  keys, rowids, groups: (n,) int32, partition-major;
    offs, counts: (P,) int32, each partition's run; htk, htv: (P, S)
    int32 packed tables, P and S powers of two; mult: int32."""
    global LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"part_probe: no kernel for device {keys.device}")
    device, n = keys.device, keys.shape[0]
    for name, t in (("keys", keys), ("rowids", rowids), ("groups", groups)):
        build.check_stream(t, name, n, device)
    if htk.dim() != 2 or htk.shape != htv.shape or \
            not htk.is_contiguous() or not htv.is_contiguous():
        raise ValueError(f"htk, htv must be contiguous (P, S), got "
                         f"{tuple(htk.shape)} and {tuple(htv.shape)}")
    n_parts, n_slots = htk.shape
    if not _pow2(n_parts) or not _pow2(n_slots) or n_slots > 1 << 32 or \
            n_parts >= 1 << 31:
        raise ValueError(f"tables ({n_parts}, {n_slots}): P and S must be "
                         "powers of 2, S up to 2^32")
    build.check_stream(htk.view(-1), "htk", n_parts * n_slots, device)
    build.check_stream(htv.view(-1), "htv", n_parts * n_slots, device)
    build.check_stream(offs, "offs", n_parts, device)
    build.check_stream(counts, "counts", n_parts, device)
    if n >= 1 << 31:
        raise ValueError(f"part_probe takes under 2^31 rows, got {n}")
    mult = int(mult)
    if not -(1 << 31) <= mult < 1 << 31:
        raise ValueError(f"mult {mult} is not an int32 value")
    out = torch.zeros((2, n), dtype=torch.int32, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    if n == 0:
        return out[0], out[1], count
    lib = library()
    tiles = -(-n // lib.part_probe_tile_rows())
    scratch = torch.empty((2, tiles), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.part_probe_launch(
            keys.data_ptr(), rowids.data_ptr(), groups.data_ptr(), n,
            offs.data_ptr(), counts.data_ptr(), n_parts, htk.data_ptr(),
            htv.data_ptr(), n_slots - 1, mult, scratch[0].data_ptr(),
            scratch[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            count.data_ptr(), stream)
    build.check(lib, rc, "part_probe")
    LAUNCHES += 1
    return out[0], out[1], count
