"""Partitioned probe on the card: every partition of a radix-partitioned
join probed against its own table in one launch (paper §4.4, Fig. 8).

Wrapper of the hand-written CUDA kernel ``csrc/part_probe.cu``, the port
of the Pallas TPU kernel ``repro/kernels/part_probe.py::part_probe``.
Same contract as ``ref.part_probe``: (rowids (n,), groups + payload·mult
(n,), count), the matches in flat (partition-major) order and zeros past
the count, bit for bit.  A call is one allocation, one memset and one
kernel, which also writes the zeros past the count; the tensors are
checked by one cheap test (``build.streams_ok``) and the launch goes
through ``build.launch``.

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


class _PartArgs(ctypes.Structure):
    """``part_probe_launch``'s arguments (``csrc/part_probe.cu``'s
    ``PartArgs``), passed by one pointer."""
    _fields_ = [("keys", ctypes.c_void_p), ("rowids", ctypes.c_void_p),
                ("groups", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("offs", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("n_parts", ctypes.c_int), ("htk", ctypes.c_void_p),
                ("htv", ctypes.c_void_p), ("slot_mask", ctypes.c_uint),
                ("mult", ctypes.c_int), ("out_rowids", ctypes.c_void_p),
                ("out_groups", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("status", ctypes.c_void_p), ("blocks", ctypes.c_longlong)]


_SIGNATURES = {
    "part_probe_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "part_probe_status_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "part_probe_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
}


def library() -> ctypes.CDLL:
    return build.load("part_probe", _SIGNATURES)


def _pow2(v: int) -> bool:
    return v >= 1 and not v & (v - 1)


def _check(keys, rowids, groups, offs, counts, htk, htv) -> None:
    """Raise with what is wrong with part_probe's tensors."""
    device, n = keys.device, keys.shape[0]
    for name, t in (("keys", keys), ("rowids", rowids), ("groups", groups)):
        build.check_stream(t, name, n, device)
    if htk.dim() != 2 or htk.shape != htv.shape or \
            not htk.is_contiguous() or not htv.is_contiguous():
        raise ValueError(f"htk, htv must be contiguous (P, S), got "
                         f"{tuple(htk.shape)} and {tuple(htv.shape)}")
    n_parts, n_slots = htk.shape
    if not _pow2(n_parts) or not _pow2(n_slots) or \
            n_parts * n_slots > 1 << 32:
        raise ValueError(f"tables ({n_parts}, {n_slots}): P and S must be "
                         "powers of 2, P * S up to 2^32")
    build.check_stream(htk.view(-1), "htk", n_parts * n_slots, device)
    build.check_stream(htv.view(-1), "htv", n_parts * n_slots, device)
    build.check_stream(offs, "offs", n_parts, device)
    build.check_stream(counts, "counts", n_parts, device)


def part_probe(keys: torch.Tensor, rowids: torch.Tensor,
               groups: torch.Tensor, offs: torch.Tensor,
               counts: torch.Tensor, htk: torch.Tensor, htv: torch.Tensor,
               mult) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (rowids (n,) int32, groups (n,) int32, count 0-d int64) on the
    keys' device.  keys, rowids, groups: (n,) int32, partition-major;
    offs, counts: (P,) int32, each partition's run; htk, htv: (P, S)
    int32 packed tables, P and S powers of two; mult: int32."""
    global LAUNCHES
    if not keys.is_cuda:
        raise ValueError(f"part_probe: no kernel for device {keys.device}")
    n, index = keys.shape[0], keys.get_device()
    n_parts, n_slots = htk.shape if htk.dim() == 2 else (0, 0)
    if not (build.streams_ok(n, index, torch.int32, keys, rowids, groups) and
            build.streams_ok(n_parts, index, torch.int32, offs, counts) and
            htk.shape == htv.shape and htk.is_contiguous() and
            htv.is_contiguous() and _pow2(n_parts) and _pow2(n_slots) and
            n_parts * n_slots <= 1 << 32 and
            build.streams_ok(n_parts * n_slots, index, torch.int32,
                             htk.view(-1), htv.view(-1))):
        _check(keys, rowids, groups, offs, counts, htk, htv)
    if n >= 1 << 31:
        raise ValueError(f"part_probe takes under 2^31 rows, got {n}")
    mult = int(mult)
    if not -(1 << 31) <= mult < 1 << 31:
        raise ValueError(f"mult {mult} is not an int32 value")
    if n == 0:
        out = torch.zeros((2, 0), dtype=torch.int32, device=keys.device)
        return out[0], out[1], torch.zeros((), dtype=torch.int64,
                                           device=keys.device)
    lib = library()
    out, count, status = build.sweep_buffers(
        n, lib.part_probe_status_words(n), keys.device)
    args = _PartArgs(keys.data_ptr(), rowids.data_ptr(), groups.data_ptr(),
                     n, offs.data_ptr(), counts.data_ptr(), n_parts,
                     htk.data_ptr(), htv.data_ptr(), n_slots - 1, mult,
                     out[0].data_ptr(), out[1].data_ptr(), count.data_ptr(),
                     status, build.resident(lib, "part_probe_shape", index, 0))
    build.launch(lib, lib.part_probe_launch, keys.device, "part_probe",
                 ctypes.addressof(args))
    LAUNCHES += 1
    return out[0], out[1], count
