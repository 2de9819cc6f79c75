"""Hash joins on the card (paper §4.3), three kernels of
``csrc/hash_join.cu``:

``build`` — the open-addressing linear-probe table of (key, val) rows;
the port of the Pallas TPU kernel ``repro/kernels/hash_join.py::build``.
Same contract as ``ref.build``: the table that inserting the rows one by
one in row order gives, bit for bit (the reference's ``ref.build`` and
its kernel's; not ``sql.hashtable.np_build``'s, which places rows in
rounds and lays them out otherwise).  It raises for more rows than slots
(checked on the host) and for a key equal to EMPTY, which no such table
can hold (the kernel raises a flag, read as 4 bytes after the launch).
A call is two allocations (the 4-byte row slots, the rows' (key, val)
words and the flag; the table) and one cooperative launch through
``build.launch``.

``probe_join`` — the rows whose key is found in a linear-probe table, as
stable compacted (payload, val) pairs (the opat chain's join); the port
of the Pallas TPU kernel ``repro/kernels/hash_join.py::probe_join``.  Same
contract as ``ref.probe_join``: (payload (n,), vals (n,), count), the
found rows in row order and zeros past the count, bit for bit.  A call is
one allocation (both outputs, the count and the kernel's status words),
one memset and one kernel, which also writes the zeros past the count;
the tensors are checked by one cheap test (``build.streams_ok``) and the
launch goes through ``build.launch``: the opat pass and part_loop make
many calls of a few thousand rows, where the fixed cost is the time.

``probe_agg`` — SUM(payload + v) over the found rows (the paper's join
microbenchmark); the port of ``repro/kernels/hash_join.py::probe_agg``.
Same contract as ``ref.probe_agg``: int32 sums wrap, bit for bit; f32
values are summed in f64 in a fixed order and rounded once (the same
bits on every run, ``ref.probe_agg``'s when the f64 sum is exact, as on
integer-valued data, and within one f32 ulp of them otherwise).  A call
is two allocations (the table's copy as 8-byte slots of key beside
payload, so that a probe reads one sector where the build's two arrays
cost two; the blocks' partials and the result) and three kernels (the
copy, the sweep and the partials' sum), launched through
``build.launch``.

The wrappers launch the kernels on CUDA tensors or raise; the choice of
the plain version for a CPU tensor is ``ops``'s alone.  ``LAUNCHES``
counts ``probe_join``'s launches of this process, ``AGG_LAUNCHES``
``probe_agg``'s and ``BUILD_LAUNCHES`` ``build``'s.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

LAUNCHES = 0
AGG_LAUNCHES = 0
BUILD_LAUNCHES = 0
BUILD_SLOTS_PER_BLOCK = 2048    # build's grid: 4 slot pairs a thread


class _JoinArgs(ctypes.Structure):
    """``probe_join_launch``'s arguments (``csrc/hash_join.cu``'s
    ``JoinArgs``), passed by one pointer."""
    _fields_ = [("keys", ctypes.c_void_p), ("vals", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("htk", ctypes.c_void_p),
                ("htv", ctypes.c_void_p), ("mask", ctypes.c_uint),
                ("out_payload", ctypes.c_void_p),
                ("out_vals", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("status", ctypes.c_void_p), ("blocks", ctypes.c_longlong)]


class _AggArgs(ctypes.Structure):
    """``probe_agg_launch``'s arguments (``csrc/hash_join.cu``'s
    ``AggArgs``), passed by one pointer."""
    _fields_ = [("keys", ctypes.c_void_p), ("vals", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("is_float", ctypes.c_int),
                ("htk", ctypes.c_void_p), ("htv", ctypes.c_void_p),
                ("mask", ctypes.c_uint), ("pairs", ctypes.c_void_p),
                ("partials", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("blocks", ctypes.c_longlong)]


_SIGNATURES = {
    "probe_join_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "probe_join_status_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "probe_join_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "probe_agg_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "probe_agg_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
    "probe_agg_tile_rows": (ctypes.c_longlong, []),
    "build_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]),
    "build_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
}
_VAL_TYPES = (torch.int32, torch.float32)


def library() -> ctypes.CDLL:
    return kbuild.load("hash_join", _SIGNATURES)


def _check_table(ht_keys: torch.Tensor, ht_vals: torch.Tensor,
                 device: torch.device) -> int:
    """The table's slot count, checked: a power of two up to 2^32."""
    s = ht_keys.shape[0]
    kbuild.check_stream(ht_keys, "ht_keys", s, device)
    kbuild.check_stream(ht_vals, "ht_vals", s, device)
    if s < 1 or s & (s - 1) or s > 1 << 32:
        raise ValueError(f"slot count {s} is not a power of 2 up to 2^32")
    return s


def probe_agg(keys: torch.Tensor, vals: torch.Tensor,
              ht_keys: torch.Tensor, ht_vals: torch.Tensor) -> torch.Tensor:
    """-> 0-d tensor of vals' dtype on the keys' device.  keys: (n,)
    int32; vals: (n,) int32 or f32; ht_keys, ht_vals: (S,) int32
    open-addressing table, S a power of two."""
    global AGG_LAUNCHES
    if not keys.is_cuda:
        raise ValueError(f"probe_agg: no kernel for device {keys.device}")
    n, index, s = keys.shape[0], keys.get_device(), ht_keys.shape[0]
    if not (vals.dtype in _VAL_TYPES and
            kbuild.streams_ok(n, index, torch.int32, keys) and
            kbuild.streams_ok(n, index, vals.dtype, vals) and
            kbuild.streams_ok(s, index, torch.int32, ht_keys, ht_vals) and
            0 < s <= 1 << 32 and not s & (s - 1)):
        kbuild.check_stream(keys, "keys", n, keys.device)
        kbuild.check_stream(vals, "vals", n, keys.device, _VAL_TYPES)
        _check_table(ht_keys, ht_vals, keys.device)
    if n == 0:
        return torch.zeros((), dtype=vals.dtype, device=keys.device)
    lib = library()
    is_float = vals.dtype is torch.float32
    blocks = min(kbuild.resident(lib, "probe_agg_shape", index,
                                 int(is_float)),
                 -(-n // lib.probe_agg_tile_rows()))
    # the partials, then the result's 8-byte word
    buf = torch.empty((blocks + 1,), dtype=torch.int64, device=keys.device)
    out = buf[blocks:].view(vals.dtype)[0]
    pairs = torch.empty((s, 2), dtype=torch.int32, device=keys.device)
    args = _AggArgs(keys.data_ptr(), vals.data_ptr(), n, int(is_float),
                    ht_keys.data_ptr(), ht_vals.data_ptr(), s - 1,
                    pairs.data_ptr(), buf.data_ptr(), out.data_ptr(), blocks)
    kbuild.launch(lib, lib.probe_agg_launch, keys.device, "probe_agg",
                  ctypes.addressof(args))
    AGG_LAUNCHES += 1
    return out


def probe_join(keys: torch.Tensor, vals: torch.Tensor,
               ht_keys: torch.Tensor, ht_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (payload (n,) int32, vals (n,) int32, count 0-d int64) on the
    keys' device.  keys, vals: (n,) int32; ht_keys, ht_vals: (S,) int32
    open-addressing table, S a power of two."""
    global LAUNCHES
    if not keys.is_cuda:
        raise ValueError(f"probe_join: no kernel for device {keys.device}")
    n, index, s = keys.shape[0], keys.get_device(), ht_keys.shape[0]
    if not (kbuild.streams_ok(n, index, torch.int32, keys, vals) and
            kbuild.streams_ok(s, index, torch.int32, ht_keys, ht_vals) and
            0 < s <= 1 << 32 and not s & (s - 1)):
        kbuild.check_stream(keys, "keys", n, keys.device)
        kbuild.check_stream(vals, "vals", n, keys.device)
        _check_table(ht_keys, ht_vals, keys.device)
    if n >= 1 << 31:
        raise ValueError(f"probe_join takes under 2^31 rows, got {n}")
    if n == 0:
        out = torch.zeros((2, 0), dtype=torch.int32, device=keys.device)
        return out[0], out[1], torch.zeros((), dtype=torch.int64,
                                           device=keys.device)
    lib = library()
    out, count, status = kbuild.sweep_buffers(
        n, lib.probe_join_status_words(n), keys.device)
    args = _JoinArgs(keys.data_ptr(), vals.data_ptr(), n, ht_keys.data_ptr(),
                     ht_vals.data_ptr(), s - 1, out[0].data_ptr(),
                     out[1].data_ptr(), count.data_ptr(), status,
                     kbuild.resident(lib, "probe_join_shape", index, 0))
    kbuild.launch(lib, lib.probe_join_launch, keys.device, "probe_join",
                  ctypes.addressof(args))
    LAUNCHES += 1
    return out[0], out[1], count


def build(keys: torch.Tensor, vals: torch.Tensor, n_slots: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (htk, htv), each (n_slots,) int32 on the keys' device.  keys,
    vals: (n,) int32, n <= n_slots, no key EMPTY; n_slots a power of two
    up to 2^31.  One launch and one 4-byte read of its EMPTY flag."""
    global BUILD_LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"build: no kernel for device {keys.device}")
    device, n = keys.device, keys.shape[0]
    kbuild.check_stream(keys, "keys", n, device)
    kbuild.check_stream(vals, "vals", n, device)
    ref.check_build_shape(keys, vals, n_slots)
    lib = library()
    blocks = min(kbuild.resident(lib, "build_shape", keys.get_device(), 0),
                 -(-n_slots // BUILD_SLOTS_PER_BLOCK))
    # the 4-byte row slots (in 8-byte words), the rows' (key, val) words,
    # then the flag
    half = (n_slots + 1) // 2
    scratch = torch.empty((half + n + 1,), dtype=torch.int64, device=device)
    out = torch.empty((2, n_slots), dtype=torch.int32, device=device)
    kbuild.launch(lib, lib.build_launch, device, "build", keys.data_ptr(),
                  vals.data_ptr(), n, n_slots - 1, blocks, scratch.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr())
    BUILD_LAUNCHES += 1
    if n and scratch.view(torch.int32)[2 * (half + n)].item():
        raise ref.empty_key_error()
    return out[0], out[1]
