"""Radix partitioning on the card: per-tile bucket histograms, every
pass's digit counts in one read, and one-sweep stable partition passes
(paper §4.4; the partitioned join's shuffle and the LSB radix sort behind
ORDER BY).

Wrappers of the hand-written CUDA kernels ``csrc/radix_part.cu``, the port
of the Pallas TPU kernels ``repro/kernels/radix_part.py::histogram`` and
``partition_multi`` (``partition`` and ``radix_sort`` wrap the latter, as
in the reference).  Same contracts as ``ref.histogram``,
``ref.digit_counts``, ``ref.partition_multi``, ``ref.partition`` and
``ref.radix_sort``, bit for bit: a key's bucket is bits [start_bit,
start_bit + r) of the key as an unsigned word, r <= 8; histogram tiles of
2048 rows.

A pass (``sweep``) is one launch: it places each tile's rows by the
pass's global bucket counts and a look-back over the tiles before it, so
no per-tile offsets array sits between two launches.  ``partition_multi``
takes those counts from the digit-count kernel, or from the column sums
of a ``histogram`` its caller already has.  ``radix_sort`` counts every
pass's digits in one read, brings the counts to the host once, and runs
only the passes that move rows (``pass_plan``).

The wrappers launch the kernels on CUDA tensors or raise; the choice of
the plain version for a CPU tensor is ``ops``' alone.  Launches of this
process: ``HIST_LAUNCHES`` of the histogram kernel, ``COUNT_LAUNCHES`` of
the digit-count kernel, ``SCATTER_LAUNCHES`` of the pass kernel.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

HIST_LAUNCHES = 0
COUNT_LAUNCHES = 0
SCATTER_LAUNCHES = 0
MAX_BITS = 8
MAX_VALS = 3
MAX_COUNTERS = 1024             # passes x 2^r digit counts of one read

_VAL_TYPES = (torch.int32, torch.float32, torch.uint32)
_SIGNATURES = {
    "radix_histogram_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "radix_shape": (ctypes.c_int, [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_longlong)]),
    "radix_counts_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
    "radix_sweep_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] +
        [ctypes.c_void_p] * 8),
    "radix_sweep_status_words": (ctypes.c_longlong, [ctypes.c_longlong,
                                                     ctypes.c_int]),
    "radix_tile_rows": (ctypes.c_longlong, []),
}


def library() -> ctypes.CDLL:
    return build.load("radix_part", _SIGNATURES)


def _check(keys: torch.Tensor, start_bit: int, r: int, what: str) -> int:
    if keys.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {keys.device}")
    n = keys.shape[0]
    build.check_stream(keys, "keys", n, keys.device)
    if not 1 <= r <= MAX_BITS or not 0 <= start_bit < 32:
        raise ValueError(f"{what}: r={r}, start_bit={start_bit}: r must lie "
                         f"in 1..{MAX_BITS} and start_bit in 0..31")
    if n >= 1 << 31:
        raise ValueError(f"{what} takes under 2^31 rows, got {n}")
    return n


def sort_passes(key_bits: int, r: int) -> int:
    """Passes of r bits of an LSB sort of ``key_bits``-bit keys."""
    return -(-key_bits // r)


def pass_plan(counts, n: int) -> List[int]:
    """The passes of an LSB sort that move rows, in order: pass p runs
    unless one bucket holds all n rows, since a stable pass with a single
    non-empty bucket is the identity.  ``counts``: the sort's (passes,
    2^r) digit counts on the host (a tensor or an array)."""
    return [p for p, row in enumerate(counts.tolist()) if max(row) < n]


def histogram(keys: torch.Tensor, start_bit: int, r: int) -> torch.Tensor:
    """Per-tile bucket counts -> (ceil(n / 2048), 2^r) int32 on the keys'
    device.  keys: (n,) int32.  One launch over a grid of resident blocks
    (asked once), each walking tiles."""
    global HIST_LAUNCHES
    n = _check(keys, start_bit, r, "histogram")
    lib = library()
    tiles = -(-n // lib.radix_tile_rows())
    hist = torch.empty((tiles, 1 << r), dtype=torch.int32,
                       device=keys.device)
    if n == 0:
        return hist
    grid = build.resident(lib, "radix_shape", keys.device.index, 1)
    build.launch(lib, lib.radix_histogram_launch, keys.device,
                 "radix histogram", keys.data_ptr(), n, start_bit, r, grid,
                 hist.data_ptr())
    HIST_LAUNCHES += 1
    return hist


def digit_counts(keys: torch.Tensor, start_bit: int, r: int,
                 passes: int = 1) -> torch.Tensor:
    """The digits of ``passes`` passes of r bits from ``start_bit``, counted
    in one read -> (passes, 2^r) int32 on the keys' device: row p counts
    the keys' buckets at bits [start_bit + p·r, + r).  passes · 2^r <=
    1024 and start_bit + (passes - 1)·r <= 31."""
    global COUNT_LAUNCHES
    n = _check(keys, start_bit, r, "digit_counts")
    if passes < 1 or passes << r > MAX_COUNTERS or \
            start_bit + (passes - 1) * r > 31:
        raise ValueError(f"digit_counts: {passes} passes of {r} bits from "
                         f"bit {start_bit}: at most {MAX_COUNTERS} counters "
                         "and a last pass starting at bit 31 or below")
    if n == 0:
        return torch.zeros((passes, 1 << r), dtype=torch.int32,
                           device=keys.device)
    counts = torch.empty((passes, 1 << r), dtype=torch.int32,
                         device=keys.device)
    lib = library()
    grid = build.resident(lib, "radix_shape", keys.device.index, 0)
    build.launch(lib, lib.radix_counts_launch, keys.device,
                 "radix digit counts", keys.data_ptr(), n, start_bit, r,
                 passes, grid, counts.data_ptr())
    COUNT_LAUNCHES += 1
    return counts


def sweep(keys: torch.Tensor, vals: Sequence[torch.Tensor], start_bit: int,
          r: int, totals: torch.Tensor
          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One stable radix-partition pass in one launch -> (keys', (vals0',
    ...)).  ``totals``: (2^r,) int32 on the keys' device, this pass's
    bucket counts of these keys (a row of ``digit_counts``, or the column
    sums of their ``histogram``); the pass trusts them, and other counts
    give another permutation (rows placed past n are dropped)."""
    global SCATTER_LAUNCHES
    vals = tuple(vals)
    n = _check(keys, start_bit, r, "partition pass")
    if len(vals) > MAX_VALS:
        raise ValueError(f"a partition pass carries at most {MAX_VALS} "
                         f"payload columns, got {len(vals)}")
    for j, v in enumerate(vals):
        build.check_stream(v, f"vals[{j}]", n, keys.device, _VAL_TYPES)
    build.check_stream(totals, "totals", 1 << r, keys.device)
    out_keys = torch.empty_like(keys)
    outs = tuple(torch.empty_like(v) for v in vals)
    if n == 0:
        return out_keys, outs
    lib = library()
    status = torch.empty((lib.radix_sweep_status_words(n, r),),
                         dtype=torch.int32, device=keys.device)
    ptrs = [v.data_ptr() for v in vals] + [0] * (MAX_VALS - len(vals))
    optrs = [o.data_ptr() for o in outs] + [0] * (MAX_VALS - len(vals))
    build.launch(lib, lib.radix_sweep_launch, keys.device, "radix pass",
                 keys.data_ptr(), n, start_bit, r, totals.data_ptr(),
                 status.data_ptr(), len(vals), *ptrs, *optrs,
                 out_keys.data_ptr())
    SCATTER_LAUNCHES += 1
    return out_keys, outs


def partition_multi(keys: torch.Tensor, vals: Sequence[torch.Tensor],
                    start_bit: int, r: int,
                    hist: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One stable radix-partition pass carrying up to 3 payload columns ->
    (keys', (vals0', ...)), every column permuted by the same stable
    bucket order.  keys: (n,) int32; vals: (n,) 4-byte tensors.  ``hist``:
    this pass's ``histogram`` of these keys when the caller already has it
    (the partitioned join reads its column sums): its column sums are the
    pass's bucket counts and no count kernel runs; else the digit-count
    kernel counts them."""
    n = _check(keys, start_bit, r, "partition_multi")
    if hist is None:
        totals = digit_counts(keys, start_bit, r)[0]
    else:
        tiles = -(-n // library().radix_tile_rows())
        if hist.shape != (tiles, 1 << r) or hist.dtype != torch.int32 or \
                hist.device != keys.device or not hist.is_contiguous():
            raise ValueError(f"hist must be contiguous ({tiles}, {1 << r}) "
                             f"int32 on {keys.device}, got {hist.dtype} "
                             f"{tuple(hist.shape)} on {hist.device}")
        totals = hist.sum(0, dtype=torch.int32)
    return sweep(keys, vals, start_bit, r, totals)


def partition(keys: torch.Tensor, vals: torch.Tensor, start_bit: int,
              r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable radix-partition pass with one payload -> (keys', vals')."""
    out, (v,) = partition_multi(keys, (vals,), start_bit, r)
    return out, v


def radix_sort(keys: torch.Tensor, vals: torch.Tensor, key_bits: int = 32,
               r: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSB radix sort by ceil(key_bits / r) stable passes of r bits, keys
    ordered as unsigned 32-bit words -> (keys', vals').  One launch counts
    every pass's digits; the counts come to the host once (one sync), and
    only the passes of ``pass_plan`` launch, one launch each.  When none
    moves a row the outputs are copies of the inputs."""
    n = _check(keys, 0, r, "radix_sort")
    build.check_stream(vals, "vals", n, keys.device, _VAL_TYPES)
    counts = digit_counts(keys, 0, r, sort_passes(key_bits, r))
    plan = pass_plan(counts.cpu(), n)
    if not plan:
        return keys.clone(), vals.clone()
    for p in plan:
        keys, (vals,) = sweep(keys, (vals,), p * r, r, counts[p])
    return keys, vals
