"""Radix partitioning on the card: per-tile bucket histograms and stable
partition passes (paper §4.4; the partitioned join's shuffle and the LSB
radix sort behind ORDER BY).

Wrappers of the hand-written CUDA kernels ``csrc/radix_part.cu``, the port
of the Pallas TPU kernels ``repro/kernels/radix_part.py::histogram`` and
``partition_multi`` (``partition`` and ``radix_sort`` wrap the latter, as
in the reference).  Same contracts as ``ref.histogram``,
``ref.partition_multi``, ``ref.partition`` and ``ref.radix_sort``, bit for
bit: a key's bucket is bits [start_bit, start_bit + r) of the key as an
unsigned word, r <= 8, tiles of 2048 rows.

Between the two kernels runs the bucket-major exclusive scan of the
histogram (the paper's K2), in plain torch: the reference writes it in
plain jnp outside Pallas (``radix_part.py:124-125``).

The wrappers launch the kernels on CUDA tensors or raise; the choice of
the plain version for a CPU tensor is ``ops``' alone.  ``HIST_LAUNCHES``
counts the histogram kernel's launches of this process,
``SCATTER_LAUNCHES`` the scatter kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

HIST_LAUNCHES = 0
SCATTER_LAUNCHES = 0
MAX_BITS = 8
MAX_VALS = 3

_VAL_TYPES = (torch.int32, torch.float32, torch.uint32)
_SIGNATURES = {
    "radix_histogram_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
    "radix_scatter_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] +
        [ctypes.c_void_p] * 8),
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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def histogram(keys: torch.Tensor, start_bit: int, r: int) -> torch.Tensor:
    """Per-tile bucket counts -> (ceil(n / 2048), 2^r) int32 on the keys'
    device.  keys: (n,) int32."""
    global HIST_LAUNCHES
    n = _check(keys, start_bit, r, "histogram")
    lib = library()
    tiles = -(-n // lib.radix_tile_rows())
    hist = torch.empty((tiles, 1 << r), dtype=torch.int32,
                       device=keys.device)
    if n == 0:
        return hist
    with torch.cuda.device(keys.device):
        rc = lib.radix_histogram_launch(keys.data_ptr(), n, start_bit, r,
                                        hist.data_ptr(), _stream(keys.device))
    build.check(lib, rc, "radix histogram")
    HIST_LAUNCHES += 1
    return hist


def partition_multi(keys: torch.Tensor, vals: Sequence[torch.Tensor],
                    start_bit: int, r: int,
                    hist: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One stable radix-partition pass carrying up to 3 payload columns ->
    (keys', (vals0', ...)), every column permuted by the same stable
    bucket order.  keys: (n,) int32; vals: (n,) 4-byte tensors.  ``hist``:
    this pass's ``histogram`` of these keys when the caller already has it
    (the partitioned join reads its column sums), else it is computed
    here; the scatter places each tile's rows by it."""
    global SCATTER_LAUNCHES
    vals = tuple(vals)
    n = _check(keys, start_bit, r, "partition_multi")
    if len(vals) > MAX_VALS:
        raise ValueError(f"partition_multi carries at most {MAX_VALS} "
                         f"payload columns, got {len(vals)}")
    for j, v in enumerate(vals):
        build.check_stream(v, f"vals[{j}]", n, keys.device, _VAL_TYPES)
    out_keys = torch.empty_like(keys)
    outs = tuple(torch.empty_like(v) for v in vals)
    if n == 0:
        return out_keys, outs
    lib = library()
    tiles = -(-n // lib.radix_tile_rows())
    if hist is None:
        hist = histogram(keys, start_bit, r)
    elif hist.shape != (tiles, 1 << r) or hist.dtype != torch.int32 or \
            hist.device != keys.device or not hist.is_contiguous():
        raise ValueError(f"hist must be contiguous ({tiles}, {1 << r}) int32 "
                         f"on {keys.device}, got {hist.dtype} "
                         f"{tuple(hist.shape)} on {hist.device}")
    # the paper's K2: bucket-major exclusive scan of the (tile, bucket)
    # counts, read by the scatter as offsets[bucket * tiles + tile]
    flat = hist.t().reshape(-1)
    offsets = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    ptrs = [v.data_ptr() for v in vals] + [0] * (MAX_VALS - len(vals))
    optrs = [o.data_ptr() for o in outs] + [0] * (MAX_VALS - len(vals))
    with torch.cuda.device(keys.device):
        rc = lib.radix_scatter_launch(
            keys.data_ptr(), n, start_bit, r, hist.data_ptr(),
            offsets.data_ptr(), len(vals),
            *ptrs, *optrs, out_keys.data_ptr(), _stream(keys.device))
    build.check(lib, rc, "radix scatter")
    SCATTER_LAUNCHES += 1
    return out_keys, outs


def partition(keys: torch.Tensor, vals: torch.Tensor, start_bit: int,
              r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable radix-partition pass with one payload -> (keys', vals')."""
    out, (v,) = partition_multi(keys, (vals,), start_bit, r)
    return out, v


def radix_sort(keys: torch.Tensor, vals: torch.Tensor, key_bits: int = 32,
               r: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSB radix sort: ceil(key_bits / r) stable partition passes (a
    histogram and a scatter launch each), keys ordered as unsigned 32-bit
    words -> (keys', vals')."""
    for p in range(-(-key_bits // r)):
        keys, vals = partition(keys, vals, p * r, r)
    return keys, vals
