"""Partition sizing of the radix-partitioned join.

The port's own copy of the part of ``repro.sql.model`` the ``part`` and
``part_loop`` strategies call: ``W``, ``PART_BUDGET_BYTES``,
``MAX_PART_BITS``, ``ht_bytes`` and ``part_bits``.  The budget is the
reference's static rule, ``min(PART_BUDGET_BYTES, cache_size // 4)``, with
the H100's 50 MB L2 as the cache: 256 KB a partition table, the same
budget the reference's host model gives.  Not here yet: the measured
budget that the reference's calibration and tuner fold in, and the cost
model itself (``predict``, ``choose``); they come with ROADMAP.md queue
1, item 11.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sql.hashtable import next_pow2

W = 4                                   # bytes per (dictionary-coded) column
L2_BYTES = 50_000_000                   # H100 L2 (NVIDIA data sheet)
# each partition's hash table should fit the private fast level, well
# under the shared cache: partitions pay off only when probes stop missing
PART_BUDGET_BYTES = 1 << 18             # 256 KB per partition table
MAX_PART_BITS = 8                       # one 8-bit partition pass (§4.4)


def ht_bytes(n_build: int) -> float:
    """Bytes of the monolithic table: keys + vals int32, 50 % max fill."""
    return 2.0 * W * next_pow2(max(n_build, 1))


def part_bits(n_build: int) -> int:
    """Radix bits so each partition's table fits the per-partition budget
    (at most PART_BUDGET_BYTES and a quarter of the L2), at least 1: the
    ``part`` strategy always partitions; whether that pays is the cost
    model's question, not a silent fallback."""
    budget = min(PART_BUDGET_BYTES, L2_BYTES // 4)
    ratio = ht_bytes(n_build) / budget
    bits = int(np.ceil(np.log2(ratio))) if ratio > 1.0 else 0
    return int(np.clip(bits, 1, MAX_PART_BITS))
