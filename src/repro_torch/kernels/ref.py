"""Plain PyTorch versions of the port's kernels — their ground truth.

Each function has its kernel's signature and semantics but is straight
tensor code with no tiling.  It runs on either device: the tests run it
on the CPU, ``chip_smoke.py`` runs it on the card beside the kernel.
Counts come back as 0-d int64 tensors on the inputs' device, and the
compacting functions return (n,) outputs whose entries past the count
are zero.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blocks as B

MEASURE_OPS = ("first", "mul", "sub")


def _host_ints(x) -> np.ndarray:
    """Small scalar parameters (predicate bounds, group multipliers) as a
    host int64 array: the kernel takes them by value, as the Pallas
    kernel keeps them in SMEM."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def bounds_list(pred_bounds, n_preds: int) -> List[Tuple[int, int]]:
    b = _host_ints(pred_bounds).reshape(-1, 2) if n_preds else \
        np.zeros((0, 2), np.int64)
    if b.shape[0] != n_preds:
        raise ValueError(f"pred_bounds has {b.shape[0]} rows for "
                         f"{n_preds} predicate columns")
    return [(int(lo), int(hi)) for lo, hi in b]


def mults_list(group_mults, n_joins: int) -> List[int]:
    m = _host_ints(group_mults).reshape(-1) if n_joins else \
        np.zeros((0,), np.int64)
    if m.shape[0] != n_joins:
        raise ValueError(f"group_mults has {m.shape[0]} entries for "
                         f"{n_joins} joins")
    return [int(v) for v in m]


def measure(m1: torch.Tensor, m2, measure_op: str) -> torch.Tensor:
    """The per-row measure in int64: m1, m1*m2 or m1-m2 of int32 columns
    (exact: |m1*m2| < 2^62)."""
    m = m1.to(torch.int64)
    if measure_op == "mul":
        m = m * m2.to(torch.int64)
    elif measure_op == "sub":
        m = m - m2.to(torch.int64)
    elif measure_op != "first":
        raise ValueError(f"measure_op {measure_op!r} not in {MEASURE_OPS}")
    return m


def spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
         join_keys: Sequence[torch.Tensor],
         join_tables: Sequence[torch.Tensor], group_mults,
         m1: torch.Tensor, m2=None, measure_op: str = "first",
         n_groups: int = 1) -> torch.Tensor:
    """Fused select-project-join-aggregate over int32 streams ->
    (n_groups,) f32.

    Range predicates, then one linear-probe lookup per join (a miss
    filters the row), group id = sum of payload * mult in int32, measure
    m1 / m1*m2 / m1-m2.  Sums are exact in int64 (``index_add_``) and
    cast to f32 once, so the result is the exact sum rounded to nearest
    — the numpy oracle's float64 sum cast to f32, and the CUDA kernel's
    result, bit for bit."""
    n = m1.shape[0]
    live = torch.ones((n,), dtype=torch.bool, device=m1.device)
    for col, (lo, hi) in zip(pred_cols,
                             bounds_list(pred_bounds, len(pred_cols))):
        live &= B.block_pred_range(col, lo, hi) > 0
    group = torch.zeros((n,), dtype=torch.int32, device=m1.device)
    for j, (keys, mult) in enumerate(
            zip(join_keys, mults_list(group_mults, len(join_keys)))):
        payload, found = B.block_lookup(keys, join_tables[2 * j],
                                        join_tables[2 * j + 1])
        live &= found > 0
        group += payload * mult
    sums = B.block_group_aggregate(group, measure(m1, m2, measure_op),
                                   live, n_groups)
    return sums.to(torch.float32)


def select_scan(x: torch.Tensor, y: torch.Tensor, lo, hi
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count): the selected
    entries of y in row order, then zeros.  Runs on the tensors' own
    device with no host round trip."""
    bitmap = B.block_pred_range(x, lo, hi)
    offsets, count = B.block_scan(bitmap)
    return B.block_shuffle(y, bitmap, offsets), count


def probe_join(keys: torch.Tensor, vals: torch.Tensor,
               ht_keys: torch.Tensor, ht_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The keys found in a linear-probe table -> (payload (n,), vals (n,),
    count): each found row's table payload and its own val, in row
    order, then zeros."""
    payload, found = B.block_lookup(keys, ht_keys, ht_vals)
    offsets, count = B.block_scan(found)
    return (B.block_shuffle(payload, found, offsets),
            B.block_shuffle(vals, found, offsets), count)


def project(x1: torch.Tensor, x2: torch.Tensor, a, b,
            sigmoid: bool = False) -> torch.Tensor:
    """a*x1 + b*x2 in f32, each product and the sum rounded once;
    optionally 1 / (1 + exp(-y))."""
    y = a * x1 + b * x2
    if sigmoid:
        y = 1.0 / (1.0 + torch.exp(-y))
    return y


def group_sum(group_ids: torch.Tensor, vals: torch.Tensor,
              n_groups: int) -> torch.Tensor:
    """SUM(vals) GROUP BY group_ids -> (n_groups,) in vals' dtype (f32 or
    int32).  int32 sums wrap as the reference's int32 accumulator does
    (summed in int64, cut to int32); f32 sums are taken in f64 and
    rounded to f32 once, so integer-valued f32 sums are exact.  An id
    outside [0, n_groups) is dropped."""
    acc = torch.float64 if vals.is_floating_point() else torch.int64
    live = torch.ones(group_ids.shape, dtype=torch.int32,
                      device=group_ids.device)
    return B.block_group_aggregate(group_ids, vals.to(acc), live,
                                   n_groups).to(vals.dtype)
