"""Plain PyTorch versions of the port's kernels — their ground truth.

Each function has its kernel's signature and semantics but is straight
tensor code with no tiling.  It runs on either device: the tests run it
on the CPU, ``chip_smoke.py`` runs it on the card beside the kernel.
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
