"""Synthetic inputs for holding each kernel against its plain version.

The generators, made from a numpy seed, serve ``chip_smoke.py`` (kernel
vs plain on the card), the card tests and the CPU tests (plain version
vs the reference package).  They cover what the SSB data never shows:
duplicate build keys (the first row wins), probe chains that wrap the
end of the table, negative keys, an all-EMPTY build side, probe keys
that miss, group ids past ``n_groups`` (dropped), selectivity 0 and 1,
f32 predicate columns, int32 sums that overflow and f32 sums that are
not integers.  Every case is a tuple of host arrays and scalars;
``tensors`` moves its arrays to a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.sql.hashtable import next_pow2, np_build, np_hash


@dataclass
class SpjaCase:
    """Host arrays for one ``spja`` call (see ``ssb_fused.spja``)."""
    pred_cols: List[np.ndarray]
    pred_bounds: np.ndarray                 # (P, 2) int32
    join_keys: List[np.ndarray]
    join_tables: List[np.ndarray]           # htk0, htv0, htk1, htv1, ...
    group_mults: np.ndarray                 # (J,) int32
    m1: np.ndarray
    m2: Optional[np.ndarray]
    measure_op: str = "first"
    n_groups: int = 1

    def args(self, device) -> tuple:
        """(positional args, keyword args) with the streams and tables as
        int32 tensors on ``device``."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return ((
            [t(c) for c in self.pred_cols], self.pred_bounds,
            [t(k) for k in self.join_keys],
            [t(h) for h in self.join_tables], self.group_mults,
            t(self.m1), None if self.m2 is None else t(self.m2)),
            dict(measure_op=self.measure_op, n_groups=self.n_groups))

    @property
    def n(self) -> int:
        return int(self.m1.shape[0])


def _dim_table(rng: np.random.Generator, n_keys: int, card: int,
               duplicates: bool, wrap: bool):
    """(dim keys, payloads, htk, htv) for one join: unique keys drawn
    around zero (so some are negative), payloads in [0, card)."""
    if n_keys == 0:
        keys = np.zeros(0, np.int32)
        vals = np.zeros(0, np.int32)
    else:
        span = max(4 * n_keys, 64)
        keys = rng.choice(np.arange(-span, span), n_keys,
                          replace=False).astype(np.int32)
        if wrap:
            # keys whose home slot is among the table's last three slots:
            # their chains run off the end and continue at slot 0
            n_slots = next_pow2(n_keys)
            cand = np.arange(-50 * span, 50 * span, dtype=np.int32)
            tail = cand[np_hash(cand, n_slots) >= n_slots - 3]
            take = min(len(tail), max(n_keys // 4, 1))
            keys[:take] = rng.choice(tail, take, replace=False)
            keys = np.unique(keys)
        vals = rng.integers(0, card, len(keys), dtype=np.int32)
        if duplicates:
            # repeat a quarter of the keys with other payloads, placed
            # after their first occurrence: the first row must win
            d = max(len(keys) // 4, 1)
            keys = np.concatenate([keys, keys[:d]])
            vals = np.concatenate(
                [vals, rng.integers(0, card, d, dtype=np.int32)])
    htk, htv = np_build(keys, vals, next_pow2(max(len(keys), 1)))
    return keys, vals, htk, htv


def spja_case(seed: int, n: int, n_preds: int, n_joins: int,
              measure_op: str, n_groups: int, *, build_rows: int = 500,
              empty_join: bool = False, duplicates: bool = False,
              wrap: bool = False, small: bool = False) -> SpjaCase:
    """A random SPJA problem.  ``empty_join`` makes join 0's build side
    empty (an all-EMPTY 16-slot table: every probe misses);
    ``small`` keeps measures small enough that every f32 partial sum of
    up to a few thousand rows stays exact (for comparing with an f32
    implementation)."""
    rng = np.random.default_rng(seed)
    pred_cols, bounds = [], []
    for _ in range(n_preds):
        pred_cols.append(rng.integers(0, 100, n, dtype=np.int32))
        lo = int(rng.integers(0, 50))
        bounds.append((lo, lo + int(rng.integers(20, 60))))
    # payload cardinalities whose mixed-radix product slightly exceeds
    # n_groups, so a few live rows carry an out-of-range group id
    cards, mults, radix = [], [], 1
    per = max(int(round(n_groups ** (1.0 / max(n_joins, 1)))), 1)
    for j in range(n_joins):
        card = per + 1 if j == n_joins - 1 else per
        cards.append(card)
        mults.append(radix)
        radix *= per
    join_keys, tables = [], []
    for j in range(n_joins):
        rows = 0 if (empty_join and j == 0) else build_rows
        dkeys, _, htk, htv = _dim_table(rng, rows, cards[j], duplicates,
                                        wrap)
        if len(dkeys):
            hits = rng.choice(dkeys, n)
            misses = rng.integers(-8 * build_rows, 8 * build_rows, n,
                                  dtype=np.int32)
            fk = np.where(rng.random(n) < 0.8, hits, misses)
        else:
            fk = rng.integers(-100, 100, n, dtype=np.int32)
        join_keys.append(fk.astype(np.int32))
        tables.extend([htk, htv])
    hi1, hi2 = (30, 5) if small else (1000, 500)
    m1 = rng.integers(1, hi1, n, dtype=np.int32)
    m2 = (rng.integers(0, hi2, n, dtype=np.int32)
          if measure_op in ("mul", "sub") else None)
    return SpjaCase(pred_cols, np.array(bounds, np.int32).reshape(-1, 2),
                    join_keys, tables, np.array(mults, np.int32), m1, m2,
                    measure_op, n_groups)


def tensors(case: tuple, device) -> tuple:
    """The case with each numpy array as a tensor on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in case)


def select_case(seed: int, n: int, selectivity: str = "mid",
                dtype: str = "int32") -> tuple:
    """(x, y, lo, hi) for ``select_scan``: x int32 or f32 in [0, 100),
    y int32 row tags; ``selectivity`` "mid" keeps about half the rows,
    "none" none, "all" all."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = (rng.random(n) * 100).astype(np.float32)
    else:
        x = rng.integers(0, 100, n, dtype=np.int32)
    y = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    lo, hi = {"mid": (20, 69), "none": (1000, 2000),
              "all": (0, 100)}[selectivity]
    if dtype == "float32":
        lo, hi = lo + 0.5, hi + 0.25
    return x, y, lo, hi


PROBE_KINDS = ("duplicate_wrap", "empty", "misses")


def probe_case(seed: int, n: int, kind: str = "duplicate_wrap",
               build_rows: int = 500) -> tuple:
    """(keys, vals, htk, htv) for ``probe_join``: "duplicate_wrap" probes
    a table with duplicate keys and chains that wrap its end, 80 % of
    the keys found; "empty" an all-EMPTY table; "misses" a table none of
    the keys is in."""
    rng = np.random.default_rng(seed)
    rows = 0 if kind == "empty" else build_rows
    dkeys, _, htk, htv = _dim_table(rng, rows, 1 << 20,
                                    duplicates=kind == "duplicate_wrap",
                                    wrap=kind == "duplicate_wrap")
    others = rng.integers(1 << 24, 1 << 30, n, dtype=np.int32)
    if kind == "duplicate_wrap":
        keys = np.where(rng.random(n) < 0.8, rng.choice(dkeys, n), others)
    else:
        keys = others
    vals = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    return keys.astype(np.int32), vals, htk, htv


def project_case(seed: int, n: int) -> tuple:
    """(x1, x2) standard-normal f32 for ``project`` (the sigmoid's output
    stays clear of f32 denormals, which XLA flushes to zero)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


GROUP_KINDS = ("int32_overflow", "f32_integers", "f32_random")


def group_case(seed: int, n: int, n_groups: int,
               kind: str = "f32_integers", out_of_range: bool = False
               ) -> tuple:
    """(group_ids, vals, n_groups) for ``group_sum``: "int32_overflow"
    int32 values whose sums wrap; "f32_integers" integer-valued f32 in
    [0, 1000) (exact in f64, and in f32 while a sum stays under 2^24);
    "f32_random" non-integer f32.  ``out_of_range`` adds ids past the
    grid and negative ones (dropped)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_groups, n, dtype=np.int32)
    if out_of_range:
        bad = rng.random(n) < 0.05
        ids[bad] = rng.choice(np.array([-1, -7, n_groups, n_groups + 9],
                                       np.int32), int(bad.sum()))
    if kind == "int32_overflow":
        vals = rng.integers(1 << 29, (1 << 31) - 1, n, dtype=np.int32)
    elif kind == "f32_integers":
        vals = rng.integers(0, 1000, n).astype(np.float32)
    else:
        vals = rng.standard_normal(n).astype(np.float32) * 1000
    return ids, vals, n_groups
