"""Synthetic inputs for holding each kernel against its plain version.

The generators, made from a numpy seed, serve ``chip_smoke.py`` (kernel
vs plain on the card), the card tests and the CPU tests (plain version
vs the reference package).  They cover what the SSB data never shows:
duplicate build keys (the first row wins), probe chains that wrap the
end of the table, negative keys, an all-EMPTY build side, probe keys
that miss, group ids past ``n_groups`` (dropped), selectivity 0 and 1,
f32 predicate columns, int32 sums that overflow and f32 sums that are
not integers; and, for the packed kernels, every packed width 1-16, row
counts that are not a multiple of a word's values, frame-of-reference
keys and measures (SSB data at SF 20 packs with reference 0 only), and
words whose sign bit is set; for the radix passes, 1-8 bit buckets at
any start bit (the last pass of r = 7 reaching past bit 31), every key
in one bucket, heavy duplicates and negative keys, with 1 and 3 payload
columns; for the partitioned probe, 2-256 partitions, one hot
partition, empty partitions, duplicate build keys, dead rows and an
all-EMPTY table; for the build, duplicate keys, negative keys, a full
table and no rows; for the sparse scan, selectivities down to none with
the matches spread or clustered.  Every case is a tuple of host arrays
(or tuples of them) and scalars; ``tensors`` moves its arrays to a
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.common import PHYS_WIDTHS
from repro_torch.sql import storage
from repro_torch.sql.hashtable import (EMPTY, MERGE_STREAMS, build_merged,
                                       next_pow2, np_build, np_hash,
                                       pack_partitions)

PACKED_WIDTHS = PHYS_WIDTHS[:-1]        # the widths that pack (below 32)


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
    # packed streams (see ``packed_spja_case``): spja's keyword arguments
    # pred_widths, key_widths, key_refs, m_widths, m_refs, n_rows
    packed: Optional[dict] = None

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
            dict(measure_op=self.measure_op, n_groups=self.n_groups,
                 **(self.packed or {})))

    @property
    def n(self) -> int:
        if self.packed:
            return int(self.packed["n_rows"])
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


def packed_spja_case(seed: int, n: int, n_preds: int, n_joins: int,
                     measure_op: str, n_groups: int, pred_phys: int = 8,
                     m_offset: int = 100_000, **kw) -> SpjaCase:
    """``spja_case`` with every stream bit-packed: predicate columns drawn
    in [0, 2^pred_phys) and packed at ``pred_phys`` bits (bounds in that
    domain, one of them reaching its top value, so top lanes with the
    sign bit set are selected), join keys frame-of-reference packed
    (their domain holds negative keys; one past 16 bits stays a plain
    stream among packed ones), measures shifted by ``m_offset`` and
    frame-of-reference packed."""
    c = spja_case(seed, n, n_preds, n_joins, measure_op, n_groups, **kw)
    rng = np.random.default_rng(seed + 1)
    top = (1 << pred_phys) - 1
    pred_cols, bounds = [], []
    for p in range(n_preds):
        pred_cols.append(rng.integers(0, top + 1, n, dtype=np.int32))
        lo = int(rng.integers(0, top + 1))
        bounds.append((lo, top if p == 0 else
                       min(top, lo + int(rng.integers(0, top + 1)))))

    def pack(vals):         # a domain past 16 bits stays plain
        col = storage.pack_column(vals)
        return col.words, col.encoding

    keys = [pack(k) for k in c.join_keys]
    ms = [pack((m + m_offset).astype(np.int32))
          for m in ((c.m1,) if c.m2 is None else (c.m1, c.m2))]
    c.pred_cols = [storage.pack_words(v, pred_phys) for v in pred_cols]
    c.pred_bounds = np.array(bounds, np.int32).reshape(-1, 2)
    c.join_keys = [w for w, _ in keys]
    c.m1 = ms[0][0]
    c.m2 = ms[1][0] if len(ms) == 2 else None
    c.packed = dict(
        pred_widths=(pred_phys,) * n_preds,
        key_widths=tuple(e.phys for _, e in keys),
        key_refs=np.array([e.ref for _, e in keys], np.int32),
        m_widths=tuple(e.phys for _, e in ms),
        m_refs=np.array([e.ref for _, e in ms], np.int32), n_rows=n)
    return c


def packed_values(rng: np.random.Generator, n: int, phys: int,
                  ref: int = 0) -> np.ndarray:
    """n values in [ref, ref + 2^phys) whose first word's top lane holds
    the top value, so that word's sign bit is set."""
    vals = rng.integers(0, 1 << phys, n, dtype=np.int64)
    c = 32 // phys
    if n >= c:
        vals[c - 1] = (1 << phys) - 1
    return (vals + ref).astype(np.int32)


def unpack_case(seed: int, n: int, phys: int, ref: int = 0) -> tuple:
    """(words, n, phys, ref) for ``unpack``: n values packed at ``phys``
    bits with frame of reference ``ref``."""
    vals = packed_values(np.random.default_rng(seed), n, phys, ref)
    return storage.pack_words(vals, phys, ref), n, phys, ref


def select_packed_case(seed: int, n: int, phys: int,
                       selectivity: str = "mid") -> tuple:
    """(words, y, lo, hi, phys) for ``select_scan_packed``: x packed at
    ``phys`` bits, bounds in its domain; "mid" keeps about half the rows
    and includes the top value, "none" none, "all" all."""
    rng = np.random.default_rng(seed)
    x = packed_values(rng, n, phys)
    y = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    top = (1 << phys) - 1
    lo, hi = {"mid": ((top + 1) // 2, top), "none": (top + 1, top + 9),
              "all": (0, top)}[selectivity]
    return storage.pack_words(x, phys), y, lo, hi, phys


def tensors(case: tuple, device) -> tuple:
    """The case with each numpy array (also inside a tuple) as a tensor on
    ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else
                 tensors(a, device) if isinstance(a, tuple) else a
                 for a in case)


# the select sweep's tile (csrc/select_scan.cu's kSelectTile): the
# "first_tile" and "last_tile" selectivities place their matches by it
SELECT_TILE = 4096
SELECT_KINDS = ("mid", "none", "all", "first_tile", "last_tile", "nan")


def select_case(seed: int, n: int, selectivity: str = "mid",
                dtype: str = "int32") -> tuple:
    """(x, y, lo, hi) for ``select_scan``: x int32 or f32 in [0, 100),
    y int32 row tags; ``selectivity`` "mid" keeps about half the rows,
    "none" none, "all" all, "first_tile" / "last_tile" about half of the
    rows of the first / last ``SELECT_TILE``-row tile and none elsewhere,
    "nan" (f32 only) every row but the tenth of them that are NaN, with
    bounds -inf and inf."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = (rng.random(n) * 100).astype(np.float32)
    else:
        x = rng.integers(0, 100, n, dtype=np.int32)
    y = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    if selectivity == "nan":
        if dtype != "float32":
            raise ValueError("NaN needs a float32 x")
        x[rng.random(n) < 0.1] = np.nan
        return x, y, float("-inf"), float("inf")
    if selectivity == "first_tile":
        x[SELECT_TILE:] = 500
    elif selectivity == "last_tile":
        x[:(n - 1) // SELECT_TILE * SELECT_TILE] = 500
    lo, hi = {"none": (1000, 2000),
              "all": (0, 100)}.get(selectivity, (20, 69))
    if dtype == "float32":
        lo, hi = lo + 0.5, hi + 0.25
    return x, y, lo, hi


# the one-sweep probe kernels' tile (csrc/lookback.cuh's kProbeTile): the
# "first_tile" and "last_tile" kinds place their matches by it
PROBE_TILE = 2048
PROBE_KINDS = ("duplicate_wrap", "empty", "misses", "clustered", "slots1",
               "slots2", "slots4", "full", "first_tile", "last_tile")
PROBE_MISS_KINDS = ("empty", "misses")          # no probe key is found
# (slots, keys) of the small and the full tables; full tables hold key 0
_SMALL_TABLES = {"slots1": (1, 1), "slots2": (2, 1), "slots4": (4, 4),
                 "full": (64, 64)}


def _homed(rng: np.random.Generator, count: int, n_slots: int, lo: int,
           hi: int, taken: Optional[np.ndarray] = None) -> np.ndarray:
    """Up to ``count`` distinct int32 keys in [-2^24, 2^24), none in
    ``taken``, whose home slot in an ``n_slots`` table is in [lo, hi)."""
    cand = np.unique(rng.integers(-(1 << 24), 1 << 24,
                                  4 * count * n_slots // (hi - lo) + 64)
                     .astype(np.int32))
    home = np_hash(cand, n_slots)
    cand = cand[(home >= lo) & (home < hi)]
    if taken is not None:
        cand = cand[~np.isin(cand, taken)]
    return rng.permutation(cand)[:count]


def tile_span(n: int, kind: str) -> tuple:
    """The rows [lo, hi) of the first or the last PROBE_TILE tile."""
    lo = 0 if kind == "first_tile" else max(n - 1, 0) // PROBE_TILE * \
        PROBE_TILE
    return lo, min(n, lo + PROBE_TILE)


def probe_case(seed: int, n: int, kind: str = "duplicate_wrap",
               build_rows: int = 500) -> tuple:
    """(keys, vals, htk, htv) for ``probe_join``: "duplicate_wrap" probes
    a table with duplicate keys and chains that wrap its end, 80 % of
    the keys found; "empty" an all-EMPTY table; "misses" a table none of
    the keys is in; "clustered" a 256-slot table where 40 of 100 keys
    have their home in the last 6 slots, so their chains cross several
    8-slot runs and go on past the table's end, 60 % of the keys found
    and 20 % missing after walking that cluster; "slots1", "slots2",
    "slots4" tables of 1, 2 and 4 slots holding 1, 1 and 4 keys, 70 %
    found; "full" 64 keys in 64 slots, 70 % found: with no EMPTY slot a
    miss ends after one lap (as in "slots1" and "slots4"; each full
    table holds key 0); "first_tile" and "last_tile" the duplicate_wrap
    table, every row of the first or the last PROBE_TILE rows found and
    no other."""
    rng = np.random.default_rng(seed)
    if kind in _SMALL_TABLES or kind == "clustered":
        others = rng.integers(1 << 24, 1 << 30, n, dtype=np.int32)
        if kind == "clustered":
            n_slots = 256
            near_end = _homed(rng, 40, n_slots, n_slots - 6, n_slots)
            bkeys = np.concatenate(
                [near_end, _homed(rng, 60, n_slots, 0, n_slots, near_end)])
            strays = _homed(rng, 64, n_slots, n_slots - 6, n_slots, bkeys)
            u = rng.random(n)
            keys = np.where(u < 0.6, rng.choice(bkeys, n),
                            np.where(u < 0.8, rng.choice(strays, n), others))
        else:
            n_slots, n_keys = _SMALL_TABLES[kind]
            bkeys = np.concatenate([[0], rng.choice(
                np.arange(1, 1 << 12), n_keys - 1, replace=False)])
            keys = np.where(rng.random(n) < 0.7, rng.choice(bkeys, n),
                            others)
        bkeys = bkeys.astype(np.int32)
        htk, htv = np_build(bkeys, rng.integers(0, 1 << 20, len(bkeys),
                                                dtype=np.int32), n_slots)
    else:
        rows = 0 if kind == "empty" else build_rows
        table = kind in ("duplicate_wrap", "first_tile", "last_tile")
        dkeys, _, htk, htv = _dim_table(rng, rows, 1 << 20,
                                        duplicates=table, wrap=table)
        others = rng.integers(1 << 24, 1 << 30, n, dtype=np.int32)
        if kind == "duplicate_wrap":
            keys = np.where(rng.random(n) < 0.8, rng.choice(dkeys, n),
                            others)
        elif kind in ("first_tile", "last_tile"):
            lo, hi = tile_span(n, kind)
            keys = others.copy()
            keys[lo:hi] = rng.choice(dkeys, hi - lo)
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


RADIX_KINDS = ("uniform", "one_bucket", "duplicates", "negative")
# (start_bit, r, kind, payload columns): the passes the radix kernels are
# held to; r = 7 from bit 28 reads bits past 31 (zeros, as unsigned)
RADIX_CASES = [
    (0, 1, "uniform", 1), (0, 4, "duplicates", 3), (0, 8, "uniform", 1),
    (8, 8, "negative", 3), (24, 8, "negative", 1), (28, 7, "negative", 1),
    (0, 8, "one_bucket", 3), (8, 4, "one_bucket", 1),
    (24, 1, "duplicates", 1), (0, 8, "duplicates", 1),
]


def radix_case(seed: int, n: int, start_bit: int, r: int,
               kind: str = "uniform", n_vals: int = 1) -> tuple:
    """(keys, (vals0, ...), start_bit, r) for one radix-partition pass:
    "uniform" keys in [0, 2^31); "negative" over all of int32; "one_bucket"
    random keys whose bits [start_bit, start_bit + r) all hold one value;
    "duplicates" 20 distinct keys.  The first payload column is the row
    number (a stable pass keeps it ascending within a bucket), the
    others random int32."""
    rng = np.random.default_rng(seed)
    if kind == "negative":
        keys = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    elif kind == "duplicates":
        keys = rng.choice(rng.integers(-(1 << 31), 1 << 31, 20), n)
    else:
        keys = rng.integers(0, 1 << 31, n, dtype=np.int64)
    if kind == "one_bucket":
        field = (((1 << r) - 1) << start_bit) & 0xFFFFFFFF
        value = (int(rng.integers(0, 1 << r)) << start_bit) & field
        keys = (keys & ~field) | value
    keys = keys.astype(np.uint32).view(np.int32)
    vals = [np.arange(n, dtype=np.int32)] + [
        rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
        for _ in range(n_vals - 1)]
    return keys, tuple(vals), start_bit, r


SORT_KINDS = ("negative", "top_byte", "equal", "date")


def sort_case(seed: int, n: int, kind: str = "negative") -> tuple:
    """(keys, row numbers) for a radix sort, int32, by how many of its
    passes move rows: "negative" over all of int32 (at a few thousand rows
    every pass does); "top_byte" random low 24 bits under one top byte
    (an 8-bit sort's top pass moves nothing); "equal" one key >= 0 (no
    pass moves a row); "date" day indices in [0, 2556), as SSB's lo_orderdate
    (bits 12 and up are zero: two of an 8-bit sort's four passes move
    nothing)."""
    rng = np.random.default_rng(seed)
    if kind == "negative":
        keys = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    elif kind == "top_byte":
        keys = rng.integers(0, 1 << 24, n, dtype=np.int64) | (0x5A << 24)
    elif kind == "equal":
        keys = np.full(n, int(rng.integers(0, 1 << 31)), np.int64)
    elif kind == "date":
        keys = rng.integers(0, 2556, n, dtype=np.int64)
    else:
        raise ValueError(f"sort_case kind {kind!r} not in {SORT_KINDS}")
    return (keys.astype(np.uint32).view(np.int32),
            np.arange(n, dtype=np.int32))


PART_PROBE_KINDS = ("uniform", "hot", "empty_parts", "duplicates", "dead",
                    "empty_table", "clustered", "slots2", "slots4", "full",
                    "first_tile", "last_tile")


def _part_tables(rng: np.random.Generator, bits: int, kind: str):
    """(build keys, vals, htk, htv) of part_probe_case's "clustered",
    "slots2", "slots4" and "full" kinds: per partition p, keys = p mod P
    from [-2^20, 2^20) in a row of S slots.  "clustered": 8 keys a
    partition in 16 slots, 4 of them homed in the row's last 8 slots where
    the partition has such keys, so their chains run past its end;
    "slots2" / "slots4": 1 / 3 keys in 2 / 4 slots; "full": 16 keys of
    partition 0 (key 0 among them) fill its 16 slots, 8 keys a partition
    elsewhere.  With P >= S a partition's
    keys share one home slot: its chain holds them all."""
    n_parts = 1 << bits
    n_slots, per = {"clustered": (16, 8), "slots2": (2, 1),
                    "slots4": (4, 3), "full": (16, 8)}[kind]
    htk = np.full((n_parts, n_slots), EMPTY, np.int32)
    htv = np.zeros((n_parts, n_slots), np.int32)
    bkeys, bvals = [], []
    for p in range(n_parts):
        cand = (np.arange(-(1 << 20), 1 << 20, n_parts, dtype=np.int64) +
                p).astype(np.int32)
        take = n_slots if kind == "full" and p == 0 else per
        if kind == "clustered":
            # P >= S: a partition's keys all share one home slot
            tail = cand[np_hash(cand, n_slots) >= n_slots - 8]
            keys = rng.choice(tail if len(tail) else cand, per // 2,
                              replace=False)
            keys = np.concatenate([keys, rng.choice(
                cand[~np.isin(cand, keys)], per - per // 2, replace=False)])
        else:
            keys = rng.choice(cand[cand != 0], take, replace=False)
            if kind == "full" and p == 0:
                keys[0] = 0
        vals = rng.integers(0, 1000, len(keys), dtype=np.int32)
        htk[p], htv[p] = np_build(keys, vals, n_slots)
        bkeys.append(keys)
        bvals.append(vals)
    return np.concatenate(bkeys), np.concatenate(bvals), htk, htv


def part_probe_case(seed: int, n: int, bits: int, kind: str = "uniform",
                    build_rows: int = 0) -> tuple:
    """(keys, rowids, groups, offs, counts, htk, htv, mult) for
    ``part_probe``: a probe side already partition-major (stably bucketed
    by the key's low ``bits`` bits, as the join's partition pass leaves
    it), each partition's run, and the packed (2^bits, S) tables of a
    build side.  About 3 probe keys in 4 are in the build side.
    "hot": 90 % of the probe rows in partition 0; "empty_parts": build
    keys in partition 0 only, probe rows in every other partition but
    partition 1; "duplicates": a quarter of the build keys repeated with
    other payloads after their first row (the first wins); "dead": a
    tenth of the rows carry rowid -1 and never match; "empty_table": no
    build rows, an all-EMPTY table, every probe misses; "clustered",
    "slots2", "slots4", "full": the tables of ``_part_tables``, the
    misses of "clustered" homed in its clusters, and in "full" a run of
    partition 0 of 128·max(1, n // 512) found rows (at most n / 2) then
    n / 16 that miss after one lap of its full row; "first_tile" and
    "last_tile": "uniform", with every row outside the first or the last
    PROBE_TILE rows of the probe side turned into a miss of its own
    partition."""
    rng = np.random.default_rng(seed)
    n_parts = 1 << bits
    if kind in ("clustered", "slots2", "slots4", "full"):
        bkeys, bvals, htk, htv = _part_tables(rng, bits, kind)
        # keys of partition 0 that no table holds (|key| >= 2^22)
        far = (rng.integers(1 << 21, 1 << 22, n) * n_parts).astype(np.int32)
        if kind == "clustered":
            n_slots = htk.shape[1]
            cand = (np.arange(-(1 << 20), 1 << 20, dtype=np.int64)
                    .astype(np.int32))
            strays = cand[(np_hash(cand, n_slots) >= n_slots - 8) &
                          ~np.isin(cand, bkeys)]
            u = rng.random(n)
            keys = np.where(u < 0.6, rng.choice(bkeys, n),
                            np.where(u < 0.8, rng.choice(strays, n),
                                     far + rng.integers(0, n_parts, n)))
        elif kind == "full":
            found = min(n // 2, 128 * max(1, n // 512))
            lost = n // 16 if n_parts > 1 else n - found
            m = n - found - lost
            rest = bkeys[(bkeys & (n_parts - 1)) != 0]
            keys = np.concatenate([
                rng.choice(bkeys[(bkeys & (n_parts - 1)) == 0], found),
                far[:lost],
                np.where(rng.random(m) < 0.75,
                         rng.choice(rest, m) if len(rest) else 0,
                         far[lost:lost + m] + 1 +
                         rng.integers(0, max(n_parts - 1, 1), m))])
        else:
            keys = np.where(rng.random(n) < 0.75, rng.choice(bkeys, n),
                            far + rng.integers(0, n_parts, n))
        keys = keys.astype(np.int32)
        mult = 3
    else:
        build_rows = build_rows or max(64, 4 * n_parts)
        span = 8 * build_rows
        bkeys = rng.choice(np.arange(-span, span, dtype=np.int32),
                           build_rows, replace=False)
        if kind == "empty_parts":
            bkeys = bkeys & ~np.int32(n_parts - 1)
        bkeys = np.unique(bkeys)
        bvals = rng.integers(0, 1000, len(bkeys), dtype=np.int32)
        if kind == "duplicates":
            d = max(len(bkeys) // 4, 1)
            bkeys = np.concatenate([bkeys, bkeys[:d]])
            bvals = np.concatenate([bvals, rng.integers(1000, 2000, d,
                                                        dtype=np.int32)])
        if kind == "empty_table":
            bkeys, bvals = bkeys[:0], bvals[:0]
        hits = rng.choice(bkeys, n) if len(bkeys) else np.zeros(n, np.int32)
        misses = rng.integers(-2 * span, 2 * span, n, dtype=np.int32)
        keys = np.where(rng.random(n) < 0.75, hits, misses).astype(np.int32)
        if kind == "hot":
            hot = rng.random(n) < 0.9
            home = bkeys[(bkeys & (n_parts - 1)) == 0]
            keys[hot] = np.where(rng.random(int(hot.sum())) < 0.75,
                                 rng.choice(home, int(hot.sum())),
                                 keys[hot] & ~np.int32(n_parts - 1))
        if kind == "empty_parts" and n_parts > 1:
            one = (keys & (n_parts - 1)) == 1
            keys[one] ^= 3 if n_parts > 2 else 1
        htk, htv = pack_partitions(bkeys, bvals, bits)
        mult = 3
    rowids = rng.permutation(n).astype(np.int32)
    if kind == "dead":
        rowids[rng.random(n) < 0.1] = -1
    groups = rng.integers(0, 50, n, dtype=np.int32)
    bucket = keys & (n_parts - 1)
    order = np.argsort(bucket, kind="stable")
    keys = keys[order]
    if kind in ("first_tile", "last_tile"):
        lo, hi = tile_span(n, kind)
        out = np.ones(n, bool)
        out[lo:hi] = False
        keys[out] = (keys[out] & (n_parts - 1)) + n_parts * (1 << 20)
    counts = np.bincount(bucket, minlength=n_parts).astype(np.int32)
    offs = (np.cumsum(counts) - counts).astype(np.int32)
    return (keys, rowids[order], groups[order], offs, counts, htk, htv,
            mult)


@dataclass
class MultiCase:
    """Host arrays for one ``multi_spja`` call (see ``ref.multi_spja``)."""
    pred_cols: List[np.ndarray]
    pred_bounds: np.ndarray                 # (Q, C, 2) int32
    join_keys: List[np.ndarray]
    join_tables: List[np.ndarray]           # htk0, htv0, htk1, htv1, ...
    join_mults: np.ndarray                  # (Q, J) int32
    join_use: np.ndarray                    # (Q, J) int32
    q_valid: np.ndarray                     # (Q,) int32
    measure_cols: List[np.ndarray]
    measure_sel: np.ndarray                 # (Q, 3) int32
    n_groups: int
    member_groups: np.ndarray               # (Q,) reachable groups
    # packed streams: pred_widths, key_widths, key_refs, m_widths, m_refs,
    # n_rows (see ``multi_spja_case(packed=True)``)
    packed: Optional[dict] = None

    def args(self, device, merged: bool = False) -> tuple:
        """(positional args, keyword args) with the streams and tables as
        int32 tensors on ``device`` (a join that reuses another's column
        or table gets the same tensor).  ``merged`` adds ``probe_groups``:
        the streams that probe one key column are one group (its merged
        table from ``hashtable.build_merged``) when there are several,
        up to ``MERGE_STREAMS`` a group."""
        made = {}

        def t(a):
            if id(a) not in made:
                made[id(a)] = torch.from_numpy(
                    np.ascontiguousarray(a)).to(device)
            return made[id(a)]
        kw = dict(n_groups=self.n_groups, **(self.packed or {}))
        if merged:
            kw["probe_groups"] = self.probe_groups(device)
        return ((
            [t(c) for c in self.pred_cols], self.pred_bounds,
            [t(k) for k in self.join_keys], [t(h) for h in self.join_tables],
            self.join_mults, self.join_use, self.q_valid,
            [t(m) for m in self.measure_cols], self.measure_sel), kw)

    def probe_groups(self, device) -> tuple:
        """The case's probe groups: streams in order of their key column's
        first use, those of one key column merged (``build_merged``)."""
        by_col = {}
        for j, k in enumerate(self.join_keys):
            by_col.setdefault(id(k), []).append(j)
        out = []
        for streams in by_col.values():
            for lo in range(0, len(streams), MERGE_STREAMS):
                part = tuple(streams[lo:lo + MERGE_STREAMS])
                if len(part) == 1:
                    out.append((part, None))
                    continue
                slots, pay = build_merged(
                    [(self.join_tables[2 * j], self.join_tables[2 * j + 1])
                     for j in part])
                out.append((part, (torch.from_numpy(slots).to(device),
                                   torch.from_numpy(pay).to(device))))
        return tuple(out)

    @property
    def n(self) -> int:
        if self.packed:
            return int(self.packed["n_rows"])
        return int(self.measure_cols[0].shape[0])


def multi_spja_case(seed: int, n: int, n_members: int, n_preds: int,
                    n_joins: int, n_groups: int, *, n_meas: int = 3,
                    pad: int = 0, build_rows: int = 500,
                    empty_join: bool = False, duplicates: bool = False,
                    wrap: bool = False, shared_table: bool = False,
                    small: bool = False, packed: bool = False,
                    pred_phys: int = 8, merge: int = 1,
                    use_p: float = 2 / 3,
                    m_offset: int = 100_000) -> MultiCase:
    """A random wave of ``n_members`` SPJA members over C predicate
    columns, J probe streams and ``n_meas`` measure columns, then ``pad``
    padding members (valid 0) whose other parameters are random, so a
    wave that lets them add anything is caught.

    Each member filters a column with probability 1/2 (else all-pass
    bounds), uses each join but the last with probability ``use_p`` (2/3;
    the last join, when J >= 2, is anchor-only: use = mult = 0 for every real
    member), and groups by its used joins' payloads in mixed radix, the
    last radix one past its table's payloads so a few ids fall past
    n_groups (dropped); with n_groups == 1 every mult is 0.  Member 0,
    when it has an unused join, still takes that join's payload into its
    group id (mult without use: a miss adds 0 and filters nothing).
    ``shared_table`` makes join 1 probe join 0's key column and table
    (two streams, one build side); ``merge`` = k makes the joins of each
    run of k probe the first one's key column, each against a build side
    of its own that shares a random part of the first one's keys (a
    probe group of k streams).  ``empty_join`` empties join 0's
    table; ``small`` keeps measures small (f32 sums of a few thousand
    rows exact); ``packed`` packs every stream as ``packed_spja_case``
    does."""
    rng = np.random.default_rng(seed)
    q = n_members + pad
    domain = (1 << pred_phys) if packed else 100
    pred_cols = [rng.integers(0, domain, n, dtype=np.int32)
                 for _ in range(n_preds)]
    bounds = np.empty((q, n_preds, 2), np.int64)
    bounds[..., 0], bounds[..., 1] = -(1 << 31), (1 << 31) - 1
    for qi in range(q):
        for c in range(n_preds):
            if qi >= n_members or rng.random() < 0.5:
                lo = int(rng.integers(0, domain))
                hi = min(domain - 1, lo + int(rng.integers(domain // 5,
                                                          domain)))
                bounds[qi, c] = (lo, hi)
    per = max(2, int(round(n_groups ** (1.0 / max(min(n_joins, 3), 1)))))
    cards = [int(rng.integers(max(2, per - 2), per + 3))
             for _ in range(n_joins)]
    join_keys, tables = [], []
    for j in range(n_joins):
        if shared_table and j == 1:
            join_keys.append(join_keys[0])
            tables.extend(tables[:2])
            cards[1] = cards[0]
            continue
        rows = 0 if (empty_join and j == 0) else build_rows
        if j % merge:
            # a build side of the key column of join j - j % merge: a
            # random part of its keys and as many others, its own payloads
            lead = j - j % merge
            held = tables[2 * lead][tables[2 * lead] != EMPTY]
            dkeys = np.concatenate([
                rng.permutation(held)[:int(rng.integers(0, len(held) + 1))],
                rng.integers(-8 * build_rows, 8 * build_rows, rows // 2,
                             dtype=np.int32)])
            if duplicates and len(dkeys):
                dkeys = np.concatenate([dkeys, dkeys[:max(len(dkeys) // 4,
                                                          1)]])
            dvals = rng.integers(0, cards[j], len(dkeys), dtype=np.int32)
            htk, htv = np_build(dkeys.astype(np.int32), dvals,
                                next_pow2(max(len(dkeys), 1)))
            join_keys.append(join_keys[lead])
            tables.extend([htk, htv])
            continue
        dkeys, _, htk, htv = _dim_table(rng, rows, cards[j], duplicates,
                                        wrap)
        if len(dkeys):
            hits = rng.choice(dkeys, n)
            misses = rng.integers(-8 * build_rows, 8 * build_rows, n,
                                  dtype=np.int32)
            fk = np.where(rng.random(n) < 0.85, hits, misses)
        else:
            fk = rng.integers(-100, 100, n, dtype=np.int32)
        join_keys.append(fk.astype(np.int32))
        tables.extend([htk, htv])
    use = (rng.random((q, n_joins)) < use_p).astype(np.int32)
    if n_joins >= 2:
        use[:n_members, -1] = 0
    mults = np.zeros((q, n_joins), np.int64)
    member_groups = np.ones(q, np.int64)
    for qi in range(q):
        radix = 1
        used = np.flatnonzero(use[qi])
        for k, j in enumerate(used):
            if n_groups == 1 and qi < n_members:
                break
            mults[qi, j] = radix
            radix *= cards[j] + (1 if k == len(used) - 1 else 0)
        member_groups[qi] = min(radix, n_groups)
        if qi >= n_members:
            mults[qi] = rng.integers(-5, 50, n_joins)
    free = np.flatnonzero(use[0, :max(n_joins - 1, 0)] == 0)
    if n_members and n_groups > 1 and len(free):
        mults[0, free[0]] = 1
    hi1, hi2 = (30, 5) if small else (1000, 500)
    meas = [rng.integers(1 if k == 0 else 0, hi1 if k == 0 else hi2, n,
                         dtype=np.int32) for k in range(n_meas)]
    m1 = rng.integers(0, n_meas, q)       # m2 another column, if any
    m2 = (m1 + 1 + rng.integers(0, max(n_meas - 1, 1), q)) % n_meas
    sel = np.stack([m1, m2, rng.integers(0, 3, q)], axis=1)
    valid = np.zeros(q, np.int32)
    valid[:n_members] = 1
    c = MultiCase(pred_cols, bounds.astype(np.int32), join_keys, tables,
                  mults.astype(np.int32), use, valid, meas,
                  sel.astype(np.int32), n_groups, member_groups)
    if not packed:
        return c

    def pack(vals):         # a domain past 16 bits stays plain
        col = storage.pack_column(vals)
        return col.words, col.encoding

    keys = {}
    for k in join_keys:
        if id(k) not in keys:
            keys[id(k)] = pack(k)
    ms = [pack((m + m_offset).astype(np.int32)) for m in meas]
    c.pred_cols = [storage.pack_words(v, pred_phys) for v in pred_cols]
    c.join_keys = [keys[id(k)][0] for k in join_keys]
    c.measure_cols = [w for w, _ in ms]
    c.packed = dict(
        pred_widths=(pred_phys,) * n_preds,
        key_widths=tuple(keys[id(k)][1].phys for k in join_keys),
        key_refs=np.array([keys[id(k)][1].ref for k in join_keys], np.int32),
        m_widths=tuple(e.phys for _, e in ms),
        m_refs=np.array([e.ref for _, e in ms], np.int32), n_rows=n)
    return c


SUM_KINDS = ("int32_overflow", "f32_integers", "f32_random")


def reduce_case(seed: int, n: int, kind: str = "int32_overflow") -> tuple:
    """(x,) for ``reduce_sum``: "int32_overflow" int32 values whose sum
    wraps; "f32_integers" integer-valued f32 in [0, 1000) (exact in f64);
    "f32_random" non-integer f32."""
    rng = np.random.default_rng(seed)
    if kind == "int32_overflow":
        x = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    elif kind == "f32_integers":
        x = rng.integers(0, 1000, n).astype(np.float32)
    else:
        x = rng.standard_normal(n).astype(np.float32) * 1000
    return (x,)


def probe_agg_case(seed: int, n: int, kind: str = "duplicate_wrap",
                   vals: str = "int32") -> tuple:
    """(keys, vals, htk, htv) for ``probe_agg``: ``probe_case``'s keys and
    table (its kinds) with vals int32 over all of int32 (the sums wrap),
    integer-valued f32 in [0, 1000) ("f32_integers") or non-integer f32
    ("f32_random")."""
    keys, v, htk, htv = probe_case(seed, n, kind)
    rng = np.random.default_rng(seed + 1)
    if vals == "f32_integers":
        v = rng.integers(0, 1000, n).astype(np.float32)
    elif vals == "f32_random":
        v = rng.standard_normal(n).astype(np.float32) * 1000
    return keys, v, htk, htv


def join_bench_keys(seed: int, table_bytes: int):
    """(keys, n_slots) of the join microbenchmark's build side (Fig.
    13's shape, ``benchmarks/run.py::fig13_join``): keys 0..n_build-1 in
    a shuffled order, n_build = table_bytes / 16, so a table of 8-byte
    slots is ``table_bytes`` at 50 % fill."""
    n_build = max(16, table_bytes // 16)
    keys = np.random.default_rng(seed).permutation(n_build).astype(np.int32)
    return keys, next_pow2(n_build)


def join_bench_table(seed: int, table_bytes: int):
    """(htk, htv, n_build) for the join microbenchmark: the host build
    (``np_build``) of ``join_bench_keys`` with payload = key."""
    keys, n_slots = join_bench_keys(seed, table_bytes)
    htk, htv = np_build(keys, keys, n_slots)
    return htk, htv, len(keys)


BUILD_KINDS = ("distinct", "duplicates", "full", "empty")


def build_case(seed: int, n_slots: int, kind: str = "distinct",
               n: Optional[int] = None) -> tuple:
    """(keys, vals, n_slots) for ``build``: "distinct" n keys (default
    a ragged n past half of the slots) spread over int32, negative keys
    included; "duplicates" keys drawn from a tenth as many values, so
    chains hold a key's rows in row order; "full" n = n_slots;
    "empty" n = 0.  No key is EMPTY."""
    rng = np.random.default_rng(seed)
    if n is None:
        n = {"full": n_slots, "empty": 0}.get(kind, n_slots // 2 + 3)
    n = min(n, n_slots)
    if kind == "duplicates":
        keys = rng.integers(-50, max(1, n // 10), n, dtype=np.int32)
    else:
        keys = rng.integers(-(1 << 31) + 1, (1 << 31) - 1, n, dtype=np.int32)
    vals = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    return keys, vals, n_slots


SPARSE_ORDERS = ("uniform", "sorted")


def sparse_case(seed: int, n: int, selectivity: float,
                order: str = "uniform") -> tuple:
    """(x, y, lo, hi) for ``select_scan_sparse``: x int32 in [0, 2^30),
    uniform or sorted (the matches clustered in a few tiles), y int32 row
    tags; [lo, hi] selects about ``selectivity`` of the rows (none at
    0)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 30, n, dtype=np.int32)
    if order == "sorted":
        x.sort()
    y = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
    return x, y, 0, int(selectivity * (1 << 30)) - 1
