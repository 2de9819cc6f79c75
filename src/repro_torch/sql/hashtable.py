"""Physical dimension hash tables: host-side build + cross-query cache.

The port of ``repro.sql.hashtable`` (monolithic build only).  The build is
the numpy parallel linear-probe placement, unchanged, so the tables are
byte-identical to the reference's; only the result is uploaded, once, as
two int32 tensors on the device the fused kernel probes them on.  Dimension
tables are small beside the fact table (the paper makes the same split,
§4.3: build time is noise at SSB dimension cardinalities).

``HashTableCache`` keys built tables by the *logical* identity of the
build side — (dim table, key column, filter fingerprint, payload
fingerprint) — plus the device, so a warm cache serves every query that
shares a build side without a rebuild or an upload.

Not here yet: the partitioned and replicated builds (ROADMAP queue 1,
items 7 and 9).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import EMPTY   # probe kernels compare against it
from repro_torch.device import resolve
from repro_torch.sql import plan as P
from repro_torch.sql import ssb


def np_hash(keys: np.ndarray, n_slots: int) -> np.ndarray:
    return ((keys.astype(np.uint32) * np.uint32(2654435761))
            & np.uint32(n_slots - 1)).astype(np.int64)


def np_build(keys: np.ndarray, vals: np.ndarray, n_slots: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    htk = np.full(n_slots, EMPTY, np.int32)
    htv = np.zeros(n_slots, np.int32)
    slot = np_hash(keys, n_slots)
    pending = np.arange(len(keys))
    while len(pending):
        s = slot[pending]
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        first = np.ones(len(s_sorted), bool)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        winner_rows = pending[order[first]]
        winner_slots = s_sorted[first]
        empty = htk[winner_slots] == EMPTY
        placed = winner_rows[empty]
        htk[winner_slots[empty]] = keys[placed]
        htv[winner_slots[empty]] = vals[placed]
        placed_mask = np.zeros(len(keys), bool)
        placed_mask[placed] = True
        rest = pending[~placed_mask[pending]]
        slot[rest] = (slot[rest] + 1) & (n_slots - 1)
        pending = rest
    return htk, htv


def next_pow2(n: int) -> int:
    return 1 << max(4, int(np.ceil(np.log2(max(n * 2, 2)))))


def filtered_build_side(db: ssb.Database, join: P.HashJoin
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(keys, payload vals) of one join's dim side after the dim filter.
    May be empty (the filter drops every row): the build then yields a
    valid all-EMPTY table, and every probe misses (the query's result is
    zero, not a crash)."""
    dim: ssb.Table = getattr(db, join.dim)
    mask = P.pred_mask(join.filter, dim)
    keys = np.asarray(dim[join.key_col])[mask].astype(np.int32)
    vals = P.expr_values(join.payload, dim)[mask]
    if len(vals) and vals.min() < 0:
        # non-negative payloads are the engine's contract: the numpy
        # oracle marks probe misses with a negative sentinel, and negative
        # group-id contributions would leave the group range — a
        # negative payload would silently diverge the paths
        raise ValueError(
            f"join on {join.dim}.{join.key_col}: payload {join.payload!r} "
            f"yields negative values (min {int(vals.min())}) on filtered "
            "rows; payloads must be >= 0 after the dim filter")
    return keys, vals


def build_dim_table(db: ssb.Database, join: P.HashJoin, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the (filtered) hash table for one join's dim side on the
    host, then upload it once as two int32 tensors on ``device``.
    Probe miss == row filtered (selective-join pipelining)."""
    device = resolve(device)
    keys, vals = filtered_build_side(db, join)
    n_slots = next_pow2(max(len(keys), 1))
    htk, htv = np_build(keys, vals, n_slots)
    return torch.from_numpy(htk).to(device), torch.from_numpy(htv).to(device)


def join_cache_key(join: P.HashJoin) -> Tuple:
    """Logical identity of a join's build side (mult is a probe-side
    concern and deliberately excluded — same table, different group
    multiplier still hits)."""
    return (join.dim, join.key_col,
            P.fingerprint(join.filter), P.fingerprint(join.payload))


def _has_callable(part) -> bool:
    if isinstance(part, tuple):
        return (bool(part) and part[0] == "callable") or \
            any(_has_callable(p) for p in part)
    return False


def _cacheable(key: Tuple) -> bool:
    """Identity-fingerprinted (callable) build sides — at any nesting
    depth, e.g. inside a FlagExpr — never re-hit across independently
    built plans, so storing them only pins memory."""
    return not _has_callable(key)


def db_fingerprint(db, tables: Optional[Iterable[str]] = None) -> Tuple:
    """Cheap data identity of a Database: per table, (attr, name, n_rows,
    crc32 of every column's data).  Build sides depend on non-key
    columns too (dim filters and payloads), so all columns participate.
    ``tables`` restricts the fingerprint to the named attributes (the
    cache only ever builds from dimension tables); ``None``
    fingerprints everything."""
    names = None if tables is None else set(tables)
    items = []
    for attr, t in vars(db).items():
        if not isinstance(t, ssb.Table):
            continue
        if names is not None and attr not in names:
            continue
        crc = 0
        for c in sorted(t.columns):
            crc = zlib.crc32(np.ascontiguousarray(t[c]).tobytes(), crc)
        items.append((attr, t.name, t.n_rows, crc))
    return tuple(sorted(items))


@dataclass
class HashTableCache:
    """Keyed cache of built dimension hash tables with hit/miss stats.

    Scoped to a single *logical* database: the first ``get_or_build``
    binds the cache to its database; later calls with a different object
    first compare ``db_fingerprint`` over the dims the cached entries
    reference — an equal-but-reloaded database rebinds and keeps the
    warmed entries, a genuinely different one raises rather than serving
    wrong tables.  ``reset()`` drops the entries and the binding.
    """
    tables: Dict[Tuple, object] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    # recency bookkeeping for evict_cold(): every access stamps its key
    _tick: int = 0
    _last_used: Dict[Tuple, int] = field(default_factory=dict, repr=False)
    _db: object = None
    _dims: Set[str] = field(default_factory=set)
    _db_fp: Optional[Tuple] = None      # (dims scope, fingerprint) memo
    # databases already proven equal to the binding
    _accepted: List[object] = field(default_factory=list, repr=False)

    def _bind(self, db) -> None:
        if self._db is db or any(db is a for a in self._accepted):
            return
        if self._db is None:
            self._db = db           # fingerprint deferred: the common
            self._accepted.append(db)   # never-reloaded case pays nothing
            return
        dims = frozenset(self._dims)
        if self._db_fp is None or self._db_fp[0] != dims:
            self._db_fp = (dims, db_fingerprint(self._db, dims))
        if db_fingerprint(db, dims) == self._db_fp[1]:
            self._db = db           # reloaded copy of the same data
            self._accepted.append(db)
            return
        raise ValueError(
            "HashTableCache is scoped to one Database; call reset() (or "
            "use a fresh cache) before serving a different database")

    def reset(self) -> None:
        """Drop all entries and the database binding (data reload)."""
        self.tables.clear()
        self._dims.clear()
        self._last_used.clear()
        self._db = None
        self._db_fp = None
        self._accepted.clear()

    def _touch(self, key: Tuple) -> None:
        self._tick += 1
        self._last_used[key] = self._tick

    def evict_cold(self, keep: int = 2) -> int:
        """Drop every entry except the ``keep`` most recently used; a
        later request simply rebuilds (a miss, not an error).  Returns
        the eviction count."""
        if len(self.tables) <= keep:
            return 0
        by_recency = sorted(self.tables,
                            key=lambda k: self._last_used.get(k, 0))
        victims = by_recency[:len(by_recency) - keep]
        for k in victims:
            self.tables.pop(k, None)
            self._last_used.pop(k, None)
        return len(victims)

    def get_or_build(self, db: ssb.Database, join: P.HashJoin, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = resolve(device)
        self._bind(db)
        key = (join_cache_key(join), str(device))
        hit = self.tables.get(key)
        if hit is not None:
            self.hits += 1
            self._touch(key)
            return hit
        self.misses += 1
        built = build_dim_table(db, join, device)
        if _cacheable(key):
            self.tables[key] = built
            self._dims.add(join.dim)
            self._touch(key)
        return built

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
