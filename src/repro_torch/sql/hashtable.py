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

A wave's merged table (``build_merged``) serves every build side that one
fact key column probes against one dimension key: one probe of the
union of their keys says which build sides hold the key (a stream mask)
and where each one's payload is (an entry of a payload matrix), as each
build side's own table would answer.

The partitioned build (``build_dim_partitions``) buckets the build side
by the key's low bits and builds one table per partition with the same
``np_build``, as the reference does: a list of tables sized each to its
partition (``part_loop``), or the dense ``(P, S)`` layout of
``PackedParts`` that the one-launch partitioned probe reads (``part``).

The sharded strategy (``repro_torch.sql.shard``) serves every shard from
one build: a shard shares the base database's dimension tables by object,
so the cache takes a ``ShardedDatabase``, or a shard of one, as its base
(``db_fingerprint`` reads only the dimension tables), and
``get_or_build_replicated`` places a table on each device of a set once.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import EMPTY   # probe kernels compare against it
from repro_torch.device import resolve
from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql.storage import PackedTable


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


def np_lookup(htk: np.ndarray, htv: np.ndarray, keys: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The probe of ``kernels/csrc/hash.cuh`` in numpy -> (payload int32,
    found bool) per key: walk from the key's home slot until the key (a
    hit) or EMPTY (a miss), one lap at most.  A probe key equal to EMPTY
    stops at the first EMPTY slot of its walk as a hit, as the kernels'
    probe does."""
    keys = np.asarray(keys, np.int32)
    n_slots = len(htk)
    payload = np.zeros(len(keys), np.int32)
    found = np.zeros(len(keys), bool)
    slot = np_hash(keys, n_slots)
    pending = np.arange(len(keys))
    for _ in range(n_slots):
        if not len(pending):
            break
        k = htk[slot[pending]]
        hit = k == keys[pending]
        payload[pending[hit]] = htv[slot[pending[hit]]]
        found[pending[hit]] = True
        pending = pending[~(hit | (k == EMPTY))]
        slot[pending] = (slot[pending] + 1) & (n_slots - 1)
    return payload, found


# the most build sides one merged table serves (bits of its stream mask)
MERGE_STREAMS = 32


def build_merged(tables: Sequence[Tuple[np.ndarray, np.ndarray]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One table for k <= ``MERGE_STREAMS`` build sides probed by one fact
    key column -> (slots (S, 4) int32, payloads (k, E) int32).

    A slot holds a key of the union of the tables' keys, the mask of the
    tables that find it (bit s for ``tables[s]``), its entry, and 0; the
    slot count follows ``build_dim_table``'s fill rule over the union, and
    the keys are placed by ``np_build``.  Row s of the payload matrix holds
    what ``tables[s]`` returns for each entry's key (0 where it misses),
    found by looking the key up in that table itself (``np_lookup``), so
    duplicate keys, the first row's win and negative keys agree with it
    by construction.  The last entry answers a probe of the key EMPTY,
    which stops at the first EMPTY slot of its walk in every table."""
    k = len(tables)
    if not 1 <= k <= MERGE_STREAMS:
        raise ValueError(f"a merged table serves 1..{MERGE_STREAMS} build "
                         f"sides, got {k}")
    held = [htk[htk != EMPTY] for htk, _ in tables]
    keys = np.unique(np.concatenate(held)).astype(np.int32)
    n_slots = next_pow2(max(len(keys), 1))
    entries = np.arange(len(keys) + 1, dtype=np.int32)
    slot_keys, slot_entry = np_build(keys, entries[:-1], n_slots)
    probe = np.append(keys, np.int32(EMPTY))
    pay = np.zeros((k, len(probe)), np.int32)
    mask = np.zeros(len(probe), np.uint32)
    for s, (htk, htv) in enumerate(tables):
        payload, found = np_lookup(htk, htv, probe)
        pay[s] = np.where(found, payload, 0)
        mask |= found.astype(np.uint32) << np.uint32(s)
    slots = np.zeros((n_slots, 4), np.int32)
    slots[:, 0] = slot_keys
    filled = slot_keys != EMPTY
    slots[filled, 1] = mask[slot_entry[filled]].view(np.int32)
    slots[filled, 2] = slot_entry[filled]
    stop = int(np_hash(np.array([EMPTY], np.int32), n_slots)[0])
    while slot_keys[stop] != EMPTY:     # at most half full: it ends
        stop = (stop + 1) & (n_slots - 1)
    slots[stop, 1] = mask[-1].view(np.int32)
    slots[stop, 2] = entries[-1]
    return slots, pay


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
    from repro_torch.sql import faults
    faults.maybe_fault("build")
    device = resolve(device)
    keys, vals = filtered_build_side(db, join)
    n_slots = next_pow2(max(len(keys), 1))
    htk, htv = np_build(keys, vals, n_slots)
    return torch.from_numpy(htk).to(device), torch.from_numpy(htv).to(device)


def merged_table(tables: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``build_merged`` of the (htk, htv) tensor pairs, uploaded once to
    ``device`` -> (slots (S, 4), payloads (k, E)) int32 tensors."""
    slots, pay = build_merged([(htk.cpu().numpy(), htv.cpu().numpy())
                               for htk, htv in tables])
    device = resolve(device)
    return torch.from_numpy(slots).to(device), torch.from_numpy(pay).to(device)


@dataclass(frozen=True)
class PackedParts:
    """Dense packed layout of 2^bits per-partition hash tables: one
    ``(P, S)`` key tensor and one ``(P, S)`` value tensor on ``device``,
    ``S`` one power-of-two slot count shared by every partition (sized off
    the fullest partition, at most half full like the monolithic build).
    Row ``p`` is partition p's table: the layout the one-launch
    partitioned probe (``kernels/part_probe.py``) reads."""
    htk: torch.Tensor                   # (P, S) int32, EMPTY-filled slots
    htv: torch.Tensor                   # (P, S) int32
    device: torch.device

    @property
    def n_parts(self) -> int:
        return self.htk.shape[0]

    @property
    def n_slots(self) -> int:
        return self.htk.shape[1]

    @property
    def nbytes(self) -> int:
        return (self.htk.numel() + self.htv.numel()) * 4


def _bucket_runs(keys: np.ndarray, vals: np.ndarray, bits: int):
    """Sort the build side into contiguous low-bit bucket runs; yields
    (keys_run, vals_run) per partition, rows in build order within a
    run (so the first duplicate still wins)."""
    bucket = keys & ((1 << bits) - 1)
    order = np.argsort(bucket, kind="stable")   # one pass, then slice
    keys, vals = keys[order], vals[order]       # contiguous bucket runs
    ends = np.cumsum(np.bincount(bucket, minlength=1 << bits))
    start = 0
    for p in range(1 << bits):
        yield keys[start:ends[p]], vals[start:ends[p]]
        start = int(ends[p])


def pack_partitions(keys: np.ndarray, vals: np.ndarray, bits: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The packed ``(2^bits, S)`` host tables of a build side: row p is
    ``np_build`` of partition p's rows at the slot count S of the fullest
    partition."""
    counts = np.bincount(keys & ((1 << bits) - 1), minlength=1 << bits)
    n_slots = next_pow2(max(int(counts.max()) if len(keys) else 0, 1))
    htk = np.full((1 << bits, n_slots), EMPTY, np.int32)
    htv = np.zeros((1 << bits, n_slots), np.int32)
    for p, (kp, vp) in enumerate(_bucket_runs(keys, vals, bits)):
        htk[p], htv[p] = np_build(kp, vp, n_slots)
    return htk, htv


def build_dim_partitions(db: ssb.Database, join: P.HashJoin, bits: int,
                         side: Optional[Tuple[np.ndarray, np.ndarray]]
                         = None, packed: bool = False, device=None):
    """Radix-partitioned build on the host: 2^bits per-partition hash
    tables, bucketed by the key's low ``bits`` bits (the probe side
    partitions by the same rule), uploaded once to ``device``.  ``side``
    lets a caller that already filtered the build side pass it in.

    ``packed=False`` returns the loop layout, a list of per-partition
    (htk, htv) tensor pairs, each sized to its own partition (the
    ``part_loop`` strategy); ``packed=True`` returns :class:`PackedParts`
    (the ``part`` strategy)."""
    device = resolve(device)
    keys, vals = side if side is not None else filtered_build_side(db, join)
    if not packed:
        parts: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for kp, vp in _bucket_runs(keys, vals, bits):
            htk, htv = np_build(kp, vp, next_pow2(max(len(kp), 1)))
            parts.append((torch.from_numpy(htk).to(device),
                          torch.from_numpy(htv).to(device)))
        return parts
    htk, htv = pack_partitions(keys, vals, bits)
    return PackedParts(torch.from_numpy(htk).to(device),
                       torch.from_numpy(htv).to(device), device)


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
    A ``PackedTable`` decodes on access, so a packed database
    fingerprints as its plain original: a cache warmed on one serves the
    other, and never a database of other data.
    ``tables`` restricts the fingerprint to the named attributes (the
    cache only ever builds from dimension tables); ``None``
    fingerprints everything.  A ``shard.ShardedDatabase`` fingerprints
    as its base (duck-typed by its ``base`` attribute): its shards
    differ only in the fact table, which no build side reads."""
    db = getattr(db, "base", db)
    names = None if tables is None else set(tables)
    items = []
    for attr, t in vars(db).items():
        if not isinstance(t, (ssb.Table, PackedTable)):
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
    wrong tables.  A shard of a ``shard.ShardedDatabase`` shares the
    base's dimension tables, so it passes that check and is served
    without a rebuild; a ``ShardedDatabase`` binds as its base.
    ``reset()`` drops the entries and the binding.
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
        db = getattr(db, "base", db)
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

    def get_or_build_merged(self, db: ssb.Database,
                            joins: Sequence[P.HashJoin],
                            tables: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]],
                            device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The merged table (``build_merged``) of ``joins``' build sides,
        whose own tables are ``tables``, on ``device``: cached under the
        ordered build-side keys and the device, so a warm wave builds
        nothing.  Kept apart from the hit and miss counts, which count
        the build sides' own tables."""
        device = resolve(device)
        self._bind(db)
        key = ("merged", tuple(join_cache_key(j) for j in joins),
               str(device))
        hit = self.tables.get(key)
        if hit is not None:
            self._touch(key)
            return hit
        built = merged_table(tables, device)
        if _cacheable(key):
            self.tables[key] = built
            self._dims.update(j.dim for j in joins)
            self._touch(key)
        return built

    def get_build_count(self, db: ssb.Database, join: P.HashJoin) -> int:
        """Filtered build-side row count, memoized under the join's
        logical key (the partitioned lowering sizes ``part_bits`` from it
        on every execute).  Not a build: it leaves the hit/miss stats
        alone."""
        self._bind(db)
        key = ("n_build", join_cache_key(join))
        hit = self.tables.get(key)
        if hit is not None:
            self._touch(key)
            return hit
        n = len(filtered_build_side(db, join)[0])
        if _cacheable(key):
            self.tables[key] = n
            self._dims.add(join.dim)
            self._touch(key)
        return n

    def get_or_build_parts(self, db: ssb.Database, join: P.HashJoin,
                           bits: int, packed: bool = False, device=None):
        """Partitioned analogue of ``get_or_build``: 2^bits
        per-partition tables, cached under the build side's logical key,
        ``bits``, the layout (the loop's list and :class:`PackedParts`
        are distinct entries) and the device."""
        device = resolve(device)
        self._bind(db)
        key = (join_cache_key(join), "part", bits,
               "packed" if packed else "list", str(device))
        hit = self.tables.get(key)
        if hit is not None:
            self.hits += 1
            self._touch(key)
            return hit
        self.misses += 1
        built = build_dim_partitions(db, join, bits, packed=packed,
                                     device=device)
        if _cacheable(key):
            self.tables[key] = built
            self._dims.add(join.dim)
            self._touch(key)
        return built

    def get_or_build_replicated(self, db, join: P.HashJoin,
                                devices: Sequence
                                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One join's table on each of ``devices`` -> ``[(htk, htv), ...]``
        in their order: ``get_or_build`` on the first, then a copy to each
        other (``shard.replicate``), cached under the build side's logical
        key and the device set, so a sharded execution places each table
        once.  The first device's entry is the solo path's own: on one
        device this is one hit on a table already built and no second
        upload."""
        from repro_torch.sql.shard import replicate
        devs = [resolve(d) for d in devices]
        self._bind(db)
        key = (join_cache_key(join), "replicated",
               tuple(str(d) for d in devs))
        hit = self.tables.get(key)
        if hit is not None:
            self.hits += 1
            self._touch(key)
            return hit
        first = self.get_or_build(db, join, devs[0])
        built = [first] + replicate(devs[1:], first)
        if _cacheable(key):
            self.tables[key] = built
            self._dims.add(join.dim)
            self._touch(key)
        return built

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
