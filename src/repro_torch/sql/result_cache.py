"""Aggregate-result cache with predicate subsumption.

The port of ``repro.sql.result_cache``; the grids stay numpy f32 on the
host.

The serving loop's third way to answer a query, after "run it" and
"share the scan": don't scan at all.  Aggregate SPJA results are tiny —
a ``(n_groups,)`` f32 grid — so finished grids are worth keeping keyed
on the *canonical* plan (name-insensitive, filter-order-insensitive).
A repeated query is answered from the cache bit-identically
(``"exact"``); and because the repo's group ids are a mixed-radix
linearization of the join payloads (``group = sum payload_i * mult_i``),
a cached grid can also answer a *narrower* query — one whose only
difference is a strictly stronger filter on group-key joins — by
masking the groups whose digit the new filter keeps (``"subsume"``).
Re-filtering a 7000-slot grid on the host replaces a full fact scan.

Subsumption is only claimed when it is provably bit-identical to a
fresh run.  For a cached plan C answering a new plan Q:

* C and Q share a **structure key**: same scan table, identical fact
  filters (order-insensitive), same measure/grouping, and joins that
  agree pairwise on everything except the dim filter.
* every join whose filter differs is a **group-key** join
  (``mult > 0``) whose new build mask is a *subset* of the cached one
  (``mQ <= mC``, checked exactly on the dim table — dims are small).
* the cached build side has **unique keys**: with duplicate dim keys
  the hash build's first-wins selection could resolve differently
  under the two filters, changing matched payloads.
* the payload values the new filter keeps and the values it drops are
  **disjoint sets** — a group digit then identifies *which* build rows
  produced it, so masking by kept digits keeps exactly the fact rows a
  fresh run would keep.
* the group-id layout is **exactly decomposable** into digits: group
  multipliers sorted ascending must divide each other, and the payload
  values observed under the cached filters must fit each digit's
  capacity (``digit_i(g) = (g // mult_i) % cap_i`` then inverts the
  linearization with no carries).

Everything else — widened bounds, filter-only joins, duplicate keys,
non-decomposable layouts, raw-callable fact predicates — is a miss,
never a wrong answer.  The port sums every group exactly (int64) and
rounds once, so a masked cached grid equals a fresh run bitwise, at any
scale; the tests and the smoke hold every served subsumption to the
numpy oracle.

Invalidation: the cache binds to one database object and snapshots
every table's ``(id, n_rows, delta_rows)`` (``storage.delta_rows``);
any ingest (appended delta batches) or rebinding clears the whole
cache — every cached grid scanned the fact table, so any table change
invalidates all of them.
The cache is thread-safe (the serving loop reads it from the admission
path while the worker inserts) and joins the ``ResourceGovernor``'s
pressure reaction: ``clear()`` is always safe, so grids are the first
soft state to go.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sql import plan as P
from repro_torch.sql import storage as ST

__all__ = ["canonical_key", "structure_key", "digit_layout",
           "subsume_mask", "ResultCache"]


# ---------------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------------


def _join_key(j: P.HashJoin, with_filter: bool) -> Tuple:
    key = (j.fact_col, j.dim, j.key_col,
           P.fingerprint(j.payload), int(j.mult))
    if with_filter:
        key += (P.fingerprint(j.filter),)
    return key


def _key(plan: P.Plan, with_join_filters: bool) -> Optional[Tuple]:
    if plan.project is None or plan.group is None:
        return None                     # row plans: nothing grid-shaped
    for pred in plan.filters:
        if callable(pred) and not isinstance(
                pred, (P.TruePred, P.RangePred, P.EqPred, P.InPred)):
            return None                 # raw-callable fact predicate:
            # identity-fingerprinted AND order-sensitive under sorting —
            # conservatively uncacheable
    filters = tuple(sorted((P.fingerprint(p) for p in plan.filters),
                           key=repr))   # conjunction commutes
    joins = tuple(_join_key(j, with_join_filters) for j in plan.joins)
    proj = plan.project
    return (plan.scan.table, filters, joins,
            (proj.m1, proj.m2, proj.op), plan.n_groups)


def canonical_key(plan: P.Plan) -> Optional[Tuple]:
    """Name-insensitive, filter-order-insensitive identity of an
    aggregate plan — equal keys mean bit-identical grids.  ``None``
    marks the plan uncacheable (row plan / raw-callable fact pred)."""
    return _key(plan, with_join_filters=True)


def structure_key(plan: P.Plan) -> Optional[Tuple]:
    """The canonical key *minus* the per-join dim filters: two plans
    sharing it differ at most in join filters — the subsumption
    candidacy bucket."""
    return _key(plan, with_join_filters=False)


# ---------------------------------------------------------------------------
# mixed-radix digit layout + subsumption mask
# ---------------------------------------------------------------------------


def digit_layout(plan: P.Plan, db) -> Optional[Dict[int, np.ndarray]]:
    """Per-group digit value of every group-key join, or ``None`` when
    the linearization is not exactly decomposable.

    Returns ``{join_index: int array of shape (n_groups,)}`` where entry
    ``g`` is the payload digit join ``i`` contributed to group id ``g``.
    Requires ascending multipliers to divide each other and the payload
    values observed *under the plan's own join filters* to fit each
    digit's capacity — then ``(g // mult) % cap`` inverts the
    ``sum payload * mult`` linearization with no carries."""
    keyed = [(i, j) for i, j in enumerate(plan.joins) if j.mult > 0]
    if not keyed:
        return None
    keyed.sort(key=lambda t: t[1].mult)
    mults = [j.mult for _, j in keyed]
    caps: List[int] = []
    for k, m in enumerate(mults):
        if k + 1 < len(mults):
            if mults[k + 1] % m:
                return None             # non-divisible radix: carries
            caps.append(mults[k + 1] // m)
        else:
            caps.append(-(-plan.n_groups // m))
    g = np.arange(plan.n_groups, dtype=np.int64)
    out: Dict[int, np.ndarray] = {}
    for (i, j), m, cap in zip(keyed, mults, caps):
        dim = getattr(db, j.dim)
        dmask = P.pred_mask(j.filter, dim)
        if not dmask.any():
            return None                 # empty build: grid is all-zero,
            # but digits are unconstrained — nothing to decompose
        pay = P.expr_values(j.payload, dim).astype(np.int64)[dmask]
        if int(pay.min()) < 0 or int(pay.max()) >= cap:
            return None                 # digit overflow: ids alias
        out[i] = (g // m) % cap
    return out


def subsume_mask(cached: P.Plan, new: P.Plan, db) -> Optional[np.ndarray]:
    """Group mask answering ``new`` from ``cached``'s grid, or ``None``.

    The caller guarantees equal :func:`structure_key`; this checks the
    per-join narrowing conditions the module docstring lists and builds
    the conjunction of kept-digit masks.  ``None`` means "run it fresh",
    never "close enough"."""
    layout: Optional[Dict[int, np.ndarray]] = None
    mask = np.ones(new.n_groups, bool)
    for i, (jc, jn) in enumerate(zip(cached.joins, new.joins)):
        if P.fingerprint(jc.filter) == P.fingerprint(jn.filter):
            continue                    # identical build side: no-op
        if jc.mult <= 0:
            return None                 # filter-only join: its filter
            # changes row survival but leaves no trace in the group id
        dim = getattr(db, jc.dim)
        mC = P.pred_mask(jc.filter, dim)
        mQ = P.pred_mask(jn.filter, dim)
        if bool(np.any(mQ & ~mC)):
            return None                 # not a narrowing
        if not mQ.any():
            # empty new build side: every probe misses, grid all zero
            return np.zeros(new.n_groups, bool)
        keys = np.asarray(dim[jc.key_col])[mC]
        if np.unique(keys).size != keys.size:
            return None                 # duplicate keys: first-wins
            # build selection may differ between the two filters
        if layout is None:
            layout = digit_layout(cached, db)
        if layout is None or i not in layout:
            return None
        pay = P.expr_values(jc.payload, dim).astype(np.int64)
        kept = np.unique(pay[mQ])
        dropped = np.unique(pay[mC & ~mQ])
        if np.intersect1d(kept, dropped).size:
            return None                 # a digit value on both sides of
            # the narrowing cannot tell kept rows from dropped ones
        mask &= np.isin(layout[i], kept)
    return mask


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    key: Tuple
    skey: Tuple
    plan: P.Plan
    grid: np.ndarray
    tick: int = 0

    @property
    def nbytes(self) -> int:
        return int(self.grid.nbytes)


_TABLE_NAMES = ("lineorder", "date", "supplier", "customer", "part")


class ResultCache:
    """Bounded LRU of finished aggregate grids, exact + subsumption
    lookups, bound to one database snapshot.

        rc = ResultCache()
        rc.insert(db, plan, grid)
        hit = rc.lookup(db, plan)     # None | (grid copy, "exact"|"subsume")

    Thread-safe; ``clear()`` is the governor's pressure hook.
    """

    def __init__(self, max_entries: int = 64,
                 max_bytes: int = 8 << 20):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.hits = 0
        self.subsume_hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        self._lock = threading.RLock()
        self._entries: Dict[Tuple, _Entry] = {}
        self._by_structure: Dict[Tuple, List[Tuple]] = {}
        self._bytes = 0
        self._tick = 0
        self._db_token: Optional[int] = None
        self._snapshot: Optional[Tuple] = None

    # -- db identity ---------------------------------------------------
    @staticmethod
    def _observe(db) -> Tuple:
        state = []
        for name in _TABLE_NAMES:
            tbl = getattr(db, name, None)
            if tbl is None:
                continue
            try:
                deltas = ST.delta_rows(tbl)
            except Exception:
                deltas = 0
            state.append((name, id(tbl), int(getattr(tbl, "n_rows", 0)),
                          int(deltas)))
        return tuple(state)

    def _validate(self, db) -> None:
        """Bind to ``db`` on first use; clear on rebinding or on any
        table change (ingest) — every grid scanned the fact, so any
        change invalidates all of them.  Caller holds the lock."""
        snap = self._observe(db)
        if self._db_token == id(db) and self._snapshot == snap:
            return
        if self._entries:
            self.invalidations += 1
            self._drop_all()
        self._db_token = id(db)
        self._snapshot = snap

    # -- bookkeeping ---------------------------------------------------
    def _drop_all(self) -> int:
        n = len(self._entries)
        self._entries.clear()
        self._by_structure.clear()
        self._bytes = 0
        return n

    def _drop(self, key: Tuple) -> None:
        e = self._entries.pop(key, None)
        if e is None:
            return
        self._bytes -= e.nbytes
        sk = self._by_structure.get(e.skey)
        if sk is not None:
            try:
                sk.remove(key)
            except ValueError:
                pass
            if not sk:
                del self._by_structure[e.skey]

    def _evict_lru(self) -> None:
        while self._entries and (len(self._entries) > self.max_entries
                                 or self._bytes > self.max_bytes):
            coldest = min(self._entries.values(), key=lambda e: e.tick)
            self._drop(coldest.key)
            self.evictions += 1

    # -- public API ----------------------------------------------------
    def insert(self, db, plan: P.Plan, grid: np.ndarray) -> bool:
        key = canonical_key(plan)
        if key is None:
            return False
        skey = structure_key(plan)
        g = np.asarray(grid)
        if g.ndim != 1 or g.shape[0] != plan.n_groups:
            return False                # not an aggregate grid
        with self._lock:
            self._validate(db)
            self._tick += 1
            if key in self._entries:    # refresh (idempotent re-insert)
                self._drop(key)
            e = _Entry(key, skey, plan, np.array(g, copy=True),
                       tick=self._tick)
            self._entries[key] = e
            self._by_structure.setdefault(skey, []).append(key)
            self._bytes += e.nbytes
            self.insertions += 1
            self._evict_lru()
            return True

    def lookup(self, db, plan: P.Plan
               ) -> Optional[Tuple[np.ndarray, str]]:
        key = canonical_key(plan)
        if key is None:
            return None
        with self._lock:
            self._validate(db)
            self._tick += 1
            e = self._entries.get(key)
            if e is not None:
                e.tick = self._tick
                self.hits += 1
                return np.array(e.grid, copy=True), "exact"
            # subsumption: newest structural sibling that provably
            # contains this query's bounds
            skey = structure_key(plan)
            for cand_key in reversed(self._by_structure.get(skey, [])):
                cand = self._entries[cand_key]
                try:
                    mask = subsume_mask(cand.plan, plan, db)
                except Exception:
                    mask = None         # a failed check is a miss,
                    # never a failed request
                if mask is None:
                    continue
                cand.tick = self._tick
                self.hits += 1
                self.subsume_hits += 1
                grid = np.where(mask, cand.grid,
                                np.zeros(1, cand.grid.dtype))
                return grid.astype(cand.grid.dtype, copy=False), "subsume"
            self.misses += 1
            return None

    def clear(self) -> int:
        """Drop everything (the governor's pressure hook); returns the
        number of entries dropped."""
        with self._lock:
            n = self._drop_all()
            self.evictions += n
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "subsume_hits": self.subsume_hits,
                    "misses": self.misses, "insertions": self.insertions,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations}
