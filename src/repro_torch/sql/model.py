"""Per-strategy bandwidth cost model: the paper's method applied to plan
selection.

The port of ``repro.sql.model``, its formulas unchanged, so the port and
the reference predict the same seconds on the same ``Hardware``.  Every
operator's runtime is predicted from the bytes it moves through the
memory hierarchy (§4); full queries reach the bandwidth ratio only when
the physical plan keeps random-access structures in fast memory (§4.4,
Fig. 8).  Evaluated per physical strategy of one logical plan:

  fused — one pass over the needed fact columns + one probe stream per
          join against the monolithic hash table (Crystal, §5.3).
  opat  — fused's column traffic plus per-operator materialization: each
          operator emits a selection vector and re-gathers the live
          columns (row ids + running group id) through it, later
          operators at the reduced cardinality.
  part  — opat's shape with every join radix-partitioned: one partition
          pass over (key, row id, group id) per join, in exchange for
          probes that hit a cache-resident per-partition table; one
          probe launch per join.
  part_loop — the same bytes as part, the probe phase dispatched
          partition at a time from the host (2^bits launches a join).
  sharded — fused with the scan and probes divided over the shards, plus
          the merge of their grids (``_shard_reduce_time``).

Every strategy carries its dispatch cost, launches x
``hw.launch_overhead_s`` (measured by ``repro_torch.sql.calibrate``).
``predict_shared`` prices a wave against its members' solo argmins;
``choose`` is the argmin the ``auto`` strategy runs (``part_loop``, the
one-launch probe's baseline, is predicted but never chosen).

Cardinalities come from the data: predicate selectivities from a strided
sample of the fact column, join selectivities exactly on the dimension
tables.  Column bytes are the encoded widths of a packed table.

The sharded term divides by the shard count as if each shard had a
device of its own.  On one card the S logical shards take turns, so it
predicts ``sharded`` about S times faster than it runs; the reference's
host loop has the same gap, and the port keeps the formula for parity
(PERF.md, ROADMAP.md queue 3).  The reference's tuner, which folds
measured launch shapes and a partition budget into the hardware, is not
in the port yet.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.cost.model import (H100, Hardware, PAPER_CPU,  # noqa: F401
                                    PAPER_GPU, morsel_pipeline_time)
from repro_torch.device import resolve
from repro_torch.sql import morsel as MS
from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql import storage
from repro_torch.sql.hashtable import next_pow2

W = 4                                   # bytes per (dictionary-coded) column
L2_BYTES = H100.cache_size              # the H100's 50 MB L2

# The host CPU the tests run on (the CPU path of every entry point): the
# reference's constants, so both packages price the host alike.
HOST = Hardware("host-cpu", read_bw=12e9, write_bw=8e9, cache_bw=200e9,
                cache_size=32e6, line_bytes=64, mem_capacity=64e9,
                launch_overhead_s=20e-6)

# each partition's hash table should fit the private fast level, well
# under the shared cache: partitions pay off only when probes stop missing
PART_BUDGET_BYTES = 1 << 18             # 256 KB per partition table
MAX_PART_BITS = 8                       # one 8-bit partition pass (§4.4)
SAMPLE_STRIDE_TARGET = 1 << 16          # fact rows sampled for selectivity


def default_hardware(device=None) -> Hardware:
    """The Hardware ``auto`` and the partitioned join's ``part_bits``
    price with on ``device`` (the card unless named): on a card, the H100
    entry with the rates measured there when ``repro_torch.sql.calibrate``
    has them cached (else its published rates), then the tuner's feedback
    when ``repro_torch.sql.tune`` has sweep results cached (the scan rate
    ``select_scan`` reached, the measured partition budget); on the CPU,
    ``HOST``.  Reading the caches is a one-time JSON read each; nothing
    is measured unless asked (the calibrate and tune CLIs, the smoke)."""
    device = resolve(device)
    if device.type != "cuda":
        return HOST
    from repro_torch.sql import calibrate, tune
    return tune.tuned_hardware(
        calibrate.cached_hardware(H100, device) or H100, device)


def ht_bytes(n_build: int) -> float:
    """Bytes of the monolithic table: keys + vals int32, 50 % max fill."""
    return 2.0 * W * next_pow2(max(n_build, 1))


def part_bits(n_build: int, hw: Optional[Hardware] = None) -> int:
    """Radix bits so each partition's table fits the per-partition budget
    (at most PART_BUDGET_BYTES and a quarter of the cache), at least 1:
    the ``part`` strategy always partitions; whether that pays is the
    cost model's question, not a silent fallback.  The execute path asks
    with no ``hw``: the H100's 50 MB L2, a 256 KB budget.  The model asks
    with its ``hw``, as the reference's does (a measured
    ``part_budget_bytes`` overrides the static rule), which gives the
    same bits wherever a quarter of the cache exceeds 256 KB."""
    if hw is not None and hw.part_budget_bytes:
        budget = int(hw.part_budget_bytes)
    else:
        cache = L2_BYTES if hw is None else hw.cache_size
        budget = min(PART_BUDGET_BYTES, int(cache) // 4)
    ratio = ht_bytes(n_build) / max(budget, 1)
    bits = int(np.ceil(np.log2(ratio))) if ratio > 1.0 else 0
    return int(np.clip(bits, 1, MAX_PART_BITS))


# ---------------------------------------------------------------------------
# plan statistics (data-derived cardinalities)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanStats:
    n_fact: int
    pred_sels: tuple            # per fact predicate
    join_sels: tuple            # per join: P(probe hits)
    join_builds: tuple          # per join: filtered build-side rows


def _pred_selectivity(pred, fact: ssb.Table, n: int) -> float:
    # strided samples decode only the touched words
    # (storage.sample_column) — the estimator must not pin a full-column
    # decode of an out-of-core table just to look at 1/64th of the rows
    stride = max(1, n // SAMPLE_STRIDE_TARGET)
    if isinstance(pred, (P.RangePred, P.EqPred, P.InPred)):
        col = storage.sample_column(fact, pred.col, stride)
        sample = ssb.Table(fact.name, {pred.col: col})
    else:                       # callable: needs every column; sample rows
        sample = ssb.Table(fact.name,
                           {c: storage.sample_column(fact, c, stride)
                            for c in fact.columns})
    m = P.pred_mask(pred, sample)
    return float(m.mean()) if m.size else 1.0


# this thread's memo of plan statistics and filtered build counts, set by
# ``stats_memo`` (a server's, for the life of its database)
_SCOPE = threading.local()


@contextmanager
def stats_memo(memo: dict):
    """Memoize this thread's ``plan_stats`` and filtered build-side counts
    in ``memo`` within the block, so pricing a new wave composition only
    combines cached numbers.  Entries are keyed by the identity of the
    plan, its join nodes and the tables they read (and the fact table's
    pending ingest rows), and hold those objects, so an identity is never
    reused while ``memo`` lives; a new table is a new entry."""
    prev = getattr(_SCOPE, "memo", None)
    _SCOPE.memo = memo
    try:
        yield memo
    finally:
        _SCOPE.memo = prev


def _memoized(key: Tuple, hold: Tuple, compute):
    memo = getattr(_SCOPE, "memo", None)
    if memo is None:
        return compute()
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = (hold, compute())
    return hit[1]


def _build_rows(j: P.HashJoin, db: ssb.Database) -> int:
    """Rows of ``j``'s build side that survive its dimension filter."""
    dim: ssb.Table = getattr(db, j.dim)
    return _memoized(("build", id(j), id(dim)), (j, dim),
                     lambda: int(P.pred_mask(j.filter, dim).sum()))


def plan_stats(plan: P.Plan, db: ssb.Database) -> PlanStats:
    fact: ssb.Table = getattr(db, plan.scan.table)
    dims = tuple(getattr(db, j.dim) for j in plan.joins)
    return _memoized(("stats", id(plan), id(fact), fact.n_rows,
                      storage.delta_rows(fact), tuple(map(id, dims))),
                     (plan, fact, dims),
                     lambda: _plan_stats(plan, db, fact))


def _plan_stats(plan: P.Plan, db: ssb.Database,
                fact: ssb.Table) -> PlanStats:
    n = fact.n_rows
    pred_sels = tuple(_pred_selectivity(p, fact, n) for p in plan.filters)
    join_sels, join_builds = [], []
    for j in plan.joins:
        dim: ssb.Table = getattr(db, j.dim)
        n_keep = _build_rows(j, db)
        join_builds.append(n_keep)
        # uniform-FK estimate: P(hit) = surviving dim fraction
        join_sels.append(n_keep / dim.n_rows if dim.n_rows else 0.0)
    return PlanStats(n, pred_sels, tuple(join_sels), tuple(join_builds))


# ---------------------------------------------------------------------------
# per-strategy time model
# ---------------------------------------------------------------------------


def _shard_reduce_time(n_groups: int, n_shards: int, hw: Hardware) -> float:
    """Cost of tree-reducing the per-shard ``(n_groups,)`` partial grids:
    ``ceil(log2 S)`` merge levels, each moving the grid once over the
    interconnect (on one card ``repro_torch.sql.calibrate`` measures the
    host link there; without one, read bandwidth — the host-loop merge
    moves the same bytes through memory) plus one dispatch.  This
    is the term that keeps tiny-output queries from sharding blindly:
    the N x scan win must beat ``log2(N)`` grid transfers."""
    if n_shards <= 1:
        return 0.0
    ici = hw.interconnect_bw or hw.read_bw
    levels = int(np.ceil(np.log2(n_shards)))
    return levels * (n_groups * W / ici + hw.launch_overhead_s)


def _probe_time(n_probe: float, table_bytes: float, hw: Hardware) -> float:
    """§4.3 step function: cache-resident probes run at cache bandwidth;
    larger tables pay a memory line per uncached probe and the cache line
    for the cached fraction (continuous at the boundary — dropping the
    hit term would price a table just past the cache *below* a resident
    one, inverting the model exactly in the crossover regime)."""
    line = hw.line_bytes
    if table_bytes <= hw.cache_size:
        return n_probe * line / hw.cache_bw
    pi = hw.cache_size / table_bytes
    return n_probe * line * (pi / hw.cache_bw + (1 - pi) / hw.read_bw)


def _scan_cols(plan: P.Plan) -> int:
    """Fact columns the query touches once each: predicate columns, join
    FK columns, measure column(s)."""
    proj = plan.project
    n_measure = 0 if proj is None else (1 if proj.m2 is None else 2)
    return len(plan.filters) + len(plan.joins) + n_measure


def _scan_streams(plan: P.Plan):
    """The fact column of every stream a single-query scan loads, in
    stream order (a column serving two roles is two streams, matching
    the kernels' accounting)."""
    cols = []
    for pred in plan.filters:
        cols.append(getattr(pred, "col", None))
    cols.extend(j.fact_col for j in plan.joins)
    proj = plan.project
    if proj is not None:
        cols.append(proj.m1)
        if proj.m2 is not None:
            cols.append(proj.m2)
    return cols


def scan_bytes_per_row(plan: P.Plan, fact) -> float:
    """Bytes one pass moves per fact row across the plan's streams,
    priced at each column's *encoded* width (callable predicates have no
    single column; they are priced at the nominal W)."""
    return sum(W if c is None else storage.scan_bytes_per_row(fact, c)
               for c in _scan_streams(plan))


def scanned_bytes(plan: P.Plan, fact) -> Tuple[int, int]:
    """(encoded, plain) total bytes a full scan of the plan's streams
    moves — the ``QueryResult.bytes_scanned`` report and the
    compression benchmark's bytes-moved ratio."""
    n = fact.n_rows
    return (int(scan_bytes_per_row(plan, fact) * n),
            int(_scan_cols(plan) * W * n))


def _shared_stream_cols(plans):
    """The fact column behind every union stream ONE shared pass over
    the wave loads, plus the deduplicated join nodes — the single owner
    of the wave's stream-byte accounting (``predict_shared`` prices it,
    ``scanned_bytes_shared`` reports it)."""
    from repro_torch.sql.compile import shared_footprint
    col_ix, join_nodes, mcol_ix = shared_footprint(plans)
    cols = (list(col_ix) + [j.fact_col for j in join_nodes]
            + list(mcol_ix))
    return cols, join_nodes


def predict(plan: P.Plan, db: ssb.Database,
            hw: Optional[Hardware] = None,
            n_shards: Optional[int] = None,
            morsel_bytes: Optional[int] = None,
            shard_morsel_bytes: Optional[int] = None) -> Dict[str, float]:
    """Predicted seconds per physical strategy.  ``fused`` is absent when
    the plan is not fusable (the compiler would silently fall back — the
    model scores what would actually run).  ``sharded`` appears when the
    plan is fusable AND ``n_shards > 1``: the fused cost with the scan
    and probes divided across shards, plus the interconnect term for
    tree-reducing the partial group grids
    (:func:`_shard_reduce_time`).

    ``morsel_bytes`` is the executor's streaming budget: the scan term
    becomes the double-buffered morsel pipeline
    (``cost.model.morsel_pipeline_time`` — per-morsel copy overlapped
    with per-morsel compute, per-morsel dispatch overhead), so the model
    prices morsel size and ``auto`` keeps ranking correctly out of
    core.  A budget the whole scan fits in (every in-memory database
    under the default) collapses the pipeline to the original
    single-pass formulas exactly.  ``shard_morsel_bytes`` is the budget
    of ``sharded``'s per-shard folds, ``morsel_bytes`` unless given (on a
    mesh a rank's resident shard is one morsel while the base streams)."""
    from repro_torch.sql.compile import fusability, partability
    hw = hw or default_hardware()
    st = plan_stats(plan, db)
    n = st.n_fact
    rd, wr = hw.read_bw, hw.write_bw

    # one pass over every touched fact column, at encoded widths (every
    # strategy pays this — and on a packed database pays less), streamed
    # through the morsel pipeline
    fact = getattr(db, plan.scan.table)
    bpr = scan_bytes_per_row(plan, fact)
    scan_bytes = bpr * n
    budget = MS.DEFAULT_MORSEL_BYTES if morsel_bytes is None \
        else int(morsel_bytes)
    nm = max(1, len(MS.plan_cuts(n, MS.rows_per_morsel(bpr, budget))))

    def scan_t(total_bytes: float, n_morsels: int,
               launches_per_morsel: int) -> float:
        return morsel_pipeline_time(total_bytes, n_morsels, hw,
                                    launches_per_morsel)

    # running probe-side cardinality after filters, then after each join
    n_after_filters = n * float(np.prod(st.pred_sels)) if st.pred_sels else n

    launch = hw.launch_overhead_s
    n_filters, n_joins = len(st.pred_sels), len(st.join_sels)

    # ---- fused: column scan + full-cardinality probes, no intermediates
    fused_probe = sum(
        _probe_time(n, ht_bytes(b), hw) for b in st.join_builds)
    fused_t = scan_t(scan_bytes, nm, 1) + fused_probe  # one kernel/morsel

    # ---- opat: per-operator selection vector + live-column re-gather,
    # at the running (work-skipped) cardinality; probes against the same
    # monolithic tables but only for surviving rows
    LIVE = 2                    # row ids + running group id
    mat = 0.0
    live = float(n)
    for s in st.pred_sels:      # each Filter predicate materializes, at
        mat += (LIVE + 1) * W * live * (1 / rd + 1 / wr)
        live *= s               # the running (work-skipped) cardinality
    opat_probe = 0.0
    for sel, b in zip(st.join_sels, st.join_builds):
        opat_probe += _probe_time(live, ht_bytes(b), hw)
        mat += (LIVE + 1) * W * live * (1 / rd + 1 / wr)
        live *= sel
    # one dispatch per operator (+ projection/aggregation tail), repeated
    # per morsel — the chain walks every morsel
    opat_t = (scan_t(scan_bytes, nm, n_filters + n_joins + 2)
              + mat + opat_probe)

    # ---- part: opat's shape, joins radix-partitioned — one partition
    # pass over (key, rowid, group) per join, probes cache-resident
    # against the packed per-partition tables, ONE probe launch per join.
    # Build-side work (monolithic or partitioned) is amortized across
    # queries for every strategy (§4.3: builds are noise / served from
    # the HashTableCache), so none of the strategies is charged for it —
    # only the per-query probe-side traffic differs.
    # ---- part_loop: identical bytes, but the probe phase is dispatched
    # partition-at-a-time: 2^bits launches per join plus the host
    # round-trip of the shuffled (key, rowid, group) arrays the loop
    # needs for partition boundaries.
    part_pass = 0.0
    part_probe = 0.0
    loop_overhead = 0.0
    live = n_after_filters
    for sel, b in zip(st.join_sels, st.join_builds):
        bits = part_bits(b, hw)
        per_part = ht_bytes(b) / (1 << bits)
        # histogram read + shuffle read/write of key + LIVE payloads
        part_pass += (1 + LIVE) * W * live * (2 / rd + 1 / wr)
        part_probe += _probe_time(live, per_part, hw)
        # loop path: per-partition dispatches + host materialization of
        # the shuffled probe side (device->host copy at read bandwidth,
        # host-side re-slice at write bandwidth)
        loop_overhead += (1 << bits) * launch
        loop_overhead += (1 + LIVE) * W * live * (1 / rd + 1 / wr)
        live *= sel
    # partition pass + fused probe = 2 launches per join, per morsel
    part_t = (scan_t(scan_bytes, nm, n_filters + 2 * n_joins + 2)
              + mat + part_pass + part_probe)
    part_loop_t = part_t + loop_overhead

    out = {"opat": opat_t}
    if fusability(plan) is None:
        out["fused"] = fused_t
        if n_shards is not None and n_shards > 1:
            s = n_shards
            # per-shard scan + probes run concurrently (wall time is one
            # shard's share, itself morsel-pipelined), then the reduce
            # pays the interconnect
            nm_s = max(1, len(MS.plan_cuts(-(-n // s), MS.rows_per_morsel(
                bpr, budget if shard_morsel_bytes is None
                else int(shard_morsel_bytes)))))
            out["sharded"] = (scan_t(scan_bytes / s, nm_s, 1)
                              + sum(_probe_time(n / s, ht_bytes(b), hw)
                                    for b in st.join_builds)
                              + _shard_reduce_time(plan.n_groups, s, hw))
    if partability(plan) is None:
        out["part"] = part_t
        out["part_loop"] = part_loop_t
    return out


def predict_shared(plans, db: ssb.Database,
                   hw: Optional[Hardware] = None,
                   n_shards: Optional[int] = None,
                   morsel_bytes: Optional[int] = None) -> Dict[str, float]:
    """Shared-wave vs solo cost of a scan-compatible group of fusable
    aggregate plans: ``{"shared": s, "solo": s}`` predicted seconds —
    plus ``shared_sharded`` when ``n_shards > 1``: the same wave with
    its one streamed pass divided across the fact shards (per-shard
    launches — the wave runs whole on each shard — plus the
    interconnect reduce of the stacked partial grids).

    ``shared`` prices ONE streamed pass over the wave's *union* of fact
    columns (fact bytes read once per wave), one probe stream per
    deduplicated dim hash table (two members sharing a build side share
    the probe), and the per-*unique*-member output payload writes — the
    reference's query server dedups identical members
    (``compile.shared_member_key``) before executing, so duplicates add no
    stacked slot and no payload; plus a single kernel dispatch.  ``solo``
    is the alternative: Σ over ALL members (duplicates included — solo
    execution repeats them) of the cost model's per-plan argmin
    (``choose``).  The shared pass pays whenever ``shared < solo``."""
    from repro_torch.sql.compile import shareability, shared_member_key
    hw = hw or default_hardware()
    if not plans:
        raise ValueError("predict_shared needs at least one plan")
    table = plans[0].scan.table
    fact: ssb.Table = getattr(db, table)
    n = fact.n_rows
    for plan in plans:
        if plan.scan.table != table:
            raise ValueError(f"{plan.name}: shared wave is "
                             "scan-incompatible")
        reason = shareability(plan)
        if reason is not None:
            raise ValueError(f"{plan.name}: {reason}")
    # the wave as executed: one stacked slot per unique member
    uniq, seen = [], set()
    for plan in plans:
        try:
            k = shared_member_key(plan)
        except (ValueError, TypeError, KeyError, AttributeError):
            k = id(plan)                # unfingerprintable: no dedup
        if k not in seen:
            seen.add(k)
            uniq.append(plan)
    # the union streams the kernel actually loads (same accounting as
    # the solo fused model's _scan_cols: a column that is both predicate
    # and measure is two streams, each deduplicated within its role) —
    # each stream priced at the column's encoded width
    cols, join_nodes = _shared_stream_cols(uniq)
    stream_bpr = sum(storage.scan_bytes_per_row(fact, c) for c in cols)
    budget = MS.DEFAULT_MORSEL_BYTES if morsel_bytes is None \
        else int(morsel_bytes)
    nm = max(1, len(MS.plan_cuts(n, MS.rows_per_morsel(stream_bpr,
                                                       budget))))
    builds = [_build_rows(j, db) for j in join_nodes]
    out_payload = float(sum(plan.n_groups * W for plan in uniq))
    shared_t = (morsel_pipeline_time(stream_bpr * n, nm, hw, 1)
                + sum(_probe_time(n, ht_bytes(b), hw) for b in builds)
                + out_payload / hw.write_bw)
    solo_t = sum(choose(plan, db, hw, n_shards=n_shards,
                        morsel_bytes=morsel_bytes).predicted_s
                 for plan in plans)
    out = {"shared": shared_t, "solo": solo_t}
    if n_shards is not None and n_shards > 1:
        s = n_shards
        red_groups = sum(plan.n_groups for plan in uniq)
        nm_s = max(1, len(MS.plan_cuts(
            -(-n // s), MS.rows_per_morsel(stream_bpr, budget))))
        out["shared_sharded"] = (
            # per-shard scan pipeline (shards scan concurrently; the
            # dispatch overhead — one wave launch per morsel per shard —
            # is serial on the host loop)
            morsel_pipeline_time(stream_bpr * n / s, nm_s, hw, 0)
            + s * nm_s * hw.launch_overhead_s
            + sum(_probe_time(n / s, ht_bytes(b), hw) for b in builds)
            + out_payload / hw.write_bw
            + _shard_reduce_time(red_groups, s, hw))
    return out


def predict_marginal(plans, db: ssb.Database,
                     hw: Optional[Hardware] = None,
                     n_shards: Optional[int] = None,
                     morsel_bytes: Optional[float] = None,
                     candidate: Optional[P.Plan] = None
                     ) -> Dict[str, float]:
    """Marginal economics of one more member riding an open wave — the
    serving loop's hold-or-dispatch predicate.

    ``plans`` is the wave as currently formed; ``candidate`` the next
    arrival it might wait for (default: the last member, the best
    stand-in for a self-similar workload).  Returns:

    * ``shared`` — predicted seconds of the wave as formed;
    * ``shared_plus`` — the wave with the candidate aboard;
    * ``marginal_cost`` — what admitting the candidate adds to every
      member's wave time (``max(shared_plus - shared, 0)``; a duplicate
      of an existing member dedups away and costs nothing);
    * ``solo`` — the candidate's per-plan argmin (``choose``), the scan
      it would otherwise pay alone;
    * ``gain`` — ``solo - marginal_cost``: the shared-scan saving that
      must pay for the wave's added queueing delay.  The wave former
      holds the wave open only while ``gain`` exceeds the expected wait
      it imposes on the members already aboard."""
    if not plans:
        raise ValueError("predict_marginal needs at least one plan")
    hw = hw or default_hardware()
    cand = plans[-1] if candidate is None else candidate
    base = predict_shared(plans, db, hw, n_shards=n_shards,
                          morsel_bytes=morsel_bytes)["shared"]
    plus = predict_shared(list(plans) + [cand], db, hw, n_shards=n_shards,
                          morsel_bytes=morsel_bytes)["shared"]
    solo = choose(cand, db, hw, n_shards=n_shards,
                  morsel_bytes=morsel_bytes).predicted_s
    marginal = max(plus - base, 0.0)
    return {"shared": base, "shared_plus": plus,
            "marginal_cost": marginal, "solo": solo,
            "gain": solo - marginal}


def scanned_bytes_shared(plans, fact) -> Tuple[int, int]:
    """(encoded, plain) bytes ONE shared pass over the wave's union
    streams moves — the per-member ``bytes_scanned`` report for shared
    executions (the wave is the unit of scan traffic)."""
    cols, _ = _shared_stream_cols(plans)
    n = fact.n_rows
    per_row = sum(storage.scan_bytes_per_row(fact, c) for c in cols)
    return int(per_row * n), int(len(cols) * W * n)


@dataclass(frozen=True)
class Choice:
    strategy: str
    predictions: Dict[str, float]

    @property
    def predicted_s(self) -> float:
        return self.predictions[self.strategy]


# deterministic tie-break: prefer the simpler lowering (ties go to the
# solo fused pass before the shards)
_PREFERENCE = ("fused", "opat", "part", "part_loop", "sharded")

# strategies auto may execute: part_loop is the fused kernel's A/B
# baseline, predicted (for the Fig. 8 ranking) but never chosen; sharded
# only enters predict's vector when the caller reports n_shards > 1
_CANDIDATES = ("fused", "opat", "part", "sharded")


def choose(plan: P.Plan, db: ssb.Database,
           hw: Optional[Hardware] = None,
           n_shards: Optional[int] = None,
           morsel_bytes: Optional[int] = None,
           shard_morsel_bytes: Optional[int] = None) -> Choice:
    """The ``auto`` strategy's decision: argmin of ``predict`` over the
    executable candidates (the ``part_loop`` baseline is excluded).
    ``n_shards`` is the shard count the caller could run sharded at
    (``shard.shard_count(db)``); ``morsel_bytes`` the streaming budget
    the executor will fold under (``shard_morsel_bytes`` that of a
    shard's fold, :func:`predict`) — the single- vs multi-device
    arbitration happens right here, per query, priced at the morsel
    pipeline that would actually run."""
    preds = predict(plan, db, hw, n_shards=n_shards,
                    morsel_bytes=morsel_bytes,
                    shard_morsel_bytes=shard_morsel_bytes)
    best = min((s for s in preds if s in _CANDIDATES),
               key=lambda s: (preds[s], _PREFERENCE.index(s)))
    return Choice(best, preds)
