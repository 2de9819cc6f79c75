"""Plan compiler: lower a logical plan to a physical strategy.

The port of ``repro.sql.compile``.  Four strategies lower so far:

``fused`` — collapse the whole SPJA subtree into one launch of the
            hand-written CUDA kernel ``kernels/csrc/ssb_fused.cu`` (the
            paper's Crystal model, §5.3: zero intermediate
            materialization, one pass over the fact table in device
            memory).  The fact columns are resident on the device
            (``ssb.Table.on_device``, ``storage.PackedTable.on_device``):
            a query sends no fact bytes over PCIe, and the measures go to
            the kernel as their int32 columns or packed word streams,
            with no per-query f32 copy.
``opat``  — operator-at-a-time: every Filter predicate, HashJoin,
            Project and GroupAgg is its own kernel launch
            (``select_scan``, ``probe_join``, ``project``, ``group_sum``)
            and re-materializes the live row ids, group ids and gathered
            columns in device memory between operators — the
            materializing engine fig17 compares fused against.  It is
            also where a plan the fused kernel cannot express runs.  On a
            packed fact table the leading range filter selects straight
            off the word stream (``select_scan_packed``).  A row plan's
            trailing ``OrderBy`` is an LSB radix sort of the survivors
            by the key (``radix_sort``: four 8-bit histogram + scatter
            passes).
``part``  — opat with every join radix-partitioned (paper §4.4, Fig. 8):
            the live rows' keys, row ids and group ids move in one
            partition pass by the key's low ``part_bits`` bits
            (``histogram`` + ``partition_multi``), then one
            ``part_probe`` launch probes every partition against its own
            table of the packed ``(P, S)`` layout.
``part_loop`` — the same partition pass, then one ``probe_join`` per
            non-empty partition from a host loop (the one-launch probe's
            baseline).

``execute`` runs the whole table in one pass — the reference's path when
the fact table is one morsel.  ``shared``, ``sharded`` and ``auto`` raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels import ssb_fused
from repro_torch.sql import hashtable as HT
from repro_torch.sql import model as M
from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql import storage as ST

STRATEGIES = ("fused", "opat", "part", "part_loop", "shared", "sharded",
              "auto")

# where each strategy the reference has lands in the port (ROADMAP.md,
# "Open items", queue 1)
_NOT_PORTED = {
    "shared": "queue 1, item 8 (shared-scan waves)",
    "sharded": "queue 1, item 10 (sharding)",
    "auto": "queue 1, item 11 (cost model, calibration, tuner)",
}
# the radix width of ORDER BY's passes; the reference's tuner picks it
# (``tune.tuned_r``, ROADMAP queue 1 item 11), whose default is 8
SORT_BITS = 8


def _not_ported(strategy: str) -> NotImplementedError:
    return NotImplementedError(
        f"strategy {strategy!r} is not in repro_torch yet; it comes with "
        f"ROADMAP.md {_NOT_PORTED[strategy]}")


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def classify(plan: P.Plan) -> str:
    """Check chain well-formedness; return result kind: "agg" | "rows".

    Aggregate plans:  Scan [Filter|HashJoin]* Project GroupAgg
    Row plans:        Scan [Filter|HashJoin]* [OrderBy]
    """
    chain = plan.chain
    if not isinstance(chain[0], P.Scan):
        raise ValueError(f"{plan.name}: chain must start with Scan")
    i = 1
    while i < len(chain) and isinstance(chain[i], (P.Filter, P.HashJoin)):
        i += 1
    rest = chain[i:]
    kinds = tuple(type(n).__name__ for n in rest)
    if kinds == ("Project", "GroupAgg"):
        return "agg"
    if kinds in ((), ("OrderBy",)):
        return "rows"
    raise ValueError(
        f"{plan.name}: unsupported chain tail {kinds} — expected "
        "Project+GroupAgg (aggregate) or optional OrderBy (row plan)")


def fusability(plan: P.Plan) -> Optional[str]:
    """None if the plan can lower to the fused SPJA kernel, else the
    human-readable reason it cannot.  Raises (via classify) on malformed
    chains — an invalid plan is an error, not a fallback."""
    kind = classify(plan)
    if kind != "agg":
        return ("row-returning plan (no Project+GroupAgg root): the fused "
                "kernel only produces per-group aggregates")
    for pred in plan.filters:
        if not isinstance(pred, (P.RangePred, P.EqPred)):
            return (f"fact predicate {pred!r} is not a range predicate; "
                    "the fused kernel evaluates SMEM-resident (lo, hi) "
                    "bounds only")
    if plan.project.op not in ("first", "mul", "sub"):
        return f"measure op {plan.project.op!r} not supported by the kernel"
    n_preds, n_joins = len(plan.filters), len(plan.joins)
    if n_preds > ssb_fused.MAX_PREDS or n_joins > ssb_fused.MAX_JOINS:
        # the port's one departure from the reference, whose kernel takes
        # any count (ROADMAP.md queue 3): same result, other strategy
        return (f"{n_preds} predicates and {n_joins} joins: the fused "
                f"kernel takes at most {ssb_fused.MAX_PREDS} and "
                f"{ssb_fused.MAX_JOINS}")
    return None


def partability(plan: P.Plan) -> Optional[str]:
    """None if the plan takes the radix-partitioned join lowering
    (``part`` and ``part_loop`` alike), else the reason it lowers
    operator-at-a-time instead."""
    kind = classify(plan)
    if kind != "agg":
        return ("row-returning plan: partition-at-a-time probes reorder "
                "surviving rows, so row plans lower operator-at-a-time")
    if not plan.joins:
        return "no joins to partition; plan lowers operator-at-a-time"
    return None


# ---------------------------------------------------------------------------
# fused lowering (Crystal model)
# ---------------------------------------------------------------------------


def _rewritten_bounds(fact, bounds) -> np.ndarray:
    """(n_preds, 2) int32 predicate bounds in each column's encoded
    domain (the identity on plain columns)."""
    out = np.empty((len(bounds), 2), np.int32)
    for p, (col, lo, hi) in enumerate(bounds):
        out[p] = ST.encoded_bounds(ST.encoding_of(fact, col), lo, hi)
    return out


def _measure_streams(fact, proj: P.Project, device: torch.device):
    """The measure inputs as the kernel consumes them: the resident int32
    column or packed word stream (the kernel sums exactly in int64, so no
    f32 copy is made).  Returns (m1, m2, m_widths, m_refs).  Stream count
    follows the measure *op*: an m2 on an op="first" projection is never
    loaded."""
    streams = [ST.column_stream(fact, c, device)
               for c in ([proj.m1] if proj.op not in ("mul", "sub")
                         else [proj.m1, proj.m2])]
    m2 = streams[1][0] if len(streams) == 2 else None
    return (streams[0][0], m2, tuple(w for _, w, _ in streams),
            np.array([r for _, _, r in streams], np.int32))


def fused_inputs(plan: P.Plan, db: ssb.Database,
                 cache: Optional[HT.HashTableCache], device: torch.device
                 ) -> Tuple[tuple, dict]:
    """The ``spja`` call one fused pass over the plan's fact table makes:
    (positional args, keyword args), with the resident fact columns and
    the hash tables on ``device``.  ``chip_smoke.py`` times the kernel on
    exactly these."""
    fact = getattr(db, plan.scan.table)
    bounds = plan.preds           # fusability guarantees the range view
    pred_streams = [ST.column_stream(fact, c, device) for c, _, _ in bounds]
    joins = plan.joins
    key_streams = [ST.column_stream(fact, j.fact_col, device)
                   for j in joins]
    join_tables: List[torch.Tensor] = []
    for j in joins:
        htk, htv = (cache.get_or_build(db, j, device) if cache is not None
                    else HT.build_dim_table(db, j, device))
        join_tables.extend([htk, htv])
    mults = np.array([j.mult for j in joins], np.int32)
    proj = plan.project
    m1, m2, m_widths, m_refs = _measure_streams(fact, proj, device)
    return (([s[0] for s in pred_streams], _rewritten_bounds(fact, bounds),
             [s[0] for s in key_streams], join_tables, mults, m1, m2),
            dict(measure_op=proj.op, n_groups=plan.n_groups,
                 pred_widths=tuple(s[1] for s in pred_streams),
                 key_widths=tuple(s[1] for s in key_streams),
                 key_refs=np.array([s[2] for s in key_streams], np.int32),
                 m_widths=m_widths, m_refs=m_refs, n_rows=fact.n_rows))


def _execute_fused(plan: P.Plan, db: ssb.Database, mode: str,
                   cache: Optional[HT.HashTableCache],
                   device: torch.device) -> np.ndarray:
    """One fused SPJA pass over the plan's fact table -> (n_groups,) f32
    on the host."""
    args, kw = fused_inputs(plan, db, cache, device)
    return ops.spja(*args, mode=mode, **kw).cpu().numpy()


# ---------------------------------------------------------------------------
# operator-at-a-time lowering (materializing engine model)
# ---------------------------------------------------------------------------


def _positions(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _probe_whole(node: P.HashJoin, fact, db: ssb.Database,
                 rowids: torch.Tensor, group: torch.Tensor, mode: str,
                 cache: Optional[HT.HashTableCache], device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """opat join: one probe of the whole dim table; matched positions come
    back as a selection vector and the live columns are gathered through
    it."""
    htk, htv = (cache.get_or_build(db, node, device) if cache is not None
                else HT.build_dim_table(db, node, device))
    keys = ST.take(fact, node.fact_col, rowids, device)
    payload, sel, cnt = ops.probe_join(
        keys, _positions(rowids.shape[0], device), htk, htv, mode=mode)
    cnt = int(cnt)
    sel = sel[:cnt]
    return rowids[sel], group[sel] + payload[:cnt] * node.mult


def _part_bits_of(node: P.HashJoin, db: ssb.Database,
                  cache: Optional[HT.HashTableCache]
                  ) -> Tuple[int, Optional[tuple]]:
    """Radix bits of one join's partitioned lowering, and the filtered
    build side when it had to be computed (no cache given)."""
    if cache is not None:
        return M.part_bits(cache.get_build_count(db, node)), None
    side = HT.filtered_build_side(db, node)
    return M.part_bits(len(side[0])), side


def _probe_part_fused(node: P.HashJoin, fact, db: ssb.Database,
                      rowids: torch.Tensor, group: torch.Tensor, mode: str,
                      cache: Optional[HT.HashTableCache],
                      device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """part join: one partition pass of the live rows' keys with their
    row ids and group ids, then ONE probe launch over every partition
    against the packed ``(P, S)`` tables (``ops.part_join``); surviving
    rows come back partition-major.  One host sync: the match count."""
    bits, side = _part_bits_of(node, db, cache)
    packed = (cache.get_or_build_parts(db, node, bits, packed=True,
                                       device=device)
              if cache is not None else
              HT.build_dim_partitions(db, node, bits, side=side, packed=True,
                                      device=device))
    col, width, colref = ST.column_stream(fact, node.fact_col, device)
    outr, outg, cnt = ops.part_join(col, rowids, group, packed.htk,
                                    packed.htv, node.mult, bits, mode=mode,
                                    width=width, ref=colref)
    cnt = int(cnt)
    return outr[:cnt], outg[:cnt]


def _probe_part_loop(node: P.HashJoin, fact, db: ssb.Database,
                     rowids: torch.Tensor, group: torch.Tensor, mode: str,
                     cache: Optional[HT.HashTableCache],
                     device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """part join, probed partition-at-a-time from the host (strategy
    ``part_loop``, the one-launch probe's baseline): the same partition
    pass as ``part``, then one ``probe_join`` per non-empty partition
    against that partition's own table.  Partitions are probed at their
    own length (the reference pads each to a power of two for XLA's
    trace cache); surviving rows come back partition-major."""
    bits, side = _part_bits_of(node, db, cache)
    parts = (cache.get_or_build_parts(db, node, bits, device=device)
             if cache is not None else
             HT.build_dim_partitions(db, node, bits, side=side,
                                     device=device))
    keys = ST.take(fact, node.fact_col, rowids, device)
    hist = ops.radix_histogram(keys, 0, bits, mode=mode)
    outk, (orow, ogrp) = ops.radix_partition_multi(
        keys, (rowids, group), 0, bits, mode=mode, hist=hist)
    # partition boundaries: the column sums of the pass's histogram
    counts = hist.sum(0).cpu().numpy()
    ends = np.cumsum(counts)
    out_rows, out_grps = [], []
    for p in range(1 << bits):
        s, e = int(ends[p] - counts[p]), int(ends[p])
        if s == e:
            continue
        htk, htv = parts[p]
        payload, sel, cnt = ops.probe_join(
            outk[s:e], _positions(e - s, device), htk, htv, mode=mode)
        cnt = int(cnt)
        if cnt:
            sel = sel[:cnt]
            out_rows.append(orow[s:e][sel])
            out_grps.append(ogrp[s:e][sel] + payload[:cnt] * node.mult)
    if not out_rows:
        z = torch.zeros((0,), dtype=torch.int32, device=device)
        return z, z
    return torch.cat(out_rows), torch.cat(out_grps)


_JOIN_LOWERINGS = {
    "opat": _probe_whole,
    "part": _probe_part_fused,
    "part_loop": _probe_part_loop,
}


def _execute_chain(plan: P.Plan, db: ssb.Database, mode: str,
                   cache: Optional[HT.HashTableCache],
                   device: torch.device, join_mode: str = "opat"
                   ) -> np.ndarray:
    """Walk the chain one operator at a time over the whole fact table ->
    (n_groups,) f32 for an aggregate plan, the surviving row ids (int32)
    for a row plan: in row order, or in the key's order after a trailing
    ``OrderBy``.  ``join_mode`` picks the HashJoin lowering: one probe of
    the whole table (``opat``), the partitioned one-launch probe
    (``part``) or the host partition loop (``part_loop``); every other
    operator is the same."""
    join_fn = _JOIN_LOWERINGS[join_mode]
    fact = getattr(db, plan.scan.table)
    n = fact.n_rows
    # live intermediate state, re-materialized by every operator:
    rowids = _positions(n, device)
    group = torch.zeros((n,), dtype=torch.int32, device=device)
    measure = None
    dense = True        # rowids still the identity: the leading filter
    #   on a packed column selects straight off the word stream
    for node in plan.chain[1:]:
        empty = rowids.shape[0] == 0
        if isinstance(node, P.Filter):
            for pred in node.preds:
                if rowids.shape[0] == 0:
                    break
                if isinstance(pred, (P.RangePred, P.EqPred)):
                    col, lo, hi = P.range_bounds(pred)
                    enc = ST.encoding_of(fact, col)
                    if dense and enc is not None and enc.kind != "plain":
                        # decode-on-scan over the packed words, bounds in
                        # the encoded domain; the output IS the surviving
                        # row ids (identity rowids: value == position)
                        lo2, hi2 = ST.encoded_bounds(enc, lo, hi)
                        words, phys, _ = ST.column_stream(fact, col, device)
                        out, cnt = ops.select_scan_packed(
                            words, rowids, lo2, hi2, phys, mode=mode)
                        rowids = out[:int(cnt)]
                        group = group[rowids]
                        dense = False
                        continue
                    x = ST.take(fact, col, rowids, device)
                    # emit a selection vector, then gather each live
                    # column through it — the materialization traffic
                    # the fused path avoids
                    sel, cnt = ops.select_scan(
                        x, _positions(rowids.shape[0], device), lo, hi,
                        mode=mode)
                    sel = sel[:int(cnt)]
                else:                       # generic predicate: host mask
                    sel = torch.from_numpy(
                        P.pred_mask(pred, fact)).to(device)[rowids]
                rowids, group = rowids[sel], group[sel]
                dense = False
        elif isinstance(node, P.HashJoin):
            dense = False
            if not empty:
                rowids, group = join_fn(node, fact, db, rowids, group, mode,
                                        cache, device)
        elif isinstance(node, P.Project):
            m = ST.take(fact, node.m1, rowids, device).to(torch.float32)
            if node.op == "mul":
                m = m * ST.take(fact, node.m2, rowids, device).to(
                    torch.float32)
            elif node.op == "sub":
                m2 = ST.take(fact, node.m2, rowids, device).to(torch.float32)
                m = m if empty else ops.project(m, m2, 1.0, -1.0, mode=mode)
            measure = m
        elif isinstance(node, P.GroupAgg):
            if empty:
                return np.zeros(node.n_groups, np.float32)
            return ops.group_sum(group, measure, node.n_groups,
                                 mode=mode).cpu().numpy()
        elif isinstance(node, P.OrderBy):
            if empty:
                break
            keys = ST.take(fact, node.key_col, rowids, device)
            _, rowids = ops.radix_sort(keys, rowids, mode=mode, r=SORT_BITS)
        else:
            raise TypeError(f"{plan.name}: cannot lower node {node!r}")
    # only row plans (classify()-checked at compile time) fall through
    return rowids.cpu().numpy()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@dataclass
class CompiledQuery:
    """An executable lowering of a logical plan.

    ``strategy`` is the strategy that runs; ``requested`` what the caller
    asked for.  When the caller asked for ``fused`` on a plan the fused
    kernel cannot express, or for ``part``/``part_loop`` on a plan with
    nothing to partition, ``strategy == "opat"`` and ``fallback_reason``
    says why, as in the reference.  After ``execute``, ``decided`` holds
    the strategy that ran."""
    plan: P.Plan
    strategy: str
    requested: str
    fallback_reason: Optional[str] = None
    decided: Optional[str] = None

    def execute(self, db: ssb.Database, mode: str = "auto",
                cache: Optional[HT.HashTableCache] = None,
                device=None) -> np.ndarray:
        """Run the plan on ``device`` (the current card when None; the
        CPU only when named) -> (n_groups,) f32 numpy array, or the
        surviving row ids of a row plan."""
        device = resolve(device)
        self.decided = self.strategy
        if self.strategy == "fused":
            return _execute_fused(self.plan, db, mode, cache, device)
        return _execute_chain(self.plan, db, mode, cache, device,
                              join_mode=self.strategy)


def compile_plan(plan: P.Plan, strategy: str = "fused") -> CompiledQuery:
    """Validate + lower ``plan``.  ``strategy``:

    * ``fused`` — the single-kernel lowering; falls back to ``opat``
      (with ``fallback_reason`` set) when the plan is not fusable;
    * ``opat``  — operator-at-a-time;
    * ``part``  — radix-partitioned joins, one probe launch per join;
      falls back to ``opat`` (reason set) when nothing is partitionable;
    * ``part_loop`` — radix-partitioned joins probed partition at a time
      from the host; the same fallback rule.

    ``shared``, ``sharded`` and ``auto`` raise ``NotImplementedError``
    naming the ROADMAP item that brings them."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    classify(plan)                      # raise on malformed chains
    if strategy in _NOT_PORTED:
        raise _not_ported(strategy)
    if strategy == "opat":
        return CompiledQuery(plan, "opat", "opat")
    reason = fusability(plan) if strategy == "fused" else partability(plan)
    if reason is None:
        return CompiledQuery(plan, strategy, strategy)
    return CompiledQuery(plan, "opat", strategy, fallback_reason=reason)
