"""Plan compiler: lower a logical plan to a physical strategy.

The port of ``repro.sql.compile``.  Five strategies lower so far:

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
            by the key (``radix_sort``: one launch counts the digits of
            its four 8-bit passes, then one one-sweep launch for each
            pass whose rows do not all share one bucket).
``part``  — opat with every join radix-partitioned (paper §4.4, Fig. 8):
            the live rows' keys, row ids and group ids move in one
            partition pass by the key's low ``part_bits`` bits
            (``histogram``, then a one-sweep ``partition_multi`` by
            its column sums), then one
            ``part_probe`` launch probes every partition against its own
            table of the packed ``(P, S)`` layout.
``part_loop`` — the same partition pass, then one ``probe_join`` per
            non-empty partition from a host loop (the one-launch probe's
            baseline).
``shared`` — a wave of aggregate plans over one fact table in ONE
            launch of the hand-written CUDA kernel
            ``kernels/csrc/multi_fused.cu``: the union of the members'
            columns is read once, each distinct build side probed once,
            and only the predicates, group ids and sums fan out by member
            (``execute_shared``); ``compile_plan(plan, "shared")`` is a
            one-member wave.

Every strategy folds over the morsel stream (``repro_torch.sql.morsel``;
``execute(..., morsel_bytes=)`` bounds a buffer): a fact table on the
host is cut into morsels whose uploads overlap the previous morsel's
kernels, and the per-morsel partials merge exactly — the fused and wave
kernels add into one int64 grid passed through every morsel, opat's
``group_sum`` into one f64 grid, and each is rounded to f32 once at the
end; a row plan concatenates its survivors as global row ids and sorts
them once.  So any cut is bit-identical to the whole-table pass.  A
table of one morsel — every test database under the default budget, and
a fact table made resident with ``Database.to`` — runs whole.
``sharded`` and ``auto`` raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels import ssb_fused
from repro_torch.sql import faults
from repro_torch.sql import hashtable as HT
from repro_torch.sql import model as M
from repro_torch.sql import morsel as MS
from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql import storage as ST

STRATEGIES = ("fused", "opat", "part", "part_loop", "shared", "sharded",
              "auto")

# where each strategy the reference has lands in the port (ROADMAP.md,
# "Open items", queue 1)
_NOT_PORTED = {
    "sharded": "queue 1, item 10 (sharding)",
    "auto": "queue 1, item 11 (cost model, calibration, tuner)",
}
# the radix width of ORDER BY's passes; the reference's tuner picks it
# (``tune.tuned_r``, ROADMAP queue 1 item 11), whose default is 8
SORT_BITS = 8
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_MEASURE_OP_CODE = {"first": 0, "mul": 1, "sub": 2}


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


def _spja_reason(plan: P.Plan) -> Optional[str]:
    """None if the plan is an SPJA aggregate chain with range-expressible
    fact predicates and a measure op the kernels take (the reference's
    ``fusability``), else the reason it is not."""
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
    return None


def fusability(plan: P.Plan) -> Optional[str]:
    """None if the plan can lower to the fused SPJA kernel, else the
    human-readable reason it cannot.  Raises (via classify) on malformed
    chains — an invalid plan is an error, not a fallback."""
    reason = _spja_reason(plan)
    if reason is not None:
        return reason
    n_preds, n_joins = len(plan.filters), len(plan.joins)
    if n_preds > ssb_fused.MAX_PREDS or n_joins > ssb_fused.MAX_JOINS:
        # the port's one departure from the reference, whose kernel takes
        # any count (ROADMAP.md queue 3): same result, other strategy
        return (f"{n_preds} predicates and {n_joins} joins: the fused "
                f"kernel takes at most {ssb_fused.MAX_PREDS} and "
                f"{ssb_fused.MAX_JOINS}")
    return None


def shareability(plan: P.Plan) -> Optional[str]:
    """None if the plan can join a shared-scan wave, else the reason.  A
    shareable plan is an SPJA aggregate chain the fused kernel's rules
    accept; the wave kernel reads its shapes at run time, so the solo
    kernel's 8 + 8 slots do not apply.  Group-level compatibility (every
    member scanning the same fact table) is ``validate_wave``'s."""
    return _spja_reason(plan)


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


def _join_tables(db, join: P.HashJoin, cache: Optional[HT.HashTableCache],
                 device: torch.device):
    """A join's (htk, htv) on ``device``: from the cache, else built."""
    return (cache.get_or_build(db, join, device) if cache is not None
            else HT.build_dim_table(db, join, device))


def fused_inputs(plan: P.Plan, db: ssb.Database,
                 cache: Optional[HT.HashTableCache], device: torch.device,
                 fact=None, prebuilt: Optional[List[torch.Tensor]] = None
                 ) -> Tuple[tuple, dict]:
    """The ``spja`` call one fused pass over ``fact`` (the plan's fact
    table by default; the morsel fold passes each cut) makes: (positional
    args, keyword args), with the fact columns and the hash tables on
    ``device``.  ``prebuilt``: the flat ``[htk, htv, ...]`` tables when
    the caller fetched them once.  ``chip_smoke.py`` times the kernel on
    exactly these."""
    if fact is None:
        fact = getattr(db, plan.scan.table)
    bounds = plan.preds           # fusability guarantees the range view
    pred_streams = [ST.column_stream(fact, c, device) for c, _, _ in bounds]
    joins = plan.joins
    key_streams = [ST.column_stream(fact, j.fact_col, device)
                   for j in joins]
    join_tables: List[torch.Tensor] = []
    if prebuilt is not None:
        join_tables = list(prebuilt)
    else:
        for j in joins:
            join_tables.extend(_join_tables(db, j, cache, device))
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
                   cache: Optional[HT.HashTableCache], device: torch.device,
                   fact, prebuilt: List[torch.Tensor],
                   acc: torch.Tensor) -> torch.Tensor:
    """One fused SPJA pass over ``fact`` (a morsel), its exact sums
    added to the int64 grid ``acc``."""
    args, kw = fused_inputs(plan, db, cache, device, fact=fact,
                            prebuilt=prebuilt)
    faults.maybe_fault("kernel")
    return ops.spja(*args, mode=mode, acc=acc, **kw)


def _fused_scan_cols(plan: P.Plan) -> List[str]:
    """The fact columns one fused pass streams (deduplicated in load
    order) — the morsel budget is sized over exactly these."""
    cols: List[str] = []
    for c, _, _ in plan.preds:
        if c not in cols:
            cols.append(c)
    for j in plan.joins:
        if j.fact_col not in cols:
            cols.append(j.fact_col)
    proj = plan.project
    for c in ([proj.m1] if proj.op not in ("mul", "sub")
              else [proj.m1, proj.m2]):
        if c not in cols:
            cols.append(c)
    return cols


def _fused_morsels(plan: P.Plan, db: ssb.Database, mode: str,
                   cache: Optional[HT.HashTableCache], morsel_bytes: int,
                   device: torch.device
                   ) -> Tuple[np.ndarray, MS.MorselReport]:
    """The fused lowering as a fold over the morsel stream: the dim
    tables are fetched once, each morsel runs the fused kernel adding
    into one int64 grid, which is rounded to f32 once at the end — so
    any cut is bit-identical to the whole-table pass."""
    fact = getattr(db, plan.scan.table)
    stream = MS.MorselStream(fact, morsel_bytes, cols=_fused_scan_cols(plan),
                             device=device)
    report = MS.MorselReport()
    prebuilt: List[torch.Tensor] = []
    for j in plan.joins:
        prebuilt.extend(_join_tables(db, j, cache, device))
    acc = torch.zeros((plan.n_groups,), dtype=torch.int64, device=device)
    if stream.n_morsels == 0:       # empty fact table: zero groups
        report.observe(0)
    stream.fold(lambda m: _execute_fused(plan, db, mode, cache, device,
                                         m.table, prebuilt, acc), report)
    return acc.to(torch.float32).cpu().numpy(), report


# ---------------------------------------------------------------------------
# shared-scan group lowering (one fused pass per wave)
# ---------------------------------------------------------------------------


def shared_join_key(join: P.HashJoin) -> Tuple:
    """Probe identity of a join inside a shared wave: the fact FK column
    plus the logical build side.  Two members whose joins agree on both
    share ONE probe stream (their ``mult``s may differ — the multiplier
    is per-member data)."""
    return (join.fact_col, HT.join_cache_key(join))


def shared_member_key(plan: P.Plan) -> Tuple:
    """Structural execution identity of a shareable member: two plans
    with equal keys lower to equal rows of the stacked wave parameters
    (predicates sorted — bound intersection is commutative; joins by
    probe identity and mult, in chain order).  The plan must be
    shareable (``plan.preds`` needs range-expressible predicates)."""
    proj = plan.project
    return (plan.scan.table,
            tuple(sorted(plan.preds)),
            tuple((shared_join_key(j), j.mult) for j in plan.joins),
            (proj.m1, proj.m2, proj.op),
            plan.n_groups)


def shared_footprint(plans: List[P.Plan]):
    """The union streams of a shared wave, as the kernel loads them:
    predicate columns (deduplicated by name), joins (deduplicated by
    :func:`shared_join_key`: two build sides on one fact FK are two probe
    streams), measure columns (deduplicated by name; a column that is
    both predicate and measure is two streams, as in the solo kernel).
    Returns ``(col_ix, join_nodes, mcol_ix)``: ordered name -> index maps
    for predicate and measure columns and the deduplicated joins."""
    col_ix: Dict[str, int] = {}
    join_ix: Dict[Tuple, int] = {}
    join_nodes: List[P.HashJoin] = []
    mcol_ix: Dict[str, int] = {}
    for plan in plans:
        for col, _, _ in plan.preds:
            col_ix.setdefault(col, len(col_ix))
        for j in plan.joins:
            k = shared_join_key(j)
            if k not in join_ix:
                join_ix[k] = len(join_nodes)
                join_nodes.append(j)
        proj = plan.project
        mcol_ix.setdefault(proj.m1, len(mcol_ix))
        if proj.m2 is not None:
            mcol_ix.setdefault(proj.m2, len(mcol_ix))
    return col_ix, join_nodes, mcol_ix


def _wave_streams(foot: List[P.Plan], anchored: bool):
    """:func:`shared_footprint` in the order the wave loads its streams:
    sorted (joins by ``repr(shared_join_key)``) under an anchor, so any
    member subset of the pool lowers to the same streams."""
    col_ix, join_nodes, mcol_ix = shared_footprint(foot)
    if anchored:
        col_ix = {c: i for i, c in enumerate(sorted(col_ix))}
        join_nodes = sorted(join_nodes,
                            key=lambda j: repr(shared_join_key(j)))
        mcol_ix = {c: i for i, c in enumerate(sorted(mcol_ix))}
    return col_ix, join_nodes, mcol_ix


def _hit_rate(db: ssb.Database, join: P.HashJoin,
              cache: Optional[HT.HashTableCache]) -> float:
    """The share of a join's dimension rows its build side keeps."""
    held = cache.get_build_count(db, join) if cache is not None else \
        len(HT.filtered_build_side(db, join)[0])
    return held / max(getattr(db, join.dim).n_rows, 1)


def probe_groups(join_nodes: List[P.HashJoin], db: ssb.Database,
                 cache: Optional[HT.HashTableCache],
                 tables: Dict[Tuple, Tuple], device: torch.device
                 ) -> Tuple[Tuple[Tuple[int, ...], Optional[Tuple]], ...]:
    """The wave's probe groups, the ``probe_groups`` of ``multi_spja``:
    the join streams that probe one fact key column against one
    dimension key (up to ``HT.MERGE_STREAMS`` of them) are one group,
    probed once a row through their merged table (``HT.build_merged``,
    from ``cache`` when given); a group of one stream probes its own
    table.  ``tables`` maps :func:`shared_join_key` to each stream's own
    ``(htk, htv)``.  Groups run in ascending order of the lowest hit
    rate among their streams (keys held over dimension rows), ties by
    ``repr(shared_join_key)``: a function of the build sides alone, so
    any member subset of an anchored pool lowers to the same groups in
    the same order."""
    by_key: Dict[Tuple, List[int]] = {}
    for ji, j in enumerate(join_nodes):
        by_key.setdefault((j.fact_col, j.dim, j.key_col), []).append(ji)
    groups = [streams[lo:lo + HT.MERGE_STREAMS]
              for streams in by_key.values()
              for lo in range(0, len(streams), HT.MERGE_STREAMS)]
    groups.sort(key=lambda g: (
        min(_hit_rate(db, join_nodes[ji], cache) for ji in g),
        min(repr(shared_join_key(join_nodes[ji])) for ji in g)))
    out = []
    for g in groups:
        if len(g) == 1:
            out.append((tuple(g), None))
            continue
        joins = [join_nodes[ji] for ji in g]
        own = [tables[shared_join_key(j)] for j in joins]
        merged = (cache.get_or_build_merged(db, joins, own, device)
                  if cache is not None else HT.merged_table(own, device))
        out.append((tuple(g), merged))
    return tuple(out)


def validate_wave(plans: List[P.Plan]) -> None:
    """Raise ``ValueError`` unless ``plans`` form a legal shared wave:
    non-empty, all scanning the same fact table, every member
    shareable."""
    if not plans:
        raise ValueError("shared wave must contain at least one plan")
    table = plans[0].scan.table
    for plan in plans:
        if plan.scan.table != table:
            raise ValueError(
                f"shared wave is scan-incompatible: {plan.name} scans "
                f"{plan.scan.table!r}, wave scans {table!r}")
        reason = shareability(plan)
        if reason is not None:
            raise ValueError(f"{plan.name} cannot join a shared wave: "
                             f"{reason}")


def shared_params(plans: List[P.Plan], db: ssb.Database,
                  cache: Optional[HT.HashTableCache] = None,
                  pad_to: Optional[int] = None,
                  prebuilt: Optional[Dict[Tuple, Tuple]] = None,
                  fact=None, anchor: Optional[List[P.Plan]] = None,
                  device=None, groups=None):
    """Lower a group of shareable plans over one fact table to the
    arguments of ``ops.multi_spja`` -> ``(fact, args, kwargs, n_groups)``.

    The stacked member parameters are host int32 arrays, equal to the
    reference's: bounds (Q, C, 2) intersected in the original domain,
    then shifted by each packed column's reference and clipped to int32;
    mults and use (Q, J), a member's mults summed where it joins one
    build side twice; valid (Q,); selectors (Q, 3).  The streams are the
    resident fact columns on ``device`` (the card unless named), the
    measures as their int32 columns or packed words (the kernel sums
    exactly in int64, so no f32 copy is made), and the tables on
    ``device``.  ``kwargs`` holds the stream encodings, ``n_rows`` and
    ``member_groups`` (each member's ``n_groups``, 0 for padding: where
    the kernel takes the sums, never their bits).

    ``pad_to`` pads the member dimension with inert slots (valid 0).
    ``anchor`` widens the footprint to a plan pool without adding
    members: its columns get all-pass bounds and its joins use = mult = 0,
    and the streams are sorted (joins by ``repr(shared_join_key)``) so any
    member subset lowers to the same stream order.  ``prebuilt`` maps
    :func:`shared_join_key` to an already built ``(htk, htv)`` pair,
    which is not fetched again.  ``kwargs["probe_groups"]`` is the
    kernel's lowering of the joins (:func:`probe_groups`: one probe a
    row for the streams of one fact key column and dimension key);
    ``groups`` passes it in when the caller lowered it once."""
    validate_wave(plans)
    device = resolve(device)
    if fact is None:
        fact = getattr(db, plans[0].scan.table)
    q_n = len(plans)
    q_pad = max(q_n, pad_to or q_n)
    foot = list(plans) + list(anchor or [])
    col_ix, join_nodes, mcol_ix = _wave_streams(foot, bool(anchor))
    join_ix = {shared_join_key(j): ji for ji, j in enumerate(join_nodes)}

    bounds = np.empty((q_pad, len(col_ix), 2), np.int64)
    bounds[..., 0] = _INT32_MIN
    bounds[..., 1] = _INT32_MAX
    for qi, plan in enumerate(plans):
        for col, lo, hi in plan.preds:
            ci = col_ix[col]
            bounds[qi, ci, 0] = max(bounds[qi, ci, 0], lo)
            bounds[qi, ci, 1] = min(bounds[qi, ci, 1], hi)
    for col, ci in col_ix.items():
        enc = ST.encoding_of(fact, col)
        if enc is not None and enc.kind != "plain":
            bounds[:, ci, :] -= enc.ref
    bounds = np.clip(bounds, _INT32_MIN, _INT32_MAX).astype(np.int32)

    mults = np.zeros((q_pad, len(join_nodes)), np.int32)
    use = np.zeros((q_pad, len(join_nodes)), np.int32)
    for qi, plan in enumerate(plans):
        for j in plan.joins:
            ji = join_ix[shared_join_key(j)]
            use[qi, ji] = 1
            mults[qi, ji] += j.mult
    key_streams = [ST.column_stream(fact, j.fact_col, device)
                   for j in join_nodes]
    tables = _shared_prebuilt(foot, db, cache, prebuilt, device)
    join_tables = [t for j in join_nodes for t in tables[shared_join_key(j)]]
    if groups is None:
        groups = probe_groups(join_nodes, db, cache, tables, device)

    msel = np.zeros((q_pad, 3), np.int32)
    for qi, plan in enumerate(plans):
        proj = plan.project
        msel[qi, 0] = mcol_ix[proj.m1]
        if proj.m2 is not None:
            msel[qi, 1] = mcol_ix[proj.m2]
        msel[qi, 2] = _MEASURE_OP_CODE[proj.op]
    m_streams = [ST.column_stream(fact, c, device) for c in mcol_ix]

    q_valid = np.zeros(q_pad, np.int32)
    q_valid[:q_n] = 1
    member_groups = np.zeros(q_pad, np.int64)
    member_groups[:q_n] = [plan.n_groups for plan in plans]
    n_groups = max(plan.n_groups for plan in foot)
    pred_streams = [ST.column_stream(fact, c, device) for c in col_ix]
    args = ([s[0] for s in pred_streams], bounds, [s[0] for s in key_streams],
            join_tables, mults, use, q_valid, [s[0] for s in m_streams],
            msel)
    kwargs = dict(pred_widths=tuple(s[1] for s in pred_streams),
                  key_widths=tuple(s[1] for s in key_streams),
                  key_refs=np.array([s[2] for s in key_streams], np.int32),
                  m_widths=tuple(s[1] for s in m_streams),
                  m_refs=np.array([s[2] for s in m_streams], np.int32),
                  n_rows=fact.n_rows, member_groups=member_groups,
                  probe_groups=groups)
    return fact, args, kwargs, n_groups


def anchor_for(plans: List[P.Plan],
               pool: Optional[List[P.Plan]]) -> Optional[List[P.Plan]]:
    """The plans of a footprint-anchor pool that could share this wave's
    scan (same fact table, shareable), or None when none does (the
    unanchored path)."""
    if not pool:
        return None
    table = plans[0].scan.table
    kept = [p for p in pool
            if p.scan.table == table and shareability(p) is None]
    return kept or None


def _shared_prebuilt(plans: List[P.Plan], db,
                     cache: Optional[HT.HashTableCache],
                     prebuilt: Optional[Dict[Tuple, Tuple]],
                     device: torch.device) -> Dict[Tuple, Tuple]:
    """A wave's join tables, one build (or cache fetch) per distinct probe
    identity, keeping whatever the caller prebuilt."""
    _, join_nodes, _ = shared_footprint(plans)
    tables = dict(prebuilt) if prebuilt else {}
    for j in join_nodes:
        k = shared_join_key(j)
        if k not in tables:
            tables[k] = _join_tables(db, j, cache, device)
    return tables


def execute_shared_morsels(plans: List[P.Plan], db: ssb.Database,
                           mode: str = "auto",
                           cache: Optional[HT.HashTableCache] = None,
                           pad_to: Optional[int] = None,
                           prebuilt: Optional[Dict[Tuple, Tuple]] = None,
                           morsel_bytes: int = MS.DEFAULT_MORSEL_BYTES,
                           anchor: Optional[List[P.Plan]] = None,
                           device=None
                           ) -> Tuple[List[np.ndarray], MS.MorselReport]:
    """A shared wave as a fold over the morsel stream on ``device`` (the
    card unless named): one ``multi_spja`` launch a morsel, each adding
    into one (Q, n_groups) int64 grid rounded to f32 once at the end, the
    tables built (or fetched from ``cache``) once per distinct build side.
    Returns ``(results, report)``, each member's ``(n_groups,)`` f32
    result in submission order.  ``pad_to`` and ``anchor`` as
    :func:`shared_params`."""
    validate_wave(plans)
    device = resolve(device)
    anchor = anchor_for(plans, anchor)
    foot = list(plans) + list(anchor or [])
    col_ix, join_nodes, mcol_ix = _wave_streams(foot, bool(anchor))
    tables = _shared_prebuilt(foot, db, cache, prebuilt, device)
    groups = probe_groups(join_nodes, db, cache, tables, device)
    # each fact column once, however many build sides probe it
    cols = [*col_ix, *(j.fact_col for j in join_nodes), *mcol_ix]
    stream = MS.MorselStream(getattr(db, plans[0].scan.table), morsel_bytes,
                             cols=cols, device=device)
    report = MS.MorselReport()
    acc = torch.zeros((max(len(plans), pad_to or len(plans)),
                       max(plan.n_groups for plan in foot)),
                      dtype=torch.int64, device=device)
    if stream.n_morsels == 0:           # empty fact: all-zero grids
        report.observe(0)

    def run(m):
        _, args, kwargs, n_groups = shared_params(
            plans, db, pad_to=pad_to, prebuilt=tables, fact=m.table,
            anchor=anchor, device=device, groups=groups)
        faults.maybe_fault("kernel")
        return ops.multi_spja(*args, n_groups=n_groups, mode=mode, acc=acc,
                              **kwargs)

    stream.fold(run, report)
    out = acc.to(torch.float32).cpu().numpy()
    return [out[qi, :plan.n_groups].copy()
            for qi, plan in enumerate(plans)], report


def execute_shared(plans: List[P.Plan], db: ssb.Database,
                   mode: str = "auto",
                   cache: Optional[HT.HashTableCache] = None,
                   pad_to: Optional[int] = None,
                   prebuilt: Optional[Dict[Tuple, Tuple]] = None,
                   device=None) -> List[np.ndarray]:
    """Execute a scan-compatible group of aggregate plans as one shared
    pass per morsel over their fact table on ``device`` (the card unless
    named) -> each member's ``(n_groups,)`` f32 result, in submission
    order.  A resident fact table, or one of a single morsel, is ONE
    ``multi_spja`` launch.  ``pad_to`` pads the member dimension with
    inert slots; the tables are built (or fetched from ``cache``) once
    per distinct build side."""
    results, _ = execute_shared_morsels(plans, db, mode=mode, cache=cache,
                                        pad_to=pad_to, prebuilt=prebuilt,
                                        device=device)
    return results


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
    htk, htv = _join_tables(db, node, cache, device)
    keys = ST.take(fact, node.fact_col, rowids, device)
    faults.maybe_fault("kernel")
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
                   device: torch.device, join_mode: str = "opat",
                   fact=None, defer_order: bool = False,
                   acc: Optional[torch.Tensor] = None):
    """Walk the chain one operator at a time over ``fact`` (the plan's
    fact table by default, a morsel in the fold) -> (n_groups,) f32 for
    an aggregate plan, the surviving row ids (int32) for a row plan: in
    row order, or in the key's order after a trailing ``OrderBy``.
    ``join_mode`` picks the HashJoin lowering: one probe of the whole
    table (``opat``), the partitioned one-launch probe (``part``) or the
    host partition loop (``part_loop``); every other operator is the
    same.  The morsel fold's hooks: ``acc`` (an f64 grid) takes an
    aggregate's unrounded sums and is returned; ``defer_order`` skips a
    trailing ``OrderBy`` (the fold sorts the survivors of every morsel
    once)."""
    join_fn = _JOIN_LOWERINGS[join_mode]
    if fact is None:
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
            if acc is not None:
                return acc if empty else ops.group_sum(
                    group, measure, node.n_groups, mode=mode, acc=acc)
            if empty:
                return np.zeros(node.n_groups, np.float32)
            return ops.group_sum(group, measure, node.n_groups,
                                 mode=mode).cpu().numpy()
        elif isinstance(node, P.OrderBy):
            if empty or defer_order:
                break
            keys = ST.take(fact, node.key_col, rowids, device)
            _, rowids = ops.radix_sort(keys, rowids, mode=mode, r=SORT_BITS)
        else:
            raise TypeError(f"{plan.name}: cannot lower node {node!r}")
    # only row plans (classify()-checked at compile time) fall through
    return rowids.cpu().numpy()


def _chain_scan_cols(plan: P.Plan) -> Optional[List[str]]:
    """The fact columns a chain lowering touches, or None when a generic
    predicate hides its column set (then the morsel budget is sized over
    the whole row — conservative, never under-counts)."""
    cols: List[str] = []

    def add(c):
        if c is not None and c not in cols:
            cols.append(c)

    for node in plan.chain[1:]:
        if isinstance(node, P.Filter):
            for pred in node.preds:
                col = getattr(pred, "col", None)
                if col is None:
                    return None
                add(col)
        elif isinstance(node, P.HashJoin):
            add(node.fact_col)
        elif isinstance(node, P.Project):
            add(node.m1)
            add(node.m2)
        elif isinstance(node, P.OrderBy):
            add(node.key_col)
    return cols


def _chain_morsels(plan: P.Plan, db: ssb.Database, mode: str,
                   cache: Optional[HT.HashTableCache], join_mode: str,
                   morsel_bytes: int, device: torch.device
                   ) -> Tuple[np.ndarray, MS.MorselReport]:
    """The materializing lowerings (opat/part/part_loop) as a fold over
    the morsel stream.  An aggregate plan adds each morsel's group sums,
    unrounded, into one f64 grid rounded to f32 once; a row plan
    concatenates each morsel's survivors as global row ids, and a
    trailing ``OrderBy`` becomes ONE stable sort of them all (the chain
    keeps row order, so this is the whole-table sort).  A one-morsel
    stream takes the whole-table chain."""
    fact = getattr(db, plan.scan.table)
    stream = MS.MorselStream(fact, morsel_bytes,
                             cols=_chain_scan_cols(plan), device=device)
    report = MS.MorselReport()
    if stream.n_morsels <= 1:
        if stream.n_morsels == 0:
            report.observe(0)
            return _execute_chain(plan, db, mode, cache, device, join_mode,
                                  fact=fact), report
        return stream.fold(
            lambda m: _execute_chain(plan, db, mode, cache, device,
                                     join_mode, fact=m.table),
            report)[0], report
    if classify(plan) == "agg":
        acc = torch.zeros((plan.n_groups,), dtype=torch.float64,
                          device=device)
        stream.fold(lambda m: _execute_chain(plan, db, mode, cache, device,
                                             join_mode, fact=m.table,
                                             acc=acc), report)
        return acc.to(torch.float32).cpu().numpy(), report
    order_node = next((nd for nd in plan.chain
                       if isinstance(nd, P.OrderBy)), None)

    def run(m):
        rows = torch.from_numpy(_execute_chain(
            plan, db, mode, cache, device, join_mode, fact=m.table,
            defer_order=True)).to(device)
        keys = (ST.take(m.table, order_node.key_col, rows, device)
                if order_node is not None and rows.numel() else None)
        return rows + m.offset, keys

    pieces = stream.fold(run, report)
    rowids = torch.cat([p[0] for p in pieces])
    if order_node is None or rowids.numel() == 0:
        return rowids.cpu().numpy(), report
    keys = torch.cat([p[1] for p in pieces if p[1] is not None])
    _, rowids = ops.radix_sort(keys, rowids, mode=mode, r=SORT_BITS)
    return rowids.cpu().numpy(), report


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
    says why, as in the reference (``shared`` on a plan no wave can take
    falls back the same way).  After ``execute``, ``decided`` holds the
    strategy that ran."""
    plan: P.Plan
    strategy: str
    requested: str
    fallback_reason: Optional[str] = None
    decided: Optional[str] = None
    # the last execute's stream: its morsels and the double-buffer peak
    # (the encoded bytes of two adjacent morsels' scanned columns)
    n_morsels: Optional[int] = None
    peak_resident_bytes: Optional[int] = None

    def execute(self, db: ssb.Database, mode: str = "auto",
                cache: Optional[HT.HashTableCache] = None,
                device=None,
                morsel_bytes: int = MS.DEFAULT_MORSEL_BYTES) -> np.ndarray:
        """Run the plan on ``device`` (the current card when None; the
        CPU only when named), a morsel of at most ``morsel_bytes`` of
        scanned columns at a time -> (n_groups,) f32 numpy array, or the
        surviving row ids of a row plan."""
        device = resolve(device)
        self.decided = self.strategy
        if self.strategy == "fused":
            out, report = _fused_morsels(self.plan, db, mode, cache,
                                         morsel_bytes, device)
        elif self.strategy == "shared":     # a one-member wave
            results, report = execute_shared_morsels(
                [self.plan], db, mode=mode, cache=cache,
                morsel_bytes=morsel_bytes, device=device)
            out = results[0]
        else:
            out, report = _chain_morsels(self.plan, db, mode, cache,
                                         self.strategy, morsel_bytes, device)
        self.n_morsels = report.n_morsels
        self.peak_resident_bytes = report.peak_resident_bytes
        return out


def compile_plan(plan: P.Plan, strategy: str = "fused") -> CompiledQuery:
    """Validate + lower ``plan``.  ``strategy``:

    * ``fused`` — the single-kernel lowering; falls back to ``opat``
      (with ``fallback_reason`` set) when the plan is not fusable;
    * ``opat``  — operator-at-a-time;
    * ``part``  — radix-partitioned joins, one probe launch per join;
      falls back to ``opat`` (reason set) when nothing is partitionable;
    * ``part_loop`` — radix-partitioned joins probed partition at a time
      from the host; the same fallback rule;
    * ``shared`` — a one-member shared-scan wave; falls back to ``opat``
      (reason set) when the plan cannot join a wave.

    ``sharded`` and ``auto`` raise ``NotImplementedError`` naming the
    ROADMAP item that brings them."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    classify(plan)                      # raise on malformed chains
    if strategy in _NOT_PORTED:
        raise _not_ported(strategy)
    if strategy == "opat":
        return CompiledQuery(plan, "opat", "opat")
    reason = {"fused": fusability, "shared": shareability}.get(
        strategy, partability)(plan)
    if reason is None:
        return CompiledQuery(plan, strategy, strategy)
    return CompiledQuery(plan, "opat", strategy, fallback_reason=reason)
