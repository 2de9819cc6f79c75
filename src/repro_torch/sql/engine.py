"""SSB query engine facade over the logical-plan IR.

The port of ``repro.sql.engine``: the 13 SSB queries built through the
plan builder, the fused-lowering wrapper, and the independent numpy
oracle, copied so the port answers to the same ground truth.

  ``ssb_queries()``       -> Dict[str, Plan]
  ``run_query(db, plan)``  -> fused (Crystal) lowering on the card, or
                             another ``strategy`` (opat, part, part_loop,
                             shared, sharded, auto)
  ``order_by(table, col)`` -> the table's columns sorted by one column
                             (the LSB radix sort, §4.4)
  ``run_query_oracle``    -> independent pure-numpy plan interpreter
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql.compile import compile_plan
from repro_torch.sql.hashtable import (EMPTY, HashTableCache,
                                       build_dim_table, next_pow2, np_build,
                                       np_hash)
from repro_torch.sql.plan import (AffineExpr, ColExpr, EqPred, FlagExpr,
                                  InPred, Plan, QueryBuilder, RangePred)
from repro_torch.sql.ssb import Database, datekey

__all__ = [
    "EMPTY", "np_hash", "np_build", "next_pow2", "HashTableCache",
    "ssb_queries", "run_query", "order_by", "run_query_oracle",
    "build_join_tables",
    "Plan", "QueryBuilder",
]


# ---------------------------------------------------------------------------
# the 13 SSB queries, built through the plan IR
# ---------------------------------------------------------------------------


def _date_join(b: QueryBuilder, payload: P.Expr, mult: int,
               years: Optional[Sequence[int]] = None) -> QueryBuilder:
    return b.hash_join(
        "lo_orderdate", "date", "d_datekey",
        dim_filter=None if years is None else InPred("d_year", tuple(years)),
        payload=payload, mult=mult)


def ssb_queries() -> Dict[str, Plan]:
    q: Dict[str, Plan] = {}
    dk = datekey
    d_year0 = AffineExpr("d_year", 1, -1992)

    # --- flight 1: pure selection, SUM(extendedprice * discount) ---
    def flight1(name, date_lo, date_hi, disc, qty):
        return (QueryBuilder(name).scan("lineorder")
                .where_range("lo_orderdate", date_lo, date_hi)
                .where_range("lo_discount", *disc)
                .where_range("lo_quantity", *qty)
                .measure("lo_extendedprice", "lo_discount", "mul")
                .group_by(1).build())

    q["q1.1"] = flight1("q1.1", dk(1993), dk(1994) - 1, (1, 3), (1, 24))
    q["q1.2"] = flight1("q1.2", dk(1994, 0), dk(1994, 30), (4, 6), (26, 35))
    q["q1.3"] = flight1("q1.3", dk(1994, 35), dk(1994, 41), (5, 7), (26, 35))

    # --- flight 2: part x supplier x date, group (d_year, p_brand1) ---
    def flight2(name, part_filter, s_region):
        b = (QueryBuilder(name).scan("lineorder")
             .hash_join("lo_suppkey", "supplier", "s_suppkey",
                        dim_filter=EqPred("s_region", s_region))
             .hash_join("lo_partkey", "part", "p_partkey",
                        dim_filter=part_filter,
                        payload=ColExpr("p_brand1"), mult=1))
        return (_date_join(b, d_year0, 1000)
                .measure("lo_revenue").group_by(7000).build())

    q["q2.1"] = flight2("q2.1", EqPred("p_category", 1), ssb.AMERICA)
    q["q2.2"] = flight2("q2.2", RangePred("p_brand1", 260, 267), ssb.ASIA)
    q["q2.3"] = flight2("q2.3", EqPred("p_brand1", 260), ssb.EUROPE)

    # --- flight 3: customer x supplier x date, group (c_x, s_x, d_year) ---
    def flight3(name, c_filter, c_payload, s_filter, s_payload, cdim,
                years, date_days=None):
        n_years = 6
        b = QueryBuilder(name).scan("lineorder")
        if date_days is not None:
            b = b.where_range("lo_orderdate", *date_days)
        b = (b.hash_join("lo_custkey", "customer", "c_custkey",
                         dim_filter=c_filter, payload=c_payload,
                         mult=cdim * n_years)
             .hash_join("lo_suppkey", "supplier", "s_suppkey",
                        dim_filter=s_filter, payload=s_payload,
                        mult=n_years))
        return (_date_join(b, d_year0, 1, years=years)
                .measure("lo_revenue")
                .group_by(cdim * cdim * n_years).build())

    years_92_97 = (1992, 1993, 1994, 1995, 1996, 1997)
    q["q3.1"] = flight3(
        "q3.1",
        EqPred("c_region", ssb.ASIA), AffineExpr("c_nation", 1, -10),
        EqPred("s_region", ssb.ASIA), AffineExpr("s_nation", 1, -10),
        5, years_92_97)
    q["q3.2"] = flight3(
        "q3.2",
        EqPred("c_nation", ssb.NATION_US),
        AffineExpr("c_city", 1, -ssb.NATION_US * 10),
        EqPred("s_nation", ssb.NATION_US),
        AffineExpr("s_city", 1, -ssb.NATION_US * 10),
        10, years_92_97)
    two_cities = (ssb.CITY_UKI1, ssb.CITY_UKI5)
    uki5_flag = FlagExpr(EqPred("c_city", ssb.CITY_UKI5))
    s_uki5_flag = FlagExpr(EqPred("s_city", ssb.CITY_UKI5))
    q["q3.3"] = flight3(
        "q3.3",
        InPred("c_city", two_cities), uki5_flag,
        InPred("s_city", two_cities), s_uki5_flag,
        2, years_92_97)
    q["q3.4"] = flight3(
        "q3.4",
        InPred("c_city", two_cities), uki5_flag,
        InPred("s_city", two_cities), s_uki5_flag,
        2, years_92_97, date_days=(dk(1997, 11 * 31), dk(1997, 364)))

    # --- flight 4: profit queries, SUM(revenue - supplycost) ---
    q["q4.1"] = (
        QueryBuilder("q4.1").scan("lineorder")
        .hash_join("lo_custkey", "customer", "c_custkey",
                   dim_filter=EqPred("c_region", ssb.AMERICA),
                   payload=AffineExpr("c_nation", 1, -5), mult=7)
        .hash_join("lo_suppkey", "supplier", "s_suppkey",
                   dim_filter=EqPred("s_region", ssb.AMERICA))
        .hash_join("lo_partkey", "part", "p_partkey",
                   dim_filter=RangePred("p_mfgr", 0, 1))
        .hash_join("lo_orderdate", "date", "d_datekey",
                   payload=d_year0, mult=1)
        .measure("lo_revenue", "lo_supplycost", "sub")
        .group_by(35).build())
    q["q4.2"] = (
        QueryBuilder("q4.2").scan("lineorder")
        .hash_join("lo_custkey", "customer", "c_custkey",
                   dim_filter=EqPred("c_region", ssb.AMERICA))
        .hash_join("lo_suppkey", "supplier", "s_suppkey",
                   dim_filter=EqPred("s_region", ssb.AMERICA),
                   payload=AffineExpr("s_nation", 1, -5), mult=10)
        .hash_join("lo_partkey", "part", "p_partkey",
                   dim_filter=RangePred("p_mfgr", 0, 1),
                   payload=ColExpr("p_category"), mult=1)
        .hash_join("lo_orderdate", "date", "d_datekey",
                   dim_filter=InPred("d_year", (1997, 1998)),
                   payload=AffineExpr("d_year", 1, -1997), mult=50)
        .measure("lo_revenue", "lo_supplycost", "sub")
        .group_by(100).build())
    q["q4.3"] = (
        QueryBuilder("q4.3").scan("lineorder")
        .hash_join("lo_custkey", "customer", "c_custkey",
                   dim_filter=EqPred("c_region", ssb.AMERICA))
        .hash_join("lo_suppkey", "supplier", "s_suppkey",
                   dim_filter=EqPred("s_nation", ssb.NATION_US),
                   payload=AffineExpr("s_city", 1, -ssb.NATION_US * 10),
                   mult=40)
        .hash_join("lo_partkey", "part", "p_partkey",
                   dim_filter=EqPred("p_category", 3),
                   payload=AffineExpr("p_brand1", 1, -120), mult=1)
        .hash_join("lo_orderdate", "date", "d_datekey",
                   dim_filter=InPred("d_year", (1997, 1998)),
                   payload=AffineExpr("d_year", 1, -1997), mult=400)
        .measure("lo_revenue", "lo_supplycost", "sub")
        .group_by(800).build())
    return q


def ssb_narrowed_variants(qs: Optional[Dict[str, Plan]] = None
                          ) -> Dict[str, Tuple[str, Plan]]:
    """Narrowed SSB variants: each differs from its parent query only
    by a *strictly stronger* filter on one group-key join — the shapes
    the result cache (``repro_torch.sql.result_cache``) can answer from the
    parent's cached grid by predicate subsumption.  Returns
    ``{variant_name: (parent_name, plan)}``; the serving benchmark and
    the subsumption-soundness tests drive both from this one list."""
    import copy
    if qs is None:
        qs = ssb_queries()

    def narrowed(name, parent, join_ix, new_filter):
        v = copy.deepcopy(qs[parent])
        v.name = name
        v.joins[join_ix].filter = new_filter
        return name, (parent, v)

    return dict([
        # q2.1's date join is unfiltered (TruePred) -> any year range
        narrowed("q2.1n", "q2.1", 2, RangePred("d_year", 1993, 1996)),
        # q2.2 brands 260..267 -> inner slice
        narrowed("q2.2n", "q2.2", 1, RangePred("p_brand1", 261, 265)),
        # q3.1 years 1992..1997 -> two of them
        narrowed("q3.1n", "q3.1", 2, InPred("d_year", (1994, 1995))),
        # q3.3 customer cities {UKI1, UKI5} -> just UKI5 (flag payload)
        narrowed("q3.3n", "q3.3", 0, EqPred("c_city", ssb.CITY_UKI5)),
        # q4.1's date join is unfiltered (all years) -> a 3-year slice.
        # (q4.2 is NOT usable here: its s_region build side is empty at
        # the small scale factors the tests/benchmarks run, so its grid
        # layout never decomposes and narrowing it can only miss.)
        narrowed("q4.1n", "q4.1", 3, RangePred("d_year", 1993, 1995)),
    ])


# ---------------------------------------------------------------------------
# execution wrappers
# ---------------------------------------------------------------------------


def build_join_tables(db: Database, plan: Plan, device=None):
    """Build (filtered) dim hash tables for a plan's joins on ``device``
    (flat [htk0, htv0, htk1, htv1, ...])."""
    tables = []
    for j in plan.joins:
        tables.extend(build_dim_table(db, j, device))
    return tables


def run_query(db, plan: Plan, mode: str = "auto",
              cache: Optional[HashTableCache] = None,
              device=None, strategy: str = "fused") -> np.ndarray:
    """Execute through ``strategy``'s lowering (the Crystal fused SPJA
    kernel by default; any of ``compile.STRATEGIES``: ``sharded`` on a
    ``shard.ShardedDatabase`` runs the fused kernel per shard, ``auto``
    lets the cost model pick) on ``device`` (the card unless the caller
    names the CPU) -> (n_groups,) f32."""
    return compile_plan(plan, strategy).execute(db, mode=mode, cache=cache,
                                                device=device)


def order_by(table, key_col: str, mode: str = "auto",
             device=None) -> Dict[str, np.ndarray]:
    """ORDER BY via the paper's §4.4 LSB radix sort (stable), on
    ``device`` (the card unless the caller names the CPU): the table's
    columns reordered on the host by ``key_col`` ascending, as the key's
    unsigned 32-bit words.  Lowers a Scan -> OrderBy row plan
    operator-at-a-time."""
    plan = (QueryBuilder(f"orderby_{table.name}_{key_col}")
            .scan(table.name).order_by(key_col).build())
    shim = SimpleNamespace(**{table.name: table})
    perm = compile_plan(plan, "opat").execute(shim, mode=mode,
                                              device=device)
    return {c: np.asarray(v)[perm] for c, v in table.columns.items()}


def _live(table, col: str, rows: np.ndarray) -> np.ndarray:
    """``col`` at the live ``rows`` (ascending): the column itself while
    every row lives."""
    values = np.asarray(table[col])
    return values if rows.size == values.size else values[rows]


def run_query_oracle(db: Database, plan: Plan) -> np.ndarray:
    """Independent pure-numpy plan interpreter (mask + np.add.at) — the
    correctness ground truth (aggregate plans only).  Each join looks up
    only the rows every earlier step kept, in row order, so the sums are
    added in the same order, to the same bits, as over the whole table."""
    if plan.project is None or plan.group is None:
        raise ValueError(
            f"{plan.name}: the oracle interprets aggregate plans "
            "(Project + GroupAgg) only")
    lo = getattr(db, plan.scan.table)
    n = lo.n_rows
    mask = np.ones(n, bool)
    for pred in plan.filters:
        mask &= P.pred_mask(pred, lo)
    rows = np.flatnonzero(mask)         # the live rows, ascending
    group = np.zeros(rows.size, np.int64)
    for j in plan.joins:
        dim: ssb.Table = getattr(db, j.dim)
        dmask = P.pred_mask(j.filter, dim)
        keys = np.asarray(dim[j.key_col])
        if keys.size == 0 or not dmask.any():
            rows = rows[:0]             # empty build side: every probe misses
            group = group[:0]
            continue
        payload = P.expr_values(j.payload, dim).astype(np.int64)
        # offset-based lut over the surviving key range: negative dim
        # keys index correctly and can be matched by negative fact FKs,
        # like the real hash build
        kmin = int(keys[dmask].min())
        size = int(keys[dmask].max()) - kmin + 1
        lut = np.full(size, -1, np.int64)
        # reversed assignment: on duplicate dim keys the FIRST matching row
        # wins, matching the linear-probe build
        sel = np.flatnonzero(dmask)[::-1]
        lut[keys[sel].astype(np.int64) - kmin] = payload[sel]
        # a fact FK outside the dim key range is a probe miss
        idx = _live(lo, j.fact_col, rows).astype(np.int64) - kmin
        in_range = (idx >= 0) & (idx < size)
        pv = np.where(in_range, lut[np.clip(idx, 0, size - 1)], -1)
        hit = pv >= 0
        rows = rows[hit]
        group = group[hit] + pv[hit] * j.mult
    proj = plan.project
    m = _live(lo, proj.m1, rows).astype(np.float64)
    if proj.op == "mul":
        m = m * _live(lo, proj.m2, rows)
    elif proj.op == "sub":
        m = m - _live(lo, proj.m2, rows)
    out = np.zeros(plan.n_groups, np.float64)
    np.add.at(out, group, m)
    return out.astype(np.float32)
