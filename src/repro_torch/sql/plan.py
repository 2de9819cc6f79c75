"""Logical query-plan IR for select-project-join-aggregate queries.

The PyTorch port's own copy of ``repro.sql.plan`` (numpy only): both
packages build structurally equal plans, so their fingerprints — and the
hash-table cache keys derived from them — agree.

The paper's headline result (25x full-query GPU speedup, §5) hinges on a
*physical* choice — fuse the whole SPJA pipeline into one kernel (Crystal)
vs. materialize intermediates between operators (CPU engines).  To express
and compare that choice, queries are built here as *logical* plans that are
independent of the lowering; ``repro_torch.sql.compile`` owns the physical
strategies (``fused`` / ``opat``).

Plan shape (linear chains; the build sides of joins hang off the chain):

  Scan(fact) -> Filter(preds) -> HashJoin* -> Project(measure) ->
      GroupAgg(n_groups)

Row-returning plans (no aggregate) are also valid — e.g. Scan -> OrderBy
is the paper's §4.4 sort, and Scan -> Filter is a selection scan.
OrderBy is row-plan only (it yields a row permutation; aggregate output
is already laid out by group id).

Expressions are tiny, hashable (frozen) dataclasses so a query server can
fingerprint the build side of a join and cache the built hash table across
queries.  Raw callables ``table -> ndarray`` are accepted anywhere an
expression is, as an escape hatch (uncacheable, unfusable-on-fact, but
handy in tests).

Group keys follow the repo's crystal convention: each join contributes
``payload * mult`` to a linearized group id (mult=0 for filter-only
joins); ``GroupAgg.n_groups`` bounds the id space.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# predicate expressions (row masks over one table)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TruePred:
    """Match every row (unfiltered join build side)."""


@dataclass(frozen=True)
class RangePred:
    """lo <= col <= hi (closed range — the paper's selection primitive)."""
    col: str
    lo: int
    hi: int


@dataclass(frozen=True)
class EqPred:
    col: str
    value: int


@dataclass(frozen=True)
class InPred:
    col: str
    values: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


Predicate = Union[TruePred, RangePred, EqPred, InPred,
                  Callable[[object], np.ndarray]]


def pred_mask(pred: Predicate, table) -> np.ndarray:
    """Evaluate a predicate to a bool row mask (numpy, host side)."""
    if callable(pred) and not isinstance(
            pred, (TruePred, RangePred, EqPred, InPred)):
        return np.asarray(pred(table)).astype(bool)
    if isinstance(pred, TruePred):
        return np.ones(table.n_rows, bool)
    if isinstance(pred, RangePred):
        c = np.asarray(table[pred.col])
        return (c >= pred.lo) & (c <= pred.hi)
    if isinstance(pred, EqPred):
        return np.asarray(table[pred.col]) == pred.value
    if isinstance(pred, InPred):
        return np.isin(np.asarray(table[pred.col]), pred.values)
    raise TypeError(f"not a predicate: {pred!r}")


# ---------------------------------------------------------------------------
# scalar int expressions (join payloads / group-key contributions)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ColExpr:
    col: str


@dataclass(frozen=True)
class AffineExpr:
    """col * scale + offset (dictionary-code arithmetic, e.g. d_year-1992)."""
    col: str
    scale: int = 1
    offset: int = 0


@dataclass(frozen=True)
class ConstExpr:
    value: int = 1


@dataclass(frozen=True)
class FlagExpr:
    """predicate -> 0/1 int32 (e.g. c_city == 'UNITED KI5')."""
    pred: Predicate


Expr = Union[ColExpr, AffineExpr, ConstExpr, FlagExpr,
             Callable[[object], np.ndarray]]


def expr_values(expr: Expr, table) -> np.ndarray:
    """Evaluate a scalar expression to an int32 column (numpy, host side)."""
    if callable(expr) and not isinstance(
            expr, (ColExpr, AffineExpr, ConstExpr, FlagExpr)):
        return np.asarray(expr(table)).astype(np.int32)
    if isinstance(expr, ColExpr):
        return np.asarray(table[expr.col]).astype(np.int32)
    if isinstance(expr, AffineExpr):
        return (np.asarray(table[expr.col]).astype(np.int32)
                * np.int32(expr.scale) + np.int32(expr.offset))
    if isinstance(expr, ConstExpr):
        return np.full(table.n_rows, expr.value, np.int32)
    if isinstance(expr, FlagExpr):
        return pred_mask(expr.pred, table).astype(np.int32)
    raise TypeError(f"not an expression: {expr!r}")


def range_bounds(pred: Predicate) -> Tuple[str, int, int]:
    """(col, lo, hi) view of a range-expressible predicate — EqPred is the
    degenerate range.  The single owner of this rule; the fused lowering
    and the legacy ``Plan.preds`` view both consume it."""
    if isinstance(pred, RangePred):
        return pred.col, pred.lo, pred.hi
    if isinstance(pred, EqPred):
        return pred.col, pred.value, pred.value
    raise ValueError(f"predicate {pred!r} has no (col, lo, hi) view")


def fingerprint(obj) -> Tuple:
    """Hashable identity of a predicate/expression for hash-table caching.

    Frozen expression dataclasses fingerprint structurally (equal exprs
    share cache entries, even across queries).  Raw callables fall back to
    object identity: conservative — structurally equal lambdas never share
    an entry.  The callable itself rides in the fingerprint (functions
    hash by identity), which also keeps it alive for as long as any cache
    entry references it, so its identity can never be recycled onto a
    different filter.
    """
    if isinstance(obj, (TruePred, RangePred, EqPred, InPred,
                        ColExpr, AffineExpr, ConstExpr)):
        return (type(obj).__name__,) + tuple(
            getattr(obj, f.name) for f in obj.__dataclass_fields__.values())
    if isinstance(obj, FlagExpr):
        return ("FlagExpr", fingerprint(obj.pred))
    return ("callable", obj)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


@dataclass
class Scan:
    """Leaf: a named table of the Database."""
    table: str
    child: None = None


@dataclass
class Filter:
    """Conjunction of predicates over the child's rows."""
    child: "Node"
    preds: List[Predicate] = field(default_factory=list)


@dataclass
class HashJoin:
    """Selective FK hash join: build a (filtered) dim hash table keyed by
    ``key_col`` carrying ``payload``; probe with the fact's ``fact_col``.
    A probe miss filters the row (the dim filter is applied at build).
    ``mult`` is this join's multiplier in the linearized group id.

    Mutable on purpose: tests rewrite ``filter`` in place to widen joins.
    """
    child: "Node"
    fact_col: str
    dim: str
    key_col: str
    filter: Predicate = field(default_factory=TruePred)
    payload: Expr = field(default_factory=ConstExpr)
    mult: int = 0


@dataclass
class Project:
    """Compute the measure column: m1, m1*m2 or m1-m2 (paper's SSB set)."""
    child: "Node"
    m1: str
    m2: Optional[str] = None
    op: str = "first"           # first | mul | sub


@dataclass
class GroupAgg:
    """SUM(measure) grouped by the linearized join-payload group id."""
    child: "Node"
    n_groups: int = 1


@dataclass
class OrderBy:
    """Sort surviving rows by an int32 key column (paper §4.4 radix sort).
    Row-plan only: yields the permutation of surviving row ids."""
    child: "Node"
    key_col: str


Node = Union[Scan, Filter, HashJoin, Project, GroupAgg, OrderBy]


# ---------------------------------------------------------------------------
# plan wrapper + accessors
# ---------------------------------------------------------------------------


def linearize(root: Node) -> List[Node]:
    """Chain from Scan (first) to root (last)."""
    chain = []
    node = root
    while node is not None:
        chain.append(node)
        node = getattr(node, "child", None)
    chain.reverse()
    return chain


@dataclass
class Plan:
    """A named logical plan.  Convenience accessors present the flattened
    SPJA view (preds / joins / measure / n_groups) that the oracle, the
    fused compiler and legacy call sites consume."""
    name: str
    root: Node

    @property
    def chain(self) -> List[Node]:
        return linearize(self.root)

    @property
    def scan(self) -> Scan:
        node = self.chain[0]
        if not isinstance(node, Scan):
            raise ValueError(f"{self.name}: plan chain must start at a Scan")
        return node

    @property
    def filters(self) -> List[Predicate]:
        preds: List[Predicate] = []
        for node in self.chain:
            if isinstance(node, Filter):
                preds.extend(node.preds)
        return preds

    @property
    def preds(self) -> List[Tuple[str, int, int]]:
        """Range predicates as (col, lo, hi) tuples (legacy view)."""
        return [range_bounds(p) for p in self.filters]

    @property
    def joins(self) -> List[HashJoin]:
        return [n for n in self.chain if isinstance(n, HashJoin)]

    @property
    def project(self) -> Optional[Project]:
        for n in self.chain:
            if isinstance(n, Project):
                return n
        return None

    @property
    def group(self) -> Optional[GroupAgg]:
        for n in self.chain:
            if isinstance(n, GroupAgg):
                return n
        return None

    # legacy QuerySpec field views ------------------------------------
    @property
    def m1(self) -> str:
        return self.project.m1

    @property
    def m2(self) -> Optional[str]:
        return self.project.m2

    @property
    def measure_op(self) -> str:
        return self.project.op

    @property
    def n_groups(self) -> int:
        return self.group.n_groups if self.group is not None else 1


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


class QueryBuilder:
    """Fluent construction of linear SPJA plans.

        plan = (QueryBuilder("q2.1")
                .scan("lineorder")
                .hash_join("lo_suppkey", "supplier", "s_suppkey",
                           dim_filter=EqPred("s_region", AMERICA))
                .hash_join("lo_partkey", "part", "p_partkey",
                           dim_filter=EqPred("p_category", 1),
                           payload=ColExpr("p_brand1"), mult=1)
                .measure("lo_revenue")
                .group_by(7000)
                .build())

    Node order in the chain == call order (probes execute in call order).
    """

    def __init__(self, name: str):
        self.name = name
        self._node: Optional[Node] = None

    def _require_scan(self) -> Node:
        if self._node is None:
            raise ValueError(f"{self.name}: call .scan(table) first")
        return self._node

    def scan(self, table: str) -> "QueryBuilder":
        if self._node is not None:
            raise ValueError(f"{self.name}: scan() must be first")
        self._node = Scan(table)
        return self

    def filter(self, *preds: Predicate) -> "QueryBuilder":
        node = self._require_scan()
        if isinstance(node, Filter):
            node.preds.extend(preds)
        else:
            self._node = Filter(node, list(preds))
        return self

    def where_range(self, col: str, lo: int, hi: int) -> "QueryBuilder":
        return self.filter(RangePred(col, lo, hi))

    def hash_join(self, fact_col: str, dim: str, key_col: str,
                  dim_filter: Predicate = None, payload: Expr = None,
                  mult: int = 0) -> "QueryBuilder":
        self._node = HashJoin(
            self._require_scan(), fact_col, dim, key_col,
            filter=TruePred() if dim_filter is None else dim_filter,
            payload=ConstExpr(1) if payload is None else payload,
            mult=mult)
        return self

    def measure(self, m1: str, m2: Optional[str] = None,
                op: str = "first") -> "QueryBuilder":
        self._node = Project(self._require_scan(), m1, m2, op)
        return self

    def group_by(self, n_groups: int) -> "QueryBuilder":
        self._node = GroupAgg(self._require_scan(), n_groups)
        return self

    def order_by(self, key_col: str) -> "QueryBuilder":
        node = self._require_scan()
        if isinstance(node, (Project, GroupAgg)):
            raise ValueError(
                f"{self.name}: OrderBy is row-plan only — it cannot "
                "follow Project/GroupAgg (aggregate output is already "
                "laid out by group id)")
        self._node = OrderBy(node, key_col)
        return self

    def build(self) -> Plan:
        return Plan(self.name, self._require_scan())
