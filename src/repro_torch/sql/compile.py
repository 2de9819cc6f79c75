"""Plan compiler: lower a logical plan to a physical strategy.

The port of ``repro.sql.compile``.  One strategy lowers so far:

``fused`` — collapse the whole SPJA subtree into one launch of the
            hand-written CUDA kernel ``kernels/csrc/ssb_fused.cu`` (the
            paper's Crystal model, §5.3: zero intermediate
            materialization, one pass over the fact table in device
            memory).  The fact columns are resident on the device
            (``ssb.Table.on_device``): a query sends no fact bytes over
            PCIe, and the measures go to the kernel as their int32
            columns, with no per-query f32 copy.

``execute`` runs the whole-table pass — the reference's fused path when
the fact table is one morsel.  Every other strategy, and a plan the fused
kernel cannot express (which the reference sends to ``opat``), raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.sql import hashtable as HT
from repro_torch.sql import plan as P
from repro_torch.sql import ssb
from repro_torch.sql import storage as ST

STRATEGIES = ("fused", "opat", "part", "part_loop", "shared", "sharded",
              "auto")

# where each strategy the reference has lands in the port (ROADMAP.md,
# "Open items", queue 1)
_NOT_PORTED = {
    "opat": "queue 1, item 5 (operator-at-a-time chain)",
    "part": "queue 1, item 7 (partitioned join)",
    "part_loop": "queue 1, item 7 (partitioned join)",
    "shared": "queue 1, item 6 (shared-scan waves)",
    "sharded": "queue 1, item 9 (sharding)",
    "auto": "queue 1, item 10 (cost model, calibration, tuner)",
}


def _not_ported(strategy: str, why: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"strategy {strategy!r} is not in repro_torch yet{why}; it comes "
        f"with ROADMAP.md {_NOT_PORTED[strategy]}")


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
                    "the fused kernel evaluates by-value (lo, hi) bounds "
                    "only")
    if plan.project.op not in ("first", "mul", "sub"):
        return f"measure op {plan.project.op!r} not supported by the kernel"
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


def _measure_streams(fact, proj: P.Project, device: torch.device
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The measure inputs as the kernel consumes them: the resident int32
    columns (the kernel sums exactly in int64, so no f32 copy is made).
    Stream count follows the measure *op*: an m2 on an op="first"
    projection is never loaded."""
    m1 = ST.column_stream(fact, proj.m1, device)[0]
    m2 = (ST.column_stream(fact, proj.m2, device)[0]
          if proj.op in ("mul", "sub") else None)
    return m1, m2


def fused_inputs(plan: P.Plan, db: ssb.Database,
                 cache: Optional[HT.HashTableCache], device: torch.device
                 ) -> Tuple[tuple, dict]:
    """The ``spja`` call one fused pass over the plan's fact table makes:
    (positional args, keyword args), with the resident fact columns and
    the hash tables on ``device``.  ``chip_smoke.py`` times the kernel on
    exactly these."""
    fact = getattr(db, plan.scan.table)
    bounds = plan.preds           # fusability guarantees the range view
    pred_cols = [ST.column_stream(fact, c, device)[0] for c, _, _ in bounds]
    joins = plan.joins
    join_keys = [ST.column_stream(fact, j.fact_col, device)[0]
                 for j in joins]
    join_tables: List[torch.Tensor] = []
    for j in joins:
        htk, htv = (cache.get_or_build(db, j, device) if cache is not None
                    else HT.build_dim_table(db, j, device))
        join_tables.extend([htk, htv])
    mults = np.array([j.mult for j in joins], np.int32)
    proj = plan.project
    m1, m2 = _measure_streams(fact, proj, device)
    return ((pred_cols, _rewritten_bounds(fact, bounds), join_keys,
             join_tables, mults, m1, m2),
            dict(measure_op=proj.op, n_groups=plan.n_groups))


def _execute_fused(plan: P.Plan, db: ssb.Database, mode: str,
                   cache: Optional[HT.HashTableCache],
                   device: torch.device) -> np.ndarray:
    """One fused SPJA pass over the plan's fact table -> (n_groups,) f32
    on the host."""
    args, kw = fused_inputs(plan, db, cache, device)
    return ops.spja(*args, mode=mode, **kw).cpu().numpy()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@dataclass
class CompiledQuery:
    """An executable lowering of a logical plan.

    ``strategy`` is the strategy that runs; ``requested`` what the caller
    asked for.  ``fallback_reason`` stays None here: the reference falls
    back to ``opat`` on a plan the fused kernel cannot express, and the
    port raises instead until that strategy is ported.  After
    ``execute``, ``decided`` holds the strategy that ran."""
    plan: P.Plan
    strategy: str
    requested: str
    fallback_reason: Optional[str] = None
    decided: Optional[str] = None

    def execute(self, db: ssb.Database, mode: str = "auto",
                cache: Optional[HT.HashTableCache] = None,
                device=None) -> np.ndarray:
        """Run the plan on ``device`` (the current card when None; the
        CPU only when named) -> (n_groups,) f32 numpy array."""
        device = resolve(device)
        self.decided = self.strategy
        return _execute_fused(self.plan, db, mode, cache, device)


def compile_plan(plan: P.Plan, strategy: str = "fused") -> CompiledQuery:
    """Validate + lower ``plan``.  Only ``fused`` lowers in this package
    so far; any other known strategy, and a plan that is not fusable,
    raises ``NotImplementedError`` naming the ROADMAP item that brings
    it."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if strategy != "fused":
        classify(plan)                  # raise on malformed chains
        raise _not_ported(strategy)
    reason = fusability(plan)           # classifies; raises on malformed
    if reason is not None:
        raise _not_ported("opat", f" (plan {plan.name!r} is not fusable: "
                                  f"{reason})")
    return CompiledQuery(plan, "fused", "fused")
