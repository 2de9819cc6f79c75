"""Deterministic fault injection (chaos harness) for the serving path.

A :class:`FaultPlan` carries a seed and per-site fault rates; while a
plan is installed, each instrumented site calls :func:`maybe_fault`,
which draws from a *per-site* counter-based stream — the k-th visit to a
site under seed S always makes the same fault/no-fault decision, no
matter how many other sites fired in between or in what order threads
interleaved.  That determinism is what lets the chaos benchmark replay a
sweep and assert bit-identical survivors.

Instrumented sites:

=========  ==========================================================
site       where
=========  ==========================================================
kernel     compile.py — just before SPJA / multi-SPJA kernel dispatch
upload     morsel.py — MorselStream._prefetch (device_put of a morsel)
build      hashtable.py — build_dim_table (device hash-table build)
ingest     storage.py — append_rows / flush_deltas staging
=========  ==========================================================

Faults raise :class:`~.resilience.FaultInjected` (an ``ExecError``), or
:class:`~.resilience.InjectedOOM` (a ``MemoryPressure``) when the plan's
``oom_every`` says this fault should simulate an allocation failure.
With no plan installed the fast path is a single global ``None`` check.
"""
from __future__ import annotations

import hashlib
from contextlib import contextmanager
from typing import Dict, Optional

from .resilience import FaultInjected, InjectedOOM

# active plan — module-global on purpose: injection sites live deep in
# code that has no request context to thread a plan handle through.
_PLAN: Optional["FaultPlan"] = None


class FaultPlan:
    """Seeded, per-site deterministic fault schedule.

    ``rates`` maps site name -> probability in [0, 1].  Sites absent
    from the map never fault.  ``oom_every`` (default 3) makes every
    n-th injected fault at a site a simulated OOM instead of a generic
    exec fault, so both taxonomy branches get exercised.
    """

    def __init__(self, seed: int, rates: Dict[str, float],
                 oom_every: int = 3):
        self.seed = seed
        self.rates = dict(rates)
        self.oom_every = oom_every
        self._counters: Dict[str, int] = {}
        self._faults: Dict[str, int] = {}

    def _draw(self, site: str) -> float:
        """Counter-based uniform draw in [0, 1) for this site visit."""
        k = self._counters.get(site, 0)
        self._counters[site] = k + 1
        h = hashlib.sha256(f"{self.seed}:{site}:{k}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def should_fault(self, site: str) -> bool:
        rate = self.rates.get(site, 0.0)
        # draw unconditionally so the per-site stream position depends
        # only on visit count, never on the configured rate
        return self._draw(site) < rate

    def fault(self, site: str) -> None:
        """Raise the typed fault for one triggered injection."""
        n = self._faults.get(site, 0) + 1
        self._faults[site] = n
        if self.oom_every and n % self.oom_every == 0:
            raise InjectedOOM(
                f"injected allocation failure at site '{site}' "
                f"(fault #{n}, seed={self.seed})")
        raise FaultInjected(
            f"injected fault at site '{site}' (fault #{n}, "
            f"seed={self.seed})")

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"visits": dict(self._counters),
                "faults": dict(self._faults)}


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or with ``None`` clear) the active fault plan."""
    global _PLAN
    _PLAN = plan


def current() -> Optional[FaultPlan]:
    return _PLAN


@contextmanager
def active(plan: FaultPlan):
    """Scope a fault plan: installed on entry, always cleared on exit."""
    install(plan)
    try:
        yield plan
    finally:
        install(None)


def maybe_fault(site: str) -> None:
    """Injection point — no-op unless a plan is installed and fires."""
    plan = _PLAN
    if plan is not None and plan.should_fault(site):
        plan.fault(site)


__all__ = ["FaultPlan", "install", "current", "active", "maybe_fault"]
