"""Resilience layer of the query server: typed errors, deadlines,
retry and degradation ladders, circuit breakers, and a memory governor.

The port of ``repro.sql.resilience``.  The serving path (``server.py``)
has several strategies for one logical query — the fused kernel, shared
waves, logical shards, morsel streams, and the numpy oracle on the host.
This module turns "a kernel faulted" into "the request went one rung down
the ladder and still answered inside its deadline":

* ``QueryError`` hierarchy — every failure the server surfaces is one of
  these; foreign exceptions are wrapped by :func:`classify_error` with
  ``__cause__`` chained, so the original traceback survives.  A torch
  ``OutOfMemoryError`` ("CUDA out of memory") matches ``_OOM_MARKERS``
  and becomes ``MemoryPressure``.  On a card (``on_card=True``) only an
  injected fault and a real ``OutOfMemoryError`` are retryable: any
  other failure of a kernel's build or launch is a ``DeviceError``,
  which no rung retries.
* ``ErrorInfo`` — the structured value in ``QueryResult.error`` (kind,
  message, strategy attempted, attempt count); it stringifies to
  ``"Kind: message"`` and supports ``in``.
* ``Deadline`` — a monotonic remaining-budget clock carried by requests.
* ``CircuitBreaker`` / ``BreakerBoard`` — per-(strategy, mode) failure
  counters that open after K consecutive faults and half-open after a
  cooldown, so one probe may close them again.
* ``ResourceGovernor`` — reacts to allocation failures or a resident-byte
  budget by halving ``morsel_bytes`` (floor: one LANE-aligned morsel),
  dropping the decode memos and device copies of packed tables, cold
  hash tables and the result cache, and shedding load at admission past
  a high-water mark.
* ``ladder_for`` — the degradation ladder per requested strategy, on the
  CPU ending at ``ref``, the numpy oracle on the host.  On a card the
  ladder has no ``ref`` rung: a request that was to run on the card never
  carries on on the host.

Nothing here imports compile or model at module scope: the server wires
the pieces together, so this module has no import cycle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class QueryError(Exception):
    """Base of every typed failure the serving path may surface."""

    #: whether the ladder may retry a different rung after this error.
    retryable = False

    @property
    def kind(self) -> str:
        return type(self).__name__


class PlanError(QueryError):
    """The logical plan itself is invalid (bad filter, unknown column).

    Not retryable: every rung would fail identically."""


class CompileError(QueryError):
    """Lowering/strategy selection failed before any execution began."""


class ExecError(QueryError):
    """A strategy faulted at runtime (kernel, upload, build, shard).

    Retryable: the same plan may succeed one rung down the ladder."""

    retryable = True


class DeadlineExceeded(QueryError):
    """The request's deadline budget ran out before a rung succeeded."""


class MemoryPressure(QueryError):
    """Allocation failure or resident-bytes budget exhaustion.

    Retryable — the governor reacts (smaller morsels, cache eviction)
    and the ladder may try again; at admission time it is terminal."""

    retryable = True


class DeviceError(QueryError):
    """A kernel failed to build or launch on the card (an nvcc error, a
    CUDA launch error, an illegal address that poisons the context).

    Not retryable: it is a fault of the program, not of the request, and
    answering it one rung down would hide it."""


class FaultInjected(ExecError):
    """Deterministic fault raised by the chaos harness (faults.py)."""


class InjectedOOM(MemoryPressure):
    """Simulated allocation failure raised by the chaos harness."""


_OOM_MARKERS = ("resource_exhausted", "out of memory", "allocation fail",
                "oom", "cannot allocate")


def classify_error(exc: BaseException, during: str = "execute",
                   on_card: bool = False) -> QueryError:
    """Wrap a foreign exception into the taxonomy, chaining ``__cause__``.

    ``during`` picks the class for plain exceptions: "plan" -> PlanError,
    "compile" -> CompileError, anything else -> ExecError.  Allocation
    failures (torch's "CUDA out of memory" and the like) map to
    MemoryPressure regardless of phase.  Already-typed errors pass
    through unchanged.
    ``on_card``: the request runs on a card.  Then only a real
    ``torch.OutOfMemoryError`` is ``MemoryPressure`` (by type, not by
    text), and an execute-time failure that is not a contract violation
    is a ``DeviceError``, not retryable: a kernel that fails to build or
    launch, or a context an illegal address poisoned, surfaces as itself
    instead of answering one rung down.  BaseExceptions that are not
    Exceptions (KeyboardInterrupt, SystemExit) must never reach here —
    callers catch ``Exception`` only.
    """
    if isinstance(exc, QueryError):
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    low = str(exc).lower()
    if on_card:
        oom = isinstance(exc, torch.OutOfMemoryError)
    else:
        oom = any(m in low for m in _OOM_MARKERS)
    if oom:
        wrapped: QueryError = MemoryPressure(msg)
    elif during == "plan":
        wrapped = PlanError(msg)
    elif during == "compile":
        wrapped = CompileError(msg)
    elif isinstance(exc, (ValueError, TypeError, KeyError)):
        # the engine raises these for *contract* violations (negative
        # payloads, unknown columns, ragged batches) — every rung would
        # fail identically, so they are plan errors, not exec faults
        wrapped = PlanError(msg)
    elif on_card:
        wrapped = DeviceError(msg)
    else:
        wrapped = ExecError(msg)
    wrapped.__cause__ = exc
    return wrapped


@dataclass
class ErrorInfo:
    """Structured error stored on ``QueryResult.error``.

    Stringifies as ``"Kind: message"``; substring membership tests
    (``"negative" in result.error``) keep working via ``__contains__``.
    ``exception`` holds the typed QueryError whose ``__cause__`` chains
    back to the original traceback.
    """

    error_kind: str
    message: str
    strategy: Optional[str] = None
    attempts: int = 1
    exception: Optional[QueryError] = None

    @classmethod
    def from_exception(cls, exc: QueryError, strategy: Optional[str] = None,
                       attempts: int = 1) -> "ErrorInfo":
        return cls(error_kind=exc.kind, message=str(exc), strategy=strategy,
                   attempts=attempts, exception=exc)

    def __str__(self) -> str:
        return f"{self.error_kind}: {self.message}"

    def __contains__(self, item: str) -> bool:
        return item in str(self)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            return str(self) == other
        if isinstance(other, ErrorInfo):
            return (self.error_kind, self.message) == (
                other.error_kind, other.message)
        return NotImplemented


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


@dataclass
class Deadline:
    """Monotonic remaining-budget clock.  ``budget_s=None`` never expires."""

    budget_s: Optional[float]
    started: float = field(default_factory=time.monotonic)

    def remaining(self) -> float:
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - (time.monotonic() - self.started)

    def expired(self) -> bool:
        return self.remaining() <= 0.0


# ---------------------------------------------------------------------------
# retry ladder + backoff
# ---------------------------------------------------------------------------

#: strategies tried in order when the requested one faults.  Every ladder
#: ends at "ref", the numpy oracle on the host: no device, no kernel
#: launch, no hash-table build.  On a card ``ladder_for`` leaves that
#: rung out.
_LADDERS: Dict[str, Tuple[str, ...]] = {
    "sharded":   ("sharded", "fused", "opat", "ref"),
    "shared":    ("shared", "fused", "opat", "ref"),
    "fused":     ("fused", "opat", "ref"),
    "part":      ("part", "opat", "ref"),
    "part_loop": ("part_loop", "opat", "ref"),
    "opat":      ("opat", "ref"),
    "auto":      ("auto", "fused", "opat", "ref"),
    "ref":       ("ref",),
}

BACKOFF_BASE_S = 0.005
BACKOFF_CAP_S = 0.1


def ladder_for(strategy: str, on_card: bool = False) -> Tuple[str, ...]:
    """Degradation ladder for a requested strategy (itself first).  On a
    card (``on_card``) no rung after the first is ``ref``: a request for
    the card never degrades to the host."""
    ladder = _LADDERS.get(strategy, (strategy, "fused", "opat", "ref"))
    if on_card:
        ladder = ladder[:1] + tuple(r for r in ladder[1:] if r != "ref")
    return ladder


def backoff_s(attempt: int) -> float:
    """Capped exponential backoff for the attempt-th retry (0-based)."""
    return min(BACKOFF_BASE_S * (2 ** attempt), BACKOFF_CAP_S)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Classic closed / open / half-open breaker.

    ``record_failure`` K times in a row opens the breaker; while open,
    ``allow()`` is False until ``cooldown_s`` passes, after which exactly
    one half-open probe is let through — its success closes the breaker,
    its failure re-opens it (restarting the cooldown)."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if time.monotonic() - self.opened_at >= self.cooldown_s:
                self.state = "half-open"
                self._probing = False
            else:
                return False
        # half-open: admit a single probe
        if not self._probing:
            self._probing = True
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"
        self._probing = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = time.monotonic()
            self._probing = False


class BreakerBoard:
    """Per-(strategy, backend) breakers, lazily created."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}

    def get(self, strategy: str, backend: str) -> CircuitBreaker:
        key = (strategy, backend)
        br = self._breakers.get(key)
        if br is None:
            br = CircuitBreaker(self.threshold, self.cooldown_s)
            self._breakers[key] = br
        return br

    def snapshot(self) -> Dict[Tuple[str, str], str]:
        return {k: b.state for k, b in self._breakers.items()}


# ---------------------------------------------------------------------------
# resource governor
# ---------------------------------------------------------------------------


#: seconds after the last pressure event past which a shedding governor
#: admits requests again, until one more event latches it (half-open, as a
#: circuit breaker): only a success resets the count, and on a card no
#: host rung answers, so a burst of allocation failures would otherwise
#: keep the door shut for good
SHED_COOLDOWN_S = 1.0


class ResourceGovernor:
    """Memory-pressure reactor for the serving loop.

    Tracks the morsel granularity the server should use and responds to
    pressure events (allocation failures, resident-bytes observations
    above budget) by (1) halving ``morsel_bytes`` down to a floor of one
    LANE-aligned morsel, and (2) evicting soft state: every table's
    device copies and packed-column decode memos, cold
    ``HashTableCache`` entries and the result cache.  Past a high-water
    mark (consecutive pressure events or an explicit shed latch) new
    admissions are refused with a typed :class:`MemoryPressure` — at the
    door, not mid-query — until ``SHED_COOLDOWN_S`` passes with no new
    pressure event.
    """

    def __init__(self, morsel_bytes: Optional[int],
                 budget_bytes: Optional[int] = None,
                 high_water: int = 3):
        from .morsel import DEFAULT_MORSEL_BYTES, LANE
        self._lane = LANE
        self.morsel_bytes = int(morsel_bytes or DEFAULT_MORSEL_BYTES)
        self._floor = LANE * 64  # one lane of wide rows; recomputed per-db
        self.budget_bytes = budget_bytes
        self.high_water = high_water
        self.pressure_events = 0
        self.consecutive = 0
        self.sheds = 0
        self.evictions = 0
        self._last_pressure: Optional[float] = None

    # -- admission -----------------------------------------------------
    def should_shed(self) -> bool:
        if self.consecutive < self.high_water:
            return False
        if self._last_pressure is not None and \
                time.monotonic() - self._last_pressure >= SHED_COOLDOWN_S:
            self.consecutive = self.high_water - 1
            return False
        return True

    def admit(self) -> None:
        """Raise typed MemoryPressure when past the high-water mark."""
        if self.should_shed():
            self.sheds += 1
            raise MemoryPressure(
                "admission shed: sustained memory pressure "
                f"({self.consecutive} consecutive events, "
                f"morsel_bytes={self.morsel_bytes})")

    # -- reaction ------------------------------------------------------
    def observe_resident(self, resident_bytes: int) -> bool:
        """Report a resident-bytes observation; True if over budget."""
        return (self.budget_bytes is not None
                and resident_bytes > self.budget_bytes)

    def on_pressure(self, db=None, cache=None, result_cache=None) -> None:
        """React to one pressure event (allocation failure / over budget)."""
        self.pressure_events += 1
        self.consecutive += 1
        self._last_pressure = time.monotonic()
        # halve the morsel granularity, but never below one aligned lane
        nxt = max(self._floor, self.morsel_bytes // 2)
        nxt -= nxt % self._lane
        self.morsel_bytes = max(self._lane, nxt)
        # drop soft state: decode memos + device word uploads on every
        # packed table, cold hash tables no in-flight query will reuse.
        if db is not None:
            for name in ("lineorder", "date", "supplier", "customer",
                         "part"):
                tbl = getattr(db, name, None)
                release = getattr(tbl, "release", None)
                if release is not None:
                    release(device=True)
                    self.evictions += 1
        if cache is not None and hasattr(cache, "evict_cold"):
            self.evictions += cache.evict_cold()
        # finished aggregate grids are the cheapest state to rebuild —
        # under pressure the whole result cache goes, not just cold
        # entries (a stale-but-kept grid would also be the one cache
        # whose wrong answer nobody re-verifies)
        if result_cache is not None and hasattr(result_cache, "clear"):
            self.evictions += result_cache.clear()

    def on_success(self) -> None:
        """A request completed cleanly; decay the consecutive counter."""
        self.consecutive = 0


# ---------------------------------------------------------------------------
# helpers for the server's ladder loop
# ---------------------------------------------------------------------------


def fit_in_budget(predictions: Optional[Dict[str, float]], strategy: str,
                  remaining_s: float, slack: float = 1.0) -> bool:
    """True when the cost model thinks ``strategy`` fits the remaining
    deadline budget.  Unknown strategies (no prediction — e.g. ``ref``)
    always fit: the oracle is the rung of last resort and must stay
    reachable."""
    if predictions is None:
        return True
    pred = predictions.get(strategy)
    if pred is None:
        return True
    return pred * slack <= remaining_s


def sleep_backoff(attempt: int, deadline: Deadline) -> None:
    """Sleep the capped-exponential backoff, clamped to the deadline."""
    pause = backoff_s(attempt)
    rem = deadline.remaining()
    if rem <= 0:
        return
    time.sleep(min(pause, max(rem, 0.0)))


__all__ = [
    "QueryError", "PlanError", "CompileError", "ExecError",
    "DeadlineExceeded", "MemoryPressure", "FaultInjected", "InjectedOOM",
    "classify_error", "ErrorInfo", "Deadline", "CircuitBreaker",
    "BreakerBoard", "ResourceGovernor", "ladder_for", "backoff_s",
    "fit_in_budget", "sleep_backoff", "BACKOFF_BASE_S", "BACKOFF_CAP_S",
]
