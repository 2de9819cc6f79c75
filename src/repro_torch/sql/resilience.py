"""Typed errors of the query path: the part of ``repro.sql.resilience``
that the port reads so far.

The chaos harness (``faults.py``) raises ``FaultInjected`` (an
``ExecError``) or ``InjectedOOM`` (a ``MemoryPressure``), both
``QueryError``\\ s.  The rest of the reference's module (the other error
kinds, deadlines, degradation ladders, circuit breakers, the memory
governor) comes with the server that reads it.
"""


class QueryError(Exception):
    """Base of every typed failure the serving path may surface."""

    #: whether the ladder may retry a different rung after this error.
    retryable = False

    @property
    def kind(self) -> str:
        return type(self).__name__


class ExecError(QueryError):
    """A strategy faulted at runtime (kernel, upload, build, shard).

    Retryable: the same plan may succeed one rung down the ladder."""

    retryable = True


class MemoryPressure(QueryError):
    """Allocation failure or resident-bytes budget exhaustion.

    Retryable — the governor reacts (smaller morsels, cache eviction)
    and the ladder may try again; at admission time it is terminal."""

    retryable = True


class FaultInjected(ExecError):
    """Deterministic fault raised by the chaos harness (faults.py)."""


class InjectedOOM(MemoryPressure):
    """Simulated allocation failure raised by the chaos harness."""
