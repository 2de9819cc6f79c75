"""Straggler mitigation: step-time watchdog.

On a real fleet a straggling host shows up as a step-time tail; the
watchdog tracks a running p50/p95, flags steps beyond ``trip_factor x p50``
and invokes a callback (log + on real deployments: pre-emptive re-slice /
hot-spare swap).  Deterministic and dependency-free so it runs identically
in tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StepWatchdog:
    trip_factor: float = 3.0
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: List[float] = field(default_factory=list)
    _t0: float = 0.0
    straggler_steps: List[int] = field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        if len(self._times) >= self.warmup_steps:
            p50 = sorted(self._times)[len(self._times) // 2]
            if dt > self.trip_factor * p50:
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, p50)
        self._times.append(dt)
        if len(self._times) > 200:
            self._times.pop(0)
        return dt

    @property
    def p50(self) -> float:
        if not self._times:
            return 0.0
        return sorted(self._times)[len(self._times) // 2]
