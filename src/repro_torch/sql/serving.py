"""Continuous query serving: admission queue, SLO-driven wave
formation, and the result/subsumption cache — ``QueryServer.run()``
turned from a one-shot batch call into a running service.

The port of ``repro.sql.serving``.  The loop runs on the card unless the
caller names the CPU: its server resolves the device once, and the worker
thread passes it to every execution (the current device is per thread).
The cost model's hardware is read once, at construction, so the worker
never reads the calibration or tuning memos beside the caller's thread.

The analytics analog of continuous batching in LLM serving (and of the
seed's own ``serve/engine.py`` wave loop): requests arrive on an
admission queue, a scheduler *forms* shared-scan waves instead of being
handed pre-formed batches, and the formed wave dispatches through the
existing ``QueryServer`` machinery — ``_waves()`` bucketing, ``auto``
arbitration, the retry/degradation ladder, the governor.  Nothing about
execution changes; what this module adds is *when* to stop waiting:

* **Deadline/SLO pressure** — every ticket's budget is
  ``min(slo_s, deadline_s)``.  The former dispatches as soon as any
  member's remaining budget barely covers the predicted wave time (a
  deadline-near arrival therefore dispatches immediately — solo if the
  pool is empty — instead of waiting for company).
* **Marginal economics** — while budgets have slack, the wave is held
  open only while ``model.predict_marginal`` says the *next* arrival's
  shared-scan saving (``gain = solo - marginal_cost``) exceeds the
  queueing delay the wait imposes on the members already aboard
  (``expected inter-arrival gap x wave size``).  Under load the gap
  shrinks and waves grow; at low rate the gap term wins and requests
  dispatch near-solo.  A hold cap bounds the wait when the predicted
  arrival never comes.
* **No scan at all** — the worker consults the server's
  :class:`~repro_torch.sql.result_cache.ResultCache` at routing time: an
  exact repeat, or a query subsumed by a cached wider grid, completes
  without ever entering the pool.

Admission is shed at the door (``ResourceGovernor.admit`` raises a
typed ``MemoryPressure`` from ``submit``), deadlines keep counting
while a ticket queues (the dispatcher passes the *remaining* budget to
the server, and a ticket that dies in the queue completes with a typed
``DeadlineExceeded``), and ``stop()`` drains: every submitted ticket
terminates with a result or a typed error — the PR 8 contract extended
to the asynchronous path.

The policy pieces are deliberately pure: :func:`poisson_arrivals` is a
seeded schedule generator (deterministic under a fixed seed),
:class:`WaveFormer` takes explicit ``now``/``expected_gap`` arguments
and touches no clock, and :class:`SharedWavePredictor` memoizes the
cost-model terms per wave composition — tests drive all three without
threads, and the threaded :class:`ServingLoop` is a thin shell around
them.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sql import resilience as RS
from repro_torch.sql import result_cache as RC
from repro_torch.sql.compile import shareability
from repro_torch.sql.plan import Plan
from repro_torch.sql.server import QueryRequest, QueryResult, QueryServer

__all__ = ["poisson_arrivals", "Ticket", "SharedWavePredictor",
           "WaveFormer", "ServingLoop"]


def poisson_arrivals(rate_qps: float, n: int, seed: int,
                     start: float = 0.0) -> np.ndarray:
    """Open-loop Poisson arrival schedule: ``n`` cumulative arrival
    times (seconds from ``start``) with exponential inter-arrival gaps
    at ``rate_qps``.  Deterministic under a fixed seed — benchmarks and
    tests replay the exact same load."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be positive, got {rate_qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=int(n))
    return start + np.cumsum(gaps)


# ---------------------------------------------------------------------------
# tickets
# ---------------------------------------------------------------------------


@dataclass
class Ticket:
    """A submitted request's handle: block on :meth:`wait` for its
    :class:`~repro_torch.sql.server.QueryResult`.  ``latency_s`` is
    end-to-end (queueing included), unlike the result's own
    ``latency_s`` which times execution from dispatch."""

    rid: int
    plan: Plan
    strategy: str
    deadline_s: Optional[float]
    arrival: float                      # time.monotonic() at submit
    _event: threading.Event = field(default_factory=threading.Event,
                                    repr=False)
    result: Optional[QueryResult] = None
    completed: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed is None:
            return None
        return self.completed - self.arrival

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = 60.0) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.rid} ({self.plan.name}) not completed "
                f"within {timeout}s")
        return self.result

    def _complete(self, result: QueryResult, now: float) -> None:
        self.result = result
        self.completed = now
        self._event.set()


class _ArrivalTracker:
    """EWMA of the inter-arrival gap — the wave former's estimate of
    how long the next marginal member will take to show up."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._last: Optional[float] = None
        self._gap: Optional[float] = None

    def note(self, now: float) -> None:
        if self._last is not None:
            gap = max(now - self._last, 0.0)
            self._gap = gap if self._gap is None else (
                self.alpha * gap + (1.0 - self.alpha) * self._gap)
        self._last = now

    def expected_gap(self) -> float:
        """inf until two arrivals have been seen (unknown rate)."""
        return float("inf") if self._gap is None else self._gap


# ---------------------------------------------------------------------------
# cost-model facade
# ---------------------------------------------------------------------------


class SharedWavePredictor:
    """Memoizing facade over the cost model's shared/marginal terms.

    Wave compositions repeat under a cyclic workload, so the model runs
    once per distinct composition, not once per arrival.  A model
    failure predicts zero — the former then never holds on its account
    (dispatch now is the safe default).  ``hw`` is the ``Hardware`` to
    price with, read once by the caller (the server's); ``memo`` the
    model's statistics memo (``model.stats_memo``; the server's), so a
    new composition only combines each plan's cached statistics.
    ``model_calls`` and ``model_s`` count the model's runs and their host
    seconds."""

    def __init__(self, db, n_shards: Optional[int] = None,
                 morsel_bytes: Optional[int] = None, hw=None,
                 memo: Optional[dict] = None):
        self.db = db
        self.n_shards = n_shards
        self.morsel_bytes = morsel_bytes
        self.hw = hw
        self.memo = {} if memo is None else memo
        self._shared: Dict[Tuple, float] = {}
        self._gain: Dict[Tuple, float] = {}
        self.model_calls = 0
        self.model_s = 0.0

    @staticmethod
    def _key(plans) -> Tuple:
        from repro_torch.sql.compile import shared_member_key
        keys = []
        for p in plans:
            try:
                keys.append(shared_member_key(p))
            except Exception:
                keys.append(("id", id(p)))
        return tuple(sorted(keys, key=repr))

    def _memo(self, memo: Dict[Tuple, float], plans, term: str,
              field: str) -> float:
        """``model.<term>(plans, ...)[field]``, once per composition."""
        key = self._key(plans)
        if key not in memo:
            from repro_torch.sql import model as M
            t0 = time.perf_counter()
            try:
                with M.stats_memo(self.memo):
                    memo[key] = getattr(M, term)(
                        plans, self.db, hw=self.hw, n_shards=self.n_shards,
                        morsel_bytes=self.morsel_bytes)[field]
            except Exception:
                memo[key] = 0.0
            self.model_calls += 1
            self.model_s += time.perf_counter() - t0
        return memo[key]

    def shared_s(self, plans) -> float:
        """Predicted seconds of one shared pass over ``plans``."""
        return self._memo(self._shared, plans, "predict_shared", "shared")

    def marginal_gain(self, plans) -> float:
        """``predict_marginal``'s gain of holding for one more arrival
        shaped like the last member (self-similar workload stand-in)."""
        return self._memo(self._gain, plans, "predict_marginal", "gain")


# ---------------------------------------------------------------------------
# wave formation policy
# ---------------------------------------------------------------------------


class WaveFormer:
    """Pure hold-or-dispatch policy over the pending shareable pool.

    No clock, no threads: callers pass ``now`` (their monotonic time)
    and the expected inter-arrival gap, and get back either a wave to
    dispatch (FIFO, at most ``max_batch``) or ``None`` (keep holding).
    """

    def __init__(self, predictor, slo_s: float = 1.0, max_batch: int = 8,
                 safety: float = 1.5, max_hold_s: float = 0.25):
        self.predictor = predictor
        self.slo_s = float(slo_s)
        self.max_batch = int(max_batch)
        self.safety = float(safety)     # multiplier on the predicted
        # wave time when computing budget slack: dispatch *before* the
        # model says it is exactly too late
        self.max_hold_s = float(max_hold_s)
        self.pending: List[Ticket] = []
        self._held_since: Optional[float] = None
        self.dispatch_reasons: Dict[str, int] = {}

    def add(self, t: Ticket, now: float) -> None:
        if not self.pending:
            self._held_since = now
        self.pending.append(t)

    def _budget(self, t: Ticket) -> float:
        if t.deadline_s is None:
            return self.slo_s
        return min(self.slo_s, t.deadline_s)

    def _min_slack(self, now: float, shared_t: float) -> float:
        """Smallest remaining budget across the pool after paying the
        predicted (safety-padded) wave execution."""
        return min(t.arrival + self._budget(t) - now
                   - self.safety * shared_t for t in self.pending)

    def _take(self, reason: str, now: float) -> List[Ticket]:
        wave = self.pending[:self.max_batch]
        self.pending = self.pending[self.max_batch:]
        self._held_since = now if self.pending else None
        self.dispatch_reasons[reason] = \
            self.dispatch_reasons.get(reason, 0) + 1
        return wave

    def decide(self, now: float, expected_gap: float,
               draining: bool = False) -> Optional[List[Ticket]]:
        """The policy.  Dispatch when the wave is full, a member's
        budget slack is gone (or smaller than one expected gap — it
        cannot afford to wait for the next arrival), the hold cap
        expired, the rate is unknown, or the marginal gain no longer
        pays for the wait it imposes on the whole pool.  Otherwise
        hold."""
        if not self.pending:
            return None
        if draining:
            return self._take("drain", now)
        if len(self.pending) >= self.max_batch:
            return self._take("full", now)
        shared_t = self.predictor.shared_s([t.plan for t in self.pending])
        slack = self._min_slack(now, shared_t)
        if slack <= 0.0:
            return self._take("deadline", now)
        if (self._held_since is not None
                and now - self._held_since >= self.max_hold_s):
            return self._take("hold_cap", now)
        if not math.isfinite(expected_gap):
            return self._take("unknown_rate", now)
        if slack <= expected_gap:
            return self._take("deadline", now)
        gain = self.predictor.marginal_gain(
            [t.plan for t in self.pending])
        if gain <= expected_gap * len(self.pending):
            return self._take("economics", now)
        return None                     # the next arrival pays its way

    def next_wakeup(self, now: float) -> Optional[float]:
        """Seconds until a held wave must be re-examined even with no
        new arrival (budget slack or hold cap running out)."""
        if not self.pending:
            return None
        shared_t = self.predictor.shared_s([t.plan for t in self.pending])
        until = self._min_slack(now, shared_t)
        if self._held_since is not None:
            until = min(until, self._held_since + self.max_hold_s - now)
        return max(until, 0.0)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------


_STOP = object()


class ServingLoop:
    """Continuously running query service over one ``QueryServer``.

        with ServingLoop(db) as loop:            # the card, mode "auto"
            t = loop.submit(plan)                # -> Ticket, sheds typed
            r = t.wait(timeout=10)               # QueryResult
        ServingLoop(db, mode="ref", device="cpu")   # on the CPU

    One worker thread owns the server and issues all device work
    (execution stays single-stream); ``submit`` only runs admission
    control and enqueues.  The worker routes each arrival — result-cache hit:
    complete immediately; unshareable or fixed-strategy: dispatch solo;
    shareable ``shared``/``auto``: into the :class:`WaveFormer` — then
    asks the former for a wave and dispatches it through
    ``QueryServer.run()`` with each member's *remaining* deadline.
    """

    def __init__(self, db, mode: str = "auto", device=None,
                 slo_s: float = 1.0,
                 max_batch: int = 8, safety: float = 1.5,
                 max_hold_s: float = 0.25, ewma_alpha: float = 0.3,
                 result_cache: Optional[RC.ResultCache] = None,
                 warm_pool: Optional[List] = None,
                 **server_kwargs):
        if result_cache is None:
            result_cache = RC.ResultCache()
        # warm_pool: the query pool this service expects.  It becomes
        # the server's footprint anchor (compile.shared_params): every
        # wave lowers with the pool's union footprint, so any member
        # subset lowers to the same streams, and prewarm() builds the
        # pool's tables and kernels up front.  The wave former still
        # prices wave-only bytes, a slight underestimate of an anchored
        # pass.
        self.warm_pool = list(warm_pool) if warm_pool else None
        self.server = QueryServer(db, mode=mode, device=device,
                                  max_batch=max_batch,
                                  result_cache=result_cache,
                                  anchor_plans=self.warm_pool,
                                  **server_kwargs)
        self.slo_s = float(slo_s)
        from repro_torch.sql import shard as SH
        self.predictor = SharedWavePredictor(
            db, n_shards=SH.shard_count(db),
            morsel_bytes=self.server._model_budget(self.warm_pool[0])
            if self.warm_pool else self.server.morsel_bytes,
            hw=self.server.hardware(), memo=self.server.model_memo)
        self.former = WaveFormer(self.predictor, slo_s=slo_s,
                                 max_batch=max_batch, safety=safety,
                                 max_hold_s=max_hold_s)
        self.tracker = _ArrivalTracker(alpha=ewma_alpha)
        self._inbox: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._next_rid = 0
        self._rid_lock = threading.Lock()

    def prewarm(self) -> int:
        """Make the first request as cheap as a later one.  The port has
        no jit cache to fill; what a first request would pay is the
        kernel build (nvcc, at first use) and the pool's hash and merged
        tables.  So on a card every kernel library is built and loaded
        first, then throwaway waves drawn from ``warm_pool`` — one per
        pow2 member bucket up to ``max_batch``, as the reference warms
        its executables — run through the server, which builds the
        pool's tables into its cache.  The result cache is detached for
        the duration (prewarm must not pre-answer real traffic) and the
        wave results are discarded.  Returns the number of buckets
        warmed; 0 without a pool.  Call before :meth:`start` (it drives
        the server directly)."""
        if not self.warm_pool:
            return 0
        if self._running:
            raise RuntimeError("prewarm() must run before start()")
        if self.server.device.type == "cuda":
            import importlib
            for name in ("ssb_fused", "multi_fused", "select_scan",
                         "hash_join", "project", "agg", "radix_part",
                         "part_probe", "unpack"):
                importlib.import_module(
                    f"repro_torch.kernels.{name}").library()
        stash, self.server.result_cache = self.server.result_cache, None
        try:
            buckets = 0
            b = 1
            while b <= self.server.max_batch:
                # distinct prefix: in-wave dedup would collapse repeats
                # and land the wave in a smaller pow2 bucket
                for plan in self.warm_pool[:b]:
                    self.server.submit(plan, strategy="shared")
                self.server.run()
                buckets += 1
                b *= 2
            return buckets
        finally:
            self.server.result_cache = stash

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServingLoop":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._worker,
                                        name="serving-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        """Drain: every already-submitted ticket completes (result or
        typed error) before the worker exits.  Raises ``TimeoutError``
        when the worker has not exited within ``timeout``."""
        if not self._running:
            return
        self._running = False           # reject new submits first, so
        self._inbox.put(_STOP)          # the drain set cannot grow
        if self._thread is not None:
            self._thread.join(timeout)
            alive = self._thread.is_alive()
            self._thread = None
            if alive:
                raise TimeoutError(f"serving loop did not drain within "
                                   f"{timeout}s")

    def __enter__(self) -> "ServingLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client side ---------------------------------------------------
    def submit(self, plan: Plan, strategy: str = "auto",
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit one request.  Raises typed ``MemoryPressure`` when the
        governor is shedding (at the door, like ``QueryServer.submit``)
        and ``RuntimeError`` when the loop is not running."""
        if not self._running:
            raise RuntimeError("ServingLoop is not running (start() it, "
                               "or use it as a context manager)")
        try:
            self.server.governor.admit()
        except RS.MemoryPressure:
            self.server.stats["sheds"] += 1
            raise
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        t = Ticket(rid, plan, strategy, deadline_s, time.monotonic())
        self._inbox.put(t)
        return t

    # -- worker side ---------------------------------------------------
    def _worker(self) -> None:
        draining = False
        while True:
            timeout = self.former.next_wakeup(time.monotonic())
            arrivals: List[Ticket] = []
            try:
                first = self._inbox.get(
                    timeout=None if timeout is None else min(timeout, 0.05))
                arrivals.append(first)
                while True:             # drain the burst in one swoop
                    arrivals.append(self._inbox.get_nowait())
            except queue.Empty:
                pass
            now = time.monotonic()
            for t in arrivals:
                if t is _STOP:
                    draining = True
                    continue
                self.tracker.note(t.arrival)
                self._route(t, now)
            while True:
                wave = self.former.decide(time.monotonic(),
                                          self.tracker.expected_gap(),
                                          draining=draining)
                if not wave:
                    break
                self._dispatch(wave)
            if draining and self._inbox.empty() and not self.former.pending:
                return

    def _route(self, t: Ticket, now: float) -> None:
        """Cache hit -> complete; shareable shared/auto -> pool;
        everything else -> immediate solo dispatch."""
        req = QueryRequest(t.rid, t.plan, t.strategy, t.deadline_s)
        hit = self.server._from_result_cache(req, time.perf_counter())
        if hit is not None:
            hit.latency_s = now - t.arrival
            t._complete(hit, time.monotonic())
            return
        shareable = False
        if t.strategy in ("shared", "auto"):
            try:
                shareable = shareability(t.plan) is None
            except Exception:
                shareable = False
        if shareable:
            self.former.add(t, now)
        else:
            self._dispatch([t])

    def _dispatch(self, wave: List[Ticket]) -> None:
        """Run one formed wave through the server with remaining
        deadlines; every ticket completes, whatever happens."""
        now = time.monotonic()
        srv = self.server
        id_map: Dict[int, Ticket] = {}
        for t in wave:
            remaining = None
            if t.deadline_s is not None:
                remaining = t.deadline_s - (now - t.arrival)
                if remaining <= 0.0:    # died in the admission queue
                    err = RS.DeadlineExceeded(
                        f"deadline {t.deadline_s}s exhausted in the "
                        "admission queue (never dispatched)")
                    srv.stats["queries"] += 1
                    srv.stats["errors"] += 1
                    srv.stats["queue_deadline_drops"] += 1
                    t._complete(QueryResult(
                        rid=t.rid, name=t.plan.name, result=None,
                        strategy=t.strategy, fallback_reason=None,
                        latency_s=now - t.arrival, cache_hits=0,
                        cache_misses=0,
                        error=RS.ErrorInfo.from_exception(
                            err, strategy=t.strategy)), now)
                    continue
            srid = srv._next_rid
            srv._next_rid += 1
            srv.queue.append(QueryRequest(srid, t.plan, t.strategy,
                                          remaining))
            id_map[srid] = t
        if not id_map:
            return
        try:
            results = srv.run()
        except Exception as e:          # must never kill the worker or
            err = RS.classify_error(e)  # leave a ticket hanging
            results = {}
            info = RS.ErrorInfo.from_exception(err)
            for srid, t in id_map.items():
                results[srid] = QueryResult(
                    rid=srid, name=t.plan.name, result=None,
                    strategy=t.strategy, fallback_reason=None,
                    latency_s=time.monotonic() - now,
                    cache_hits=0, cache_misses=0, error=info)
        done = time.monotonic()
        for srid, t in id_map.items():
            r = results.get(srid)
            if r is None:               # defensive: a dropped rid still
                r = QueryResult(        # terminates its ticket
                    rid=srid, name=t.plan.name, result=None,
                    strategy=t.strategy, fallback_reason=None,
                    latency_s=done - now, cache_hits=0, cache_misses=0,
                    error=RS.ErrorInfo.from_exception(RS.ExecError(
                        "request lost by the server run")))
            r.rid = t.rid               # surface the loop-level handle
            r.latency_s = done - t.arrival      # end-to-end, queueing in
            t._complete(r, done)
