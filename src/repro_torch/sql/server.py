"""Batched query server: queue -> waves of compiled plans -> execute, with
a keyed cache of built dimension hash tables.

The port of ``repro.sql.server``.  Submitted requests queue up, ``run()``
drains the queue in *waves*, and every wave executes against one shared
``HashTableCache`` on the server's device — the card unless the caller
names the CPU, resolved once at construction and passed to every
execution (the current device is per thread, and a serving loop's worker
issues the device work).  Scheduling is sequential on the host: the
concurrency story is many queued clients sharing one resident database,
amortized builds and per-wave batching.

Waves are bucketed by **scan-compatibility**: requests whose strategy is
``shared`` (or ``auto``) and whose plan is shareable — an aggregate SPJA
plan the fused kernel could run — group by the fact table they scan, and
a compatible wave runs as ONE ``multi_spja`` launch a morsel
(``compile.execute_shared_morsels``): the fact table is read once per
wave, each distinct build side probed once for every member, and each
member's ``QueryResult`` reports the wave it rode in
(``shared_wave_size``).  ``auto`` waves ask the cost model's
shared-vs-solo term (``model.predict_shared``, on the device's
calibrated and tuned ``Hardware``) and run per query when sharing does
not pay.  Everything else — fixed ``fused``/``opat``/``part`` requests,
row plans, unshareable plans — buckets by strategy.

Wave sizing is enforced: a wave is at most ``max_batch`` unique members,
capped at ``multi_fused.MAX_MEMBERS``, the members one launch takes.
That cap is the only wave budget: the port's wave kernel keeps at most
``multi_fused.ACC_BUDGET_BYTES`` of member grids in a block's shared
memory and sums every other group in L2, so its grid never outgrows a
block (the reference's split at a 2 MiB VMEM ``(Q, n_groups)`` f32 grid
has no counterpart), and a launch whose block would still pass the
shared memory a block may take raises.  Identical members inside a wave (``compile.shared_member_key``)
aggregate ONCE, the result fanned out per duplicate
(``stats["dedup_saved"]``).

Repeated queries (or distinct queries sharing a build side) skip the
hash-table build; the cache's hit and miss counts report it.  A packed
database is served as it is (every strategy reads the word streams), and
each result reports the scan's encoded and nominal bytes.  Every
execution streams the fact table through the morsel spine under the
server's ``morsel_bytes``; each result reports ``n_morsels`` and
``peak_resident_bytes``, and ``launch_config``, the launch record of the
kernel families that ran (``compile.LAUNCH_CONFIG``).

Resilience (``repro_torch.sql.resilience``): every request ends in a
result or a typed error (``QueryResult.error``, an ``ErrorInfo``).  On a
retryable fault the server walks the degradation ladder (e.g. ``sharded
→ fused → opat → ref``, ``ref`` being the numpy oracle on the host, a
rung the ladder has only on the CPU) with
capped exponential backoff, skipping rungs the cost model predicts will
not fit a request's deadline and rungs whose circuit breaker is open; a
faulted shared-wave member, or a faulted whole wave, re-enters the ladder
solo; a ``ResourceGovernor`` reacts to memory pressure (a torch "CUDA out
of memory" is one) by halving ``morsel_bytes`` and dropping soft state,
and past a high-water mark sheds new admissions with a typed
``MemoryPressure``.  A request that degraded says so: its ``strategy``
is the rung that answered and ``attempts`` the rungs tried, and
``stats["retries"]`` and ``stats["fallbacks"]`` count them.  On a card
only an injected fault and a real out-of-memory are retryable: a kernel
that fails to build or launch ends its request in a ``DeviceError`` at
once, with no rung tried after it, and a wave it faults in ends every
member so.

``stats`` is a ``defaultdict(int)``: a strategy it never saw tallies
instead of raising.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.device import resolve
from repro_torch.kernels import multi_fused as MF
from repro_torch.sql import compile as C
from repro_torch.sql import resilience as RS
from repro_torch.sql import result_cache as RC
from repro_torch.sql import ssb
from repro_torch.sql import storage as ST
from repro_torch.sql.compile import compile_plan, shareability
from repro_torch.sql.hashtable import HashTableCache
from repro_torch.sql.plan import Plan


@dataclass
class QueryRequest:
    rid: int
    plan: Plan
    strategy: str = "fused"
    deadline_s: Optional[float] = None  # wall-clock budget; None = no bound


@dataclass
class QueryResult:
    rid: int
    name: str
    result: Optional[np.ndarray]        # None when the request errored
    strategy: str                       # strategy that actually ran
    fallback_reason: Optional[str]
    latency_s: float
    cache_hits: int                     # dim-table builds skipped
    cache_misses: int                   # dim-table builds performed
    error: Optional[Union[str, RS.ErrorInfo]] = None  # a failed request's
    #   ErrorInfo (kind, message, strategy attempted, attempts; the
    #   original traceback on exception.__cause__)
    attempts: int = 1                   # ladder rungs tried (1 = first try)
    model_choice: Optional[str] = None  # auto requests: the model's pick
    predicted_s: Optional[float] = None  # the model's time for what ran
    predictions: Optional[Dict[str, float]] = None  # every strategy's
    shared_wave_size: Optional[int] = None  # members of the shared pass
    #   that produced this result (None: ran solo); a shared member's
    #   latency_s is the whole wave's
    bytes_scanned: Optional[int] = None  # fact bytes the scan read at the
    #   columns' encoded widths (a shared member: the whole wave's)
    bytes_scanned_plain: Optional[int] = None  # the same at 4 bytes a value
    device_count: Optional[int] = None  # shards the execution ran over
    shard_times_s: Optional[List[float]] = None  # each shard's seconds
    n_morsels: Optional[int] = None     # morsels the scan streamed
    peak_resident_bytes: Optional[int] = None  # the double-buffer peak
    cache_hit: bool = False             # answered from the result cache
    #   (strategy == "cached": no scan, no kernel, no build)
    launch_config: Optional[Dict[str, Dict]] = None  # per kernel family,
    #   the launch configuration used (compile.LAUNCH_CONFIG's snapshot);
    #   None for cached and ref answers (no kernel launched)
    subsumption_hit: bool = False       # the cache hit masked a wider
    #   cached grid (implies cache_hit)


class QueryServer:
    """Batch query server over one resident ``Database``.

        server = QueryServer(db)                # the card, mode "auto"
        server = QueryServer(db, mode="ref", device="cpu")
        rid = server.submit(plan)               # fused by default
        results = server.run()                  # Dict[rid, QueryResult]
    """

    def __init__(self, db: ssb.Database, mode: str = "auto",
                 device=None, max_batch: int = 8,
                 morsel_bytes: int = C.MS.DEFAULT_MORSEL_BYTES,
                 resident_budget_bytes: Optional[int] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 result_cache: Optional[RC.ResultCache] = None,
                 anchor_plans: Optional[List[Plan]] = None):
        self.db = db
        self.mode = mode
        self.device = resolve(device)
        # on a card a kernel's failure is not retried and the ladder has
        # no host rung (resilience.classify_error, ladder_for)
        self.on_card = self.device.type == "cuda"
        self.max_batch = min(int(max_batch), MF.MAX_MEMBERS)
        # the morsel budget every execution streams under; the governor
        # owns the live value (memory pressure halves it)
        self.governor = RS.ResourceGovernor(
            morsel_bytes, budget_bytes=resident_budget_bytes)
        self.breakers = RS.BreakerBoard(threshold=breaker_threshold,
                                        cooldown_s=breaker_cooldown_s)
        self.cache = HashTableCache()
        # the finished-grid cache: off by default (a batch benchmark that
        # re-submits a wave times execution, not lookups); the serving
        # loop turns it on
        self.result_cache = result_cache
        # footprint anchor (compile.shared_params): every wave lowers with
        # the pool's union footprint
        self.anchor_plans = list(anchor_plans) if anchor_plans else None
        # the cost model's plan statistics for this database, kept across
        # runs (model.stats_memo): pricing a wave combines cached numbers
        self.model_memo: dict = {}
        self.queue: List[QueryRequest] = []
        self._next_rid = 0
        self.stats = defaultdict(int)
        self.stats["occupancy"] = []

    @property
    def morsel_bytes(self) -> int:
        return self.governor.morsel_bytes

    @morsel_bytes.setter
    def morsel_bytes(self, v: int) -> None:
        self.governor.morsel_bytes = int(v)

    def hardware(self):
        """The ``Hardware`` the server prices with: the device's,
        calibrated and tuned where their caches hold it."""
        from repro_torch.sql import model as M
        return M.default_hardware(self.device)

    def submit(self, plan: Plan, strategy: str = "fused",
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request.  Past the governor's high-water mark the
        server sheds load HERE, a typed ``MemoryPressure`` at the door."""
        try:
            self.governor.admit()
        except RS.MemoryPressure:
            self.stats["sheds"] += 1
            raise
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(QueryRequest(rid, plan, strategy, deadline_s))
        return rid

    def _wave_key(self, req: QueryRequest) -> Tuple:
        """Scan-compatibility bucketing: shareable plans requested as
        ``shared``/``auto`` group by the fact table they scan; everything
        else buckets by requested strategy.  A malformed plan buckets solo
        so ``_execute`` reports its error per request."""
        if req.strategy in ("shared", "auto"):
            try:
                shareable = shareability(req.plan) is None
            except (ValueError, TypeError, KeyError, AttributeError):
                shareable = False
            if shareable:
                return ("scan", req.plan.scan.table, req.strategy)
        return ("solo", req.strategy)

    @staticmethod
    def _member_key(req: QueryRequest) -> Tuple:
        """Dedup identity of a wave member; a per-request key (no dedup)
        when the plan cannot be fingerprinted."""
        try:
            return C.shared_member_key(req.plan)
        except (ValueError, TypeError, KeyError, AttributeError):
            return ("rid", req.rid)

    def _chunk_scan_bucket(self, rs: List[QueryRequest]
                           ) -> List[List[QueryRequest]]:
        """Chunk one scan-compatible bucket into waves of at most
        ``max_batch`` *unique* members: a duplicate takes no slot after
        the dedup, so N copies of one query stay one wave."""
        waves: List[List[QueryRequest]] = []
        cur: List[QueryRequest] = []
        cur_keys: set = set()
        for r in rs:
            k = self._member_key(r)
            if cur and k not in cur_keys and \
                    len(cur_keys) >= self.max_batch:
                waves.append(cur)
                cur, cur_keys = [], set()
            cur.append(r)
            cur_keys.add(k)
        if cur:
            waves.append(cur)
        return waves

    def _waves(self) -> List[Tuple[Tuple, List[QueryRequest]]]:
        """Bucket by scan-compatibility key, then chunk — scan buckets to
        unique members, everything else to batch size."""
        buckets: Dict[Tuple, List[QueryRequest]] = defaultdict(list)
        for r in self.queue:
            buckets[self._wave_key(r)].append(r)
        waves = []
        for key, rs in sorted(buckets.items()):
            if key[0] == "scan":
                waves.extend((key, chunk)
                             for chunk in self._chunk_scan_bucket(rs))
            else:
                for i in range(0, len(rs), self.max_batch):
                    waves.append((key, rs[i:i + self.max_batch]))
        return waves

    def run(self) -> Dict[int, QueryResult]:
        from repro_torch.sql import model as M
        out: Dict[int, QueryResult] = {}
        with M.stats_memo(self.model_memo):
            for key, wave in self._waves():
                self.stats["waves"] += 1
                self.stats["occupancy"].append(len(wave) / self.max_batch)
                if key[0] == "scan":
                    out.update(self._run_scan_wave(key, wave))
                else:
                    for req in wave:
                        out[req.rid] = self._execute(req)
        self.queue.clear()
        return out

    # ------------------------------------------------------------------
    # result cache (finished aggregate grids; see result_cache)
    # ------------------------------------------------------------------

    def _from_result_cache(self, req: QueryRequest,
                           t0: float) -> Optional[QueryResult]:
        """Answer ``req`` from the result cache, or None.  A cache
        malfunction is a miss, never a failed request."""
        if self.result_cache is None:
            return None
        try:
            hit = self.result_cache.lookup(self.db, req.plan)
        except Exception:
            return None
        if hit is None:
            return None
        grid, kind = hit
        self.stats["queries"] += 1
        self.stats["result_cache_hits"] += 1
        if kind == "subsume":
            self.stats["result_subsume_hits"] += 1
        if req.strategy == "auto":
            self.stats["auto"] += 1
        return QueryResult(
            rid=req.rid, name=req.plan.name, result=grid,
            strategy="cached", fallback_reason=None,
            latency_s=time.perf_counter() - t0,
            cache_hits=0, cache_misses=0,
            cache_hit=True, subsumption_hit=(kind == "subsume"))

    def _to_result_cache(self, plan: Plan, result) -> None:
        """Keep a finished aggregate grid; never fatal, never rows."""
        if (self.result_cache is None or result is None
                or plan.project is None or plan.group is None):
            return
        try:
            self.result_cache.insert(self.db, plan, np.asarray(result))
        except Exception:
            pass

    # ------------------------------------------------------------------
    # shared-scan wave path
    # ------------------------------------------------------------------

    def _model_budget(self, plan: Plan) -> int:
        """The morsel budget the model prices ``plan`` at on this server
        (a resident fact table is one morsel)."""
        return C._model_budget(plan, self.db, self.device, self.morsel_bytes)

    def _run_scan_wave(self, key: Tuple,
                       wave: List[QueryRequest]) -> Dict[int, QueryResult]:
        """One scan-compatible wave.  ``shared`` requests always run the
        shared pass; ``auto`` waves run it only when the cost model says
        sharing beats the members' solo argmins (a 1-member wave never
        does).  On a sharded database the wave runs shard by shard
        (``compile.execute_shared_sharded``), and ``auto`` arbitrates
        solo, one shared pass and the shared pass over the shards
        (``model.predict_shared(..., n_shards=...)``)."""
        from repro_torch.sql import shard as SH
        strategy = key[2]
        n_shards = SH.shard_count(self.db)
        sharded = n_shards > 1
        preds = None
        if strategy == "auto":
            from repro_torch.sql import model as M
            run_shared = False
            if len(wave) > 1:
                t0 = time.perf_counter()
                try:
                    preds = M.predict_shared(
                        [r.plan for r in wave], self.db,
                        hw=self.hardware(), n_shards=n_shards,
                        morsel_bytes=self._model_budget(wave[0].plan))
                    shared_t = min(preds["shared"],
                                   preds.get("shared_sharded",
                                             float("inf")))
                    run_shared = shared_t < preds["solo"]
                    sharded = (sharded and
                               preds.get("shared_sharded",
                                         float("inf")) < preds["shared"])
                except Exception:           # a model failure is not fatal
                    run_shared = False      # the members run solo
                    self.stats["shared_arbitration_errors"] += 1
                self.stats["arbitration_s"] += time.perf_counter() - t0
            if not run_shared:
                return {req.rid: self._execute(req) for req in wave}
        return self._run_shared(wave, model_predictions=preds,
                                sharded=sharded)

    def _run_shared(self, wave: List[QueryRequest],
                    model_predictions: Optional[Dict[str, float]] = None,
                    sharded: bool = False) -> Dict[int, QueryResult]:
        """Execute one wave as a single shared pass, with member fault
        isolation: a member whose build sides fail to construct leaves the
        wave and re-enters the ladder solo; the survivors still share one
        pass.  A retryable fault inside the shared pass sends every
        survivor back through the ladder solo (one launch says nothing
        about which member is poisoned); a fault no rung retries (a
        kernel's failure on a card) ends every survivor in it.  ``sharded=True`` runs the wave on each
        shard and merges (``compile.execute_shared_sharded``); members
        then report ``device_count``/``shard_times_s``."""
        from repro_torch.sql import model as M
        from repro_torch.sql import shard as SH
        out: Dict[int, QueryResult] = {}
        t0 = time.perf_counter()
        survivors: List[QueryRequest] = []
        deltas: Dict[int, Tuple[int, int]] = {}
        # the built tables ride into the wave as they are, so the
        # lowering never fetches them again: each hit and miss the wave
        # causes is one member's
        prebuilt: Dict[Tuple, Tuple] = {}
        for req in wave:
            cached = self._from_result_cache(req, t0)
            if cached is not None:      # answered with no wave slot
                out[req.rid] = cached
                continue
            h0, m0 = self.cache.hits, self.cache.misses
            try:
                for j in req.plan.joins:
                    built = self.cache.get_or_build(self.db, j, self.device)
                    prebuilt[C.shared_join_key(j)] = built
            except Exception:       # build fault: the member leaves
                self.stats["member_reentries"] += 1
                out[req.rid] = self._execute(req)
                continue
            deltas[req.rid] = (self.cache.hits - h0,
                               self.cache.misses - m0)
            survivors.append(req)
        if not survivors:
            return out

        # in-wave dedup: members of equal execution identity aggregate
        # ONCE; duplicates get their own copy of the result
        uniq_reqs: List[QueryRequest] = []
        slot_of: Dict[int, int] = {}
        slot_ix: Dict[Tuple, int] = {}
        for req in survivors:
            k = self._member_key(req)
            if k in slot_ix:
                self.stats["dedup_saved"] += 1
            else:
                slot_ix[k] = len(uniq_reqs)
                uniq_reqs.append(req)
            slot_of[req.rid] = slot_ix[k]

        try:
            fact = getattr(self.db, uniq_reqs[0].plan.scan.table)
            bytes_enc, bytes_plain = M.scanned_bytes_shared(
                [r.plan for r in uniq_reqs], fact)
        except Exception:                   # reporting only, never fatal
            bytes_enc = bytes_plain = None

        flavor = "shared_sharded" if sharded else "shared"
        dc = SH.shard_count(self.db) if sharded else None
        shard_times: Optional[List[float]] = None
        report: Optional[C.MS.MorselReport] = None
        wave_config: Optional[Dict[str, Dict]] = None

        def member_result(req, result, dt):
            self.stats["queries"] += 1
            if req.strategy == "auto":
                self.stats["auto"] += 1
            self.stats["shared"] += 1
            hits, misses = deltas[req.rid]
            return QueryResult(
                rid=req.rid, name=req.plan.name, result=result,
                strategy="shared", fallback_reason=None, latency_s=dt,
                cache_hits=hits, cache_misses=misses,
                model_choice=flavor if req.strategy == "auto" else None,
                predicted_s=(None if model_predictions is None
                             else model_predictions.get(
                                 flavor, model_predictions["shared"])),
                predictions=model_predictions,
                shared_wave_size=len(survivors),
                bytes_scanned=bytes_enc, bytes_scanned_plain=bytes_plain,
                device_count=dc, shard_times_s=shard_times,
                n_morsels=None if report is None else report.n_morsels,
                peak_resident_bytes=(None if report is None
                                     else report.peak_resident_bytes),
                launch_config=wave_config)

        # members padded to a power of two: padded slots are inert but not
        # free, so a small wave does not pay for max_batch
        pad_to = 1 << max(len(uniq_reqs) - 1, 0).bit_length()
        plans = [r.plan for r in uniq_reqs]
        try:
            if sharded:
                results, shard_times, report = C.execute_shared_sharded(
                    plans, self.db, mode=self.mode, cache=self.cache, pad_to=pad_to, prebuilt=prebuilt,
                    morsel_bytes=self.morsel_bytes,
                    anchor=self.anchor_plans, device=self.device)
            else:
                results, report = C.execute_shared_morsels(
                    plans, SH.base_of(self.db), mode=self.mode,
                    cache=self.cache, pad_to=pad_to,
                    prebuilt=prebuilt, morsel_bytes=self.morsel_bytes,
                    anchor=self.anchor_plans, device=self.device)
            wave_config = C.snapshot_launch_config()
        except Exception as e:          # wave fault: members retry solo
            err = RS.classify_error(e, during="execute",
                                    on_card=self.on_card)
            if isinstance(err, RS.MemoryPressure):
                self.governor.on_pressure(db=self.db, cache=self.cache,
                                          result_cache=self.result_cache)
            if not err.retryable:
                for req in survivors:
                    out[req.rid] = self._errored(req, err, "shared", t0,
                                                 deltas[req.rid])
                return out
            self.stats["wave_reentries"] += 1
            for req in survivors:
                out[req.rid] = self._execute(req)
            return out
        dt = time.perf_counter() - t0
        self.stats["shared_waves"] += 1
        if sharded:
            self.stats["sharded_waves"] += 1
        owned = set()
        for req in survivors:
            result = results[slot_of[req.rid]]
            if slot_of[req.rid] in owned:   # duplicate member: own copy
                result = result.copy()
            owned.add(slot_of[req.rid])
            self._to_result_cache(req.plan, result)
            out[req.rid] = member_result(req, result, dt)
        return out

    # ------------------------------------------------------------------
    # solo path
    # ------------------------------------------------------------------

    def _oracle_ok(self, plan: Plan) -> bool:
        """Whether the ``ref`` rung (the numpy oracle) can interpret this
        plan: aggregate SPJA plans only."""
        return plan.project is not None and plan.group is not None

    def _run_ref(self, plan: Plan) -> np.ndarray:
        """The ladder's last rung: the numpy oracle on the host — no
        kernel, no device copy, no hash-table build.  Pending ingest
        deltas fold into a throwaway flushed copy, so the oracle sees the
        rows every engine path scans."""
        from dataclasses import replace as dc_replace

        from repro_torch.sql import engine as E
        from repro_torch.sql import shard as SH
        base = SH.base_of(self.db)
        fact = getattr(base, plan.scan.table)
        if ST.delta_rows(fact):
            base = dc_replace(base,
                              **{plan.scan.table: ST.flush_deltas(fact)})
        return np.asarray(E.run_query_oracle(base, plan))

    def _errored(self, req: QueryRequest, err: RS.QueryError,
                 strategy: str, t0: float, cache_delta: Tuple[int, int],
                 attempts: int = 1,
                 fallback_reason: Optional[str] = None) -> QueryResult:
        """A request that ends in the typed error ``err``, tallied."""
        self.stats["queries"] += 1
        self.stats["errors"] += 1
        if req.strategy == "auto":
            self.stats["auto"] += 1
        if fallback_reason is not None:
            self.stats["fallbacks"] += 1
        return QueryResult(
            rid=req.rid, name=req.plan.name, result=None,
            strategy=strategy, fallback_reason=fallback_reason,
            latency_s=time.perf_counter() - t0,
            cache_hits=cache_delta[0], cache_misses=cache_delta[1],
            attempts=attempts,
            error=RS.ErrorInfo.from_exception(err, strategy=strategy,
                                              attempts=attempts))

    def _execute(self, req: QueryRequest) -> QueryResult:
        """One request through the retry and degradation ladder.

        A non-retryable failure (bad plan, compile error, a kernel's
        failure on a card) surfaces at once as a typed ``ErrorInfo``; a retryable one (exec fault, memory
        pressure) walks ``resilience.ladder_for(req.strategy)`` with
        capped exponential backoff, skipping rungs whose breaker is open
        or whose predicted time exceeds the remaining deadline.  Memory
        pressure also triggers the governor and retries the same rung
        once before degrading.  Every path ends: success, typed error, or
        ``DeadlineExceeded``."""
        h0, m0 = self.cache.hits, self.cache.misses
        t0 = time.perf_counter()
        cached = self._from_result_cache(req, t0)
        if cached is not None:
            return cached
        deadline = RS.Deadline(req.deadline_s)
        attempts = 0

        def errored(err: RS.QueryError, strategy, fallback_reason=None):
            return self._errored(
                req, err, strategy, t0,
                (self.cache.hits - h0, self.cache.misses - m0),
                attempts=max(attempts, 1), fallback_reason=fallback_reason)

        def succeeded(result, ran, cq):
            dt = time.perf_counter() - t0
            self.stats["queries"] += 1
            self.stats[ran] += 1
            if req.strategy == "auto":
                self.stats["auto"] += 1
            fallback = None if cq is None else cq.fallback_reason
            if fallback is not None:
                self.stats["fallbacks"] += 1
            self.governor.on_success()
            self._to_result_cache(req.plan, result)
            try:
                from repro_torch.sql import model as M
                bytes_enc, bytes_plain = M.scanned_bytes(
                    req.plan, getattr(self.db, req.plan.scan.table))
            except Exception:               # reporting only, never fatal
                bytes_enc = bytes_plain = None
            preds = None if cq is None else cq.predictions
            return QueryResult(
                rid=req.rid, name=req.plan.name, result=result,
                strategy=ran, fallback_reason=fallback,
                latency_s=dt, cache_hits=self.cache.hits - h0,
                cache_misses=self.cache.misses - m0,
                attempts=max(attempts, 1),
                model_choice=ran if req.strategy == "auto" else None,
                predicted_s=None if preds is None else preds.get(ran),
                predictions=preds,
                bytes_scanned=bytes_enc, bytes_scanned_plain=bytes_plain,
                device_count=None if cq is None else cq.device_count,
                shard_times_s=None if cq is None else cq.shard_times_s,
                n_morsels=None if cq is None else cq.n_morsels,
                peak_resident_bytes=(None if cq is None
                                     else cq.peak_resident_bytes),
                launch_config=(None if cq is None
                               else cq.launch_config))

        ladder = RS.ladder_for(req.strategy, on_card=self.on_card)
        predictions: Optional[Dict[str, float]] = None
        last_err: Optional[RS.QueryError] = None
        pressure_retried: set = set()
        rung_i = 0
        while rung_i < len(ladder):
            rung = ladder[rung_i]
            if deadline.expired():
                break
            if rung == "ref" and not self._oracle_ok(req.plan):
                rung_i += 1
                continue
            breaker = self.breakers.get(rung, self.mode)
            if not breaker.allow():     # poisoned path: skip, don't probe
                self.stats["breaker_skips"] += 1
                rung_i += 1
                continue
            if req.deadline_s is not None and last_err is not None:
                # don't start a rung the model predicts will blow the
                # remaining budget
                if predictions is None:
                    from repro_torch.sql import model as M
                    from repro_torch.sql import shard as SH
                    try:
                        predictions = M.predict(
                            req.plan, self.db, hw=self.hardware(),
                            n_shards=SH.shard_count(self.db),
                            morsel_bytes=self._model_budget(req.plan))
                    except Exception:   # no model, no skipping
                        predictions = {}
                if not RS.fit_in_budget(predictions, rung,
                                        deadline.remaining()):
                    self.stats["budget_skips"] += 1
                    rung_i += 1
                    continue
            attempts += 1
            cq = None
            try:
                if rung == "ref":
                    result = self._run_ref(req.plan)
                    ran = "ref"
                else:
                    try:
                        cq = compile_plan(req.plan, rung)
                    except Exception as e:
                        raise RS.classify_error(e, during="compile") \
                            from e
                    result = cq.execute(
                        self.db, mode=self.mode, cache=self.cache,
                        device=self.device, morsel_bytes=self.morsel_bytes)
                    # auto reports the strategy the model dispatched
                    ran = cq.decided or cq.strategy
            except Exception as e:
                err = RS.classify_error(e, during="execute",
                                        on_card=self.on_card)
                if err.retryable:
                    # only exec faults say something of the rung's health
                    breaker.record_failure()
                last_err = err
                if isinstance(err, RS.MemoryPressure):
                    # react, then retry the SAME rung once at the
                    # governor's reduced footprint before degrading
                    self.governor.on_pressure(
                        db=self.db, cache=self.cache,
                        result_cache=self.result_cache)
                    self.stats["pressure_events"] += 1
                    if err.retryable and rung not in pressure_retried:
                        pressure_retried.add(rung)
                        RS.sleep_backoff(attempts - 1, deadline)
                        continue
                if not err.retryable:
                    return errored(err, rung, None if cq is None
                                   else cq.fallback_reason)
                self.stats["retries"] += 1
                RS.sleep_backoff(attempts - 1, deadline)
                rung_i += 1
                continue
            breaker.record_success()
            return succeeded(result, ran, cq)

        if deadline.expired():
            err = RS.DeadlineExceeded(
                f"deadline {req.deadline_s}s exhausted after "
                f"{attempts} attempt(s), last rung "
                f"{ladder[min(rung_i, len(ladder) - 1)]!r}")
            if last_err is not None:
                err.__cause__ = last_err
            return errored(err, req.strategy)
        if last_err is None:
            last_err = RS.ExecError(
                f"no runnable rung in ladder {ladder} "
                "(circuit breakers open or rungs inapplicable)")
        return errored(last_err, req.strategy)
