"""The port's query server and resilience layer
(``repro_torch.sql.server``, ``repro_torch.sql.resilience``) on the CPU,
held to the reference's ``tests/test_query_server.py`` and
``tests/test_resilience.py``, the server cases of ``tests/test_morsel.py``
(:441, :515) and ``tests/test_shard.py`` (:186-230), and to the reference
package itself.

Same inputs in both: the reference's SF 0.005 database carried across
with ``ssb.from_numpy``.  Every answer is bit-identical to the numpy
oracle, and to the reference's ``QueryServer(db, mode="ref")`` (its f32
sums stay below 2^24 at this scale, so they are exact too).  The port's
server runs on the card unless the caller names the CPU; here every
server is ``mode="ref", device="cpu"``.
"""
import copy
import logging
import os
import time

import numpy as np
import pytest
import torch

from repro.sql import engine as RE
from repro.sql import shard as RSH
from repro.sql import ssb as RSSB
from repro.sql.server import QueryServer as RefServer
from repro_torch.cost import model as CM
from repro_torch.kernels import multi_fused as MF
from repro_torch.sql import calibrate as CAL
from repro_torch.sql import engine, faults, ssb
from repro_torch.sql import plan as P
from repro_torch.sql import resilience as RS
from repro_torch.sql import shard as SH
from repro_torch.sql import storage as ST
from repro_torch.sql.hashtable import HashTableCache, join_cache_key
from repro_torch.sql.server import QueryServer

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
QUERIES = engine.ssb_queries()
REF_QUERIES = RE.ssb_queries()
Q11 = QUERIES["q1.1"]           # no joins (selection only)
Q21 = QUERIES["q2.1"]           # 3 joins (build-side surface)
CPU = torch.device("cpu")
ORACLE = {name: engine.run_query_oracle(DB, plan)
          for name, plan in QUERIES.items()}


def server(db=DB, **kw):
    return QueryServer(db, mode="ref", device=CPU, **kw)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    """Fault plans never leak across tests."""
    yield
    faults.install(None)


# ---------------------------------------------------------------------------
# the server (tests/test_query_server.py)
# ---------------------------------------------------------------------------


def test_server_matches_direct_run_query():
    srv = server()
    rids = {name: srv.submit(QUERIES[name])
            for name in ("q1.1", "q2.1", "q3.2", "q4.1")}
    results = srv.run()
    for name, rid in rids.items():
        direct = engine.run_query(DB, QUERIES[name], mode="ref", device=CPU)
        np.testing.assert_array_equal(results[rid].result, direct)
        np.testing.assert_array_equal(results[rid].result, ORACLE[name])
        assert results[rid].strategy == "fused"
        assert results[rid].fallback_reason is None


@pytest.mark.parametrize("strategy", ["fused", "opat", "part", "part_loop",
                                      "shared", "auto"])
def test_server_matches_reference_server_bit_for_bit(strategy):
    """The 13 queries through both servers in one batch: the same bits,
    the oracle's, and the same strategy that ran (the reference decides
    ``auto`` on its host model, the port on ``HOST``: the same numbers)."""
    ours, ref = server(max_batch=16), RefServer(REF_DB, mode="ref",
                                                max_batch=16)
    rids = {n: (ours.submit(p, strategy), ref.submit(REF_QUERIES[n],
                                                     strategy))
            for n, p in QUERIES.items()}
    got, want = ours.run(), ref.run()
    for name, (a, b) in rids.items():
        assert got[a].error is None, (name, got[a].error)
        assert got[a].attempts == 1
        assert got[a].result.tobytes() == ORACLE[name].tobytes(), name
        assert got[a].result.tobytes() == \
            np.asarray(want[b].result, np.float32).tobytes(), name
        assert got[a].strategy == want[b].strategy, name
        assert got[a].shared_wave_size == want[b].shared_wave_size
        assert got[a].fallback_reason == want[b].fallback_reason
        assert set(got[a].launch_config or {}) == \
            set(want[b].launch_config or {}), name
    assert ours.stats["retries"] == 0


def test_repeated_query_hits_hash_table_cache():
    srv = server()
    r1 = srv.submit(Q21)
    out1 = srv.run()
    assert out1[r1].cache_misses == 3       # supplier, part, date built
    assert out1[r1].cache_hits == 0
    r2 = srv.submit(Q21)
    out2 = srv.run()
    assert out2[r2].cache_hits == 3         # all three builds skipped
    assert out2[r2].cache_misses == 0
    np.testing.assert_array_equal(out1[r1].result, out2[r2].result)
    assert srv.cache.hit_rate == 0.5


def test_distinct_queries_share_build_sides():
    """q2.1 and q2.2 share the identical unfiltered date build side."""
    srv = server()
    srv.submit(QUERIES["q2.1"])
    srv.submit(QUERIES["q2.2"])
    results = srv.run()
    assert sum(r.cache_hits for r in results.values()) >= 1
    assert join_cache_key(QUERIES["q2.1"].joins[2]) == \
        join_cache_key(QUERIES["q2.2"].joins[2])


def test_opat_requests_run_and_match():
    srv = server()
    rf = srv.submit(QUERIES["q3.1"], strategy="fused")
    ro = srv.submit(QUERIES["q3.1"], strategy="opat")
    results = srv.run()
    assert results[rf].strategy == "fused"
    assert results[ro].strategy == "opat"
    np.testing.assert_array_equal(results[rf].result, results[ro].result)
    assert results[ro].cache_hits + results[rf].cache_hits >= 3
    assert srv.stats["waves"] == 2          # one wave per strategy bucket


def test_wave_batching():
    srv = server(max_batch=2)
    for _ in range(3):
        srv.submit(Q11)
    srv.run()
    assert srv.stats["waves"] == 2
    assert srv.stats["occupancy"] == [1.0, 0.5]
    assert srv.stats["queries"] == 3


def test_cache_standalone_stats():
    cache = HashTableCache()
    j = QUERIES["q4.2"].joins[3]
    cache.get_or_build(DB, j, CPU)
    cache.get_or_build(DB, j, CPU)
    assert (cache.hits, cache.misses) == (1, 1)


def test_cache_rejects_second_database():
    cache = HashTableCache()
    cache.get_or_build(DB, Q21.joins[0], CPU)
    other = ssb.generate(sf=0.002, seed=99)
    with pytest.raises(ValueError, match="scoped to one Database"):
        cache.get_or_build(other, Q21.joins[0], CPU)


def test_bad_request_does_not_poison_batch():
    """A failing plan yields an errored QueryResult; the rest of the wave
    completes and the queue drains."""
    bad = (P.QueryBuilder("bad_payload").scan("lineorder")
           .hash_join("lo_orderdate", "date", "d_datekey",
                      payload=P.AffineExpr("d_year", 1, -1997), mult=50)
           .measure("lo_revenue").group_by(100).build())
    srv = server()
    r_good1 = srv.submit(Q11)
    r_bad = srv.submit(bad)
    r_good2 = srv.submit(QUERIES["q1.2"])
    results = srv.run()
    assert results[r_bad].result is None
    assert "negative" in results[r_bad].error
    for rid, name in ((r_good1, "q1.1"), (r_good2, "q1.2")):
        np.testing.assert_array_equal(results[rid].result, ORACLE[name])
    assert srv.queue == []
    assert srv.stats["errors"] == 1
    r_again = srv.submit(Q11)
    assert srv.run()[r_again].error is None


def test_nested_callable_payload_not_retained():
    cache = HashTableCache()
    plan = copy.deepcopy(QUERIES["q3.3"])
    plan.joins[0].payload = P.FlagExpr(
        lambda tb: np.asarray(tb["c_city"]) % 2 == 0)
    cache.get_or_build(DB, plan.joins[0], CPU)
    assert len(cache.tables) == 0


def test_callable_build_sides_are_not_retained():
    cache = HashTableCache()
    plan = copy.deepcopy(Q21)
    plan.joins[1].filter = lambda tb: np.ones(tb.n_rows, bool)
    for j in plan.joins:
        cache.get_or_build(DB, j, CPU)
    assert len(cache.tables) == 2       # supplier + date only
    assert cache.misses == 3


def test_auto_strategy_reports_model_choice():
    srv = server()
    ra = srv.submit(Q21, strategy="auto")
    rf = srv.submit(Q21, strategy="fused")
    results = srv.run()
    auto = results[ra]
    assert auto.model_choice in ("fused", "opat", "part")
    assert auto.strategy == auto.model_choice
    assert auto.predicted_s is not None and auto.predicted_s > 0
    assert set(auto.predictions) >= {"fused", "opat"}
    np.testing.assert_array_equal(auto.result, results[rf].result)
    assert srv.stats["auto"] == 1
    assert results[rf].model_choice is None
    ref = RefServer(REF_DB, mode="ref")
    rr = ref.submit(REF_QUERIES["q2.1"], strategy="auto")
    assert ref.run()[rr].model_choice == auto.model_choice


def test_server_survives_equal_data_reload():
    srv = server()
    r1 = srv.submit(Q21)
    out1 = srv.run()
    srv.db = ssb.from_numpy({t: {c: v.copy() for c, v in
                                 getattr(REF_DB, t).columns.items()}
                             for t in ssb.TABLES}, REF_DB.sf)
    r2 = srv.submit(Q21)
    out2 = srv.run()
    assert out2[r2].error is None
    assert out2[r2].cache_hits == 3
    np.testing.assert_array_equal(out1[r1].result, out2[r2].result)


def test_part_fallback_reason_reported_both_paths():
    srv = server()
    rp = srv.submit(Q11, strategy="part")
    rl = srv.submit(Q11, strategy="part_loop")
    results = srv.run()
    for rid in (rp, rl):
        assert results[rid].strategy == "opat"
        assert "no joins" in results[rid].fallback_reason
        assert results[rid].error is None
    assert srv.stats["fallbacks"] == 2
    assert srv.stats["opat"] == 2


def test_part_loop_requests_run_and_match():
    srv = server()
    rp = srv.submit(Q21, strategy="part")
    rl = srv.submit(Q21, strategy="part_loop")
    results = srv.run()
    assert results[rp].strategy == "part"
    assert results[rl].strategy == "part_loop"
    np.testing.assert_array_equal(results[rp].result, results[rl].result)
    assert srv.stats["part"] == 1 and srv.stats["part_loop"] == 1


def test_results_report_launch_config_per_family():
    srv = server()
    rids = {s: srv.submit(Q21, strategy=s)
            for s in ("fused", "part", "part_loop", "opat")}
    rs = srv.run()
    assert set(rs[rids["fused"]].launch_config) == {"spja"}
    assert set(rs[rids["part"]].launch_config) == {"part_probe"}
    assert set(rs[rids["part_loop"]].launch_config) == {"partition_multi"}
    assert set(rs[rids["opat"]].launch_config) == set()     # no filter
    ro = srv.submit(Q11, strategy="opat")       # fact filters only
    assert set(srv.run()[ro].launch_config) == {"select_scan"}
    srv.submit(Q21, strategy="shared")
    srv.submit(QUERIES["q2.2"], strategy="shared")
    wave = list(srv.run().values())
    assert all(set(r.launch_config) == {"multi_spja"} for r in wave)
    assert all(r.shared_wave_size == 2 for r in wave)


def test_server_default_is_the_card_in_auto_mode():
    import inspect
    sig = inspect.signature(QueryServer)
    assert sig.parameters["mode"].default == "auto"
    assert sig.parameters["device"].default is None
    assert server().device == CPU


def test_launch_config_names_each_familys_compiled_shape():
    """Each family's record names the threads a block its kernel is
    compiled with, the packed width and the knobs it ran at."""
    from repro_torch.sql import compile as C
    srv = server()
    rf = srv.submit(Q21, strategy="fused")
    rp = srv.submit(Q21, strategy="part")
    rs = srv.run()
    assert rs[rf].launch_config["spja"] == {
        "threads": C.LAUNCH_SHAPES["spja"], "width": 32}
    lc = rs[rp].launch_config["part_probe"]
    assert lc["threads"] == C.LAUNCH_SHAPES["part_probe"]
    assert lc["bits"] >= 1 and rs[rp].attempts == 1


# ---------------------------------------------------------------------------
# the wave budget: max_batch capped at the 64 members one launch takes
# ---------------------------------------------------------------------------


def test_max_batch_caps_at_max_members():
    srv = server(max_batch=1000)
    assert srv.max_batch == MF.MAX_MEMBERS
    # the 13-query wave is one launch
    for p in QUERIES.values():
        srv.submit(p, "shared")
    rs = srv.run()
    assert srv.stats["waves"] == 1
    assert {r.shared_wave_size for r in rs.values()} == {13}
    # past max_batch unique members a bucket splits
    small = server(max_batch=2)
    for n in ("q2.1", "q2.2", "q2.3"):
        small.submit(QUERIES[n], "shared")
    rs = small.run()
    assert small.stats["waves"] == 2
    assert sorted(r.shared_wave_size for r in rs.values()) == [1, 2, 2]
    for r in rs.values():
        np.testing.assert_array_equal(r.result, ORACLE[r.name])


def test_duplicates_dedup_without_splitting():
    srv = server(max_batch=2)
    for _ in range(5):
        srv.submit(Q21, "shared")
    rs = srv.run()
    assert srv.stats["waves"] == 1 and srv.stats["dedup_saved"] == 4
    assert {r.shared_wave_size for r in rs.values()} == {5}
    arrays = [r.result for r in rs.values()]
    assert all(a is not b for a in arrays for b in arrays if a is not b)


# ---------------------------------------------------------------------------
# out-of-core and sharded accounting (tests/test_morsel.py:441, :515;
# tests/test_shard.py:186-230)
# ---------------------------------------------------------------------------

PDB = ST.pack_database(DB)
BUDGET = PDB.lineorder.nbytes // 8


def test_server_reports_out_of_core_accounting():
    srv = server(PDB, morsel_bytes=BUDGET)
    rids = {n: srv.submit(p, strategy="fused") for n, p in QUERIES.items()}
    results = srv.run()
    for name, rid in rids.items():
        r = results[rid]
        assert r.error is None, (name, r.error)
        assert r.n_morsels > 1, name
        assert r.peak_resident_bytes <= 2 * BUDGET + 4 * 1024
        assert r.result.tobytes() == ORACLE[name].tobytes(), name
        assert r.bytes_scanned < r.bytes_scanned_plain


def test_server_shared_wave_reports_stream():
    srv = server(PDB, max_batch=16, morsel_bytes=BUDGET)
    rids = {n: srv.submit(p, strategy="shared") for n, p in QUERIES.items()}
    results = srv.run()
    for name, rid in rids.items():
        r = results[rid]
        assert r.error is None, (name, r.error)
        assert r.shared_wave_size == len(QUERIES)
        assert r.n_morsels > 1, name
        assert r.result.tobytes() == ORACLE[name].tobytes(), name


def test_server_shared_wave_routes_sharded():
    sdb = SH.shard_database(DB, 4)
    srv = server(sdb, max_batch=16)
    rids = {n: srv.submit(p, strategy="shared") for n, p in QUERIES.items()}
    results = srv.run()
    ref = RefServer(RSH.shard_database(REF_DB, 4), mode="ref", max_batch=16)
    rrids = {n: ref.submit(p, strategy="shared")
             for n, p in REF_QUERIES.items()}
    rres = ref.run()
    for name, rid in rids.items():
        r = results[rid]
        assert r.error is None, (name, r.error)
        assert r.result.tobytes() == ORACLE[name].tobytes(), name
        assert r.result.tobytes() == np.asarray(
            rres[rrids[name]].result, np.float32).tobytes(), name
        assert r.device_count == 4
        assert len(r.shard_times_s) == 4
    assert srv.stats["sharded_waves"] >= 1


def test_server_solo_sharded_request_reports_breakdown():
    sdb = SH.shard_database(DB, 2)
    srv = server(sdb)
    rid = srv.submit(QUERIES["q3.2"], strategy="sharded")
    r = srv.run()[rid]
    assert r.error is None
    assert r.strategy == "sharded"
    assert r.device_count == 2
    assert len(r.shard_times_s) == 2
    np.testing.assert_array_equal(r.result, ORACLE["q3.2"])


def test_server_auto_wave_on_sharded_db_is_correct():
    sdb = SH.shard_database(DB, 2)
    srv = server(sdb, max_batch=16)
    rids = {n: srv.submit(p, strategy="auto") for n, p in QUERIES.items()}
    results = srv.run()
    for name, rid in rids.items():
        r = results[rid]
        assert r.error is None, (name, r.error)
        np.testing.assert_array_equal(r.result, ORACLE[name])
        assert r.model_choice in ("shared", "shared_sharded", "fused",
                                  "opat", "part", "sharded")


def test_server_on_plain_db_never_reports_devices():
    srv = server()
    rid = srv.submit(QUERIES["q1.2"], strategy="fused")
    r = srv.run()[rid]
    assert r.device_count is None and r.shard_times_s is None


# ---------------------------------------------------------------------------
# taxonomy / classification (tests/test_resilience.py)
# ---------------------------------------------------------------------------


def test_taxonomy_hierarchy():
    assert issubclass(RS.PlanError, RS.QueryError)
    assert issubclass(RS.FaultInjected, RS.ExecError)
    assert issubclass(RS.InjectedOOM, RS.MemoryPressure)
    assert RS.ExecError("x").retryable
    assert RS.MemoryPressure("x").retryable
    assert not RS.PlanError("x").retryable
    assert not RS.CompileError("x").retryable
    assert not RS.DeadlineExceeded("x").retryable
    assert RS.ExecError("x").kind == "ExecError"


def test_classify_wraps_and_chains_cause():
    orig = RuntimeError("kernel blew up")
    err = RS.classify_error(orig)
    assert isinstance(err, RS.ExecError)
    assert err.__cause__ is orig
    assert isinstance(RS.classify_error(ValueError("negative payload")),
                      RS.PlanError)
    oom = RS.classify_error(RuntimeError("RESOURCE_EXHAUSTED: oom"))
    assert isinstance(oom, RS.MemoryPressure)
    e = RS.ExecError("already typed")
    assert RS.classify_error(e) is e
    assert isinstance(RS.classify_error(RuntimeError("x"), "compile"),
                      RS.CompileError)
    assert isinstance(RS.classify_error(RuntimeError("x"), "plan"),
                      RS.PlanError)


def test_torch_out_of_memory_is_memory_pressure():
    """torch's own allocation failure, as the card raises it, maps to
    ``MemoryPressure`` with no special case."""
    msg = ("CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 "
           "GiB total capacity; 77.50 GiB already allocated)")
    err = RS.classify_error(torch.OutOfMemoryError(msg))
    assert isinstance(err, RS.MemoryPressure) and err.retryable
    assert isinstance(err.__cause__, torch.OutOfMemoryError)
    assert RS._OOM_MARKERS == ("resource_exhausted", "out of memory",
                               "allocation fail", "oom", "cannot allocate")


def test_errorinfo_stringifies_and_supports_substring():
    err = RS.ExecError("boom at morsel 3")
    info = RS.ErrorInfo.from_exception(err, strategy="fused", attempts=2)
    assert info.error_kind == "ExecError"
    assert info.strategy == "fused" and info.attempts == 2
    assert str(info) == "ExecError: boom at morsel 3"
    assert "morsel 3" in info
    assert info.exception is err
    assert info == "ExecError: boom at morsel 3"
    assert info == RS.ErrorInfo("ExecError", "boom at morsel 3")


def test_ladders_match_the_reference():
    from repro.sql import resilience as RRS
    for s in ("sharded", "shared", "fused", "part", "part_loop", "opat",
              "auto", "ref", "unknown"):
        assert RS.ladder_for(s) == RRS.ladder_for(s)
        assert RS.ladder_for(s)[-1] == "ref"
    assert (RS.BACKOFF_BASE_S, RS.BACKOFF_CAP_S) == \
        (RRS.BACKOFF_BASE_S, RRS.BACKOFF_CAP_S)


# ---------------------------------------------------------------------------
# fault-plan determinism
# ---------------------------------------------------------------------------


def test_fault_plan_deterministic_per_site():
    def draw(seed, site, n):
        p = faults.FaultPlan(seed, {site: 0.3})
        return [p.should_fault(site) for _ in range(n)]

    assert draw(7, "kernel", 200) == draw(7, "kernel", 200)
    assert draw(7, "kernel", 200) != draw(8, "kernel", 200)
    p = faults.FaultPlan(7, {"kernel": 0.3, "build": 0.3})
    mixed = []
    for _ in range(200):
        p.should_fault("build")
        mixed.append(p.should_fault("kernel"))
    assert mixed == draw(7, "kernel", 200)


def test_fault_plan_rates_and_oom_every():
    p = faults.FaultPlan(3, {"kernel": 1.0}, oom_every=3)
    kinds = []
    for _ in range(6):
        with pytest.raises(RS.QueryError) as ei:
            p.fault("kernel")
        kinds.append(type(ei.value))
    assert kinds == [RS.FaultInjected, RS.FaultInjected, RS.InjectedOOM] * 2
    q = faults.FaultPlan(3, {"kernel": 0.0})
    assert not any(q.should_fault("kernel") for _ in range(100))
    assert not any(q.should_fault("upload") for _ in range(100))


def test_maybe_fault_noop_without_plan():
    faults.install(None)
    faults.maybe_fault("kernel")


# ---------------------------------------------------------------------------
# deadline / backoff / breaker primitives
# ---------------------------------------------------------------------------


def test_deadline_remaining_and_unbounded():
    d = RS.Deadline(None)
    assert d.remaining() == float("inf") and not d.expired()
    assert RS.Deadline(0.0).expired()


def test_backoff_capped_exponential():
    vals = [RS.backoff_s(i) for i in range(10)]
    assert vals[0] == RS.BACKOFF_BASE_S
    assert all(b >= a for a, b in zip(vals, vals[1:]))
    assert vals[-1] == RS.BACKOFF_CAP_S


def test_sleep_backoff_clamped_to_deadline():
    t0 = time.monotonic()
    RS.sleep_backoff(10, RS.Deadline(0.0))          # expired: no sleep
    RS.sleep_backoff(10, RS.Deadline(0.01))
    assert time.monotonic() - t0 < RS.BACKOFF_CAP_S


def test_circuit_breaker_open_halfopen_close():
    br = RS.CircuitBreaker(threshold=3, cooldown_s=0.02)
    assert br.allow()
    for _ in range(3):
        br.record_failure()
    assert br.state == "open" and not br.allow()
    time.sleep(0.025)
    assert br.allow()                       # half-open: one probe
    assert not br.allow()
    br.record_failure()                     # a failed probe re-opens
    assert br.state == "open"
    time.sleep(0.025)
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_board_snapshot():
    board = RS.BreakerBoard(threshold=1)
    board.get("fused", "auto").record_failure()
    board.get("opat", "auto")
    assert board.snapshot() == {("fused", "auto"): "open",
                                ("opat", "auto"): "closed"}


def test_fit_in_budget():
    preds = {"fused": 0.5, "opat": 2.0}
    assert RS.fit_in_budget(preds, "fused", 1.0)
    assert not RS.fit_in_budget(preds, "opat", 1.0)
    assert RS.fit_in_budget(preds, "ref", 1.0)
    assert RS.fit_in_budget(None, "opat", 0.0)


# ---------------------------------------------------------------------------
# the ladder on the server
# ---------------------------------------------------------------------------


def test_ladder_degrades_to_typed_success():
    """Every device-touching site faults on every visit: the ladder walks
    all 13 queries down to the host oracle, bit-identical to it."""
    with faults.active(faults.FaultPlan(
            seed=2, rates={"kernel": 1.0, "build": 1.0, "upload": 1.0})):
        srv = server()
        rids = {srv.submit(p, "auto"): p for p in QUERIES.values()}
        res = srv.run()
    for rid, plan in rids.items():
        r = res[rid]
        assert r.error is None, (plan.name, str(r.error))
        assert r.strategy == "ref"
        assert r.launch_config is None
        assert np.array_equal(r.result, ORACLE[plan.name]), plan.name
    assert max(res[rid].attempts for rid in rids) > 1
    assert srv.stats["breaker_skips"] >= 1
    assert srv.stats["retries"] >= 1


def test_ladder_partial_degradation_prefers_early_rung():
    """Only the kernel site faults: a no-join query lands on opat (its
    chain has no probe), not on ref."""
    with faults.active(faults.FaultPlan(seed=5, rates={"kernel": 1.0})):
        srv = server()
        rid = srv.submit(Q11, "fused")
        r = srv.run()[rid]
    assert r.error is None
    assert r.strategy == "opat" and r.attempts == 2
    assert np.array_equal(r.result, ORACLE["q1.1"])
    assert srv.stats["retries"] == 1


def test_plan_error_not_retried():
    bad = (P.QueryBuilder("bad").scan("lineorder")
           .hash_join("lo_suppkey", "supplier", "s_suppkey",
                      payload=P.AffineExpr("s_suppkey", 1, -999999))
           .measure("lo_revenue").group_by(1).build())
    srv = server()
    rid = srv.submit(bad, "fused")
    r = srv.run()[rid]
    assert r.error is not None
    assert r.error.error_kind == "PlanError"
    assert "negative" in r.error
    assert r.attempts == 1
    assert r.error.exception.__cause__ is not None


def test_deadline_exceeded_is_typed_and_prompt():
    with faults.active(faults.FaultPlan(
            seed=4, rates={"kernel": 1.0, "build": 1.0})):
        srv = server()
        rid = srv.submit(Q21, "fused", deadline_s=1e-6)
        t0 = time.monotonic()
        r = srv.run()[rid]
        dt = time.monotonic() - t0
    assert r.error is not None
    assert r.error.error_kind == "DeadlineExceeded"
    assert dt < 1e-6 + RS.BACKOFF_CAP_S + 2.0


def test_budget_skips_rungs_the_model_prices_past_the_deadline(
        monkeypatch):
    """After a fault, a rung the model predicts past the remaining budget
    is skipped (``stats["budget_skips"]``)."""
    from repro_torch.sql import model as M
    monkeypatch.setattr(M, "predict", lambda *a, **k: {"fused": 1e-9,
                                                       "opat": 1e9})
    with faults.active(faults.FaultPlan(seed=5, rates={"kernel": 1.0})):
        srv = server()
        rid = srv.submit(Q11, "fused", deadline_s=30.0)
        r = srv.run()[rid]
    assert r.error is None and r.strategy == "ref"
    assert srv.stats["budget_skips"] == 1


def test_breaker_opens_and_skips_poisoned_strategy():
    with faults.active(faults.FaultPlan(seed=6, rates={"kernel": 1.0})):
        srv = server(breaker_threshold=2, breaker_cooldown_s=60.0)
        for _ in range(3):
            rid = srv.submit(Q11, "fused")
            r = srv.run()[rid]
            assert r.error is None
    assert srv.breakers.get("fused", "ref").state == "open"
    assert srv.stats["breaker_skips"] >= 1
    assert r.attempts == 1


def test_wave_fault_reenters_members_solo():
    plans = [QUERIES["q2.1"], QUERIES["q2.2"], QUERIES["q2.3"]]
    with faults.active(faults.FaultPlan(seed=9, rates={"kernel": 1.0})):
        srv = server()
        rids = {srv.submit(p, "shared"): p for p in plans}
        res = srv.run()
    assert srv.stats["wave_reentries"] >= 1
    for rid, plan in rids.items():
        r = res[rid]
        assert r.error is None, (plan.name, str(r.error))
        assert np.array_equal(r.result, ORACLE[plan.name]), plan.name


def test_member_build_fault_leaves_the_wave():
    """A build fault on one member's side takes that member out of the
    wave (it re-enters the ladder solo); the rest still share a pass."""
    class FailFirstBuild(faults.FaultPlan):
        def __init__(self):
            super().__init__(0, {"build": 1.0})
            self.n = 0

        def should_fault(self, site):
            if site != "build":
                return False
            self.n += 1
            return self.n == 1

    plans = [QUERIES["q2.1"], QUERIES["q3.1"], QUERIES["q4.1"]]
    with faults.active(FailFirstBuild()):
        srv = server()
        rids = {srv.submit(p, "shared"): p for p in plans}
        res = srv.run()
    assert srv.stats["member_reentries"] == 1
    sizes = sorted(r.shared_wave_size or 0 for r in res.values())
    assert sizes[-1] == 2
    for rid, plan in rids.items():
        np.testing.assert_array_equal(res[rid].result, ORACLE[plan.name])


def test_no_cross_request_contamination_under_faults():
    srv = server()
    with faults.active(faults.FaultPlan(
            seed=2, rates={"kernel": 1.0, "build": 1.0})):
        srv.submit(Q21, "fused")
        srv.run()
    rid2 = srv.submit(Q21, "fused")
    r2 = srv.run()[rid2]
    assert r2.error is None
    assert r2.strategy == "fused"
    assert np.array_equal(r2.result, ORACLE["q2.1"])


# ---------------------------------------------------------------------------
# resource governor
# ---------------------------------------------------------------------------


def test_governor_halves_morsels_with_lane_floor():
    g = RS.ResourceGovernor(1 << 20)
    sizes = []
    for _ in range(40):
        g.on_pressure()
        sizes.append(g.morsel_bytes)
    assert sizes[0] == (1 << 19)
    assert all(b % 32 == 0 for b in sizes)
    assert sizes[-1] == g._floor
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))
    assert g._floor >= 32


def test_governor_evicts_cache_and_decode_memos():
    pdb = ST.pack_database(DB)
    cache = HashTableCache()
    for j in Q21.joins:
        cache.get_or_build(pdb, j, CPU)
    pdb.lineorder.columns["lo_revenue"].decode()
    pdb.lineorder.on_device("lo_revenue", CPU)
    assert len(cache.tables) >= 3
    g = RS.ResourceGovernor(1 << 20)
    g.on_pressure(db=pdb, cache=cache)
    assert len(cache.tables) <= 2           # keep=2 most recent
    assert pdb.lineorder.columns["lo_revenue"]._decoded is None
    assert pdb.lineorder.resident_bytes(CPU) == 0
    assert g.evictions > 0
    m0 = cache.misses
    cache.get_or_build(pdb, Q21.joins[0], CPU)
    assert cache.misses >= m0


def test_admission_shed_past_high_water():
    srv = server()
    for _ in range(srv.governor.high_water):
        srv.governor.on_pressure()
    with pytest.raises(RS.MemoryPressure):
        srv.submit(Q11, "fused")
    assert srv.stats["sheds"] == 1
    srv.governor.on_success()
    rid = srv.submit(Q11, "fused")
    assert srv.run()[rid].error is None


def test_shed_latch_half_opens_after_cooldown():
    """Past the high-water mark the door stays shut until
    ``SHED_COOLDOWN_S`` passes with no new pressure event; then requests
    are admitted, and one more event latches it again."""
    srv = server()
    gov = srv.governor
    for _ in range(gov.high_water + 1):
        gov.on_pressure()
    with pytest.raises(RS.MemoryPressure):
        srv.submit(Q11, "fused")
    gov._last_pressure -= RS.SHED_COOLDOWN_S
    rid = srv.submit(Q11, "fused")
    srv.submit(Q21, "fused")                # still open before an event
    assert gov.consecutive == gov.high_water - 1
    gov.on_pressure()
    with pytest.raises(RS.MemoryPressure):
        srv.submit(Q11, "fused")
    assert srv.run()[rid].error is None and gov.consecutive == 0


def test_injected_oom_triggers_governor_and_recovers():
    plan = faults.FaultPlan(seed=1, rates={"kernel": 1.0}, oom_every=1)
    mb0 = 1 << 20
    with faults.active(plan):
        srv = server(morsel_bytes=mb0)
        rid = srv.submit(Q11, "fused")
        r = srv.run()[rid]
    assert r.error is None
    assert srv.stats["pressure_events"] >= 1
    assert srv.governor.morsel_bytes < mb0
    assert np.array_equal(r.result, ORACLE["q1.1"])


def test_torch_oom_in_a_kernel_triggers_the_governor(monkeypatch):
    """A real ``torch.OutOfMemoryError`` out of the fused kernel: the
    governor halves the morsels, the rung is retried once, then the
    request degrades and still answers."""
    from repro_torch.kernels import ops
    calls = []

    def oom(*a, **k):
        calls.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 1.00 GiB")

    monkeypatch.setattr(ops, "spja", oom)
    srv = server(morsel_bytes=1 << 20)
    rid = srv.submit(Q21, "fused")
    r = srv.run()[rid]
    assert len(calls) == 2                  # the rung, then its one retry
    assert srv.stats["pressure_events"] == 2
    assert srv.governor.morsel_bytes == 1 << 18
    assert r.error is None and r.strategy == "opat"
    np.testing.assert_array_equal(r.result, ORACLE["q2.1"])


# ---------------------------------------------------------------------------
# ingest atomicity
# ---------------------------------------------------------------------------


def _delta_rows_dict(table, n, seed):
    rng = np.random.default_rng(seed)
    return {c: rng.integers(1, 100, n).astype(np.int32)
            for c in table.columns}


def test_append_rows_atomic_under_injected_fault():
    lo = ST.pack_database(ssb.generate(sf=0.005, seed=3)).lineorder
    ST.append_rows(lo, _delta_rows_dict(lo, 64, seed=0))
    before = ST.delta_batches(lo)
    assert len(before) == 1

    class Fail3(faults.FaultPlan):
        def __init__(self):
            super().__init__(0, {"ingest": 1.0})
            self.n = 0

        def should_fault(self, site):
            self.n += 1
            return self.n == 3

    with faults.active(Fail3()):
        with pytest.raises(RS.QueryError):
            ST.append_rows(lo, _delta_rows_dict(lo, 64, seed=1))
    after = ST.delta_batches(lo)
    assert len(after) == 1 and after[0] is before[0]
    assert ST.delta_rows(lo) == 64
    ST.append_rows(lo, _delta_rows_dict(lo, 32, seed=2))
    assert ST.delta_rows(lo) == 96


def test_flush_deltas_atomic_under_injected_fault():
    lo = ST.pack_database(ssb.generate(sf=0.005, seed=3)).lineorder
    ST.append_rows(lo, _delta_rows_dict(lo, 64, seed=0))
    base_rows = lo.n_rows

    class FailLate(faults.FaultPlan):
        def __init__(self):
            super().__init__(0, {"ingest": 1.0})
            self.n = 0

        def should_fault(self, site):
            self.n += 1
            return self.n == 5

    with faults.active(FailLate()):
        with pytest.raises(RS.QueryError):
            ST.flush_deltas(lo)
    assert ST.delta_rows(lo) == 64
    assert lo.n_rows == base_rows
    flushed = ST.flush_deltas(lo)
    assert flushed.n_rows == base_rows + 64
    assert ST.delta_rows(flushed) == 0


def test_append_rows_validation_still_raises_plain():
    lo = ST.pack_database(ssb.generate(sf=0.005, seed=3)).lineorder
    with pytest.raises(ValueError, match="columns"):
        ST.append_rows(lo, {"nope": np.zeros(4, np.int32)})


def test_ref_rung_sees_pending_deltas():
    """The oracle rung folds the fact table's pending deltas in, so it
    answers over the rows every engine path scans."""
    pdb = ST.pack_database(ssb.generate(sf=0.005, seed=3))
    ST.append_rows(pdb.lineorder, _delta_rows_dict(pdb.lineorder, 64, 0))
    srv = server(pdb)
    flushed = ST.flush_deltas(pdb.lineorder)
    import dataclasses
    want = engine.run_query_oracle(
        dataclasses.replace(pdb, lineorder=flushed), Q11)
    np.testing.assert_array_equal(srv._run_ref(Q11), want)


# ---------------------------------------------------------------------------
# calibration torn-cache recovery (tests/test_resilience.py:442-479)
# ---------------------------------------------------------------------------


def _fake_calib():
    return CAL.Calibration(backend="cpu", read_bw=1e10, write_bw=5e9,
                           cache_bw=2e10, launch_overhead_s=1e-5,
                           measured_at=0.0)


@pytest.mark.parametrize("torn", [
    "{\"backend\": \"cpu\", \"read_bw\": 1e10, \"wri",   # truncated
    "not json at all",
    "3",                                                 # wrong shape
    "{}",                                                # missing fields
])
def test_torn_calibration_cache_discarded_and_remeasured(
        tmp_path, monkeypatch, torn, caplog):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    CAL._MEMO.clear()
    path = CAL.cache_path(CPU)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(torn)
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.sql.calibrate"):
        assert CAL.load_cached(CPU) is None
    assert "corrupt calibration cache" in caplog.text
    assert not os.path.exists(path)
    CAL._MEMO.clear()
    monkeypatch.setattr(CAL, "measure", lambda device=None: _fake_calib())
    with open(path, "w") as f:
        f.write(torn)
    hw = CAL.calibrated_hardware(CM.PAPER_CPU, CPU)
    assert hw.read_bw == 1e10
    CAL._MEMO.clear()
    loaded = CAL.load_cached(CPU)
    assert loaded is not None and loaded.read_bw == 1e10
    CAL._MEMO.clear()


def test_good_calibration_cache_still_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    CAL._MEMO.clear()
    CAL.save(_fake_calib())
    CAL._MEMO.clear()
    loaded = CAL.load_cached(CPU)
    assert loaded is not None and loaded.read_bw == 1e10
    CAL._MEMO.clear()


# ---------------------------------------------------------------------------
# on a card: a kernel's failure is typed at once, and no rung is the host
# (the server's ``on_card`` is set by hand so the CPU runs the card's rules)
# ---------------------------------------------------------------------------


def card_server(**kw):
    srv = server(**kw)
    srv.on_card = True
    return srv


@pytest.mark.parametrize("strategy", ["sharded", "shared", "fused", "part",
                                      "part_loop", "opat", "auto"])
def test_ladder_on_card_has_no_host_rung(strategy):
    cpu = RS.ladder_for(strategy)
    card = RS.ladder_for(strategy, on_card=True)
    assert cpu[-1] == "ref" and "ref" not in card
    assert card == tuple(r for r in cpu if r != "ref")
    assert RS.ladder_for("ref", on_card=True) == ("ref",)   # asked for


@pytest.mark.parametrize("exc,kind", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "DeviceError"),
    (RuntimeError("nvcc failed: ptxas error"), "DeviceError"),
    (RuntimeError("out of memory"), "DeviceError"),     # by type on a card
    (torch.OutOfMemoryError("CUDA out of memory"), "MemoryPressure"),
    (ValueError("negative payload"), "PlanError"),
    (RS.FaultInjected("injected"), "FaultInjected"),
    (RS.InjectedOOM("injected"), "InjectedOOM")])
def test_classify_on_card(exc, kind):
    err = RS.classify_error(exc, on_card=True)
    assert err.kind == kind
    assert err.retryable == (kind in ("MemoryPressure", "FaultInjected",
                                      "InjectedOOM"))
    if not isinstance(exc, RS.QueryError):
        assert err.__cause__ is exc


@pytest.mark.parametrize("strategy", ["fused", "auto", "shared"])
def test_kernel_failure_on_card_is_a_device_error(monkeypatch, strategy):
    """A kernel that fails to launch ends its request in a ``DeviceError``
    on the first attempt: no rung after it, no retry, no fallback."""
    from repro_torch.kernels import ops

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    for name in ("spja", "multi_spja", "select_scan", "probe_join",
                 "part_join"):
        monkeypatch.setattr(ops, name, broken)
    srv = card_server()
    rid = srv.submit(Q21, strategy)
    r = srv.run()[rid]
    assert r.result is None and r.error.error_kind == "DeviceError"
    assert r.attempts == 1 and "illegal memory access" in r.error
    assert srv.stats["retries"] == srv.stats["fallbacks"] == 0
    assert srv.stats["ref"] == 0


def test_wave_kernel_failure_on_card_ends_every_member(monkeypatch):
    """The wave kernel's failure on a card ends every member of the wave
    in the typed error; on the CPU the same fault re-enters them solo."""
    from repro_torch.kernels import ops

    def broken(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(ops, "multi_spja", broken)
    plans = [QUERIES["q2.1"], QUERIES["q2.2"], QUERIES["q3.1"]]
    srv = card_server()
    rids = [srv.submit(p, "shared") for p in plans]
    res = srv.run()
    assert srv.stats["wave_reentries"] == 0
    for rid in rids:
        assert res[rid].error.error_kind == "DeviceError"
        assert res[rid].strategy == "shared"
    cpu = server()
    rids = {cpu.submit(p, "shared"): p for p in plans}
    res = cpu.run()
    assert cpu.stats["wave_reentries"] == 1
    for rid, plan in rids.items():
        np.testing.assert_array_equal(res[rid].result, ORACLE[plan.name])


def test_injected_faults_on_card_never_reach_the_host():
    """Injected kernel and upload faults stay retryable on a card: each
    request ends in the oracle's answer from a rung on the card, or in a
    typed error; none is answered by ``ref``."""
    plan = faults.FaultPlan(5, {"kernel": 0.5, "upload": 0.3})
    with faults.active(plan):
        srv = card_server()
        rids = {srv.submit(p, s): p for p in QUERIES.values()
                for s in ("fused", "auto")}
        res = srv.run()
    assert srv.stats["ref"] == 0
    answered = 0
    for rid, p in rids.items():
        r = res[rid]
        assert r.strategy != "ref"
        if r.error is None:
            answered += 1
            np.testing.assert_array_equal(r.result, ORACLE[p.name])
        else:
            assert r.error.error_kind in ("FaultInjected", "InjectedOOM",
                                          "ExecError")
    assert answered > 0 and srv.stats["retries"] > 0


# ---------------------------------------------------------------------------
# the cost model's statistics memo (model.stats_memo)
# ---------------------------------------------------------------------------


def test_stats_memo_prices_alike_and_computes_once(monkeypatch):
    from repro_torch.sql import model as M
    plans = [QUERIES[n] for n in ("q2.1", "q3.1", "q4.1")]
    want = M.predict_shared(plans, DB, hw=M.HOST)
    calls = []
    inner = M._plan_stats
    monkeypatch.setattr(M, "_plan_stats",
                        lambda *a: calls.append(1) or inner(*a))
    memo: dict = {}
    with M.stats_memo(memo):
        assert M.predict_shared(plans, DB, hw=M.HOST) == want
        n = len(calls)
        assert M.predict_shared(plans, DB, hw=M.HOST) == want
        assert M.predict_marginal(plans, DB, hw=M.HOST)["shared"] == \
            want["shared"]
    assert n == len(plans) and len(calls) == n
    # outside the block nothing is memoized
    M.predict_shared(plans, DB, hw=M.HOST)
    assert len(calls) == 2 * n


def test_stats_memo_sees_new_tables():
    """A flushed or replaced table is a new key: its statistics are
    computed anew, never read from the old table's entry."""
    from dataclasses import replace as dc_replace
    from repro_torch.sql import model as M
    plan = QUERIES["q2.1"]
    memo: dict = {}
    with M.stats_memo(memo):
        a = M.plan_stats(plan, DB)
        half = ssb.Table("lineorder", {
            c: v[: DB.lineorder.n_rows // 2]
            for c, v in DB.lineorder.columns.items()})
        b = M.plan_stats(plan, dc_replace(DB, lineorder=half))
    assert a.n_fact == DB.lineorder.n_rows
    assert b.n_fact == DB.lineorder.n_rows // 2


def test_server_keeps_the_model_memo_across_runs():
    srv = server()
    for _ in range(2):
        for p in QUERIES.values():
            srv.submit(p, "auto")
        rs = srv.run()
        for r in rs.values():
            np.testing.assert_array_equal(r.result, ORACLE[r.name])
    n = len(srv.model_memo)
    assert n > 0
    for p in QUERIES.values():
        srv.submit(p, "auto")
    srv.run()
    assert len(srv.model_memo) == n
