"""The port's serving loop (``repro_torch.sql.serving``) on the CPU, held
to the reference's ``tests/test_serving.py`` and to the reference package
itself.

The policy pieces are pure: ``poisson_arrivals`` is the reference's
schedule under the same seed, the ``WaveFormer`` is driven with a fake
predictor and explicit clocks, and ``model.predict_marginal`` is checked
against the in-wave dedup invariant.  The threaded ``ServingLoop`` is
then run end to end (``mode="ref", device="cpu"``; the loop runs on the
card unless the caller names the CPU): every response — executed,
exact-cached or subsumption-served — bit-identical to the numpy oracle,
drain on stop, admission shedding, queue-expired deadlines, the
footprint anchor, prewarm, and a Poisson-driven run in which waves form.
Every wait, stop and join has a timeout, so a hang fails the test.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro.sql import engine as RE
from repro.sql import serving as RSV
from repro.sql import ssb as RSSB
from repro_torch.sql import compile as C
from repro_torch.sql import engine, ssb
from repro_torch.sql import model as M
from repro_torch.sql import resilience as RS
from repro_torch.sql import serving as SV
from repro_torch.sql.result_cache import ResultCache

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
QUERIES = engine.ssb_queries()
POOL = list(QUERIES.values())
CPU = torch.device("cpu")
WAIT = 120


def oracle(plan):
    return np.asarray(engine.run_query_oracle(DB, plan))


def loop_on_cpu(**kw):
    return SV.ServingLoop(DB, mode="ref", device=CPU, **kw)


# ---------------------------------------------------------------------------
# poisson arrivals
# ---------------------------------------------------------------------------


def test_poisson_arrivals_deterministic_under_seed():
    a = SV.poisson_arrivals(50.0, 64, seed=7)
    b = SV.poisson_arrivals(50.0, 64, seed=7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, SV.poisson_arrivals(50.0, 64, seed=8))
    # the reference's schedule, bit for bit
    np.testing.assert_array_equal(a, RSV.poisson_arrivals(50.0, 64, seed=7))


def test_poisson_arrivals_shape_and_rate():
    sched = SV.poisson_arrivals(100.0, 2000, seed=3, start=5.0)
    assert sched.shape == (2000,)
    assert np.all(np.diff(sched) >= 0) and sched[0] >= 5.0
    assert abs(np.diff(sched).mean() - 0.01) < 0.0015


def test_poisson_arrivals_rejects_bad_rate():
    with pytest.raises(ValueError):
        SV.poisson_arrivals(0.0, 4, seed=1)


# ---------------------------------------------------------------------------
# wave former policy (fake predictor, explicit clock)
# ---------------------------------------------------------------------------


class FakePredictor:
    def __init__(self, shared_s=0.01, gain=1.0):
        self._shared = shared_s
        self._gain = gain

    def shared_s(self, plans):
        return self._shared

    def marginal_gain(self, plans):
        return self._gain


def ticket(rid, arrival, deadline_s=None):
    return SV.Ticket(rid, POOL[rid % len(POOL)], "auto", deadline_s,
                     arrival)


def test_former_holds_while_marginal_gain_pays():
    f = SV.WaveFormer(FakePredictor(shared_s=0.01, gain=10.0),
                      slo_s=10.0, max_batch=8, max_hold_s=60.0)
    f.add(ticket(0, arrival=0.0), now=0.0)
    f.add(ticket(1, arrival=0.1), now=0.1)
    assert f.decide(now=0.2, expected_gap=0.05) is None
    assert len(f.pending) == 2


def test_former_dispatches_on_economics():
    f = SV.WaveFormer(FakePredictor(shared_s=0.01, gain=0.001),
                      slo_s=10.0, max_batch=8, max_hold_s=60.0)
    f.add(ticket(0, arrival=0.0), now=0.0)
    f.add(ticket(1, arrival=0.1), now=0.1)
    wave = f.decide(now=0.2, expected_gap=0.05)
    assert wave is not None and len(wave) == 2
    assert f.dispatch_reasons == {"economics": 1}


def test_former_deadline_near_ticket_dispatches_alone():
    f = SV.WaveFormer(FakePredictor(shared_s=0.2, gain=100.0),
                      slo_s=10.0, max_batch=8, safety=1.5,
                      max_hold_s=60.0)
    f.add(ticket(0, arrival=0.0, deadline_s=0.25), now=0.0)
    wave = f.decide(now=0.0, expected_gap=0.01)
    assert wave is not None and len(wave) == 1
    assert f.dispatch_reasons == {"deadline": 1}


def test_former_dispatches_when_slack_below_expected_gap():
    f = SV.WaveFormer(FakePredictor(shared_s=0.01, gain=100.0),
                      slo_s=0.5, max_batch=8, max_hold_s=60.0)
    f.add(ticket(0, arrival=0.0), now=0.0)
    assert f.decide(now=0.4, expected_gap=1.0) is not None
    assert f.dispatch_reasons == {"deadline": 1}


def test_former_full_wave_dispatches():
    f = SV.WaveFormer(FakePredictor(gain=100.0), slo_s=10.0, max_batch=4)
    for i in range(5):
        f.add(ticket(i, arrival=0.0), now=0.0)
    wave = f.decide(now=0.0, expected_gap=0.01)
    assert [t.rid for t in wave] == [0, 1, 2, 3]
    assert len(f.pending) == 1
    assert f.dispatch_reasons == {"full": 1}


def test_former_unknown_rate_never_holds():
    f = SV.WaveFormer(FakePredictor(gain=100.0), slo_s=10.0,
                      max_batch=8, max_hold_s=60.0)
    f.add(ticket(0, arrival=0.0), now=0.0)
    assert f.decide(now=0.0, expected_gap=math.inf) is not None
    assert f.dispatch_reasons == {"unknown_rate": 1}


def test_former_hold_cap_expires():
    f = SV.WaveFormer(FakePredictor(shared_s=0.01, gain=100.0),
                      slo_s=10.0, max_batch=8, max_hold_s=0.2)
    f.add(ticket(0, arrival=0.0), now=0.0)
    assert f.decide(now=0.1, expected_gap=0.05) is None
    assert f.decide(now=0.21, expected_gap=0.05) is not None
    assert f.dispatch_reasons == {"hold_cap": 1}


def test_former_drain_flushes_everything():
    f = SV.WaveFormer(FakePredictor(gain=100.0), slo_s=10.0, max_batch=2)
    for i in range(3):
        f.add(ticket(i, arrival=0.0), now=0.0)
    waves = []
    while True:
        w = f.decide(now=0.0, expected_gap=0.01, draining=True)
        if not w:
            break
        waves.append(w)
    assert [len(w) for w in waves] == [2, 1] and not f.pending


def test_former_next_wakeup_tracks_hold_cap_and_slack():
    f = SV.WaveFormer(FakePredictor(shared_s=0.0, gain=100.0),
                      slo_s=10.0, max_batch=8, max_hold_s=0.25)
    assert f.next_wakeup(now=0.0) is None
    f.add(ticket(0, arrival=0.0), now=0.0)
    assert f.next_wakeup(now=0.0) == pytest.approx(0.25)
    f2 = SV.WaveFormer(FakePredictor(shared_s=0.0, gain=100.0),
                       slo_s=0.1, max_batch=8, max_hold_s=60.0)
    f2.add(ticket(0, arrival=0.0), now=0.0)
    assert f2.next_wakeup(now=0.0) == pytest.approx(0.1)


def test_arrival_tracker_ewma():
    tr = SV._ArrivalTracker(alpha=0.5)
    assert tr.expected_gap() == math.inf
    for now in (0.0, 1.0, 3.0):
        tr.note(now)
    assert tr.expected_gap() == pytest.approx(0.5 * 2.0 + 0.5 * 1.0)


def test_predictor_memoizes_and_prices_on_its_hardware():
    p = SV.SharedWavePredictor(DB, hw=M.HOST)
    plans = [QUERIES["q2.1"], QUERIES["q3.1"]]
    s = p.shared_s(plans)
    assert s == pytest.approx(M.predict_shared(plans, DB,
                                               hw=M.HOST)["shared"])
    assert p.shared_s(list(reversed(plans))) == s      # one composition
    assert len(p._shared) == 1 and p.model_calls == 1
    assert p.marginal_gain(plans) == pytest.approx(
        M.predict_marginal(plans, DB, hw=M.HOST)["gain"])
    assert p.model_calls == 2 and p.model_s > 0


# ---------------------------------------------------------------------------
# marginal cost model
# ---------------------------------------------------------------------------


def test_predict_marginal_duplicate_member_is_free():
    plans = [QUERIES["q2.1"], QUERIES["q3.1"]]
    out = M.predict_marginal(plans, DB, hw=M.HOST,
                             candidate=QUERIES["q2.1"])
    assert out["marginal_cost"] == pytest.approx(0.0, abs=1e-9)
    assert out["gain"] == pytest.approx(out["solo"], rel=1e-6)


def test_predict_marginal_new_member_costs_less_than_solo():
    plans = [QUERIES["q2.1"], QUERIES["q2.2"]]
    out = M.predict_marginal(plans, DB, hw=M.HOST,
                             candidate=QUERIES["q3.1"])
    assert 0.0 < out["marginal_cost"] < out["solo"]
    assert out["gain"] == pytest.approx(out["solo"] - out["marginal_cost"])


def test_governor_pressure_clears_result_cache():
    rc = ResultCache()
    assert rc.insert(DB, QUERIES["q2.1"], oracle(QUERIES["q2.1"]))
    gov = RS.ResourceGovernor(1 << 20)
    before = gov.evictions
    gov.on_pressure(result_cache=rc)
    assert len(rc) == 0
    assert gov.evictions > before


# ---------------------------------------------------------------------------
# serving loop end to end
# ---------------------------------------------------------------------------


def test_serving_loop_defaults_to_the_card_in_auto_mode():
    sig = inspect.signature(SV.ServingLoop)
    assert sig.parameters["mode"].default == "auto"
    assert sig.parameters["device"].default is None
    loop = loop_on_cpu()
    assert loop.server.device == CPU and loop.server.mode == "ref"
    assert loop.predictor.hw is M.HOST


def test_serving_loop_bit_identical_and_caches():
    q21, q31 = QUERIES["q2.1"], QUERIES["q3.1"]
    variants = engine.ssb_narrowed_variants(QUERIES)
    with loop_on_cpu(slo_s=5.0) as loop:
        first = [loop.submit(p) for p in (q21, q31)]
        for t, p in zip(first, (q21, q31)):
            r = t.wait(timeout=WAIT)
            assert r.error is None
            np.testing.assert_array_equal(np.asarray(r.result), oracle(p))
            assert t.latency_s is not None and t.latency_s >= 0
        r = loop.submit(q21).wait(timeout=WAIT)
        assert r.cache_hit and not r.subsumption_hit
        assert r.strategy == "cached" and r.error is None
        np.testing.assert_array_equal(np.asarray(r.result), oracle(q21))
        name, (parent, narrowed) = next(iter(variants.items()))
        pr = loop.submit(QUERIES[parent]).wait(timeout=WAIT)
        assert pr.error is None
        r = loop.submit(narrowed).wait(timeout=WAIT)
        assert r.subsumption_hit and r.cache_hit
        np.testing.assert_array_equal(np.asarray(r.result),
                                      oracle(narrowed))


def test_serving_loop_drains_on_stop():
    loop = loop_on_cpu(slo_s=5.0)
    loop.start()
    tickets = [loop.submit(p) for p in POOL[:6]]
    loop.stop(timeout=WAIT)
    for t in tickets:
        assert t.done()
        assert t.result.error is None
        np.testing.assert_array_equal(t.result.result, oracle(t.plan))
    with pytest.raises(RuntimeError):
        loop.submit(POOL[0])


def test_serving_loop_sheds_at_the_door():
    loop = loop_on_cpu()
    loop.start()
    try:
        gov = loop.server.governor
        gov.consecutive = gov.high_water
        with pytest.raises(RS.MemoryPressure):
            loop.submit(POOL[0])
        assert loop.server.stats["sheds"] >= 1
    finally:
        loop.server.governor.consecutive = 0
        loop.stop(timeout=WAIT)


def test_serving_loop_queue_expired_deadline_is_typed():
    with loop_on_cpu(slo_s=5.0) as loop:
        r = loop.submit(QUERIES["q1.1"], deadline_s=1e-9).wait(timeout=WAIT)
        assert r.error is not None
        assert r.error.error_kind == "DeadlineExceeded"
        assert r.result is None
    assert loop.server.stats["queue_deadline_drops"] == 1


def test_ticket_wait_times_out():
    t = ticket(0, arrival=0.0)
    with pytest.raises(TimeoutError):
        t.wait(timeout=0.01)


def test_poisson_run_forms_waves_bit_identically():
    """An open-loop Poisson run over the pool (a short version of the
    smoke's): every result the oracle's bits, with no retry or fallback,
    the result cache hit, and waves of more than one member formed."""
    import time
    # far faster than the worker serves: the arrivals queue while the
    # first dispatch runs, so waves form whatever the machine
    arrivals = SV.poisson_arrivals(4000.0, 60, seed=20)
    with loop_on_cpu(slo_s=5.0, max_batch=8, warm_pool=POOL,
                     max_hold_s=0.05) as loop:
        t0, tickets = time.monotonic(), []
        for i, at in enumerate(arrivals):
            pause = t0 + at - time.monotonic()
            if pause > 0:
                time.sleep(pause)
            tickets.append(loop.submit(POOL[i % len(POOL)]))
        results = [t.wait(timeout=WAIT) for t in tickets]
    for t, r in zip(tickets, results):
        assert r.error is None and r.attempts == 1
        np.testing.assert_array_equal(r.result, oracle(t.plan))
    stats = loop.server.stats
    assert stats["retries"] == 0 and stats["fallbacks"] == 0
    assert stats["result_cache_hits"] > 0
    assert max(r.shared_wave_size or 0 for r in results) > 1


# ---------------------------------------------------------------------------
# pool-anchored waves
# ---------------------------------------------------------------------------


def test_anchored_wave_bit_identical_any_membership():
    for lo in (0, 3, 9):
        wave = POOL[lo:lo + 4]
        got, _ = C.execute_shared_morsels(wave, DB, mode="ref", pad_to=4,
                                          anchor=POOL, device=CPU)
        for r, p in zip(got, wave):
            np.testing.assert_array_equal(r, oracle(p))


def test_anchor_for_keeps_only_legal_members():
    assert C.anchor_for(POOL[:2], None) is None
    kept = C.anchor_for(POOL[:2], POOL)
    assert kept is not None and len(kept) == len(POOL)


def test_serving_loop_prewarm_counts_buckets():
    loop = loop_on_cpu(max_batch=4, warm_pool=POOL)
    assert loop.prewarm() == 3          # pow2 buckets 1, 2, 4
    assert len(loop.server.result_cache) == 0
    assert loop.server.cache.misses > 0     # the pool's tables built
    with loop:
        with pytest.raises(RuntimeError, match="before start"):
            loop.prewarm()
        r = loop.submit(POOL[5]).wait(timeout=WAIT)
        assert r.error is None
        np.testing.assert_array_equal(np.asarray(r.result), oracle(POOL[5]))
    ref = RSV.ServingLoop(REF_DB, mode="ref", max_batch=4,
                          warm_pool=list(RE.ssb_queries().values()))
    assert ref.prewarm() == 3           # the reference's bucket count
