"""The port's cost model and calibration on the CPU
(``repro_torch.cost.model``, ``repro_torch.sql.model``,
``repro_torch.sql.calibrate`` and the ``auto`` strategy), held to the
reference's tests of them (``tests/test_cost_model.py`` but its TPU
constants, ``tests/test_morsel.py:385-432``, ``tests/test_shard.py:379-458``
and the ``auto`` cases of ``tests/test_strategies.py``) and to the
reference package itself.

Same inputs in both (the reference's databases carried across with
``from_numpy``), and ``Hardware`` built from the same numbers in both
packages.  Tolerances: every prediction, plan statistic and byte count
equals the reference's within rtol 1e-9 (the formulas are copies, so the
same float operations), every choice is the reference's, and every
``auto`` result is bit-identical to the numpy oracle.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.cost import model as RCM
from repro.sql import engine as RE
from repro.sql import model as RM
from repro.sql import ssb as RSSB
from repro.sql import storage as RST
from repro_torch.cost import model as CM
from repro_torch.sql import calibrate as CAL
from repro_torch.sql import compile as C
from repro_torch.sql import engine, ssb
from repro_torch.sql import model as M
from repro_torch.sql import morsel as MS
from repro_torch.sql import plan as P
from repro_torch.sql import shard as SH
from repro_torch.sql import storage as ST

REF_DB = RSSB.generate(sf=0.005, seed=11)
REF_PDB = RST.pack_database(REF_DB)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
PDB = ST.pack_database(DB)
QUERIES = engine.ssb_queries()
REF_QUERIES = RE.ssb_queries()
CPU = torch.device("cpu")
BUDGET = PDB.lineorder.nbytes // 8
# the strategies suite's database (tests/test_strategies.py)
REF_DB3 = RSSB.generate(sf=0.01, seed=3)
DB3 = ssb.from_numpy({t: getattr(REF_DB3, t).columns for t in ssb.TABLES},
                     REF_DB3.sf)
RTOL = 1e-9


def both(hw: CM.Hardware):
    """``hw`` and the reference's Hardware of the same numbers."""
    return hw, RCM.Hardware(**dataclasses.asdict(hw))


HW = {"host": M.HOST, "h100": CM.H100,
      "toy": CM.Hardware("toy", read_bw=10e9, write_bw=10e9, cache_bw=1e12,
                         cache_size=1 << 16, line_bytes=64,
                         mem_capacity=1e12, interconnect_bw=5e9,
                         launch_overhead_s=3e-6)}


def close(a: float, b: float) -> bool:
    return a == pytest.approx(b, rel=RTOL, abs=0.0)


class _TinyDB:
    """Minimal database shim: any attribute-addressable set of Tables."""
    def __init__(self, **tables):
        for k, v in tables.items():
            setattr(self, k, v)


def _tiny_join_plan(name="tiny"):
    return (P.QueryBuilder(name).scan("lineorder")
            .hash_join("lo_fk", "dim", "d_key",
                       payload=P.ColExpr("d_pay"), mult=1)
            .measure("lo_rev").group_by(8).build())


# ---------------------------------------------------------------------------
# cost/model.py: the paper's claims (tests/test_cost_model.py)
# ---------------------------------------------------------------------------


def test_bandwidth_ratio():
    # §1 / §4 intro: "roughly 16x on modern hardware" (16.2 in-text)
    assert 15.5 < CM.BANDWIDTH_RATIO_PAPER < 17.0
    assert CM.BANDWIDTH_RATIO_PAPER == RCM.BANDWIDTH_RATIO_PAPER


def test_project_select_sort_speedups_near_ratio():
    # §4.1 project: 16.56x measured; §4.2 select: 15.8x; §4.4 sort: 17.13x
    c = CM.paper_claims()
    for k in ("project_speedup", "select_speedup", "sort_speedup"):
        assert 15.0 < c[k] < 18.0, (k, c[k])


def test_join_below_ratio():
    # §4.3: large hash tables -> "we would expect roughly 8.1x"
    assert 7.0 < CM.paper_claims()["join_1gb_speedup"] < 11.0


def test_join_cache_step_function():
    # §4.3 Fig 13: runtime steps up when the table exceeds the cache
    small = CM.join_probe_time(256_000_000, 1e6, CM.PAPER_GPU)
    large = CM.join_probe_time(256_000_000, 1e9, CM.PAPER_GPU)
    assert large > 2 * small


def test_coprocessor_loses():
    # §3.1: R_C < R_G whenever B_c > B_pcie — the paper's negative result
    c = CM.paper_claims()
    assert c["coprocessor_loses"]
    assert c["coprocessor_q1_ms"] > 2 * c["cpu_q1_ms"]


def test_q21_model_magnitude():
    # §5.3: model predicts 3.7ms GPU / 47ms CPU (measured 3.86 / 125)
    c = CM.paper_claims()
    assert 1.5 < c["q21_gpu_model_ms"] < 6.0
    assert 15.0 < c["q21_cpu_model_ms"] < 60.0
    assert c["q21_cpu_model_ms"] / c["q21_gpu_model_ms"] > 6.0


def test_paper_claims_equal_the_reference():
    got, want = CM.paper_claims(), RCM.paper_claims()
    assert set(got) == set(want)
    for k in got:
        assert got[k] == want[k], k


@pytest.mark.parametrize("hw", ["paper_cpu", "paper_gpu", "h100", "toy"])
def test_operator_models_equal_the_reference(hw):
    mine = {"paper_cpu": CM.PAPER_CPU, "paper_gpu": CM.PAPER_GPU,
            "h100": CM.H100, "toy": HW["toy"]}[hw]
    mine, ref = both(mine)
    n = 123_456_789
    calls = (lambda m, h: m.project_time(n, h),
             lambda m, h: m.select_time(n, 0.3, h),
             lambda m, h: m.join_probe_time(n, 3e6, h),
             lambda m, h: m.join_probe_time(n, 3e9, h),
             lambda m, h: m.join_build_time(n, h),
             lambda m, h: m.radix_pass_time(n, h),
             lambda m, h: m.sort_time(n, h),
             lambda m, h: m.q1_time(n, h),
             lambda m, h: m.q21_time(n, 8000, 2556, 8e6, h),
             lambda m, h: m.morsel_pipeline_time(7e9, 1, h),
             lambda m, h: m.morsel_pipeline_time(7e9, 29, h, 3))
    for i, call in enumerate(calls):
        assert close(call(CM, mine), call(RCM, ref)), i
    if mine.interconnect_bw:
        assert close(CM.coprocessor_time(5e9, mine),
                     RCM.coprocessor_time(5e9, ref))


def test_h100_entry_is_the_data_sheets_geometry():
    h = CM.H100
    assert (h.read_bw, h.cache_size, h.line_bytes, h.mem_capacity) == \
        (3.35e12, 50e6, 32, 80e9)
    assert h.interconnect_bw == 64e9 and h.interconnect_gbps == 64.0
    assert not hasattr(CM, "TPU_V5E")


# ---------------------------------------------------------------------------
# the morsel pipeline term (tests/test_morsel.py:385-432)
# ---------------------------------------------------------------------------


def test_morsel_pipeline_collapses_to_single_pass_at_one_morsel():
    hw = CM.PAPER_CPU                       # no interconnect
    nb = 1e9
    assert CM.morsel_pipeline_time(nb, 1, hw, 3) == pytest.approx(
        nb / hw.read_bw + 3 * hw.launch_overhead_s)
    # a single-morsel stream is the resident case: no copy term
    hw2 = dataclasses.replace(CM.PAPER_GPU, launch_overhead_s=5e-6)
    assert CM.morsel_pipeline_time(nb, 1, hw2, 2) == pytest.approx(
        nb / hw2.read_bw + 2 * 5e-6)
    # ...while a 2-morsel stream does pay the head copy
    assert CM.morsel_pipeline_time(nb, 2, hw2, 0) > nb / hw2.read_bw


def test_morsel_pipeline_overlap_hides_cheaper_side():
    hw = dataclasses.replace(CM.PAPER_GPU, launch_overhead_s=0.0)
    nb, n = 1e9, 10
    t = CM.morsel_pipeline_time(nb, n, hw, 0)
    per_copy = nb / hw.interconnect_bw / n
    per_comp = nb / hw.read_bw / n
    # PCIe is the bottleneck: compute hides behind the copies entirely
    assert t == pytest.approx(per_copy + (n - 1) * per_copy + per_comp)
    assert t < nb / hw.interconnect_bw + nb / hw.read_bw


def test_predictions_unchanged_at_default_budget():
    for name in ("q1.1", "q2.1", "q4.3"):
        a = M.predict(QUERIES[name], PDB, M.HOST)
        b = M.predict(QUERIES[name], PDB, M.HOST,
                      morsel_bytes=MS.DEFAULT_MORSEL_BYTES)
        for k in a:
            assert a[k] == pytest.approx(b[k]), (name, k)


def test_model_prices_morsel_count():
    plan = QUERIES["q2.1"]
    hw = dataclasses.replace(M.HOST, launch_overhead_s=1e-4)
    base = M.predict(plan, PDB, hw)
    tiny = M.predict(plan, PDB, hw, morsel_bytes=BUDGET)
    for k in base:
        assert tiny[k] > base[k], k
    c = M.choose(plan, PDB, hw, morsel_bytes=BUDGET)
    assert c.strategy in ("fused", "opat", "part", "sharded")


# ---------------------------------------------------------------------------
# sql/model.py against the reference, same Hardware
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hw", sorted(HW))
def test_predict_and_choose_equal_the_reference(hw, packed):
    mine, ref = both(HW[hw])
    db, rdb = (PDB, REF_PDB) if packed else (DB, REF_DB)
    for name, plan in QUERIES.items():
        rplan = REF_QUERIES[name]
        s, r = M.plan_stats(plan, db), RM.plan_stats(rplan, rdb)
        assert dataclasses.astuple(s) == dataclasses.astuple(r), name
        assert M.scanned_bytes(plan, db.lineorder) == \
            RM.scanned_bytes(rplan, rdb.lineorder)
        for n_shards in (None, 4):
            for budget in (None, BUDGET):
                kw = dict(n_shards=n_shards, morsel_bytes=budget)
                got, want = M.predict(plan, db, mine, **kw), \
                    RM.predict(rplan, rdb, ref, **kw)
                assert set(got) == set(want), (name, kw)
                for k in got:
                    assert close(got[k], want[k]), (name, kw, k)
                c, rc = M.choose(plan, db, mine, **kw), \
                    RM.choose(rplan, rdb, ref, **kw)
                assert c.strategy == rc.strategy, (name, kw)
                assert close(c.predicted_s, rc.predicted_s)


@pytest.mark.parametrize("packed", [False, True])
def test_predict_shared_and_marginal_equal_the_reference(packed):
    db, rdb = (PDB, REF_PDB) if packed else (DB, REF_DB)
    waves = (list(QUERIES), ["q1.1", "q1.2", "q1.3"],
             ["q2.1", "q2.2", "q2.3", "q4.1", "q4.2", "q4.3"],
             ["q3.1", "q3.1", "q2.1"])
    for hw in ("host", "h100"):
        mine, ref = both(HW[hw])
        for names in waves:
            plans = [QUERIES[n] for n in names]
            rplans = [REF_QUERIES[n] for n in names]
            assert M.scanned_bytes_shared(plans, db.lineorder) == \
                RM.scanned_bytes_shared(rplans, rdb.lineorder)
            for n_shards in (None, 4):
                got = M.predict_shared(plans, db, mine, n_shards=n_shards)
                want = RM.predict_shared(rplans, rdb, ref, n_shards=n_shards)
                assert set(got) == set(want)
                for k in got:
                    assert close(got[k], want[k]), (names, hw, k)
            got = M.predict_marginal(plans, db, mine, n_shards=4,
                                     candidate=QUERIES["q2.2"])
            want = RM.predict_marginal(rplans, rdb, ref, n_shards=4,
                                       candidate=REF_QUERIES["q2.2"])
            for k in got:
                assert close(got[k], want[k]), (names, hw, k)


def test_part_bits_execute_path_keeps_its_bits():
    for n in (1, 100, 30_000, 1 << 20, 1 << 24):
        assert M.part_bits(n) == M.part_bits(n, CM.H100) == \
            RM.part_bits(n, RCM.Hardware(**dataclasses.asdict(CM.H100)))
    toy = HW["toy"]
    assert M.part_bits(1 << 20, toy) == \
        RM.part_bits(1 << 20, RCM.Hardware(**dataclasses.asdict(toy)))
    tuned = dataclasses.replace(CM.H100, part_budget_bytes=1 << 12)
    assert M.part_bits(1 << 16, tuned) == RM.part_bits(
        1 << 16, RCM.Hardware(**dataclasses.asdict(tuned)))


def test_default_hardware_on_the_cpu_is_host():
    assert M.default_hardware(CPU) is M.HOST
    assert M.default_hardware("cpu") is M.HOST


# ---------------------------------------------------------------------------
# the sharded term and the arbitration (tests/test_shard.py:379-458)
# ---------------------------------------------------------------------------


def test_predict_sharded_only_with_shards():
    plan = QUERIES["q2.1"]
    assert "sharded" not in M.predict(plan, DB, M.HOST)
    assert "sharded" not in M.predict(plan, DB, M.HOST, n_shards=1)
    preds = M.predict(plan, DB, M.HOST, n_shards=4)
    assert "sharded" in preds and preds["sharded"] > 0


def test_shard_reduce_time_prices_interconnect():
    hw = M.HOST
    assert M._shard_reduce_time(7000, 1, hw) == 0.0
    t2 = M._shard_reduce_time(7000, 2, hw)
    t8 = M._shard_reduce_time(7000, 8, hw)
    assert 0 < t2 < t8              # more shards, more merge levels
    fast = dataclasses.replace(hw, interconnect_bw=hw.read_bw * 100)
    assert M._shard_reduce_time(7000, 8, fast) < t8


def test_choose_arbitrates_single_vs_multi_device():
    plan = QUERIES["q2.1"]
    slow = dataclasses.replace(M.HOST, interconnect_bw=1e3)
    c = M.choose(plan, DB, hw=slow, n_shards=8)
    assert c.strategy != "sharded"
    assert "sharded" in c.predictions
    fast = dataclasses.replace(M.HOST, interconnect_bw=1e15,
                               launch_overhead_s=0.0)
    assert M.choose(plan, DB, hw=fast, n_shards=8).strategy == "sharded"


def test_predict_shared_sharded_term():
    plans = list(QUERIES.values())
    out = M.predict_shared(plans, DB, M.HOST)
    assert "shared_sharded" not in out
    out2 = M.predict_shared(plans, DB, M.HOST, n_shards=4)
    assert out2["shared_sharded"] > 0
    assert out2["shared"] == pytest.approx(out["shared"])


def test_hardware_interconnect_gbps_property():
    assert M.HOST.interconnect_gbps is None
    hw = dataclasses.replace(M.HOST, interconnect_bw=50e9)
    assert hw.interconnect_gbps == pytest.approx(50.0)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.fixture
def calib_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    return tmp_path


def test_calibration_interconnect_roundtrip(calib_dir):
    calib = CAL.Calibration(backend="cpu", read_bw=1e10, write_bw=5e9,
                            cache_bw=1e11, launch_overhead_s=1e-5,
                            measured_at=0.0, interconnect_bw=3e9)
    path = CAL.save(calib)
    assert os.path.dirname(path) == str(calib_dir)
    assert os.path.basename(path).startswith("torch-calibration-cpu-torch")
    assert path == CAL.cache_path(CPU)
    CAL._MEMO.clear()                       # read it back from the file
    loaded = CAL.load_cached("cpu")
    assert loaded == calib
    hw = CAL.apply(loaded, M.HOST)
    assert hw.interconnect_bw == pytest.approx(3e9)
    assert hw.read_bw == 1e10 and hw.cache_size == M.HOST.cache_size


def test_calibration_from_json_tolerates_old_records():
    """A record without the interconnect (or the device name) loads; the
    field defaults and ``apply`` keeps the base's link rate."""
    old = {"backend": "cuda", "read_bw": 1e10, "write_bw": 5e9,
           "cache_bw": 1e11, "launch_overhead_s": 1e-5,
           "measured_at": 0.0, "some_future_key": 42}
    calib = CAL.Calibration.from_json(old)
    assert calib.interconnect_bw is None
    hw = CAL.apply(calib, CM.H100)
    assert hw.interconnect_bw == CM.H100.interconnect_bw
    assert hw.line_bytes == CM.H100.line_bytes and hw.read_bw == 1e10


@pytest.mark.parametrize("junk", ["{not json", "42", '{"backend": "cpu"}'])
def test_corrupt_calibration_cache_is_discarded(calib_dir, junk):
    path = CAL.cache_path(CPU)
    with open(path, "w") as f:
        f.write(junk)
    CAL._MEMO.pop(path, None)
    assert CAL.load_cached(CPU) is None
    assert not os.path.exists(path)
    assert CAL.cached_hardware(M.HOST, CPU) is None


def test_measure_on_the_cpu_gives_four_rates_and_no_link(calib_dir):
    calib = CAL.measure(CPU, stream_bytes=1 << 20, table_bytes=1 << 12,
                        probes=1 << 14)
    assert calib.backend == "cpu" and calib.device_name == "cpu"
    for k in ("read_bw", "write_bw", "cache_bw", "launch_overhead_s"):
        assert getattr(calib, k) > 0, k
    assert calib.interconnect_bw is None
    assert CAL._measure_interconnect(CPU) is None
    CAL.save(calib)
    CAL._MEMO.clear()
    hw = CAL.cached_hardware(M.HOST, CPU)
    assert hw.read_bw == calib.read_bw and hw.interconnect_bw is None
    assert hw.name == "host-cpu-calibrated"
    # a warm cache is served without a measurement
    assert CAL.calibrated_hardware(M.HOST, CPU) == hw


def test_calibrate_cli_on_the_cpu(calib_dir, capsys):
    CAL.save(CAL.Calibration(backend="cpu", read_bw=2e10, write_bw=1e10,
                             cache_bw=1e11, launch_overhead_s=2e-5,
                             measured_at=0.0))
    CAL.main(["--device", "cpu", "--json", str(calib_dir / "out")])
    text = capsys.readouterr().out
    assert "read_bw=20.00 GB/s" in text and "cached" in text
    assert "interconnect_bw=n/a" in text
    with open(calib_dir / "out" / "CALIBRATION.json") as f:
        assert json.load(f)["read_bw"] == 2e10


# ---------------------------------------------------------------------------
# auto (tests/test_strategies.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle3():
    return {name: engine.run_query_oracle(DB3, plan)
            for name, plan in QUERIES.items()}


def test_ssb_auto_vs_oracle(oracle3):
    for name, plan in QUERIES.items():
        cq = C.compile_plan(plan, "auto")
        assert (cq.strategy, cq.requested, cq.fallback_reason) == \
            ("auto", "auto", None)
        got = cq.execute(DB3, device=CPU)
        assert np.array_equal(got, oracle3[name]), name
        assert cq.decided in ("fused", "opat", "part")
        assert cq.predictions and cq.decided in cq.predictions
        want = RM.choose(REF_QUERIES[name], REF_DB3, both(M.HOST)[1])
        assert cq.decided == want.strategy, name


@pytest.mark.parametrize("packed", [False, True])
def test_auto_on_a_sharded_database(packed, oracle3):
    db = ST.pack_database(DB3) if packed else DB3
    sdb = SH.shard_database(db, 4)
    decided = set()
    for name, plan in QUERIES.items():
        cq = C.compile_plan(plan, "auto")
        got = cq.execute(sdb, device=CPU)
        assert np.array_equal(got, oracle3[name]), name
        assert "sharded" in cq.predictions
        assert cq.decided == M.choose(plan, sdb, M.HOST,
                                      n_shards=4).strategy
        if cq.decided == "sharded":
            assert cq.device_count == 4 and len(cq.shard_times_s) == 4
        decided.add(cq.decided)
    assert "sharded" in decided


def test_auto_prices_a_resident_table_as_one_morsel():
    """A fact table resident on the device is one morsel whatever the
    budget, so ``auto`` prices no host copy for it; a table on the host
    is priced at the budget it streams under."""
    plan = QUERIES["q2.1"]
    budget = 1 << 14
    host = ST.pack_database(DB)
    cq = C.compile_plan(plan, "auto")
    cq.execute(host, device=CPU, morsel_bytes=budget)
    assert cq.n_morsels > 1
    assert cq.predictions == M.predict(plan, host, M.HOST,
                                       morsel_bytes=budget)
    resident = ST.pack_database(DB).to(CPU)
    cq.execute(resident, device=CPU, morsel_bytes=budget)
    assert cq.n_morsels == 1
    whole = M.predict(plan, resident, M.HOST,
                      morsel_bytes=resident.lineorder.nbytes)
    assert cq.predictions == whole
    assert whole["fused"] < M.predict(plan, resident, M.HOST,
                                      morsel_bytes=budget)["fused"]


def test_empty_build_side_zero_result_auto():
    plan = (P.QueryBuilder("allfiltered").scan("lineorder")
            .hash_join("lo_suppkey", "supplier", "s_suppkey",
                       dim_filter=P.EqPred("s_region", 99))
            .measure("lo_revenue").group_by(4).build())
    expect = engine.run_query_oracle(DB3, plan)
    assert (expect == 0).all()
    for strategy in ("auto", "sharded"):
        got = C.compile_plan(plan, strategy).execute(
            SH.shard_database(DB3, 3), device=CPU)
        assert np.array_equal(got, expect), strategy


def test_model_predictions_shape():
    preds = M.predict(QUERIES["q2.1"], DB3, M.HOST)
    assert set(preds) == {"fused", "opat", "part", "part_loop"}
    assert all(v > 0 for v in preds.values())
    preds1 = M.predict(QUERIES["q1.1"], DB3, M.HOST)
    assert "part" not in preds1 and "part_loop" not in preds1
    assert "fused" in preds1


def test_model_prefers_partitioned_past_the_cache():
    """The paper's Fig. 8 crossover: once the monolithic table dwarfs the
    cache, the partition pass pays for itself."""
    hw = CM.Hardware("toy", read_bw=10e9, write_bw=10e9, cache_bw=1e12,
                     cache_size=1 << 16, line_bytes=64, mem_capacity=1e12)
    rng = np.random.default_rng(0)
    n_dim, n_fact = 1 << 20, 1 << 22
    fact = ssb.Table("lineorder", {
        "lo_fk": rng.integers(0, n_dim, n_fact).astype(np.int32),
        "lo_rev": np.ones(n_fact, np.int32)})
    dim = ssb.Table("dim", {
        "d_key": np.arange(n_dim, dtype=np.int32),
        "d_pay": np.zeros(n_dim, np.int32)})
    preds = M.predict(_tiny_join_plan("big"), _TinyDB(lineorder=fact,
                                                      dim=dim), hw)
    assert preds["part"] < preds["opat"]


def test_auto_choice_is_argmin():
    choice = M.choose(QUERIES["q2.1"], DB3, M.HOST)
    assert choice.strategy == min(choice.predictions,
                                  key=choice.predictions.get)
    cq = C.compile_plan(QUERIES["q2.1"], "auto")
    cq.execute(DB3, device=CPU)
    assert cq.decided == choice.strategy
