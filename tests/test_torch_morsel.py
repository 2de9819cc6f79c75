"""The port's morsel spine on the CPU (``repro_torch.sql.morsel`` and the
folds of ``repro_torch.sql.compile``), held to the reference's morsel
tests (``tests/test_morsel.py``, the cases that need neither the cost
model nor the server) and to the reference package itself.

Same inputs in both (the reference's SF 0.005 database carried across
with ``from_numpy``).  Tolerances: every morsel result is bit-identical
to the port's whole-table pass and to the numpy oracle; against the
reference's ``mode="ref"`` morsel execution, which merges f32 partials,
within ``tests/test_ssb.py``'s rtol 1e-5 / atol 1e-3 (at this scale its
sums stay below 2^24, so the bits agree as well).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro.sql import storage as RST
from repro_torch.sql import compile as C
from repro_torch.sql import engine, faults, ssb
from repro_torch.sql import hashtable as HT
from repro_torch.sql import morsel as MS
from repro_torch.sql import plan as P
from repro_torch.sql import resilience as RS
from repro_torch.sql import storage as ST

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
PDB = ST.pack_database(DB)
QUERIES = engine.ssb_queries()
# a budget forcing >1 morsel on every query: an eighth of the packed
# fact table
BUDGET = PDB.lineorder.nbytes // 8
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-3)


def oracle(name):
    return np.asarray(engine.run_query_oracle(DB, QUERIES[name]))


@pytest.fixture(scope="module")
def reference():
    """The reference's fused ``mode="ref"`` results on the packed database
    under the same budget (its morsel fold)."""
    rpdb = RST.pack_database(REF_DB)
    return {name: np.asarray(RC.compile_plan(plan, "fused").execute(
                rpdb, mode="ref", morsel_bytes=BUDGET))
            for name, plan in RE.ssb_queries().items()}


def fresh_packed():
    return ST.pack_database(DB)


# ---------------------------------------------------------------------------
# cut geometry / boundary math
# ---------------------------------------------------------------------------


def test_rows_per_morsel_lane_aligned_and_floored():
    assert MS.rows_per_morsel(4.0, 1 << 20) == (1 << 18) // 32 * 32
    assert MS.rows_per_morsel(4.0, 1) == MS.LANE
    assert MS.rows_per_morsel(0.0, 1 << 20) == MS.LANE
    for bpr in (0.5, 1.0, 2.5, 4.0):
        assert MS.rows_per_morsel(bpr, 12345) % MS.LANE == 0


def test_plan_cuts_cover_partition_and_tail():
    assert MS.plan_cuts(100, 32) == [(0, 32), (32, 64), (64, 96), (96, 100)]
    assert MS.plan_cuts(0, 32) == []
    assert MS.plan_cuts(7, 32) == [(0, 7)]
    for n, step in ((1, 32), (31, 32), (32, 32), (33, 32), (257, 64)):
        cuts = MS.plan_cuts(n, step)
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        for (_a, b), (c, _d) in zip(cuts, cuts[1:]):
            assert b == c


def test_slice_rows_word_aligned_is_view():
    lo = PDB.lineorder
    col = lo.columns["lo_discount"]             # packed, phys < 32
    c = col.encoding.values_per_word
    sliced = ST.slice_rows(lo, 0, 2 * MS.LANE).columns["lo_discount"]
    assert sliced.encoding.kind == col.encoding.kind
    assert sliced.encoding.width == col.encoding.width
    assert sliced.encoding.ref == col.encoding.ref
    assert np.shares_memory(sliced.words, col.words)
    assert np.array_equal(np.asarray(sliced), np.asarray(col)[:2 * MS.LANE])
    assert len(sliced.words) == (2 * MS.LANE + c - 1) // c


def test_slice_rows_unaligned_offsets_repack_exactly():
    lo = PDB.lineorder
    n = lo.n_rows
    for a, b in ((5, 70), (1, 2), (33, 33 + 7), (n - 3, n)):
        cut = ST.slice_rows(lo, a, b)
        assert cut.n_rows == b - a
        for cname in lo.columns:
            assert np.array_equal(np.asarray(cut[cname]),
                                  np.asarray(lo[cname])[a:b]), (cname, a, b)
            assert cut.encoding(cname).width == lo.encoding(cname).width
            assert cut.encoding(cname).ref == lo.encoding(cname).ref


def test_decode_range_matches_full_decode():
    lo = PDB.lineorder
    n = lo.n_rows
    for cname in ("lo_discount", "lo_orderdate", "lo_revenue"):
        col = lo.columns[cname]
        full = np.asarray(col)
        for a, b in ((0, n), (0, 0), (5, 5), (3, 41), (n - 1, n),
                     (MS.LANE, 3 * MS.LANE)):
            assert np.array_equal(col.decode_range(a, b), full[a:b]), \
                (cname, a, b)


def test_stream_covers_rows_exactly_and_reports_peak():
    stream = MS.MorselStream(PDB.lineorder, morsel_bytes=BUDGET, device=CPU)
    assert stream.n_morsels > 1
    got = np.concatenate([np.asarray(m.table["lo_revenue"])
                          for m in stream.morsels()])
    assert np.array_equal(got, np.asarray(PDB.lineorder["lo_revenue"]))
    for i, m in enumerate(stream.morsels()):
        assert stream.morsel_nbytes(i) == MS.scanned_morsel_bytes(
            m.table, None)
    report = MS.MorselReport()
    stream.fold(lambda m: None, report=report)
    assert report.n_morsels == stream.n_morsels
    assert report.peak_resident_bytes == stream.peak_resident_bytes()
    assert report.peak_resident_bytes <= 2 * BUDGET + 4 * 1024


def test_single_morsel_is_identity():
    stream = MS.MorselStream(PDB.lineorder, device=CPU)   # 64 MiB default
    assert stream.n_morsels == 1
    (m,) = list(stream.morsels())
    assert m.table is PDB.lineorder


def test_resident_table_is_one_morsel_whatever_the_budget():
    pdb = fresh_packed().to(CPU)
    stream = MS.MorselStream(pdb.lineorder, morsel_bytes=BUDGET, device=CPU)
    assert stream.n_morsels == 1
    cq = C.compile_plan(QUERIES["q2.1"], "fused")
    got = cq.execute(pdb, device=CPU, morsel_bytes=BUDGET)
    assert cq.n_morsels == 1
    assert np.array_equal(got, oracle("q2.1"))
    pdb.lineorder.release(device=True)          # no longer resident
    assert MS.MorselStream(pdb.lineorder, morsel_bytes=BUDGET,
                           device=CPU).n_morsels > 1


def test_empty_table_streams_zero_morsels():
    empty = ST.slice_rows(PDB.lineorder, 0, 0)
    stream = MS.MorselStream(empty, morsel_bytes=BUDGET, device=CPU)
    assert stream.n_morsels == 0
    assert stream.peak_resident_bytes() == 0
    assert stream.fold(lambda m: 1) == []
    edb = dataclasses.replace(PDB, lineorder=empty)
    for strategy in ("fused", "opat", "shared"):
        got = C.compile_plan(QUERIES["q2.1"], strategy).execute(
            edb, device=CPU, morsel_bytes=BUDGET)
        assert got.shape == (QUERIES["q2.1"].n_groups,) and not got.any()


# ---------------------------------------------------------------------------
# every strategy folds bit-identically
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy",
                         ["fused", "opat", "part", "part_loop", "shared"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_all_queries_bit_identical_under_budget(packed, strategy, reference):
    db = PDB if packed else DB
    cache = HT.HashTableCache()
    for name, plan in QUERIES.items():
        cq = C.compile_plan(plan, strategy)
        got = cq.execute(db, cache=cache, device=CPU, morsel_bytes=BUDGET)
        assert cq.n_morsels > 1, (name, strategy)
        assert cq.peak_resident_bytes <= 2 * BUDGET + 4 * 1024
        whole = C.compile_plan(plan, strategy).execute(db, cache=cache,
                                                       device=CPU)
        assert np.array_equal(got, whole), (name, strategy)
        assert np.array_equal(got, oracle(name)), (name, strategy)
        np.testing.assert_allclose(got, reference[name], **TOL,
                                   err_msg=name)


def test_default_budget_single_morsel_reported():
    cq = C.compile_plan(QUERIES["q1.1"], "fused")
    got = cq.execute(PDB, device=CPU)
    assert cq.n_morsels == 1
    assert cq.peak_resident_bytes > 0
    assert np.array_equal(got, oracle("q1.1"))


def test_morsel_sums_merge_exactly_past_f32():
    """Partials past 2^24 merge exactly: every row's measure is exact in
    f32 (opat's type), but each morsel's sum is far past 2^24 and not an
    f32 value, so merged f32 partials would round."""
    rev = np.full(DB.lineorder.n_rows, (1 << 20) + 1, np.int32)
    lo = ssb.Table("lineorder", {**DB.lineorder.columns, "lo_revenue": rev,
                                 "lo_discount": np.full_like(rev, 2),
                                 "lo_quantity": np.full_like(rev, 3)})
    db = dataclasses.replace(DB, lineorder=lo)
    plan = (P.QueryBuilder("big").scan("lineorder")
            .where_range("lo_discount", 1, 3).measure("lo_revenue")
            .group_by(1).build())
    want = engine.run_query_oracle(db, plan)
    for strategy in ("fused", "opat", "shared"):
        cq = C.compile_plan(plan, strategy)
        got = cq.execute(db, device=CPU, morsel_bytes=BUDGET)
        assert cq.n_morsels > 2, strategy
        assert np.array_equal(got, want), strategy


def test_row_plan_deferred_order_by_matches_whole_pass():
    rowplan = P.Plan("rows_ord", P.OrderBy(
        P.Filter(P.Scan("lineorder"), [P.RangePred("lo_discount", 4, 6)]),
        "lo_orderdate"))
    whole = C.compile_plan(rowplan, "opat").execute(PDB, device=CPU)
    cq = C.compile_plan(rowplan, "opat")
    got = cq.execute(PDB, device=CPU, morsel_bytes=BUDGET // 4)
    assert cq.n_morsels > 1
    assert np.array_equal(whole, got)
    keys = np.asarray(PDB.lineorder["lo_orderdate"])
    disc = np.asarray(PDB.lineorder["lo_discount"])
    rows = np.flatnonzero((disc >= 4) & (disc <= 6))
    assert np.array_equal(got, rows[np.argsort(keys[rows], kind="stable")])


def test_row_plan_without_order_concatenates_global_rowids():
    rowplan = P.Plan("rows_flat", P.Filter(
        P.Scan("lineorder"), [P.RangePred("lo_quantity", 1, 10)]))
    whole = C.compile_plan(rowplan, "opat").execute(PDB, device=CPU)
    cq = C.compile_plan(rowplan, "opat")
    got = cq.execute(PDB, device=CPU, morsel_bytes=BUDGET // 4)
    assert cq.n_morsels > 1
    assert np.array_equal(whole, got)


def test_shared_wave_streams_once_per_wave():
    plans = [QUERIES[n] for n in ("q1.1", "q2.1", "q3.1", "q4.1")]
    base = C.execute_shared(plans, PDB, device=CPU)
    got, report = C.execute_shared_morsels(plans, PDB, morsel_bytes=BUDGET,
                                           device=CPU, pad_to=8)
    assert report.n_morsels > 1
    assert report.peak_resident_bytes <= 2 * BUDGET + 4 * 1024
    for b, g, p in zip(base, got, plans):
        assert np.array_equal(b, g), p.name
        assert np.array_equal(g, oracle(p.name)), p.name


# ---------------------------------------------------------------------------
# append-only delta batches
# ---------------------------------------------------------------------------


def _with_deltas(n_batches=2, rows_per=96):
    pdb = fresh_packed()
    rng = np.random.default_rng(5)
    for _ in range(n_batches):
        idx = rng.integers(0, DB.lineorder.n_rows, rows_per)
        rows = {c: np.asarray(DB.lineorder[c])[idx]
                for c in DB.lineorder.columns}
        ST.append_rows(pdb.lineorder, rows)
    return pdb


def test_deltas_visible_without_flush():
    pdb = _with_deltas()
    assert ST.delta_rows(pdb.lineorder) == 192
    flushed = dataclasses.replace(
        pdb, lineorder=ST.flush_deltas(pdb.lineorder))
    assert ST.delta_rows(flushed.lineorder) == 0
    assert flushed.lineorder.n_rows == DB.lineorder.n_rows + 192
    for name in ("q1.1", "q2.1", "q4.2"):
        for strategy in ("fused", "opat", "shared"):
            want = C.compile_plan(QUERIES[name], strategy).execute(
                flushed, device=CPU)
            got = C.compile_plan(QUERIES[name], strategy).execute(
                pdb, device=CPU, morsel_bytes=BUDGET)
            assert np.array_equal(got, want), (name, strategy)
            assert np.array_equal(want, engine.run_query_oracle(flushed,
                                                                QUERIES[name]))


def test_plain_table_deltas_visible_without_flush():
    db = dataclasses.replace(DB, lineorder=ssb.Table(
        "lineorder", dict(DB.lineorder.columns)))
    rows = {c: np.asarray(v)[:100] for c, v in DB.lineorder.columns.items()}
    ST.append_rows(db.lineorder, rows)
    flushed = dataclasses.replace(db, lineorder=ST.flush_deltas(db.lineorder))
    got = C.compile_plan(QUERIES["q3.1"], "fused").execute(
        db, device=CPU, morsel_bytes=BUDGET)
    assert np.array_equal(got, engine.run_query_oracle(flushed,
                                                       QUERIES["q3.1"]))


def test_delta_morsels_carry_global_offsets():
    pdb = _with_deltas(n_batches=1, rows_per=64)
    stream = MS.MorselStream(pdb.lineorder, morsel_bytes=BUDGET, device=CPU)
    base_n = pdb.lineorder.n_rows
    kinds = [(m.source, m.offset) for m in stream.morsels()]
    deltas = [o for k, o in kinds if k == "delta"]
    assert deltas and deltas[0] == base_n
    assert stream.total_rows == base_n + 64


def test_append_rows_rejects_mismatched_columns():
    pdb = fresh_packed()
    with pytest.raises(ValueError):
        ST.append_rows(pdb.lineorder, {"lo_revenue": np.zeros(4, np.int32)})
    rows = {c: np.zeros(3 if c == "lo_revenue" else 4, np.int32)
            for c in pdb.lineorder.columns}
    with pytest.raises(ValueError, match="ragged"):
        ST.append_rows(pdb.lineorder, rows)
    assert ST.delta_rows(pdb.lineorder) == 0


def test_append_rows_ingest_fault_publishes_nothing():
    pdb = fresh_packed()
    rows = {c: np.asarray(v)[:10] for c, v in DB.lineorder.columns.items()}
    with faults.active(faults.FaultPlan(0, {"ingest": 1.0})):
        with pytest.raises(RS.FaultInjected):
            ST.append_rows(pdb.lineorder, rows)
    assert ST.delta_rows(pdb.lineorder) == 0


def test_release_drops_device_buffers():
    pdb = _with_deltas(n_batches=1)
    lo = pdb.lineorder
    col = lo.columns["lo_discount"]
    col.on_device(CPU)
    batch = ST.delta_batches(lo)[0].columns["lo_discount"]
    batch.on_device(CPU)
    assert col._resident and batch._resident
    lo.release(device=True)
    assert not col._resident and not batch._resident


class _Cudart:
    """Records the page-lock calls ``morsel.page_lock`` makes."""

    def __init__(self):
        self.registered, self.unregistered = [], []

    def cudaHostRegister(self, ptr, size, flags):
        self.registered.append((ptr, size))
        return 0

    def cudaHostUnregister(self, ptr):
        self.unregistered.append(ptr)
        return 0


def test_page_lock_is_per_owner_and_forgotten_when_it_goes(monkeypatch):
    rt = _Cudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: rt)
    buf = bytearray(16 * MS._PAGE)
    a = np.frombuffer(buf, np.int32)
    start, end = MS.page_lock(a)
    assert (end - start) // MS._PAGE in (15, 16)
    # a view shares its owner's lock
    assert MS.page_lock(a[100:-100]) == (start, end)
    assert rt.registered == [(start, end - start)]
    del a
    assert rt.unregistered == [start]
    assert (start, end) not in MS._REGISTERED
    # a new array at the same addresses is locked again, and released
    b = np.frombuffer(buf, np.int32)
    assert MS.page_lock(b) == (start, end)
    assert rt.registered == [(start, end - start)] * 2
    del b
    assert rt.unregistered == [start, start]
    assert (start, end) not in MS._REGISTERED


# ---------------------------------------------------------------------------
# streaming generator
# ---------------------------------------------------------------------------


def test_generate_packed_bit_identical_to_pack_after_generate():
    want = ST.pack_database(ssb.generate(0.005, seed=11))
    got = ssb.generate_packed(0.005, seed=11, chunk_rows=1000)
    for tname in ("lineorder", "date", "supplier", "customer", "part"):
        rt, gt = getattr(want, tname), getattr(got, tname)
        assert list(rt.columns) == list(gt.columns)
        for cname in rt.columns:
            assert rt.encoding(cname) == gt.encoding(cname), (tname, cname)
            assert np.array_equal(rt.columns[cname].words,
                                  gt.columns[cname].words), (tname, cname)


def test_generate_packed_serves_queries():
    got_db = ssb.generate_packed(0.005, seed=11)
    for name in ("q1.1", "q3.2"):
        got = C.compile_plan(QUERIES[name], "fused").execute(
            got_db, device=CPU, morsel_bytes=BUDGET)
        assert np.array_equal(got, oracle(name)), name


# ---------------------------------------------------------------------------
# fold exception safety
# ---------------------------------------------------------------------------


def test_fold_fault_releases_both_inflight_buffers():
    pdb = fresh_packed()
    stream = MS.MorselStream(pdb.lineorder, morsel_bytes=BUDGET, device=CPU)
    assert stream.n_morsels > 2
    seen, prefetched = [], []
    orig = stream._prefetch

    def spy_prefetch(m):
        prefetched.append(m)
        orig(m)

    stream._prefetch = spy_prefetch

    def compute(m):
        seen.append(m)
        for col in m.table.columns.values():
            assert col._resident            # uploaded by the prefetch
            col.decode()
        if len(seen) == 2:
            raise RuntimeError("kernel fault at morsel 2")
        return 0

    with pytest.raises(RuntimeError, match="morsel 2"):
        stream.fold(compute)
    assert prefetched[-1].table is not seen[-1].table
    for m in (seen[0], seen[-1], prefetched[-1]):
        for col in m.table.columns.values():
            assert not col._resident
            assert col._decoded is None


def test_fold_fault_through_executor_then_retry_bit_identical():
    class FailSecondUpload(faults.FaultPlan):
        def __init__(self):
            super().__init__(0, {"upload": 1.0})
            self.n = 0

        def should_fault(self, site):
            if site != "upload":
                return False
            self.n += 1
            return self.n == 2              # fault mid-stream, not head

    pdb = fresh_packed()
    cache = HT.HashTableCache()
    cq = C.compile_plan(QUERIES["q2.1"], "fused")
    with faults.active(FailSecondUpload()):
        with pytest.raises(RS.FaultInjected):
            cq.execute(pdb, cache=cache, device=CPU, morsel_bytes=BUDGET)
    got = C.compile_plan(QUERIES["q2.1"], "fused").execute(
        pdb, cache=cache, device=CPU, morsel_bytes=BUDGET)
    assert np.array_equal(got, oracle("q2.1"))


@pytest.mark.parametrize("site", ["kernel", "build"])
def test_kernel_and_build_faults_raise_typed_then_retry(site):
    cq = C.compile_plan(QUERIES["q3.2"], "opat")
    with faults.active(faults.FaultPlan(1, {site: 1.0})):
        with pytest.raises(RS.FaultInjected):
            cq.execute(DB, device=CPU, morsel_bytes=BUDGET)
    got = cq.execute(DB, device=CPU, morsel_bytes=BUDGET)
    assert np.array_equal(got, oracle("q3.2"))
