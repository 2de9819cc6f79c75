"""The port's sharding on the CPU (``repro_torch.sql.shard`` and the
``sharded`` strategy of ``repro_torch.sql.compile``), held to the
reference's shard tests (``tests/test_shard.py``: the mechanics, the 13
queries at S = 1, 2 and 8 plain and packed, the sharded wave, the cache,
the merge property) and to the reference package itself.

Same inputs in both (the reference's SF 0.005 database carried across
with ``from_numpy``).  Tolerances: every sharded result is bit-identical
to the port's solo fused pass and to the numpy oracle, and to the
reference's ``compile_plan(p, "sharded").execute(sdb, mode="ref")`` (its
f32 partial sums stay below 2^24 at this scale, so they are exact too);
the sharded wave is bit-identical to the oracle and within
``tests/test_ssb.py``'s rtol 1e-5 / atol 1e-3 of the reference's wave,
which sums f32 copies of the measures.  The mesh cases
(``test_shard.py:150``, ``test_morsel.py:227``) are held in
``tests/test_torch_mesh.py``, over ranks of a process group; the server
cases (``test_shard.py:186-230``) wait for the port's query server.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import shard as RSH
from repro.sql import ssb as RSSB
from repro_torch.sql import compile as C
from repro_torch.sql import engine, ssb
from repro_torch.sql import hashtable as HT
from repro_torch.sql import morsel as MS
from repro_torch.sql import plan as P
from repro_torch.sql import shard as SH
from repro_torch.sql import storage as ST

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
PDB = ST.pack_database(DB)
QUERIES = engine.ssb_queries()
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-3)
# a budget forcing >1 morsel on every query: an eighth of the packed
# fact table (tests/test_morsel.py's)
BUDGET = PDB.lineorder.nbytes // 8


@pytest.fixture(scope="module")
def oracle():
    return {name: engine.run_query_oracle(DB, plan)
            for name, plan in QUERIES.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's host-loop sharded results, ``mode="ref"``, by
    shard count."""
    out = {}
    for s in (2, 8):
        rsdb = RSH.shard_database(REF_DB, s)
        assert rsdb.mesh is None            # one jax device: host loop
        out[s] = {name: np.asarray(RC.compile_plan(plan, "sharded").execute(
                      rsdb, mode="ref"))
                  for name, plan in RE.ssb_queries().items()}
    return out


# ---------------------------------------------------------------------------
# shard_database / slice_rows mechanics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 3, 8])
def test_shard_database_bounds_cover_and_partition(s):
    sdb = SH.shard_database(DB, s)
    n = DB.lineorder.n_rows
    assert sdb.bounds[0] == 0 and sdb.bounds[-1] == n
    assert np.array_equal(sdb.bounds, RSH.shard_database(REF_DB, s).bounds)
    assert sum(x.lineorder.n_rows for x in sdb.shards) == n
    sizes = np.diff(sdb.bounds)
    assert sizes.max() - sizes.min() <= 1
    # dim tables are shared BY OBJECT (replication, not copies)
    for x in sdb.shards:
        assert x.date is DB.date and x.part is DB.part
    got = np.concatenate([x.lineorder["lo_revenue"] for x in sdb.shards])
    assert np.array_equal(got, DB.lineorder["lo_revenue"])


def test_shard_database_delegates_to_base():
    sdb = SH.shard_database(DB, 2)
    assert sdb.sf == DB.sf
    assert sdb.lineorder is DB.lineorder        # __getattr__ delegation
    assert SH.base_of(sdb) is DB and SH.base_of(DB) is DB
    assert SH.shard_count(sdb) == 2 and SH.shard_count(DB) == 1
    with pytest.raises(ValueError, match="shard count"):
        SH.shard_database(DB, 0)
    # a sharded database shards again from its base
    assert SH.shard_database(sdb, 3).base is DB


def test_shard_count_none_is_one_per_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert SH.shard_database(DB).n_shards == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert SH.shard_database(DB).n_shards == 4


def test_slice_rows_packed_matches_plain_slice():
    lo, hi = 7, 103
    plain = ST.slice_rows(DB.lineorder, lo, hi)
    packed = ST.slice_rows(PDB.lineorder, lo, hi)
    assert plain.n_rows == packed.n_rows == hi - lo
    for col in DB.lineorder.columns:
        assert np.array_equal(plain[col], DB.lineorder[col][lo:hi]), col
        assert np.array_equal(packed[col], plain[col]), col


def test_shard_count_may_exceed_rows_with_empty_tail_shards():
    tiny = dataclasses.replace(DB, lineorder=ST.slice_rows(DB.lineorder,
                                                           0, 5))
    sdb = SH.shard_database(tiny, 8)
    assert sdb.n_shards == 8
    assert sum(x.lineorder.n_rows for x in sdb.shards) == 5
    assert any(x.lineorder.n_rows == 0 for x in sdb.shards)
    plan = QUERIES["q1.1"]
    solo = C.compile_plan(plan, "fused").execute(tiny, device=CPU)
    cq = C.compile_plan(plan, "sharded")
    out = cq.execute(sdb, device=CPU)
    assert np.array_equal(solo, out)
    assert cq.n_morsels == 8                # an empty shard observes one
    assert np.array_equal(out, engine.run_query_oracle(tiny, plan))


# ---------------------------------------------------------------------------
# residency: a shard of a pinned table holds views, not copies
# ---------------------------------------------------------------------------


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def test_shards_of_a_pinned_plain_table_are_views():
    db = dataclasses.replace(DB, lineorder=ST.slice_rows(DB.lineorder, 0,
                                                         DB.lineorder.n_rows))
    db.to(CPU)
    sdb = SH.shard_database(db, 3)
    for i, x in enumerate(sdb.shards):
        fact = x.lineorder
        assert fact.is_pinned(CPU)
        for col in fact.columns:
            view = fact.on_device(col, CPU)
            assert _storage(view) == _storage(db.lineorder.on_device(col, CPU))
            assert np.array_equal(view.numpy(), fact[col])
        # a pinned shard is one morsel, read in place
        assert MS.MorselStream(fact, 1 << 10, device=CPU).n_morsels == 1


def test_shards_of_a_pinned_packed_table_view_the_words():
    pdb = ST.pack_database(DB)
    pdb.to(CPU)
    base = pdb.lineorder
    sdb = SH.shard_database(pdb, 7)
    assert sdb.bounds[1] % 2 == 1           # shard 1 starts off every word
    repacked = 0
    for i, x in enumerate(sdb.shards):
        lo = int(sdb.bounds[i])
        for name, col in x.lineorder.columns.items():
            t = col.on_device(CPU)
            assert np.array_equal(t.numpy(), col.words)
            c = col.encoding.values_per_word
            shared = _storage(t) == _storage(base.on_device(name, CPU))
            assert shared == (col.encoding.kind == "plain" or lo % c == 0)
            repacked += 0 if shared else t.numel() * 4
        assert x.lineorder.is_pinned(CPU)
    assert repacked > 0
    # the re-packed words are the shards' only device bytes of their own
    own = sum(t.numel() * 4 for x in sdb.shards
              for name, col in x.lineorder.columns.items()
              for t in [col.on_device(CPU)]
              if _storage(t) != _storage(base.on_device(name, CPU)))
    assert own == repacked


def test_sharded_database_to_pins_base_and_shards():
    sdb = SH.shard_database(ST.pack_database(DB), 2)
    assert not sdb.base.lineorder.is_pinned(CPU)
    assert sdb.to(CPU) is sdb
    assert sdb.base.lineorder.is_pinned(CPU)
    assert all(x.lineorder.is_pinned(CPU) for x in sdb.shards)
    plan = QUERIES["q2.1"]
    assert np.array_equal(C.compile_plan(plan, "sharded").execute(
        sdb, device=CPU), engine.run_query_oracle(DB, plan))


# ---------------------------------------------------------------------------
# the tentpole: bit-identity sharded vs solo, all 13 queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 8])
def test_all_13_sharded_bit_identical_plain(s, oracle, reference):
    cache = HT.HashTableCache()
    sdb = SH.shard_database(DB, s)
    for name, plan in QUERIES.items():
        solo = C.compile_plan(plan, "fused").execute(DB, device=CPU,
                                                     cache=cache)
        cq = C.compile_plan(plan, "sharded")
        out = cq.execute(sdb, device=CPU, cache=cache)
        assert np.array_equal(solo, out), (name, s)
        assert np.array_equal(oracle[name], out), (name, s)
        if s in reference:
            assert np.array_equal(reference[s][name], out), (name, s)
        assert cq.device_count == s
        assert len(cq.shard_times_s) == cq.device_count
        assert all(t >= 0 for t in cq.shard_times_s)
        assert cq.n_morsels == s
    # every shard served from one build a distinct build side
    distinct = {HT.join_cache_key(j) for p in QUERIES.values()
                for j in p.joins}
    assert cache.misses == len(distinct)


@pytest.mark.parametrize("s", [2, 8])
def test_all_13_sharded_bit_identical_packed(s, oracle):
    cache = HT.HashTableCache()
    sdb = SH.shard_database(PDB, s)
    for name, plan in QUERIES.items():
        solo = C.compile_plan(plan, "fused").execute(PDB, device=CPU,
                                                     cache=cache)
        out = C.compile_plan(plan, "sharded").execute(sdb, device=CPU,
                                                      cache=cache)
        assert np.array_equal(solo, out), (name, s)
        assert np.array_equal(oracle[name], out), (name, s)


@pytest.mark.parametrize("s", [1, 2])
def test_auto_bit_identical_to_oracle_and_reference(s, oracle):
    """``auto`` on a plain database (S = 1) and on its shards: whatever
    the model picks, the oracle's bits and the reference's ``auto``
    results (host-loop ``mode="ref"``)."""
    db = DB if s == 1 else SH.shard_database(DB, s)
    rdb = REF_DB if s == 1 else RSH.shard_database(REF_DB, s)
    for name, plan in QUERIES.items():
        cq = C.compile_plan(plan, "auto")
        got = cq.execute(db, device=CPU)
        assert np.array_equal(got, oracle[name]), (name, cq.decided)
        rq = RC.compile_plan(RE.ssb_queries()[name], "auto")
        want = np.asarray(rq.execute(rdb, mode="ref"))
        assert np.array_equal(got, want), (name, cq.decided, rq.decided)
        assert ("sharded" in cq.predictions) == (s > 1)


def test_sharded_on_plain_database_degenerates_to_fused():
    plan = QUERIES["q2.1"]
    cq = C.compile_plan(plan, "sharded")
    out = cq.execute(DB, device=CPU)
    solo = C.compile_plan(plan, "fused").execute(DB, device=CPU)
    assert np.array_equal(solo, out)
    assert cq.device_count == 1
    assert len(cq.shard_times_s) == 1


def test_sharded_plan_over_another_table_runs_solo():
    sdb = SH.shard_database(DB, 3)
    plan = (P.QueryBuilder("dim").scan("supplier")
            .where_range("s_region", 1, 2).measure("s_suppkey")
            .group_by(1).build())
    cq = C.compile_plan(plan, "sharded")
    out = cq.execute(sdb, device=CPU)
    assert cq.device_count == 1
    assert np.array_equal(out, engine.run_query_oracle(DB, plan))


def test_unshardable_plan_falls_back_to_opat_with_reason():
    row_plan = (P.QueryBuilder("rows").scan("lineorder")
                .order_by("lo_orderdate").build())
    cq = C.compile_plan(row_plan, "sharded")
    assert cq.strategy == "opat"
    assert cq.requested == "sharded"
    assert "row-returning" in cq.fallback_reason
    assert C.shardability(QUERIES["q2.1"]) is None


def test_sharded_sums_merge_exactly_past_f32():
    """Each shard's sum is far past 2^24 and not an f32 value: shards
    rounded to f32 and then added would differ from the oracle; the
    port's int64 partials, merged and rounded once, do not."""
    v = (1 << 20) + 2
    rev = np.full(DB.lineorder.n_rows, v, np.int32)
    lo = ssb.Table("lineorder", {**DB.lineorder.columns, "lo_revenue": rev,
                                 "lo_discount": np.full_like(rev, 2)})
    db = dataclasses.replace(DB, lineorder=lo)
    plan = (P.QueryBuilder("big").scan("lineorder")
            .where_range("lo_discount", 1, 3).measure("lo_revenue")
            .group_by(1).build())
    want = engine.run_query_oracle(db, plan)
    sdb = SH.shard_database(db, 3)
    rounded = np.float32(0)
    for x in sdb.shards:
        rounded = np.float32(rounded + np.float32(x.lineorder.n_rows * v))
    assert rounded != want[0]
    got = C.compile_plan(plan, "sharded").execute(sdb, device=CPU)
    assert np.array_equal(got, want)
    waves, _, _ = C.execute_shared_sharded([plan], sdb, device=CPU)
    assert np.array_equal(waves[0], want)


# ---------------------------------------------------------------------------
# sharded x morsels, reports merged
# ---------------------------------------------------------------------------


def test_morsel_report_merge():
    a = MS.MorselReport(3, 100)
    b = MS.MorselReport(2, 250)
    m = a.merge(b)
    assert (m.n_morsels, m.peak_resident_bytes) == (5, 250)
    assert (a.n_morsels, b.n_morsels) == (3, 2)       # inputs unchanged


def test_sharded_composes_with_morsels(oracle):
    sdb = SH.shard_database(PDB, 3)
    for name in ("q1.1", "q2.1", "q4.3"):
        cq = C.compile_plan(QUERIES[name], "sharded")
        got = cq.execute(sdb, device=CPU, morsel_bytes=BUDGET)
        assert cq.n_morsels >= 3            # every shard streams
        assert np.array_equal(got, oracle[name]), name
        streams = [MS.MorselStream(x.lineorder, BUDGET,
                                   cols=C._fused_scan_cols(QUERIES[name]),
                                   device=CPU) for x in sdb.shards]
        # morsels add across shards, the peak is one shard's buffer
        assert cq.n_morsels == sum(st.n_morsels for st in streams)
        assert cq.peak_resident_bytes == max(st.peak_resident_bytes()
                                             for st in streams)
        assert cq.peak_resident_bytes <= 2 * BUDGET + 4 * 1024


# ---------------------------------------------------------------------------
# shared waves over a sharded database
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_execute_shared_sharded_matches_execute_shared(packed, oracle):
    plans = list(QUERIES.values())
    db = PDB if packed else DB
    cache = HT.HashTableCache()
    base = C.execute_shared(plans, db, cache=cache, pad_to=16, device=CPU)
    sdb = SH.shard_database(db, 4)
    got, times, report = C.execute_shared_sharded(
        plans, sdb, cache=cache, pad_to=16, device=CPU)
    assert len(times) == 4
    assert report.n_morsels >= 4            # one stream per shard
    for b, g, plan in zip(base, got, plans):
        assert np.array_equal(b, g), plan.name
        assert np.array_equal(oracle[plan.name], g), plan.name
    distinct = {C.shared_join_key(j) for p in plans for j in p.joins}
    assert cache.misses == len(distinct)    # the shards built nothing
    if not packed:
        ref_sdb = RSH.shard_database(REF_DB, 4)
        ref, ref_times, _ = RC.execute_shared_sharded(
            list(RE.ssb_queries().values()), ref_sdb, mode="ref")
        assert len(ref_times) == 4
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g, r, **TOL)


def test_execute_shared_sharded_degenerates_on_a_plain_database():
    plans = [QUERIES[n] for n in ("q1.1", "q2.1")]
    got, times, report = C.execute_shared_sharded(plans, DB, device=CPU)
    assert len(times) == 1 and report.n_morsels == 1
    for g, plan in zip(got, plans):
        assert np.array_equal(g, engine.run_query_oracle(DB, plan))
    with pytest.raises(ValueError, match="at least one plan"):
        C.execute_shared_sharded([], SH.shard_database(DB, 2), device=CPU)


# ---------------------------------------------------------------------------
# replicated dim-table cache + shard-replica binding
# ---------------------------------------------------------------------------


def test_cache_accepts_shard_replicas_without_rebuild():
    cache = HT.HashTableCache()
    sdb = SH.shard_database(DB, 4)
    j = QUERIES["q2.1"].joins[0]
    cache.get_or_build(DB, j, CPU)
    for x in sdb.shards:            # shard replicas share the dim objects
        cache.get_or_build(x, j, CPU)
    cache.get_or_build(sdb, j, CPU)     # binds as its base
    assert cache.misses == 1
    assert cache.hits == 5
    other = ssb.generate(sf=0.005, seed=12)
    with pytest.raises(ValueError, match="scoped to one Database"):
        cache.get_or_build(other, j, CPU)


def test_cache_reset_clears_accepted_replicas():
    cache = HT.HashTableCache()
    j = QUERIES["q2.1"].joins[0]
    cache.get_or_build(DB, j, CPU)
    cache.reset()
    other = ssb.generate(sf=0.005, seed=12)
    cache.get_or_build(other, j, CPU)   # fresh binding after reset
    assert cache._db is other


def test_get_or_build_replicated_caches_per_device_set():
    cache = HT.HashTableCache()
    j = QUERIES["q2.1"].joins[0]
    [(htk1, htv1)] = cache.get_or_build_replicated(DB, j, [CPU])
    assert cache.misses == 1
    [(htk2, htv2)] = cache.get_or_build_replicated(DB, j, ["cpu"])
    assert htk2 is htk1 and htv2 is htv1
    assert cache.hits >= 1
    # on one device the replicated entry IS the solo path's table
    solo_k, solo_v = cache.get_or_build(DB, j, CPU)
    assert solo_k is htk1 and solo_v is htv1
    assert cache.misses == 1
    k, v = HT.build_dim_table(DB, j, CPU)
    assert torch.equal(htk1, k) and torch.equal(htv1, v)
    # two entries of a set: the first device's own, then a copy
    pair = cache.get_or_build_replicated(DB, j, [CPU, CPU])
    assert len(pair) == 2 and pair[0][0] is htk1
    assert torch.equal(pair[1][0], htk1)


def test_replicate_is_the_identity_on_one_device():
    t = torch.arange(5)
    [got] = SH.replicate([CPU], t)
    assert got is t
    [(a, b)] = SH.replicate(["cpu"], (t, t + 1))
    assert a is t and torch.equal(b, t + 1)


def test_db_fingerprint_unwraps_sharded_database():
    sdb = SH.shard_database(DB, 2)
    assert HT.db_fingerprint(sdb, ["date"]) == HT.db_fingerprint(DB, ["date"])


# ---------------------------------------------------------------------------
# tree reduction (+ hypothesis property)
# ---------------------------------------------------------------------------


def test_tree_merge_bit_identical_any_split():
    rng = np.random.default_rng(3)
    full = rng.integers(0, 1000, (16, 64)).astype(np.float32)
    ref = full.sum(axis=0)          # integer-valued f32: exact
    for n_parts in (1, 2, 3, 5, 16):
        cuts = np.array_split(np.arange(16), n_parts)
        partials = [full[c].sum(axis=0) for c in cuts]
        assert np.array_equal(SH.tree_merge(partials), ref)
        assert np.array_equal(RSH.tree_merge(partials), ref)
    # int64 tensors past 2^31 (the executors' partials)
    big = torch.full((5, 3), 1 << 40, dtype=torch.int64)
    assert torch.equal(SH.tree_merge(list(big)),
                       torch.full((3,), 5 << 40, dtype=torch.int64))
    with pytest.raises(ValueError):
        SH.tree_merge([])


def test_group_partial_finalize_ops():
    gp = SH.GroupPartial.from_rows([0, 0, 2], [3.0, 5.0, 7.0], 4)
    assert gp.sums.dtype == np.float64
    assert np.array_equal(gp.finalize("sum"),
                          np.array([8, 0, 7, 0], np.float32))
    assert np.array_equal(gp.finalize("count"),
                          np.array([2, 0, 1, 0], np.float32))
    assert np.array_equal(gp.finalize("avg"),
                          np.array([4, 0, 7, 0], np.float32))
    with pytest.raises(ValueError):
        gp.finalize("median")
    assert SH.GroupPartial.from_rows([1], [5], 2).sums.dtype == np.int64
    with pytest.raises(ValueError):
        SH.merge_partials([])


def test_group_partial_exact_past_f32():
    """The reference's f32 partials round past 2^24; the port's int64
    (and f64) sums do not."""
    vals = np.full(40, (1 << 20) + 1, np.int64)
    gids = np.zeros(40, np.int64)
    parts = [SH.GroupPartial.from_rows(gids[lo:hi], vals[lo:hi], 1)
             for lo, hi in ((0, 13), (13, 29), (29, 40))]
    want = np.array([40 * ((1 << 20) + 1)], np.int64).astype(np.float32)
    assert np.array_equal(SH.merge_partials(parts).finalize("sum"), want)
    fparts = [SH.GroupPartial.from_rows(gids[lo:hi],
                                        vals[lo:hi].astype(np.float32), 1)
              for lo, hi in ((0, 13), (13, 29), (29, 40))]
    assert np.array_equal(SH.merge_partials(fparts).finalize("sum"), want)


def _merge_property_case(gids, vals, n_groups, bounds):
    """Partials over the given row partition finalize bit-identically to
    the unsharded partial, and their sums and counts to the
    reference's."""
    g = np.asarray(gids, np.int64)
    v = np.asarray(vals, np.int64)
    whole = SH.GroupPartial.from_rows(g, v, n_groups)
    merged = SH.merge_partials(
        [SH.GroupPartial.from_rows(g[lo:hi], v[lo:hi], n_groups)
         for lo, hi in zip(bounds, bounds[1:])])
    for op in ("sum", "count", "avg"):
        assert np.array_equal(merged.finalize(op), whole.finalize(op)), op
    ref = RSH.merge_partials(
        [RSH.GroupPartial.from_rows(g[lo:hi], v[lo:hi], n_groups)
         for lo, hi in zip(bounds, bounds[1:])])
    for op in ("sum", "count"):
        assert np.array_equal(merged.finalize(op), ref.finalize(op)), op
    np.testing.assert_allclose(merged.finalize("avg"), ref.finalize("avg"),
                               rtol=1e-6)


try:        # the module must not whole-skip when hypothesis is absent
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(st.data())
    def test_property_partial_merge_bit_identical_to_oracle(data):
        """Merging per-shard partials over ANY row partition is
        bit-identical to the unsharded partial for sum/count/avg, empty
        shards and groups absent from some shards included."""
        n_groups = data.draw(st.integers(1, 8))
        n_rows = data.draw(st.integers(0, 120))
        gids = data.draw(st.lists(st.integers(0, n_groups - 1),
                                  min_size=n_rows, max_size=n_rows))
        vals = data.draw(st.lists(st.integers(0, 10_000),
                                  min_size=n_rows, max_size=n_rows))
        n_shards = data.draw(st.integers(1, 6))
        cuts = sorted(data.draw(st.lists(st.integers(0, n_rows),
                                         min_size=n_shards - 1,
                                         max_size=n_shards - 1)))
        _merge_property_case(gids, vals, n_groups, [0] + cuts + [n_rows])


def test_merge_fixed_cases_cover_empty_and_absent_groups():
    _merge_property_case([0, 1, 1, 3], [5, 7, 11, 13], 5,
                         [0, 0, 2, 2, 4])            # two empty shards
    _merge_property_case([], [], 4, [0, 0, 0])       # all shards empty
    _merge_property_case([2] * 10, [9] * 10, 3, [0, 1, 9, 10])
