"""The port's result and subsumption cache
(``repro_torch.sql.result_cache``) on the CPU, held to the reference's
``tests/test_result_cache.py`` and to the reference package itself.

Soundness is the whole game: a cached grid answers a new query only when
the answer is bit-identical to running it fresh.  The sweep drives every
SSB query and every narrowed variant of ``engine.ssb_narrowed_variants``
against the numpy oracle; the port's keys, digit layouts and masks equal
the reference's on the same data (the reference's SF 0.005 database
carried across with ``ssb.from_numpy``).
"""
import copy

import numpy as np
import pytest

from repro.sql import engine as RE
from repro.sql import result_cache as RRC
from repro.sql import ssb as RSSB
from repro_torch.sql import engine, ssb
from repro_torch.sql import plan as PL
from repro_torch.sql import result_cache as RC
from repro_torch.sql import storage as ST

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
QUERIES = engine.ssb_queries()
VARIANTS = engine.ssb_narrowed_variants(QUERIES)
REF_QUERIES = RE.ssb_queries()
REF_VARIANTS = RE.ssb_narrowed_variants(REF_QUERIES)


def oracle(db, plan):
    return np.asarray(engine.run_query_oracle(db, plan))


def warm_cache(db=DB, queries=QUERIES):
    rc = RC.ResultCache()
    for plan in queries.values():
        assert rc.insert(db, plan, oracle(db, plan))
    return rc


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def _filter_nodes(plan):
    return [n for n in plan.chain if isinstance(n, PL.Filter)]


def test_canonical_key_ignores_name_and_filter_order():
    q = QUERIES["q1.1"]
    renamed = copy.deepcopy(q)
    renamed.name = "whatever"
    fnodes = _filter_nodes(renamed)
    allp = [p for n in fnodes for p in n.preds]
    assert len(allp) >= 2
    for n in fnodes:
        n.preds[:] = []
    fnodes[0].preds[:] = list(reversed(allp))
    assert RC.canonical_key(q) == RC.canonical_key(renamed)
    changed = copy.deepcopy(q)
    node = _filter_nodes(changed)[0]
    p = node.preds[0]
    node.preds[0] = PL.RangePred(p.col, p.lo, p.hi - 1)
    assert RC.canonical_key(q) != RC.canonical_key(changed)


def test_structure_key_ignores_join_filters_only():
    parent = QUERIES["q2.1"]
    _, narrowed = VARIANTS["q2.1n"]
    assert RC.structure_key(parent) == RC.structure_key(narrowed)
    assert RC.canonical_key(parent) != RC.canonical_key(narrowed)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_keys_equal_the_references(name):
    """The port's plans key as the reference's equal plans do."""
    assert RC.canonical_key(QUERIES[name]) == \
        RRC.canonical_key(REF_QUERIES[name])
    assert RC.structure_key(QUERIES[name]) == \
        RRC.structure_key(REF_QUERIES[name])


def test_narrowed_variants_match_the_references():
    assert list(VARIANTS) == list(REF_VARIANTS)
    for name, (parent, plan) in VARIANTS.items():
        rparent, rplan = REF_VARIANTS[name]
        assert parent == rparent and plan.name == name
        assert RC.canonical_key(plan) == RRC.canonical_key(rplan)
        assert RC.structure_key(plan) == RC.structure_key(QUERIES[parent])


# ---------------------------------------------------------------------------
# exact hits
# ---------------------------------------------------------------------------


def test_exact_hit_every_ssb_query():
    rc = warm_cache()
    for name, plan in QUERIES.items():
        hit = rc.lookup(DB, plan)
        assert hit is not None, name
        grid, kind = hit
        assert kind == "exact"
        np.testing.assert_array_equal(grid, oracle(DB, plan))


def test_returned_grid_is_isolated_from_the_cache():
    rc = RC.ResultCache()
    plan = QUERIES["q2.1"]
    rc.insert(DB, plan, oracle(DB, plan))
    grid, _ = rc.lookup(DB, plan)
    grid[:] = -1
    again, _ = rc.lookup(DB, plan)
    np.testing.assert_array_equal(again, oracle(DB, plan))


def test_insert_rejects_malformed_grids():
    rc = RC.ResultCache()
    plan = QUERIES["q2.1"]
    good = oracle(DB, plan)
    assert not rc.insert(DB, plan, good[:-1])
    assert not rc.insert(DB, plan, good.reshape(1, -1))
    assert len(rc) == 0


def test_row_plans_are_not_cached():
    plan = (PL.QueryBuilder("rows").scan("lineorder")
            .order_by("lo_orderdate").build())
    assert RC.canonical_key(plan) is None
    rc = RC.ResultCache()
    assert not rc.insert(DB, plan, np.zeros(3, np.float32))
    assert rc.lookup(DB, plan) is None


# ---------------------------------------------------------------------------
# subsumption: the deterministic soundness sweep
# ---------------------------------------------------------------------------


def test_subsumption_serves_every_variant_bit_identically():
    rc = warm_cache()
    assert VARIANTS
    for name, (parent, narrowed) in VARIANTS.items():
        hit = rc.lookup(DB, narrowed)
        assert hit is not None, f"{name} should subsume under {parent}"
        grid, kind = hit
        assert kind == "subsume", name
        np.testing.assert_array_equal(grid, oracle(DB, narrowed),
                                      err_msg=name)
    assert rc.stats()["subsume_hits"] == len(VARIANTS)


def test_subsumption_only_parent_cached():
    for name, (parent, narrowed) in VARIANTS.items():
        rc = RC.ResultCache()
        rc.insert(DB, QUERIES[parent], oracle(DB, QUERIES[parent]))
        hit = rc.lookup(DB, narrowed)
        assert hit is not None and hit[1] == "subsume", name
        np.testing.assert_array_equal(hit[0], oracle(DB, narrowed),
                                      err_msg=name)


@pytest.mark.parametrize("name", sorted(engine.ssb_narrowed_variants()))
def test_masks_and_layouts_equal_the_references(name):
    parent, narrowed = VARIANTS[name]
    rparent, rnarrowed = REF_VARIANTS[name]
    mask = RC.subsume_mask(QUERIES[parent], narrowed, DB)
    rmask = RRC.subsume_mask(REF_QUERIES[rparent], rnarrowed, REF_DB)
    np.testing.assert_array_equal(mask, rmask)
    lay = RC.digit_layout(QUERIES[parent], DB)
    rlay = RRC.digit_layout(REF_QUERIES[rparent], REF_DB)
    assert (lay is None) == (rlay is None)
    for k in (lay or {}):
        np.testing.assert_array_equal(lay[k], rlay[k])


def test_widened_filter_misses():
    exercised = 0
    for name, (parent, narrowed) in VARIANTS.items():
        pq = QUERIES[parent]
        widens = any(
            bool(np.any(PL.pred_mask(jn.filter, getattr(DB, jn.dim))
                        & ~PL.pred_mask(jc.filter, getattr(DB, jc.dim))))
            for jc, jn in zip(narrowed.joins, pq.joins))
        rc = RC.ResultCache()
        rc.insert(DB, narrowed, oracle(DB, narrowed))
        hit = rc.lookup(DB, pq)
        if widens:
            exercised += 1
            assert hit is None, name
        elif hit is not None:
            np.testing.assert_array_equal(hit[0], oracle(DB, pq),
                                          err_msg=name)
    assert exercised >= 3


def test_filter_only_join_never_subsumes():
    parent = QUERIES["q2.1"]
    narrowed = copy.deepcopy(parent)
    narrowed.name = "q2.1f"
    zero = [j for j in narrowed.joins if j.mult == 0]
    assert zero
    zero[0].filter = PL.EqPred("s_nation", ssb.NATION_US)
    rc = RC.ResultCache()
    rc.insert(DB, parent, oracle(DB, parent))
    assert rc.lookup(DB, narrowed) is None


def test_changed_fact_filter_misses():
    parent = QUERIES["q1.1"]
    other = copy.deepcopy(parent)
    other.name = "q1.1f"
    node = _filter_nodes(other)[0]
    p = node.preds[0]
    node.preds[0] = PL.RangePred(p.col, p.lo, p.hi - 1)
    rc = RC.ResultCache()
    rc.insert(DB, parent, oracle(DB, parent))
    assert rc.lookup(DB, other) is None


def test_duplicate_build_keys_never_subsume():
    """With duplicate keys on the cached build side the first-wins build
    could resolve otherwise under the narrower filter: a miss."""
    dup = ssb.from_numpy({t: {c: v.copy() for c, v in
                              getattr(REF_DB, t).columns.items()}
                          for t in ssb.TABLES}, REF_DB.sf)
    keys = dup.date.columns["d_datekey"]
    keys[1] = keys[0]
    parent, narrowed = VARIANTS["q2.1n"]
    assert RC.subsume_mask(QUERIES[parent], narrowed, dup) is None


# ---------------------------------------------------------------------------
# invalidation + eviction
# ---------------------------------------------------------------------------


def test_delta_ingest_invalidates_everything():
    db = ssb.generate(sf=0.005, seed=23)
    rc = RC.ResultCache()
    plan = QUERIES["q2.1"]
    rc.insert(db, plan, oracle(db, plan))
    assert rc.lookup(db, plan) is not None
    rng = np.random.default_rng(0)
    ST.append_rows(db.lineorder,
                   {c: rng.integers(1, 50, 8).astype(np.int32)
                    for c in db.lineorder.columns})
    assert rc.lookup(db, plan) is None
    assert len(rc) == 0
    assert rc.stats()["invalidations"] == 1


def test_different_database_object_invalidates():
    db2 = ssb.generate(sf=0.005, seed=29)
    rc = RC.ResultCache()
    plan = QUERIES["q2.1"]
    rc.insert(DB, plan, oracle(DB, plan))
    assert rc.lookup(db2, plan) is None
    assert rc.lookup(DB, plan) is None


def test_lru_eviction_caps_entries():
    rc = RC.ResultCache(max_entries=2)
    for n in ["q1.1", "q1.2", "q1.3"]:
        rc.insert(DB, QUERIES[n], oracle(DB, QUERIES[n]))
    assert len(rc) == 2
    assert rc.lookup(DB, QUERIES["q1.1"]) is None
    assert rc.lookup(DB, QUERIES["q1.3"]) is not None
    assert rc.stats()["evictions"] == 1


def test_byte_budget_evicts():
    one = oracle(DB, QUERIES["q2.1"]).nbytes
    rc = RC.ResultCache(max_bytes=one)
    rc.insert(DB, QUERIES["q2.1"], oracle(DB, QUERIES["q2.1"]))
    rc.insert(DB, QUERIES["q2.2"], oracle(DB, QUERIES["q2.2"]))
    assert len(rc) == 1 and rc.stats()["bytes"] <= one


def test_clear_reports_count():
    rc = warm_cache()
    n = len(rc)
    assert rc.clear() == n == len(QUERIES)
    assert len(rc) == 0


@pytest.mark.parametrize("packed", [False, True])
def test_oracle_equals_the_references(packed):
    """The port's oracle (each join over the rows still live) gives the
    reference's oracle's bits on every SSB query and narrowed variant,
    plain and packed."""
    db = ST.pack_database(DB) if packed else DB
    plans = {**{n: (p, REF_QUERIES[n]) for n, p in QUERIES.items()},
             **{n: (p, REF_VARIANTS[n][1]) for n, (_, p) in VARIANTS.items()}}
    for name, (plan, rplan) in plans.items():
        got = engine.run_query_oracle(db, plan)
        want = np.asarray(RE.run_query_oracle(REF_DB, rplan))
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), \
            name
