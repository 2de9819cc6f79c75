"""The port's dimension hash tables (``repro_torch.sql.hashtable``) against
the reference's: byte-identical tables for every join of the 13 SSB plans
on the same data, and the cache's hit/miss/rebinding contract."""
import numpy as np
import pytest
import torch

from repro.sql import engine as RE
from repro.sql import hashtable as RHT
from repro.sql import ssb as RSSB
from repro_torch.sql import engine as TE
from repro_torch.sql import hashtable as THT
from repro_torch.sql import ssb as TSSB

REF_DB = RSSB.generate(sf=0.01, seed=3)


def _port_db(ref_db):
    return TSSB.from_numpy({t: getattr(ref_db, t).columns
                            for t in TSSB.TABLES}, ref_db.sf)


DB = _port_db(REF_DB)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()
JOINS = [(name, j) for name, p in REF_Q.items() for j in range(len(p.joins))]


@pytest.mark.parametrize("name,j", JOINS)
def test_build_dim_table_byte_identical(name, j):
    want_k, want_v = RHT.build_dim_table(REF_DB, REF_Q[name].joins[j])
    got_k, got_v = THT.build_dim_table(DB, PORT_Q[name].joins[j], "cpu")
    assert got_k.dtype == torch.int32 and got_v.dtype == torch.int32
    assert got_k.numpy().tobytes() == np.asarray(want_k).tobytes()
    assert got_v.numpy().tobytes() == np.asarray(want_v).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_np_build_matches_reference_with_duplicates(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-500, 500, 800, dtype=np.int32)   # many duplicates
    vals = rng.integers(0, 1000, 800, dtype=np.int32)
    n_slots = THT.next_pow2(len(keys))
    assert n_slots == RHT.next_pow2(len(keys))
    for got, want in zip(THT.np_build(keys, vals, n_slots),
                         RHT.np_build(keys, vals, n_slots)):
        assert got.tobytes() == want.tobytes()


def test_cache_hits_misses_and_device_scope():
    cache = THT.HashTableCache()
    q = PORT_Q["q2.1"]
    first = cache.get_or_build(DB, q.joins[0], "cpu")
    assert (cache.hits, cache.misses) == (0, 1)
    again = cache.get_or_build(DB, q.joins[0], "cpu")
    assert again is first and (cache.hits, cache.misses) == (1, 1)
    # q2.2 shares q2.1's supplier build side only by structure: different
    # region, so a miss; the date join is shared across flight 2 (a hit)
    cache.get_or_build(DB, PORT_Q["q2.2"].joins[0], "cpu")
    cache.get_or_build(DB, PORT_Q["q2.2"].joins[2], "cpu")
    cache.get_or_build(DB, q.joins[2], "cpu")
    assert (cache.hits, cache.misses) == (2, 3)
    assert cache.hit_rate == pytest.approx(2 / 5)
    assert cache.evict_cold(keep=1) == 2 and len(cache.tables) == 1


def test_cache_rebinds_reloaded_db_and_rejects_other_data():
    cache = THT.HashTableCache()
    join = PORT_Q["q3.1"].joins[0]
    cache.get_or_build(DB, join, "cpu")
    reloaded = _port_db(RSSB.generate(sf=0.01, seed=3))
    cache.get_or_build(reloaded, join, "cpu")
    assert (cache.hits, cache.misses) == (1, 1)     # same data: kept warm
    other = _port_db(RSSB.generate(sf=0.01, seed=4))
    with pytest.raises(ValueError, match="scoped to one Database"):
        cache.get_or_build(other, join, "cpu")
    cache.reset()
    cache.get_or_build(other, join, "cpu")
    assert len(cache.tables) == 1 and cache.misses == 2


def test_callable_build_sides_are_not_cached():
    cache = THT.HashTableCache()
    import copy
    plan = copy.deepcopy(PORT_Q["q2.1"])
    plan.joins[1].filter = lambda t: np.asarray(t["p_category"]) == 1
    a = cache.get_or_build(DB, plan.joins[1], "cpu")
    want = THT.build_dim_table(DB, PORT_Q["q2.1"].joins[1], "cpu")
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    assert len(cache.tables) == 0


def test_negative_payload_rejected():
    import copy
    plan = copy.deepcopy(PORT_Q["q4.1"])
    plan.joins[0].payload = TE.AffineExpr("c_nation", 1, -100)
    with pytest.raises(ValueError, match="payloads must be >= 0"):
        THT.build_dim_table(DB, plan.joins[0], "cpu")
