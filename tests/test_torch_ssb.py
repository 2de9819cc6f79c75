"""The port's fused SSB path on the CPU against the reference package.

Same data in both (``ssb.generate`` with one seed, carried across with
``from_numpy``), same 13 plans.  Tolerances:

* against the numpy oracle ``run_query_oracle``: bit-identical — the port
  sums exactly in int64 and rounds to f32 once, as the oracle's exact
  float64 sum cast to f32 does;
* against the reference's fused ``ref`` path and its interpret-mode
  Pallas kernel: ``tests/test_ssb.py``'s rtol 1e-5 / atol 1e-3, because
  the reference sums in f32.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RREF
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro_torch import cases
from repro_torch.kernels import ref as TREF
from repro_torch.sql import engine as TE
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB

REF_DB = RSSB.generate(sf=0.01, seed=3)          # 60k fact rows
REF_DB_SMALL = RSSB.generate(sf=0.002, seed=5)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()


def _port_db(ref_db):
    return TSSB.from_numpy({t: getattr(ref_db, t).columns
                            for t in TSSB.TABLES}, ref_db.sf)


DB = _port_db(REF_DB)
DB_SMALL = _port_db(REF_DB_SMALL)


@pytest.mark.parametrize("sf,seed", [(0.002, 5), (0.01, 3), (0.004, 11)])
def test_generate_identical_to_reference(sf, seed):
    ref, port = RSSB.generate(sf=sf, seed=seed), TSSB.generate(sf=sf,
                                                              seed=seed)
    assert port.sf == ref.sf
    for t in TSSB.TABLES:
        r, p = getattr(ref, t), getattr(port, t)
        assert p.name == r.name and list(p.columns) == list(r.columns)
        for c in r.columns:
            assert p[c].dtype == r[c].dtype
            np.testing.assert_array_equal(p[c], r[c])


def test_from_numpy_round_trips_reference_database():
    assert DB.sf == REF_DB.sf
    for t in TSSB.TABLES:
        r, p = getattr(REF_DB, t), getattr(DB, t)
        assert p.n_rows == r.n_rows and list(p.columns) == list(r.columns)
        for c in r.columns:
            np.testing.assert_array_equal(p[c], r[c])
    with pytest.raises(ValueError, match="missing tables"):
        TSSB.from_numpy({"lineorder": REF_DB.lineorder.columns}, 0.01)


def test_resident_columns_upload_once():
    db = _port_db(REF_DB_SMALL)
    assert db.to("cpu") is db
    col = db.lineorder.on_device("lo_revenue", "cpu")
    assert db.lineorder.on_device("lo_revenue", torch.device("cpu")) is col
    assert db.lineorder.resident_bytes("cpu") == \
        4 * db.lineorder.n_rows * len(db.lineorder.columns)


@pytest.mark.parametrize("name", list(REF_Q))
def test_plans_match_reference(name):
    r, p = REF_Q[name], PORT_Q[name]
    assert p.name == r.name
    assert p.preds == r.preds
    assert (p.m1, p.m2, p.measure_op, p.n_groups) == \
        (r.m1, r.m2, r.measure_op, r.n_groups)
    assert len(p.joins) == len(r.joins)
    for pj, rj in zip(p.joins, r.joins):
        assert (pj.fact_col, pj.dim, pj.key_col, pj.mult) == \
            (rj.fact_col, rj.dim, rj.key_col, rj.mult)
        assert TP.fingerprint(pj.filter) == RC.P.fingerprint(rj.filter)
        assert TP.fingerprint(pj.payload) == RC.P.fingerprint(rj.payload)


REF_CASES = [
    dict(n_preds=2, n_joins=0, measure_op="mul", n_groups=1),
    dict(n_preds=0, n_joins=3, measure_op="first", n_groups=64),
    dict(n_preds=1, n_joins=2, measure_op="sub", n_groups=37,
         duplicates=True, wrap=True),
    dict(n_preds=1, n_joins=2, measure_op="first", n_groups=10,
         empty_join=True),
]


@pytest.mark.parametrize("i", range(len(REF_CASES)))
def test_ref_spja_matches_reference_ref(i):
    """Measures small enough that the reference's f32 sums are exact
    too: the comparison is exact."""
    c = cases.spja_case(100 + i, 1000, small=True, **REF_CASES[i])
    args, kw = c.args("cpu")
    got = TREF.spja(*args, **kw)
    f32 = (lambda a: None if a is None
           else jnp.asarray(a.astype(np.float32)))
    want = RREF.spja(
        tuple(jnp.asarray(a) for a in c.pred_cols),
        jnp.asarray(c.pred_bounds),
        tuple(jnp.asarray(a) for a in c.join_keys),
        tuple(jnp.asarray(a) for a in c.join_tables),
        jnp.asarray(c.group_mults), f32(c.m1), f32(c.m2), **kw)
    assert got.dtype == torch.float32 and got.shape == (c.n_groups,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not REF_CASES[i].get("empty_join"):
        assert got.abs().sum() > 0


@pytest.mark.parametrize("name", list(REF_Q))
def test_query_cpu_matches_oracle_and_reference(name):
    got = TE.run_query(DB, PORT_Q[name], device="cpu")
    assert got.dtype == np.float32 and got.shape == (PORT_Q[name].n_groups,)
    np.testing.assert_array_equal(got, RE.run_query_oracle(REF_DB,
                                                           REF_Q[name]))
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, PORT_Q[name]))
    want = RC.compile_plan(REF_Q[name], "fused").execute(REF_DB, mode="ref")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", ["q1.1", "q2.1", "q3.3", "q4.3"])
def test_query_cpu_matches_reference_interpret_kernel(name):
    got = TE.run_query(DB_SMALL, PORT_Q[name], device="cpu")
    want = RE.run_query(REF_DB_SMALL, REF_Q[name], mode="kernel", tile=512)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        got, RE.run_query_oracle(REF_DB_SMALL, REF_Q[name]))


def test_empty_build_side_gives_zeros_in_both():
    ref_plan = copy.deepcopy(REF_Q["q2.1"])
    port_plan = copy.deepcopy(PORT_Q["q2.1"])
    ref_plan.joins[1].filter = RC.P.EqPred("p_category", 999)
    port_plan.joins[1].filter = TP.EqPred("p_category", 999)
    got = TE.run_query(DB, port_plan, device="cpu")
    want = RC.compile_plan(ref_plan, "fused").execute(REF_DB, mode="ref")
    assert not got.any() and not np.asarray(want).any()
    np.testing.assert_array_equal(got, RE.run_query_oracle(REF_DB, ref_plan))


def test_q1_flight_selects_rows():
    """Guard against vacuous comparisons."""
    for name in ("q1.1", "q1.2", "q1.3", "q2.1", "q4.1"):
        assert TE.run_query(DB, PORT_Q[name], device="cpu").sum() > 0
