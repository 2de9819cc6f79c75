"""The port's shared-scan waves on the CPU against the reference package:
the plain ``multi_spja``, the wave lowering (``shared_params`` and its
helpers), ``execute_shared`` and ``compile_plan(plan, "shared")``.

Same inputs in both (made with numpy from a seed; the database carried
across with ``from_numpy``).  Tolerances:

* ``ref.multi_spja`` against the reference's interpret-mode Pallas
  ``multi_spja`` and its jnp oracle: bit-identical on small measures,
  where every f32 partial sum of the reference stays below 2^24 (the
  port sums exactly in int64 and rounds once);
* ``shared_params``' stacked arrays, widths, references and tables:
  byte-identical; its streams equal the reference's values;
* waves of SSB queries and of random plans: bit-identical to the port's
  solo fused results and to the numpy oracle; within
  ``tests/test_ssb.py``'s rtol 1e-5 / atol 1e-3 of the reference's
  ``execute_shared(mode="ref")``, which sums in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro.sql import storage as RST
from repro_torch import cases
from repro_torch.kernels import ops, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import hashtable as THT
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB
from repro_torch.sql import storage as TST

REF_DB = RSSB.generate(sf=0.005, seed=11)        # 30k fact rows
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
REF_PDB = RST.pack_database(REF_DB)
PDB = TST.pack_database(DB)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()
TOL = dict(rtol=1e-5, atol=1e-3)


def _np(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# the plain multi_spja against the reference's kernel and oracle
# ---------------------------------------------------------------------------

# (n, members, preds, joins, n_groups, padding, extra)
KERNEL_CASES = [
    (1000, 3, 2, 3, 40, 2, dict(duplicates=True, wrap=True)),
    (4096, 5, 3, 4, 120, 3, dict(shared_table=True, empty_join=True)),
    (777, 2, 1, 2, 1, 1, {}),
]


def _reference_multi(case, mode: str, tile: int) -> np.ndarray:
    """The reference's ``ops.multi_spja`` on the case's host arrays."""
    kw = dict(case.packed or {})
    for k in ("key_refs", "m_refs"):
        if k in kw:
            kw[k] = jnp.asarray(kw[k])
    return np.asarray(ROPS.multi_spja(
        [jnp.asarray(c) for c in case.pred_cols],
        jnp.asarray(case.pred_bounds),
        [jnp.asarray(k) for k in case.join_keys],
        [jnp.asarray(t) for t in case.join_tables],
        jnp.asarray(case.join_mults), jnp.asarray(case.join_use),
        jnp.asarray(case.q_valid),
        [jnp.asarray(m) for m in case.measure_cols],
        jnp.asarray(case.measure_sel), n_groups=case.n_groups, mode=mode,
        tile=tile, **kw))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("i", range(len(KERNEL_CASES)))
def test_plain_multi_spja_matches_reference_kernel_and_oracle(i, packed):
    n, q, c, j, g, pad, extra = KERNEL_CASES[i]
    case = cases.multi_spja_case(600 + i, n, q, c, j, g, pad=pad,
                                 small=True, packed=packed, pred_phys=4,
                                 m_offset=0, **extra)
    args, kw = case.args("cpu")
    got = TREF.multi_spja(*args, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (q + pad, g)
    assert got[:q].any() and not got[q:].any()
    np.testing.assert_array_equal(got, _reference_multi(case, "ref", 256))
    for tile in (256, 1024):
        np.testing.assert_array_equal(
            got, _reference_multi(case, "kernel", tile), err_msg=str(tile))
    # ops: auto and ref run the plain version on CPU tensors
    for mode in ("auto", "ref"):
        assert torch.equal(ops.multi_spja(*args, mode=mode, **kw),
                           torch.from_numpy(got))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.multi_spja(*args, mode="kernel", **kw)


def test_plain_multi_spja_sums_exactly_past_f32():
    """Large measures: the reference's f32 sums round, the port's equal
    the exact int64 sum rounded once."""
    case = cases.multi_spja_case(9, 4096, 4, 2, 3, 30, pad=1)
    args, kw = case.args("cpu")
    got = TREF.multi_spja(*args, **kw).numpy()
    np.testing.assert_allclose(got, _reference_multi(case, "ref", 256),
                               **TOL)
    for q in range(4):                  # one member at a time, in int64
        one = [a[q:q + 1] if isinstance(a, np.ndarray) else a for a in args]
        assert np.array_equal(TREF.multi_spja(*one, **kw).numpy()[0],
                              got[q])


def test_plain_multi_spja_checks_its_parameters():
    case = cases.multi_spja_case(2, 100, 2, 1, 1, 4)
    args, kw = case.args("cpu")
    for pos, bad, what in ((8, [[0, 0, 0], [3, 0, 0]], "measure_sel"),
                           (8, [[0, 0, 3], [0, 0, 0]], "measure_sel"),
                           (5, [[2], [0]], "join_use"),
                           (6, [1, 2], "q_valid"),
                           (4, [[1 << 31], [0]], "join_mults")):
        b = list(args)
        b[pos] = np.array(bad)
        with pytest.raises(ValueError, match=what):
            TREF.multi_spja(*b, **kw)


# ---------------------------------------------------------------------------
# the wave lowering
# ---------------------------------------------------------------------------

WAVES = {
    "all13": (list(PORT_Q), {}),
    "all13_pad16": (list(PORT_Q), dict(pad_to=16)),
    "anchored": (["q1.2", "q2.1", "q4.3"], dict(anchor=True, pad_to=4)),
    "flight2_4": (["q2.1", "q2.2", "q2.3", "q4.1", "q4.2", "q4.3"], {}),
}


def _lower(wave: str, packed: bool):
    names, kw = WAVES[wave]
    kw = dict(kw)
    anchor = kw.pop("anchor", False)
    ref_db, db = (REF_PDB, PDB) if packed else (REF_DB, DB)
    rplans = [REF_Q[n] for n in names]
    tplans = [PORT_Q[n] for n in names]
    r = RC.shared_params(rplans, ref_db, **kw, anchor=RC.anchor_for(
        rplans, list(REF_Q.values())) if anchor else None)
    t = TC.shared_params(tplans, db, **kw, device="cpu",
                         anchor=TC.anchor_for(tplans, list(PORT_Q.values()))
                         if anchor else None)
    return r, t, tplans


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wave", list(WAVES))
def test_shared_params_byte_identical_to_reference(wave, packed):
    (_, rargs, rkw, rgroups), (_, targs, tkw, tgroups), plans = \
        _lower(wave, packed)
    assert tgroups == rgroups
    # bounds, mults, use, valid, selectors
    for pos in (1, 4, 5, 6, 8):
        r, t = np.asarray(rargs[pos]), _np(targs[pos])
        assert t.dtype == r.dtype == np.int32 and t.shape == r.shape, pos
        assert t.tobytes() == r.tobytes(), pos
    for k in ("pred_widths", "key_widths", "m_widths", "n_rows"):
        assert tkw[k] == rkw[k], k
    for k in ("key_refs", "m_refs"):
        assert _np(tkw[k]).tobytes() == np.asarray(rkw[k]).tobytes(), k
    np.testing.assert_array_equal(
        tkw["member_groups"][:len(plans)], [p.n_groups for p in plans])
    assert not tkw["member_groups"][len(plans):].any()
    # streams: the same values (the reference's plain measures are f32
    # copies; the port's the int32 columns) and byte-identical tables
    for pos in (0, 2, 3, 7):
        assert len(targs[pos]) == len(rargs[pos]), pos
        for t, r in zip(targs[pos], rargs[pos]):
            t, r = _np(t), np.asarray(r)
            assert t.dtype == np.int32
            if pos == 3:
                assert t.tobytes() == r.tobytes()
            else:
                np.testing.assert_array_equal(t, r.astype(np.int64))


def test_anchored_wave_gives_anchor_only_joins_no_weight():
    (_, rargs, _, _), (_, targs, _, _), _ = _lower("anchored", False)
    use, mults, valid = _np(targs[5]), _np(targs[4]), _np(targs[6])
    n_all = len({TC.shared_join_key(j) for p in PORT_Q.values()
                 for j in p.joins})
    assert use.shape[1] == n_all               # the whole pool's joins
    unused = ~use[valid > 0].any(axis=0)
    assert unused.any() and not mults[:, unused].any()


def test_a_member_joining_one_build_side_twice_sums_its_mults():
    def twice(mod):
        date = ("lo_orderdate", "date", "d_datekey")
        return (mod.QueryBuilder("twice").scan("lineorder")
                .hash_join(*date, payload=mod.ColExpr("d_year"), mult=1)
                .hash_join(*date, payload=mod.ColExpr("d_year"), mult=3)
                .measure("lo_revenue").group_by(8000).build())
    tplan, rplan = twice(TP), twice(RC.P)
    _, targs, _, _ = TC.shared_params([tplan], DB, device="cpu")
    _, rargs, _, _ = RC.shared_params([rplan], REF_DB)
    assert _np(targs[4]).tolist() == [[4]] == np.asarray(rargs[4]).tolist()
    got = TC.execute_shared([tplan], DB, device="cpu")[0]
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, tplan))
    np.testing.assert_allclose(got, RC.execute_shared([rplan], REF_DB,
                                                      mode="ref")[0], **TOL)


def test_footprint_and_member_keys_equal_reference():
    tplans, rplans = list(PORT_Q.values()), list(REF_Q.values())
    tcol, tjoins, tmeas = TC.shared_footprint(tplans)
    rcol, rjoins, rmeas = RC.shared_footprint(rplans)
    assert (tcol, tmeas) == (rcol, rmeas)
    assert [TC.shared_join_key(j) for j in tjoins] == \
        [RC.shared_join_key(j) for j in rjoins]
    assert len(tjoins) == 21 and len(tcol) == 3 and len(tmeas) == 4
    assert [TC.shared_member_key(p) for p in tplans] == \
        [RC.shared_member_key(p) for p in rplans]


# ---------------------------------------------------------------------------
# execute_shared and compile_plan(plan, "shared")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_13_query_wave_matches_fused_oracle_and_reference(packed):
    db, ref_db = (PDB, REF_PDB) if packed else (DB, REF_DB)
    plans = list(PORT_Q.values())
    cache = THT.HashTableCache()
    outs = TC.execute_shared(plans, db, cache=cache, pad_to=16,
                             device="cpu")
    assert cache.misses == 21 and cache.hits == 0
    refs = RC.execute_shared(list(REF_Q.values()), ref_db, mode="ref",
                             pad_to=16)
    for plan, got, want in zip(plans, outs, refs):
        assert got.dtype == np.float32 and got.shape == (plan.n_groups,)
        np.testing.assert_array_equal(got, TE.run_query_oracle(db, plan),
                                      err_msg=plan.name)
        np.testing.assert_array_equal(
            got, TE.run_query(db, plan, cache=cache, device="cpu"),
            err_msg=plan.name)
        np.testing.assert_allclose(got, want, **TOL, err_msg=plan.name)
    assert cache.misses == 21                  # the solo runs all hit


def test_compile_plan_shared_singleton_matches_fused():
    q = TC.compile_plan(PORT_Q["q3.1"], "shared")
    assert (q.strategy, q.requested, q.fallback_reason) == \
        ("shared", "shared", None)
    out = q.execute(DB, device="cpu")
    assert q.decided == "shared"
    np.testing.assert_array_equal(
        out, TE.run_query(DB, PORT_Q["q3.1"], device="cpu"))
    np.testing.assert_array_equal(
        out, TE.run_query(DB, PORT_Q["q3.1"], device="cpu",
                          strategy="shared"))


def test_shared_fallback_reason_equals_the_reference():
    def rows(mod):
        return (mod.QueryBuilder("rows").scan("lineorder")
                .where_range("lo_discount", 1, 3).build())
    ref_q = RC.compile_plan(rows(RC.P), "shared")
    port_q = TC.compile_plan(rows(TP), "shared")
    assert "row-returning" in ref_q.fallback_reason
    assert (port_q.strategy, port_q.requested, port_q.fallback_reason) == \
        ("opat", "shared", ref_q.fallback_reason)


def test_execute_shared_padding_is_inert():
    plans = [PORT_Q[n] for n in ("q1.1", "q2.1", "q3.3")]
    plain = TC.execute_shared(plans, DB, device="cpu")
    padded = TC.execute_shared(plans, DB, pad_to=8, device="cpu")
    for a, b in zip(plain, padded):
        assert a.tobytes() == b.tobytes()


def test_execute_shared_dedups_build_sides():
    """q2.1/q2.2/q2.3 and q4.1 share the unfiltered date build side: the
    wave builds each distinct table once."""
    plans = [PORT_Q[n] for n in ("q2.1", "q2.2", "q2.3", "q4.1")]
    cache = THT.HashTableCache()
    TC.execute_shared(plans, DB, cache=cache, device="cpu")
    n_distinct = len({TC.shared_join_key(j) for p in plans
                      for j in p.joins})
    assert cache.misses == n_distinct
    assert n_distinct < sum(len(p.joins) for p in plans)


def test_execute_shared_rejects_incompatible_groups():
    other = (TP.QueryBuilder("dimscan").scan("date")
             .measure("d_year").group_by(1).build())
    with pytest.raises(ValueError, match="scan-incompatible"):
        TC.execute_shared([PORT_Q["q1.1"], other], DB, device="cpu")
    row_plan = (TP.QueryBuilder("rows").scan("lineorder")
                .where_range("lo_discount", 1, 3).build())
    with pytest.raises(ValueError, match="cannot join a shared wave"):
        TC.execute_shared([PORT_Q["q1.1"], row_plan], DB, device="cpu")
    with pytest.raises(ValueError, match="at least one plan"):
        TC.execute_shared([], DB, device="cpu")


def random_agg_plan(mod, rng, name):
    """A random shareable SPJA plan over the SSB schema (the reference's
    ``tests/test_shared_scan.py::random_agg_plan``, for either package's
    plan module)."""
    b = mod.QueryBuilder(name).scan("lineorder")
    pred_pool = (("lo_orderdate", 0, TSSB.N_DATES - 1),
                 ("lo_discount", 0, 10), ("lo_quantity", 1, 50),
                 ("lo_extendedprice", 1, 999))
    for col, lo, hi in pred_pool:
        if rng.random() < 0.5:
            a, c = sorted(rng.integers(lo, hi + 1, size=2))
            b = b.where_range(col, int(a), int(c))
    join_pool = (
        ("lo_orderdate", "date", "d_datekey",
         mod.EqPred("d_year", int(rng.integers(1992, 1999))),
         mod.ColExpr("d_weeknuminyear")),
        ("lo_suppkey", "supplier", "s_suppkey",
         mod.RangePred("s_region", 0, int(rng.integers(0, 5))),
         mod.ColExpr("s_nation")),
        ("lo_partkey", "part", "p_partkey",
         mod.RangePred("p_mfgr", 0, int(rng.integers(0, 5))),
         mod.ColExpr("p_category")),
    )
    mult = 1
    n_groups = 1
    for fact_col, dim, key, filt, payload in join_pool:
        if rng.random() < 0.6:
            payload_max = {"d_weeknuminyear": 53, "s_nation": 24,
                           "p_category": 24}[payload.col]
            b = b.hash_join(fact_col, dim, key, dim_filter=filt,
                            payload=payload, mult=mult)
            n_groups = (payload_max + 1) * mult
            mult = n_groups
    measures = (("lo_revenue", None, "first"),
                ("lo_extendedprice", "lo_discount", "mul"),
                ("lo_revenue", "lo_supplycost", "sub"))
    m1, m2, op = measures[int(rng.integers(0, len(measures)))]
    return b.measure(m1, m2, op).group_by(max(n_groups, 1)).build()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_plan_waves_match_oracle_and_reference(seed):
    def wave(mod):
        rng = np.random.default_rng(seed)
        return [random_agg_plan(mod, rng, f"rand{seed}.{i}")
                for i in range(int(rng.integers(2, 6)))]
    tplans, rplans = wave(TP), wave(RC.P)
    outs = TC.execute_shared(tplans, DB, pad_to=8, device="cpu")
    refs = RC.execute_shared(rplans, REF_DB, mode="ref", pad_to=8)
    for plan, got, want in zip(tplans, outs, refs):
        np.testing.assert_array_equal(got, TE.run_query_oracle(DB, plan),
                                      err_msg=plan.name)
        np.testing.assert_allclose(got, want, **TOL, err_msg=plan.name)
