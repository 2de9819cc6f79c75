"""The port's operator-at-a-time path on the CPU against the reference
package: the plain versions of the four kernels it runs, and the 13 SSB
queries through ``opat``.

Same inputs in both (made with numpy from a seed; the database carried
across with ``from_numpy``).  Tolerances:

* ``select_scan``, ``probe_join``, ``project`` without sigmoid, and
  ``group_sum`` on integer-valued inputs: bit-identical to the
  reference's interpret-mode Pallas kernel (on ``[:count]``; its padded
  tail is arbitrary) and to its jnp oracle;
* ``project`` with sigmoid: rtol 1e-6, as ``tests/test_kernels.py`` holds
  the reference (exp differs in the last bits between libraries); against
  the interpreted Pallas kernel, whose body XLA contracts into an FMA,
  bit-identical only for the chain's a = 1, b = -1, else the reference's
  own rtol 1e-6 / atol 1e-6;
* the 13 queries: bit-identical to the numpy oracle and to the port's
  fused path (both sum exactly and round once); within
  ``tests/test_ssb.py``'s rtol 1e-5 / atol 1e-3 of the reference's opat,
  which sums in f32.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as RB
from repro.kernels import agg as RAGG
from repro.kernels import hash_join as RHJ
from repro.kernels import project as RPROJ
from repro.kernels import ref as RREF
from repro.kernels import select_scan as RSEL
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro_torch import cases
from repro_torch.core import blocks as TB
from repro_torch.kernels import ops, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB

SIZES = [37, 1000, 4099]
REF_DB = RSSB.generate(sf=0.01, seed=3)          # 60k fact rows
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()


def _cpu(case):
    return cases.tensors(case, "cpu")


def _jnp(case):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in case)


# ---------------------------------------------------------------------------
# block functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 37, 4099])
def test_block_scan_and_shuffle_match_reference(n):
    rng = np.random.default_rng(n)
    bitmap = (rng.random(n) < 0.4).astype(np.int32)
    tile = rng.integers(-1000, 1000, n, dtype=np.int32)
    r_off, r_tot = RB.block_scan(jnp.asarray(bitmap))
    t_off, t_tot = TB.block_scan(torch.from_numpy(bitmap))
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(r_off))
    assert t_tot.dim() == 0 and int(t_tot) == int(r_tot)
    r_out = np.asarray(RB.block_shuffle(jnp.asarray(tile),
                                        jnp.asarray(bitmap), r_off))
    t_out = TB.block_shuffle(torch.from_numpy(tile),
                             torch.from_numpy(bitmap), t_off).numpy()
    cnt = int(t_tot)
    np.testing.assert_array_equal(t_out[:cnt], r_out[:cnt])
    np.testing.assert_array_equal(t_out[:cnt], tile[bitmap > 0])
    assert not t_out[cnt:].any()


# ---------------------------------------------------------------------------
# plain versions vs the reference kernels (interpret mode) and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sel,dtype", [("mid", "int32"), ("none", "int32"),
                                       ("all", "int32"),
                                       ("mid", "float32")])
def test_select_scan_matches_reference(n, sel, dtype):
    case = cases.select_case(n, n, sel, dtype)
    out, cnt = TREF.select_scan(*_cpu(case))
    assert out.shape == (n,) and out.dtype == torch.int32 and cnt.dim() == 0
    cnt = int(cnt)
    assert cnt == {"none": 0, "all": n}.get(sel, cnt)
    k_out, k_cnt = RSEL.select_scan(*_jnp(case), interpret=True)
    assert int(k_cnt) == cnt
    np.testing.assert_array_equal(out.numpy()[:cnt], np.asarray(k_out)[:cnt])
    r_out, r_cnt = RREF.select_scan(*_jnp(case))
    assert int(r_cnt) == cnt
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", cases.PROBE_KINDS)
def test_probe_join_matches_reference(n, kind):
    case = cases.probe_case(n + 7, n, kind)
    pay, vals, cnt = TREF.probe_join(*_cpu(case))
    cnt = int(cnt)
    assert (cnt > 0) == (kind == "duplicate_wrap")
    k_pay, k_vals, k_cnt = RHJ.probe_join(*_jnp(case), interpret=True)
    assert int(k_cnt) == cnt
    np.testing.assert_array_equal(pay.numpy()[:cnt], np.asarray(k_pay)[:cnt])
    np.testing.assert_array_equal(vals.numpy()[:cnt],
                                  np.asarray(k_vals)[:cnt])
    r_pay, r_vals, r_cnt = RREF.probe_join(*_jnp(case))
    assert int(r_cnt) == cnt
    np.testing.assert_array_equal(pay.numpy(), np.asarray(r_pay))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("a,b", [(1.0, -1.0), (0.75, -1.25)])
def test_project_matches_reference(n, sigmoid, a, b):
    case = cases.project_case(n, n)
    got = TREF.project(*_cpu(case), a, b, sigmoid=sigmoid).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    kernel = np.asarray(RPROJ.project(*_jnp(case), a, b, sigmoid=sigmoid,
                                      interpret=True))
    oracle = np.asarray(RREF.project(*_jnp(case), a, b, sigmoid=sigmoid))
    if sigmoid:
        np.testing.assert_allclose(got, oracle, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, oracle)
    if (a, b) == (1.0, -1.0) and not sigmoid:   # the opat chain's call
        np.testing.assert_array_equal(got, kernel)
    else:
        # XLA contracts the interpreted kernel body into an FMA: the
        # reference's own tolerance for its kernel (tests/test_kernels.py)
        np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["int32_overflow", "f32_integers"])
@pytest.mark.parametrize("n_groups", [1, 37, 700])
def test_group_sum_matches_reference(n, kind, n_groups):
    ids, vals, _ = case = cases.group_case(n + n_groups, n, n_groups, kind)
    got = TREF.group_sum(*_cpu(case)).numpy()
    assert got.dtype == vals.dtype and got.shape == (n_groups,)
    kernel = RAGG.group_sum(jnp.asarray(ids), jnp.asarray(vals), n_groups,
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(kernel))
    np.testing.assert_array_equal(
        got, np.asarray(RREF.group_sum(jnp.asarray(ids), jnp.asarray(vals),
                                       n_groups)))
    if kind == "int32_overflow":
        exact = np.zeros(n_groups, np.int64)
        np.add.at(exact, ids, vals.astype(np.int64))
        assert (exact > np.iinfo(np.int32).max).any() or n < 100


def test_group_sum_sums_f32_in_f64_and_drops_out_of_range_ids():
    ids, vals, n_groups = case = cases.group_case(5, 4099, 50, "f32_random",
                                                  out_of_range=True)
    got = TREF.group_sum(*_cpu(case)).numpy()
    keep = (ids >= 0) & (ids < n_groups)
    exact = np.zeros(n_groups, np.float64)
    np.add.at(exact, ids[keep], vals[keep].astype(np.float64))
    np.testing.assert_array_equal(got, exact.astype(np.float32))


@pytest.mark.parametrize("fn", ["select_scan", "probe_join", "project",
                                "group_sum"])
def test_ops_modes_on_cpu_tensors(fn):
    """``auto`` and ``ref`` run the plain version on CPU tensors;
    ``kernel`` raises (a CUDA kernel has no CPU form)."""
    args = {"select_scan": _cpu(cases.select_case(1, 64)),
            "probe_join": _cpu(cases.probe_case(1, 64)),
            "project": _cpu(cases.project_case(1, 64)) + (1.0, -1.0),
            "group_sum": _cpu(cases.group_case(1, 64, 4))}[fn]
    want = getattr(TREF, fn)(*args)
    for mode in ("auto", "ref"):
        got = getattr(ops, fn)(*args, mode=mode)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        getattr(ops, fn)(*args, mode="kernel")


# ---------------------------------------------------------------------------
# the opat path, whole queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(REF_Q))
def test_opat_query_matches_oracle_fused_and_reference(name):
    q = TC.compile_plan(PORT_Q[name], "opat")
    assert (q.strategy, q.requested, q.fallback_reason) == \
        ("opat", "opat", None)
    got = q.execute(DB, device="cpu")
    assert q.decided == "opat"
    assert got.dtype == np.float32 and got.shape == (PORT_Q[name].n_groups,)
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, PORT_Q[name]))
    np.testing.assert_array_equal(got, TE.run_query(DB, PORT_Q[name],
                                                    device="cpu"))
    want = RC.compile_plan(REF_Q[name], "opat").execute(REF_DB, mode="ref")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_row_plan_returns_reference_rowids():
    def plan(mod):
        return (mod.QueryBuilder("rows").scan("lineorder")
                .where_range("lo_discount", 1, 3)
                .hash_join("lo_suppkey", "supplier", "s_suppkey",
                           dim_filter=mod.EqPred("s_region", 2))
                .build())
    want = RC.compile_plan(plan(RC.P), "opat").execute(REF_DB, mode="ref")
    got = TC.compile_plan(plan(TP), "opat").execute(DB, device="cpu")
    assert got.dtype == np.int32 and len(got) > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    fused = TC.compile_plan(plan(TP), "fused")
    assert fused.strategy == "opat"
    np.testing.assert_array_equal(fused.execute(DB, device="cpu"), got)


def _thirds(table):
    return np.asarray(table["lo_quantity"]) % 3 == 0


def _generic_pred_plan(mod):
    return (mod.QueryBuilder("generic").scan("lineorder")
            .filter(_thirds)
            .hash_join("lo_suppkey", "supplier", "s_suppkey",
                       dim_filter=mod.EqPred("s_region", 1),
                       payload=mod.ColExpr("s_nation"), mult=1)
            .measure("lo_revenue").group_by(25).build())


def test_non_fusable_plans_fall_back_to_opat_with_reference_reason():
    for make in (_generic_pred_plan,
                 lambda mod: (mod.QueryBuilder("rows").scan("lineorder")
                              .where_range("lo_discount", 1, 3).build())):
        ref_q = RC.compile_plan(make(RC.P), "fused")
        port_q = TC.compile_plan(make(TP), "fused")
        assert ref_q.fallback_reason is not None
        assert (port_q.strategy, port_q.requested, port_q.fallback_reason) \
            == ("opat", "fused", ref_q.fallback_reason)
    plan = _generic_pred_plan(TP)
    got = TC.compile_plan(plan, "fused").execute(DB, device="cpu")
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, plan))
    want = RC.compile_plan(_generic_pred_plan(RC.P), "fused").execute(
        REF_DB, mode="ref")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert got.sum() > 0


def test_plan_past_the_fused_caps_runs_opat_with_the_same_result():
    """The reference fuses any count of predicates; the port's kernel takes
    8 of each, so a ninth predicate lowers opat — same answer."""
    def plan(mod):
        b = mod.QueryBuilder("nine").scan("lineorder")
        for i in range(9):
            b = b.where_range("lo_quantity", i, 50 - i)
        return (b.hash_join("lo_suppkey", "supplier", "s_suppkey",
                            payload=mod.ColExpr("s_region"), mult=1)
                .measure("lo_revenue").group_by(5).build())
    ref_q = RC.compile_plan(plan(RC.P), "fused")
    assert ref_q.strategy == "fused"
    port_q = TC.compile_plan(plan(TP), "fused")
    assert port_q.strategy == "opat"
    assert "at most 8 and 8" in port_q.fallback_reason
    got = port_q.execute(DB, device="cpu")
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, plan(TP)))
    np.testing.assert_allclose(got, ref_q.execute(REF_DB, mode="ref"),
                               rtol=1e-5, atol=1e-3)
    assert got.sum() > 0


def test_opat_empty_build_side_gives_zeros():
    port_plan = copy.deepcopy(PORT_Q["q4.1"])
    port_plan.joins[2].filter = TP.EqPred("p_mfgr", 999)
    got = TC.compile_plan(port_plan, "opat").execute(DB, device="cpu")
    assert got.shape == (35,) and not got.any()
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, port_plan))
