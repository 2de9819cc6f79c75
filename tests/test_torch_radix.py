"""The port's radix slice on the CPU against the reference package: the
plain ``histogram``, ``digit_counts``, ``partition_multi``, ``partition``
and ``radix_sort``, the radix sort's pass plan (``radix_part.pass_plan``,
which skips the passes that move no row), and ORDER BY
(``engine.order_by``, row plans ending in ``OrderBy``).

Same inputs in both (made with numpy from a seed; the database carried
across with ``from_numpy``).  Tolerance: bit-identical throughout — the
passes move integers.  Against the reference's interpret-mode Pallas
kernels at n <= 4096 (their scatter writes one element at a time), tiles
of 512 and 2048 rows; against the reference's jnp oracles at larger n.
``radix_sort`` is held to the reference on keys >= 0 only: on a negative
key the reference's own two modes disagree (its kernel sorts unsigned,
its oracle signed), and the port follows its kernel (ROADMAP.md queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import radix_part as RRADIX
from repro.kernels import ref as RREF
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro_torch import cases
from repro_torch.kernels import ops, radix_part, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB

REF_DB = RSSB.generate(sf=0.01, seed=3)          # 60k fact rows
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
CASES = list(enumerate(cases.RADIX_CASES))


def _ids(case):
    i, (start_bit, r, kind, n_vals) = case
    return f"{i}-{kind}-bit{start_bit}-r{r}-v{n_vals}"


def _both(seed, n, start_bit, r, kind, n_vals):
    """The case as torch tensors (the port) and jnp arrays (the
    reference)."""
    keys, vals, start_bit, r = cases.radix_case(seed, n, start_bit, r, kind,
                                                n_vals)
    t = cases.tensors((keys, vals), "cpu")
    return t[0], t[1], jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile", [512, 2048])
@pytest.mark.parametrize("n", [37, 4096])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_histogram_matches_reference_kernel(case, n, tile):
    i, (start_bit, r, kind, n_vals) = case
    tk, _, rk, _ = _both(i, n, start_bit, r, kind, n_vals)
    got = TREF.histogram(tk, start_bit, r, tile)
    assert got.dtype == torch.int32 and got.shape == (-(-n // tile), 1 << r)
    _same(got, RRADIX.histogram(rk, start_bit, r, tile=tile, interpret=True))
    _same(got, RREF.histogram(rk, start_bit, r, tile))


@pytest.mark.parametrize("kind", ["uniform", "negative", "one_bucket"])
@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("n", [2047, 2049, 4099])
def test_histogram_matches_reference_kernel_at_the_tile_edges(n, r, kind):
    """The part path's bucket widths (``model.part_bits``: 1-5 at SF 20)
    at the 2,048-row tile's edges: one row short of a tile, one past it,
    and a ragged third tile, where the card's kernel switches from its
    16-byte loads of a whole tile to 4-byte loads of a ragged one."""
    tk, _, rk, _ = _both(n + r, n, 0, r, kind, 1)
    got = TREF.histogram(tk, 0, r, 2048)
    assert got.shape == (-(-n // 2048), 1 << r)
    _same(got, RRADIX.histogram(rk, 0, r, tile=2048, interpret=True))


@pytest.mark.parametrize("n,tile", [(37, 512), (4096, 512), (3001, 2048)])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partition_multi_matches_reference_kernel(case, n, tile):
    i, (start_bit, r, kind, n_vals) = case
    tk, tv, rk, rv = _both(i, n, start_bit, r, kind, n_vals)
    got_k, got_v = TREF.partition_multi(tk, tv, start_bit, r)
    want_k, want_v = RRADIX.partition_multi(rk, rv, start_bit, r, tile=tile,
                                            interpret=True)
    _same(got_k, want_k)
    assert len(got_v) == n_vals
    for g, w in zip(got_v, want_v):
        _same(g, w)
    # stable: within a bucket the row numbers (payload 0) ascend
    b = TREF.bucket_of(got_k, start_bit, r)
    assert bool((b[1:] >= b[:-1]).all())
    same = b[1:] == b[:-1]
    assert bool((got_v[0][1:][same] > got_v[0][:-1][same]).all())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partition_passes_match_reference_oracle_at_larger_n(case):
    i, (start_bit, r, kind, n_vals) = case
    n = 100_003
    tk, tv, rk, rv = _both(100 + i, n, start_bit, r, kind, n_vals)
    _same(TREF.histogram(tk, start_bit, r), RREF.histogram(rk, start_bit, r,
                                                           2048))
    got_k, got_v = TREF.partition_multi(tk, tv, start_bit, r)
    want_k, want_v = RREF.partition_multi(rk, rv, start_bit, r)
    _same(got_k, want_k)
    for g, w in zip(got_v, want_v):
        _same(g, w)
    one_k, one_v = TREF.partition(tk, tv[0], start_bit, r)
    ref_k, ref_v = RREF.partition(rk, rv[0], start_bit, r)
    _same(one_k, ref_k)
    _same(one_v, ref_v)


@pytest.mark.parametrize("r", [4, 7, 8])
@pytest.mark.parametrize("n", [37, 2500])
def test_radix_sort_matches_reference_kernel_on_non_negative_keys(n, r):
    keys, (vals,), _, _ = cases.radix_case(n + r, n, 0, 1, "uniform", 1)
    got_k, got_v = TREF.radix_sort(torch.from_numpy(keys),
                                   torch.from_numpy(vals), r=r)
    want_k, want_v = RRADIX.radix_sort(jnp.asarray(keys), jnp.asarray(vals),
                                       r=r, tile=512, interpret=True)
    _same(got_k, want_k)
    _same(got_v, want_v)
    oracle_k, oracle_v = RREF.radix_sort(jnp.asarray(keys),
                                         jnp.asarray(vals))
    _same(got_k, oracle_k)
    _same(got_v, oracle_v)
    np.testing.assert_array_equal(got_v.numpy(),
                                  np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("kind", ["uniform", "duplicates"])
def test_radix_sort_matches_reference_oracle_at_larger_n(kind):
    keys, (vals,), _, _ = cases.radix_case(5, 200_003, 0, 1, kind, 1)
    keys = np.abs(keys.astype(np.int64)).clip(0, (1 << 31) - 1).astype(
        np.int32)                                   # keys >= 0
    got_k, got_v = ops.radix_sort(torch.from_numpy(keys),
                                  torch.from_numpy(vals))
    want_k, want_v = RREF.radix_sort(jnp.asarray(keys), jnp.asarray(vals))
    _same(got_k, want_k)
    _same(got_v, want_v)


def test_negative_keys_sort_unsigned_as_the_reference_kernel():
    """The reference's two modes disagree on a negative key: its kernel's
    LSB passes order the keys as unsigned words (-1 after 5), its oracle
    ``ref.radix_sort`` signed (-1 first).  The port's plain version gives
    the kernel's order."""
    keys = np.array([5, -1, 3, -(1 << 31), 0, 7, -1, 2], np.int32)
    vals = np.arange(len(keys), dtype=np.int32)
    kern_k, kern_v = RRADIX.radix_sort(jnp.asarray(keys), jnp.asarray(vals),
                                       tile=512, interpret=True)
    orac_k, orac_v = RREF.radix_sort(jnp.asarray(keys), jnp.asarray(vals))
    assert not np.array_equal(np.asarray(kern_v), np.asarray(orac_v))
    np.testing.assert_array_equal(np.asarray(orac_v),
                                  np.argsort(keys, kind="stable"))
    got_k, got_v = TREF.radix_sort(torch.from_numpy(keys),
                                   torch.from_numpy(vals))
    _same(got_k, kern_k)
    _same(got_v, kern_v)
    np.testing.assert_array_equal(
        got_v.numpy(), np.argsort(keys.view(np.uint32), kind="stable"))


def _planned_sort(keys, vals, key_bits, r):
    """The kernel ``radix_sort``'s passes with the plain pass: the plan of
    ``radix_part.pass_plan`` over the plain digit counts, then
    ``ref.partition`` for each pass it keeps -> ((keys', vals'), plan)."""
    counts = TREF.digit_counts(keys, 0, r,
                               radix_part.sort_passes(key_bits, r))
    plan = radix_part.pass_plan(counts, keys.shape[0])
    for p in plan:
        keys, vals = TREF.partition(keys, vals, p * r, r)
    return (keys, vals), plan


@pytest.mark.parametrize("key_bits", [32, 12])
@pytest.mark.parametrize("r", [1, 4, 7, 8])
@pytest.mark.parametrize("kind", cases.SORT_KINDS)
def test_pass_plan_skips_only_the_passes_that_move_nothing(kind, r,
                                                           key_bits):
    """Skipping a pass whose rows all share one bucket leaves the sort's
    bits as they were: the plain ``radix_sort``'s, the reference's kernel
    and oracle on keys >= 0, and numpy's stable argsort of the bits the
    passes cover."""
    keys, vals = cases.sort_case(r + key_bits, 2000, kind)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    (got_k, got_v), plan = _planned_sort(tk, tv, key_bits, r)
    passes = radix_part.sort_passes(key_bits, r)
    assert plan == [p for p in range(passes)
                    if TREF.bucket_of(tk, p * r, r).unique().numel() > 1]
    if kind == "equal":
        assert plan == []
    elif kind != "negative" and key_bits == 32:
        assert len(plan) < passes                 # a pass was skipped
    want_k, want_v = TREF.radix_sort(tk, tv, key_bits=key_bits, r=r)
    _same(got_k, want_k)
    _same(got_v, want_v)
    covered = keys.view(np.uint32).astype(np.uint64) & \
        ((1 << min(32, passes * r)) - 1)
    np.testing.assert_array_equal(got_v.numpy(),
                                  np.argsort(covered, kind="stable"))
    if key_bits == 32 and kind != "negative":
        oracle_k, oracle_v = RREF.radix_sort(jnp.asarray(keys),
                                             jnp.asarray(vals))
        _same(got_k, oracle_k)
        _same(got_v, oracle_v)
        if r == 8 and kind != "equal":
            kern_k, kern_v = RRADIX.radix_sort(
                jnp.asarray(keys), jnp.asarray(vals), r=r, tile=2048,
                interpret=True)
            _same(got_k, kern_k)
            _same(got_v, kern_v)


def test_pass_plan_of_an_empty_sort_runs_nothing():
    counts = TREF.digit_counts(torch.zeros(0, dtype=torch.int32), 0, 8, 4)
    assert counts.shape == (4, 256) and not counts.any()
    assert radix_part.pass_plan(counts, 0) == []
    assert radix_part.pass_plan(counts.numpy(), 0) == []


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_digit_counts_are_the_histograms_column_sums(case):
    """Every pass's plain digit counts, as many passes as fit from the
    case's start bit, against the column sums of the port's and the
    reference's per-tile histograms."""
    i, (start_bit, r, kind, n_vals) = case
    tk, _, rk, _ = _both(200 + i, 3001, start_bit, r, kind, n_vals)
    passes = min((31 - start_bit) // r + 1, radix_part.MAX_COUNTERS >> r)
    got = TREF.digit_counts(tk, start_bit, r, passes)
    assert got.dtype == torch.int32 and got.shape == (passes, 1 << r)
    for p in range(passes):
        bit = start_bit + p * r
        _same(got[p], TREF.histogram(tk, bit, r).sum(0))
        _same(got[p], np.asarray(RREF.histogram(rk, bit, r, 2048)).sum(0))


@pytest.mark.parametrize("fn,args", [
    ("radix_histogram", (0, 8)),
    ("radix_partition", (8, 4)),
    ("radix_partition_multi", (24, 8)),
    ("radix_sort", ()),
])
@pytest.mark.parametrize("mode", ["auto", "ref", "kernel"])
def test_radix_ops_modes_on_cpu_tensors(fn, args, mode):
    """``auto`` and ``ref`` run the plain version on CPU tensors;
    ``kernel`` raises: a CUDA kernel has no CPU form."""
    keys, vals, _, _ = cases.tensors(
        cases.radix_case(9, 3000, 0, 1, "negative", 2), "cpu")
    if fn == "radix_histogram":
        call = (keys, *args)
    elif fn in ("radix_partition", "radix_sort"):
        call = (keys, vals[0], *args)
    else:
        call = (keys, vals, *args)
    if mode == "kernel":
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            getattr(ops, fn)(*call, mode=mode)
        return
    got = getattr(ops, fn)(*call, mode=mode)
    want = {"radix_histogram": lambda: TREF.histogram(keys, *args),
            "radix_partition": lambda: TREF.partition(keys, vals[0], *args),
            "radix_partition_multi":
                lambda: TREF.partition_multi(keys, vals, *args),
            "radix_sort": lambda: TREF.radix_sort(keys, vals[0])}[fn]()
    flat = torch.utils._pytree.tree_leaves
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w)


def test_radix_wrappers_refuse_cpu_tensors_and_bad_widths():
    keys, vals, _, _ = cases.tensors(
        cases.radix_case(9, 300, 0, 1, "uniform", 1), "cpu")
    counters = ("HIST_LAUNCHES", "COUNT_LAUNCHES", "SCATTER_LAUNCHES")
    before = [getattr(radix_part, c) for c in counters]
    totals = TREF.digit_counts(keys, 0, 8)[0]
    for call in (lambda: radix_part.histogram(keys, 0, 8),
                 lambda: radix_part.digit_counts(keys, 0, 8),
                 lambda: radix_part.sweep(keys, vals, 0, 8, totals),
                 lambda: radix_part.partition_multi(keys, vals, 0, 8),
                 lambda: radix_part.radix_sort(keys, vals[0])):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            call()
    assert [getattr(radix_part, c) for c in counters] == before


# ---------------------------------------------------------------------------
# ORDER BY
# ---------------------------------------------------------------------------


def test_order_by_returns_the_reference_order():
    got = TE.order_by(DB.lineorder, "lo_orderdate", device="cpu")
    want = RE.order_by(REF_DB.lineorder, "lo_orderdate", mode="ref")
    assert set(got) == set(want)
    perm = np.argsort(DB.lineorder["lo_orderdate"], kind="stable")
    for c in want:
        np.testing.assert_array_equal(got[c], np.asarray(want[c]))
        np.testing.assert_array_equal(got[c], DB.lineorder[c][perm])


def _ordered_plan(mod):
    return (mod.QueryBuilder("ordered").scan("lineorder")
            .where_range("lo_discount", 1, 3)
            .hash_join("lo_orderdate", "date", "d_datekey",
                       dim_filter=mod.EqPred("d_year", 1993))
            .order_by("lo_revenue").build())


@pytest.mark.parametrize("strategy", ["opat", "fused", "part", "part_loop"])
def test_filter_join_order_by_row_plan_returns_reference_rowids(strategy):
    want = RC.compile_plan(_ordered_plan(RC.P), "opat").execute(
        REF_DB, mode="ref")
    q = TC.compile_plan(_ordered_plan(TP), strategy)
    assert q.strategy == "opat"
    got = q.execute(DB, device="cpu")
    assert q.decided == "opat"
    assert got.dtype == np.int32 and len(got) > 100
    np.testing.assert_array_equal(got, np.asarray(want))
    # numpy's stable argsort of the surviving rows' keys
    survivors = TC.compile_plan(
        TP.Plan("survivors", _ordered_plan(TP).root.child), "opat").execute(
            DB, device="cpu")
    rev = DB.lineorder["lo_revenue"][survivors]
    np.testing.assert_array_equal(
        got, survivors[np.argsort(rev, kind="stable")])


def test_row_plan_falls_back_to_opat_with_reference_reason():
    for strategy in ("fused", "part", "part_loop"):
        ref_q = RC.compile_plan(_ordered_plan(RC.P), strategy)
        port_q = TC.compile_plan(_ordered_plan(TP), strategy)
        assert ref_q.fallback_reason
        assert (port_q.strategy, port_q.requested, port_q.fallback_reason) \
            == ("opat", strategy, ref_q.fallback_reason)


def test_order_by_on_an_empty_selection_returns_no_rows():
    plan = (TE.QueryBuilder("none").scan("lineorder")
            .where_range("lo_discount", 50, 60).order_by("lo_revenue")
            .build())
    got = TC.compile_plan(plan, "opat").execute(DB, device="cpu")
    assert got.dtype == np.int32 and got.shape == (0,)
