"""The port's CUDA kernels on the card, held against their plain versions.

Needs an NVIDIA GPU: every test here skips without one.  Imports nothing
of jax or the reference package, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: bit-identical, except two cases that say why.  The fused
kernel sums exactly in int64 and the compactions are ordered by tile
offsets, so block order cannot change a result.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.core import blocks as core_blocks
from repro_torch.kernels import (agg, build, hash_join, multi_fused, ops,
                                 part_probe, project, radix_part, ref,
                                 select_scan, ssb_fused, unpack)
from repro_torch.sql import compile as compile_, engine, hashtable, ssb, \
    storage
from repro_torch.configs import base as lm_configs
from repro_torch.configs.base import ARCH_IDS as LM_ARCH_IDS
from repro_torch.models import api as lm_api
from repro_torch.models import smoke as lm_smoke
from repro_torch.serve import engine as lm_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


CASES = [
    dict(n=1, n_preds=1, n_joins=1, measure_op="first", n_groups=4),
    dict(n=37, n_preds=2, n_joins=0, measure_op="mul", n_groups=1),
    dict(n=100_003, n_preds=3, n_joins=0, measure_op="mul", n_groups=1),
    dict(n=65_537, n_preds=0, n_joins=3, measure_op="first",
         n_groups=7000, duplicates=True, wrap=True),
    dict(n=50_001, n_preds=1, n_joins=2, measure_op="sub", n_groups=100,
         empty_join=True),
    dict(n=80_000, n_preds=3, n_joins=4, measure_op="sub", n_groups=800,
         duplicates=True),
    dict(n=30_000, n_preds=0, n_joins=2, measure_op="first", n_groups=1),
    # past SSB's 3 predicates and 4 joins, within the kernel's 8 and 8
    dict(n=70_001, n_preds=6, n_joins=5, measure_op="mul", n_groups=243,
         duplicates=True, wrap=True),
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_spja_kernel_bit_identical_to_plain(cuda, i):
    c = cases.spja_case(1000 + i, **CASES[i])
    args, kw = c.args(cuda)
    before = ssb_fused.LAUNCHES
    got = ssb_fused.spja(*args, **kw)
    assert ssb_fused.LAUNCHES == before + 1
    want = ref.spja(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.device == want.device
    assert torch.equal(got, want)
    again = ssb_fused.spja(*args, **kw)
    assert torch.equal(again, got)


def test_spja_wrapper_rejects_bad_inputs(cuda):
    # grids past a block's shared memory (30,000 groups: 240 KB) sum their
    # later groups in device memory: the plain version's bits
    for n_groups in (30_000, 33_750):
        c = cases.spja_case(1, 200_003, 1, 2, "first", n_groups,
                            build_rows=5000)
        args, kw = c.args(cuda)
        got = _launched(ssb_fused, "spja", *args, **kw)
        want = ref.spja(*args, **kw)
        assert torch.equal(got, want) and bool((got != 0).any()), n_groups
        assert torch.equal(ssb_fused.spja(*args, **kw), got)
    kw["n_groups"] = 4
    bad = list(args)
    bad[5] = bad[5].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ssb_fused.spja(*bad, **kw)


# rows at the edges of a step: R - 1 (R = 2) and a tile (1024 threads x R)
# +- 1, and ragged tails
SPJA_ROWS_N = [1, 7, 511, 512, 513, 2047, 2048, 2049, 8191, 8192, 8193,
               100_003]
SPJA_GROUPS = [1, 2, 3584, 7000, 7168, 29_056, 33_750]


@pytest.mark.parametrize("n_groups", SPJA_GROUPS)
@pytest.mark.parametrize("n", SPJA_ROWS_N)
def test_spja_rows_in_flight_and_block_sizes(cuda, n, n_groups):
    """Ragged tails of a thread's rows in flight and of a block's tile, at
    every grid size (a scalar sum, grids in shared memory, the spilling
    grid): the plain version's bits, twice."""
    c = cases.spja_case(2000 + n % 97, n, 2, 3, "sub", n_groups,
                        build_rows=3000, duplicates=True, wrap=True)
    args, kw = c.args(cuda)
    got = _launched(ssb_fused, "spja", *args, **kw)
    assert torch.equal(got, ref.spja(*args, **kw))
    assert torch.equal(ssb_fused.spja(*args, **kw), got)


@pytest.mark.parametrize("n_groups", [1, 2, 7000])
@pytest.mark.parametrize("n", SPJA_ROWS_N)
def test_spja_no_join_instance(cuda, n, n_groups):
    """Plans with no join run the instance with no join slots."""
    c = cases.spja_case(2200 + n % 89, n, 3, 0, "mul", n_groups)
    args, kw = c.args(cuda)
    got = _launched(ssb_fused, "spja", *args, **kw)
    assert torch.equal(got, ref.spja(*args, **kw))
    assert torch.equal(ssb_fused.spja(*args, **kw), got)


@pytest.mark.parametrize("n_groups", [1, 7000])
@pytest.mark.parametrize("wide", [False, True])
def test_spja_packed_and_wide_instances(cuda, n_groups, wide):
    """The packed decode and the 8 + 8 instance, with and without a group
    grid."""
    c = cases.packed_spja_case(2100 + n_groups, 40_009, 6 if wide else 2,
                               5 if wide else 2, "mul", n_groups,
                               pred_phys=4, duplicates=True)
    args, kw = c.args(cuda)
    got = _launched(ssb_fused, "spja", *args, **kw)
    assert torch.equal(got, ref.spja(*args, **kw))
    assert torch.equal(ssb_fused.spja(*args, **kw), got)


def test_spja_flight2_grid_runs_64_warps_an_sm(cuda):
    """A 7000-group grid launches 1024-thread blocks, two an SM."""
    lib = ssb_fused.library()
    _, blocks = ssb_fused.launch_shape(lib, cuda.index, 0, 3, 7000)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ssb_fused.THREADS == 1024 and blocks == 2 * sms


@pytest.mark.parametrize("n_groups", [1, 800, 33_750])
def test_spja_adds_into_a_running_grid(cuda, n_groups):
    c = cases.spja_case(7, 100_003, 2, 2, "sub", n_groups, build_rows=5000)
    args, kw = c.args(cuda)
    acc = torch.zeros((n_groups,), dtype=torch.int64, device=cuda)
    assert ssb_fused.spja(*args, **kw, acc=acc) is acc
    ssb_fused.spja(*args, **kw, acc=acc)
    want = ref.spja(*args, **kw, acc=torch.zeros_like(acc))
    assert torch.equal(acc, 2 * want)
    assert torch.equal(want.to(torch.float32), ref.spja(*args, **kw))


def _wide_plan():
    """A plan the reference fuses: three joins into 54 * 25 * 25 = 33,750
    groups (the reference's random wave plans reach it)."""
    from repro_torch.sql.plan import ColExpr, QueryBuilder, RangePred
    return (QueryBuilder("wide")
            .scan("lineorder")
            .hash_join("lo_orderdate", "date", "d_datekey",
                       payload=ColExpr("d_weeknuminyear"), mult=1)
            .hash_join("lo_suppkey", "supplier", "s_suppkey",
                       dim_filter=RangePred("s_region", 0, 4),
                       payload=ColExpr("s_nation"), mult=54)
            .hash_join("lo_partkey", "part", "p_partkey",
                       dim_filter=RangePred("p_mfgr", 0, 4),
                       payload=ColExpr("p_category"), mult=54 * 25)
            .measure("lo_revenue")
            .group_by(54 * 25 * 25)
            .build())


def test_fused_plan_past_shared_memory_runs_fused(cuda):
    db = ssb.generate(sf=0.05, seed=3).to(cuda)
    plan = _wide_plan()
    q = compile_.compile_plan(plan, "fused")
    assert q.strategy == "fused" and plan.n_groups == 33_750
    before = ssb_fused.LAUNCHES
    got = q.execute(db)
    assert ssb_fused.LAUNCHES == before + 1
    np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan))
    np.testing.assert_array_equal(got, q.execute(db, mode="ref"))
    assert np.count_nonzero(got) > 1000


def test_queries_on_card_match_oracle(cuda):
    db = ssb.generate(sf=0.05, seed=7).to(cuda)
    cache = hashtable.HashTableCache()
    for name, plan in engine.ssb_queries().items():
        before = ssb_fused.LAUNCHES
        got = engine.run_query(db, plan, cache=cache)
        assert ssb_fused.LAUNCHES == before + 1, name
        np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got, engine.run_query(db, plan, mode="ref", cache=cache),
            err_msg=name)
    assert ops.use_kernel("auto", cuda)


def _on(case, device):
    return cases.tensors(case, device)


def _launched(mod, fn, *args, counter="LAUNCHES", **kw):
    before = getattr(mod, counter)
    out = getattr(mod, fn)(*args, **kw)
    assert getattr(mod, counter) == before + 1
    return out


# the select sweep's tile edges (cases.SELECT_TILE rows) and, with
# MANY_TILES below, tickets past one wave of resident blocks
SELECT_EDGES = [cases.SELECT_TILE - 1, cases.SELECT_TILE,
                cases.SELECT_TILE + 1, 3 * cases.SELECT_TILE + 17]


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003] + SELECT_EDGES +
                         [3_000_017, (1 << 24) + 5])
@pytest.mark.parametrize("sel,dtype", [("mid", "int32"), ("none", "int32"),
                                       ("all", "int32"),
                                       ("mid", "float32"),
                                       ("first_tile", "int32"),
                                       ("last_tile", "float32"),
                                       ("nan", "float32")])
def test_select_scan_kernel_bit_identical_to_plain(cuda, n, sel, dtype):
    """Each call twice with the same bits: block order cannot change one."""
    args = _on(cases.select_case(n, n, sel, dtype), cuda)
    out, cnt = _launched(select_scan, "select_scan", *args)
    want, want_cnt = ref.select_scan(*args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)
    again, again_cnt = _launched(select_scan, "select_scan", *args)
    assert torch.equal(again_cnt, cnt) and torch.equal(again, out)
    assert out.dtype == args[1].dtype and out.shape == (n,)


def test_select_scan_tile_is_the_cases_tile(cuda):
    assert select_scan.library().select_scan_tile_rows() == cases.SELECT_TILE


@pytest.mark.parametrize("y_type", [torch.float32, torch.uint32])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_select_scan_unaligned_and_typed_columns(cuda, y_type, offset):
    """x and y views that start off a 16-byte boundary are read a row at
    a time, with the same bits; y of any 4-byte type moves as raw bits."""
    x, y, lo, hi = _on(cases.select_case(8, 100_003, "mid"), cuda)
    xs = torch.empty(x.shape[0] + offset, dtype=x.dtype, device=cuda)
    ys = torch.empty(y.shape[0] + offset, dtype=y_type, device=cuda)
    xs[offset:].copy_(x)
    ys[offset:].copy_(y.view(y_type))
    out, cnt = _launched(select_scan, "select_scan", xs[offset:],
                         ys[offset:], lo, hi)
    want, want_cnt = ref.select_scan(x, y, lo, hi)
    assert out.dtype == y_type and torch.equal(cnt, want_cnt)
    assert torch.equal(out.view(torch.int32), want)     # the bits


def _dirty(n: int) -> None:
    """Leave the caching allocator a freed block of the select sweep's
    buffer for n rows, every byte 0xFF, so the next call's torch.empty
    returns it and the zero tail and count must come from the kernel."""
    words = build.sweep_words(
        n, select_scan.library().select_scan_status_words(n), rows=1)
    junk = torch.full((words,), -1, dtype=torch.int32, device="cuda")
    del junk
    probe = torch.empty((words,), dtype=torch.int32, device="cuda")
    assert bool((probe == -1).all())           # the block came back dirty
    del probe


@pytest.mark.parametrize("n", [1, 37, cases.SELECT_TILE + 1, 3_000_017])
@pytest.mark.parametrize("sel", ["mid", "none", "first_tile"])
def test_select_scan_writes_a_dirty_buffer_whole(cuda, n, sel):
    args = _on(cases.select_case(11, n, sel), cuda)
    want, want_cnt = ref.select_scan(*args)
    torch.cuda.synchronize()
    _dirty(n)
    out, cnt = _launched(select_scan, "select_scan", *args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)


@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("n", [33, 3_000_017])
def test_select_scan_packed_writes_a_dirty_buffer_whole(cuda, phys, n):
    args = _on(cases.select_packed_case(n + phys, n, phys, "mid"), cuda)
    want, want_cnt = ref.select_scan_packed(*args)
    torch.cuda.synchronize()
    _dirty(n)
    out, cnt = _launched(select_scan, "select_scan_packed", *args,
                         counter="PACKED_LAUNCHES")
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [37, 3_000_017])
def test_select_scan_call_is_one_memset_and_one_sweep(cuda, packed, n):
    """The profile of one call shows one sweep kernel of the wrapper's
    kind and one memset, and nothing else (chip_smoke.one_call)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if packed:
        args = _on(cases.select_packed_case(12, n, 4), cuda)
        fn, counter, flag = "select_scan_packed", "PACKED_LAUNCHES", 4
    else:
        args = _on(cases.select_case(12, n), cuda)
        fn, counter, flag = "select_scan", "LAUNCHES", 32
    count = int(_launched(select_scan, fn, *args, counter=counter)[1])
    before = getattr(select_scan, counter)
    got = smoke.one_call(fn, lambda: getattr(select_scan, fn)(*args), n,
                         count, select_scan.library(), columns=1,
                         shape=("select_scan_shape", flag))
    assert getattr(select_scan, counter) > before
    assert got["blocks_per_sm"] >= 1


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("kind", cases.PROBE_KINDS)
def test_probe_join_kernel_bit_identical_to_plain(cuda, n, kind):
    args = _on(cases.probe_case(n, n, kind), cuda)
    got = _launched(hash_join, "probe_join", *args)
    for g, w in zip(got, ref.probe_join(*args)):
        assert torch.equal(g, w)


# many sweep tiles (2048 rows) and more than one wave of resident blocks
MANY_TILES = [3_000_017, (1 << 24) + 5]


@pytest.mark.parametrize("n", MANY_TILES)
@pytest.mark.parametrize("kind", ["duplicate_wrap", "clustered", "slots4",
                                  "full", "first_tile", "last_tile",
                                  "misses"])
def test_probe_join_many_tiles_bit_identical_to_plain(cuda, n, kind):
    """Each run bit-identical to the plain version: the look-back over
    thousands of tiles, tiles with no match, and the zero tail."""
    args = _on(cases.probe_case(n + 1, n, kind), cuda)
    want = ref.probe_join(*args)
    for _ in range(2):
        assert _equal(_launched(hash_join, "probe_join", *args), want)


def test_probe_join_unaligned_table_walks_slot_by_slot(cuda):
    """A table whose address is not a multiple of a run's bytes is walked
    a slot a step (the launcher's choice), with the same bits."""
    keys, vals, htk, htv = _on(cases.probe_case(5, 100_003, "clustered"),
                               cuda)
    shifted = torch.empty(2 * htk.shape[0] + 1, dtype=torch.int32,
                          device=cuda)
    odd_k = shifted[1:htk.shape[0] + 1]
    odd_v = shifted[htk.shape[0] + 1:]
    odd_k.copy_(htk)
    odd_v.copy_(htv)
    got = _launched(hash_join, "probe_join", keys, vals, odd_k, odd_v)
    assert _equal(got, ref.probe_join(keys, vals, htk, htv))


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("sigmoid", [False, True])
def test_project_kernel_matches_plain(cuda, n, sigmoid):
    """Bit-identical without the sigmoid (no FMA contraction); with it,
    rtol 1e-6 (expf against torch's exp)."""
    for a, b in ((1.0, -1.0), (0.75, -1.25)):
        args = _on(cases.project_case(n, n), cuda)
        got = _launched(project, "project", *args, a, b, sigmoid=sigmoid)
        want = ref.project(*args, a, b, sigmoid=sigmoid)
        if sigmoid:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, want)


def test_project_launch_asks_no_launch_shape(cuda):
    """The grid follows from n alone: a call asks the runtime for no
    launch shape (``build.resident`` is not consulted), on aligned and
    unaligned pointers and a ragged end."""
    x1, x2 = _on(cases.project_case(5, 1003), cuda)
    info = build.resident.cache_info()
    for lo in (0, 1):
        got = _launched(project, "project", x1[lo:], x2[lo:], 1.0, -1.0)
        assert torch.equal(got, torch.sub(x1[lo:], x2[lo:]))
    after = build.resident.cache_info()
    assert (after.hits, after.misses) == (info.hits, info.misses)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("n_groups", [1, 7000])
@pytest.mark.parametrize("kind", cases.GROUP_KINDS)
def test_group_sum_kernel_matches_plain(cuda, n, n_groups, kind):
    """Bit-identical on int32 and integer-valued f32; non-integer f32 is
    summed in f64 in a fixed order: two runs give the same bits, within
    one f32 ulp of the plain version's (another order)."""
    args = _on(cases.group_case(n, n, n_groups, kind, out_of_range=True),
               cuda)
    got = _launched(agg, "group_sum", *args)
    want = ref.group_sum(*args)
    assert got.dtype == want.dtype
    if kind == "f32_random":
        assert torch.equal(_launched(agg, "group_sum", *args), got)
        ulp = torch.abs(torch.nextafter(want, torch.full_like(want, np.inf))
                        - want)
        assert bool(((got - want).abs() <= ulp).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_groups", [1, 7000, "max"])
@pytest.mark.parametrize("n", [72, 4095, 1 << 22])
@pytest.mark.parametrize("kind", cases.GROUP_KINDS)
def test_group_sum_grid_sized_by_its_rows(cuda, kind, n, n_groups):
    """One launch a call, whatever grid the rows give it (one block for a
    few thousand rows, which writes the result itself; the resident grid
    for 2^22 rows, finished after the grid sync), up to the most groups
    one warp's f64 grid holds; two runs give the same bits, bit-identical
    to the plain version or within one f32 ulp for non-integer f32."""
    if n_groups == "max":
        n_groups = agg._shape(cuda.index, 1, kind != "int32_overflow")[2]
    args = _on(cases.group_case(n % 1000 + n_groups % 97, n, n_groups,
                                kind, out_of_range=True), cuda)
    got = _launched(agg, "group_sum", *args)
    again = _launched(agg, "group_sum", *args)
    want = ref.group_sum(*args)
    assert got.dtype == want.dtype and got.shape == (n_groups,)
    assert torch.equal(again, got)
    if kind == "f32_random":
        ulp = torch.abs(torch.nextafter(want, torch.full_like(want, np.inf))
                        - want)
        assert bool(((got - want).abs() <= ulp).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("odd", ["past_2^31", "halves"])
@pytest.mark.parametrize("n", [4095, 1 << 22])
def test_group_sum_exact_and_ordered_blocks_agree(cuda, n, odd):
    """f32 values that are integers of magnitude at most 2^31 are summed
    exactly in int64; a block that holds any other value (a few rows of
    3 * 2^31, or of halves) sums its rows in f64 in lane order instead.
    Every sum here is exact in f64, so each block's path gives the plain
    version's bits, run after run."""
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 7000, n, dtype=np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.float32)
    rows = rng.integers(0, n, 5)
    vals[rows] = np.float32(3 * 2.0 ** 31) if odd == "past_2^31" else \
        vals[rows] + np.float32(0.5)
    ids, vals = (torch.from_numpy(a).to(cuda) for a in (ids, vals))
    got = _launched(agg, "group_sum", ids, vals, 7000)
    assert torch.equal(_launched(agg, "group_sum", ids, vals, 7000), got)
    assert torch.equal(got, ref.group_sum(ids, vals, 7000))


@pytest.mark.parametrize("n_groups", [1, 7000])
@pytest.mark.parametrize("kind", ["int32_overflow", "f32_integers"])
def test_group_sum_acc_folds_morsels_as_one_call(cuda, kind, n_groups):
    """Three morsels (one block, then grids of blocks) added into one
    running grid, f64 for f32 values and int32 for int32, one launch each:
    the grid is the sums of one call over their concatenation (rounded
    once for f32; wrapping for int32)."""
    ids, vals, g = _on(cases.group_case(23, 300_007, n_groups, kind,
                                        out_of_range=True), cuda)
    acc = torch.zeros((g,), dtype=ref.group_acc_dtype(vals), device=cuda)
    cuts = (0, 72, 100_001, 300_007)
    for lo, hi in zip(cuts, cuts[1:]):
        assert _launched(agg, "group_sum", ids[lo:hi], vals[lo:hi], g,
                         acc=acc) is acc
    whole = _launched(agg, "group_sum", ids, vals, g)
    assert torch.equal(acc.to(vals.dtype), whole)
    assert torch.equal(whole, ref.group_sum(ids, vals, g))


def test_opat_queries_on_card_match_oracle_and_fused(cuda):
    db = ssb.generate(sf=0.05, seed=7).to(cuda)
    cache = hashtable.HashTableCache()
    mods = (select_scan, hash_join, project, agg)
    for name, plan in engine.ssb_queries().items():
        before = [m.LAUNCHES for m in mods]
        got = engine.run_query(db, plan, cache=cache, strategy="opat")
        launched = [m.LAUNCHES - b for m, b in zip(mods, before)]
        shape = [len(plan.filters), len(plan.joins),
                 int(plan.measure_op == "sub"), 1]
        # an operator that finds no rows left launches nothing
        assert launched == shape if got.any() else \
            all(a <= b for a, b in zip(launched, shape)), (name, launched)
        np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got, engine.run_query(db, plan, cache=cache), err_msg=name)
        np.testing.assert_array_equal(
            got, engine.run_query(db, plan, mode="ref", cache=cache,
                                  strategy="opat"), err_msg=name)


# ---------------------------------------------------------------------------
# compressed storage: the packed kernels
# ---------------------------------------------------------------------------


PACKED_CASES = [
    dict(n=1, n_preds=1, n_joins=1, measure_op="first", n_groups=4),
    dict(n=37, n_preds=2, n_joins=0, measure_op="mul", n_groups=1),
    dict(n=100_003, n_preds=3, n_joins=2, measure_op="sub", n_groups=100,
         duplicates=True, wrap=True),
    dict(n=65_537, n_preds=1, n_joins=3, measure_op="mul", n_groups=7000,
         small=True),
    dict(n=50_001, n_preds=2, n_joins=2, measure_op="first", n_groups=1,
         empty_join=True),
]


@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("i", range(len(PACKED_CASES)))
def test_spja_packed_kernel_bit_identical_to_plain(cuda, phys, i):
    """Packed predicate columns at every width, frame-of-reference keys
    and measures, n not a multiple of a word's values."""
    c = cases.packed_spja_case(2000 + i, pred_phys=phys, **PACKED_CASES[i])
    args, kw = c.args(cuda)
    got = _launched(ssb_fused, "spja", *args, **kw)
    want = ref.spja(*args, **kw)
    assert torch.equal(got, want)
    assert torch.equal(ssb_fused.spja(*args, **kw), got)
    if c.n > 1000 and not PACKED_CASES[i].get("empty_join"):
        assert bool(got.any())


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003] + SELECT_EDGES +
                         [3_000_017, (1 << 24) + 5])
@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("sel", ["mid", "none", "all"])
def test_select_scan_packed_kernel_bit_identical_to_plain(cuda, n, phys,
                                                          sel):
    """Ragged n (not a multiple of the values a word holds) leaves padding
    lanes in the last word; each call twice with the same bits."""
    args = _on(cases.select_packed_case(n + phys, n, phys, sel), cuda)
    out, cnt = _launched(select_scan, "select_scan_packed", *args,
                         counter="PACKED_LAUNCHES")
    want, want_cnt = ref.select_scan_packed(*args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)
    assert int(cnt) == {"none": 0, "all": n}.get(sel, int(cnt))
    again, again_cnt = _launched(select_scan, "select_scan_packed", *args,
                                 counter="PACKED_LAUNCHES")
    assert torch.equal(again_cnt, cnt) and torch.equal(again, out)


@pytest.mark.parametrize("phys", [4, 8, 16])
def test_select_scan_packed_unaligned_words(cuda, phys):
    """Words that start off the 8- or 16-byte boundary of a vector load
    are read a word at a time, with the same bits."""
    words, y, lo, hi, _ = _on(cases.select_packed_case(9, 100_003, phys),
                              cuda)
    shifted = torch.empty(words.shape[0] + 1, dtype=words.dtype,
                          device=cuda)
    shifted[1:].copy_(words)
    out, cnt = _launched(select_scan, "select_scan_packed", shifted[1:], y,
                         lo, hi, phys, counter="PACKED_LAUNCHES")
    want, want_cnt = ref.select_scan_packed(words, y, lo, hi, phys)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)


def test_select_scan_packed_counts_its_own_launches(cuda):
    args = _on(cases.select_packed_case(1, 1000, 4), cuda)
    plain, packed = select_scan.LAUNCHES, select_scan.PACKED_LAUNCHES
    select_scan.select_scan_packed(*args)
    assert (select_scan.LAUNCHES, select_scan.PACKED_LAUNCHES) == \
        (plain, packed + 1)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("ref_", [0, -5000, 1 << 20])
def test_unpack_kernel_bit_identical_to_plain(cuda, n, phys, ref_):
    words, n, phys, r = case = cases.unpack_case(n + phys, n, phys, ref_)
    w = _on((words,), cuda)[0]
    got = _launched(unpack, "unpack", w, n, phys, r)
    want = ref.unpack(w, n, phys, r)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  storage.unpack_words(words, n, phys, r))


def test_packed_wrappers_reject_bad_inputs(cuda):
    words, y, lo, hi, phys = _on(cases.select_packed_case(1, 1000, 4), cuda)
    with pytest.raises(ValueError, match="rows, expected"):
        select_scan.select_scan_packed(words[:-1], y, lo, hi, phys)
    with pytest.raises(ValueError, match="phys 3"):
        select_scan.select_scan_packed(words, y, lo, hi, 3)
    with pytest.raises(ValueError, match="past the"):
        unpack.unpack(words, 8 * words.shape[0] + 1, 4)
    c = cases.packed_spja_case(5, 1000, 1, 1, "first", 4)
    args, kw = c.args(cuda)
    kw["n_rows"] = 2000
    with pytest.raises(ValueError, match="rows, expected"):
        ssb_fused.spja(*args, **kw)


def test_packed_queries_on_card_match_oracle(cuda):
    """The 13 queries on a packed database, fused and opat, against the
    oracle of the plain one; the hash cache warmed on the plain database
    serves the packed one with hits only."""
    db = ssb.generate(sf=0.05, seed=7)
    pdb = storage.pack_database(db).to(cuda)
    cache = hashtable.HashTableCache()
    queries = engine.ssb_queries()
    for plan in queries.values():
        engine.run_query(db.to(cuda), plan, cache=cache)
    misses = cache.misses
    for name, plan in queries.items():
        want = engine.run_query_oracle(db, plan)
        before = ssb_fused.LAUNCHES
        got = engine.run_query(pdb, plan, cache=cache)
        assert ssb_fused.LAUNCHES == before + 1, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        before = select_scan.PACKED_LAUNCHES
        got = engine.run_query(pdb, plan, cache=cache, strategy="opat")
        assert select_scan.PACKED_LAUNCHES == before + int(
            bool(plan.filters)), name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            got, engine.run_query(pdb, plan, mode="ref", cache=cache,
                                  strategy="opat"), err_msg=name)
    assert cache.misses == misses


# ---------------------------------------------------------------------------
# the radix slice: histogram, partition scatter, partitioned probe
# ---------------------------------------------------------------------------


def _flat(out):
    return torch.utils._pytree.tree_leaves(out)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003])
@pytest.mark.parametrize("i", range(len(cases.RADIX_CASES)))
def test_radix_kernels_bit_identical_to_plain(cuda, i, n):
    """Each pass twice: block order cannot change a bit."""
    start_bit, r, kind, n_vals = cases.RADIX_CASES[i]
    keys, vals, _, _ = _on(cases.radix_case(i, n, start_bit, r, kind,
                                            n_vals), cuda)
    hist = _launched(radix_part, "histogram", keys, start_bit, r,
                     counter="HIST_LAUNCHES")
    assert torch.equal(hist, ref.histogram(keys, start_bit, r))
    assert torch.equal(radix_part.histogram(keys, start_bit, r), hist)
    got = _launched(radix_part, "partition_multi", keys, vals, start_bit, r,
                    hist=hist, counter="SCATTER_LAUNCHES")
    assert _equal(got, ref.partition_multi(keys, vals, start_bit, r))
    assert _equal(radix_part.partition_multi(keys, vals, start_bit, r), got)


def _hist_rows(n, cuda) -> int:
    """n as the histogram cases name it: a number, or "resident", past
    the tiles of one wave of the kernel's resident grid, so a block takes
    several tiles and the last one is ragged."""
    if n != "resident":
        return n
    lib = radix_part.library()
    grid = build.resident(lib, "radix_shape", cuda.index, 1)
    return lib.radix_tile_rows() * grid + 37


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [2047, 2049, "resident"])
@pytest.mark.parametrize("i", range(len(cases.RADIX_CASES)))
def test_histogram_tiles_edges_and_unaligned_keys(cuda, i, n, offset):
    """Tiles past one ragged edge and past the resident grid (a block
    walks several tiles, the next one's loads in flight), and a view
    that is not 16-byte aligned (offset 1: 4-byte loads), each run
    twice."""
    start_bit, r, kind, n_vals = cases.RADIX_CASES[i]
    rows = _hist_rows(n, cuda)
    keys = _on(cases.radix_case(i, rows + offset, start_bit, r, kind,
                                n_vals), cuda)[0][offset:]
    got = _launched(radix_part, "histogram", keys, start_bit, r,
                    counter="HIST_LAUNCHES")
    assert torch.equal(got, ref.histogram(keys, start_bit, r))
    assert torch.equal(radix_part.histogram(keys, start_bit, r), got)


@pytest.mark.parametrize("start_bit", [0, 3])
@pytest.mark.parametrize("kind", ["uniform", "one_bucket", "duplicates"])
@pytest.mark.parametrize("n", [37, 4099, "resident"])
@pytest.mark.parametrize("r", range(1, radix_part.MAX_BITS + 1))
def test_histogram_every_width(cuda, r, n, kind, start_bit):
    """Every r: the 4-bit fields of registers for r <= 5 (one register to
    r = 4, two at r = 5; "one_bucket" fills a field with all 8 of a
    thread's rows), the warp's ballots past it."""
    rows = _hist_rows(n, cuda)
    keys = _on(cases.radix_case(r, rows, start_bit, r, kind, 1), cuda)[0]
    got = _launched(radix_part, "histogram", keys, start_bit, r,
                    counter="HIST_LAUNCHES")
    assert torch.equal(got, ref.histogram(keys, start_bit, r))
    assert torch.equal(radix_part.histogram(keys, start_bit, r), got)


def _counters():
    return (radix_part.HIST_LAUNCHES, radix_part.COUNT_LAUNCHES,
            radix_part.SCATTER_LAUNCHES)


def _planned(keys, r, key_bits=32):
    """The passes ``radix_sort`` must launch: the plan of the plain digit
    counts."""
    counts = ref.digit_counts(keys, 0, r, radix_part.sort_passes(key_bits, r))
    return radix_part.pass_plan(counts.cpu(), keys.shape[0])


@pytest.mark.parametrize("r", [4, 7, 8])
@pytest.mark.parametrize("kind", ["negative", "duplicates"])
def test_radix_sort_kernel_bit_identical_to_plain(cuda, kind, r):
    """One digit-count launch, then one pass launch for each pass the
    plan keeps (every pass, on these keys); no histogram."""
    keys, (vals,), _, _ = _on(cases.radix_case(r, 100_003, 0, 1, kind, 1),
                              cuda)
    before = _counters()
    got = radix_part.radix_sort(keys, vals, r=r)
    plan = _planned(keys, r)
    assert plan == list(range(-(-32 // r)))
    assert _counters() == (before[0], before[1] + 1, before[2] + len(plan))
    assert _equal(got, ref.radix_sort(keys, vals, r=r))
    assert _equal(radix_part.radix_sort(keys, vals, r=r), got)
    order = np.argsort(keys.cpu().numpy().view(np.uint32), kind="stable")
    np.testing.assert_array_equal(got[1].cpu().numpy(), order)


SWEEP_TILE = 4096               # csrc/radix_part.cu's kSweepTile


@pytest.mark.parametrize("start_bit", [0, 24])
@pytest.mark.parametrize("n_vals", [0, 1, 2, 3])
@pytest.mark.parametrize("r", [1, 4, 7, 8])
@pytest.mark.parametrize("n", [37, SWEEP_TILE - 1, SWEEP_TILE,
                               SWEEP_TILE + 1, (1 << 20) + 7])
def test_radix_sweep_bit_identical_to_plain(cuda, n, r, n_vals, start_bit):
    """The one-sweep pass at ragged and whole tiles, every payload count:
    the plain pass's bits, a second run's, and its bits when the bucket
    counts come from a histogram's column sums."""
    keys, vals, _, _ = cases.radix_case(n + r, n, start_bit, r, "negative",
                                        max(n_vals, 1))
    keys, *vals = _on((keys, *vals[:n_vals]), cuda)
    before = _counters()
    got = radix_part.partition_multi(keys, vals, start_bit, r)
    assert _counters() == (before[0], before[1] + 1, before[2] + 1)
    want = ref.partition_multi(keys, vals, start_bit, r)
    assert _equal(got, want) and len(got[1]) == n_vals
    assert _equal(radix_part.partition_multi(keys, vals, start_bit, r), got)
    hist = radix_part.histogram(keys, start_bit, r)
    before = _counters()
    assert _equal(radix_part.partition_multi(keys, vals, start_bit, r,
                                             hist=hist), got)
    assert _counters() == (before[0], before[1], before[2] + 1)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("kind", cases.SORT_KINDS)
def test_radix_sort_launches_only_the_passes_that_move_rows(cuda, kind, n):
    """Keys whose high bytes are one value (SSB dates, a constant top
    byte) or all equal: the skipped passes launch nothing and the bits are
    the plain sort's; a sort that skips every pass returns copies."""
    keys, vals = _on(cases.sort_case(n, n, kind), cuda)
    before = _counters()
    got = radix_part.radix_sort(keys, vals)
    plan = _planned(keys, 8)
    expect = {"negative": [0, 1, 2, 3], "top_byte": [0, 1, 2],
              "equal": [], "date": [0, 1]}[kind]
    assert plan == (expect if n > 1 else [])
    assert _counters() == (before[0], before[1] + 1, before[2] + len(plan))
    assert _equal(got, ref.radix_sort(keys, vals))
    assert _equal(radix_part.radix_sort(keys, vals), got)
    if not plan:
        assert got[0].data_ptr() != keys.data_ptr()
        assert got[1].data_ptr() != vals.data_ptr()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("bits", [(0, 8, 4), (0, 7, 5), (0, 1, 32),
                                  (24, 8, 1), (8, 4, 6)])
def test_digit_counts_kernel_matches_plain(cuda, bits, n, offset):
    """Every pass's counts in one launch, keys 16-byte aligned or not."""
    start_bit, r, passes = bits
    keys, _, _, _ = cases.radix_case(n, n + offset, 0, 1, "negative", 1)
    keys = _on((keys,), cuda)[0][offset:]
    got = _launched(radix_part, "digit_counts", keys, start_bit, r, passes,
                    counter="COUNT_LAUNCHES")
    assert torch.equal(got, ref.digit_counts(keys, start_bit, r, passes))
    assert int(got.sum()) == n * passes


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("kind", cases.PART_PROBE_KINDS)
def test_part_probe_kernel_bit_identical_to_plain(cuda, kind, bits, n):
    args = _on(cases.part_probe_case(bits + n, n, bits, kind), cuda)
    got = _launched(part_probe, "part_probe", *args)
    assert _equal(got, ref.part_probe(*args))
    assert _equal(part_probe.part_probe(*args), got)


@pytest.mark.parametrize("n", MANY_TILES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", ["uniform", "dead", "clustered", "slots2",
                                  "full", "first_tile", "last_tile"])
def test_part_probe_many_tiles_bit_identical_to_plain(cuda, kind, bits, n):
    args = _on(cases.part_probe_case(bits + n, n, bits, kind), cuda)
    want = ref.part_probe(*args)
    for _ in range(2):
        assert _equal(_launched(part_probe, "part_probe", *args), want)


def test_radix_wrappers_reject_bad_inputs(cuda):
    keys, vals, _, _ = _on(cases.radix_case(1, 1000, 0, 8, "uniform", 3),
                           cuda)
    for start_bit, r in ((0, 9), (32, 4), (0, 0)):
        with pytest.raises(ValueError, match="start_bit"):
            radix_part.histogram(keys, start_bit, r)
    with pytest.raises(ValueError, match="at most 3"):
        radix_part.partition_multi(keys, vals + vals[:1], 0, 8)
    with pytest.raises(ValueError, match="hist must be"):
        radix_part.partition_multi(keys, vals, 0, 8,
                                   hist=radix_part.histogram(keys, 0, 4))
    for start_bit, r, passes in ((0, 8, 5), (28, 4, 2), (0, 1, 33)):
        with pytest.raises(ValueError, match="counters"):
            radix_part.digit_counts(keys, start_bit, r, passes)
    with pytest.raises(ValueError, match="totals"):
        radix_part.sweep(keys, vals, 0, 8,
                         radix_part.digit_counts(keys, 0, 4)[0])
    args = list(_on(cases.part_probe_case(1, 1000, 4), cuda))
    with pytest.raises(ValueError, match="powers of 2"):
        part_probe.part_probe(*args[:5], args[5][:3], args[6][:3], 3)


@pytest.mark.parametrize("strategy", ["part", "part_loop"])
def test_part_queries_on_card_match_oracle(cuda, strategy):
    """The 13 queries through the partitioned join, plain and packed: per
    join one histogram and one scatter, then one ``part_probe`` (part)
    or one ``probe_join`` per non-empty partition (part_loop)."""
    db = ssb.generate(sf=0.05, seed=7)
    pdb = storage.pack_database(db).to(cuda)
    db.to(cuda)
    cache = hashtable.HashTableCache()
    for name, plan in engine.ssb_queries().items():
        want = engine.run_query_oracle(db, plan)
        for database in (db, pdb):
            before = (radix_part.HIST_LAUNCHES, radix_part.SCATTER_LAUNCHES,
                      part_probe.LAUNCHES, hash_join.LAUNCHES)
            got = engine.run_query(database, plan, cache=cache,
                                   strategy=strategy)
            hist, scatter, pp, pj = (
                a - b for a, b in zip(
                    (radix_part.HIST_LAUNCHES, radix_part.SCATTER_LAUNCHES,
                     part_probe.LAUNCHES, hash_join.LAUNCHES), before))
            np.testing.assert_array_equal(got, want, err_msg=name)
            j = len(plan.joins)
            if strategy == "part" and got.any():   # no join ran dry
                assert (hist, scatter, pp, pj) == (j, j, j, 0), name
            elif got.any():
                assert (hist, scatter, pp) == (j, j, 0), name
                assert j <= pj <= j << 8, name
            np.testing.assert_array_equal(
                got, engine.run_query(database, plan, mode="ref",
                                      cache=cache, strategy=strategy),
                err_msg=name)


def test_order_by_on_card_matches_numpy(cuda):
    """One digit-count launch and the two passes that move rows (the
    dates' bits 16-31 are zero), no histogram."""
    db = ssb.generate(sf=0.05, seed=7)
    before = _counters()
    out = engine.order_by(db.lineorder, "lo_orderdate")
    assert _counters() == (before[0], before[1] + 1, before[2] + 2)
    perm = np.argsort(db.lineorder["lo_orderdate"], kind="stable")
    for c, v in db.lineorder.columns.items():
        np.testing.assert_array_equal(out[c], v[perm])


# (n, members, preds, joins, n_groups, padding, extra): waves of up to 16
# members, 1 / 7000 / 33,750 groups, packed streams, padding members,
# two streams of one build side, an empty build side, ragged n
MULTI_CASES = [
    (1, 1, 1, 1, 4, 0, {}),
    (37, 3, 2, 2, 1, 1, {}),
    (100_003, 1, 3, 0, 1, 0, {}),
    (100_003, 13, 3, 5, 7000, 3, dict(duplicates=True, wrap=True,
                                      shared_table=True)),
    (65_537, 16, 4, 4, 33_750, 0, dict(duplicates=True)),
    (50_001, 8, 2, 3, 100, 8, dict(empty_join=True)),
    (80_000, 13, 3, 4, 800, 3, dict(packed=True, pred_phys=4,
                                     duplicates=True, wrap=True)),
    (20_011, 5, 1, 3, 7000, 0, dict(packed=True, pred_phys=16,
                                    shared_table=True)),
]


@pytest.mark.parametrize("i", range(len(MULTI_CASES)))
def test_multi_spja_kernel_bit_identical_to_plain(cuda, i, monkeypatch):
    n, q, c, j, g, pad, extra = MULTI_CASES[i]
    case = cases.multi_spja_case(4000 + i, n, q, c, j, g, pad=pad, **extra)
    args, kw = case.args(cuda)
    got = _launched(multi_fused, "multi_spja", *args, **kw,
                    member_groups=case.member_groups)
    want = ref.multi_spja(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == (q + pad, g) and torch.equal(got, want)
    assert not got[q:].any()                    # padding adds nothing
    # where a sum is taken (shared grid or L2) never changes its bits
    for budget in (0, 200 * 1024):
        monkeypatch.setattr(multi_fused, "ACC_BUDGET_BYTES", budget)
        again = multi_fused.multi_spja(*args, **kw)
        assert torch.equal(again, got)


# (n, members, preds, joins, n_groups, padding, extra): merged probe
# groups of 2 to 33 streams (split at 32), one stream a group beside them,
# 1 to 64 members, padding, packed streams, an empty build side
MERGED_CASES = [
    (1, 1, 1, 2, 4, 0, dict(merge=2)),
    (37, 3, 2, 4, 1, 1, dict(merge=2)),
    (100_003, 13, 3, 6, 7000, 3, dict(merge=3, duplicates=True, wrap=True)),
    (65_537, 16, 2, 5, 33_750, 0, dict(merge=5, duplicates=True)),
    (50_001, 8, 2, 4, 100, 8, dict(merge=4, empty_join=True)),
    (80_000, 13, 3, 6, 800, 3, dict(merge=3, packed=True, pred_phys=4,
                                     duplicates=True)),
    (40_009, 64, 1, 7, 9, 0, dict(merge=7, build_rows=50)),
    (30_011, 4, 1, 34, 4, 0, dict(merge=33, build_rows=50, use_p=0.05)),
]


@pytest.mark.parametrize("i", range(len(MERGED_CASES)))
def test_multi_spja_merged_groups_bit_identical_to_plain(cuda, i):
    """One probe a group through merged tables: the plain version's bits
    on the same lowering and on one probe a stream, twice, and added into
    a running grid across two calls."""
    n, q, c, j, g, pad, extra = MERGED_CASES[i]
    case = cases.multi_spja_case(4100 + i, n, q, c, j, g, pad=pad, **extra)
    args, kw = case.args(cuda, merged=True)
    assert any(m is not None for _, m in kw["probe_groups"])
    got = _launched(multi_fused, "multi_spja", *args, **kw,
                    member_groups=case.member_groups)
    want = ref.multi_spja(*args, **kw)
    plain = ref.multi_spja(*case.args(cuda)[0], **case.args(cuda)[1])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(want, plain)
    assert torch.equal(multi_fused.multi_spja(*args, **kw), got)
    assert not got[q:].any()
    acc = torch.zeros((q + pad, g), dtype=torch.int64, device=cuda)
    for _ in range(2):
        assert multi_fused.multi_spja(*args, **kw, acc=acc) is acc
    assert torch.equal(acc, 2 * ref.multi_spja(
        *args, **kw, acc=torch.zeros_like(acc)))


@pytest.mark.parametrize("wave", ["all13", "flight1", "flight2",
                                  "flights2_4"])
@pytest.mark.parametrize("packed", [False, True])
def test_ssb_waves_on_card_match_plain_and_oracle(cuda, wave, packed):
    """``chip_smoke.WAVES`` at SF 0.05: one launch, the merged lowering's
    plain version and the oracle, bit for bit; the 13-query wave probes 4
    groups, one per fact key column."""
    names = {"all13": None, "flight1": ("q1.1", "q1.2", "q1.3"),
             "flight2": ("q2.1", "q2.2", "q2.3"),
             "flights2_4": ("q2.1", "q2.2", "q2.3", "q4.1", "q4.2",
                            "q4.3")}[wave]
    db = _ssb_db(cuda, packed)
    queries = engine.ssb_queries()
    plans = [queries[q] for q in (names or queries)]
    cache = hashtable.HashTableCache()
    _, a, k, n_groups = compile_.shared_params(
        plans, db, cache=cache, pad_to=16 if names is None else None,
        device=cuda)
    if names is None:
        assert len(k["probe_groups"]) == 4
    got = _launched(multi_fused, "multi_spja", *a, n_groups=n_groups, **k)
    plain_kw = {x: v for x, v in k.items() if x != "member_groups"}
    want = ref.multi_spja(*a, n_groups=n_groups, **plain_kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(multi_fused.multi_spja(*a, n_groups=n_groups, **k),
                       got)
    for qi, plan in enumerate(plans):
        np.testing.assert_array_equal(
            got[qi, :plan.n_groups].cpu().numpy(),
            engine.run_query_oracle(db, plan), err_msg=plan.name)


_SSB_DBS = {}


def _ssb_db(cuda, packed: bool):
    """SF 0.05 (seed 11) on the card, plain or packed, made once."""
    if packed not in _SSB_DBS:
        db = ssb.generate(sf=0.05, seed=11)
        _SSB_DBS[packed] = (storage.pack_database(db) if packed
                            else db).to(cuda)
    return _SSB_DBS[packed]


def test_multi_spja_refuses_malformed_words(cuda):
    """The launcher refuses words whose probe groups do not hold together:
    a group's streams past the stream count, a group of several streams
    with no payload matrix, a pair's bit past its group."""
    case = cases.multi_spja_case(5, 1000, 2, 1, 4, 4, merge=2)
    args, kw = case.args(cuda, merged=True)
    lib = multi_fused.library()
    device, n, q, ptrs, chunks = multi_fused._lower(
        *args, kw["n_groups"], None, None, None, None, None, None, None,
        kw["probe_groups"])
    words = chunks[0][1]
    head, c, g = 10, int(words[1]), int(words[2])
    groups = head + 5 * c + 2 * c * q
    n_pairs = int(words[7])
    pairs = len(words) - 3 * n_pairs
    ptr_words = np.array(ptrs, np.uint64).view(np.int64)
    for at, value in ((groups + 6, 3),            # k past the streams
                      (groups + 7, 0),            # no payload matrix
                      (pairs + 1, 2)):            # bit past its group
        if at >= len(words) or (at == pairs + 1 and not n_pairs):
            continue
        bad = words.copy()
        bad[at] = value
        params = torch.from_numpy(np.concatenate([
            ptr_words, np.resize(bad, (bad.size + 1) & ~1).view(
                np.int64)])).to(device)
        out = torch.zeros((q, kw["n_groups"]), dtype=torch.int64,
                          device=device)
        # held in a name: the launcher reads the struct through its address
        launch_args = multi_fused._Args(bad.ctypes.data, bad.size,
                                        params.data_ptr(), n,
                                        out.data_ptr(), 1)
        rc = lib.multi_spja_launch(ctypes.addressof(launch_args),
                                   torch.cuda.current_stream().cuda_stream)
        assert rc != 0, at


@pytest.mark.parametrize("which", ["spja", "multi_spja"])
def test_launch_asks_the_runtime_nothing(cuda, which):
    """One kernel a call (its count), and a repeated call asks for no
    launch shape (``build.resident`` answers from its cache)."""
    if which == "spja":
        c = cases.spja_case(9, 50_001, 2, 3, "sub", 7000, build_rows=5000)
        args, kw = c.args(cuda)
        mod = ssb_fused
    else:
        c = cases.multi_spja_case(9, 50_001, 5, 2, 4, 700, merge=2)
        args, kw = c.args(cuda, merged=True)
        mod = multi_fused
    _launched(mod, which, *args, **kw)
    info = build.resident.cache_info()
    shape = ssb_fused.launch_shape.cache_info()
    _launched(mod, which, *args, **kw)
    assert build.resident.cache_info().misses == info.misses
    assert ssb_fused.launch_shape.cache_info().misses == shape.misses


def test_multi_spja_past_64_members_runs_64_a_launch(cuda):
    case = cases.multi_spja_case(7, 30_000, 70, 2, 2, 50)
    args, kw = case.args(cuda)
    before = multi_fused.LAUNCHES
    got = multi_fused.multi_spja(*args, **kw)
    assert multi_fused.LAUNCHES == before + 2
    assert torch.equal(got, ref.multi_spja(*args, **kw))


def test_multi_spja_wrapper_rejects_bad_inputs(cuda):
    case = cases.multi_spja_case(3, 1000, 2, 1, 1, 4)
    args, kw = case.args(cuda)
    bad = list(args)
    bad[8] = np.array([[0, 0, 0], [5, 0, 0]], np.int32)
    with pytest.raises(ValueError, match="measure_sel"):
        multi_fused.multi_spja(*bad, **kw)
    bad = list(args)
    bad[7] = [args[7][0].to(torch.int64)] + list(args[7][1:])
    with pytest.raises(ValueError, match="int32"):
        multi_fused.multi_spja(*bad, **kw)
    wide = cases.multi_spja_case(3, 1000, 1, 1, 230, 1)
    wargs, wkw = wide.args(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        multi_fused.multi_spja(*wargs, **wkw)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("kind", cases.PROBE_KINDS)
@pytest.mark.parametrize("vals", ["int32", "f32_integers", "f32_random"])
def test_probe_agg_kernel_matches_plain(cuda, n, kind, vals):
    args = _on(cases.probe_agg_case(n, n, kind, vals), cuda)
    got = _launched(hash_join, "probe_agg", *args, counter="AGG_LAUNCHES")
    want = ref.probe_agg(*args)
    assert got.dtype == want.dtype and got.shape == ()
    assert torch.equal(hash_join.probe_agg(*args), got)     # two runs
    if vals == "f32_random":        # another f64 order: within an ulp
        ulp = abs(float(torch.nextafter(want, want + 1)) - float(want))
        assert abs(float(got) - float(want)) <= ulp
    else:
        assert torch.equal(got, want)


def _agg_held(args, want, f32_random: bool) -> None:
    """probe_agg of args, twice: the same bits every run, and the plain
    version's (within one f32 ulp of them for non-integer f32 values,
    which the f64 sums in another order)."""
    runs = [hash_join.probe_agg(*args) for _ in range(2)]
    for got in runs:
        assert got.dtype == want.dtype and got.shape == ()
        assert torch.equal(got, runs[0])
    if f32_random:
        ulp = abs(float(torch.nextafter(want, want + 1)) - float(want))
        assert abs(float(runs[0]) - float(want)) <= ulp
    else:
        assert torch.equal(runs[0], want)


@pytest.mark.parametrize("n", [2047, 2049, 3_000_017, (1 << 24) + 5])
@pytest.mark.parametrize("vals", ["int32", "f32_integers", "f32_random"])
def test_probe_agg_many_tiles(cuda, n, vals):
    """Ragged n over many 2,048-row tiles and more tiles than resident
    blocks: the plain version's sum, run after run."""
    args = _on(cases.probe_agg_case(n, n, "duplicate_wrap", vals), cuda)
    _agg_held(args, ref.probe_agg(*args), vals == "f32_random")


@pytest.mark.parametrize("kind", ["clustered", "full", "slots1", "slots2",
                                  "slots4", "misses", "empty"])
@pytest.mark.parametrize("vals", ["int32", "f32_integers"])
def test_probe_agg_walks_past_the_home_run(cuda, kind, vals):
    """Walks that cross several runs and the table's end ("clustered"),
    a full table whose misses end after one lap, tables smaller than a
    run, and tables no key is in: the plain version's bits."""
    args = _on(cases.probe_agg_case(70_001, 70_001, kind, vals), cuda)
    _agg_held(args, ref.probe_agg(*args), False)


def test_probe_agg_table_past_the_l2(cuda):
    """A table whose 8-byte slots are more than the L2 holds, probed by as
    many rows as it has slots (2^24 rows on an H100): the plain version's
    bits and numpy's sum."""
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    kb = 1 << max(10, (2 * l2 - 1).bit_length() - 10)    # > 2 L2, in KB
    bkeys, n_slots = cases.join_bench_keys(9, kb * 1024)
    assert 8 * n_slots > l2
    htk, htv = (torch.from_numpy(a).to(cuda)
                for a in hashtable.np_build(bkeys, bkeys, n_slots))
    rng = np.random.default_rng(9)
    keys = rng.integers(0, len(bkeys), n_slots).astype(np.int32)
    vals = rng.integers(-(1 << 31), (1 << 31) - 1, n_slots).astype(np.int32)
    args = (torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda),
            htk, htv)
    got = _launched(hash_join, "probe_agg", *args, counter="AGG_LAUNCHES")
    exact = int(keys.astype(np.int64).sum() + vals.astype(np.int64).sum())
    assert int(got) == (exact + (1 << 31)) % (1 << 32) - (1 << 31)
    _agg_held(args, ref.probe_agg(*args), False)


@pytest.mark.parametrize("n", [1, 3, 37, 100_003, 1 << 22])
@pytest.mark.parametrize("kind", cases.SUM_KINDS)
@pytest.mark.parametrize("offset", [0, 1])
def test_reduce_sum_kernel_matches_plain(cuda, n, kind, offset):
    (x,) = _on(cases.reduce_case(n, n + offset, kind), cuda)
    x = x[offset:]                  # offset 1: not 16-byte aligned
    got = _launched(agg, "reduce_sum", x, counter="SUM_LAUNCHES")
    want = ref.reduce_sum(x)
    assert got.dtype == want.dtype and got.shape == ()
    assert torch.equal(agg.reduce_sum(x), got)
    if kind == "f32_random":
        ulp = abs(float(torch.nextafter(want, want + 1)) - float(want))
        assert abs(float(got) - float(want)) <= ulp
    else:
        assert torch.equal(got, want)


def _sum_held(x, got):
    want = ref.reduce_sum(x)
    assert got.dtype == want.dtype and got.shape == ()
    if x.is_floating_point():
        ulp = abs(float(torch.nextafter(want, want + 1)) - float(want))
        assert abs(float(got) - float(want)) <= ulp
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", cases.SUM_KINDS)
@pytest.mark.parametrize("offset", [0, 1])
def test_reduce_sum_past_one_grid_step(cuda, kind, offset):
    """n just past one full step of the resident grid (4 vectors of 4 rows
    a thread), aligned and not: every row summed once, the same bits
    twice."""
    lib = agg.library()
    blocks = build.resident(lib, "reduce_sum_shape", cuda.index,
                            int(kind != "int32_overflow"))
    n = blocks * agg.SUM_ROWS_PER_BLOCK * 4 + 3
    (x,) = _on(cases.reduce_case(n, n + offset, kind), cuda)
    x = x[offset:]
    got = _launched(agg, "reduce_sum", x, counter="SUM_LAUNCHES")
    _sum_held(x, got)
    assert torch.equal(agg.reduce_sum(x), got)


@pytest.mark.parametrize("kind", cases.SUM_KINDS)
def test_reduce_sum_ticket_is_the_calls_own(cuda, kind):
    """Calls back to back and one on each of two streams give the same
    bits: each call clears its own ticket, and no two share one."""
    (x,) = _on(cases.reduce_case(7, 3_000_017, kind), cuda)
    first = agg.reduce_sum(x)
    back_to_back = [agg.reduce_sum(x) for _ in range(4)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    main = torch.cuda.current_stream(cuda)
    on_streams = []
    for s in streams:
        s.wait_stream(main)
        with torch.cuda.stream(s):
            on_streams.append(agg.reduce_sum(x))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize(cuda)
    _sum_held(x, first)
    for got in back_to_back + on_streams:
        assert torch.equal(got, first)


@pytest.mark.parametrize("packed", [False, True])
def test_shared_wave_on_card_matches_oracle_and_fused(cuda, packed):
    db = ssb.generate(sf=0.05, seed=7)
    db = (storage.pack_database(db) if packed else db).to(cuda)
    cache = hashtable.HashTableCache()
    plans = list(engine.ssb_queries().values())
    before = multi_fused.LAUNCHES
    outs = compile_.execute_shared(plans, db, cache=cache, pad_to=16)
    assert multi_fused.LAUNCHES == before + 1
    assert cache.misses == len({compile_.shared_join_key(j)
                                for p in plans for j in p.joins})
    plain = compile_.execute_shared(plans, db, mode="ref", cache=cache)
    for plan, got, want in zip(plans, outs, plain):
        np.testing.assert_array_equal(got, want, err_msg=plan.name)
        np.testing.assert_array_equal(
            got, engine.run_query_oracle(db, plan), err_msg=plan.name)
        np.testing.assert_array_equal(
            got, engine.run_query(db, plan, cache=cache), err_msg=plan.name)
    one = engine.run_query(db, plans[3], cache=cache, strategy="shared")
    np.testing.assert_array_equal(one, outs[3])


@pytest.mark.parametrize("n_slots", [1, 16, 1 << 12, 1 << 20])
@pytest.mark.parametrize("kind", cases.BUILD_KINDS)
def test_build_kernel_bit_identical_to_plain(cuda, kind, n_slots):
    keys, vals, s = _on(cases.build_case(11, n_slots, kind), cuda)
    got = _launched(hash_join, "build", keys, vals, s,
                    counter="BUILD_LAUNCHES")
    want = ref.build(keys, vals, s)
    again = hash_join.build(keys, vals, s)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.int32 and g.shape == (s,)
        assert torch.equal(g, w) and torch.equal(a, g)
    assert torch.equal(ops.build_hash_table(keys, vals, s)[0], want[0])


def test_build_kernel_table_probes_as_the_host_build(cuda):
    keys, n_slots = cases.join_bench_keys(5, 1 << 20)
    t = torch.from_numpy(keys).to(cuda)
    htk, htv = hash_join.build(t, t, n_slots)
    hk, hv = (torch.from_numpy(a).to(cuda)
              for a in hashtable.np_build(keys, keys, n_slots))
    probe = torch.remainder(torch.arange(1 << 20, device=cuda,
                                         dtype=torch.int32) * 7, len(keys))
    assert torch.equal(hash_join.probe_agg(probe, probe, htk, htv),
                       hash_join.probe_agg(probe, probe, hk, hv))


def test_build_runs_wrap_past_the_last_slot(cuda):
    """Rows whose home slots are the table's last four: their runs wrap
    to slot 0 and on, in row order, as the sequential build lays them."""
    n_slots = 64
    cand = torch.arange(-20_000, 20_000, dtype=torch.int32)
    keys = cand[core_blocks.hash_fn(cand, n_slots) >= n_slots - 4][:40]
    keys = torch.cat([keys, keys[:8]]).to(cuda)         # and duplicates
    vals = torch.arange(keys.numel(), dtype=torch.int32, device=cuda) * 7
    got = _launched(hash_join, "build", keys, vals, n_slots,
                    counter="BUILD_LAUNCHES")
    want = ref.build(keys, vals, n_slots)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[0][0]) != -(1 << 31)                 # wrapped to slot 0


@pytest.mark.parametrize("n_slots", [16, 1 << 12, 1 << 16])
def test_build_full_table_of_duplicates(cuda, n_slots):
    """n = S rows of duplicate keys: every slot filled, each key's rows in
    row order along its chain."""
    keys, vals, s = _on(cases.build_case(17, n_slots, "duplicates",
                                         n=n_slots), cuda)
    got = _launched(hash_join, "build", keys, vals, s,
                    counter="BUILD_LAUNCHES")
    want = ref.build(keys, vals, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not bool((got[0] == -(1 << 31)).any())


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_build_empty_key_raises_from_the_kernels_flag(cuda, where):
    """A key equal to EMPTY is found by the kernel's insert, which raises
    its flag; the wrapper raises the plain path's error after the launch,
    and the next call, of clean keys, builds."""
    keys, vals, s = _on(cases.build_case(19, 1 << 16), cuda)
    at = {"first": 0, "middle": keys.numel() // 2,
          "last": keys.numel() - 1}[where]
    clean = keys.clone()
    keys[at] = -(1 << 31)
    before = hash_join.BUILD_LAUNCHES
    with pytest.raises(ValueError) as kernel_err:
        hash_join.build(keys, vals, s)
    assert hash_join.BUILD_LAUNCHES == before + 1
    for mode in ("kernel", "ref"):
        with pytest.raises(ValueError) as err:
            ops.build_hash_table(keys, vals, s, mode=mode)
        assert str(err.value) == str(kernel_err.value)
    got = _launched(hash_join, "build", clean, vals, s,
                    counter="BUILD_LAUNCHES")
    assert all(torch.equal(g, w)
               for g, w in zip(got, ref.build(clean, vals, s)))


def test_build_table_past_the_l2_bit_identical_to_plain(cuda):
    """The join microbenchmark's largest table, 2^24 rows into 2^25
    slots (256 MB of table, a 256 MB slot array past the 50 MB L2)."""
    host, n_slots = cases.join_bench_keys(20, 256 << 20)
    assert n_slots == 1 << 25
    keys = torch.from_numpy(host).to(cuda)
    vals = keys * 3 + 1
    got = _launched(hash_join, "build", keys, vals, n_slots,
                    counter="BUILD_LAUNCHES")
    want = ref.build(keys, vals, n_slots)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_build_wrapper_rejects_bad_inputs(cuda):
    keys = torch.arange(17, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        hash_join.build(keys, keys, 16)
    keys[3] = -(1 << 31)
    with pytest.raises(ValueError, match="EMPTY"):
        hash_join.build(keys, keys, 32)
    with pytest.raises(ValueError, match="power of 2"):
        hash_join.build(keys[:4], keys[:4], 24)


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003])
@pytest.mark.parametrize("selectivity", [0.0, 1e-5, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("order", cases.SPARSE_ORDERS)
def test_select_scan_sparse_equals_select_scan(cuda, n, selectivity, order):
    args = _on(cases.sparse_case(n, n, selectivity, order), cuda)
    out, cnt = _launched(select_scan, "select_scan_sparse", *args,
                         counter="SPARSE_LAUNCHES")
    dense, dense_cnt = select_scan.select_scan(*args)
    want, want_cnt = ref.select_scan_sparse(*args)
    assert torch.equal(cnt, dense_cnt) and torch.equal(out, dense)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)
    again = select_scan.select_scan_sparse(*args)
    assert torch.equal(again[0], out)


def test_select_scan_sparse_float_column(cuda):
    args = _on(cases.select_case(5, 100_003, "mid", "float32"), cuda)
    out, cnt = select_scan.select_scan_sparse(*args)
    want, want_cnt = ref.select_scan(*args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)


@pytest.mark.parametrize("selectivity", [0.0, 1.0])
@pytest.mark.parametrize("n", [37, 100_003])
def test_select_scan_sparse_unaligned_y(cuda, selectivity, n):
    """y offset by one element (not 16-byte aligned) is read a row at a
    time, at no match and at every row a match: select_scan's bits, and
    the zero tail written whole."""
    x, y, lo, hi = _on(cases.sparse_case(n, n, selectivity), cuda)
    ys = torch.empty(n + 1, dtype=y.dtype, device=cuda)
    ys[1:].copy_(y)
    want = ref.select_scan_sparse(x, y, lo, hi)
    torch.cuda.synchronize()
    _dirty(n)
    got = _launched(select_scan, "select_scan_sparse", x, ys[1:], lo, hi,
                    counter="SPARSE_LAUNCHES")
    again = select_scan.select_scan_sparse(x, ys[1:], lo, hi)
    assert int(want[1]) == (0 if selectivity == 0.0 else n)
    assert _equal(got, want) and _equal(again, want)
    assert _equal(got, select_scan.select_scan(x, ys[1:], lo, hi))


def test_select_scan_sparse_call_is_one_memset_and_one_sweep(cuda):
    """One call is one memset and one sweep kernel of its own name."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n = 3_000_017
    args = _on(cases.sparse_case(n, n, 1e-3), cuda)
    count = int(select_scan.select_scan_sparse(*args)[1])
    got = smoke.one_call("select_scan_sparse",
                         lambda: select_scan.select_scan_sparse(*args), n,
                         count, select_scan.library(), columns=1,
                         shape=("select_scan_shape", 32 | 128))
    assert "select_sparse_sweep" in got["kernel"]


@pytest.fixture
def streamed_db(cuda):
    """SF 0.05 on the host (not resident), its packed copy, the oracle."""
    db = ssb.generate(sf=0.05, seed=13)
    return db, storage.pack_database(db)


@pytest.mark.parametrize("strategy", ["fused", "opat", "part", "shared"])
@pytest.mark.parametrize("packed", [False, True])
def test_morsel_queries_on_card_match_resident(streamed_db, strategy,
                                               packed):
    from repro_torch.sql import morsel
    db, pdb = streamed_db
    database = pdb if packed else db
    # at most an eighth of the packed table, one plain column's bytes: at
    # least four morsels a query
    budget = database.lineorder.nbytes // 8 if packed else \
        4 * db.lineorder.n_rows
    cache = hashtable.HashTableCache()
    for name, plan in engine.ssb_queries().items():
        q = compile_.compile_plan(plan, strategy)
        before = ssb_fused.LAUNCHES, multi_fused.LAUNCHES
        got = q.execute(database, cache=cache, morsel_bytes=budget)
        assert q.n_morsels > 1, name
        if strategy == "fused":
            assert ssb_fused.LAUNCHES == before[0] + q.n_morsels
        if strategy == "shared":
            assert multi_fused.LAUNCHES == before[1] + q.n_morsels
        assert not database.lineorder.resident_bytes(None), name
        np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan),
                                      err_msg=name)
    assert morsel._REGISTERED


def test_morsel_stream_keeps_two_buffers_on_card(streamed_db):
    db, _ = streamed_db
    plan = engine.ssb_queries()["q2.1"]
    cache = hashtable.HashTableCache()
    q = compile_.compile_plan(plan, "fused")
    q.execute(db, cache=cache, morsel_bytes=1 << 19)     # tables built
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = q.execute(db, cache=cache, morsel_bytes=1 << 19)
    torch.cuda.synchronize()
    assert q.n_morsels > 8
    assert torch.cuda.max_memory_allocated() - before <= \
        q.peak_resident_bytes + (4 << 20)
    np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan))
    wave = list(engine.ssb_queries().values())
    outs, report = compile_.execute_shared_morsels(
        wave, db, cache=cache, pad_to=16, morsel_bytes=1 << 22)
    assert report.n_morsels > 1
    for p, o in zip(wave, outs):
        np.testing.assert_array_equal(o, engine.run_query_oracle(db, p),
                                      err_msg=p.name)


def test_page_locked_upload_is_the_host_bytes(cuda):
    from repro_torch.sql import morsel
    host = np.arange(3 << 20, dtype=np.int32)
    start, end = morsel.page_lock(host)
    assert end - start > host.nbytes - 2 * 4096
    assert morsel.page_lock(host) == (start, end)     # once per array
    side = torch.cuda.Stream()
    for cut in (host, host[4096:], host[5:-7], host[:100]):
        with torch.cuda.stream(side):
            t = morsel.upload(cut, cuda, (start, end))
        side.synchronize()
        assert torch.equal(t.cpu(), torch.from_numpy(cut))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s", [2, 8])
def test_sharded_on_card_matches_fused(cuda, s, packed):
    from repro_torch.sql import shard
    db = ssb.generate(sf=0.05, seed=7)
    db = (storage.pack_database(db) if packed else db).to(cuda)
    sdb = shard.shard_database(db, s)
    cache = hashtable.HashTableCache()
    for name, plan in engine.ssb_queries().items():
        fused = compile_.compile_plan(plan, "fused").execute(db, cache=cache)
        q = compile_.compile_plan(plan, "sharded")
        before = ssb_fused.LAUNCHES
        got = q.execute(sdb, cache=cache)
        assert ssb_fused.LAUNCHES == before + s, name
        assert q.device_count == s and len(q.shard_times_s) == s
        np.testing.assert_array_equal(got, fused, err_msg=name)
        np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan),
                                      err_msg=name)
    plans = list(engine.ssb_queries().values())
    before = multi_fused.LAUNCHES
    waves, times, _ = compile_.execute_shared_sharded(plans, sdb, cache=cache,
                                                      pad_to=16)
    assert multi_fused.LAUNCHES == before + s and len(times) == s
    for plan, got in zip(plans, waves):
        np.testing.assert_array_equal(got, engine.run_query_oracle(db, plan),
                                      err_msg=plan.name)


def test_shard_of_a_pinned_table_holds_views_on_card(cuda):
    from repro_torch.sql import shard
    db = ssb.generate(sf=0.01, seed=3).to(cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sdb = shard.shard_database(db, 4)
    assert torch.cuda.memory_allocated() == before
    for i, x in enumerate(sdb.shards):
        lo = int(sdb.bounds[i])
        for col in x.lineorder.columns:
            view = x.lineorder.on_device(col, cuda)
            whole = db.lineorder.on_device(col, cuda)
            assert view.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr()
            assert view.data_ptr() == whole.data_ptr() + 4 * lo
            np.testing.assert_array_equal(view.cpu().numpy(),
                                          x.lineorder[col])


def test_calibration_on_card(cuda, tmp_path, monkeypatch):
    from repro_torch.cost.model import H100
    from repro_torch.sql import calibrate, model
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    calib = calibrate.measure(cuda, stream_bytes=256 << 20,
                              probes=1 << 24, h2d_bytes=64 << 20)
    assert calib.backend == "cuda"
    assert calib.device_name == torch.cuda.get_device_name(cuda)
    for k in ("read_bw", "write_bw", "cache_bw", "launch_overhead_s",
              "interconnect_bw"):
        assert getattr(calib, k) > 0, k
    assert model.default_hardware(cuda) is H100       # nothing cached yet
    path = calibrate.save(calib)
    assert path == calibrate.cache_path(cuda)
    calibrate._MEMO.clear()
    assert calibrate.load_cached(cuda) == calib
    hw = model.default_hardware(cuda)
    assert hw == calibrate.apply(calib, H100)
    assert hw.interconnect_bw == calib.interconnect_bw
    assert (hw.cache_size, hw.line_bytes) == (H100.cache_size,
                                              H100.line_bytes)
    plan = engine.ssb_queries()["q2.1"]
    db = ssb.generate(sf=0.01, seed=3).to(cuda)
    q = compile_.compile_plan(plan, "auto")
    np.testing.assert_array_equal(q.execute(db),
                                  engine.run_query_oracle(db, plan))
    assert q.decided in ("fused", "opat", "part")


@pytest.fixture
def resident_db(cuda):
    """SF 0.05 resident on the card, and the oracle of the 13 queries."""
    db = ssb.generate(sf=0.05, seed=17).to(cuda)
    return db, {name: engine.run_query_oracle(db, plan)
                for name, plan in engine.ssb_queries().items()}


@pytest.mark.parametrize("strategy", ["fused", "shared", "auto"])
def test_query_server_on_card_bit_identical(resident_db, strategy):
    """The server on the card (its default device and mode): the 13
    queries in one batch, each the oracle's bits on its first attempt,
    with no retry and no fallback."""
    from repro_torch.sql import server
    db, want = resident_db
    srv = server.QueryServer(db, max_batch=16)
    assert srv.device.type == "cuda" and srv.mode == "auto"
    rids = {name: srv.submit(plan, strategy)
            for name, plan in engine.ssb_queries().items()}
    got = srv.run()
    for name, rid in rids.items():
        r = got[rid]
        assert r.error is None and r.attempts == 1, (name, r.error)
        assert r.result.tobytes() == want[name].tobytes(), name
        assert r.strategy != "ref" and r.launch_config, name
    assert srv.stats["retries"] == srv.stats["fallbacks"] == 0
    if strategy == "shared":
        assert {r.shared_wave_size for r in got.values()} == {13}


def test_tuner_smoke_grid_on_card(cuda, tmp_path, monkeypatch):
    """``tune.measure(SMOKE_GRID)`` on the card: every family swept (each
    configuration checked before it is timed), the store written, and its
    partition depth the one ``part_bits`` reads back."""
    from repro_torch.sql import calibrate, model, tune
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    tunings = tune.measure(grid=tune.SMOKE_GRID)
    assert tunings.backend == "cuda"
    assert {c.family for c in tunings.configs.values()} == \
        set(tune.FAMILIES)
    tune.save(tunings)
    tune._MEMO.clear()
    assert tune.load_cached(cuda) == tunings
    pp = tunings.configs["part_probe/w32"]
    hw = model.default_hardware(cuda)
    assert hw.part_budget_bytes == pp.part_budget_bytes
    assert hw.read_bw == tunings.configs["select_scan/w32"].eff_bw
    assert model.part_bits(tune.SMOKE_GRID["n_build"], hw) == pp.part_bits
    assert tune.tuned_r(device=cuda) == tunings.configs["radix_sort/w32"].r
    calibrate._MEMO.clear()
    tune._MEMO.clear()


def test_out_of_memory_on_card_is_memory_pressure(cuda, monkeypatch):
    """A real allocation failure on the card maps to ``MemoryPressure``;
    out of the fused kernel's call it halves the server's morsels, and the
    request still answers one rung down."""
    from repro_torch.sql import resilience, server
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(1 << 46, dtype=torch.uint8, device=cuda)
    assert isinstance(resilience.classify_error(ei.value),
                      resilience.MemoryPressure)

    def oom(*a, **k):
        torch.empty(1 << 46, dtype=torch.uint8, device=cuda)

    db = ssb.generate(sf=0.01, seed=3).to(cuda)
    plan = engine.ssb_queries()["q2.1"]
    monkeypatch.setattr(ops, "spja", oom)
    srv = server.QueryServer(db, morsel_bytes=1 << 24)
    rid = srv.submit(plan, "fused")
    r = srv.run()[rid]
    assert srv.stats["pressure_events"] == 2
    assert srv.governor.morsel_bytes == 1 << 22
    assert r.error is None and r.strategy == "opat"
    np.testing.assert_array_equal(r.result, engine.run_query_oracle(db, plan))


def test_kernel_failure_on_card_is_a_device_error(resident_db, monkeypatch):
    """A kernel that fails on the card ends its request in a typed
    ``DeviceError`` on the first attempt: no rung after it, none on the
    host."""
    from repro_torch.sql import server
    db, want = resident_db

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(ops, "spja", broken)
    srv = server.QueryServer(db)
    rid = srv.submit(engine.ssb_queries()["q2.1"], "fused")
    r = srv.run()[rid]
    assert r.result is None and r.error.error_kind == "DeviceError"
    assert r.attempts == 1 and r.strategy == "fused"
    assert srv.stats["retries"] == srv.stats["fallbacks"] == 0


# ---------------------------------------------------------------------------
# the LM serving path (plain PyTorch on the card; no kernel of its own)
# ---------------------------------------------------------------------------

LM_SEED = 14
LM_TOL = 1e-4       # float32 on card and host, the CPU tests' tolerance


@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_lm_smoke_config_on_card_matches_host(cuda, arch):
    """forward, loss, prefill (every cache leaf) and two decode steps at
    smoke width, float32: the card within 1e-4 of the host on the same
    parameters."""
    cfg = lm_configs.smoke_config(arch)
    host = lm_api.init(cfg, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    want = lm_smoke.pass_outputs(host, cfg,
                                 lm_smoke.batch(cfg, LM_SEED, "cpu"))
    got = lm_smoke.pass_outputs(lm_api.to(host, cuda), cfg,
                                lm_smoke.batch(cfg, LM_SEED, cuda))
    lm_smoke.assert_close(got, want, LM_TOL)


def test_lm_int8_cache_on_card_matches_host(cuda):
    """The int8 KV cache: equal on card and host, the rest within 1e-4."""
    cfg = lm_configs.smoke_config("qwen2-0.5b").replace(
        kv_cache_dtype="int8")
    host = lm_api.init(cfg, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    want = lm_smoke.pass_outputs(host, cfg,
                                 lm_smoke.batch(cfg, LM_SEED, "cpu"))
    got = lm_smoke.pass_outputs(lm_api.to(host, cuda), cfg,
                                lm_smoke.batch(cfg, LM_SEED, cuda))
    assert got["prefill.k"].dtype == torch.int8
    lm_smoke.assert_close(got, want, LM_TOL)


def test_lm_entry_points_default_to_the_card(cuda):
    cfg = lm_configs.smoke_config("qwen2-0.5b")
    params = lm_api.init(cfg)
    assert params["embed"].device == cuda
    assert lm_api.init_cache(cfg, 2, 8)["k"].device == cuda
    assert lm_engine.BatchServer(cfg, params).device == cuda


def test_batch_server_slot_isolation_on_card(cuda):
    """A request served in a padded wave on the card gives the tokens of
    the same prompt served alone, and the host's tokens."""
    cfg = lm_configs.smoke_config("qwen2.5-3b")
    host = lm_api.init(cfg, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    params = lm_api.to(host, cuda)
    prompt = list(range(10, 18))
    rng = np.random.default_rng(1)
    others = [rng.integers(0, cfg.vocab_size, len(prompt)).tolist()
              for _ in range(2)]

    def serve(p, device, prompts, slots):
        srv = lm_engine.BatchServer(cfg, p, max_batch=slots, device=device)
        for rid, pr in enumerate(prompts):
            srv.submit(lm_engine.Request(rid, pr, max_new=5))
        return {rid: c.tokens for rid, c in srv.run().items()}

    solo = serve(params, cuda, [prompt], 1)
    waved = serve(params, cuda, [prompt] + others, 4)
    assert solo[0] == waved[0]
    assert waved == serve(host, "cpu", [prompt] + others, 4)


# ---------------------------------------------------------------------------
# the LM training path (plain PyTorch on the card; the pipeline's filter is
# the select_scan kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_lm_train_step_on_card_matches_host(cuda, arch):
    """The loss, every gradient leaf and one train step (params, moments,
    step, metrics) at smoke width, float32: the card within 1e-4 of the
    host on the same parameters and batch."""
    cfg = lm_configs.smoke_config(arch)
    host = lm_api.init(cfg, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    want = lm_smoke.train_outputs(host, cfg,
                                  lm_smoke.batch(cfg, LM_SEED, "cpu"))
    got = lm_smoke.train_outputs(lm_api.to(host, cuda), cfg,
                                 lm_smoke.batch(cfg, LM_SEED, cuda))
    assert lm_smoke.least_move(host, want) > 5 * LM_TOL
    lm_smoke.assert_close(got, want, LM_TOL)


@pytest.mark.parametrize("band", [(0.2, 1.0), (0.9, 1.0), (2.0, 3.0)])
def test_pipeline_batch_on_card_equals_host_and_launches_select_scan(
        cuda, band):
    """Each batch on the card launches ``select_scan`` once and equals
    the host's batch (the plain filter), with survivors to spare, fewer
    than the batch, and none."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    for arch in ("qwen2-0.5b", "paligemma-3b"):
        cfg = lm_configs.smoke_config(arch)
        pipe = TokenPipeline(cfg, DataConfig(batch=8, seq=32,
                                             quality_lo=band[0],
                                             quality_hi=band[1]))
        for step in range(3):
            before = select_scan.LAUNCHES
            got = pipe.batch_at(step)
            assert select_scan.LAUNCHES == before + 1
            want = pipe.batch_at(step, "cpu")
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device == cuda
                assert torch.equal(got[k].cpu(), want[k]), (arch, step, k)


def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A bf16 tree with its optimizer state saved from card tensors, one
    train step on, restored on the host with every leaf's bits."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.api import leaves, tree_map
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.step import make_train_step
    cfg = lm_configs.smoke_config("qwen2-0.5b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    params = lm_api.init(cfg)
    opt = init_opt_state(params)
    params, opt, _ = make_train_step(cfg)(params, opt,
                                          lm_smoke.batch(cfg, 0, cuda))
    tree = {"params": params, "opt": opt}
    CheckpointManager(tmp_path).save(1, tree)
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                        tree)
    got = CheckpointManager(tmp_path).restore(1, template)
    for (path, g), (_, w) in zip(leaves(got), leaves(tree)):
        assert g.device.type == "cpu" and g.dtype == w.dtype, path
        assert torch.equal(g.flatten().view(torch.uint8),
                           w.cpu().flatten().view(torch.uint8)), path


def test_launch_train_smoke_on_card(cuda, tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke`` on the card (its
    default device) for a few steps, checkpointed and resumed."""
    from repro_torch.launch import train as lm_train
    args = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "32",
            "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    before = select_scan.LAUNCHES
    lm_train.main(args)
    first = capsys.readouterr().out
    assert "(cuda:" in first.splitlines()[0] and first.rstrip().endswith(
        "done")
    assert select_scan.LAUNCHES == before + 6
    lm_train.main(args[:2] + ["8"] + args[3:])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step     7 loss" in out


def test_sharded_over_a_world_of_two_ranks_on_card(cuda):
    """A gloo world of 2 ranks sharing the card (NCCL refuses two ranks on
    one device): the 13 queries ``sharded`` at SF 0.01, each rank folding
    its own resident shard with one ``spja`` launch a query, the grids
    all-reduced — every rank the oracle's bits."""
    from repro_torch.distributed import mesh, ranks
    db = ssb.generate(0.01, seed=3)
    backend = mesh.backend_for(["cuda:0", "cuda:0"])
    assert backend == "gloo"
    out = mesh.spawn(ranks.sql_rank, 2, backend, {
        "db": db, "runs": [{"label": "plain", "resident": True}],
        "interconnect": [2]}, timeout_s=300)
    for name, plan in engine.ssb_queries().items():
        want = engine.run_query_oracle(db, plan)
        for r in out:
            run = r["runs"]["plain"]
            assert np.array_equal(run["results"][name], want), name
            assert run["spja"][name] == 1 and run["device_count"][name] == 2
    for r in out:
        assert r["device"] == "cuda:0"
        assert r["runs"]["plain"]["launches"] == {"ssb_fused.LAUNCHES": 13}
        [link] = r["interconnect"]
        assert link["backend"] == "gloo" and link["rate"] > 0


def test_moe_mesh_on_card_matches_host(cuda):
    """Expert-parallel MoE on a 2 x 2 mesh of gloo ranks on the card: each
    rank's rows, aux and ``api.forward`` logits within 1e-4 of the host's
    local path on the same parameters (phase 14's tolerance)."""
    from repro_torch.distributed import mesh, ranks
    cases = [{"arch": arch, "mesh": (2, 2), "seed": 5, "batch": 4,
              "seq": 16, "forward": True}
             for arch in ("qwen3-moe-30b-a3b", "deepseek-moe-16b")]
    out = mesh.spawn(ranks.moe_rank, 4, "gloo", {"cases": cases},
                     timeout_s=300)
    for r in out:
        for case in r["cases"]:
            assert case["local_on"] == "cpu"
            assert case["max_abs_err"] <= 1e-4, case["arch"]
            assert case["aux_err"] <= 1e-4 and case["forward_err"] <= 1e-4


def test_pin_after_a_morsel_stream_locked_the_columns_on_card(cuda):
    """A table pinned after a morsel stream page-locked its columns in
    place (the mesh phase's windows run, then its packed run): the
    upload is copied around the locked pages, plain and packed, and the
    shard of a rank, a view into the middle of a locked column, too."""
    from repro_torch.sql import morsel
    db = ssb.generate(0.01, seed=4)
    fact = db.lineorder
    for col in fact.columns:
        morsel.page_lock(fact.columns[col])
        assert morsel.locked_range(fact.columns[col]) != (0, 0)
    n = fact.n_rows
    for table in (fact, storage.pack_table(fact),
                  storage.slice_rows(fact, n // 3, n),
                  storage.slice_rows(storage.pack_table(fact), n // 2, n)):
        table.pin(cuda)
        for col in table.columns:
            got = table.on_device(col, cuda).cpu().numpy()
            want = (table.columns[col].words
                    if isinstance(table, storage.PackedTable)
                    else table.columns[col])
            assert np.array_equal(got, np.asarray(want, np.int32)), col


@pytest.fixture(scope="module")
def train_mesh_world(tmp_path_factory):
    """One gloo world of 2 ranks sharing the card: the sharded smoke
    step (a 2 x 1 mesh with ZeRO-1, a 1 x 2 mesh without), the group
    compression and GPipe over 2 stages; the single-rank steps on the
    host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks run on the card")
    import dataclasses
    from repro_torch.distributed import mesh, ranks
    tmp = tmp_path_factory.mktemp("train_mesh")
    tol = {"params": (1e-4, 1e-4), "m": (1e-4, 0.0, 1e-4),
           "v": (1e-4, 0.0, 1e-4)}
    cases = []
    for arch, shape, zero1 in (("qwen2.5-3b", (2, 1), True),
                               ("mamba2-2.7b", (1, 2), False)):
        case = {"arch": arch, "mesh": shape, "zero1": zero1, "seed": 3,
                "batch": 4, "seq": 16, "steps": 2, "tol": tol,
                "opt": dataclasses.asdict(lm_smoke.TRAIN_OPT),
                "want": str(tmp / f"{arch}.pt")}
        ranks.single_rank_train(case, torch.device("cpu"), case["want"])
        cases.append(case)
    pipe = {"S": 2, "F": 4, "MB": 2, "D": 16, "seed": 4}
    out = mesh.spawn(ranks.chain_rank, 2, mesh.backend_for(["cuda:0"] * 2), {
        "bodies": [("train_rank", {"cases": cases}),
                   ("compress_rank", {"n": 1 << 16, "seed": 6, "reps": 1}),
                   ("pipe_rank", {"cases": [pipe]})]}, timeout_s=300)
    return cases, pipe, out


def test_sharded_train_step_on_card_matches_host(train_mesh_world):
    """Each rank's blocks, loss and gradient norm within 1e-4 of the
    single-rank step on the host (phase 15's card-vs-host tolerance; the
    moments within 1e-4 of their block's largest entry)."""
    cases, _, out = train_mesh_world
    for r in out:
        assert r["train_rank"]["device"] == "cuda:0"
        for case, got in zip(cases, r["train_rank"]["cases"]):
            assert got["loss_rel"] <= 1e-4 and got["grad_norm_rel"] <= 1e-4
            assert got["step_equal"] and got["launches"] == {}
            for name, e in got["errors"].items():
                assert e["excess"] <= 1.0, (case["arch"], name, e)
            assert set(got["collectives"]) <= {"all_reduce", "broadcast"}


def test_group_compression_on_card_matches_stacked(train_mesh_world):
    """int8 over the group the stacked form's bits; bf16 within the
    backend's one rounding of 2 ranks."""
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import ranks
    _, _, out = train_mesh_world
    res = [r["compress_rank"] for r in out]
    g, err = ranks.compress_inputs(1 << 16, 2, 6)
    gs = torch.from_numpy(g).cuda()
    want, new_errs = C.compressed_psum_stacked(gs, torch.from_numpy(err)
                                               .cuda())
    assert np.array_equal(res[0]["compressed"].view(np.int32),
                          want.cpu().numpy().view(np.int32))
    for r in res:
        assert r["digest"]["new_err"] == ranks.digest(new_errs[r["rank"]])
        assert r["digest"]["compressed"] == res[0]["digest"]["compressed"]
    bound = 2.0 ** -8 * gs.to(torch.bfloat16).double().abs().sum(0).cpu()
    got = torch.from_numpy(res[0]["bf16"]).double()
    assert bool(((got - C.bf16_psum_stacked(gs).double().cpu()).abs()
                 <= bound).all())


def test_gpipe_on_card_matches_serial(train_mesh_world):
    """GPipe over 2 ranks on the card against the serial network on the
    host, the reference test's tolerances."""
    from repro_torch.distributed import ranks
    _, pipe, out = train_mesh_world
    y, loss, grads = ranks.pipe_serial(pipe)
    rs = {c["rank"]: c for c in (r["pipe_rank"]["cases"][0] for r in out)}
    np.testing.assert_allclose(rs[0]["y"], y, rtol=1e-4, atol=1e-6)
    for s, r in rs.items():
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        for k in grads:
            np.testing.assert_allclose(r["grads"][k][0], grads[k][s],
                                       rtol=1e-4, atol=1e-6)
        assert r["collectives"] == ["all_reduce"]
