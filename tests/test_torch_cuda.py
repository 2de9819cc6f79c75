"""The port's CUDA kernels on the card, held against their plain versions.

Needs an NVIDIA GPU: every test here skips without one.  Imports nothing
of jax or the reference package, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: bit-identical, except two cases that say why.  The fused
kernel sums exactly in int64 and the compactions are ordered by tile
offsets, so block order cannot change a result.
"""
import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import (agg, hash_join, multi_fused, ops,
                                 part_probe, project, radix_part, ref,
                                 select_scan, ssb_fused, unpack)
from repro_torch.sql import compile as compile_, engine, hashtable, ssb, \
    storage

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
    c = cases.spja_case(1, 1000, 1, 1, "first", 30_000)   # 240 KB grid
    args, kw = c.args(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssb_fused.spja(*args, **kw)
    kw["n_groups"] = 4
    bad = list(args)
    bad[5] = bad[5].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ssb_fused.spja(*bad, **kw)


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


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003])
@pytest.mark.parametrize("sel,dtype", [("mid", "int32"), ("none", "int32"),
                                       ("all", "int32"),
                                       ("mid", "float32")])
def test_select_scan_kernel_bit_identical_to_plain(cuda, n, sel, dtype):
    args = _on(cases.select_case(n, n, sel, dtype), cuda)
    out, cnt = _launched(select_scan, "select_scan", *args)
    want, want_cnt = ref.select_scan(*args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("kind", cases.PROBE_KINDS)
def test_probe_join_kernel_bit_identical_to_plain(cuda, n, kind):
    args = _on(cases.probe_case(n, n, kind), cuda)
    got = _launched(hash_join, "probe_join", *args)
    for g, w in zip(got, ref.probe_join(*args)):
        assert torch.equal(g, w)


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


@pytest.mark.parametrize("n", [1, 37, 2048, 100_003])
@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("sel", ["mid", "none", "all"])
def test_select_scan_packed_kernel_bit_identical_to_plain(cuda, n, phys,
                                                          sel):
    args = _on(cases.select_packed_case(n + phys, n, phys, sel), cuda)
    out, cnt = _launched(select_scan, "select_scan_packed", *args,
                         counter="PACKED_LAUNCHES")
    want, want_cnt = ref.select_scan_packed(*args)
    assert torch.equal(cnt, want_cnt) and torch.equal(out, want)
    assert int(cnt) == {"none": 0, "all": n}.get(sel, int(cnt))


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


@pytest.mark.parametrize("r", [4, 7, 8])
@pytest.mark.parametrize("kind", ["negative", "duplicates"])
def test_radix_sort_kernel_bit_identical_to_plain(cuda, kind, r):
    keys, (vals,), _, _ = _on(cases.radix_case(r, 100_003, 0, 1, kind, 1),
                              cuda)
    before = radix_part.HIST_LAUNCHES, radix_part.SCATTER_LAUNCHES
    got = radix_part.radix_sort(keys, vals, r=r)
    passes = -(-32 // r)
    assert (radix_part.HIST_LAUNCHES, radix_part.SCATTER_LAUNCHES) == \
        (before[0] + passes, before[1] + passes)
    assert _equal(got, ref.radix_sort(keys, vals, r=r))
    assert _equal(radix_part.radix_sort(keys, vals, r=r), got)
    order = np.argsort(keys.cpu().numpy().view(np.uint32), kind="stable")
    np.testing.assert_array_equal(got[1].cpu().numpy(), order)


@pytest.mark.parametrize("n", [1, 37, 100_003])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("kind", cases.PART_PROBE_KINDS)
def test_part_probe_kernel_bit_identical_to_plain(cuda, kind, bits, n):
    args = _on(cases.part_probe_case(bits + n, n, bits, kind), cuda)
    got = _launched(part_probe, "part_probe", *args)
    assert _equal(got, ref.part_probe(*args))
    assert _equal(part_probe.part_probe(*args), got)


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
    db = ssb.generate(sf=0.05, seed=7)
    before = radix_part.HIST_LAUNCHES
    out = engine.order_by(db.lineorder, "lo_orderdate")
    assert radix_part.HIST_LAUNCHES == before + 4
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
