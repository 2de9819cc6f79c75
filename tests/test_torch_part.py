"""The port's partitioned join on the CPU against the reference package:
the plain ``part_probe``, ``ops.part_join``, the partitioned builds,
``part_bits``, and the 13 SSB queries through ``part`` and ``part_loop``.

Same inputs in both (made with numpy from a seed; the database carried
across with ``from_numpy``).  Tolerances:

* ``part_probe``: bit-identical on ``[:count]`` to the reference's
  interpret-mode Pallas kernel (its padded tail is arbitrary) and to its
  jnp oracle (the whole output: its tail is zeros, as the port's);
* the partitioned tables: byte-identical;
* the 13 queries: bit-identical to the numpy oracle (the port sums
  exactly and rounds once); within ``tests/test_ssb.py``'s rtol 1e-5 /
  atol 1e-3 of the reference's ``part`` / ``part_loop`` in ``ref`` mode,
  which sum in f32.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import part_probe as RPP
from repro.kernels import ref as RREF
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import hashtable as RHT
from repro.sql import model as RM
from repro.sql import ssb as RSSB
from repro_torch import cases
from repro_torch.kernels import ops, part_probe, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import hashtable as THT
from repro_torch.sql import model as TM
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB
from repro_torch.sql import storage as TST

REF_DB = RSSB.generate(sf=0.01, seed=3)          # 60k fact rows
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
PDB = TST.pack_database(DB)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()
JOINS = [(name, j) for name in PORT_Q
         for j in range(len(PORT_Q[name].joins))]


def _jnp(case):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in case)


# ---------------------------------------------------------------------------
# the plain part_probe
# ---------------------------------------------------------------------------


def _reference_rows(case):
    """The probe side the reference is given: all of it, or, where a
    partition's row of the tables has no EMPTY slot, without that
    partition's rows whose key the row does not hold (offs and counts
    taken again).  The reference's walk has no lap cap, so a miss in a
    full row would not end; a miss never reaches the output, so the
    outputs agree.  Its kernel probes every row of a tile-sized chunk
    against the chunk's partition, so "full" gives partition 0 a run of
    found rows a multiple of the 128-row tile."""
    keys, rowids, groups, offs, counts, htk, htv, mult = case
    full = (htk != THT.EMPTY).all(axis=1)
    if not full.any():
        return case
    part = keys & (htk.shape[0] - 1)
    held = ~full[part] | (htk[part] == keys[:, None]).any(axis=1)
    counts = np.bincount(part[held], minlength=htk.shape[0]).astype(
        np.int32)
    return (keys[held], rowids[held], groups[held],
            (np.cumsum(counts) - counts).astype(np.int32), counts, htk, htv,
            mult)


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("kind", cases.PART_PROBE_KINDS)
def test_part_probe_matches_reference_kernel_and_oracle(kind, bits):
    case = cases.part_probe_case(10 * bits + len(kind), 777, bits, kind)
    outr, outg, cnt = TREF.part_probe(*cases.tensors(case, "cpu"))
    assert outr.dtype == torch.int32 and cnt.dim() == 0
    c = int(cnt)
    sub = _reference_rows(case)
    m = sub[0].shape[0]
    kr, kg, kc = RPP.part_probe(*_jnp(sub), tile=128, interpret=True)
    assert c == int(kc)
    np.testing.assert_array_equal(outr.numpy()[:c], np.asarray(kr)[:c])
    np.testing.assert_array_equal(outg.numpy()[:c], np.asarray(kg)[:c])
    orr, org, oc = RREF.part_probe(*_jnp(sub))
    assert c == int(oc)
    np.testing.assert_array_equal(outr.numpy()[:m], np.asarray(orr))
    np.testing.assert_array_equal(outg.numpy()[:m], np.asarray(org))
    assert not outr.numpy()[m:].any() and not outg.numpy()[m:].any()
    if kind == "empty_table":
        assert c == 0
    else:
        assert c > 0
    if kind == "dead":
        assert (outr.numpy()[:c] >= 0).all()


def _brute(case):
    """Matches in input order, each key's chain walked one slot at a time
    in its partition's table: (rowids, groups)."""
    keys, rowids, groups, offs, counts, htk, htv, mult = case
    n_parts, n_slots = htk.shape
    rows, grps = [], []
    for k, r, g in zip(keys.tolist(), rowids.tolist(), groups.tolist()):
        p = k & (n_parts - 1)
        slot = int(THT.np_hash(np.array([k], np.int32), n_slots)[0])
        while htk[p, slot] not in (k, THT.EMPTY):
            slot = (slot + 1) % n_slots
        if r < 0 or htk[p, slot] != k:
            continue
        rows.append(r)
        grps.append(g + int(htv[p, slot]) * mult)
    return np.array(rows, np.int32), np.array(grps, np.int32)


@pytest.mark.parametrize("kind", ["hot", "duplicates", "dead"])
def test_part_probe_matches_brute_force(kind):
    case = cases.part_probe_case(5, 2000, 4, kind)
    outr, outg, cnt = TREF.part_probe(*cases.tensors(case, "cpu"))
    er, eg = _brute(case)
    np.testing.assert_array_equal(outr.numpy()[:int(cnt)], er)
    np.testing.assert_array_equal(outg.numpy()[:int(cnt)], eg)


@pytest.mark.parametrize("n", [1, 777, 5000])
def test_part_join_with_and_without_pow2_padding(n):
    """The reference pads the probe side to a power of two with dead rows
    (rowid -1) for XLA's trace cache; the port does not.  Dead rows never
    match, so padding changes nothing: the same bits either way, and the
    reference's ``part_join`` in ``ref`` mode agrees."""
    rng = np.random.default_rng(n)
    bits = 3
    bk = np.unique(rng.integers(-300, 300, 200)).astype(np.int32)
    bv = rng.integers(0, 9, len(bk), dtype=np.int32)
    htk, htv = THT.pack_partitions(bk, bv, bits)
    col = rng.integers(-350, 350, 10_000, dtype=np.int32)
    rowids = rng.choice(10_000, n, replace=False).astype(np.int32)
    groups = rng.integers(0, 5, n, dtype=np.int32)
    t = cases.tensors((col, rowids, groups, htk, htv), "cpu")
    got = ops.part_join(*t, 7, bits)
    pad = (1 << max((n - 1).bit_length(), 0)) - n
    padded = ops.part_join(
        t[0], torch.cat([t[1], torch.full((pad,), -1, dtype=torch.int32)]),
        torch.cat([t[2], torch.zeros(pad, dtype=torch.int32)]), t[3], t[4],
        7, bits)
    c = int(got[2])
    assert c == int(padded[2]) and c > 0
    for g, p in zip(got[:2], padded[:2]):
        assert torch.equal(g[:c], p[:c])
    want = ROPS.part_join(*_jnp((col, rowids, groups, htk, htv)), 7, bits,
                            mode="ref")
    assert c == int(want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[:c], np.asarray(w)[:c])


def test_part_join_on_a_packed_column_equals_the_plain_one():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 200, 3001, dtype=np.int32)
    col = TST.pack_column(vals)
    assert col.encoding.phys < 32
    bk = np.arange(0, 200, 3, dtype=np.int32)
    htk, htv = THT.pack_partitions(bk, bk % 11, 2)
    rowids = torch.from_numpy(rng.permutation(3001)[:900].astype(np.int32))
    groups = torch.zeros(900, dtype=torch.int32)
    t = cases.tensors((htk, htv), "cpu")
    plain = ops.part_join(torch.from_numpy(vals), rowids, groups, *t, 3, 2)
    packed = ops.part_join(torch.from_numpy(col.words), rowids, groups, *t,
                           3, 2, width=col.encoding.phys,
                           ref=col.encoding.ref)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)
    assert int(plain[2]) > 0


def test_part_ops_modes_on_cpu_tensors():
    case = cases.tensors(cases.part_probe_case(2, 500, 4, "dead"), "cpu")
    want = TREF.part_probe(*case)
    for mode in ("auto", "ref"):
        for g, w in zip(ops.part_probe(*case, mode=mode), want):
            assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.part_probe(*case, mode="kernel")
    before = part_probe.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        part_probe.part_probe(*case)
    assert part_probe.LAUNCHES == before
    z = torch.zeros(0, dtype=torch.int32)
    outr, outg, cnt = ops.part_join(torch.arange(4, dtype=torch.int32), z, z,
                                    case[5], case[6], 3, 4)
    assert outr.shape == (0,) and int(cnt) == 0


# ---------------------------------------------------------------------------
# partitioned builds and their sizing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,j", JOINS)
def test_build_dim_partitions_byte_identical(name, j):
    port_join, ref_join = PORT_Q[name].joins[j], REF_Q[name].joins[j]
    n_build = len(THT.filtered_build_side(DB, port_join)[0])
    for bits in {TM.part_bits(n_build), 3}:
        packed = THT.build_dim_partitions(DB, port_join, bits, packed=True,
                                          device="cpu")
        want = RHT.build_dim_partitions(REF_DB, ref_join, bits, packed=True)
        assert packed.htk.dtype == torch.int32
        assert packed.device == torch.device("cpu")
        np.testing.assert_array_equal(packed.htk.numpy(),
                                      np.asarray(want.htk))
        np.testing.assert_array_equal(packed.htv.numpy(),
                                      np.asarray(want.htv))
        assert (packed.n_parts, packed.n_slots, packed.nbytes) == \
            (want.n_parts, want.n_slots, want.nbytes)
        parts = THT.build_dim_partitions(DB, port_join, bits, device="cpu")
        want_parts = RHT.build_dim_partitions(REF_DB, ref_join, bits)
        assert len(parts) == len(want_parts) == 1 << bits
        for (k, v), (wk, wv) in zip(parts, want_parts):
            np.testing.assert_array_equal(k.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


def test_part_bits_matches_reference():
    sizes = sorted({0, 1, 2, 1 << 24} | {
        (1 << e) + d for e in range(25) for d in (-1, 0, 1)
        if 0 <= (1 << e) + d <= 1 << 24} | set(
            np.random.default_rng(0).integers(0, 1 << 24, 200).tolist()))
    for n in sizes:
        assert TM.part_bits(n) == RM.part_bits(n, RM.HOST), n
        assert TM.ht_bytes(n) == RM.ht_bytes(n), n
    assert min(RM.PART_BUDGET_BYTES, int(RM.HOST.cache_size) // 4) == \
        min(TM.PART_BUDGET_BYTES, TM.L2_BYTES // 4) == 1 << 18
    assert (TM.W, TM.MAX_PART_BITS) == (RM.W, RM.MAX_PART_BITS)


def test_partition_cache_keys_layout_bits_and_device():
    cache = THT.HashTableCache()
    join = PORT_Q["q4.1"].joins[2]
    n = cache.get_build_count(DB, join)
    assert n == len(THT.filtered_build_side(DB, join)[0])
    assert (cache.hits, cache.misses) == (0, 0)
    assert cache.get_build_count(DB, join) == n
    packed = cache.get_or_build_parts(DB, join, 2, packed=True,
                                      device="cpu")
    parts = cache.get_or_build_parts(DB, join, 2, device="cpu")
    assert isinstance(packed, THT.PackedParts) and isinstance(parts, list)
    assert cache.get_or_build_parts(DB, join, 2, packed=True,
                                    device="cpu") is packed
    assert cache.get_or_build_parts(DB, join, 3, device="cpu") is not parts
    assert (cache.hits, cache.misses) == (1, 3)


# ---------------------------------------------------------------------------
# the 13 queries through part and part_loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["part", "part_loop"])
@pytest.mark.parametrize("name", list(PORT_Q))
def test_part_query_matches_oracle_and_reference(name, strategy):
    plan = PORT_Q[name]
    want = TE.run_query_oracle(DB, plan)
    ref_q = RC.compile_plan(REF_Q[name], strategy)
    q = TC.compile_plan(plan, strategy)
    assert (q.strategy, q.requested, q.fallback_reason) == \
        (ref_q.strategy, strategy, ref_q.fallback_reason)
    cache = THT.HashTableCache()
    got = q.execute(DB, cache=cache, device="cpu")
    assert got.dtype == np.float32 and got.shape == (plan.n_groups,)
    np.testing.assert_array_equal(got, want)
    misses = cache.misses       # a join after the rows ran out builds none
    assert misses <= len({THT.join_cache_key(j) for j in plan.joins})
    # the packed database: every build a hit; and without a cache
    np.testing.assert_array_equal(q.execute(PDB, cache=cache, device="cpu"),
                                  want)
    assert cache.misses == misses
    np.testing.assert_array_equal(q.execute(PDB, device="cpu"), want)
    # the packed results equal these bits, so the reference's packed
    # run (equal to its plain one within its f32 rounding) is not rerun
    np.testing.assert_allclose(got, ref_q.execute(REF_DB, mode="ref"),
                               rtol=1e-5, atol=1e-3)


def test_part_loop_probes_each_non_empty_partition(monkeypatch):
    plan = PORT_Q["q2.1"]
    calls = {"probe_join": 0, "part_probe": 0}
    for fn in calls:
        real = getattr(ops, fn)

        def counted(*a, _fn=fn, _real=real, **k):
            calls[_fn] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, fn, counted)
    TC.compile_plan(plan, "part").execute(DB, device="cpu")
    assert calls == {"probe_join": 0, "part_probe": len(plan.joins)}
    calls["part_probe"] = 0
    got = TC.compile_plan(plan, "part_loop").execute(DB, device="cpu")
    assert calls["part_probe"] == 0
    assert len(plan.joins) < calls["probe_join"] <= len(plan.joins) << 8
    np.testing.assert_array_equal(got, TE.run_query_oracle(DB, plan))


def _no_join_plan(mod):
    return (mod.QueryBuilder("nojoin").scan("lineorder")
            .where_range("lo_discount", 1, 3)
            .measure("lo_revenue").group_by(1).build())


@pytest.mark.parametrize("strategy", ["part", "part_loop"])
def test_fallback_reasons_equal_the_reference(strategy):
    row = (lambda mod: mod.QueryBuilder("rows").scan("lineorder")
           .where_range("lo_discount", 1, 3).build())
    for make in (row, _no_join_plan):
        ref_q = RC.compile_plan(make(RC.P), strategy)
        port_q = TC.compile_plan(make(TP), strategy)
        assert ref_q.fallback_reason is not None
        assert (port_q.strategy, port_q.requested, port_q.fallback_reason) \
            == ("opat", strategy, ref_q.fallback_reason)
    got = TC.compile_plan(_no_join_plan(TP), strategy).execute(
        DB, device="cpu")
    np.testing.assert_array_equal(got, TE.run_query_oracle(
        DB, _no_join_plan(TP)))


def test_part_empty_build_side_gives_zeros():
    plan = copy.deepcopy(PORT_Q["q4.1"])
    plan.joins[2].filter = TP.EqPred("p_mfgr", 999)
    for strategy in ("part", "part_loop"):
        got = TC.compile_plan(plan, strategy).execute(DB, device="cpu")
        assert got.shape == (35,) and not got.any()
