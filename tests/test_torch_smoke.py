"""``chip_smoke.py``'s bounds: the bytes and operations one ``spja`` call,
one call of each opat kernel, and one ``probe_agg`` and
``select_scan_sparse`` call, needs on its data, held against a
row-by-row count in plain Python.  Tolerance: exact (integer counts, and
shares of a sector past the L2 that sum exactly)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import ref
from repro_torch.sql import hashtable, storage

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

CASES = [
    dict(n=500, n_preds=2, n_joins=0, measure_op="mul", n_groups=1),
    dict(n=700, n_preds=1, n_joins=2, measure_op="sub", n_groups=30,
         duplicates=True, wrap=True, build_rows=40),
    dict(n=333, n_preds=0, n_joins=3, measure_op="first", n_groups=50,
         empty_join=True),
    dict(n=900, n_preds=3, n_joins=4, measure_op="first", n_groups=200,
         build_rows=60),
]


PACKED_CASES = [
    dict(n=999, n_preds=2, n_joins=1, measure_op="mul", n_groups=8,
         pred_phys=1),
    dict(n=1201, n_preds=1, n_joins=2, measure_op="sub", n_groups=30,
         pred_phys=4, duplicates=True, wrap=True, build_rows=40),
    dict(n=517, n_preds=3, n_joins=1, measure_op="first", n_groups=1,
         pred_phys=16, small=True),
]


def _brute(c) -> dict:
    """Walk every row as the kernel does and count what it touches: a
    stream packed c values a word holds 16·c rows a 64-byte segment, and
    each value decoded from it costs 2 operations."""
    packed = c.packed or {}
    n_meas = 1 if c.m2 is None else 2
    live = [True] * c.n
    fact = table = ops = 0

    def read(arr, width, r=0):
        nonlocal fact, ops
        seg = (smoke.SEGMENT // 4) * (32 // width)
        fact += smoke.SEGMENT * len({i // seg for i in range(c.n) if live[i]})
        if width != 32:
            ops += 2 * sum(live)
            return storage.unpack_words(arr, c.n, width, r)
        return arr

    widths = packed.get("pred_widths", (32,) * len(c.pred_cols))
    for col, w, (lo, hi) in zip(c.pred_cols, widths,
                                c.pred_bounds.reshape(-1, 2)):
        col = read(col, w)
        for r in range(c.n):
            if live[r]:
                ops += 2
                live[r] = bool(lo <= col[r] <= hi)
    group = [0] * c.n
    key_widths = packed.get("key_widths", (32,) * len(c.join_keys))
    key_refs = packed.get("key_refs", [0] * len(c.join_keys))
    for j, keys in enumerate(c.join_keys):
        keys = read(keys, key_widths[j], int(key_refs[j]))
        htk, htv = c.join_tables[2 * j], c.join_tables[2 * j + 1]
        mask = len(htk) - 1
        visited, hits = set(), set()
        for r in range(c.n):
            if not live[r]:
                continue
            key = int(keys[r])
            slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
            found = False
            for _ in range(len(htk)):
                visited.add(slot)
                ops += 4
                if htk[slot] == key:
                    found = True
                    break
                if htk[slot] == -2 ** 31:
                    break
                slot = (slot + 1) & mask
            live[r] = found
            if found:
                hits.add(slot)
                ops += 2
                group[r] += int(htv[slot]) * int(c.group_mults[j])
        seg = smoke.SEGMENT // 4
        table += smoke.SEGMENT * (len({s // seg for s in visited})
                                  + len({s // seg for s in hits}))
    for r in range(c.n):
        live[r] = live[r] and (group[r] & 0xFFFFFFFF) < c.n_groups
    m_widths = packed.get("m_widths", (32,) * n_meas)
    for m, w in zip((c.m1, c.m2)[:n_meas], m_widths):
        read(m, w)
    ops += 2 * sum(live)
    return {"fact_bytes": fact, "table_bytes": table,
            "bytes": fact + table + 4 * c.n_groups, "ops": ops}


@pytest.mark.parametrize("i", range(len(CASES)))
def test_must_move_counts_what_the_kernel_touches(i):
    c = cases.spja_case(300 + i, **CASES[i])
    args, _ = c.args("cpu")
    got = smoke.must_move(args, c.n_groups)
    want = _brute(c)
    assert {k: got[k] for k in want} == want
    assert got["bytes_ms"] == want["bytes"] / smoke.HBM_BYTES_PER_S * 1e3


@pytest.mark.parametrize("i", range(len(PACKED_CASES)))
def test_must_move_counts_packed_streams_by_their_words(i):
    c = cases.packed_spja_case(400 + i, **PACKED_CASES[i])
    args, kw = c.args("cpu")
    got = smoke.must_move(args, **kw)
    want = _brute(c)
    assert {k: got[k] for k in want} == want
    # the same streams decoded to plain int32 columns move more bytes
    unpacked = smoke.must_move(_decoded(c, args), c.n_groups)
    assert got["fact_bytes"] < unpacked["fact_bytes"]
    assert got["table_bytes"] == unpacked["table_bytes"]


def _decoded(c, args) -> tuple:
    """A packed case's spja arguments with every stream decoded."""
    j = c.packed

    def dec(a, w, r):
        return None if a is None else ref.decode_stream(a, w, int(r), c.n)

    m_widths = tuple(j["m_widths"]) + (32,)
    m_refs = tuple(j["m_refs"]) + (0,)
    return ([dec(a, w, 0) for a, w in zip(args[0], j["pred_widths"])],
            args[1],
            [dec(a, w, r) for a, w, r in zip(args[2], j["key_widths"],
                                             j["key_refs"])],
            args[3], args[4], dec(args[5], m_widths[0], m_refs[0]),
            dec(args[6], m_widths[1], m_refs[1]))


def _probe_brute(keys, htk):
    """(found rows, probe steps, 64-byte segments visited + hit) of a
    linear probe walked key by key."""
    seg, mask = smoke.SEGMENT // 4, len(htk) - 1
    found = steps = 0
    visited, hits = set(), set()
    for key in keys.tolist():
        slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
        for _ in range(len(htk)):
            visited.add(slot)
            steps += 1
            if htk[slot] == key:
                found += 1
                hits.add(slot)
                break
            if htk[slot] == -2 ** 31:
                break
            slot = (slot + 1) & mask
    return found, steps, smoke.SEGMENT * (len({s // seg for s in visited})
                                          + len({s // seg for s in hits}))


@pytest.mark.parametrize("fn,case", [
    ("select_scan", cases.select_case(1, 777, "mid")),
    ("select_scan", cases.select_case(2, 333, "none", "float32")),
    ("probe_join", cases.probe_case(3, 900, "duplicate_wrap", 60)),
    ("probe_join", cases.probe_case(4, 100, "empty")),
    ("project", cases.project_case(5, 501) + (1.0, -1.0)),
    ("group_sum", cases.group_case(6, 640, 37, "f32_integers")),
    ("group_sum", cases.group_case(7, 640, 5, "int32_overflow")),
])
def test_opat_need_counts_what_the_function_moves(fn, case):
    args = cases.tensors(case, "cpu")
    n = len(case[0])
    got = smoke.opat_need(fn, args, getattr(ref, fn)(*args))
    if fn == "select_scan":
        x, _, lo, hi = case
        count = int(sum(lo <= v <= hi for v in x.tolist()))
        want = (8 * n + 4 * count, 2 * n, smoke.INT32_OPS_PER_S)
    elif fn == "probe_join":
        found, steps, table = _probe_brute(case[0], case[2])
        want = (8 * n + 8 * found + table, 4 * steps, smoke.INT32_OPS_PER_S)
    elif fn == "project":
        want = (12 * n, 3 * n, smoke.F32_OPS_PER_S)
    else:
        rate = smoke.F32_OPS_PER_S if case[1].dtype.kind == "f" \
            else smoke.INT32_OPS_PER_S
        want = (8 * n + 4 * case[2], n, rate)
    assert (got["bytes"], got["ops"]) == want[:2]
    assert got["bytes_ms"] == want[0] / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == want[1] / want[2] * 1e3


@pytest.mark.parametrize("fn,case", [
    ("select_scan_packed", cases.select_packed_case(8, 777, 4, "mid")),
    ("select_scan_packed", cases.select_packed_case(9, 333, 16, "none")),
    ("select_scan_packed", cases.select_packed_case(10, 65, 1, "all")),
    ("unpack", cases.unpack_case(11, 777, 2, -5000)),
    ("unpack", cases.unpack_case(12, 33, 16, 0)),
])
def test_opat_need_counts_packed_words_once(fn, case):
    """Words read once (4 bytes each), y read once, the output written
    once; a decoded value costs 2 operations, a compare pair 2, a
    reference add 1."""
    args = cases.tensors(case, "cpu")
    got = smoke.opat_need(fn, args, getattr(ref, fn)(*args))
    words = case[0]
    if fn == "select_scan_packed":
        _, y, lo, hi, phys = case
        x = storage.unpack_words(words, len(y), phys)
        count = sum(lo <= v <= hi for v in x.tolist())
        want = (4 * len(words) + 4 * len(y) + 4 * count, 4 * len(y))
    else:
        _, n, phys, _ = case
        want = (4 * (-(-n // (32 // phys))) + 4 * n, 3 * n)
    assert (got["bytes"], got["ops"]) == want
    assert got["bytes_ms"] == want[0] / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == want[1] / smoke.INT32_OPS_PER_S * 1e3


@pytest.mark.parametrize("fn,case", [
    ("histogram", cases.radix_case(13, 5000, 8, 4, "negative", 1)),
    ("histogram", cases.radix_case(14, 37, 0, 8, "one_bucket", 1)),
    ("partition_multi", cases.radix_case(15, 4097, 0, 8, "uniform", 3)),
    ("partition_multi", cases.radix_case(16, 100, 28, 7, "duplicates", 1)),
])
def test_radix_need_counts_each_column_once(fn, case):
    """histogram: keys read once and the (tiles, 2^r) counts written;
    partition_multi: the key and every payload read and written once and
    the histogram read; 3 operations a row either way."""
    keys, vals, start_bit, r = cases.tensors(case, "cpu")
    n, counts = len(case[0]), 4 * -(-len(case[0]) // 2048) * (1 << r)
    if fn == "histogram":
        args = (keys, start_bit, r)
        want = 4 * n + counts
    else:
        args = (keys, vals, start_bit, r)
        want = (1 + len(vals)) * 8 * n + counts
    got = smoke.opat_need(fn, args, getattr(ref, fn)(*args))
    assert (got["bytes"], got["ops"]) == (want, 3 * n)
    assert got["bytes_ms"] == want / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == 3 * n / smoke.INT32_OPS_PER_S * 1e3


@pytest.mark.parametrize("kind", ["hot", "dead", "duplicates",
                                  "empty_table"])
@pytest.mark.parametrize("bits", [1, 4])
def test_part_probe_need_walks_each_partition_table(kind, bits):
    """Every row before the runs' end reads its rowid, a live one its key
    and group and walks the chain of its own partition's table: 4
    operations a step, 2 a match, the 64-byte segments visited and hit,
    the offs and counts read, 8 bytes written a match."""
    case = cases.part_probe_case(17, 900, bits, kind)
    args = cases.tensors(case, "cpu")
    got = smoke.opat_need("part_probe", args, ref.part_probe(*args))
    keys, rowids, _, offs, counts, htk, _, _ = case
    n_parts, n_slots = htk.shape
    seg = smoke.SEGMENT // 4
    end = int(offs[-1]) + int(counts[-1])
    moved, steps, found = 4 * end, 0, 0
    visited, hits = set(), set()
    for key, rowid in zip(keys[:end].tolist(), rowids[:end].tolist()):
        if rowid < 0:
            continue
        moved += 8
        p = key & (n_parts - 1)
        slot = ((key & 0xFFFFFFFF) * 2654435761) & (n_slots - 1)
        for _ in range(n_slots):
            visited.add(p * n_slots + slot)
            steps += 1
            if htk[p, slot] == key:
                found += 1
                hits.add(p * n_slots + slot)
                break
            if htk[p, slot] == -2 ** 31:
                break
            slot = (slot + 1) & (n_slots - 1)
    moved += smoke.SEGMENT * (len({s // seg for s in visited}) +
                              len({s // seg for s in hits}))
    moved += 8 * n_parts + 8 * found
    assert (got["bytes"], got["ops"]) == (moved, 4 * steps + 2 * found)
    assert got["ops_ms"] == (4 * steps + 2 * found) / \
        smoke.INT32_OPS_PER_S * 1e3


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::part_probe_sweep<8>((anonymous namespace)"
     "::PartProbe, unsigned int*, long long*)", "part_probe"),
    ("void (anonymous namespace)::probe_join_sweep<8>((anonymous namespace)"
     "::JoinProbe, unsigned int*, long long*)", "probe_join"),
    ("void (anonymous namespace)::select_sparse_sweep<(anonymous namespace)"
     "::PlainX<int> >((anonymous namespace)::SelectTile<(anonymous "
     "namespace)::PlainX<int> >, unsigned int*, long long*)",
     "select_scan_sparse"),
    ("void (anonymous namespace)::probe_agg_sweep<4, float, double>(int "
     "const*, float const*, long long, int2 const*, unsigned int, double*)",
     "probe_agg"),
    ("void (anonymous namespace)::pair_slots(int const*, int const*, long "
     "long, int2*)", "probe_agg"),
    ("void (anonymous namespace)::select_sweep<(anonymous namespace)::"
     "PlainX<float> >((anonymous namespace)::SelectTile<(anonymous "
     "namespace)::PlainX<float> >, unsigned int*, long long*)",
     "select_scan"),
    ("void (anonymous namespace)::select_packed_sweep<(anonymous namespace)"
     "::PackedX<4> >((anonymous namespace)::SelectTile<(anonymous "
     "namespace)::PackedX<4> >, unsigned int*, long long*)",
     "select_scan_packed"),
    ("void (anonymous namespace)::probe_agg_partials<int, unsigned long "
     "long>(int const*, int const*, long long, int const*, int const*, "
     "unsigned int, unsigned long long*)", "other"),
    ("Memset (Device)", "memset"),
    ("void (anonymous namespace)::radix_histogram(int const*, long long, "
     "int, unsigned int, bool, int*)", "histogram"),
    ("void (anonymous namespace)::radix_sweep<2>(int const*, long long, "
     "int, unsigned int, int const*, unsigned int*, unsigned int*, "
     "(anonymous namespace)::Payload, int*)", "partition_multi"),
    ("void (anonymous namespace)::radix_counts(int const*, long long, int, "
     "int, int, bool, int*)", "digit_counts"),
    ("void (anonymous namespace)::reduce_sum_kernel<float, float4, double, "
     "float>(float const*, long long, int, double*, unsigned int*, float*)",
     "reduce_sum"),
    ("void (anonymous namespace)::reduce_sum_kernel<int, int4, unsigned "
     "long long, int>(int const*, long long, int, unsigned long long*, "
     "unsigned int*, int*)", "reduce_sum"),
])
def test_device_kinds_file_each_kernel_under_its_wrapper(name, kind):
    """The profile files the partitioned probe under ``part_probe``, not
    under the ``probe_join`` its name also resembles."""
    assert smoke.device_kind(name) == kind


def test_device_kinds_name_the_select_sweep_alone():
    """The select scans are one sweep kernel each: the profile names no
    count or scatter kernel of the three-launch design before it, and
    its tile scan serves only ``select_scan_sparse``."""
    subs = [sub for sub, _ in smoke.DEVICE_KINDS]
    assert not {"select_count", "select_scatter"} & set(subs)
    assert dict(smoke.DEVICE_KINDS)["select_sweep"] == "select_scan"
    assert dict(smoke.DEVICE_KINDS)["select_packed_sweep"] == \
        "select_scan_packed"
    assert set(smoke.SWEEPS) >= {"select_scan", "select_scan_packed"}


def _agg_brute(keys, htk, l2_bytes) -> dict:
    """probe_agg's need, row by row: each key's walk from its home slot
    (4 operations a step, 2 a hit), the 64-byte segments of 16 slots it
    visits and hits, 8 bytes a row of keys and vals, the 4-byte result,
    and past the L2 the segments only at the share the L2 can hold and a
    32-byte sector a row at the share it cannot."""
    mask, seg = len(htk) - 1, smoke.SEGMENT // 4
    visited, hits, ops = set(), set(), 0
    for key in keys.tolist():
        slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
        for _ in range(len(htk)):
            visited.add(slot // seg)
            ops += 4
            if htk[slot] == key:
                hits.add(slot // seg)
                ops += 2
                break
            if htk[slot] == -2 ** 31:
                break
            slot = (slot + 1) & mask
    table = 8 * len(htk)
    held = l2_bytes / table if table > l2_bytes else 1
    moved = 8 * len(keys) + 4 + \
        smoke.SEGMENT * (len(visited) + len(hits)) * held
    for _ in keys.tolist():
        if table > l2_bytes:
            moved += smoke.SECTOR * (table - l2_bytes) / table
    return {"bytes": moved, "ops": ops}


@pytest.mark.parametrize("kind", ["duplicate_wrap", "clustered", "full",
                                  "misses"])
@pytest.mark.parametrize("l2_share", [None, 4, 2])
def test_agg_need_counts_each_probe_and_the_share_past_the_l2(kind,
                                                               l2_share):
    """probe_agg's bound: the segments its probes visit and hit while the
    table fits the L2; past it those segments at the share L2 / table
    bytes and a sector a probe at 1 - L2 / table bytes (an L2 of a
    quarter and a half of the table: shares whose sums are exact)."""
    keys, _, htk, _ = cases.probe_agg_case(31, 501, kind)
    table = 8 * len(htk)
    l2 = 1 << 40 if l2_share is None else table // l2_share
    got = smoke.agg_need(torch.from_numpy(keys), torch.from_numpy(htk), l2)
    want = _agg_brute(keys, htk, l2)
    assert (got["bytes"], got["ops"]) == (want["bytes"], want["ops"])
    assert got["past_l2_bytes"] == (0.0 if l2_share is None else
                                    501 * smoke.SECTOR * (1 - 1 / l2_share))
    held = 1 if l2_share is None else 1 / l2_share
    assert got["table_read_bytes"] == (
        want["bytes"] - 8 * 501 - 4 - got["past_l2_bytes"])
    assert got["table_read_bytes"] <= held * table
    assert got["bytes_ms"] == want["bytes"] / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == want["ops"] / smoke.INT32_OPS_PER_S * 1e3


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 1025])
@pytest.mark.parametrize("selectivity", [0.0, 1e-3, 0.1, 1.0])
@pytest.mark.parametrize("order", cases.SPARSE_ORDERS)
def test_sparse_need_counts_x_the_matched_segments_and_out_whole(
        n, selectivity, order):
    """select_scan_sparse's bound, row by row: x (4n), each 64-byte
    segment of y (16 rows) that holds a selected row, and out written
    whole (4n)."""
    x, _, lo, hi = cases.sparse_case(n, n, selectivity, order)
    got = smoke.sparse_need(torch.from_numpy(x), lo, hi)
    rows = smoke.SEGMENT // 4
    segments = {r // rows for r in range(n) if lo <= x[r] <= hi}
    want = 4 * n + smoke.SEGMENT * len(segments) + 4 * n
    assert (got["bytes"], got["ops"]) == (want, 2 * n)
    assert (got["y_bytes"], got["count"]) == (
        smoke.SEGMENT * len(segments), sum(lo <= v <= hi for v in x.tolist()))
    assert got["bytes_ms"] == want / smoke.HBM_BYTES_PER_S * 1e3


def _profile(head, kept, launches, kinds):
    return {"device_ms": dict.fromkeys(kinds, 1.0), "kernels": {},
            "busy_ms": 1.0, "wall_ms": 1.0, "busy_share": 1.0,
            "launches": launches, "head": head, "spins_kept": head // 2,
            "kernels_kept": kept}


@pytest.mark.parametrize("lost_tries", [0, 1, 2, 3])
def test_profiled_takes_a_profile_again_after_a_longer_head(monkeypatch,
                                                            lost_tries):
    """A profile that lost a record of the run (fewer kernels than
    launches, none at all, or an expected kind missing) is taken again
    after each longer head; the first whole one is kept with the lost
    ones listed, and a run lost in every try raises."""
    heads = (smoke.PROFILE_HEAD, *smoke.PROFILE_RETRY_HEADS)
    bad = [(0, 1, []), (1, 2, ["spja"]), (2, 2, ["torch zeros"])]
    calls = []

    def once(run, head):
        run()
        calls.append(head)
        i = len(calls) - 1
        return _profile(head, *(bad[i] if i < lost_tries
                                else (2, 2, ["spja", "torch zeros"])))

    monkeypatch.setattr(smoke, "profile_once", once)
    ran = []
    if lost_tries == len(heads):
        with pytest.raises(AssertionError, match="every try"):
            smoke.profiled(lambda: ran.append(1), ("spja",))
        assert calls == list(heads)
        return
    prof = smoke.profiled(lambda: ran.append(1), ("spja",))
    assert calls == list(heads[:lost_tries + 1]) and len(ran) == len(calls)
    assert prof["head"] == heads[lost_tries]
    assert [x["head"] for x in prof["lost"]] == list(heads[:lost_tries])


@pytest.mark.parametrize("bits", [0, 1, 4])
def test_mean_probe_walks_each_key_from_its_home(bits):
    """The mean walk of a hit: each build key's chain walked slot by slot
    from its home slot in its own partition's table."""
    from repro_torch.sql import hashtable
    rng = np.random.default_rng(bits)
    keys = np.unique(rng.integers(-3000, 3000, 700)).astype(np.int32)
    keys = np.concatenate([keys, keys[:50]])       # duplicates: first wins
    vals = np.arange(len(keys), dtype=np.int32)
    htk = (hashtable.np_build(keys, vals, hashtable.next_pow2(len(keys)))[0]
           if bits == 0 else hashtable.pack_partitions(keys, vals, bits)[0])
    rows = htk.reshape(-1, htk.shape[-1])
    n_slots, walks = rows.shape[1], []
    for row in rows:
        for s, key in enumerate(row.tolist()):
            if key == hashtable.EMPTY:
                continue
            slot, steps = int(hashtable.np_hash(np.array([key]), n_slots)[0]), 1
            while slot != s:
                slot, steps = (slot + 1) % n_slots, steps + 1
            walks.append(steps)
    got = smoke.mean_probe(torch.from_numpy(htk))
    assert got == pytest.approx(float(np.mean(walks)), rel=1e-12)
    assert got >= 1.0


def _wave_brute(c) -> dict:
    """Walk every row as the wave kernel does: a member set per row,
    predicate columns while a live member filters them, join keys while a
    live member uses the join or takes its payload, measures while a live
    member sums them."""
    packed = c.packed or {}
    q_n, n = len(c.q_valid), c.n
    every = (-(1 << 31), (1 << 31) - 1)

    def values(arr, width, r=0):
        if width == 32:
            return arr.tolist()
        return storage.unpack_words(arr, n, width, int(r)).tolist()

    pw = packed.get("pred_widths", (32,) * len(c.pred_cols))
    kw = packed.get("key_widths", (32,) * len(c.join_keys))
    kr = packed.get("key_refs", [0] * len(c.join_keys))
    mw = packed.get("m_widths", (32,) * len(c.measure_cols))
    cols = [values(a, w) for a, w in zip(c.pred_cols, pw)]
    keys = [values(a, w, r) for a, w, r in zip(c.join_keys, kw, kr)]
    real = [q for q in range(q_n) if c.q_valid[q]]
    filt = [{q for q in real if tuple(c.pred_bounds[q, ci]) != every}
            for ci in range(len(cols))]
    need = [{q for q in real if c.join_use[q, j] or c.join_mults[q, j]}
            for j in range(len(keys))]
    users = [{q for q in real if c.measure_sel[q, 0] == m or
              (c.measure_sel[q, 2] and c.measure_sel[q, 1] == m)}
             for m in range(len(c.measure_cols))]
    touched, visited, hits, widths = {}, {}, {}, {}
    ops = steps = 0

    def load(arr, width, r):
        nonlocal ops
        touched.setdefault(id(arr), set()).add(r)
        widths[id(arr)] = width
        ops += 2 if width != 32 else 0

    for r in range(n):
        lv = set(real)
        for ci, col in enumerate(cols):
            if not lv & filt[ci]:
                continue
            load(c.pred_cols[ci], pw[ci], r)
            for q in lv & filt[ci]:
                ops += 2
                lo, hi = c.pred_bounds[q, ci]
                if not lo <= col[r] <= hi:
                    lv.discard(q)
        payload = {}
        for j in range(len(keys)):
            if not lv & need[j]:
                continue
            load(c.join_keys[j], kw[j], r)
            htk, htv = c.join_tables[2 * j], c.join_tables[2 * j + 1]
            mask, key = len(htk) - 1, keys[j][r]
            slot = ((key & 0xFFFFFFFF) * 2654435761) & mask
            payload[j], found = 0, False
            for _ in range(len(htk)):
                visited.setdefault(id(htk), set()).add(slot)
                ops += 4
                steps += 1
                if htk[slot] == key:
                    hits.setdefault(id(htk), set()).add(slot)
                    payload[j], found = int(htv[slot]), True
                    break
                if htk[slot] == -2 ** 31:
                    break
                slot = (slot + 1) & mask
            if not found:
                lv -= {q for q in lv if c.join_use[q, j]}
        for m in range(len(c.measure_cols)):
            if lv & users[m]:
                load(c.measure_cols[m], mw[m], r)
        for q in lv:
            own = [j for j in range(len(keys)) if c.join_mults[q, j]]
            ops += 2 * len(own)
            g = sum(payload.get(j, 0) * int(c.join_mults[q, j]) for j in own)
            ops += 2 if (g & 0xFFFFFFFF) < c.n_groups else 0
    seg = smoke.SEGMENT // 4
    fact = sum(smoke.SEGMENT * len({r // (seg * (32 // widths[k]))
                                    for r in rows})
               for k, rows in touched.items())
    table = smoke.SEGMENT * sum(len({s // seg for s in v})
                                for v in (*visited.values(),
                                          *hits.values()))
    return {"fact_bytes": fact, "table_bytes": table,
            "bytes": fact + table + 4 * q_n * c.n_groups, "ops": ops,
            "steps": steps}


@pytest.mark.parametrize("kw", [
    dict(n=400, n_members=4, n_preds=2, n_joins=3, n_groups=40, pad=2,
         duplicates=True, wrap=True, shared_table=True, build_rows=40),
    dict(n=333, n_members=3, n_preds=3, n_joins=2, n_groups=1,
         empty_join=True, build_rows=30),
    dict(n=517, n_members=5, n_preds=2, n_joins=3, n_groups=30, pad=1,
         packed=True, pred_phys=4, build_rows=50),
])
def test_wave_need_counts_what_the_wave_kernel_touches(kw):
    c = cases.multi_spja_case(500, **kw)
    args, akw = c.args("cpu")
    got = smoke.wave_need(args, **akw)
    want = _wave_brute(c)
    assert {k: got[k] for k in want} == want
    assert got["bytes_ms"] == want["bytes"] / smoke.HBM_BYTES_PER_S * 1e3
    assert got["ops_ms"] == want["ops"] / smoke.INT32_OPS_PER_S * 1e3


def _probes_brute(c, groups) -> int:
    """Rows probed a group, row by row: a group is probed while a live
    member uses or takes one of its streams, then the members that use a
    stream that missed die."""
    real = [q for q in range(len(c.q_valid)) if c.q_valid[q]]
    every = (-(1 << 31), (1 << 31) - 1)
    probes = 0
    for r in range(c.n):
        lv = {q for q in real if all(
            tuple(c.pred_bounds[q, ci]) == every or
            c.pred_bounds[q, ci, 0] <= col[r] <= c.pred_bounds[q, ci, 1]
            for ci, col in enumerate(c.pred_cols))}
        for streams in groups:
            if not any(c.join_use[q, j] or c.join_mults[q, j]
                       for q in lv for j in streams):
                continue
            probes += 1
            for j in streams:
                htk, htv = c.join_tables[2 * j], c.join_tables[2 * j + 1]
                _, found = hashtable.np_lookup(
                    htk, htv, np.array([c.join_keys[j][r]], np.int32))
                if not found[0]:
                    lv -= {q for q in lv if c.join_use[q, j]}
    return probes


@pytest.mark.parametrize("merge", [1, 2, 3])
def test_wave_probes_counts_one_probe_a_group_a_row(merge):
    c = cases.multi_spja_case(501, 300, 4, 2, 6, 40, pad=1, merge=merge,
                              duplicates=True, build_rows=40)
    args, akw = c.args("cpu", merged=True)
    groups = [s for s, _ in akw["probe_groups"]]
    assert smoke.wave_probes(args, **akw) == _probes_brute(c, groups)
    plain = {k: v for k, v in akw.items() if k != "probe_groups"}
    assert smoke.wave_probes(args, **plain) == \
        _probes_brute(c, [(j,) for j in range(6)])
