"""The wave kernel's merged probe groups on the CPU: one probe a fact key
column for every build side that column probes against one dimension key.

* ``hashtable.build_merged``: a lookup through the merged table (the
  stream's mask bit, then its payload matrix row) equals the lookup
  through the stream's own table, for every stream of the 13-query wave,
  of each ``chip_smoke.WAVES`` wave and of an anchored pool, and on
  hypothesis-drawn build sides (duplicate and negative keys, an empty
  build side, a one-key table, the key EMPTY itself);
* ``compile.probe_groups``: the 13-query wave lowers to 4 groups, one per
  fact key column, in an order that no member subset of the pool changes;
* ``ref.multi_spja`` on the merged lowering: bit-identical to one probe a
  stream and to the numpy oracle, within ``tests/test_ssb.py``'s rtol
  1e-5 / atol 1e-3 of the reference's ``execute_shared(mode="ref")``
  (which sums in f32), up to 64 members;
* malformed probe groups and words are refused.

SF 0.005 (30k fact rows), as ``tests/test_torch_shared.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import ssb as RSSB
from repro_torch import cases
from repro_torch.core.blocks import EMPTY
from repro_torch.kernels import multi_fused, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import hashtable as THT
from repro_torch.sql import ssb as TSSB

REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
PORT_Q = TE.ssb_queries()
REF_Q = RE.ssb_queries()
TOL = dict(rtol=1e-5, atol=1e-3)
# chip_smoke.WAVES (the smoke imports jax-free modules only; its table is
# repeated here so this file does not import the smoke)
WAVES = {"all13": None, "flight1": ("q1.1", "q1.2", "q1.3"),
         "flight2": ("q2.1", "q2.2", "q2.3"),
         "flights2_4": ("q2.1", "q2.2", "q2.3", "q4.1", "q4.2", "q4.3")}


def _merged_lookups(slots, pay, keys):
    """(payload, found) per stream of a merged table, in numpy: the key's
    slot by the plain probe, then the stream's bit and payload row."""
    slot_of = np.arange(len(slots), dtype=np.int32)
    slot, found = THT.np_lookup(slots[:, 0], slot_of, keys)
    mask = np.where(found, slots[slot, 1], 0).view(np.uint32)
    entry = np.where(found, slots[slot, 2], 0)
    out = []
    for s in range(pay.shape[0]):
        hit = ((mask >> np.uint32(s)) & 1).astype(bool)
        out.append((np.where(hit, pay[s][entry], 0), hit))
    return out


def _check_group(tables, keys):
    slots, pay = THT.build_merged(tables)
    assert slots.dtype == pay.dtype == np.int32 and slots.shape[1] == 4
    n_keys = int((slots[:, 0] != EMPTY).sum())
    assert len(slots) == THT.next_pow2(max(n_keys, 1))
    for (htk, htv), (got_p, got_f) in zip(tables,
                                          _merged_lookups(slots, pay, keys)):
        want_p, want_f = THT.np_lookup(htk, htv, keys)
        np.testing.assert_array_equal(got_f, want_f)
        np.testing.assert_array_equal(got_p, np.where(want_f, want_p, 0))


def _probe_keys(db, join, rng):
    """Every fact key of the join's column, the dimension's keys and keys
    no table holds (negative and past the dimension), and EMPTY."""
    fact = np.asarray(db.lineorder[join.fact_col])
    dim = np.asarray(getattr(db, join.dim)[join.key_col])
    extra = rng.integers(-1000, int(dim.max()) + 1000, 500, dtype=np.int64)
    return np.concatenate([fact, dim, extra.astype(np.int32),
                           np.array([EMPTY], np.int32)]).astype(np.int32)


def _wave_plans(wave):
    names = WAVES[wave]
    return [PORT_Q[q] for q in (names or PORT_Q)]


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("wave", list(WAVES))
def test_merged_lookup_equals_each_streams_own_table(wave, anchored):
    plans = _wave_plans(wave)
    pool = list(PORT_Q.values()) if anchored else None
    cache = THT.HashTableCache()
    _, args, kw, _ = TC.shared_params(
        plans, DB, cache=cache, device="cpu",
        anchor=TC.anchor_for(plans, pool) if anchored else None)
    _, joins, _ = TC._wave_streams(
        plans + (TC.anchor_for(plans, pool) or []), anchored)
    rng = np.random.default_rng(5)
    seen = []
    for streams, merged in kw["probe_groups"]:
        seen += streams
        if merged is None:
            continue
        tables = [(args[3][2 * j].numpy(), args[3][2 * j + 1].numpy())
                  for j in streams]
        slots, pay = (t.numpy() for t in merged)
        keys = _probe_keys(DB, joins[streams[0]], rng)
        for (htk, htv), (got_p, got_f) in zip(
                tables, _merged_lookups(slots, pay, keys)):
            want_p, want_f = THT.np_lookup(htk, htv, keys)
            np.testing.assert_array_equal(got_f, want_f)
            np.testing.assert_array_equal(got_p,
                                          np.where(want_f, want_p, 0))
    assert sorted(seen) == list(range(len(joins)))


_KEYS = st.lists(st.integers(-(1 << 31), (1 << 31) - 1), max_size=40)


@settings(max_examples=60, deadline=None)
@given(sides=st.lists(st.tuples(_KEYS, st.integers(0, 3)), min_size=1,
                      max_size=6),
       probes=_KEYS, seed=st.integers(0, 1 << 16))
def test_merged_lookup_on_drawn_build_sides(sides, probes, seed):
    """Duplicate keys (the first row wins), negative keys and the key
    EMPTY, an empty build side, one-key tables."""
    rng = np.random.default_rng(seed)
    tables, held = [], []
    for keys, dup in sides:
        keys = np.array(keys, np.int32)
        if dup and len(keys):
            keys = np.concatenate([keys, rng.choice(keys, dup)])
        vals = rng.integers(0, 1000, len(keys), dtype=np.int32)
        tables.append(THT.np_build(keys, vals,
                                   THT.next_pow2(max(len(keys), 1))))
        held.append(keys)
    probe = np.concatenate([np.array(probes, np.int32), *held,
                            np.array([EMPTY, 0, -1], np.int32)])
    _check_group(tables, probe.astype(np.int32))


def test_merged_lookup_of_one_key_and_empty_tables():
    one = THT.np_build(np.array([7], np.int32), np.array([3], np.int32), 16)
    empty = THT.np_build(np.zeros(0, np.int32), np.zeros(0, np.int32), 16)
    keys = np.array([7, 8, -7, EMPTY, 0], np.int32)
    _check_group([one, empty], keys)
    _check_group([empty, empty], keys)
    with pytest.raises(ValueError, match="1..32"):
        THT.build_merged([one] * (THT.MERGE_STREAMS + 1))


def test_13_query_wave_lowers_to_one_group_a_fact_key_column():
    plans = list(PORT_Q.values())
    _, args, kw, _ = TC.shared_params(plans, DB, pad_to=16, device="cpu")
    groups = kw["probe_groups"]
    _, joins, _ = TC.shared_footprint(plans)
    cols = [joins[streams[0]].fact_col for streams, _ in groups]
    assert sorted(cols) == ["lo_custkey", "lo_orderdate", "lo_partkey",
                            "lo_suppkey"]
    assert sum(len(s) for s, _ in groups) == len(joins) == 21
    for streams, merged in groups:
        assert len({(joins[j].fact_col, joins[j].dim, joins[j].key_col)
                     for j in streams}) == 1
        assert (merged is None) == (len(streams) == 1)


@pytest.mark.parametrize("subset", [("q1.2", "q2.1", "q4.3"),
                                    ("q3.1",), ("q1.1", "q4.1", "q4.2"),
                                    tuple(PORT_Q)])
def test_group_order_does_not_depend_on_the_member_subset(subset):
    pool = list(PORT_Q.values())
    plans = [PORT_Q[q] for q in subset]
    _, _, kw, _ = TC.shared_params(plans, DB, device="cpu",
                                   anchor=TC.anchor_for(plans, pool))
    _, _, full, _ = TC.shared_params(pool, DB, device="cpu",
                                     anchor=TC.anchor_for(pool, pool))
    assert [s for s, _ in kw["probe_groups"]] == \
        [s for s, _ in full["probe_groups"]]
    for (_, a), (_, b) in zip(kw["probe_groups"], full["probe_groups"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("wave", list(WAVES))
def test_merged_lowering_matches_plain_oracle_and_reference(wave):
    plans = _wave_plans(wave)
    pad = 16 if WAVES[wave] is None else None
    _, args, kw, n_groups = TC.shared_params(plans, DB, pad_to=pad,
                                             device="cpu")
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("member_groups", "probe_groups")}
    got = TREF.multi_spja(*args, n_groups=n_groups, **plain_kw,
                          probe_groups=kw["probe_groups"])
    assert torch.equal(got, TREF.multi_spja(*args, n_groups=n_groups,
                                            **plain_kw))
    refs = RC.execute_shared([REF_Q[p.name] for p in plans], REF_DB,
                             mode="ref", pad_to=pad)
    for qi, (plan, want) in enumerate(zip(plans, refs)):
        row = got[qi, :plan.n_groups].numpy()
        np.testing.assert_array_equal(row, TE.run_query_oracle(DB, plan),
                                      err_msg=plan.name)
        np.testing.assert_allclose(row, want, **TOL, err_msg=plan.name)


# (n, members, preds, joins, n_groups, padding, extra)
MERGED_CASES = [
    (3000, 5, 2, 6, 50, 2, dict(merge=3)),
    (2500, 13, 3, 8, 700, 3, dict(merge=4, duplicates=True, wrap=True)),
    (1500, 6, 1, 4, 1, 0, dict(merge=2, empty_join=True)),
    (2001, 6, 2, 6, 100, 2, dict(merge=3, packed=True)),
    (2000, 64, 1, 7, 9, 0, dict(merge=7, build_rows=50)),
    (1200, 4, 1, 34, 4, 0, dict(merge=33, build_rows=50, use_p=0.08)),
]


@pytest.mark.parametrize("i", range(len(MERGED_CASES)))
def test_merged_plain_version_on_synthetic_waves(i):
    n, q, c, j, g, pad, extra = MERGED_CASES[i]
    case = cases.multi_spja_case(4100 + i, n, q, c, j, g, pad=pad, **extra)
    args, kw = case.args("cpu", merged=True)
    assert max(len(s) for s, _ in kw["probe_groups"]) > 1
    got = TREF.multi_spja(*args, **kw)
    want = TREF.multi_spja(*case.args("cpu")[0], **case.args("cpu")[1])
    assert torch.equal(got, want)
    assert got[:q].any() and not got[q:].any()


def test_malformed_probe_groups_are_refused():
    case = cases.multi_spja_case(5, 1000, 2, 1, 4, 4, merge=2)
    args, kw = case.args("cpu", merged=True)
    groups = kw["probe_groups"]
    (s0, m0), (s1, m1) = groups
    bad = {
        "do not cover": ((s0, m0),),
        "cover": ((s0, m0), (s1, m1), ((s1[0],), None)),
        "needs a merged": ((s0, None), (s1, m1)),
        "other key streams": (((s0[0], s1[0]), m0), ((s0[1], s1[1]), m1)),
        "merged tables": ((s0, (m0[0][:, :3], m0[1])), (s1, m1)),
        "streams of the": (((s0[0], 9), m0), (s1, m1)),
    }
    for match, pg in bad.items():
        kw2 = dict(kw, probe_groups=pg)
        with pytest.raises(ValueError, match=match):
            TREF.multi_spja(*args, **kw2)


def test_param_words_hold_the_probe_groups_together():
    """The words the launcher validates: groups' streams contiguous and
    covering, a merged group's entries > 0, each pair's bit inside its
    group (``csrc/multi_fused.cu``'s layout)."""
    case = cases.multi_spja_case(6, 1000, 3, 2, 5, 40, merge=2)
    _, kw = case.args("cpu", merged=True)
    bounds, mults, use, valid, sel = TREF.wave_params(
        case.pred_bounds, case.join_mults, case.join_use, case.q_valid,
        case.measure_sel, 2, 5, 3)
    lowered = [(s, (m[0].shape[0] if m else 16) - 1,
                m[1].shape[1] if m else 0) for s, m in kw["probe_groups"]]
    span = multi_fused.spans(case.member_groups, valid, 40, 512)
    words = multi_fused.param_words(
        bounds, mults, use, valid, sel, 40, (32,) * 2, (32,) * 5, [0] * 5,
        (32,) * 3, [0] * 3, lowered, span)
    q, c, g, j = (int(v) for v in words[:4])
    assert (q, c, g, j) == (3, 2, len(lowered), 5)
    at = 10 + 5 * c + 2 * c * q
    first = 0
    for streams, _, entries in lowered:
        gw = words[at:at + 12]
        assert (gw[5], gw[6], gw[7]) == (first, len(streams), entries)
        first += len(streams)
        at += 12
    n_pairs = int(words[7])
    pairs = words[len(words) - 3 * n_pairs:].reshape(-1, 3)
    ks = [len(s) for s, _, _ in lowered]
    assert n_pairs and all(0 <= b < ks[gi] for gi, b, _ in pairs)
    n_ptrs, m = c + 3 * g + 3, 3
    assert multi_fused.smem_bytes(words) == 8 * int(span.sum()) + \
        8 * n_ptrs + 4 * ((words.size + 1) & ~1) + \
        8 * multi_fused.THREADS * g + 4 * multi_fused.THREADS * m


@pytest.mark.parametrize("merge", [1, 2, 3])
def test_wrapper_lowering_fits_one_launch(merge, monkeypatch):
    """The wrapper's lowering (``multi_fused._lower``, run here on CPU
    tensors past its device check): one chunk of words for 16 members,
    one pointer triple a probe group, and a block's shared memory one
    8-byte probe state a group and thread beside the rest, well under a
    block's 227 KB."""
    monkeypatch.setattr(multi_fused, "_kernel_device",
                        lambda cols: torch.device("cpu"))
    case = cases.multi_spja_case(7, 100_003, 13, 3, 6, 7000, pad=3,
                                 merge=merge)
    args, kw = case.args("cpu", merged=True)
    n_groups = kw.pop("n_groups")
    _, n, q, ptrs, chunks = multi_fused._lower(
        *args, n_groups, None, None, None, None, None, None,
        case.member_groups, kw["probe_groups"])
    assert (n, q, len(chunks)) == (100_003, 16, 1)
    words = chunks[0][1]
    g = int(words[2])
    assert g == len(kw["probe_groups"])
    assert len(ptrs) == 3 + 3 * g + 3
    assert 8 * multi_fused.THREADS * g < multi_fused.smem_bytes(words) < \
        64 * 1024
