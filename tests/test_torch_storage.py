"""The port's compressed storage on the CPU against the reference package:
the packed word layout, its decode, the plain versions of the three packed
kernels, and the 13 SSB queries on a packed database.

Same inputs in both (made with numpy from a seed).  Tolerances:

* the layout (``pack_words``, ``ColumnEncoding``, ``pack_database``,
  ``generate_packed``), every decode and ``ref.unpack`` /
  ``ref.select_scan_packed``: bit-identical (on ``[:count]`` against the
  reference's interpret-mode Pallas kernel, whose padded tail is
  arbitrary);
* ``ref.spja`` on packed streams against the reference's interpret-mode
  kernel: bit-identical where every f32 sum of the reference stays below
  2^24 (``first``/``sub`` cases), else ``tests/test_ssb.py``'s rtol 1e-5 /
  atol 1e-3 (``mul``: the reference's f32 sums round);
* the 13 queries: bit-identical to the port's plain results and to the
  numpy oracle; within rtol 1e-5 / atol 1e-3 of the reference's packed
  ``compile_plan(...).execute(mode="ref")``, which sums in f32.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as RCOM
from repro.kernels import ops as ROPS
from repro.sql import compile as RC
from repro.sql import engine as RE
from repro.sql import hashtable as RHT
from repro.sql import ssb as RSSB
from repro.sql import storage as RST
from repro_torch import cases
from repro_torch.kernels import common as TCOM
from repro_torch.kernels import ops, ref as TREF
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import hashtable as THT
from repro_torch.sql import plan as TP
from repro_torch.sql import ssb as TSSB
from repro_torch.sql import storage as TST

WIDTHS = list(range(1, 33))
REF_DB = RSSB.generate(sf=0.01, seed=3)          # 60k fact rows
DB = TSSB.from_numpy({t: getattr(REF_DB, t).columns for t in TSSB.TABLES},
                     REF_DB.sf)
REF_PDB = RST.pack_database(REF_DB)
PDB = TST.pack_database(DB)
REF_Q = RE.ssb_queries()
PORT_Q = TE.ssb_queries()


def _values(width: int, ref: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    span = min((1 << width) - 1, (1 << 31) - 1 - max(ref, 0))
    if ref < 0:
        span = min(span, (1 << 31) + ref)
    return (rng.integers(0, span + 1, n, dtype=np.int64) + ref).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_words_and_encoding_match_reference(width):
    """Every logical width (so every phys), zero and frame-of-reference."""
    for ref, n in ((0, 257), (-5000, 1001), (1 << 20, 33)):
        vals = _values(width, ref, n, width * 7 + n)
        got = TST.pack_words(vals, width, ref)
        want = RST.pack_words(vals, width, ref)
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(TST.unpack_words(got, n, width, ref),
                                      vals)
        np.testing.assert_array_equal(
            TST.unpack_words(got, n, width, ref),
            RST.unpack_words(want, n, width, ref))
        col, rcol = TST.pack_column(vals), RST.pack_column(vals)
        assert col.encoding.__dict__ == rcol.encoding.__dict__
        assert col.words.tobytes() == rcol.words.tobytes()
        assert col.encoding.nbytes == rcol.encoding.nbytes
        assert col.encoding.bytes_per_row == rcol.encoding.bytes_per_row
        np.testing.assert_array_equal(np.asarray(col), vals)


def test_encoding_rules_match_reference():
    for vmin, vmax, n in ((0, 0, 5), (1, 50, 9), (0, 2554, 3), (-5, 5, 2),
                          (100_000, 100_010, 7), (1, 1 << 16, 4),
                          (-(1 << 30), 1 << 30, 8), (3, 3, 0)):
        assert TST.encoding_from_stats(vmin, vmax, n).__dict__ == \
            RST.encoding_from_stats(vmin, vmax, n).__dict__
    for span in (0, 1, 2, 255, 256, 1 << 20):
        assert TST.bits_for(span) == RST.bits_for(span)
    assert TST.PHYS_WIDTHS == RST.PHYS_WIDTHS
    assert [TST.phys_width(w) for w in WIDTHS] == \
        [RST.phys_width(w) for w in WIDTHS]
    with pytest.raises(ValueError, match="out of range"):
        TST.pack_words(np.array([16], np.int32), width=4)


def test_hypothesis_layout_sweep():
    hyp = pytest.importorskip(
        "hypothesis", reason="hypothesis not installed "
        "(see requirements-dev.txt)")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=150, deadline=None)
    @given(st.integers(1, 32), st.integers(-(1 << 30), 1 << 30),
           st.integers(0, 300), st.integers(0, 2 ** 32 - 1))
    def sweep(width, ref, n, seed):
        vals = _values(width, ref, n, seed)
        hyp.assume(len(vals) == n)
        words = TST.pack_words(vals, width, ref)
        assert words.tobytes() == RST.pack_words(vals, width, ref).tobytes()
        col, rcol = TST.pack_column(vals), RST.pack_column(vals)
        assert col.encoding.__dict__ == rcol.encoding.__dict__
        e = col.encoding
        got = ops.unpack(torch.from_numpy(col.words), n, e.phys, e.ref)
        np.testing.assert_array_equal(got.numpy(), vals)

    sweep()


@pytest.mark.parametrize("table", TSSB.TABLES)
def test_pack_database_words_identical_to_reference(table):
    got, want = getattr(PDB, table), getattr(REF_PDB, table)
    assert got.name == want.name and list(got.columns) == list(want.columns)
    for c in want.columns:
        assert got.encoding(c).__dict__ == want.encoding(c).__dict__, c
        assert got.columns[c].words.tobytes() == \
            want.columns[c].words.tobytes(), c
        np.testing.assert_array_equal(got[c], getattr(DB, table)[c])
    assert got.nbytes == want.nbytes and got.plain_nbytes == want.plain_nbytes


@pytest.mark.parametrize("sf,seed,chunk", [(0.002, 5, 1000), (0.01, 3, 4096)])
def test_generate_packed_equals_packed_generate(sf, seed, chunk):
    got = TSSB.generate_packed(sf=sf, seed=seed, chunk_rows=chunk)
    want = TST.pack_database(TSSB.generate(sf=sf, seed=seed))
    ref = RSSB.generate_packed(sf=sf, seed=seed, chunk_rows=chunk)
    for t in TSSB.TABLES:
        g, w, r = getattr(got, t), getattr(want, t), getattr(ref, t)
        for c in w.columns:
            assert g.encoding(c) == w.encoding(c), (t, c)
            assert g.encoding(c).__dict__ == r.encoding(c).__dict__
            assert g.columns[c].words.tobytes() == \
                w.columns[c].words.tobytes() == \
                r.columns[c].words.tobytes(), (t, c)


# ---------------------------------------------------------------------------
# decode: common, take, bounds, slices, samples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phys", [1, 2, 4, 8, 16, 32])
def test_decode_and_gather_match_reference(phys):
    """Words with the sign bit set in their top lane included (torch
    shifts int32 arithmetically, the reference logically)."""
    for ref in (0, -77, 1 << 20):
        vals = cases.packed_values(np.random.default_rng(phys), 999,
                                   min(phys, 31), ref) \
            if phys < 32 else _values(31, 0, 999, 1)
        words = RST.pack_words(vals, phys if phys < 32 else 31, ref)
        if phys < 32:
            assert (words < 0).any()            # a sign bit is set
        tw, jw = torch.from_numpy(words), jnp.asarray(words)
        np.testing.assert_array_equal(
            TCOM.decode_words(tw, phys, ref).numpy(),
            np.asarray(RCOM.decode_words(jw, phys, ref)))
        idx = np.random.default_rng(ref & 0xFF).integers(0, 999, 300)
        got = TCOM.gather_decode(tw, torch.from_numpy(idx.astype(np.int32)),
                                 phys, ref)
        want = RCOM.gather_decode(jw, jnp.asarray(idx, jnp.int32), phys, ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if phys < 32:
            np.testing.assert_array_equal(got.numpy(), vals[idx])
    assert TCOM.DEFAULT_TILE == RCOM.DEFAULT_TILE
    for tile, phys in ((2048, 4), (2048, 32), (64, 16)):
        assert TCOM.words_per_block(tile, phys) == \
            RCOM.words_per_block(tile, phys)
    with pytest.raises(ValueError, match="not divisible"):
        TCOM.words_per_block(30, 2)
    x = torch.arange(5, dtype=torch.int32)
    np.testing.assert_array_equal(
        TCOM.pad_to_tile(x, 4, -1).numpy(),
        np.asarray(RCOM.pad_to_tile(jnp.arange(5, dtype=jnp.int32), 4, -1)))


def test_take_bounds_and_bytes_match_reference():
    rowids = np.sort(np.random.default_rng(1).choice(
        PDB.lineorder.n_rows, 5000, replace=False)).astype(np.int32)
    for c in PDB.lineorder.columns:
        got = TST.take(PDB.lineorder, c, torch.from_numpy(rowids), "cpu")
        want = RST.take(REF_PDB.lineorder, c, jnp.asarray(rowids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), c)
        np.testing.assert_array_equal(
            TST.take(DB.lineorder, c, torch.from_numpy(rowids), "cpu"),
            got.numpy())
        assert TST.scan_bytes_per_row(PDB.lineorder, c) == \
            RST.scan_bytes_per_row(REF_PDB.lineorder, c)
        assert TST.scan_bytes_per_row(DB.lineorder, c) == 4.0
    enc = TST.ColumnEncoding("for", 10, 16, 1000, 5)
    renc = RST.ColumnEncoding("for", 10, 16, 1000, 5)
    for lo, hi in ((1000, 1005), (-(1 << 31), 1 << 30), (0, (1 << 31) - 1)):
        assert TST.encoded_bounds(enc, lo, hi) == \
            RST.encoded_bounds(renc, lo, hi)
    assert TST.encoded_bounds(None, 3, 9) == (3, 9)


@pytest.mark.parametrize("lo,hi", [(0, 60_000), (64, 1000), (33, 1030),
                                   (59_999, 60_000)])
def test_slice_rows_and_sample_column_match_reference(lo, hi):
    got = TST.slice_rows(PDB.lineorder, lo, hi)
    want = RST.slice_rows(REF_PDB.lineorder, lo, hi)
    plain = TST.slice_rows(DB.lineorder, lo, hi)
    assert got.n_rows == want.n_rows == plain.n_rows == hi - lo
    for c in want.columns:
        assert got.encoding(c).__dict__ == want.encoding(c).__dict__
        assert got.columns[c].words.tobytes() == \
            want.columns[c].words.tobytes()
        np.testing.assert_array_equal(got[c], DB.lineorder[c][lo:hi])
        np.testing.assert_array_equal(plain[c], got[c])
    for stride in (1, 7, 64):
        for c in ("lo_discount", "lo_partkey"):
            np.testing.assert_array_equal(
                TST.sample_column(PDB.lineorder, c, stride),
                RST.sample_column(REF_PDB.lineorder, c, stride))
            np.testing.assert_array_equal(
                TST.sample_column(DB.lineorder, c, stride),
                DB.lineorder[c][::stride])


def test_decode_memo_and_release():
    # one row past the budget, at 1 bit a row: decoded on demand, no pin
    big = TST.pack_column(np.arange(TST.DECODE_MEMO_LIMIT // 4 + 1,
                                    dtype=np.int32) & 1)
    assert big.encoding.width == 1
    assert big.decode() is not big.decode()
    col = TST.pack_column(np.arange(1000, dtype=np.int32))
    assert col.decode() is col.decode()
    np.testing.assert_array_equal(col.decode_range(100, 900),
                                  np.arange(100, 900))
    col.on_device("cpu")
    col.release(device=True)
    assert col._decoded is None and not col._resident


def test_packed_table_residency_and_database_to():
    db = TST.pack_database(TSSB.generate(sf=0.002, seed=1))
    assert db.to("cpu") is db
    t = db.lineorder
    assert t.resident_bytes("cpu") == t.nbytes
    assert t.on_device("lo_discount", "cpu") is \
        t.on_device("lo_discount", "cpu")
    assert t.nbytes < t.plain_nbytes / 2


# ---------------------------------------------------------------------------
# the plain versions of the packed kernels vs the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
def test_unpack_matches_reference(phys):
    for n, ref in ((37, 0), (4099, -5000), (1000, 1 << 20)):
        words, n, phys, ref = cases.unpack_case(n + phys, n, phys, ref)
        got = TREF.unpack(torch.from_numpy(words), n, phys, ref).numpy()
        kernel = ROPS.unpack(jnp.asarray(words), n, phys, ref, mode="kernel")
        np.testing.assert_array_equal(got, np.asarray(kernel))
        np.testing.assert_array_equal(
            got, RST.unpack_words(words, n, phys, ref))
        np.testing.assert_array_equal(
            ops.unpack(torch.from_numpy(words), n, phys, ref).numpy(), got)


@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("sel", ["mid", "none", "all"])
def test_select_scan_packed_matches_reference(phys, sel):
    n = 4099
    words, y, lo, hi, _ = case = cases.select_packed_case(n + phys, n, phys,
                                                          sel)
    out, cnt = TREF.select_scan_packed(*cases.tensors(case, "cpu"))
    assert out.shape == (n,) and cnt.dim() == 0
    cnt = int(cnt)
    assert cnt == {"none": 0, "all": n}.get(sel, cnt) and (
        0 < cnt < n or sel != "mid")
    k_out, k_cnt = ROPS.select_scan_packed(jnp.asarray(words), jnp.asarray(y),
                                           lo, hi, phys, mode="kernel")
    assert int(k_cnt) == cnt
    np.testing.assert_array_equal(out.numpy()[:cnt], np.asarray(k_out)[:cnt])
    assert not out.numpy()[cnt:].any()
    got2, cnt2 = ops.select_scan_packed(*cases.tensors(case, "cpu"))
    assert torch.equal(got2, out) and int(cnt2) == cnt


@pytest.mark.parametrize("phys", cases.PACKED_WIDTHS)
@pytest.mark.parametrize("op", ["first", "sub", "mul"])
def test_spja_packed_matches_reference(phys, op):
    """Packed predicates at every width, frame-of-reference keys and
    measures."""
    c = cases.packed_spja_case(40 + phys, 4099, 2, 2, op, 30,
                               pred_phys=phys, m_offset=1000, small=True,
                               duplicates=True)
    assert c.packed["m_refs"][0] > 0 and min(c.packed["key_refs"]) < 0
    args, kw = c.args("cpu")
    got = TREF.spja(*args, **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (30,) and got.any()
    j = c.packed

    def jn(a):
        return jnp.asarray(np.asarray(a))

    want = ROPS.spja(
        [jn(a) for a in c.pred_cols], jn(c.pred_bounds),
        [jn(a) for a in c.join_keys], [jn(a) for a in c.join_tables],
        jn(c.group_mults), jn(c.m1), None if c.m2 is None else jn(c.m2),
        measure_op=op, n_groups=30, mode="kernel",
        pred_widths=j["pred_widths"], key_widths=j["key_widths"],
        key_refs=jn(j["key_refs"]), m_widths=j["m_widths"],
        m_refs=jn(j["m_refs"]), n_rows=j["n_rows"])
    if op == "mul":                 # the reference's f32 sums round
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-3)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
    assert torch.equal(ops.spja(*args, **kw), torch.from_numpy(got))


@pytest.mark.parametrize("fn,case", [
    ("select_scan_packed", cases.select_packed_case(1, 64, 2)),
    ("unpack", cases.unpack_case(1, 64, 16, -3)),
])
def test_packed_ops_modes_on_cpu_tensors(fn, case):
    """``auto`` and ``ref`` run the plain version on CPU tensors;
    ``kernel`` raises (a CUDA kernel has no CPU form); phys 32 takes the
    plain-column route."""
    args = cases.tensors(case, "cpu")
    want = getattr(TREF, fn)(*args)
    for mode in ("auto", "ref"):
        got = getattr(ops, fn)(*args, mode=mode)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        getattr(ops, fn)(*args, mode="kernel")
    x = torch.arange(-5, 60, dtype=torch.int32)
    assert torch.equal(ops.unpack(x, 50, 32, 7), x[:50] + 7)
    out, cnt = ops.select_scan_packed(x, x, 3, 9, 32)
    want_out, want_cnt = TREF.select_scan(x, x, 3, 9)
    assert torch.equal(out, want_out) and int(cnt) == int(want_cnt) == 7


def test_spja_packed_equals_spja_on_the_decoded_streams():
    c = cases.packed_spja_case(9, 3001, 3, 3, "sub", 200, pred_phys=2,
                               wrap=True, duplicates=True)
    args, kw = c.args("cpu")
    packed = TREF.spja(*args, **kw)
    j = c.packed
    n = j["n_rows"]
    dec = ([TREF.decode_stream(a, w, 0, n) for a, w in
            zip(args[0], j["pred_widths"])], args[1],
           [TREF.decode_stream(a, w, r, n) for a, w, r in
            zip(args[2], j["key_widths"], j["key_refs"])], args[3], args[4],
           *[TREF.decode_stream(a, w, r, n) for a, w, r in
             zip(args[5:], j["m_widths"], j["m_refs"])])
    plain = TREF.spja(*dec, measure_op="sub", n_groups=200)
    assert torch.equal(packed, plain) and bool(plain.any())
    with pytest.raises(ValueError, match="n_rows is required"):
        TREF.spja(*args, measure_op="sub", n_groups=200,
                  m_widths=j["m_widths"])
    with pytest.raises(ValueError, match="widths"):
        TREF.spja(*args, measure_op="sub", n_groups=200, pred_widths=(3,),
                  n_rows=n)


# ---------------------------------------------------------------------------
# the 13 queries on a packed database
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_packed(name: str) -> np.ndarray:
    """The reference's packed result (its strategies agree bit for bit on
    a packed database, tests/test_storage.py)."""
    return RC.compile_plan(REF_Q[name], "fused").execute(REF_PDB, mode="ref")


@pytest.mark.parametrize("strategy", ["fused", "opat"])
@pytest.mark.parametrize("name", list(REF_Q))
def test_packed_query_matches_plain_oracle_and_reference(name, strategy):
    plan = PORT_Q[name]
    got = TC.compile_plan(plan, strategy).execute(PDB, device="cpu")
    assert got.dtype == np.float32 and got.shape == (plan.n_groups,)
    oracle = TE.run_query_oracle(DB, plan)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, TE.run_query_oracle(PDB, plan))
    np.testing.assert_array_equal(
        got, TC.compile_plan(plan, strategy).execute(DB, device="cpu"))
    np.testing.assert_allclose(got, _reference_packed(name), rtol=1e-5,
                               atol=1e-3)


def test_fused_inputs_carry_the_packed_streams():
    args, kw = TC.fused_inputs(PORT_Q["q1.1"], PDB, None, torch.device("cpu"))
    enc = PDB.lineorder.encoding
    assert kw["pred_widths"] == tuple(enc(c).phys
                                      for c, _, _ in PORT_Q["q1.1"].preds)
    assert kw["n_rows"] == PDB.lineorder.n_rows
    assert args[5].shape[0] == -(-kw["n_rows"] // (32 // kw["m_widths"][0]))
    _, plain_kw = TC.fused_inputs(PORT_Q["q1.1"], DB, None,
                                  torch.device("cpu"))
    assert set(plain_kw["pred_widths"]) == {32}


def test_opat_leading_packed_filter_selects_off_the_words(monkeypatch):
    """While the row ids are the identity, the first range filter on a
    packed column runs ``select_scan_packed``; later filters gather."""
    calls = []
    real = ops.select_scan_packed

    def spy(*a, **k):
        calls.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(ops, "select_scan_packed", spy)
    for name, plan in PORT_Q.items():
        calls.clear()
        TC.compile_plan(plan, "opat").execute(PDB, device="cpu")
        leading = bool(plan.filters) and \
            isinstance(plan.chain[1], TP.Filter)
        assert len(calls) == int(leading), name
        if leading:
            assert calls == [PDB.lineorder.encoding(
                plan.chain[1].preds[0].col).phys], name


def test_for_encoded_fact_key_joins_fused_and_opat():
    """A frame-of-reference FK column (an offset key domain): the decode
    adds the reference before the hash lookup."""
    rng = np.random.default_rng(5)
    base, n_dim, n_fact = 1 << 20, 64, 4096
    dim = {"d_key": (np.arange(n_dim) + base).astype(np.int32),
           "d_pay": np.arange(n_dim, dtype=np.int32)}
    lo = {"lo_fk": (rng.integers(0, n_dim, n_fact) + base).astype(np.int32),
          "lo_rev": rng.integers(1, 100, n_fact, dtype=np.int32)}

    class Db:
        pass

    plain, packed = Db(), Db()
    plain.lineorder = TSSB.Table("lineorder", lo)
    packed.lineorder = TST.pack_table(plain.lineorder)
    plain.dim = packed.dim = TSSB.Table("dim", dim)
    assert packed.lineorder.encoding("lo_fk").kind == "for"
    plan = (TP.QueryBuilder("forfk").scan("lineorder")
            .hash_join("lo_fk", "dim", "d_key", payload=TP.ColExpr("d_pay"),
                       mult=1)
            .measure("lo_rev").group_by(n_dim).build())
    want = TE.run_query_oracle(plain, plan)
    assert want.sum() == lo["lo_rev"].sum()
    for strategy in ("fused", "opat"):
        got = TC.compile_plan(plan, strategy).execute(packed, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=strategy)


# ---------------------------------------------------------------------------
# the hash cache across plain and packed databases
# ---------------------------------------------------------------------------


def test_packed_fingerprint_matches_plain_and_serves_hits_only():
    dims = ("supplier", "customer", "part", "date")
    assert THT.db_fingerprint(PDB) == THT.db_fingerprint(DB)
    assert THT.db_fingerprint(PDB, dims) == RHT.db_fingerprint(REF_PDB, dims)
    assert len(THT.db_fingerprint(PDB)) == len(TSSB.TABLES)
    cache = THT.HashTableCache()
    for plan in PORT_Q.values():
        for j in plan.joins:
            cache.get_or_build(DB, j, "cpu")
    misses = cache.misses
    for plan in PORT_Q.values():
        for j in plan.joins:
            got = cache.get_or_build(PDB, j, "cpu")
            want = THT.build_dim_table(PDB, j, "cpu")
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cache.misses == misses and cache.hits > 0


def test_different_packed_databases_do_not_fingerprint_equal():
    other = TST.pack_database(TSSB.generate(sf=0.01, seed=4))
    dims = ("supplier", "customer", "part", "date")
    assert THT.db_fingerprint(other, dims) != THT.db_fingerprint(PDB, dims)
    cache = THT.HashTableCache()
    join = PORT_Q["q3.1"].joins[0]
    cache.get_or_build(PDB, join, "cpu")
    with pytest.raises(ValueError, match="scoped to one Database"):
        cache.get_or_build(other, join, "cpu")
