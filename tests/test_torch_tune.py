"""The port's tuner (``repro_torch.sql.tune``) and its launch records in
``repro_torch.sql.compile``, held to the reference's ``tests/test_tune.py``
and to the reference package itself, on the CPU.

Two halves, as the reference's:

* every family's results are answer-preserving — each kernel family the
  reference sweeps, every digit width ``radix_sort`` takes (r <= 8; the
  reference's 16 has no instance) and every partition depth — against
  the reference's plain versions on the same inputs (bit-identical), and
  each family's launch record names the one shape its kernel is compiled
  with (``compile.LAUNCH_SHAPES``: the port has no ``tile=`` to sweep);
* the store: its file (beside the calibration's, keyed like it), the
  save/load round trip and memo, torn files, width-bucket fallback, the
  tie rule, ``eff_bw`` only at the streaming size, the cold store's
  default launch byte for byte, the tuned store's pickup,
  ``LAUNCH_STATS``, and the feedback into the cost model
  (``apply_hardware``/``tuned_hardware``/``default_hardware``: the
  reference's ``Hardware`` from the same numbers, rtol 1e-9).

``test_lsb_shuffle_digit_invariant`` has no counterpart: the port
partitions by all the bits in one kernel pass and has no host LSD
shuffle (``ops._lsb_partition_multi``) whose pass width could be swept.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.sql import engine as RE
from repro.sql import hashtable as RHT
from repro.sql import model as RM
from repro.sql import ssb as RSSB
from repro.sql import tune as RTN
from repro_torch.cost import model as CM
from repro_torch.kernels import ops
from repro_torch.sql import calibrate as CAL
from repro_torch.sql import compile as C
from repro_torch.sql import engine, ssb
from repro_torch.sql import model as M
from repro_torch.sql import storage as ST
from repro_torch.sql import tune as TN
from repro_torch.sql.hashtable import build_dim_partitions, next_pow2, np_build

CPU = torch.device("cpu")
N = 2048
RNG = np.random.default_rng(11)


def randi(lo, hi, n=N):
    return RNG.integers(lo, hi, n).astype(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# invariance: every swept knob is answer-preserving, per family
# ---------------------------------------------------------------------------


def test_select_scan_matches_reference():
    x, y = randi(0, 1000), np.arange(N, dtype=np.int32)
    out, cnt = ops.select_scan(t(x), t(y), 100, 900, mode="ref")
    rout, rcnt = RR.select_scan(jnp.asarray(x), jnp.asarray(y), 100, 900)
    assert int(cnt) == int(rcnt)
    np.testing.assert_array_equal(out[:int(cnt)].numpy(),
                                  np.asarray(rout)[:int(rcnt)])


def test_select_scan_packed_matches_reference():
    """The same scan off the 16-bit words."""
    vals = randi(0, 1000)
    y = np.arange(N, dtype=np.int32)
    words = ST.pack_words(vals, 16)
    out, cnt = ops.select_scan_packed(t(words), t(y), 100, 900, 16,
                                      mode="ref")
    rout, rcnt = RO.select_scan_packed(jnp.asarray(words), jnp.asarray(y),
                                       100, 900, 16, mode="kernel", tile=512)
    mask = (vals >= 100) & (vals <= 900)
    assert int(cnt) == int(rcnt) == int(mask.sum())
    np.testing.assert_array_equal(out[:int(cnt)].numpy(), np.arange(N)[mask])
    np.testing.assert_array_equal(np.asarray(rout)[:int(rcnt)],
                                  np.arange(N)[mask])


def test_unpack_matches_reference():
    vals = randi(0, 200)                         # an 8-bit domain
    words = ST.pack_words(vals, 8)
    got = ops.unpack(t(words), N, 8, mode="ref")
    np.testing.assert_array_equal(got.numpy(), vals)
    np.testing.assert_array_equal(
        np.asarray(RO.unpack(jnp.asarray(words), N, 8, mode="kernel",
                             tile=512)), vals)


def _join_fixture():
    n_dim = 512
    x, fk, m = randi(0, 1000), randi(0, n_dim), randi(0, 100)
    dimk = np.arange(n_dim, dtype=np.int32)
    dimv = (dimk % 16).astype(np.int32)
    htk, htv = np_build(dimk, dimv, next_pow2(n_dim))
    return x, fk, m, htk, htv


def test_spja_matches_reference():
    x, fk, m, htk, htv = _join_fixture()
    bounds = np.array([[100, 900]], np.int32)
    mults = np.array([1], np.int32)
    got = ops.spja([t(x)], bounds, [t(fk)], [t(htk), t(htv)], mults, t(m),
                   measure_op="first", n_groups=16, mode="ref")
    want = RR.spja([jnp.asarray(x)], jnp.asarray(bounds), [jnp.asarray(fk)],
                   [jnp.asarray(htk), jnp.asarray(htv)], jnp.asarray(mults),
                   jnp.asarray(m).astype(jnp.float32), None,
                   measure_op="first", n_groups=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multi_spja_matches_reference():
    x, fk, m, htk, htv = _join_fixture()
    b = np.array([[[100, 900]], [[200, 800]]], np.int32)   # (Q=2, C=1, 2)
    ones2 = np.ones((2, 1), np.int32)
    valid = np.ones((2,), np.int32)
    msel = np.zeros((2, 3), np.int32)
    got = ops.multi_spja([t(x)], b, [t(fk)], [t(htk), t(htv)], ones2, ones2,
                         valid, [t(m)], msel, n_groups=16, mode="ref")
    want = RR.multi_spja([jnp.asarray(x)], jnp.asarray(b), [jnp.asarray(fk)],
                         [jnp.asarray(htk), jnp.asarray(htv)],
                         jnp.asarray(ones2), jnp.asarray(ones2),
                         jnp.asarray(valid),
                         [jnp.asarray(m).astype(jnp.float32)],
                         jnp.asarray(msel), n_groups=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", (1, 2, 3))
def test_part_probe_bits_invariant(bits):
    """The partitioned join across radix depths: partition-major output,
    so compare the (rowid, group) pairs in rowid order, against the dense
    expectation and the reference's ``part_join``."""
    n_build = 512
    fk = randi(0, n_build)
    dimk = np.arange(n_build, dtype=np.int32)
    dimv = (dimk % 7).astype(np.int32)
    parts = build_dim_partitions(None, None, bits, side=(dimk, dimv),
                                 packed=True, device=CPU)
    outr, outg, cnt = ops.part_join(
        t(fk), torch.arange(N, dtype=torch.int32),
        torch.zeros(N, dtype=torch.int32), parts.htk, parts.htv, 1, bits,
        mode="ref")
    cnt = int(cnt)
    assert cnt == N                             # a dense dim: every key hits
    order = np.argsort(outr[:cnt].numpy(), kind="stable")
    np.testing.assert_array_equal(outr[:cnt].numpy()[order], np.arange(N))
    np.testing.assert_array_equal(outg[:cnt].numpy()[order], dimv[fk])
    rparts = RHT.build_dim_partitions(None, None, bits, side=(dimk, dimv),
                                      packed=True)
    np.testing.assert_array_equal(parts.htk.numpy(), np.asarray(rparts.htk))
    rr, rg, rc = RO.part_join(jnp.asarray(fk), jnp.arange(N, dtype=jnp.int32),
                              jnp.zeros(N, jnp.int32), rparts.htk, rparts.htv,
                              1, bits, mode="ref", digit=2)
    assert int(rc) == cnt
    np.testing.assert_array_equal(outr[:cnt].numpy(), np.asarray(rr)[:cnt])
    np.testing.assert_array_equal(outg[:cnt].numpy(), np.asarray(rg)[:cnt])


@pytest.mark.parametrize("r", [r for r in range(1, 17) if TN.radix_ok(r)])
def test_radix_sort_r_invariant(r):
    """Every digit width the port's sort takes (``radix_ok``: r <= 8 with
    passes x 2^r <= 1024) sorts like the reference's oracle."""
    keys = randi(0, 1 << 30)
    vals = np.arange(N, dtype=np.int32)
    sk, sv = ops.radix_sort(t(keys), t(vals), mode="ref", r=r)
    rk, rv = RR.radix_sort(jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(rv))


def test_radix_widths_offered_are_the_kernels():
    assert [r for r in range(1, 17) if TN.radix_ok(r)] == list(range(1, 9))
    assert TN.DEFAULT_R == RTN.DEFAULT_R
    assert set(TN.FULL_GRID["rs"]) >= {4, 8}
    assert all(TN.radix_ok(r) for r in TN.FULL_GRID["rs"] +
               TN.SMOKE_GRID["rs"])


def test_partition_pass_matches_reference():
    """``partition_multi``'s one pass by all 8 bits, the family with no
    pass width to sweep, against the reference's oracle."""
    keys = randi(0, 1 << 19)
    v1, v2 = np.arange(N, dtype=np.int32), randi(0, 64)
    ok, (o1, o2) = ops.radix_partition_multi(t(keys), (t(v1), t(v2)), 0, 8,
                                             mode="ref")
    rk, (r1, r2) = RR.partition_multi(jnp.asarray(keys),
                                      (jnp.asarray(v1), jnp.asarray(v2)), 0, 8)
    for a, b in ((ok, rk), (o1, r1), (o2, r2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# launch records: one compiled shape a family
# ---------------------------------------------------------------------------

DB_REF = RSSB.generate(sf=0.002, seed=5)
DB = ssb.from_numpy({n: getattr(DB_REF, n).columns for n in ssb.TABLES},
                    DB_REF.sf)
QUERIES = engine.ssb_queries()
REF_QUERIES = RE.ssb_queries()


def test_launch_shapes_are_the_compiled_kernels():
    from repro_torch.kernels import multi_fused, ssb_fused
    assert C.LAUNCH_SHAPES["spja"] == ssb_fused.THREADS == 1024
    assert C.LAUNCH_SHAPES["multi_spja"] == multi_fused.THREADS == 256
    assert set(C.LAUNCH_SHAPES) == {"spja", "multi_spja", "select_scan",
                                    "part_probe", "radix_sort",
                                    "partition_multi"}
    assert set(TN.FAMILIES) <= set(C.LAUNCH_SHAPES)


@pytest.mark.parametrize("strategy,family", [("fused", "spja"),
                                             ("shared", "multi_spja"),
                                             ("part", "part_probe"),
                                             ("part_loop",
                                              "partition_multi")])
def test_launch_record_names_the_compiled_shape(strategy, family):
    """Each strategy's record names the one shape its family's kernel is
    compiled with, and the run answers as the oracle does; ``execute``
    takes no ``tile``."""
    q = C.compile_plan(QUERIES["q2.1"], strategy)
    got = q.execute(DB, mode="ref", device=CPU)
    assert q.launch_config[family]["threads"] == C.LAUNCH_SHAPES[family]
    assert q.launch_config[family]["width"] == 32
    np.testing.assert_array_equal(
        got, engine.run_query_oracle(DB, QUERIES["q2.1"]))
    with pytest.raises(TypeError):
        q.execute(DB, mode="ref", tile=256, device=CPU)


# ---------------------------------------------------------------------------
# tune store: persistence, recovery, lookup, pick rule
# ---------------------------------------------------------------------------


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """The cache in a private directory, so store tests neither see nor
    leave anything in the session's."""
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path))
    TN._MEMO.clear()
    CAL._MEMO.clear()
    yield str(tmp_path)
    TN._MEMO.clear()
    CAL._MEMO.clear()


def _mk_tunings(**configs):
    return TN.Tunings(backend="cpu", fingerprint=CAL.fingerprint(CPU),
                      measured_at=0.0, configs=configs)


def test_cache_filename_fingerprinted(tune_dir):
    base = os.path.basename(TN.cache_path(CPU))
    assert base.startswith("torch-tunings-cpu-torch")
    assert torch.__version__.split("+")[0] in base
    assert TN.cache_path(CPU) == os.path.join(tune_dir, base)
    # beside the calibration, keyed like it, named apart from the
    # reference's tunings file
    assert os.path.dirname(CAL.cache_path(CPU)) == tune_dir
    assert CAL.fingerprint(CPU) in os.path.basename(CAL.cache_path(CPU))
    assert not base.startswith("tunings-")


def test_store_roundtrip(tune_dir):
    tn = _mk_tunings(**{
        "select_scan/w32": TN.TunedConfig("select_scan", 32, best_us=10.0,
                                          default_us=15.0, eff_bw=2e12),
        "radix_sort/w32": TN.TunedConfig("radix_sort", 32, r=4,
                                         best_us=5.0, default_us=5.0)})
    path = TN.save(tn)
    assert os.path.exists(path) and path == TN.cache_path(CPU)
    TN._MEMO.clear()
    loaded = TN.load_cached(CPU)
    assert loaded is not None
    assert loaded.configs["select_scan/w32"].eff_bw == 2e12
    assert loaded.configs["select_scan/w32"].speedup == pytest.approx(1.5)
    assert loaded.configs["radix_sort/w32"].r == 4
    # the memo: a second load does not read the disk again
    os.remove(path)
    assert TN.load_cached(CPU) is loaded
    # the same JSON as the reference's record of the same numbers, less
    # the reference's tile (the port has no launch shape to record)
    ref = RTN.Tunings(backend="cpu", fingerprint=tn.fingerprint,
                      measured_at=0.0, configs={
                          k: RTN.TunedConfig(**dataclasses.asdict(v))
                          for k, v in tn.configs.items()}).to_json()
    for c in ref["configs"].values():
        del c["tile"]
    assert json.dumps(ref, sort_keys=True) == \
        json.dumps(tn.to_json(), sort_keys=True)
    # a file the reference's schema wrote (with a tile) still loads
    with open(path, "w") as f:
        json.dump(RTN.Tunings(backend="cpu", fingerprint=tn.fingerprint,
                              measured_at=0.0, configs={
                                  "radix_sort/w32": RTN.TunedConfig(
                                      "radix_sort", 32, tile=512, r=4)}
                              ).to_json(), f)
    TN._MEMO.clear()
    assert TN.load_cached(CPU).configs["radix_sort/w32"].r == 4


def test_torn_file_recovery(tune_dir):
    path = TN.cache_path(CPU)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write('{"backend": "cpu", "configs": {"x"')     # torn write
    TN._MEMO.clear()
    assert TN.load_cached(CPU) is None
    assert not os.path.exists(path)         # removed for a later retune
    assert TN.load_cached(CPU) is None      # absence is memoized too
    with open(path, "w") as f:              # schema drift
        json.dump({"backend": "cpu", "configs": {"radix_sort/w32": 7}}, f)
    TN._MEMO.clear()
    assert TN.load_cached(CPU) is None
    assert not os.path.exists(path)


def test_width_bucket_fallback(tune_dir):
    st = TN.TuneStore(_mk_tunings(**{
        "select_scan/w32": TN.TunedConfig("select_scan", 32, eff_bw=2e9)}))
    assert st.get("select_scan", 16).eff_bw == 2e9   # the plain winner
    assert st.eff_read_bw() == 2e9
    assert st.get("part_probe") is None              # unknown: default
    assert st.r() == TN.DEFAULT_R
    assert st.part_budget_bytes() is None
    # a store never makes a launch illegal: a width the kernel does not
    # take reads as the default
    odd = TN.TuneStore(_mk_tunings(**{
        "radix_sort/w32": TN.TunedConfig("radix_sort", 32, r=16)}))
    assert odd.r() == TN.DEFAULT_R


def test_pick_tie_keeps_default():
    dflt = {"r": 8}
    cfg, best, d = TN._pick([({"r": 4}, 0.98), (dflt, 1.0)], dflt)
    assert cfg == dflt and best == d == 1.0
    cfg, best, d = TN._pick([({"r": 4}, 0.5), (dflt, 1.0)], dflt)
    assert cfg == {"r": 4} and best == 0.5 and d == 1.0
    assert TN.TunedConfig("x", 32, best_us=best * 1e6,
                          default_us=d * 1e6).speedup >= 1.0
    # the reference's rule on the same times
    for timed in ([({"r": 4}, 0.98), (dflt, 1.0)],
                  [({"r": 4}, 0.5), (dflt, 1.0)]):
        assert TN._pick(timed, dflt) == RTN._pick(timed, dflt)
    assert TN.WIN_MARGIN == RTN.WIN_MARGIN


def test_assert_identical_refuses_wrong_answers():
    with pytest.raises(AssertionError, match="never change answers"):
        TN._assert_identical("radix_sort", {"r": 4},
                             (torch.arange(4),), (np.arange(4) + 1,))
    with pytest.raises(AssertionError, match="never change answers"):
        TN._assert_identical("radix_sort", {"r": 4}, (torch.arange(4),),
                             (torch.arange(5),))
    TN._assert_identical("radix_sort", {"r": 4}, (torch.arange(4),),
                         (np.arange(4),))


def test_measure_on_the_cpu_checks_every_family(tune_dir):
    """One sweep at a tiny grid: every family measured, every depth held
    to the same rows; a scan this small is no measure of bandwidth, so it
    records no ``eff_bw``."""
    g = dict(rs=(4, 8), bits=(1, 2), n=1 << 10, n_build=1 << 9,
             n_scan=1 << 10, warmup=0, iters=1)
    tn = TN.measure(grid=g, device=CPU)
    assert {c.family for c in tn.configs.values()} == set(TN.FAMILIES)
    for c in tn.configs.values():
        assert c.best_us > 0
    assert tn.configs["radix_sort/w32"].r in (4, 8)
    pp = tn.configs["part_probe/w32"]
    assert pp.part_bits in (1, 2)
    assert M.part_bits(g["n_build"], dataclasses.replace(
        M.HOST, part_budget_bytes=pp.part_budget_bytes)) == pp.part_bits
    assert tn.configs["select_scan/w32"].eff_bw is None
    assert TN.apply_hardware(TN.TuneStore(tn), M.HOST).read_bw == \
        M.HOST.read_bw
    path = TN.save(tn)
    TN._MEMO.clear()
    assert TN.load_cached(CPU) == tn and os.path.exists(path)


def test_eff_bw_only_at_the_streaming_size():
    """``select_scan``'s rate is recorded at the calibration's streaming
    size (``calibrate.STREAM_BYTES``, two 4-byte inputs) and not below."""
    g = dict(warmup=0, iters=1)
    assert TN.scan_rows(CPU) * 8 == CAL.STREAM_BYTES["cpu"]
    assert TN.scan_rows(torch.device("cuda")) == 1 << 27
    at = TN._sweep_select_scan(dict(g, n_scan=None), TN._gen(CPU, 0), CPU)
    assert at[0].eff_bw > 0
    below = TN._sweep_select_scan(dict(g, n_scan=TN.scan_rows(CPU) // 2),
                                  TN._gen(CPU, 0), CPU)
    assert below[0].eff_bw is None


def test_grids_sweep_at_the_main_paths_sizes():
    """The depth sweep's build side is SF 20's part table (1.0 M rows,
    2^20), where the static rule gives 6 bits on the card, and both grids
    scan at the streaming size."""
    for g in (TN.FULL_GRID, TN.SMOKE_GRID):
        assert g["n_build"] == 1 << 20 and g["n_scan"] is None
        assert g["n"] >= 1 << 24
    assert TN._part_default_bits(1 << 20, torch.device("cuda")) == 6


# ---------------------------------------------------------------------------
# launch threading: cold store, tuned pickup
# ---------------------------------------------------------------------------


def test_cold_store_launches_default_byte_for_byte(tune_dir):
    """No tunings file: every knob at its default, and each strategy's
    result byte-identical to the reference's default launch."""
    assert TN.cached_store(CPU) is None
    assert TN.tuned_r(device=CPU) == TN.DEFAULT_R
    assert TN.tuned_hardware(M.HOST, device=CPU) is M.HOST
    for strategy in ("fused", "part", "opat"):
        cq = C.compile_plan(QUERIES["q2.1"], strategy)
        got = cq.execute(DB, mode="ref", device=CPU)
        ref = np.asarray(RE.compile_plan(REF_QUERIES["q2.1"], strategy
                                         ).execute(DB_REF, mode="ref"))
        assert got.tobytes() == ref.tobytes(), strategy
    assert cq.launch_config == {}               # opat on q2.1: no filter
    cq = C.compile_plan(QUERIES["q2.1"], "fused")
    cq.execute(DB, mode="ref", device=CPU)
    assert cq.launch_config["spja"] == {"threads": C.LAUNCH_SHAPES["spja"],
                                        "width": 32}


def test_tuned_store_drives_launch_and_preserves_answers(tune_dir):
    """A store read on the CPU: ``tuned_r`` reads it, ``HOST`` stays as
    it is (the partition depth and the model do not move), and every
    answer keeps its bytes."""
    cold = C.compile_plan(QUERIES["q2.1"], "part")
    want = cold.execute(DB, mode="ref", device=CPU)
    TN.save(_mk_tunings(**{
        "radix_sort/w32": TN.TunedConfig("radix_sort", 32, r=4),
        "part_probe/w32": TN.TunedConfig("part_probe", 32, part_bits=1,
                                         part_budget_bytes=1 << 30),
        "select_scan/w32": TN.TunedConfig("select_scan", 32,
                                          eff_bw=1e12)}))
    assert TN.tuned_r(device=CPU) == 4
    assert M.default_hardware(CPU) is M.HOST
    cq = C.compile_plan(QUERIES["q2.1"], "part")
    got = cq.execute(DB, mode="ref", device=CPU)
    assert got.tobytes() == want.tobytes()
    assert cq.launch_config["part_probe"]["bits"] == \
        cold.launch_config["part_probe"]["bits"]


def test_tuned_r_drives_order_by(tune_dir):
    """ORDER BY's digit width comes from the store (``tuned_r``); every
    width gives the same row order."""
    TN.save(_mk_tunings(**{
        "radix_sort/w32": TN.TunedConfig("radix_sort", 32, r=4)}))
    assert TN.tuned_r(device=CPU) == 4
    got = engine.order_by(DB.date, "d_yearmonthnum", device=CPU)
    want = np.argsort(DB.date["d_yearmonthnum"], kind="stable")
    np.testing.assert_array_equal(got["d_datekey"],
                                  DB.date["d_datekey"][want])


def test_part_launch_reports_bits(tune_dir):
    cq = C.compile_plan(QUERIES["q2.1"], "part")
    cq.execute(DB, mode="ref", device=CPU)
    lc = cq.launch_config["part_probe"]
    assert lc["threads"] == C.LAUNCH_SHAPES["part_probe"]
    assert lc["bits"] >= 1 and "digit" not in lc
    rq = RE.compile_plan(REF_QUERIES["q2.1"], "part")
    rq.execute(DB_REF, mode="ref")
    assert rq.launch_config["part_probe"]["bits"] == lc["bits"]


def test_launch_stats_count_part_and_part_loop():
    """``tests/test_part_probe.py``'s accounting: ``part`` one probe and
    one partition pass a join, ``part_loop`` one probe a non-empty
    partition."""
    plan = QUERIES["q2.1"]                  # 3 joins, none empties the chain
    C.reset_launch_stats()
    C.compile_plan(plan, "part").execute(DB, mode="ref", device=CPU)
    assert C.LAUNCH_STATS["probe"] == len(plan.joins)
    assert C.LAUNCH_STATS["partition"] == len(plan.joins)
    assert C.LAUNCH_STATS["host_syncs"] == len(plan.joins)
    C.reset_launch_stats()
    C.compile_plan(plan, "part_loop").execute(DB, mode="ref", device=CPU)
    assert C.LAUNCH_STATS["probe"] > len(plan.joins)
    assert C.LAUNCH_STATS["partition"] == len(plan.joins)
    prev = C.reset_launch_stats()
    assert prev["probe"] > 0 and C.LAUNCH_STATS["probe"] == 0


def test_launch_stats_count_waves_and_opat():
    C.reset_launch_stats()
    C.execute_shared(list(QUERIES.values()), DB, mode="ref", device=CPU)
    assert C.LAUNCH_STATS["probe"] == 1     # one wave, one morsel
    C.reset_launch_stats()
    C.compile_plan(QUERIES["q4.1"], "opat").execute(DB, mode="ref",
                                                    device=CPU)
    assert C.LAUNCH_STATS["probe"] == len(QUERIES["q4.1"].joins)
    C.reset_launch_stats()


# ---------------------------------------------------------------------------
# cost-model feedback
# ---------------------------------------------------------------------------


def _ref_hw(hw):
    from repro.cost import model as RCM
    return RCM.Hardware(**dataclasses.asdict(hw))


def _same_hw(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        if isinstance(da[k], float) and isinstance(db[k], float):
            assert da[k] == pytest.approx(db[k], rel=1e-9), k
        else:
            assert da[k] == db[k], k


def test_part_budget_feedback_reproduces_best_bits():
    """The stored budget makes ``model.part_bits`` give the measured depth
    at the sweep's build size, for every depth the grid can pick, as the
    reference's does."""
    n_build = 1 << 19
    for best_bits in TN.FULL_GRID["bits"]:
        budget = int(M.ht_bytes(n_build) * 2 / (3 << (best_bits - 1)))
        hw = dataclasses.replace(M.HOST, part_budget_bytes=budget)
        assert M.part_bits(n_build, hw=hw) == best_bits, best_bits
        assert RM.part_bits(n_build, hw=_ref_hw(hw)) == best_bits


def _store_pair():
    cfgs = {"part_probe/w32": dict(family="part_probe", width=32,
                                   part_bits=2, part_budget_bytes=123456),
            "select_scan/w32": dict(family="select_scan", width=32,
                                    eff_bw=2.0e12)}
    ours = TN.TuneStore(_mk_tunings(**{
        k: TN.TunedConfig(**v) for k, v in cfgs.items()}))
    ref = RTN.TuneStore(RTN.Tunings(
        backend="cpu", fingerprint="x", measured_at=0.0,
        configs={k: RTN.TunedConfig(**v) for k, v in cfgs.items()}))
    return ours, ref


@pytest.mark.parametrize("base", ["HOST", "H100"])
def test_apply_hardware_folds_tuned_feedback_as_the_reference(base):
    hw0 = getattr(CM, base) if base == "H100" else M.HOST
    ours, ref = _store_pair()
    hw = TN.apply_hardware(ours, hw0)
    assert hw.name == hw0.name + "-tuned"
    assert hw.part_budget_bytes == 123456 and hw.read_bw == 2.0e12
    _same_hw(hw, RTN.apply_hardware(ref, _ref_hw(hw0)))
    # nothing to fold -> the base itself
    assert TN.apply_hardware(TN.TuneStore(_mk_tunings()), hw0) is hw0


def test_tuned_hardware_cold_is_base(tune_dir):
    assert TN.tuned_hardware(M.HOST, device=CPU) is M.HOST
    assert RTN.tuned_hardware(RM.HOST) is RM.HOST


def test_default_hardware_folds_calibration_then_tunings(monkeypatch):
    """On a card ``default_hardware`` is the H100 entry, calibrated, then
    tuned — the reference's composition (``tune.tuned_hardware(
    calibrate.cached_hardware(base) or base)``) on the same numbers; on
    the CPU it stays ``HOST``."""
    ours, ref = _store_pair()
    calibrated = dataclasses.replace(CM.H100, name="H100-calibrated",
                                     read_bw=3.0e12, cache_bw=9e12)
    monkeypatch.setattr(M, "resolve", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(CAL, "cached_hardware", lambda base, d=None:
                        calibrated)
    monkeypatch.setattr(TN, "cached_store", lambda d=None: ours)
    hw = M.default_hardware()
    _same_hw(hw, RTN.apply_hardware(ref, _ref_hw(calibrated)))
    assert hw.read_bw == 2.0e12 and hw.part_budget_bytes == 123456
    # the tuned budget reaches part_bits, as the execute path asks
    assert M.part_bits(1 << 16, hw) == RM.part_bits(1 << 16, _ref_hw(hw))
    monkeypatch.setattr(TN, "cached_store", lambda d=None: None)
    assert M.default_hardware() is calibrated
    monkeypatch.undo()
    assert M.default_hardware(CPU) is M.HOST
