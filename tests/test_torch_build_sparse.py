"""The plain versions of the port's last two kernels on the CPU, against
the reference package: ``ref.build`` (the hash build of the join
microbenchmark) and ``ref.select_scan_sparse`` (the selective load).

Same inputs in both, made with numpy from a seed.  Tolerance:
bit-identical.  The build is held to the reference's interpret-mode
Pallas ``hash_join.build`` and to its jnp ``ref.build`` — the table that
inserting the rows in row order gives, byte for byte (not the host
``np_build``'s, which places rows in rounds).  The sparse scan is held to
the reference's interpret-mode ``select_scan_sparse`` in row order and
to the port's ``select_scan``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_join as RHJ
from repro.kernels import ref as RREF
from repro.kernels import select_scan as RSEL
from repro_torch import cases
from repro_torch.core import blocks as TB
from repro_torch.kernels import ops, ref as TREF
from repro_torch.sql import hashtable as THT

# (n, n_slots, kind): ragged n, duplicate keys, a full table, no rows
BUILD_CASES = [(1000, 2048, "distinct"), (2048, 4096, "duplicates"),
               (513, 1024, "duplicates"), (256, 256, "full"),
               (0, 64, "empty"), (1, 1, "full"), (37, 64, "distinct")]


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("n,n_slots,kind", BUILD_CASES)
def test_build_matches_reference_kernel_and_oracle(n, n_slots, kind, tile):
    keys, vals, s = cases.build_case(n + n_slots, n_slots, kind, n=n)
    htk, htv = TREF.build(torch.from_numpy(keys), torch.from_numpy(vals), s)
    if n:
        rk, rv = RHJ.build(jnp.asarray(keys), jnp.asarray(vals), s,
                           tile=tile, interpret=True)
        ok, ov = RREF.build(jnp.asarray(keys), jnp.asarray(vals), s)
    else:       # the reference's build takes no empty input: its table
        rk = ok = np.full(s, TB.EMPTY, np.int32)
        rv = ov = np.zeros(s, np.int32)
    for got, want in ((htk, rk), (htv, rv), (htk, ok), (htv, ov)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's entry point, on the CPU, is the plain version
    for got, want in zip(ops.build_hash_table(torch.from_numpy(keys),
                                              torch.from_numpy(vals), s),
                         (htk, htv)):
        assert torch.equal(got, want)


def test_build_keeps_the_first_duplicate_and_probes_as_np_build():
    keys, vals, s = cases.build_case(3, 1 << 12, "duplicates")
    htk, htv = TREF.build(torch.from_numpy(keys), torch.from_numpy(vals), s)
    hk, hv = (torch.from_numpy(a) for a in THT.np_build(keys, vals, s))
    probe = torch.from_numpy(keys)
    payload, found = TB.block_lookup(probe, htk, htv)
    want_p, want_f = TB.block_lookup(probe, hk, hv)
    assert torch.equal(found, want_f) and bool((found > 0).all())
    assert torch.equal(payload, want_p)
    first = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        first.setdefault(k, v)
    assert payload.tolist() == [first[k] for k in keys.tolist()]


def test_build_layout_differs_from_np_build_but_not_from_sequential():
    """``np_build`` places rows in rounds, so its bytes may differ from
    the sequential table's; the port's build gives the sequential ones."""
    rng = np.random.default_rng(4)
    differ = 0
    for _ in range(40):
        n = int(rng.integers(1, 200))
        keys = rng.integers(0, 60, n).astype(np.int32)
        s = THT.next_pow2(n)
        got, _ = TREF.build(torch.from_numpy(keys), torch.from_numpy(keys), s)
        want, _ = RREF.build(jnp.asarray(keys), jnp.asarray(keys), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        differ += not np.array_equal(got.numpy(),
                                     THT.np_build(keys, keys, s)[0])
    assert differ > 0


def test_build_rejects_what_no_table_holds():
    keys = torch.arange(17, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.build_hash_table(keys, keys, 16)
    keys[5] = TB.EMPTY
    with pytest.raises(ValueError, match="EMPTY"):
        ops.build_hash_table(keys, keys, 32)
    with pytest.raises(ValueError, match="power of 2"):
        ops.build_hash_table(keys[:3], keys[:3], 12)


@pytest.mark.parametrize("bounds", [(0, 4), (100, 400), (0, 999),
                                    (5000, 6000)])
def test_select_scan_sparse_matches_reference_kernel_in_row_order(bounds):
    rng = np.random.default_rng(sum(bounds))
    x = rng.integers(0, 1000, 4096).astype(np.int32)
    x[1000:1600] = 2000                 # tiles with no match at all
    y = rng.integers(-(1 << 31), (1 << 31) - 1, 4096).astype(np.int32)
    lo, hi = bounds
    out, cnt = TREF.select_scan_sparse(torch.from_numpy(x),
                                       torch.from_numpy(y), lo, hi)
    r_out, r_cnt = RSEL.select_scan_sparse(jnp.asarray(x), jnp.asarray(y),
                                           lo, hi, tile=256, interpret=True)
    c = int(cnt)
    assert c == int(r_cnt)
    np.testing.assert_array_equal(out.numpy()[:c], np.asarray(r_out)[:c])
    dense, dense_cnt = TREF.select_scan(torch.from_numpy(x),
                                        torch.from_numpy(y), lo, hi)
    assert torch.equal(out, dense) and torch.equal(cnt, dense_cnt)


@pytest.mark.parametrize("unit", [1, 7, 32, 256, 5000])
@pytest.mark.parametrize("selectivity", [0.0, 1e-3, 0.5])
@pytest.mark.parametrize("order", cases.SPARSE_ORDERS)
def test_select_scan_sparse_any_skip_unit_gives_select_scan(unit,
                                                            selectivity,
                                                            order,
                                                            monkeypatch):
    x, y, lo, hi = cases.sparse_case(9, 4099, selectivity, order)
    args = (torch.from_numpy(x), torch.from_numpy(y), lo, hi)
    with monkeypatch.context() as m:
        m.setattr(TREF, "SKIP_ROWS", unit)
        got = TREF.select_scan_sparse(*args)
    want = TREF.select_scan(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in
               zip(ops.select_scan_sparse(*args), want))


def test_select_scan_sparse_float_and_empty():
    x, y, lo, hi = cases.select_case(2, 3001, "mid", "float32")
    args = (torch.from_numpy(x), torch.from_numpy(y), lo, hi)
    got, want = TREF.select_scan_sparse(*args), TREF.select_scan(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    z = torch.zeros(0, dtype=torch.int32)
    out, cnt = TREF.select_scan_sparse(z, z, 0, 1)
    assert out.numel() == 0 and int(cnt) == 0
