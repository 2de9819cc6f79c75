"""The join microbenchmark's kernels on the CPU against the reference
package: the plain ``probe_agg`` (SUM(payload + v) over the matches) and
``reduce_sum`` (the global sum), and their dispatch.

Same inputs in both (made with numpy from a seed).  Tolerances: int32
sums bit-identical (both wrap at 32 bits); f32 sums bit-identical on
integer-valued data whose f32 partial sums stay below 2^24 (exact in
both), else rtol 1e-5 (the reference sums in f32, the port in f64 and
rounds once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro_torch import cases
from repro_torch.kernels import ops, ref as TREF
from repro_torch.sql.hashtable import next_pow2, np_build, np_hash


def _jnp(case):
    return tuple(jnp.asarray(a) for a in case)


def _t(case):
    return cases.tensors(case, "cpu")


def _np_probe(keys, htk, htv):
    """(found, payload int64) of each key by a numpy linear probe."""
    slot = np_hash(keys, htk.shape[0])
    hit = np.zeros(keys.shape, bool)
    pay = np.zeros(keys.shape, np.int64)
    walking = np.ones(keys.shape, bool)
    for _ in range(htk.shape[0]):
        at = htk[slot]
        found = walking & (at == keys)
        hit |= found
        pay[found] = htv[slot[found]]
        walking &= ~found & (at != TREF.B.EMPTY)
        if not walking.any():
            break
        slot = np.where(walking, (slot + 1) % htk.shape[0], slot)
    return hit, pay


@pytest.mark.parametrize("n_build,n_slots", [(100, 256), (500, 2048)])
def test_probe_agg_matches_reference_kernel(n_build, n_slots):
    """``tests/test_kernels.py``'s shapes: a permuted key range, payloads
    in [0, 100), 3000 probes of which some miss."""
    rng = np.random.default_rng(n_build)
    bk = rng.permutation(5 * n_build)[:n_build].astype(np.int32)
    bv = rng.integers(0, 100, n_build, dtype=np.int32)
    htk, htv = np_build(bk, bv, n_slots)
    probe = rng.integers(0, 5 * n_build, 3000, dtype=np.int32)
    vals = rng.integers(0, 100, 3000, dtype=np.int32)
    case = (probe, vals, htk, htv)
    got = TREF.probe_agg(*_t(case))
    assert got.dtype == torch.int32 and got.shape == ()
    for tile in (512, 1024):
        assert int(got) == int(ROPS.probe_agg(*_jnp(case), mode="kernel",
                                              tile=tile))
    assert int(got) == int(RREF.probe_agg(*_jnp(case)))


@pytest.mark.parametrize("kind", cases.PROBE_KINDS)
@pytest.mark.parametrize("vals", ["int32", "f32_integers", "f32_random"])
def test_probe_agg_cases_match_reference(kind, vals):
    """Duplicate build keys (the first wins), chains that wrap the table,
    an all-EMPTY table and an all-miss probe; int32 vals over all of
    int32, so the sums wrap.  The reference's Pallas kernel takes int32
    vals only (its accumulator starts as an int32 0); f32 vals are held
    to its jnp oracle."""
    case = cases.probe_agg_case(11, 4000, kind, vals)
    got = TREF.probe_agg(*_t(case))
    keys, v, htk, htv = case
    sub = case
    if (htk != TREF.B.EMPTY).all():
        # no EMPTY slot: the reference's walk has no lap cap and would
        # not end on a miss, so it sums the rows whose key the table holds
        held = np.isin(keys, htk)
        sub = (keys[held], v[held], htk, htv)
    want = np.asarray(
        ROPS.probe_agg(*_jnp(sub), mode="kernel", tile=512)
        if vals == "int32" else RREF.probe_agg(*_jnp(sub)))
    assert got.numpy().dtype == want.dtype
    if kind in cases.PROBE_MISS_KINDS:
        assert float(got) == 0.0               # no key is found
    if vals == "int32":
        assert got.numpy().tobytes() == want.tobytes()
    else:           # payloads up to 2^20: the reference's f32 sum rounds
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # against numpy: each key walked from its home slot
    hit, pay = _np_probe(keys, htk, htv)
    if vals == "int32":
        exact = int((pay[hit] + v[hit].astype(np.int64)).sum())
        assert int(got) == (exact + (1 << 31)) % (1 << 32) - (1 << 31)
    else:
        row = pay[hit].astype(np.float32) + v[hit]
        assert float(got) == np.float32(row.astype(np.float64).sum())


@pytest.mark.parametrize("kind", cases.SUM_KINDS)
@pytest.mark.parametrize("n", [1, 3000, 4097, 4099, 8195])
def test_reduce_sum_matches_reference_kernel(kind, n):
    (x,) = cases.reduce_case(n, n, kind)
    got = TREF.reduce_sum(torch.from_numpy(x))
    want = np.asarray(ROPS.reduce_sum(jnp.asarray(x), mode="kernel",
                                      tile=256))
    assert got.numpy().dtype == want.dtype and got.shape == ()
    if kind == "f32_random":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        assert float(got) == np.float32(x.astype(np.float64).sum())
    elif kind == "f32_integers" or n < 4097:
        assert got.numpy().tobytes() == want.tobytes()
    if kind == "int32_overflow":
        exact = int(x.astype(np.int64).sum())
        assert int(got) == (exact + (1 << 31)) % (1 << 32) - (1 << 31)
        assert got.numpy().tobytes() == want.tobytes()


def test_reduce_sum_of_the_reference_agg_test():
    """``tests/test_kernels.py::test_agg``'s reduce: 3000 values in
    [0, 100), tile 256."""
    x = np.random.default_rng(8).integers(0, 100, 3000, dtype=np.int32)
    got = TREF.reduce_sum(torch.from_numpy(x))
    assert int(got) == int(ROPS.reduce_sum(jnp.asarray(x), mode="kernel",
                                           tile=256)) == int(x.sum())


def test_join_bench_table_is_a_half_full_table_of_every_key():
    htk, htv, n_build = cases.join_bench_table(3, 8 * 1024)
    assert htk.shape == (next_pow2(n_build),) and n_build == 512
    assert htk.nbytes + htv.nbytes == 8 * 1024
    used = htk != TREF.B.EMPTY
    assert int(used.sum()) == n_build
    np.testing.assert_array_equal(np.sort(htk[used]), np.arange(n_build))
    np.testing.assert_array_equal(htv[used], htk[used])
    keys = np.arange(0, n_build, 7, dtype=np.int32)
    vals = np.ones_like(keys)
    got = TREF.probe_agg(*_t((keys, vals, htk, htv)))
    assert int(got) == int(keys.sum()) + len(keys)


@pytest.mark.parametrize("mode", ["kernel", "auto", "ref"])
def test_dispatch_on_cpu_tensors(mode):
    probe = _t(cases.probe_agg_case(5, 500))
    (x,) = _t(cases.reduce_case(5, 500))
    if mode == "kernel":
        for fn, args in ((ops.probe_agg, probe), (ops.reduce_sum, (x,))):
            with pytest.raises(RuntimeError, match="needs CUDA tensors"):
                fn(*args, mode=mode)
        return
    assert torch.equal(ops.probe_agg(*probe, mode=mode),
                       TREF.probe_agg(*probe))
    assert torch.equal(ops.reduce_sum(x, mode=mode), TREF.reduce_sum(x))
