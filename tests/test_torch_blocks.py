"""The port's block functions (``repro_torch.core.blocks``) against the
reference's (``repro.core.blocks``) on the same numpy inputs.  Every
comparison is exact: these are integer functions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as RB
from repro.sql import hashtable as RHT
from repro_torch.core import blocks as TB

INT32_EXTREMES = np.array([-(1 << 31), -(1 << 31) + 1, -1, 0, 1,
                           (1 << 31) - 1], np.int32)


@pytest.mark.parametrize("n_slots", [16, 1024, 1 << 20, 1 << 30])
def test_hash_fn_matches_reference(n_slots):
    rng = np.random.default_rng(n_slots)
    keys = np.concatenate([
        rng.integers(-(1 << 31), (1 << 31) - 1, 4096, dtype=np.int32),
        INT32_EXTREMES])
    want = np.asarray(RB.hash_fn(jnp.asarray(keys), n_slots))
    got = TB.hash_fn(torch.from_numpy(keys), n_slots).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, RHT.np_hash(keys, n_slots))


@pytest.mark.parametrize("lo,hi", [(10, 20), (-5, 5), (30, 29),
                                   (-(1 << 31), (1 << 31) - 1), (7, 7)])
def test_block_pred_range_matches_reference(lo, hi):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(-40, 40, 1000, dtype=np.int32),
                        INT32_EXTREMES])
    want = np.asarray(RB.block_pred_range(jnp.asarray(x), lo, hi))
    got = TB.block_pred_range(torch.from_numpy(x), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


_LOOKUP_SEEDS = {"collide": 11, "negative": 12, "wrap": 13,
                 "duplicates": 14, "empty": 15}


def _lookup_case(kind: str):
    """(probe keys, htk, htv) for one lookup scenario."""
    rng = np.random.default_rng(_LOOKUP_SEEDS[kind])
    if kind == "empty":
        htk, htv = RHT.np_build(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                16)
        probe = rng.integers(-50, 50, 300, dtype=np.int32)
        return np.concatenate([probe, INT32_EXTREMES]), htk, htv
    n = 700
    if kind == "collide":
        # many keys, a table at the build's one-half load: long chains
        keys = rng.choice(np.arange(0, 100_000), n, replace=False)
    elif kind == "negative":
        keys = rng.choice(np.arange(-5000, 0), n, replace=False)
    elif kind == "wrap":
        # every key's home slot is among the last four: chains wrap
        n_slots = RHT.next_pow2(n // 8)
        cand = np.arange(-200_000, 200_000, dtype=np.int32)
        cand = cand[RHT.np_hash(cand, n_slots) >= n_slots - 4]
        keys = rng.choice(cand, n // 8, replace=False)
    elif kind == "duplicates":
        base = rng.choice(np.arange(-3000, 3000), n // 2, replace=False)
        keys = np.concatenate([base, base[:n // 4], base[:n // 8]])
    else:
        raise ValueError(kind)
    keys = keys.astype(np.int32)
    vals = rng.integers(0, 1 << 20, len(keys), dtype=np.int32)
    htk, htv = RHT.np_build(keys, vals, RHT.next_pow2(len(np.unique(keys))))
    probe = np.concatenate([
        rng.choice(keys, 600),
        rng.integers(keys.min() - 100, keys.max() + 100, 400,
                     dtype=np.int32),
        INT32_EXTREMES])
    return probe, htk, htv


@pytest.mark.parametrize("kind", ["collide", "negative", "wrap",
                                  "duplicates", "empty"])
def test_block_lookup_matches_reference(kind):
    probe, htk, htv = _lookup_case(kind)
    want_p, want_f = RB.block_lookup(jnp.asarray(probe), jnp.asarray(htk),
                                     jnp.asarray(htv))
    got_p, got_f = TB.block_lookup(torch.from_numpy(probe),
                                   torch.from_numpy(htk),
                                   torch.from_numpy(htv))
    assert got_p.dtype == torch.int32 and got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    if kind != "empty":
        assert 0 < int(got_f.sum()) < len(probe)    # hits and misses both


@pytest.mark.parametrize("n_groups,dtype", [(1, np.int32), (37, np.int32),
                                            (7000, np.int32),
                                            (37, np.float32)])
def test_block_group_aggregate_matches_reference(n_groups, dtype):
    """Group ids run past n_groups on some live rows: both drop them.
    Values are small integers, so f32 sums are exact in any order."""
    rng = np.random.default_rng(n_groups)
    n = 5000
    ids = rng.integers(0, n_groups + max(n_groups // 10, 1), n,
                       dtype=np.int32)
    vals = rng.integers(-100, 100, n).astype(dtype)
    bitmap = (rng.random(n) < 0.6).astype(np.int32)
    want = np.asarray(RB.block_group_aggregate(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(bitmap), n_groups))
    got = TB.block_group_aggregate(torch.from_numpy(ids),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(bitmap), n_groups)
    np.testing.assert_array_equal(got.numpy(), want)
