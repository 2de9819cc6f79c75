"""The port's CUDA kernels on the card, held against their plain versions.

Needs an NVIDIA GPU: every test here skips without one.  Imports nothing
of jax or the reference package, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: bit-identical.  The kernel sums exactly in int64, so block
order cannot change the result.
"""
import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import ops, ref, ssb_fused
from repro_torch.sql import engine, hashtable, ssb

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
