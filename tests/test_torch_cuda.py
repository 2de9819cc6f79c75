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
from repro_torch.kernels import (agg, hash_join, ops, project, ref,
                                 select_scan, ssb_fused)
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


def _launched(mod, fn, *args, **kw):
    before = mod.LAUNCHES
    out = getattr(mod, fn)(*args, **kw)
    assert mod.LAUNCHES == before + 1
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
