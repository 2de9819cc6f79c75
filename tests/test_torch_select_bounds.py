"""A select bound over an int32 column: every mode of the port takes the
kernels' rule.  A bound that is not an int32 value (2.5, 2^31, NaN)
raises the same ``ValueError`` in ``ref`` mode as the kernel wrappers
(``select_scan.bound_bits``); int32 bounds, and f32 columns with their
bounds rounded to f32, select what they did, held against numpy.
Exact."""
import math
import re
import struct

import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import ops, ref, select_scan

NOT_INT32 = [(2.5, 3.5), (2, 3.5), (0, 2 ** 31), (-(2 ** 31) - 1, 0),
             (math.nan, 1), (0, math.inf), (np.float32(0.5), 7)]


def _numpy_select(x, y, lo, hi):
    hit = (x >= lo) & (x <= hi)
    out = np.zeros_like(y)
    out[:int(hit.sum())] = y[hit]
    return out, int(hit.sum())


@pytest.mark.parametrize("lo,hi", NOT_INT32)
@pytest.mark.parametrize("fn", ["select_scan", "select_scan_sparse",
                                "select_scan_packed"])
def test_ref_mode_refuses_a_bound_that_is_no_int32_value(fn, lo, hi):
    if fn == "select_scan_packed":
        words, y, _, _, phys = cases.tensors(
            cases.select_packed_case(3, 1000, 4), "cpu")
        args = (words, y, lo, hi, phys)
    else:
        x, y, _, _ = cases.tensors(cases.select_case(3, 1000), "cpu")
        args = (x, y, lo, hi)
    with pytest.raises(ValueError, match="not an int32 value"):
        getattr(ops, fn)(*args, mode="ref")
    with pytest.raises(ValueError, match="not an int32 value"):
        getattr(ref, fn)(*args)


@pytest.mark.parametrize("v", [l for pair in NOT_INT32 for l in pair] +
                         [3, -7, 2 ** 31 - 1, -(2 ** 31), 4.0,
                          np.int64(12), torch.tensor(5)])
def test_kernel_and_plain_bound_rules_agree(v):
    """The wrapper's bound bits and the plain path's bound are one rule."""
    try:
        want = ref.int32_bound(v)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            select_scan.bound_bits(v, torch.int32)
    else:
        assert select_scan.bound_bits(v, torch.int32) == want
        assert isinstance(want, int) and want == v


def test_the_opat_example_raises_in_ref_mode():
    x = torch.arange(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="bound 2.5 is not an int32 value"):
        ops.select_scan(x, x, 2.5, 3.5, mode="ref")


@pytest.mark.parametrize("lo,hi", [(10, 60), (-5, 2 ** 31 - 1),
                                   (-(2 ** 31), 0), (50, 40), (7.0, 7.0),
                                   (np.int32(3), np.int64(90)),
                                   (torch.tensor(20), torch.tensor(30))])
@pytest.mark.parametrize("fn", ["select_scan", "select_scan_sparse"])
def test_int32_bounds_select_as_numpy(fn, lo, hi):
    x, y, _, _ = cases.select_case(4, 3001)
    out, cnt = getattr(ops, fn)(torch.from_numpy(x), torch.from_numpy(y),
                                lo, hi, mode="ref")
    want, want_cnt = _numpy_select(x, y, int(lo), int(hi))
    assert int(cnt) == want_cnt
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(2.5, 3.5), (0.1, 77.7), (-1e40, 1e40),
                                   (30, 30)])
@pytest.mark.parametrize("fn", ["select_scan", "select_scan_sparse"])
def test_f32_columns_compare_in_f32(fn, lo, hi):
    """A float32 x takes any bound, rounded to f32 as the kernel's bound
    bits are."""
    x, y, _, _ = cases.select_case(5, 3001, "mid", "float32")
    out, cnt = getattr(ops, fn)(torch.from_numpy(x), torch.from_numpy(y),
                                lo, hi, mode="ref")
    with np.errstate(over="ignore"):         # past f32's range: +-inf
        f32 = [np.float32(v) for v in (lo, hi)]
    want, want_cnt = _numpy_select(x, y, *f32)
    assert int(cnt) == want_cnt
    np.testing.assert_array_equal(out.numpy(), want)
    assert [select_scan.bound_bits(v, torch.float32) for v in (lo, hi)] == \
        [struct.unpack("<i", v.tobytes())[0] for v in f32]
