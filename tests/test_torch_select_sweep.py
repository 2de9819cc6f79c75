"""``build.sweep_buffers``: the one allocation of a one-sweep compaction
(``csrc/lookback.cuh``), on CPU tensors.  The select sweep takes one
output row of y's type, the probe sweeps two int32 rows; the count is 8-
byte aligned past the rows, and the kernel's scratch words follow it.
Exact (addresses and shapes)."""
import inspect

import pytest
import torch

from repro_torch.kernels import build, hash_join, part_probe, select_scan

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 4095, 4096, 4097, 100_003])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.uint32])
def test_sweep_buffers_layout(n, rows, dtype):
    words = n // 4096 + 2
    out, count, scratch = build.sweep_buffers(n, words, CPU, rows=rows,
                                              dtype=dtype)
    assert out.shape == (rows, n) and out.dtype == dtype
    assert out.is_contiguous() and out[rows - 1].is_contiguous()
    base = out.data_ptr()
    end = base + 4 * rows * n
    assert count.dtype == torch.int64 and count.dim() == 0
    assert count.data_ptr() % 8 == 0
    assert end <= count.data_ptr() <= end + 4
    assert scratch == count.data_ptr() + 8
    total = build.sweep_words(n, words, rows)
    assert scratch + 4 * words == base + 4 * total
    # the pieces do not overlap: writing each leaves the others
    out.view(torch.int32).fill_(-1)
    count.fill_(7)
    assert int(count) == 7 and bool((out.view(torch.int32) == -1).all())


def test_sweep_buffers_default_is_the_probe_layout():
    """``probe_join`` and ``part_probe`` take the default: (2, n) int32
    rows, the count behind them."""
    out, count, scratch = build.sweep_buffers(5, 2, CPU)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert count.data_ptr() == out.data_ptr() + 40
    assert scratch == out.data_ptr() + 48
    for mod in (hash_join, part_probe):
        src = inspect.getsource(mod)
        call = src[src.index("sweep_buffers("):]
        call = call[:call.index(")")]
        assert "rows=" not in call and "dtype=" not in call, mod.__name__


def test_select_wrappers_take_one_row_of_y_type():
    src = inspect.getsource(select_scan._sweep)
    assert "rows=1" in src and "dtype=y.dtype" in src
