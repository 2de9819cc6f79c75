"""The grid rule of ``group_sum``'s kernel, and the errors of the two
entry points whose kernels changed (``group_sum``, ``build``), on the CPU.

``agg.group_grid`` sizes one ``group_sum`` launch by the call's rows: a
block for every ``GROUP_BLOCK_ROWS`` rows, at most the resident blocks
(a cooperative launch takes no more), and few enough that the blocks'
partial rows stay within 1 / ``PARTIAL_SHARE`` of the call's 8n input
bytes; one block writes no partial row.  The rule is pure Python, so it
is held here; the kernel that runs it is held on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import agg, hash_join, ops, ref

# (rows, groups) of the opat pass's 13 group_sum calls at SF 20 (the
# smoke's phase 5), and edges around them
OPAT_CALLS = [(2_245_807, 1), (79_567, 1), (18_150, 1), (971_681, 7000),
              (187_167, 7000), (23_527, 7000), (4_130_006, 150),
              (157_370, 600), (6_743, 24), (72, 24), (1_947_529, 35),
              (555_491, 100), (10_626, 800)]
EDGES = [(0, 1), (1, 1), (agg.GROUP_BLOCK_ROWS - 1, 1),
         (agg.GROUP_BLOCK_ROWS, 1), (2 * agg.GROUP_BLOCK_ROWS, 1),
         (1 << 22, 1), (1 << 22, 7000), (1 << 22, 28_000), (1 << 31, 1),
         (1 << 31, 28_000), (4095, 28_000)]
RESIDENT = [1, 132, 264, 1056]
WIDTHS = [4, 8]                 # int32 partial sums, f64 partial sums


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("n,n_groups", OPAT_CALLS + EDGES)
def test_group_grid_bounds(n, n_groups, resident, width):
    """At least one block and never more than the resident blocks; more
    than one only when each has GROUP_BLOCK_ROWS rows and the partial
    rows stay within 1 / PARTIAL_SHARE of the 8n input bytes."""
    blocks = agg.group_grid(n, n_groups, resident, width)
    assert 1 <= blocks <= resident
    if blocks > 1:
        assert blocks * agg.GROUP_BLOCK_ROWS <= n
        assert blocks * n_groups * width * agg.PARTIAL_SHARE <= 8 * n


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n_groups", [1, 24, 7000, 28_000])
@pytest.mark.parametrize("n", [0, 1, 72, 4095, agg.GROUP_BLOCK_ROWS - 1])
def test_group_grid_one_block_below_a_blocks_rows(n, n_groups, width):
    """A call below one block's rows is one block, on any card."""
    for resident in RESIDENT:
        assert agg.group_grid(n, n_groups, resident, width) == 1


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n_groups", [1, 24, 150])
def test_group_grid_large_call_fills_the_resident_grid(n_groups, width):
    """A call of many rows over few groups takes every resident block."""
    for resident in RESIDENT:
        assert agg.group_grid(1 << 24, n_groups, resident, width) == \
            resident


def test_group_grid_grows_with_rows():
    """More rows never give fewer blocks, for any group count."""
    rng = np.random.default_rng(0)
    for n_groups in (1, 35, 800, 7000, 28_000):
        ns = np.sort(rng.integers(0, 1 << 26, 200))
        grids = [agg.group_grid(int(n), n_groups, 132, 8) for n in ns]
        assert grids == sorted(grids)


def test_group_grid_flight_two_calls_are_split():
    """SSB flight 2's largest opat call (q2.1, 971,681 rows into 7000
    groups) runs over several blocks, its partial rows a quarter of its
    input bytes at most; q2.3's 23,527 rows run as one block."""
    assert 1 < agg.group_grid(971_681, 7000, 132, 8) < 132
    assert agg.group_grid(23_527, 7000, 132, 8) == 1


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_group_sum_errors_unchanged(mode):
    """A running grid of the wrong type, shape or layout raises in the
    plain path as before; the kernel wrapper refuses a CPU tensor."""
    ids, vals, g = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in cases.group_case(3, 64, 4))
    for acc in (torch.zeros(4, dtype=torch.float32),
                torch.zeros(5, dtype=torch.float64),
                torch.zeros(8, dtype=torch.float64)[::2]):
        with pytest.raises(ValueError, match="acc must be"):
            ops.group_sum(ids, vals, g, mode=mode, acc=acc)
    with pytest.raises(ValueError, match="acc must be"):
        ops.group_sum(ids, vals.to(torch.int32), g, mode=mode,
                      acc=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="no kernel for device"):
        agg.group_sum(ids, vals, g)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.group_sum(ids, vals, g, mode="kernel")


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_build_errors_unchanged(mode):
    """Every check of ``ref.check_build`` raises as before in the plain
    path; the EMPTY error is the one the kernel wrapper raises from its
    flag (``ref.empty_key_error``)."""
    keys = torch.arange(17, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        ops.build_hash_table(keys, keys, 16, mode=mode)
    with pytest.raises(ValueError, match="power of 2"):
        ops.build_hash_table(keys[:3], keys[:3], 12, mode=mode)
    with pytest.raises(ValueError, match="1-D int32"):
        ops.build_hash_table(keys.to(torch.int64), keys, 32, mode=mode)
    with pytest.raises(ValueError, match="1-D int32"):
        ops.build_hash_table(keys, keys[:5], 32, mode=mode)
    for at in (0, 8, 16):
        bad = keys.clone()
        bad[at] = -(1 << 31)
        with pytest.raises(ValueError) as err:
            ops.build_hash_table(bad, keys, 32, mode=mode)
        assert str(err.value) == str(ref.empty_key_error())
    with pytest.raises(ValueError, match="no kernel for device"):
        hash_join.build(keys, keys, 32)


def test_build_shape_check_leaves_the_keys_to_the_kernel():
    """``check_build_shape`` (the kernel wrapper's host checks) passes a
    table whose keys hold EMPTY, which ``check_build`` refuses."""
    keys = torch.arange(8, dtype=torch.int32)
    keys[3] = -(1 << 31)
    ref.check_build_shape(keys, keys, 8)
    with pytest.raises(ValueError, match="EMPTY"):
        ref.check_build(keys, keys, 8)
