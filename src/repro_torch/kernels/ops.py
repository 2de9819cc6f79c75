"""Entry points of the port's kernels, with the reference's ``mode``
contract (``repro.kernels.ops``), decided by the device of the data:

  auto   -> the kernel on a CUDA tensor, the plain version on a CPU tensor
  kernel -> the kernel; raises on a CPU tensor (a CUDA kernel has no CPU
            form — the reference's interpret mode has no counterpart)
  ref    -> the plain version on either device (the kernels' oracle)

``spja`` and ``multi_spja`` take ``group``, the counterpart of the
reference's ``axis_name``: each rank runs the kernel on its own shard's
streams, and its exact int64 grid is all-reduced over the process group
(``reduce_grid``) before it is rounded to f32 once.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import agg as _agg
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import multi_fused as _multi
from repro_torch.kernels import part_probe as _pp
from repro_torch.kernels import project as _proj
from repro_torch.kernels import radix_part as _radix
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import select_scan as _sel
from repro_torch.kernels import ssb_fused as _fused
from repro_torch.kernels import unpack as _unp
from repro_torch.kernels.common import gather_decode

MODES = ("auto", "kernel", "ref")


def use_kernel(mode: str, device) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode == "ref":
        return False
    if device.type == "cuda":
        return True
    if mode == "kernel":
        raise RuntimeError(f"mode='kernel' needs CUDA tensors, got {device}: "
                           "the CUDA kernels have no CPU form")
    return False


def reduce_grid(acc: torch.Tensor, group=None) -> torch.Tensor:
    """Sum the exact int64 grid ``acc`` over the ranks of ``group`` in
    place (one ``all_reduce``; every rank gets the same bits) ->
    ``acc``.  Without a group, ``acc`` untouched."""
    if group is not None:
        if acc.dtype != torch.int64:
            raise TypeError(f"reduce_grid sums exact int64 grids, got "
                            f"{acc.dtype}")
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc


def _reduced(fn, acc, group, shape, device):
    """``fn(acc=grid)`` into a zero int64 grid, all-reduced over
    ``group`` -> ``acc`` with the reduced sums added, or (no ``acc``)
    the grid rounded to f32 once."""
    grid = torch.zeros(shape, dtype=torch.int64, device=device)
    fn(acc=grid)
    reduce_grid(grid, group)
    if acc is None:
        return grid.to(torch.float32)
    acc += grid
    return acc


def spja(pred_cols, pred_bounds, join_keys, join_tables, group_mults,
         m1, m2=None, measure_op: str = "first", n_groups: int = 1,
         mode: str = "auto", pred_widths=None, key_widths=None,
         key_refs=None, m_widths=None, m_refs=None, n_rows=None, acc=None,
         group=None):
    """Whole SPJA query over int32 fact streams, plain or bit-packed ->
    (n_groups,) f32 on the streams' device, or ``acc`` (an int64 grid)
    with the exact sums added.  Arguments as ``ssb_fused.spja``; an m2
    given with ``measure_op="first"`` is ignored (never loaded).
    ``n_rows`` is required when the measure stream is packed (its length
    is then the word count).  ``group``: this rank's streams are its
    shard; the sums of every rank of the process group are all-reduced
    in int64 before any rounding."""
    if measure_op not in ("mul", "sub"):
        m2 = None
    fn = _fused.spja if use_kernel(mode, m1.device) else _ref.spja
    kw = dict(measure_op=measure_op, n_groups=n_groups,
              pred_widths=pred_widths, key_widths=key_widths,
              key_refs=key_refs, m_widths=m_widths, m_refs=m_refs,
              n_rows=n_rows)
    args = (pred_cols, pred_bounds, join_keys, join_tables, group_mults,
            m1, m2)
    if group is not None:
        return _reduced(lambda acc: fn(*args, acc=acc, **kw), acc, group,
                        (n_groups,), m1.device)
    return fn(*args, acc=acc, **kw)


def multi_spja(pred_cols, pred_bounds, join_keys, join_tables, join_mults,
               join_use, q_valid, measure_cols, measure_sel,
               n_groups: int = 1, mode: str = "auto", pred_widths=None,
               key_widths=None, key_refs=None, m_widths=None, m_refs=None,
               n_rows=None, member_groups=None, acc=None,
               probe_groups=None, group=None):
    """A whole wave of SPJA queries in one fact pass -> (Q, n_groups) f32
    on the streams' device, or ``acc`` (an int64 grid) with the exact sums
    added (arguments as ``ref.multi_spja``).  ``n_rows`` is required when
    the first measure stream is packed (its length is then the word
    count).  ``member_groups`` (each member's reachable groups) only tells
    the kernel where to take each sum; ``probe_groups`` is the lowering
    of the joins to one probe a fact key column (``ref.multi_spja``),
    which both versions follow.  ``group`` as ``spja``'s: the whole
    wave's (Q, n_groups) grid is all-reduced over the process group."""
    if group is not None:
        return _reduced(lambda acc: multi_spja(
            pred_cols, pred_bounds, join_keys, join_tables, join_mults,
            join_use, q_valid, measure_cols, measure_sel,
            n_groups=n_groups, mode=mode, pred_widths=pred_widths,
            key_widths=key_widths, key_refs=key_refs, m_widths=m_widths,
            m_refs=m_refs, n_rows=n_rows, member_groups=member_groups,
            acc=acc, probe_groups=probe_groups), acc, group,
            (_ref._host_ints(q_valid).size, n_groups),
            measure_cols[0].device)
    if use_kernel(mode, measure_cols[0].device):
        return _multi.multi_spja(
            pred_cols, pred_bounds, join_keys, join_tables, join_mults,
            join_use, q_valid, measure_cols, measure_sel, n_groups=n_groups,
            pred_widths=pred_widths, key_widths=key_widths,
            key_refs=key_refs, m_widths=m_widths, m_refs=m_refs,
            n_rows=n_rows, member_groups=member_groups, acc=acc,
            probe_groups=probe_groups)
    return _ref.multi_spja(
        pred_cols, pred_bounds, join_keys, join_tables, join_mults, join_use,
        q_valid, measure_cols, measure_sel, n_groups=n_groups,
        pred_widths=pred_widths, key_widths=key_widths, key_refs=key_refs,
        m_widths=m_widths, m_refs=m_refs, n_rows=n_rows, acc=acc,
        probe_groups=probe_groups)


def select_scan(x, y, lo, hi, mode: str = "auto"):
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count): stable, zeros
    past the count.  x: int32 or f32; y: 4-byte."""
    fn = _sel.select_scan if use_kernel(mode, x.device) else _ref.select_scan
    return fn(x, y, lo, hi)


def select_scan_sparse(x, y, lo, hi, mode: str = "auto"):
    """``select_scan``'s result, reading y only in the tiles that hold a
    match (the paper's selective load, §5.3) -> (out (n,), count)."""
    fn = _sel.select_scan_sparse if use_kernel(mode, x.device) else \
        _ref.select_scan_sparse
    return fn(x, y, lo, hi)


def select_scan_packed(words, y, lo, hi, phys: int, mode: str = "auto"):
    """``select_scan`` over a bit-packed predicate column at ``phys``
    bits, the bounds in the encoded domain (``storage.encoded_bounds``)
    -> (out (n,), count) with n = y.shape[0].  A plain column (phys 32)
    goes to ``select_scan``."""
    if phys == 32:
        return select_scan(words, y, lo, hi, mode=mode)
    fn = _sel.select_scan_packed if use_kernel(mode, words.device) else \
        _ref.select_scan_packed
    return fn(words, y, lo, hi, phys)


def unpack(words, n: int, phys: int, ref=0, mode: str = "auto"):
    """Materializing bit-unpack: ``(n_words,)`` packed int32 words at
    ``phys`` bits -> the first ``n`` int32 values (+ ref).  A plain
    column (phys 32) is ``words[:n] + ref``."""
    if phys == 32:
        return words[:n] + int(ref)
    fn = _unp.unpack if use_kernel(mode, words.device) else _ref.unpack
    return fn(words, n, phys, ref)


def build_hash_table(keys, vals, n_slots: int, mode: str = "auto"):
    """The open-addressing linear-probe table of (key, val) rows ->
    (htk, htv), each (n_slots,) int32: the table sequential insertion in
    row order gives (the build half of the join microbenchmark)."""
    fn = _hj.build if use_kernel(mode, keys.device) else _ref.build
    return fn(keys, vals, n_slots)


def probe_join(keys, vals, ht_keys, ht_vals, mode: str = "auto"):
    """The keys found in a linear-probe table -> (payload (n,), vals (n,),
    count): stable, zeros past the count."""
    fn = _hj.probe_join if use_kernel(mode, keys.device) else \
        _ref.probe_join
    return fn(keys, vals, ht_keys, ht_vals)


def probe_agg(keys, vals, ht_keys, ht_vals, mode: str = "auto"):
    """SUM(payload + v) over the keys found in a linear-probe table -> a
    0-d tensor of vals' dtype (the paper's join microbenchmark)."""
    fn = _hj.probe_agg if use_kernel(mode, keys.device) else _ref.probe_agg
    return fn(keys, vals, ht_keys, ht_vals)


def reduce_sum(x, mode: str = "auto"):
    """The global sum -> 0-d int32 (int32 input, wrapping) or f32."""
    fn = _agg.reduce_sum if use_kernel(mode, x.device) else _ref.reduce_sum
    return fn(x)


def project(x1, x2, a, b, sigmoid: bool = False, mode: str = "auto"):
    """a*x1 + b*x2 in f32, optionally sigmoid."""
    fn = _proj.project if use_kernel(mode, x1.device) else _ref.project
    return fn(x1, x2, a, b, sigmoid=sigmoid)


def group_sum(group_ids, vals, n_groups: int, mode: str = "auto",
              acc=None):
    """SUM(vals) GROUP BY dense int32 ids -> (n_groups,) in vals' dtype,
    or ``acc`` (``ref.group_acc_dtype``'s running grid) with the sums
    added unrounded."""
    fn = _agg.group_sum if use_kernel(mode, vals.device) else \
        _ref.group_sum
    if acc is None:
        return fn(group_ids, vals, n_groups)
    return fn(group_ids, vals, n_groups, acc=acc)


def radix_histogram(keys, start_bit: int, r: int, mode: str = "auto"):
    """Per-tile bucket counts of bits [start_bit, start_bit + r) of each
    key (unsigned) -> (ceil(n / 2048), 2^r) int32."""
    if use_kernel(mode, keys.device):
        return _radix.histogram(keys, start_bit, r)
    return _ref.histogram(keys, start_bit, r)


def radix_partition_multi(keys, vals, start_bit: int, r: int,
                          mode: str = "auto", hist=None):
    """Stable partition pass with N payload columns riding the key ->
    (keys', (vals0', ...)): the partitioned join's shuffle.  ``hist``:
    the pass's ``radix_histogram`` when the caller has it (its column sums
    are then the pass's bucket counts and the kernel path launches no
    digit count of its own; the plain pass needs none)."""
    vals = tuple(vals)
    if use_kernel(mode, keys.device):
        return _radix.partition_multi(keys, vals, start_bit, r, hist=hist)
    return _ref.partition_multi(keys, vals, start_bit, r)


def radix_partition(keys, vals, start_bit: int, r: int, mode: str = "auto"):
    """One stable partition pass with one payload -> (keys', vals')."""
    fn = _radix.partition if use_kernel(mode, keys.device) else \
        _ref.partition
    return fn(keys, vals, start_bit, r)


def radix_sort(keys, vals, mode: str = "auto", r: int = 8,
               key_bits: int = 32):
    """LSB radix sort by the keys as unsigned 32-bit words, stable ->
    (keys', vals'): ceil(key_bits / r) partition passes; the kernel path
    counts every pass's digits in one launch and runs only the passes
    that move rows (``radix_part.pass_plan``)."""
    fn = _radix.radix_sort if use_kernel(mode, keys.device) else \
        _ref.radix_sort
    return fn(keys, vals, key_bits=key_bits, r=r)


def part_probe(keys, rowids, groups, offs, counts, htk, htv, mult,
               mode: str = "auto"):
    """Single-launch partitioned probe of the flat partition-major probe
    side against the packed ``(P, S)`` tables -> stable (rowids,
    groups + payload·mult, count); rows with a negative rowid are dead
    and never match."""
    fn = _pp.part_probe if use_kernel(mode, keys.device) else \
        _ref.part_probe
    return fn(keys, rowids, groups, offs, counts, htk, htv, mult)


def part_join(col, rowids, groups, htk, htv, mult, bits: int,
              mode: str = "auto", width: int = 32, ref=0):
    """Radix-partitioned join of the live rows (paper §4.4): gather their
    FK keys from ``col`` (a plain int32 column, or a packed word stream
    at ``width`` bits with frame of reference ``ref``), partition them by
    the key's low ``bits`` bits in one pass (row ids and running group
    ids ride along), then probe every partition against its row of the
    packed ``(P, S)`` tables in one launch -> stable partition-major
    (rowids, groups + payload·mult, count).

    The partition boundaries are the column sums of the pass's own
    histogram (``counts``) and their exclusive scan (``offs``), on the
    device: no second pass over the shuffled keys and no host round
    trip.  Dead rows (a negative rowid) never match; the reference pads
    the probe side with them to a power of two for XLA's trace cache,
    which the port does not need."""
    n = rowids.shape[0]
    if n == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=rowids.device)
        return z, z, torch.zeros((), dtype=torch.int64, device=z.device)
    keys = col[rowids] if width == 32 else gather_decode(col, rowids, width,
                                                         ref)
    hist = radix_histogram(keys, 0, bits, mode=mode)
    outk, (orow, ogrp) = radix_partition_multi(keys, (rowids, groups), 0,
                                               bits, mode=mode, hist=hist)
    counts = hist.sum(0, dtype=torch.int32)
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return part_probe(outk, orow, ogrp, offs, counts, htk, htv, mult,
                      mode=mode)
