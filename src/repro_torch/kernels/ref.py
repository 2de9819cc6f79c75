"""Plain PyTorch versions of the port's kernels — their ground truth.

Each function has its kernel's signature and semantics but is straight
tensor code with no tiling.  It runs on either device: the tests run it
on the CPU, ``chip_smoke.py`` runs it on the card beside the kernel.
Counts come back as 0-d int64 tensors on the inputs' device, and the
compacting functions return (n,) outputs whose entries past the count
are zero.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blocks as B
from repro_torch.kernels.common import DEFAULT_TILE, PHYS_WIDTHS, \
    decode_words

MEASURE_OPS = ("first", "mul", "sub")


def _host_ints(x) -> np.ndarray:
    """Small scalar parameters (predicate bounds, group multipliers) as a
    host int64 array: the kernel takes them by value, as the Pallas
    kernel keeps them in SMEM."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def bounds_list(pred_bounds, n_preds: int) -> List[Tuple[int, int]]:
    b = _host_ints(pred_bounds).reshape(-1, 2) if n_preds else \
        np.zeros((0, 2), np.int64)
    if b.shape[0] != n_preds:
        raise ValueError(f"pred_bounds has {b.shape[0]} rows for "
                         f"{n_preds} predicate columns")
    return [(int(lo), int(hi)) for lo, hi in b]


def mults_list(group_mults, n_joins: int) -> List[int]:
    m = _host_ints(group_mults).reshape(-1) if n_joins else \
        np.zeros((0,), np.int64)
    if m.shape[0] != n_joins:
        raise ValueError(f"group_mults has {m.shape[0]} entries for "
                         f"{n_joins} joins")
    return [int(v) for v in m]


def measure(m1: torch.Tensor, m2, measure_op: str) -> torch.Tensor:
    """The per-row measure in int64: m1, m1*m2 or m1-m2 of int32 columns
    (exact: |m1*m2| < 2^62)."""
    m = m1.to(torch.int64)
    if measure_op == "mul":
        m = m * m2.to(torch.int64)
    elif measure_op == "sub":
        m = m - m2.to(torch.int64)
    elif measure_op != "first":
        raise ValueError(f"measure_op {measure_op!r} not in {MEASURE_OPS}")
    return m


def refs_list(refs, k: int) -> List[int]:
    """The first k frame-of-reference values (all 0 when None)."""
    if refs is None:
        return [0] * k
    r = _host_ints(refs).reshape(-1)
    if r.shape[0] < k:
        raise ValueError(f"{r.shape[0]} references for {k} streams")
    return [int(v) for v in r[:k]]


def stream_widths(widths, k: int) -> Tuple[int, ...]:
    """The first k streams' widths: 32 (a plain int32 column) unless
    given, else one of the packed layout's widths."""
    w = tuple(int(v) for v in widths)[:k] if widths else (32,) * k
    if len(w) < k or any(v not in PHYS_WIDTHS for v in w):
        raise ValueError(f"widths {w} for {k} streams: each must be one "
                         f"of {PHYS_WIDTHS}")
    return w


def decode_stream(arr: torch.Tensor, width: int, ref: int,
                  n: int) -> torch.Tensor:
    """A stream as its n int32 values: a plain column as it is, a packed
    word stream decoded with its reference."""
    if width == 32:
        return arr
    return decode_words(arr, width, ref)[:n]


def spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
         join_keys: Sequence[torch.Tensor],
         join_tables: Sequence[torch.Tensor], group_mults,
         m1: torch.Tensor, m2=None, measure_op: str = "first",
         n_groups: int = 1, pred_widths=None, key_widths=None,
         key_refs=None, m_widths=None, m_refs=None,
         n_rows=None) -> torch.Tensor:
    """Fused select-project-join-aggregate -> (n_groups,) f32.

    Range predicates, then one linear-probe lookup per join (a miss
    filters the row), group id = sum of payload * mult in int32, measure
    m1 / m1*m2 / m1-m2.  Sums are exact in int64 (``index_add_``) and
    cast to f32 once, so the result is the exact sum rounded to nearest
    — the numpy oracle's float64 sum cast to f32, and the CUDA kernel's
    result, bit for bit.

    Any stream may be bit-packed (its width below 32): it is then the
    word stream of ``repro_torch.sql.storage``, of ``n_rows`` values.
    Packed predicate columns compare their raw lanes (the bounds are in
    the encoded domain); packed keys and measures add their reference
    (``key_refs``, ``m_refs``; ignored on plain streams)."""
    n_meas = 2 if measure_op in ("mul", "sub") else 1
    pred_widths = stream_widths(pred_widths, len(pred_cols))
    key_widths = stream_widths(key_widths, len(join_keys))
    m_widths = stream_widths(m_widths, n_meas)
    krefs = refs_list(key_refs, len(join_keys))
    mrefs = refs_list(m_refs, n_meas)
    if n_rows is None:
        if m_widths[0] != 32:
            raise ValueError("n_rows is required when the measure stream "
                             "is bit-packed")
        n_rows = m1.shape[0]
    n = int(n_rows)
    device = m1.device
    live = torch.ones((n,), dtype=torch.bool, device=device)
    for col, w, (lo, hi) in zip(pred_cols, pred_widths,
                                bounds_list(pred_bounds, len(pred_cols))):
        live &= B.block_pred_range(decode_stream(col, w, 0, n), lo, hi) > 0
    group = torch.zeros((n,), dtype=torch.int32, device=device)
    for j, (keys, w, mult) in enumerate(
            zip(join_keys, key_widths,
                mults_list(group_mults, len(join_keys)))):
        payload, found = B.block_lookup(decode_stream(keys, w, krefs[j], n),
                                        join_tables[2 * j],
                                        join_tables[2 * j + 1])
        live &= found > 0
        group += payload * mult
    ms = [decode_stream(m, w, r, n)
          for m, w, r in zip((m1, m2)[:n_meas], m_widths, mrefs)]
    sums = B.block_group_aggregate(
        group, measure(ms[0], ms[1] if n_meas == 2 else None, measure_op),
        live, n_groups)
    return sums.to(torch.float32)


def wave_params(pred_bounds, join_mults, join_use, q_valid, measure_sel,
                n_preds: int, n_joins: int, n_meas: int):
    """A wave's stacked member parameters as host int64 arrays, checked:
    bounds (Q, C, 2), mults and use (Q, J), valid (Q,), selectors (Q, 3).
    Every value must fit int32; use and valid are 0 or 1; each member's
    selectors name measure columns and an op of ``MEASURE_OPS``."""
    valid = _host_ints(q_valid).reshape(-1)
    q = valid.size
    bounds = _host_ints(pred_bounds).reshape(q, n_preds, 2)
    mults = _host_ints(join_mults).reshape(q, n_joins)
    use = _host_ints(join_use).reshape(q, n_joins)
    sel = _host_ints(measure_sel).reshape(q, 3)
    for name, a in (("pred_bounds", bounds), ("join_mults", mults)):
        if a.size and (a.min() < -(1 << 31) or a.max() >= 1 << 31):
            raise ValueError(f"{name} has a value outside int32")
    for name, a in (("join_use", use), ("q_valid", valid)):
        if a.size and not np.isin(a, (0, 1)).all():
            raise ValueError(f"{name} must hold 0 or 1")
    if q and ((sel[:, :2] < 0).any() or (sel[:, :2] >= n_meas).any()
              or (sel[:, 2] < 0).any()
              or (sel[:, 2] >= len(MEASURE_OPS)).any()):
        raise ValueError(f"measure_sel {sel.tolist()}: each (m1, m2) must "
                         f"index the {n_meas} measure columns and each op "
                         f"be 0..{len(MEASURE_OPS) - 1}")
    return bounds, mults, use, valid, sel


def multi_spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
               join_keys: Sequence[torch.Tensor],
               join_tables: Sequence[torch.Tensor], join_mults, join_use,
               q_valid, measure_cols: Sequence[torch.Tensor], measure_sel,
               n_groups: int = 1, pred_widths=None, key_widths=None,
               key_refs=None, m_widths=None, m_refs=None,
               n_rows=None) -> torch.Tensor:
    """A wave of Q SPJA queries in one pass -> (Q, n_groups) f32.

    The streams are the union of the members' columns: each join's table
    is probed once for every member, and only the predicates, group ids
    and sums fan out by member.  Member q's row is live when
    ``q_valid[q]``, every column c holds a value in
    ``[pred_bounds[q, c, 0], pred_bounds[q, c, 1]]`` and every join j
    with ``join_use[q, j]`` finds its key; its group id is
    Σ_j payload_j · join_mults[q, j] in int32 (a miss's payload is 0);
    its measure is ``measure_sel[q]`` = (m1, m2, op): column m1, m1·m2
    (op 1) or m1 − m2 (op 2).  Sums are exact in int64, rounded to f32
    once, as ``spja``'s; an id outside [0, n_groups) is dropped.  Streams
    may be bit-packed as in ``spja`` (``*_widths``, ``key_refs``,
    ``m_refs``; ``n_rows`` required when the first measure is packed)."""
    n_preds, n_joins, n_meas = len(pred_cols), len(join_keys), \
        len(measure_cols)
    bounds, mults, use, valid, sel = wave_params(
        pred_bounds, join_mults, join_use, q_valid, measure_sel, n_preds,
        n_joins, n_meas)
    pred_widths = stream_widths(pred_widths, n_preds)
    key_widths = stream_widths(key_widths, n_joins)
    m_widths = stream_widths(m_widths, n_meas)
    krefs = refs_list(key_refs, n_joins)
    mrefs = refs_list(m_refs, n_meas)
    if n_rows is None:
        if m_widths[0] != 32:
            raise ValueError("n_rows is required when the measure stream "
                             "is bit-packed")
        n_rows = measure_cols[0].shape[0]
    n = int(n_rows)
    device = measure_cols[0].device
    cols = [decode_stream(c, w, 0, n) for c, w in zip(pred_cols,
                                                      pred_widths)]
    probes = [B.block_lookup(decode_stream(k, w, krefs[j], n),
                             join_tables[2 * j], join_tables[2 * j + 1])
              for j, (k, w) in enumerate(zip(join_keys, key_widths))]
    meas = [decode_stream(m, w, r, n)
            for m, w, r in zip(measure_cols, m_widths, mrefs)]
    rows = []
    for q in range(bounds.shape[0]):
        if not valid[q]:
            rows.append(torch.zeros((n_groups,), dtype=torch.int64,
                                    device=device))
            continue
        live = torch.ones((n,), dtype=torch.bool, device=device)
        for c, col in enumerate(cols):
            live &= B.block_pred_range(col, int(bounds[q, c, 0]),
                                       int(bounds[q, c, 1])) > 0
        group = torch.zeros((n,), dtype=torch.int32, device=device)
        for j, (payload, found) in enumerate(probes):
            if use[q, j]:
                live &= found > 0
            if mults[q, j]:
                group += payload * int(mults[q, j])
        op = MEASURE_OPS[sel[q, 2]]
        m = measure(meas[sel[q, 0]], meas[sel[q, 1]], op)
        rows.append(B.block_group_aggregate(group, m, live, n_groups))
    if not rows:
        return torch.zeros((0, n_groups), dtype=torch.float32, device=device)
    return torch.stack(rows).to(torch.float32)


def probe_agg(keys: torch.Tensor, vals: torch.Tensor, ht_keys: torch.Tensor,
              ht_vals: torch.Tensor) -> torch.Tensor:
    """SUM(payload + v) over the keys found in a linear-probe table -> a
    0-d tensor of vals' dtype.  int32: each payload + v and the sum wrap
    as the reference's int32 adds (summed in int64, cut to int32 once:
    the same low 32 bits).  f32: each payload + v rounded to f32, then
    summed in f64 and rounded once; the kernel's f64 order differs, so
    it has these bits when the f64 sum is exact and is within one f32
    ulp of them otherwise."""
    payload, found = B.block_lookup(keys, ht_keys, ht_vals)
    hit = found > 0
    if vals.is_floating_point():
        row = payload[hit].to(torch.float32) + vals[hit].to(torch.float32)
        return row.double().sum().to(torch.float32)
    row = payload[hit].to(torch.int64) + vals[hit].to(torch.int64)
    return row.sum().to(torch.int32)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The global sum -> a 0-d tensor: int32 for integer input (wrapping,
    as the reference's int32 accumulator: summed in int64, cut to int32
    once), f32 for float input (summed in f64, rounded to f32 once; the
    reference sums in f32).  The kernel sums f64 in another order: these
    bits when the f64 sum is exact, within one f32 ulp otherwise."""
    if x.is_floating_point():
        return x.double().sum().to(torch.float32)
    return x.to(torch.int64).sum().to(torch.int32)


def unpack(words: torch.Tensor, n: int, phys: int, ref=0) -> torch.Tensor:
    """The first ``n`` values of a packed word stream at ``phys`` bits
    per value, plus the frame of reference."""
    return decode_words(words, phys, int(ref))[:n]


def select_scan_packed(words: torch.Tensor, y: torch.Tensor, lo, hi,
                       phys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_scan`` over a bit-packed predicate column: SELECT y WHERE
    lo <= decode(x) <= hi with the bounds in the encoded domain; rows
    past ``y.shape[0]`` (a last word's padding lanes) never match."""
    return select_scan(decode_words(words, phys)[:y.shape[0]], y, lo, hi)


def select_scan(x: torch.Tensor, y: torch.Tensor, lo, hi
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count): the selected
    entries of y in row order, then zeros.  Runs on the tensors' own
    device with no host round trip."""
    bitmap = B.block_pred_range(x, lo, hi)
    offsets, count = B.block_scan(bitmap)
    return B.block_shuffle(y, bitmap, offsets), count


def probe_join(keys: torch.Tensor, vals: torch.Tensor,
               ht_keys: torch.Tensor, ht_vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The keys found in a linear-probe table -> (payload (n,), vals (n,),
    count): each found row's table payload and its own val, in row
    order, then zeros."""
    payload, found = B.block_lookup(keys, ht_keys, ht_vals)
    offsets, count = B.block_scan(found)
    return (B.block_shuffle(payload, found, offsets),
            B.block_shuffle(vals, found, offsets), count)


def project(x1: torch.Tensor, x2: torch.Tensor, a, b,
            sigmoid: bool = False) -> torch.Tensor:
    """a*x1 + b*x2 in f32, each product and the sum rounded once;
    optionally 1 / (1 + exp(-y))."""
    y = a * x1 + b * x2
    if sigmoid:
        y = 1.0 / (1.0 + torch.exp(-y))
    return y


def group_sum(group_ids: torch.Tensor, vals: torch.Tensor,
              n_groups: int) -> torch.Tensor:
    """SUM(vals) GROUP BY group_ids -> (n_groups,) in vals' dtype (f32 or
    int32).  int32 sums wrap as the reference's int32 accumulator does
    (summed in int64, cut to int32); f32 sums are taken in f64 and
    rounded to f32 once, so integer-valued f32 sums are exact.  An id
    outside [0, n_groups) is dropped."""
    acc = torch.float64 if vals.is_floating_point() else torch.int64
    live = torch.ones(group_ids.shape, dtype=torch.int32,
                      device=group_ids.device)
    return B.block_group_aggregate(group_ids, vals.to(acc), live,
                                   n_groups).to(vals.dtype)


# ---------------------------------------------------------------------------
# radix partitioning (paper §4.4) and the partitioned probe
# ---------------------------------------------------------------------------


def bucket_of(keys: torch.Tensor, start_bit: int, r: int) -> torch.Tensor:
    """Each key's radix bucket: bits [start_bit, start_bit + r) of the key
    as an unsigned 32-bit word, int64.  The shift is logical, as the
    reference's ``shift_right_logical``: torch's int32 ``>>`` is
    arithmetic, so it runs in int64 on the key's low 32 bits (a last pass
    with start_bit + r > 32 then sees zeros above bit 31, not the sign)."""
    return ((keys.to(torch.int64) & 0xFFFFFFFF) >> start_bit) & ((1 << r) - 1)


def histogram(keys: torch.Tensor, start_bit: int, r: int,
              tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Per-tile bucket counts -> (ceil(n / tile), 2^r) int32: row t counts
    the buckets of rows [t·tile, (t+1)·tile)."""
    n, nb = keys.shape[0], 1 << r
    n_tiles = -(-n // tile)
    rows = torch.arange(n, dtype=torch.int64, device=keys.device)
    idx = rows // tile * nb + bucket_of(keys, start_bit, r)
    return torch.bincount(idx, minlength=n_tiles * nb).view(
        n_tiles, nb).to(torch.int32)


def partition_multi(keys: torch.Tensor, vals: Sequence[torch.Tensor],
                    start_bit: int, r: int
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One stable radix-partition pass carrying N payload columns: one
    stable argsort of the bucket ids, every column gathered through it
    -> (keys', (vals0', ...))."""
    order = torch.argsort(bucket_of(keys, start_bit, r), stable=True)
    return keys[order], tuple(v[order] for v in vals)


def partition(keys: torch.Tensor, vals: torch.Tensor, start_bit: int,
              r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``partition_multi`` with one payload column -> (keys', vals')."""
    out, (v,) = partition_multi(keys, (vals,), start_bit, r)
    return out, v


def radix_sort(keys: torch.Tensor, vals: torch.Tensor, key_bits: int = 32,
               r: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSB radix sort: ceil(key_bits / r) stable ``partition`` passes of r
    bits from bit 0 up.  Keys order as unsigned 32-bit words (a negative
    key after every non-negative one), as the reference's kernel passes
    do; the reference's own oracle ``ref.radix_sort`` orders them signed
    (ROADMAP.md, queue 3)."""
    for p in range(-(-key_bits // r)):
        keys, vals = partition(keys, vals, p * r, r)
    return keys, vals


def part_probe(keys: torch.Tensor, rowids: torch.Tensor,
               groups: torch.Tensor, offs: torch.Tensor,
               counts: torch.Tensor, htk: torch.Tensor, htv: torch.Tensor,
               mult) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partitioned probe over the flat partition-major probe side ->
    (rowids (n,), groups + payload·mult (n,), count): each row probes the
    table of its own partition, row ``key & (P - 1)`` of the packed
    ``(P, S)`` tables; rows past the runs (``offs[-1] + counts[-1]``)
    and dead rows (``rowid < 0``) never match; the matches compacted
    stably, in flat order, then zeros."""
    n = keys.shape[0]
    payload, found = B.block_lookup(keys, htk, htv)
    total = (offs[-1].to(torch.int64) + counts[-1]) if offs.numel() else 0
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    bitmap = ((found > 0) & (pos < total) & (rowids >= 0)).to(torch.int32)
    offsets, count = B.block_scan(bitmap)
    grp = groups + payload * int(mult)
    return (B.block_shuffle(rowids, bitmap, offsets),
            B.block_shuffle(grp, bitmap, offsets), count)
