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
# select_scan_sparse's skip unit: 32 rows, one 128-byte line of int32 (the
# reference's; csrc/select_scan.cu's sweep reads y by runs of 4 rows)
SKIP_ROWS = 32
_INT32_MAX = (1 << 31) - 1


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


def check_acc(acc: torch.Tensor, shape: Tuple[int, ...],
              device: torch.device, dtype=torch.int64) -> None:
    """Raise unless ``acc`` is a contiguous grid of ``shape`` and
    ``dtype`` on ``device``: the running sums a morsel fold hands each
    pass."""
    if (acc.dtype != dtype or tuple(acc.shape) != tuple(shape)
            or acc.device != device or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")


def group_acc_dtype(vals: torch.Tensor) -> torch.dtype:
    """The running grid ``group_sum(..., acc=)`` takes for these values:
    f64 for f32 (their unrounded sums), int32 for int32 (wrapping)."""
    return torch.float64 if vals.is_floating_point() else torch.int32


def accumulate(sums: torch.Tensor, acc) -> torch.Tensor:
    """Exact int64 ``sums`` rounded to f32, or added to ``acc`` (which is
    returned, unrounded)."""
    if acc is None:
        return sums.to(torch.float32)
    check_acc(acc, tuple(sums.shape), sums.device)
    return acc.add_(sums)


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
         n_rows=None, acc=None) -> torch.Tensor:
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
    (``key_refs``, ``m_refs``; ignored on plain streams).

    ``acc``: an (n_groups,) int64 grid the exact sums are added to; it is
    returned unrounded (a morsel fold's running sums)."""
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
    return accumulate(sums, acc)


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


# the most streams one probe group serves (bits of a merged slot's mask;
# hashtable.MERGE_STREAMS)
GROUP_STREAMS = 32


def check_probe_groups(probe_groups, join_keys: Sequence[torch.Tensor],
                       key_widths, key_refs) -> List[Tuple[Tuple[int, ...],
                                                           object]]:
    """A wave's probe groups, checked -> [(streams, merged)] in probe
    order.  Each group is (the stream indices in bit order, None or the
    merged ``(slots (S, 4), payloads (k, E))`` int32 tables of
    ``hashtable.build_merged``); a group of one stream may probe its own
    table (merged None), a larger one needs a merged table.  Every
    stream is in one group, and a group's streams probe one key stream
    (the same tensor, width and reference)."""
    n_joins = len(join_keys)
    groups, seen = [], []
    for entry in probe_groups:
        streams, merged = entry
        streams = tuple(int(j) for j in streams)
        if not 1 <= len(streams) <= GROUP_STREAMS or \
                any(not 0 <= j < n_joins for j in streams):
            raise ValueError(f"probe group {streams}: 1..{GROUP_STREAMS} "
                             f"streams of the {n_joins} joins")
        first = streams[0]
        if any(join_keys[j] is not join_keys[first] or
               key_widths[j] != key_widths[first] or
               key_refs[j] != key_refs[first] for j in streams):
            raise ValueError(f"probe group {streams}: its streams probe "
                             "other key streams")
        if merged is None:
            if len(streams) != 1:
                raise ValueError(f"probe group {streams} needs a merged "
                                 "table")
        else:
            slots, pay = merged
            s = slots.shape[0] if slots.dim() == 2 else 0
            if slots.dim() != 2 or slots.shape[1] != 4 or s < 1 or \
                    s & (s - 1) or pay.dim() != 2 or \
                    pay.shape[0] != len(streams) or \
                    slots.dtype != torch.int32 or pay.dtype != torch.int32:
                raise ValueError(f"probe group {streams}: merged tables "
                                 "must be (S, 4) int32 slots, S a power of "
                                 "2, and (k, E) int32 payloads")
        seen += streams
        groups.append((streams, merged))
    if sorted(seen) != list(range(n_joins)):
        raise ValueError(f"probe groups {[g for g, _ in groups]} do not "
                         f"cover the {n_joins} joins once each")
    return groups


def merged_lookup(keys: torch.Tensor, slots: torch.Tensor,
                  pay: torch.Tensor
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One probe of a merged table -> (payload, found) int32 for each of
    its streams: a stream finds the key when the key is in the table and
    the stream's bit is set in its mask, and takes its payload matrix
    row's entry (0 where it misses)."""
    slot_of = torch.arange(slots.shape[0], dtype=torch.int32,
                           device=keys.device)
    slot, found = B.block_lookup(keys, slots[:, 0].contiguous(), slot_of)
    at = slot.to(torch.int64)
    hit = found > 0
    mask = torch.where(hit, slots[at, 1], 0)
    entry = torch.where(hit, slots[at, 2], 0).to(torch.int64)
    out = []
    for s in range(pay.shape[0]):
        bit = ((mask >> s) & 1).to(torch.int32)
        out.append((torch.where(bit > 0, pay[s][entry], 0), bit))
    return out


def multi_spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
               join_keys: Sequence[torch.Tensor],
               join_tables: Sequence[torch.Tensor], join_mults, join_use,
               q_valid, measure_cols: Sequence[torch.Tensor], measure_sel,
               n_groups: int = 1, pred_widths=None, key_widths=None,
               key_refs=None, m_widths=None, m_refs=None,
               n_rows=None, acc=None, probe_groups=None) -> torch.Tensor:
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
    ``m_refs``; ``n_rows`` required when the first measure is packed).
    ``acc``: a (Q, n_groups) int64 grid the sums are added to and which
    is returned, as ``spja``'s.

    ``probe_groups`` (see ``check_probe_groups``): the kernel's lowering,
    one probe a group of streams that one key stream probes against one
    dimension key, through its merged table; each stream's (payload,
    found) then comes from that one probe, and the result is the same
    bits as without it (one probe a stream in its own table)."""
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
    groups = [((j,), None) for j in range(n_joins)] if probe_groups is None \
        else check_probe_groups(probe_groups, join_keys, key_widths, krefs)
    probes = [None] * n_joins
    for streams, merged in groups:
        first = streams[0]
        keys = decode_stream(join_keys[first], key_widths[first],
                             krefs[first], n)
        if merged is None:
            probes[first] = B.block_lookup(keys, join_tables[2 * first],
                                           join_tables[2 * first + 1])
        else:
            for j, got in zip(streams, merged_lookup(keys, *merged)):
                probes[j] = got
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
        return accumulate(torch.zeros((0, n_groups), dtype=torch.int64,
                                      device=device), acc)
    return accumulate(torch.stack(rows), acc)


def check_build(keys: torch.Tensor, vals: torch.Tensor,
                n_slots: int) -> None:
    """Raise unless (keys, vals) can be built into an ``n_slots`` table:
    ``check_build_shape``'s checks, and no key equal to EMPTY (the
    reference's lookups stop at EMPTY and its sequential insert
    overwrites such a key, so no table holds it)."""
    check_build_shape(keys, vals, n_slots)
    if keys.shape[0] and bool((keys == B.EMPTY).any()):
        raise empty_key_error()


def check_build_shape(keys: torch.Tensor, vals: torch.Tensor,
                      n_slots: int) -> None:
    """Raise unless keys and vals are (n,) int32 each and n_slots is a
    power of two up to 2^31 holding every row: ``check_build`` without
    the scan of the keys (the kernel's insert checks them)."""
    n = keys.shape[0]
    for what, t in (("keys", keys), ("vals", vals)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what} must be a 1-D int32 tensor of "
                             f"{n} rows, got {t.dtype} {tuple(t.shape)}")
    if n_slots < 1 or n_slots & (n_slots - 1) or n_slots > 1 << 31:
        raise ValueError(f"n_slots {n_slots} is not a power of 2 up to 2^31")
    if n > n_slots:
        raise ValueError(f"{n} keys do not fit a table of {n_slots} slots")


def empty_key_error() -> ValueError:
    """The error of a build whose keys hold EMPTY, in every mode."""
    return ValueError(f"a key equals EMPTY ({B.EMPTY}), which no "
                      "open-addressing table can hold")


def build(keys: torch.Tensor, vals: torch.Tensor, n_slots: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Open-addressing linear-probe build -> (htk, htv), each (n_slots,)
    int32, EMPTY keys and 0 payloads in free slots: the table that
    inserting the rows one by one in row order gives (each at the first
    EMPTY slot from ``hash_fn(key)``), so a duplicate key's first row is
    found first.

    Vectorised in rounds, the CUDA kernel's rule run in lock step: every
    pending row and every placed row that a pending row contests is a
    candidate at its slot; the lowest row takes the slot and every other
    candidate moves on one slot.  A row then sits past its home only over
    lower rows, which is the sequential layout.  The rounds are the
    longest chain of displacements."""
    check_build(keys, vals, n_slots)
    device = keys.device
    row = torch.full((n_slots,), _INT32_MAX, dtype=torch.int64,
                     device=device)
    pend = torch.arange(keys.shape[0], dtype=torch.int64, device=device)
    slot = B.hash_fn(keys, n_slots)
    while pend.numel():
        at = torch.unique(slot)
        held = row[at]
        placed = held != _INT32_MAX
        cand = torch.cat([pend, held[placed]])
        where = torch.cat([slot, at[placed]])
        best = row.new_full((n_slots,), _INT32_MAX).scatter_reduce_(
            0, where, cand, "amin")
        row[at] = best[at]
        lose = cand != best[where]
        pend, slot = cand[lose], (where[lose] + 1) & (n_slots - 1)
    free = row == _INT32_MAX
    src = torch.where(free, 0, row)
    htk = torch.where(free, B.EMPTY, keys[src] if keys.numel() else 0)
    htv = torch.where(free, 0, vals[src] if vals.numel() else 0)
    return htk.to(torch.int32), htv.to(torch.int32)


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


def int32_bound(v) -> int:
    """A select bound over an int32 column, as an int: an int32 value, or
    ``ValueError``.  The kernels compare in x's type, and no int32 value
    is 2.5 or 2^31, so every mode refuses such a bound alike."""
    try:
        iv = int(v)
    except (OverflowError, ValueError):
        iv = None
    if iv is None or v != iv or not -(1 << 31) <= iv < (1 << 31):
        raise ValueError(f"bound {v!r} is not an int32 value")
    return iv


def _bounds(x: torch.Tensor, lo, hi):
    """The select bounds as the kernels take them: ``int32_bound``s over
    an int32 x; as given otherwise (compared in x's type: f32 rounding
    for a float32 x)."""
    if x.dtype == torch.int32:
        return int32_bound(lo), int32_bound(hi)
    return lo, hi


def select_scan_sparse(x: torch.Tensor, y: torch.Tensor, lo, hi
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_scan`` in two phases (the paper's selective load, §5.3):
    phase 1 reads x alone and marks the ``SKIP_ROWS``-row tiles that hold
    a match; phase 2 compacts only the marked tiles, reading y only there.
    The result is ``select_scan``'s, bit for bit, whatever the unit."""
    n, unit = x.shape[0], SKIP_ROWS
    lo, hi = _bounds(x, lo, hi)
    hit = B.block_pred_range(x, lo, hi) > 0
    pad = (-n) % unit
    tiles = torch.nn.functional.pad(hit, (0, pad)).view(-1, unit)
    marked = tiles.any(1).nonzero().squeeze(1)
    rows = (marked[:, None] * unit + torch.arange(
        unit, device=x.device)).reshape(-1)
    rows = rows[rows < n]
    rows = rows[hit[rows]]
    out = torch.zeros_like(y)
    out[:rows.shape[0]] = y[rows]
    return out, torch.tensor(rows.shape[0], dtype=torch.int64,
                             device=x.device)


def select_scan(x: torch.Tensor, y: torch.Tensor, lo, hi
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count): the selected
    entries of y in row order, then zeros.  Runs on the tensors' own
    device with no host round trip.  Over an int32 x a bound that is not
    an int32 value raises ``ValueError``, as the kernel does."""
    lo, hi = _bounds(x, lo, hi)
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
              n_groups: int, acc=None) -> torch.Tensor:
    """SUM(vals) GROUP BY group_ids -> (n_groups,) in vals' dtype (f32 or
    int32).  int32 sums wrap as the reference's int32 accumulator does
    (summed in int64, cut to int32); f32 sums are taken in f64 and
    rounded to f32 once, so integer-valued f32 sums are exact.  An id
    outside [0, n_groups) is dropped.  ``acc``: a running grid of
    ``group_acc_dtype`` the sums are added to unrounded (f64) or wrapping
    (int32); it is returned."""
    wide = torch.float64 if vals.is_floating_point() else torch.int64
    live = torch.ones(group_ids.shape, dtype=torch.int32,
                      device=group_ids.device)
    sums = B.block_group_aggregate(group_ids, vals.to(wide), live, n_groups)
    if acc is None:
        return sums.to(vals.dtype)
    check_acc(acc, (n_groups,), vals.device, group_acc_dtype(vals))
    if vals.is_floating_point():
        return acc.add_(sums)
    return acc.copy_((acc.to(torch.int64) + sums).to(torch.int32))


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


def digit_counts(keys: torch.Tensor, start_bit: int, r: int,
                 passes: int = 1) -> torch.Tensor:
    """Global bucket counts of ``passes`` passes of r bits from
    ``start_bit`` -> (passes, 2^r) int32: row p counts the keys' buckets
    at bits [start_bit + p·r, + r), the column sums of that pass's
    ``histogram``."""
    return torch.stack([
        torch.bincount(bucket_of(keys, start_bit + p * r, r),
                       minlength=1 << r) for p in range(passes)]).to(
                           torch.int32)


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
