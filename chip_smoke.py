#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # SF 20, the paper's scale (§5.1)

Phases, each printing what it found; any failure raises, and the script
exits non-zero without printing a result:

1. card:   name and power limit, as nvidia-smi reports them;
2. build:  every CUDA kernel of the port, compiled from the repo's
           sources with nvcc, one process per source, all at once;
3. kernel vs plain: each kernel against its plain version on the card on
           synthetic inputs from a seed — bit-identical, except the
           sigmoid (rtol 1e-6) and non-integer f32 group sums (two runs
           identical, within one f32 ulp of the plain version); the
           packed kernels at every packed width, with ragged n,
           frame-of-reference keys and measures and sign-bit words;
4. main path: ``ssb.generate(sf=20)`` (120 M lineorder rows), resident
           on the card, all 13 SSB queries through
           ``compile_plan(plan, "fused").execute(db, cache=...)``: 13
           kernel launches per pass, every result bit-identical to the
           numpy oracle, to the plain version on the card and to a second
           pass; then per-query times beside the least time the card
           could take for the work this data needs (``must_move``);
5. second path: the same 13 queries through ``compile_plan(plan,
           "opat")`` on the same resident database and hash cache — one
           launch of ``select_scan`` per fact predicate, ``probe_join``
           per join, ``project`` per ``sub`` measure and ``group_sum`` per
           query; every result bit-identical to phase 4's oracle and fused
           results, to a second pass and to the plain versions on the
           card; then per-query times beside fused (the fig17 analogue)
           and each kernel's time over one pass beside its bound;
6. packed storage: phase 4's database packed (``storage.pack_database``)
           and resident on the card, the 13 queries ``fused`` (``spja`` on
           packed streams) and ``opat`` (the leading filter through
           ``select_scan_packed``) through the same hash cache — every
           build a hit, every result bit-identical to phase 4's oracle
           and fused results, a second pass and the plain versions on
           the card, launches checked against the plans; per-query
           packed times beside phase 4's plain ones and the packed bound;
           ``select_scan_packed`` over one pass and ``unpack`` of every
           packed column (bit-identical to the resident plain column)
           beside their bounds;
7. partitioned join: the 13 queries through ``compile_plan(plan,
           "part")`` and ``"part_loop"`` on phase 4's database and on
           phase 6's packed one, through the same hash cache — per join,
           ``part`` launches one ``histogram``, one ``partition_multi``
           scatter and one ``part_probe``, ``part_loop`` one histogram,
           one scatter and one ``probe_join`` per non-empty partition;
           every result bit-identical to phase 4's oracle, a second pass
           and the plain versions on the card; per-query times beside
           fused and opat, each new kernel's time over one pass beside
           its bound; then the Fig. 8 analogue, one FK join of 2^27 fact
           rows against dims of 2^12 to 2^24 rows, through fused, opat,
           part and part_loop, each against the oracle;
8. ORDER BY: ``engine.order_by`` of lineorder by ``lo_orderdate`` (four
           8-bit radix passes) against numpy's stable argsort, and a
           filter + join + ``OrderBy`` row plan against numpy's stable
           argsort of its survivors; ``radix_sort`` timed beside its bound
           and ``torch.sort(stable=True)``.

The line before the last lists every kernel of every path as JSON; the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory, published peak
SEGMENT = 64                    # bytes of one device-memory access
F32_OPS_PER_S = 67e12           # published float32 rate outside tensor cores
# int32 ALU peak of an H100 SXM: 132 SMs x 64 int32 lanes x 1.98 GHz =
# 16.7 TOP/s, a quarter of the published 67 TFLOP/s float32 rate (128
# float32 lanes, an FMA counted as 2)
INT32_OPS_PER_S = F32_OPS_PER_S / 4
SF = 20                         # the paper's scale factor (§5.1)
SEED = 20
QUERY_REPS = 5                  # end-to-end runs per query (median)
KERNEL_REPS = 10                # back-to-back launches per timing
PLAIN_REPS = 2
CALL_REPS = 3                   # back-to-back launches per opat call
KERNEL = {"name": "ssb_fused.spja", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/ssb_fused.cu",
          "replaces": "src/repro/kernels/ssb_fused.py:115"}
# the opat path's kernels: (wrapper module, function, CUDA source,
# the Pallas kernel it replaces)
OPAT = [("select_scan", "select_scan", "select_scan.cu",
         "src/repro/kernels/select_scan.py:52"),
        ("hash_join", "probe_join", "hash_join.cu",
         "src/repro/kernels/hash_join.py:193"),
        ("project", "project", "project.cu",
         "src/repro/kernels/project.py:33"),
        ("agg", "group_sum", "agg.cu", "src/repro/kernels/agg.py:80")]
# the packed kernels: (wrapper module, function, its launch counter, CUDA
# source, the Pallas kernel it replaces)
PACKED = [("select_scan", "select_scan_packed", "PACKED_LAUNCHES",
           "select_scan.cu", "src/repro/kernels/select_scan.py:219"),
          ("unpack", "unpack", "LAUNCHES", "unpack.cu",
           "src/repro/kernels/unpack.py:30")]
# the partitioned join's and ORDER BY's kernels, the same fields
PARTITIONED = [
    ("radix_part", "histogram", "HIST_LAUNCHES", "radix_part.cu",
     "src/repro/kernels/radix_part.py:52"),
    ("radix_part", "partition_multi", "SCATTER_LAUNCHES", "radix_part.cu",
     "src/repro/kernels/radix_part.py:111"),
    ("part_probe", "part_probe", "LAUNCHES", "part_probe.cu",
     "src/repro/kernels/part_probe.py:94")]
PART_N = 2_000_003              # rows of the synthetic partitioned probes
# the Fig. 8 analogue (benchmarks/run.py::_fig8_db's shape): 2^27 fact
# rows, FK uniform over a dim of 2^12 .. 2^24 rows (the last a 256 MB
# table, past the 50 MB L2)
FIG8_FACT = 1 << 27
FIG8_DIMS = (1 << 12, 1 << 16, 1 << 20, 1 << 24)
STRATEGIES = ("fused", "opat", "part", "part_loop")

# (label, cases.spja_case arguments): what SSB data never shows — a
# ragged tail, an empty build side, duplicate and wrapping keys, group ids
# past the grid, n_groups 1 and 7000, each measure op
SYNTHETIC = [
    ("ragged n, 3 preds, mul, 1 group",
     dict(n=10_000_019, n_preds=3, n_joins=0, measure_op="mul",
          n_groups=1)),
    ("7000 groups, duplicate + wrapping keys",
     dict(n=4_000_037, n_preds=0, n_joins=3, measure_op="first",
          n_groups=7000, duplicates=True, wrap=True, build_rows=20_000)),
    ("empty build side (all-EMPTY 16 slots), sub",
     dict(n=1_000_003, n_preds=1, n_joins=2, measure_op="sub",
          n_groups=100, empty_join=True)),
    ("3 preds + 4 joins, sub, 800 groups",
     dict(n=2_000_001, n_preds=3, n_joins=4, measure_op="sub",
          n_groups=800, duplicates=True)),
    ("joins into 1 group (ids past the grid dropped)",
     dict(n=999_999, n_preds=0, n_joins=2, measure_op="first",
          n_groups=1)),
    ("n = 37, less than a warp",
     dict(n=37, n_preds=2, n_joins=1, measure_op="mul", n_groups=4)),
    ("6 preds + 5 joins, past SSB, within the kernel's 8 + 8",
     dict(n=3_000_017, n_preds=6, n_joins=5, measure_op="mul",
          n_groups=243, duplicates=True, wrap=True)),
]
BIG = 10_000_019                # a ragged n past every tile and grid size
# (label, cases.packed_spja_case arguments): packed predicates at every
# width, frame-of-reference keys and measures (SSB data packs with
# reference 0 only), n not a multiple of a word's values
PACKED_SPJA = [
    (f"packed preds at {phys} bits, 2 joins, sub, 100 groups",
     dict(n=BIG, n_preds=3, n_joins=2, measure_op="sub", n_groups=100,
          pred_phys=phys, duplicates=True, wrap=True))
    for phys in (1, 2, 4, 8, 16)] + [
    ("packed, 7000 groups, small measures at 8 and 4 bits, mul",
     dict(n=4_000_037, n_preds=1, n_joins=3, measure_op="mul",
          n_groups=7000, pred_phys=16, small=True)),
    ("packed, n = 37", dict(n=37, n_preds=2, n_joins=1, measure_op="first",
                            n_groups=4, pred_phys=2)),
]
# fn -> [(label, cases generator, its arguments, extra positional call
# arguments, sigmoid)]
OPAT_SYNTHETIC = {
    "select_scan": [
        (f"{sel} {dtype}, n={n}", "select_case", (n, n, sel, dtype), (),
         False)
        for n, sel, dtype in ((BIG, "mid", "int32"), (BIG, "none", "int32"),
                              (BIG, "all", "int32"),
                              (BIG, "mid", "float32"), (37, "mid", "int32"))],
    "probe_join": [
        (f"{kind}, n={n}", "probe_case", (n, n, kind), (), False)
        for n, kind in ((BIG, "duplicate_wrap"), (1_000_003, "empty"),
                        (1_000_003, "misses"), (37, "duplicate_wrap"))],
    "project": [
        (f"a={a} b={b} sigmoid={sig}, n={n}", "project_case", (n, n),
         (a, b), sig)
        for n in (BIG, 37) for sig in (False, True)
        for a, b in ((1.0, -1.0), (0.75, -1.25))],
    "group_sum": [
        (f"{kind}, {g} groups, n={BIG}", "group_case",
         (g, BIG, g, kind, True), (), False)
        for kind in ("int32_overflow", "f32_integers", "f32_random")
        for g in (1, 7000)],
    "select_scan_packed": [
        (f"{sel} at {phys} bits, n={n}", "select_packed_case",
         (n + phys, n, phys, sel), (), False)
        for n, phys, sel in [(BIG, p, "mid") for p in (1, 2, 4, 8, 16)] +
        [(BIG, 4, "none"), (BIG, 16, "all"), (37, 2, "mid")]],
    "unpack": [
        (f"{phys} bits, ref {r}, n={n}", "unpack_case", (n + phys, n, phys, r),
         (), False)
        for n, phys, r in [(BIG, p, r) for p in (1, 2, 4, 8, 16)
                           for r in (0, -5000)] + [(37, 4, 1 << 20)]],
}


def phase(title: str) -> float:
    print(f"== {title}", flush=True)
    return time.perf_counter()


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls after
    one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def segment_bytes(touched: torch.Tensor, rows_per_segment: int = 16) -> int:
    """Bytes of the 64-byte segments of a stream that hold at least one
    touched row: 16 rows a segment for an int32 column, 16·c for a column
    packed c values a word."""
    per = rows_per_segment
    pad = torch.nn.functional.pad(touched, (0, (-touched.shape[0]) % per))
    return SEGMENT * int(pad.view(-1, per).any(dim=1).sum())


def probe_walk(keys: torch.Tensor, htk: torch.Tensor):
    """Each key's linear probe as the kernel walks it: (hit slot or -1,
    slots visited, probe steps taken).  ``htk`` is one ``(S,)`` table, or
    the packed ``(P, S)`` tables of a partitioned join, where a key walks
    row ``key & (P - 1)``; slots are then flat indices into them."""
    from repro_torch.core import blocks
    n_parts, n_slots = (1, htk.shape[0]) if htk.dim() == 1 else htk.shape
    flat = htk.reshape(-1)
    hit_slot = torch.full(keys.shape, -1, dtype=torch.int64,
                          device=keys.device)
    visited = torch.zeros(flat.shape[0], dtype=torch.bool,
                          device=keys.device)
    lanes = torch.arange(keys.shape[0], device=keys.device)
    base = (keys.to(torch.int64) & (n_parts - 1)) * n_slots
    want, slot, steps = keys, blocks.hash_fn(keys, n_slots), 0
    for _ in range(n_slots):
        if lanes.numel() == 0:
            break
        at = base + slot
        visited[at] = True
        steps += lanes.numel()
        k_at = flat[at]
        hit = k_at == want
        hit_slot[lanes[hit]] = at[hit]
        walking = ~(hit | (k_at == blocks.EMPTY))
        lanes, want, base = lanes[walking], want[walking], base[walking]
        slot = (slot[walking] + 1) & (n_slots - 1)
    return hit_slot, visited, steps


def mean_probe(htk: torch.Tensor) -> float:
    """Mean slots a hit walks in a linear-probe table, over its keys: each
    occupied slot's distance from its key's home slot, plus one.  ``htk``
    is one ``(S,)`` table or packed ``(P, S)`` tables (a key's home is in
    its own row).  It is the mean probe length of a lookup when every
    build key is probed alike."""
    from repro_torch.core import blocks
    rows = htk.reshape(-1, htk.shape[-1])
    n_slots = rows.shape[1]
    used = rows != blocks.EMPTY
    if not bool(used.any()):
        return 0.0
    at = torch.arange(n_slots, device=rows.device)
    walk = ((at - blocks.hash_fn(rows, n_slots)) & (n_slots - 1)) + 1
    return float(walk[used].double().mean())


def must_move(spja_args, n_groups: int, pred_widths=None, key_widths=None,
              key_refs=None, m_widths=None, m_refs=None, n_rows=None,
              measure_op=None) -> dict:
    """What one ``spja`` call needs on this data, for its bound.

    Bytes: the kernel loads a row's next column only while the row is
    live (predicates in order, then join keys, then measures), so each
    column costs the 64-byte segments that hold a live row when it is
    first read (the first column in full); a column packed c values a
    word holds 16·c rows a segment.  Each table costs the segments of the
    slots its probes visit (keys) or hit (payloads); the output is
    (n_groups,) f32.  Operations: 2 compares per predicate and live row, 4
    per probe step (multiply, mask, 2 compares), 2 per hit (group
    multiply-add), 2 per summed row (measure op and add), and 2 per value
    decoded from a packed stream (shift, mask)."""
    from repro_torch.kernels import ref
    pred_cols, bounds, join_keys, tables, mults, m1, m2 = spja_args
    n = m1.shape[0] if n_rows is None else int(n_rows)
    n_meas = 1 if m2 is None else 2
    pred_widths = ref.stream_widths(pred_widths, len(pred_cols))
    key_widths = ref.stream_widths(key_widths, len(join_keys))
    m_widths = ref.stream_widths(m_widths, n_meas)
    key_refs = ref.refs_list(key_refs, len(join_keys))
    m_refs = ref.refs_list(m_refs, n_meas)
    live = torch.ones(n, dtype=torch.bool, device=m1.device)
    seen, fact, table, ops = set(), 0, 0, 0

    def read(col, width, r=0):
        """The stream's values; counts its bytes on its first read."""
        nonlocal fact, ops
        if col.data_ptr() not in seen:
            seen.add(col.data_ptr())
            fact += segment_bytes(live, 16 * (32 // width))
            if width != 32:
                ops += 2 * int(live.sum())
        return ref.decode_stream(col, width, r, n)

    for col, w, (lo, hi) in zip(pred_cols, pred_widths,
                                ref.bounds_list(bounds, len(pred_cols))):
        vals = read(col, w)
        ops += 2 * int(live.sum())
        live &= (vals >= lo) & (vals <= hi)
    group = torch.zeros(n, dtype=torch.int64, device=m1.device)
    for j, (col, w, mult) in enumerate(
            zip(join_keys, key_widths, ref.mults_list(mults, len(join_keys)))):
        keys = read(col, w, key_refs[j])
        htk, htv = tables[2 * j], tables[2 * j + 1]
        rows = live.nonzero().squeeze(1)
        slot, visited, steps = probe_walk(keys[rows], htk)
        hit = slot >= 0
        hit_slots = torch.zeros_like(visited)
        hit_slots[slot[hit]] = True
        table += segment_bytes(visited) + segment_bytes(hit_slots)
        ops += 4 * steps + 2 * int(hit.sum())
        live[rows] = hit
        group[rows[hit]] += htv[slot[hit]].to(torch.int64) * mult
    live &= (group & 0xFFFFFFFF) < n_groups     # the kernel's uint32 test
    read(m1, m_widths[0], m_refs[0])
    if m2 is not None:
        read(m2, m_widths[1], m_refs[1])
    ops += 2 * int(live.sum())
    moved = fact + table + 4 * n_groups
    return {"fact_bytes": fact, "table_bytes": table, "bytes": moved,
            "ops": ops, "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT32_OPS_PER_S * 1e3}


def call_rows(fn: str, args: tuple) -> int:
    """The rows one call of a kernel other than ``spja`` works on."""
    if fn == "select_scan_packed":
        return args[1].shape[0]
    if fn == "unpack":
        return int(args[1])
    return args[0].shape[0]


def opat_need(fn: str, args: tuple, out) -> dict:
    """What one call of an opat kernel needs on its inputs, for its
    bound: each input read once and each output written once, and the
    operations of the function in the inputs' type.

    select_scan: x and y read (8n), the selected entries written (4 per
    selected row), 2 compares a row.  probe_join: keys and vals read
    (8n), payload and val written per found row (8), the 64-byte table
    segments the probes visit (keys) or hit (payloads), 4 operations per
    probe step.  project: 12n bytes, 3 f32 operations a row.  group_sum:
    ids and vals read (8n), the (n_groups,) sums written in the values'
    type (4 bytes a group), an add a row (in the values' type, f32 on the
    path).  select_scan_packed: the packed words and y read (4 bytes a
    word, 4 a row), the selected entries written, 4 operations a row
    (shift, mask, 2 compares).  unpack: the words read and the n values
    written, 3 operations a value (shift, mask, add).

    histogram: the keys read (4n) and the (tiles, 2^r) counts written, 3
    operations a row (shift, mask, add).  partition_multi: the key and N
    payload columns read and written ((1 + N)·8 bytes a row) and the
    histogram read, 3 operations a row (shift, mask, position add).
    part_probe: the rowid of each row before the runs' end read (4), the
    key and group of each live one (rowid >= 0; 8), the 64-byte table
    segments its probes visit (keys) or hit (payloads), the offs and
    counts, and rowid and group written per match (8); 4 operations per
    probe step and 2 per match (group multiply-add)."""
    n = call_rows(fn, args)
    if fn == "select_scan_packed":
        count = int(out[1])
        moved = 4 * args[0].shape[0] + 4 * n + 4 * count
        ops, rate = 4 * n, INT32_OPS_PER_S
    elif fn == "unpack":
        moved = 4 * -(-n // (32 // args[2])) + 4 * n
        ops, rate = 3 * n, INT32_OPS_PER_S
    elif fn == "select_scan":
        count = int(out[1])
        moved, ops, rate = 8 * n + 4 * count, 2 * n, INT32_OPS_PER_S
    elif fn == "probe_join":
        count = int(out[2])
        slot, visited, steps = probe_walk(args[0], args[2])
        hit = torch.zeros_like(visited)
        hit[slot[slot >= 0]] = True
        moved = 8 * n + 8 * count + segment_bytes(visited) + \
            segment_bytes(hit)
        ops, rate = 4 * steps, INT32_OPS_PER_S
    elif fn == "project":
        moved, ops, rate = 12 * n, 3 * n, F32_OPS_PER_S
    elif fn == "group_sum":
        moved, ops = 8 * n + args[1].element_size() * args[2], n
        rate = F32_OPS_PER_S if args[1].is_floating_point() \
            else INT32_OPS_PER_S
    elif fn == "histogram":
        tiles = -(-n // 2048)
        moved, ops, rate = 4 * n + 4 * tiles * (1 << args[2]), 3 * n, \
            INT32_OPS_PER_S
    elif fn == "partition_multi":
        tiles = -(-n // 2048)
        moved = (1 + len(args[1])) * 8 * n + 4 * tiles * (1 << args[3])
        ops, rate = 3 * n, INT32_OPS_PER_S
    elif fn == "part_probe":
        keys, rowids, _, offs, counts, htk = args[:6]
        end = min(n, int(offs[-1]) + int(counts[-1])) if offs.numel() else 0
        live = (rowids[:end] >= 0).nonzero().squeeze(1)
        count = int(out[2])
        slot, visited, steps = probe_walk(keys[live], htk)
        hit = torch.zeros_like(visited)
        hit[slot[slot >= 0]] = True
        moved = 4 * end + 8 * live.numel() + segment_bytes(visited) + \
            segment_bytes(hit) + 8 * offs.numel() + 8 * count
        ops, rate = 4 * steps + 2 * count, INT32_OPS_PER_S
    else:
        raise ValueError(f"no bound for {fn!r}")
    return {"bytes": moved, "ops": ops,
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / rate * 1e3}


def library_call(fn: str):
    """One PyTorch call computing the same function on the same inputs,
    timed beside the kernel and used nowhere in the port; None where
    there is none."""
    if fn == "group_sum":
        return lambda ids, vals, n_groups: torch.zeros(
            (n_groups,), dtype=vals.dtype, device=vals.device).index_add_(
                0, ids, vals)
    if fn == "project":
        def sub(x1, x2, a, b, sigmoid=False):
            if (a, b, sigmoid) != (1.0, -1.0, False):
                raise ValueError("torch.sub computes only a=1, b=-1")
            return torch.sub(x1, x2)
        return sub
    return None


def outputs(got) -> tuple:
    """A kernel's outputs as one flat tuple of tensors."""
    if not isinstance(got, tuple):
        return (got,)
    return tuple(t for g in got for t in outputs(g))


def check_against_plain(fn: str, label: str, got, want, again=None,
                        sigmoid: bool = False) -> float:
    """Hold a kernel's outputs against its plain version's (``again``: a
    second run, for the f32 group sums); returns the largest absolute
    difference."""
    err = 0.0
    for g, w in zip(outputs(got), outputs(want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{fn} {label}: {g.dtype} {tuple(g.shape)}"
                                 f" vs plain {w.dtype} {tuple(w.shape)}")
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    if sigmoid:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    elif fn == "group_sum" and got.is_floating_point() and again is not None:
        if not torch.equal(again, got):
            raise AssertionError(f"{fn} {label}: two runs differ")
        ulp = (torch.nextafter(want, torch.full_like(want, float("inf")))
               - want).abs()
        if not bool(((got - want).abs() <= ulp).all()):
            raise AssertionError(f"{fn} {label}: more than 1 ulp from plain")
    elif not all(torch.equal(g, w)
                 for g, w in zip(outputs(got), outputs(want))):
        raise AssertionError(f"{fn} {label}: kernel != plain, "
                             f"max |err| {err}")
    return err


# device kernels by name: the port's own (by the wrapper that launches
# them) and PyTorch's glue around them; first match wins
DEVICE_KINDS = [("select_count", "select_scan"),
                ("select_scatter", "select_scan"),
                ("probe_count", "probe_join"), ("probe_scatter", "probe_join"),
                ("scan_tiles", "select_scan/probe_join tile scan"),
                ("group_sum", "group_sum"), ("reduce_partials", "group_sum"),
                ("project_kernel", "project"), ("spja_kernel", "spja"),
                ("arange", "torch arange"), ("index", "torch gather"),
                ("copy", "torch copy/cast"), ("Fill", "torch zeros"),
                ("Memcpy", "copy to host")]


def profiled(run) -> dict:
    """Device time by kind over one call of ``run`` under torch.profiler,
    the kernels behind each kind (name cut to 96 characters, launches,
    ms; the three longest), and the device's busy share of the wall time
    (a lower bound: the profiler adds host time per operation)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for sub, k in DEVICE_KINDS if sub in e.name), "other")
        ms = e.device_time / 1e3
        kinds[kind] = kinds.get(kind, 0.0) + ms
        calls, total = names.setdefault(kind, {}).get(e.name[:96], (0, 0.0))
        names[kind][e.name[:96]] = (calls + 1, total + ms)
    busy = sum(kinds.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"device_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "kernels": {kind: sorted(([name, *v] for name, v in by.items()),
                                     key=lambda r: -r[2])[:3]
                        for kind, by in names.items()},
            "busy_ms": busy, "wall_ms": wall_ms, "busy_share": busy / wall_ms}


@contextlib.contextmanager
def nonempty_partitions(radix):
    """Within the block, every ``radix.histogram`` call appends to the
    yielded list the number of buckets its rows fill: the partitions
    ``part_loop`` probes."""
    real, seen = radix.histogram, []

    def recorded(keys, start_bit, r):
        hist = real(keys, start_bit, r)
        seen.append(int((hist.sum(0) > 0).sum()))
        return hist
    radix.histogram = recorded
    try:
        yield seen
    finally:
        radix.histogram = real


def fig8_db(ssb, rng: np.random.Generator, n_dim: int,
            revenue: np.ndarray):
    """``benchmarks/run.py::_fig8_db``'s star join: a fact FK uniform over
    a dim of ``n_dim`` rows with payload ``p_group = key % 64``."""
    i32 = np.int32
    fact = ssb.Table("lineorder", {
        "lo_partkey": rng.integers(0, n_dim, revenue.shape[0], dtype=i32),
        "lo_revenue": revenue})
    dim = ssb.Table("part", {"p_partkey": np.arange(n_dim, dtype=i32),
                             "p_group": np.arange(n_dim, dtype=i32) % 64})
    stub = ssb.Table("stub", {"x": np.zeros(1, i32)})
    return ssb.Database(fact, stub, stub, stub, dim, sf=0.0)


def query_ms(q, database, cache) -> list:
    """Host times of QUERY_REPS runs of one compiled query, each from a
    synchronised start to its result on the host."""
    times = []
    for _ in range(QUERY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q.execute(database, cache=cache)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class Timed:
    """Stands in for a kernel wrapper for one timed pass: each call runs
    the wrapper CALL_REPS times back to back between CUDA events (after
    one warm-up call), then the plain version and the library call on the
    same inputs, and keeps the times and the call's bound."""

    def __init__(self, mod, fn: str, plain):
        self.mod, self.fn, self.plain = mod, fn, plain
        self.kernel = getattr(mod, fn)
        self.library = library_call(fn)
        self.rows, self.err = [], 0.0

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        ms = event_ms(lambda: self.kernel(*args, **kw), CALL_REPS)
        want = self.plain(*args, **kw)
        plain_ms = event_ms(lambda: self.plain(*args, **kw), 1)
        again = self.kernel(*args, **kw) if self.fn == "group_sum" else None
        self.err = max(self.err, check_against_plain(
            self.fn, "opat pass", out, want, again=again,
            sigmoid=kw.get("sigmoid", False)))
        lib_ms = (None if self.library is None else
                  event_ms(lambda: self.library(*args, **kw), CALL_REPS))
        self.rows.append(dict(opat_need(self.fn, args, out),
                              n=call_rows(self.fn, args), ms=ms,
                              plain_ms=plain_ms,
                              library_ms=lib_ms))
        return out

    def __enter__(self):
        setattr(self.mod, self.fn, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.fn, self.kernel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cases
    from repro_torch.kernels import build, ref, ssb_fused
    from repro_torch.sql import engine, hashtable, ssb, storage
    from repro_torch.sql import model as M
    from repro_torch.sql import plan as P
    from repro_torch.sql.compile import SORT_BITS, compile_plan, fused_inputs
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, *_ in OPAT + PACKED + PARTITIONED}

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1 card")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    t = phase("2 build")
    names = build.names()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(build.build, names)))
    for name in names:
        print(build.library_path(name).relative_to(ROOT))
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")
    for mod in (ssb_fused, *mods.values()):
        mod.library()
    print(f"build_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase("3 kernel vs plain (synthetic, bit-identical)")
    max_err = packed_err = 0.0
    spja_cases = [(label, kw, cases.spja_case) for label, kw in SYNTHETIC] + \
        [(label, kw, cases.packed_spja_case) for label, kw in PACKED_SPJA]
    for i, (label, kw, make) in enumerate(spja_cases):
        c = make(1000 + i, **kw)
        a, k = c.args(dev)
        before = ssb_fused.LAUNCHES
        got = ssb_fused.spja(*a, **k)
        if ssb_fused.LAUNCHES != before + 1:
            raise AssertionError(f"{label}: the kernel did not launch")
        want = ref.spja(*a, **k)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if c.packed:
            packed_err = max(packed_err, err)
        else:
            max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain, max |err| {err}")
        nonzero = int((got != 0).sum())
        if kw.get("empty_join") and nonzero:
            raise AssertionError(f"{label}: an empty build side must give 0")
        if not kw.get("empty_join") and not nonzero:
            raise AssertionError(f"{label}: vacuous case, all groups zero")
        print(f"{label}: n={c.n} n_groups={c.n_groups} nonzero={nonzero} "
              f"max_abs_err={err} ok", flush=True)
    opat_err = {}
    for m, fn, counter, *_ in [(m, fn, "LAUNCHES") for m, fn, *_ in OPAT] + \
            PACKED:
        opat_err[fn] = 0.0
        for label, gen, gen_args, extra, sigmoid in OPAT_SYNTHETIC[fn]:
            args = cases.tensors(getattr(cases, gen)(*gen_args), dev) + extra
            kw = {"sigmoid": sigmoid} if fn == "project" else {}
            before = getattr(mods[m], counter)
            got = getattr(mods[m], fn)(*args, **kw)
            if getattr(mods[m], counter) != before + 1:
                raise AssertionError(f"{fn} {label}: the kernel did not "
                                     "launch")
            again = getattr(mods[m], fn)(*args) if fn == "group_sum" \
                else None
            want = getattr(ref, fn)(*args, **kw)
            torch.cuda.synchronize()
            err = check_against_plain(fn, label, got, want, again, sigmoid)
            opat_err[fn] = max(opat_err[fn], err)
            what = (f"count={int(got[-1])}" if isinstance(got, tuple)
                    else f"nonzero={int((got != 0).sum())}")
            print(f"{fn} {label}: {what} max_abs_err={err} ok", flush=True)
    radix, pprobe = mods["radix_part"], mods["part_probe"]
    part_err = {fn: 0.0 for _, fn, *_ in PARTITIONED}

    def held(fn, label, got, again, want):
        """A radix-slice kernel against its plain version and its own
        second run, bit for bit."""
        if not all(torch.equal(a, b) for a, b in
                   zip(outputs(got), outputs(again))):
            raise AssertionError(f"{fn} {label}: two runs differ")
        part_err[fn] = max(part_err[fn],
                           check_against_plain(fn, label, got, want))

    for i, (start_bit, r, kind, n_vals) in enumerate(cases.RADIX_CASES):
        for n in (BIG, 37):
            keys, vals, _, _ = cases.tensors(cases.radix_case(
                3000 + i, n, start_bit, r, kind, n_vals), dev)
            label = f"{kind}, bits {start_bit}+{r}, {n_vals} payloads, n={n}"
            before = (radix.HIST_LAUNCHES, radix.SCATTER_LAUNCHES)
            hist = radix.histogram(keys, start_bit, r)
            again = radix.histogram(keys, start_bit, r)
            held("histogram", label, hist, again,
                 ref.histogram(keys, start_bit, r))
            got = radix.partition_multi(keys, vals, start_bit, r, hist=hist)
            again = radix.partition_multi(keys, vals, start_bit, r)
            held("partition_multi", label, got, again,
                 ref.partition_multi(keys, vals, start_bit, r))
            if (radix.HIST_LAUNCHES, radix.SCATTER_LAUNCHES) != \
                    (before[0] + 3, before[1] + 2):
                raise AssertionError(f"radix {label}: the kernels did not "
                                     "launch as called")
            print(f"histogram + partition_multi {label}: buckets filled "
                  f"{int((hist.sum(0) > 0).sum())} ok", flush=True)
    keys, (vals,), _, _ = cases.tensors(
        cases.radix_case(3100, BIG, 0, 1, "negative", 1), dev)
    got = radix.radix_sort(keys, vals)
    held("partition_multi", f"radix_sort, negative keys, n={BIG}", got,
         radix.radix_sort(keys, vals), ref.radix_sort(keys, vals))
    print(f"radix_sort negative keys n={BIG}: unsigned order ok", flush=True)
    for kind in cases.PART_PROBE_KINDS:
        for bits, n in ((1, PART_N), (4, PART_N), (8, PART_N), (4, 37)):
            args = cases.tensors(cases.part_probe_case(3200 + bits, n, bits,
                                                       kind), dev)
            before = pprobe.LAUNCHES
            got = pprobe.part_probe(*args)
            if pprobe.LAUNCHES != before + 1:
                raise AssertionError(f"part_probe {kind}: the kernel did "
                                     "not launch")
            label = f"{kind}, P={1 << bits}, n={n}"
            held("part_probe", label, got, pprobe.part_probe(*args),
                 ref.part_probe(*args))
            print(f"part_probe {label}: count={int(got[2])} ok", flush=True)
    print(f"phase3_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase(f"4 main path: 13 SSB queries, fused, SF {SF}")
    t0 = time.perf_counter()
    db = ssb.generate(sf=SF, seed=SEED)
    print(f"generate_s {time.perf_counter() - t0:.3f} "
          f"lineorder_rows {db.lineorder.n_rows} "
          f"columns {len(db.lineorder.columns)}")
    t0 = time.perf_counter()
    db.to(dev)
    torch.cuda.synchronize()
    print(f"upload_s {time.perf_counter() - t0:.3f} resident_GB "
          f"{db.lineorder.resident_bytes(dev) / 1e9:.3f}", flush=True)
    queries = engine.ssb_queries()
    cache = hashtable.HashTableCache()

    def run_pass(mode="auto", database=db):
        out, launches = {}, {}
        for name, plan in queries.items():
            before = ssb_fused.LAUNCHES
            out[name] = compile_plan(plan, "fused").execute(
                database, mode=mode, cache=cache)
            launches[name] = ssb_fused.LAUNCHES - before
        return out, launches

    ssb_fused.LAUNCHES = 0
    first, launches = run_pass()
    main_launches = ssb_fused.LAUNCHES
    if main_launches != len(queries) or set(launches.values()) != {1}:
        raise AssertionError(f"expected one launch per query, got {launches}")
    ssb_fused.LAUNCHES = 0
    second, _ = run_pass()
    if ssb_fused.LAUNCHES != len(queries):
        raise AssertionError(f"second pass launched {ssb_fused.LAUNCHES}")
    plain, plain_launches = run_pass(mode="ref")
    if set(plain_launches.values()) != {0}:
        raise AssertionError("mode='ref' launched the kernel")
    t0 = time.perf_counter()
    oracle = {name: engine.run_query_oracle(db, plan)
              for name, plan in queries.items()}
    oracle_s = time.perf_counter() - t0
    for name in queries:
        for other, what in ((second[name], "second pass"),
                            (plain[name], "plain version on the card"),
                            (oracle[name], "numpy oracle")):
            if not same_bits(first[name], other):
                diff = np.abs(first[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name}: differs from the {what} "
                                     f"(max |diff| {diff})")
        max_err = max(max_err, float(np.abs(
            first[name].astype(np.float64) - plain[name]).max()))
    print(f"launches_per_pass {main_launches} bit-identical: second pass, "
          f"plain on card, oracle (oracle_s {oracle_s:.3f}) "
          f"cache hits {cache.hits} misses {cache.misses}", flush=True)

    def fused_row(name, plan, database, launched, result):
        """One query's fused times, on this database, beside its bound."""
        times = query_ms(compile_plan(plan, "fused"), database, cache)
        a, k = fused_inputs(plan, database, cache, dev)
        kernel_ms = event_ms(functools.partial(ssb_fused.spja, *a, **k),
                             KERNEL_REPS)
        plain_ms = event_ms(functools.partial(ref.spja, *a, **k),
                            PLAIN_REPS)
        streams = {s.data_ptr(): s for s in [*a[0], *a[2], a[5]] + (
            [a[6]] if a[6] is not None else [])}
        n_cols = len(streams)
        fact_bytes = sum(4 * s.numel() for s in streams.values())
        table_bytes = sum(t.numel() * t.element_size() for t in a[3])
        stream_ms = (fact_bytes + table_bytes + 4 * plan.n_groups) \
            / HBM_BYTES_PER_S * 1e3
        need = must_move(a, **k)
        bound_ms = max(need["bytes_ms"], need["ops_ms"])
        return {"query": name, "n_groups": plan.n_groups,
                "launches": launched,
                "groups_nonzero": int(np.count_nonzero(result)),
                "result_sum": float(result.astype(np.float64).sum()),
                "query_ms": statistics.median(times),
                "query_ms_max": max(times), "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "fact_columns": n_cols,
                "fact_GB": fact_bytes / 1e9, "table_MB": table_bytes / 1e6,
                "GBps": fact_bytes / kernel_ms / 1e6,
                "stream_bound_ms": stream_ms,
                "stream_share": stream_ms / kernel_ms,
                "need_fact_GB": need["fact_bytes"] / 1e9,
                "need_table_MB": need["table_bytes"] / 1e6,
                "need_Gops": need["ops"] / 1e9,
                "bytes_ms": need["bytes_ms"], "ops_ms": need["ops_ms"],
                "bound_ms": bound_ms,
                "bound_by": "bytes" if need["bytes_ms"] >= need["ops_ms"]
                else "operations",
                "bound_share": bound_ms / kernel_ms}

    rows = []
    for name, plan in queries.items():
        rows.append(fused_row(name, plan, db, launches[name], first[name]))
        print(json.dumps(rows[-1]), flush=True)
    totals = ("query_ms", "kernel_ms", "plain_ms", "stream_bound_ms",
              "bytes_ms", "ops_ms", "bound_ms")
    tot = {k: sum(r[k] for r in rows) for k in totals}
    print(f"totals {json.dumps(tot)}")
    print("profile fused " + json.dumps(profiled(run_pass)), flush=True)
    print(f"phase4_s {time.perf_counter() - t:.3f}", flush=True)
    kernels = [dict(
        KERNEL, launches=main_launches, max_abs_err=max_err,
        ms=tot["kernel_ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        library_ms=None)]

    t = phase(f"5 second path: 13 SSB queries, opat, SF {SF}")
    kernel_mods = [mods[m] for m, *_ in OPAT]

    def counts():
        return [mod.LAUNCHES for mod in kernel_mods]

    def run_opat(mode="auto", database=db, count=counts):
        out, per = {}, {}
        for name, plan in queries.items():
            before = count()
            out[name] = compile_plan(plan, "opat").execute(
                database, mode=mode, cache=cache)
            per[name] = [a - b for a, b in zip(count(), before)]
        return out, per

    for mod in kernel_mods:
        mod.LAUNCHES = 0
    opat, per_query = run_opat()
    opat_launches = counts()
    for mod in kernel_mods:
        mod.LAUNCHES = 0
    opat_second, _ = run_opat()
    if counts() != opat_launches:
        raise AssertionError(f"second opat pass launched {counts()}, "
                             f"the first {opat_launches}")
    opat_plain, plain_per = run_opat(mode="ref")
    if any(any(v) for v in plain_per.values()):
        raise AssertionError("mode='ref' launched a kernel")
    for name, plan in queries.items():
        shape = [len(plan.filters), len(plan.joins),
                 int(plan.measure_op == "sub"), 1]
        if per_query[name] != shape:
            if opat[name].any() or any(
                    a > b for a, b in zip(per_query[name], shape)):
                raise AssertionError(f"{name}: launches {per_query[name]},"
                                     f" the plan's shape {shape}")
            print(f"{name}: rows ran out, launches {per_query[name]} of "
                  f"{shape}")
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "fused path"),
                            (opat_second[name], "second opat pass"),
                            (opat_plain[name], "plain versions on the card")):
            if not same_bits(opat[name], other):
                diff = np.abs(opat[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} opat: differs from the {what} "
                                     f"(max |diff| {diff})")
    print("launches_per_pass " + " ".join(
        f"{fn}={n}" for (_, fn, *_), n in zip(OPAT, opat_launches)) +
        " bit-identical: oracle, fused, second pass, plain on card",
        flush=True)

    fused_ms = {r["query"]: r["query_ms"] for r in rows}
    opat_ms, opat_rows = {}, []
    for name, plan in queries.items():
        times = query_ms(compile_plan(plan, "opat"), db, cache)
        opat_ms[name] = statistics.median(times)
        row = {"query": name, "launches": per_query[name],
               "opat_query_ms": statistics.median(times),
               "opat_query_ms_max": max(times),
               "fused_query_ms": fused_ms[name],
               "opat_over_fused": statistics.median(times) / fused_ms[name]}
        opat_rows.append(row)
        print(json.dumps(row), flush=True)
    print("totals " + json.dumps({k: sum(r[k] for r in opat_rows) for k in (
        "opat_query_ms", "fused_query_ms")}), flush=True)

    print("profile opat " + json.dumps(profiled(run_opat)), flush=True)
    n = db.lineorder.n_rows     # the chain's first positions vector, alone
    arange_ms = event_ms(lambda: torch.arange(n, dtype=torch.int32,
                                              device=dev), KERNEL_REPS)
    print(f"arange int32 n={n} ms {arange_ms} "
          f"GBps {4 * n / arange_ms / 1e6}", flush=True)

    with contextlib.ExitStack() as stack:
        timers = {fn: stack.enter_context(Timed(mods[m], fn, getattr(ref, fn)))
                  for m, fn, *_ in OPAT}
        timed, _ = run_opat()
    for name in queries:
        if not same_bits(timed[name], opat[name]):
            raise AssertionError(f"{name}: the timed opat pass differs")
    def kernel_entry(fn, src, replaces, launched, err, calls):
        """The kernels line's entry for one kernel from its timed calls
        (each printed on its own line)."""
        for r in calls:
            print(json.dumps({"call": fn, "n": r["n"], "ms": r["ms"],
                              "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
                              "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"]}))
        tot = {k: sum(r[k] for r in calls)
               for k in ("ms", "plain_ms", "bytes", "ops", "bytes_ms",
                         "ops_ms")}
        bound_ms = sum(max(r["bytes_ms"], r["ops_ms"]) for r in calls)
        lib = [r["library_ms"] for r in calls if r["library_ms"] is not None]
        entry = {"name": fn, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}",
                 "replaces": replaces, "launches": launched,
                 "max_abs_err": err, "ms": tot["ms"],
                 "plain_ms": tot["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                 else "operations",
                 "library_ms": sum(lib) if lib else None}
        print(json.dumps(dict(entry, calls=len(calls), GB=tot["bytes"] / 1e9,
                              Gops=tot["ops"] / 1e9,
                              bound_share=bound_ms / tot["ms"])), flush=True)
        return entry

    for (m, fn, src, replaces), launched in zip(OPAT, opat_launches):
        kernels.append(kernel_entry(fn, src, replaces, launched,
                                    max(opat_err[fn], timers[fn].err),
                                    timers[fn].rows))
    print(f"phase5_s {time.perf_counter() - t:.3f}")

    t = phase(f"6 packed storage: 13 SSB queries, fused and opat, SF {SF}")
    t0 = time.perf_counter()
    pdb = storage.pack_database(db)
    print(f"pack_s {time.perf_counter() - t0:.3f}")
    for col, pc in pdb.lineorder.columns.items():
        e = pc.encoding
        print(f"{col}: {e.kind} width {e.width} phys {e.phys} ref {e.ref}")
    pdb.to(dev)
    torch.cuda.synchronize()
    print(f"resident_GB {pdb.lineorder.resident_bytes(dev) / 1e9:.3f} "
          f"(plain {db.lineorder.resident_bytes(dev) / 1e9:.3f})", flush=True)
    hits, misses = cache.hits, cache.misses

    ssb_fused.LAUNCHES = 0
    pfirst, plaunched = run_pass(database=pdb)
    packed_launches = ssb_fused.LAUNCHES
    if packed_launches != len(queries) or set(plaunched.values()) != {1}:
        raise AssertionError(f"expected one launch per query, got "
                             f"{plaunched}")
    ssb_fused.LAUNCHES = 0
    psecond, _ = run_pass(database=pdb)
    if ssb_fused.LAUNCHES != len(queries):
        raise AssertionError(f"second pass launched {ssb_fused.LAUNCHES}")
    pplain, pl = run_pass(mode="ref", database=pdb)
    if set(pl.values()) != {0}:
        raise AssertionError("mode='ref' launched the kernel")
    for name in queries:
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "plain fused path"),
                            (psecond[name], "second pass"),
                            (pplain[name], "plain version on the card")):
            if not same_bits(pfirst[name], other):
                diff = np.abs(pfirst[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} packed fused: differs from the "
                                     f"{what} (max |diff| {diff})")
        packed_err = max(packed_err, float(np.abs(
            pfirst[name].astype(np.float64) - pplain[name]).max()))

    sel_mod = mods["select_scan"]

    def counts6():
        return [sel_mod.PACKED_LAUNCHES] + counts()

    def reset6():
        sel_mod.PACKED_LAUNCHES = 0
        for mod in kernel_mods:
            mod.LAUNCHES = 0

    reset6()
    popat, pper = run_opat(database=pdb, count=counts6)
    popat_launches = counts6()
    reset6()
    popat_second, _ = run_opat(database=pdb, count=counts6)
    if counts6() != popat_launches:
        raise AssertionError(f"second packed opat pass launched {counts6()}, "
                             f"the first {popat_launches}")
    popat_plain, pp = run_opat(mode="ref", database=pdb, count=counts6)
    if any(any(v) for v in pp.values()):
        raise AssertionError("mode='ref' launched a kernel")
    for name, plan in queries.items():
        lead = int(bool(plan.filters) and isinstance(plan.chain[1], P.Filter))
        shape = [lead, len(plan.filters) - lead, len(plan.joins),
                 int(plan.measure_op == "sub"), 1]
        if pper[name] != shape:
            if popat[name].any() or any(
                    a > b for a, b in zip(pper[name], shape)):
                raise AssertionError(f"{name}: packed opat launches "
                                     f"{pper[name]}, the plan's {shape}")
            print(f"{name}: rows ran out, launches {pper[name]} of {shape}")
        for other, what in ((oracle[name], "numpy oracle"),
                            (first[name], "plain fused path"),
                            (popat_second[name], "second pass"),
                            (popat_plain[name], "plain versions on the card")):
            if not same_bits(popat[name], other):
                diff = np.abs(popat[name].astype(np.float64) - other).max()
                raise AssertionError(f"{name} packed opat: differs from the "
                                     f"{what} (max |diff| {diff})")
    if cache.misses != misses:
        raise AssertionError(f"{cache.misses - misses} hash-table builds "
                             "missed the cache warmed on the plain database")
    print(f"launches_per_pass spja={packed_launches} " + " ".join(
        f"{fn}={n}" for fn, n in zip(
            ["select_scan_packed"] + [fn for _, fn, *_ in OPAT],
            popat_launches)) +
        " bit-identical: oracle, plain fused, second pass, plain on card; "
        f"cache hits {cache.hits - hits} misses {cache.misses - misses}",
        flush=True)

    prows = []
    for (name, plan), plain_row in zip(queries.items(), rows):
        row = fused_row(name, plan, pdb, plaunched[name], pfirst[name])
        times = query_ms(compile_plan(plan, "opat"), pdb, cache)
        row.update({"opat_launches": pper[name],
                    "opat_query_ms": statistics.median(times),
                    "plain_kernel_ms": plain_row["kernel_ms"],
                    "plain_query_ms": plain_row["query_ms"],
                    "plain_bound_ms": plain_row["bound_ms"],
                    "plain_need_fact_GB": plain_row["need_fact_GB"]})
        prows.append(row)
        print(json.dumps(row), flush=True)
    ptot = {k: sum(r[k] for r in prows)
            for k in totals + ("opat_query_ms", "plain_kernel_ms",
                               "plain_query_ms", "plain_bound_ms")}
    print(f"totals {json.dumps(ptot)}", flush=True)
    kernels[0]["packed"] = {
        "launches": packed_launches, "max_abs_err": packed_err,
        "ms": ptot["kernel_ms"], "plain_ms": ptot["plain_ms"],
        "bound_ms": ptot["bound_ms"],
        "bound_by": "bytes" if ptot["bytes_ms"] >= ptot["ops_ms"]
        else "operations"}

    (m, fn, _, src, replaces), (um, ufn, _, usrc, ureplaces) = PACKED
    with Timed(mods[m], fn, getattr(ref, fn)) as timer:
        timed, _ = run_opat(database=pdb, count=counts6)
    for name in queries:
        if not same_bits(timed[name], popat[name]):
            raise AssertionError(f"{name}: the timed packed opat pass "
                                 "differs")
    kernels.append(kernel_entry(fn, src, replaces, popat_launches[0],
                                max(opat_err[fn], timer.err), timer.rows))

    unp = mods[um]
    packed_cols = [(col, pc.encoding)
                   for col, pc in pdb.lineorder.columns.items()
                   if pc.encoding.kind != "plain"]
    unp.LAUNCHES = 0
    for col, e in packed_cols:
        words = pdb.lineorder.on_device(col, dev)
        got = unp.unpack(words, e.n_rows, e.phys, e.ref)
        for other, what in ((ref.unpack(words, e.n_rows, e.phys, e.ref),
                             "plain version"),
                            (db.lineorder.on_device(col, dev),
                             "resident plain column")):
            if not torch.equal(got, other):
                raise AssertionError(f"unpack {col}: differs from the {what}")
    unpack_launches = unp.LAUNCHES
    if unpack_launches != len(packed_cols):
        raise AssertionError(f"unpack launched {unpack_launches} times for "
                             f"{len(packed_cols)} columns")
    print(f"unpack: {unpack_launches} packed columns bit-identical to the "
          "plain version and the resident plain column", flush=True)
    calls = []
    for col, e in packed_cols:
        a = (pdb.lineorder.on_device(col, dev), e.n_rows, e.phys, e.ref)
        out = unp.unpack(*a)
        calls.append(dict(opat_need(ufn, a, out), n=e.n_rows,
                          ms=event_ms(functools.partial(unp.unpack, *a),
                                      KERNEL_REPS),
                          plain_ms=event_ms(functools.partial(ref.unpack, *a),
                                            1),
                          library_ms=None))
    kernels.append(kernel_entry(ufn, usrc, ureplaces, unpack_launches,
                                opat_err[ufn], calls))
    print(f"phase6_s {time.perf_counter() - t:.3f}")

    t = phase(f"7 partitioned join: 13 SSB queries, part and part_loop, "
              f"SF {SF}; the Fig. 8 analogue")
    hj = mods["hash_join"]

    def counts7():
        return [radix.HIST_LAUNCHES, radix.SCATTER_LAUNCHES, pprobe.LAUNCHES,
                hj.LAUNCHES]

    def reset7():
        radix.HIST_LAUNCHES = radix.SCATTER_LAUNCHES = pprobe.LAUNCHES = \
            hj.LAUNCHES = 0

    def run_part(strategy, mode="auto", database=db, seen=None):
        """The 13 queries through one partitioned strategy -> (results,
        launches per query, non-empty partitions per query)."""
        out, per, probes = {}, {}, {}
        for name, plan in queries.items():
            before, k = counts7(), len(seen) if seen is not None else 0
            out[name] = compile_plan(plan, strategy).execute(
                database, mode=mode, cache=cache)
            per[name] = [a - b for a, b in zip(counts7(), before)]
            probes[name] = sum(seen[k:]) if seen is not None else None
        return out, per, probes

    part_launches, part_per = {}, {}
    hits, misses = cache.hits, cache.misses
    for label, database in (("plain", db), ("packed", pdb)):
        for strategy in ("part", "part_loop"):
            reset7()
            with nonempty_partitions(radix) as seen:
                res, per, probes = run_part(strategy, database=database,
                                            seen=seen)
            launched = counts7()
            reset7()
            second, _, _ = run_part(strategy, database=database)
            if counts7() != launched:
                raise AssertionError(f"{label} {strategy}: second pass "
                                     f"launched {counts7()}, the first "
                                     f"{launched}")
            plain_res, pp, _ = run_part(strategy, mode="ref",
                                        database=database)
            if any(any(v) for v in pp.values()):
                raise AssertionError("mode='ref' launched a kernel")
            for name, plan in queries.items():
                j = len(plan.joins)
                shape = [j, j, j, 0] if strategy == "part" else \
                    [j, j, 0, probes[name]]
                if per[name] != shape:
                    if res[name].any() or any(
                            a > b for a, b in zip(per[name], shape)):
                        raise AssertionError(
                            f"{name} {label} {strategy}: launches "
                            f"{per[name]}, the plan's {shape}")
                    print(f"{name} {label} {strategy}: rows ran out, "
                          f"launches {per[name]} of {shape}")
                for other, what in ((oracle[name], "numpy oracle"),
                                    (second[name], "second pass"),
                                    (plain_res[name],
                                     "plain versions on the card")):
                    if not same_bits(res[name], other):
                        diff = np.abs(res[name].astype(np.float64)
                                      - other).max()
                        raise AssertionError(
                            f"{name} {label} {strategy}: differs from the "
                            f"{what} (max |diff| {diff})")
            part_launches[label, strategy] = launched
            part_per[label, strategy] = per
            print(f"{label} {strategy}: launches histogram={launched[0]} "
                  f"partition_multi={launched[1]} part_probe={launched[2]} "
                  f"probe_join={launched[3]} bit-identical: oracle, second "
                  "pass, plain on card", flush=True)
    print(f"cache hits {cache.hits - hits} misses {cache.misses - misses}",
          flush=True)

    part_rows = []
    for name, plan in queries.items():
        bits = [M.part_bits(cache.get_build_count(db, j))
                for j in plan.joins]
        row = {"query": name, "part_bits": bits,
               "probe_whole": [mean_probe(cache.get_or_build(db, j, dev)[0])
                               for j in plan.joins],
               "probe_part": [mean_probe(cache.get_or_build_parts(
                   db, j, b, packed=True, device=dev).htk)
                   for j, b in zip(plan.joins, bits)],
               "fused_query_ms": fused_ms[name],
               "opat_query_ms": opat_ms[name]}
        for label, database in (("plain", db), ("packed", pdb)):
            for strategy in ("part", "part_loop"):
                times = query_ms(compile_plan(plan, strategy), database,
                                 cache)
                key = strategy if label == "plain" else f"{strategy}_packed"
                row[f"{key}_query_ms"] = statistics.median(times)
                row[f"{key}_launches"] = part_per[label, strategy][name]
        part_rows.append(row)
        print(json.dumps(row), flush=True)
    print("totals " + json.dumps({k: sum(r[k] for r in part_rows) for k in (
        "fused_query_ms", "opat_query_ms", "part_query_ms",
        "part_loop_query_ms", "part_packed_query_ms",
        "part_loop_packed_query_ms")}), flush=True)

    plains = {"histogram": ref.histogram,
              "partition_multi": lambda keys, vals, start_bit, r, hist=None:
              ref.partition_multi(keys, vals, start_bit, r),
              "part_probe": ref.part_probe}
    with contextlib.ExitStack() as stack:
        timers = {fn: stack.enter_context(Timed(mods[m], fn, plains[fn]))
                  for m, fn, *_ in PARTITIONED}
        timed, _, _ = run_part("part")
    for name in queries:
        if not same_bits(timed[name], oracle[name]):
            raise AssertionError(f"{name}: the timed part pass differs")
    loop_launches = part_launches["plain", "part_loop"]
    for i, (m, fn, _, src, replaces) in enumerate(PARTITIONED):
        kernels.append(dict(
            kernel_entry(fn, src, replaces, part_launches["plain", "part"][i],
                         max(part_err[fn], timers[fn].err), timers[fn].rows),
            launches_part_loop=loop_launches[i] if i < 2 else 0))

    fig8_plan = (engine.QueryBuilder("fig8").scan("lineorder")
                 .hash_join("lo_partkey", "part", "p_partkey",
                            payload=P.ColExpr("p_group"), mult=1)
                 .measure("lo_revenue").group_by(64).build())
    rng = np.random.default_rng(SEED)
    revenue = rng.integers(1, 1000, FIG8_FACT, dtype=np.int32)
    for n_dim in FIG8_DIMS:
        t0 = time.perf_counter()
        fdb = fig8_db(ssb, rng, n_dim, revenue).to(dev)
        fcache = hashtable.HashTableCache()
        want = engine.run_query_oracle(fdb, fig8_plan)
        row = {"n_fact": FIG8_FACT, "n_dim": n_dim,
               "table_MB": M.ht_bytes(n_dim) / 1e6,
               "part_bits": M.part_bits(n_dim),
               "setup_s": time.perf_counter() - t0}
        for strategy in STRATEGIES:
            q = compile_plan(fig8_plan, strategy)
            t0 = time.perf_counter()
            got = q.execute(fdb, cache=fcache)      # builds its tables
            row[f"{strategy}_first_s"] = time.perf_counter() - t0
            if not same_bits(got, want):
                raise AssertionError(f"fig8 n_dim={n_dim} {strategy}: "
                                     "differs from the numpy oracle")
            before = counts7()
            times = query_ms(q, fdb, fcache)
            row[f"{strategy}_query_ms"] = statistics.median(times)
            row[f"{strategy}_launches"] = [
                (a - b) // QUERY_REPS for a, b in zip(counts7(), before)]
        join = fig8_plan.joins[0]
        row["probe_whole"] = mean_probe(fcache.get_or_build(fdb, join,
                                                            dev)[0])
        row["probe_part"] = mean_probe(fcache.get_or_build_parts(
            fdb, join, row["part_bits"], packed=True, device=dev).htk)
        print("fig8 " + json.dumps(row), flush=True)
        del fdb, fcache
        torch.cuda.empty_cache()
    print(f"phase7_s {time.perf_counter() - t:.3f}", flush=True)

    t = phase(f"8 ORDER BY: LSB radix sort, SF {SF}")
    lo = db.lineorder
    radix.HIST_LAUNCHES = radix.SCATTER_LAUNCHES = 0
    t0 = time.perf_counter()
    ordered = engine.order_by(lo, "lo_orderdate")
    order_by_s = time.perf_counter() - t0
    ob_launches = [radix.HIST_LAUNCHES, radix.SCATTER_LAUNCHES]
    passes = -(-32 // SORT_BITS)
    if ob_launches != [passes, passes]:
        raise AssertionError(f"order_by launched {ob_launches}, expected "
                             f"{passes} histogram and scatter passes")
    perm = np.argsort(lo["lo_orderdate"], kind="stable")
    for c in lo.columns:
        if not np.array_equal(ordered[c], lo[c][perm]):
            raise AssertionError(f"order_by: column {c} is not in numpy's "
                                 "stable argsort order")
    print(f"order_by lineorder by lo_orderdate: {lo.n_rows} rows, "
          f"launches histogram={ob_launches[0]} "
          f"partition_multi={ob_launches[1]}, order_by_s {order_by_s:.3f}, "
          "equal to numpy's stable argsort", flush=True)

    row_plan = (engine.QueryBuilder("ordered").scan("lineorder")
                .where_range("lo_discount", 1, 3)
                .hash_join("lo_orderdate", "date", "d_datekey",
                           dim_filter=P.EqPred("d_year", 1993))
                .order_by("lo_revenue").build())
    sel = mods["select_scan"]

    def counts8():
        return [sel.LAUNCHES, hj.LAUNCHES, radix.HIST_LAUNCHES,
                radix.SCATTER_LAUNCHES]

    before = counts8()
    got = compile_plan(row_plan, "opat").execute(db, cache=cache)
    row_launches = [a - b for a, b in zip(counts8(), before)]
    if row_launches != [1, 1, passes, passes]:
        raise AssertionError(f"row plan launched {row_launches}")
    disc = lo["lo_discount"]
    year = db.date["d_datekey"][db.date["d_year"] == 1993]
    survivors = np.flatnonzero((disc >= 1) & (disc <= 3) &
                               np.isin(lo["lo_orderdate"], year))
    want = survivors[np.argsort(lo["lo_revenue"][survivors], kind="stable")]
    for other, what in ((want, "numpy's stable argsort"),
                        (compile_plan(row_plan, "opat").execute(
                            db, cache=cache), "second pass"),
                        (compile_plan(row_plan, "opat").execute(
                            db, mode="ref", cache=cache),
                         "plain versions on the card")):
        if not np.array_equal(got, other):
            raise AssertionError(f"row plan: differs from the {what}")
    print(f"row plan filter + join + OrderBy(lo_revenue): {len(got)} rows, "
          f"launches select_scan/probe_join/histogram/partition_multi "
          f"{row_launches}, equal to numpy's stable argsort, a second pass "
          "and the plain versions on the card", flush=True)

    keys = lo.on_device("lo_orderdate", dev)
    vals = torch.arange(lo.n_rows, dtype=torch.int32, device=dev)
    n = lo.n_rows
    sort_bytes = 16 * n             # keys and row ids read and written once
    sort_row = {"n": n, "passes": passes,
                "ms": event_ms(lambda: radix.radix_sort(keys, vals),
                               KERNEL_REPS),
                "plain_ms": event_ms(lambda: ref.radix_sort(keys, vals), 1),
                "library_ms": event_ms(
                    lambda: torch.sort(keys, stable=True), KERNEL_REPS),
                "bound_ms": sort_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
    hist = radix.histogram(keys, 0, SORT_BITS)
    sort_row["pass_histogram_ms"] = event_ms(
        lambda: radix.histogram(keys, 0, SORT_BITS), KERNEL_REPS)
    sort_row["pass_scatter_ms"] = event_ms(
        lambda: radix.partition_multi(keys, (vals,), 0, SORT_BITS,
                                      hist=hist), KERNEL_REPS)
    sort_row["bound_share"] = sort_row["bound_ms"] / sort_row["ms"]
    print("radix_sort " + json.dumps(sort_row), flush=True)
    for entry in kernels[-3:-1]:
        entry["launches_order_by"] = ob_launches[0]
    print(f"phase8_s {time.perf_counter() - t:.3f}")
    print(f"total_s {time.perf_counter() - t_all:.3f}")
    print(f"card {card}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
