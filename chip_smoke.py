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
           identical, within one f32 ulp of the plain version);
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
           and each kernel's time over one pass beside its bound.

The line before the last lists every kernel of both paths as JSON; the
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


def segment_bytes(touched: torch.Tensor) -> int:
    """Bytes of the 64-byte segments of an int32 array that hold at least
    one touched element."""
    per = SEGMENT // 4
    pad = torch.nn.functional.pad(touched, (0, (-touched.shape[0]) % per))
    return SEGMENT * int(pad.view(-1, per).any(dim=1).sum())


def probe_walk(keys: torch.Tensor, htk: torch.Tensor):
    """Each key's linear probe as the kernel walks it: (hit slot or -1,
    slots visited, probe steps taken)."""
    from repro_torch.core import blocks
    n_slots = htk.shape[0]
    hit_slot = torch.full(keys.shape, -1, dtype=torch.int64,
                          device=keys.device)
    visited = torch.zeros(n_slots, dtype=torch.bool, device=keys.device)
    lanes = torch.arange(keys.shape[0], device=keys.device)
    want, slot, steps = keys, blocks.hash_fn(keys, n_slots), 0
    for _ in range(n_slots):
        if lanes.numel() == 0:
            break
        visited[slot] = True
        steps += lanes.numel()
        k_at = htk[slot]
        hit = k_at == want
        hit_slot[lanes[hit]] = slot[hit]
        walking = ~(hit | (k_at == blocks.EMPTY))
        lanes, want = lanes[walking], want[walking]
        slot = (slot[walking] + 1) & (n_slots - 1)
    return hit_slot, visited, steps


def must_move(spja_args, n_groups: int) -> dict:
    """What one ``spja`` call needs on this data, for its bound.

    Bytes: the kernel loads a row's next column only while the row is
    live (predicates in order, then join keys, then measures), so each
    column costs the 64-byte segments that hold a live row when it is
    first read (the first column in full); each table costs the segments
    of the slots its probes visit (keys) or hit (payloads); the output is
    (n_groups,) f32.  Operations: 2 compares per predicate and live row, 4
    per probe step (multiply, mask, 2 compares), 2 per hit (group
    multiply-add), 2 per summed row (measure op and add)."""
    from repro_torch.kernels import ref
    pred_cols, bounds, join_keys, tables, mults, m1, m2 = spja_args
    n = m1.shape[0]
    live = torch.ones(n, dtype=torch.bool, device=m1.device)
    seen, fact, table, ops = set(), 0, 0, 0

    def read(col):
        nonlocal fact
        if col.data_ptr() not in seen:
            seen.add(col.data_ptr())
            fact += segment_bytes(live)

    for col, (lo, hi) in zip(pred_cols,
                             ref.bounds_list(bounds, len(pred_cols))):
        read(col)
        ops += 2 * int(live.sum())
        live &= (col >= lo) & (col <= hi)
    group = torch.zeros(n, dtype=torch.int64, device=m1.device)
    for j, (keys, mult) in enumerate(
            zip(join_keys, ref.mults_list(mults, len(join_keys)))):
        read(keys)
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
    read(m1)
    if m2 is not None:
        read(m2)
    ops += 2 * int(live.sum())
    moved = fact + table + 4 * n_groups
    return {"fact_bytes": fact, "table_bytes": table, "bytes": moved,
            "ops": ops, "bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT32_OPS_PER_S * 1e3}


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
    path)."""
    n = args[0].shape[0]
    if fn == "select_scan":
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
    return got if isinstance(got, tuple) else (got,)


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
                              n=args[0].shape[0], ms=ms, plain_ms=plain_ms,
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
    from repro_torch.sql import engine, hashtable, ssb
    from repro_torch.sql.compile import compile_plan, fused_inputs
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m, *_ in OPAT}

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
    max_err = 0.0
    for i, (label, kw) in enumerate(SYNTHETIC):
        c = cases.spja_case(1000 + i, **kw)
        a, k = c.args(dev)
        before = ssb_fused.LAUNCHES
        got = ssb_fused.spja(*a, **k)
        if ssb_fused.LAUNCHES != before + 1:
            raise AssertionError(f"{label}: the kernel did not launch")
        want = ref.spja(*a, **k)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
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
    for m, fn, *_ in OPAT:
        opat_err[fn] = 0.0
        for label, gen, gen_args, extra, sigmoid in OPAT_SYNTHETIC[fn]:
            args = cases.tensors(getattr(cases, gen)(*gen_args), dev) + extra
            kw = {"sigmoid": sigmoid} if fn == "project" else {}
            before = mods[m].LAUNCHES
            got = getattr(mods[m], fn)(*args, **kw)
            if mods[m].LAUNCHES != before + 1:
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

    def run_pass(mode="auto"):
        out, launches = {}, {}
        for name, plan in queries.items():
            before = ssb_fused.LAUNCHES
            out[name] = compile_plan(plan, "fused").execute(
                db, mode=mode, cache=cache)
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

    rows = []
    for name, plan in queries.items():
        q = compile_plan(plan, "fused")
        times = []
        for _ in range(QUERY_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.execute(db, cache=cache)
            times.append((time.perf_counter() - t0) * 1e3)
        a, k = fused_inputs(plan, db, cache, dev)
        kernel_ms = event_ms(functools.partial(ssb_fused.spja, *a, **k),
                             KERNEL_REPS)
        plain_ms = event_ms(functools.partial(ref.spja, *a, **k),
                            PLAIN_REPS)
        streams = [*a[0], *a[2], a[5]] + ([a[6]] if a[6] is not None else [])
        n_cols = len({s.data_ptr() for s in streams})
        fact_bytes = 4 * db.lineorder.n_rows * n_cols
        table_bytes = sum(t.numel() * t.element_size() for t in a[3])
        stream_ms = (fact_bytes + table_bytes + 4 * plan.n_groups) \
            / HBM_BYTES_PER_S * 1e3
        need = must_move(a, plan.n_groups)
        bound_ms = max(need["bytes_ms"], need["ops_ms"])
        row = {"query": name, "n_groups": plan.n_groups,
               "launches": launches[name],
               "groups_nonzero": int(np.count_nonzero(first[name])),
               "result_sum": float(first[name].astype(np.float64).sum()),
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
        rows.append(row)
        print(json.dumps(row), flush=True)
    tot = {k: sum(r[k] for r in rows)
           for k in ("query_ms", "kernel_ms", "plain_ms", "stream_bound_ms",
                     "bytes_ms", "ops_ms", "bound_ms")}
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

    def run_opat(mode="auto"):
        out, per = {}, {}
        for name, plan in queries.items():
            before = counts()
            out[name] = compile_plan(plan, "opat").execute(
                db, mode=mode, cache=cache)
            per[name] = [a - b for a, b in zip(counts(), before)]
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
    opat_rows = []
    for name, plan in queries.items():
        q = compile_plan(plan, "opat")
        times = []
        for _ in range(QUERY_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.execute(db, cache=cache)
            times.append((time.perf_counter() - t0) * 1e3)
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
    for (m, fn, src, replaces), launched in zip(OPAT, opat_launches):
        calls = timers[fn].rows
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
                 "max_abs_err": max(opat_err[fn], timers[fn].err),
                 "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                 "bound_ms": bound_ms,
                 "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                 else "operations",
                 "library_ms": sum(lib) if lib else None}
        kernels.append(entry)
        print(json.dumps(dict(entry, calls=len(calls), GB=tot["bytes"] / 1e9,
                              Gops=tot["ops"] / 1e9,
                              bound_share=bound_ms / tot["ms"])), flush=True)
    print(f"phase5_s {time.perf_counter() - t:.3f}")
    print(f"total_s {time.perf_counter() - t_all:.3f}")
    print(f"card {card}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
