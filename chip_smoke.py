#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # SF 20, the paper's scale (§5.1)

Phases, each printing what it found; any failure raises, and the script
exits non-zero without printing a result:

1. card:   name and power limit, as nvidia-smi reports them;
2. build:  the port's CUDA kernel, compiled from the repo's source with
           nvcc;
3. kernel vs plain: ``ssb_fused.spja`` against ``ref.spja`` on the card
           on synthetic inputs from a seed — bit-identical required;
4. main path: ``ssb.generate(sf=20)`` (120 M lineorder rows), resident
           on the card, all 13 SSB queries through
           ``compile_plan(plan, "fused").execute(db, cache=...)``: 13
           kernel launches per pass, every result bit-identical to the
           numpy oracle, to the plain version on the card and to a second
           pass; then per-query times beside the least time the card
           could take for the work this data needs (``must_move``).

The line before the last lists every kernel of the path as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Needs one CUDA device.
"""
from __future__ import annotations

import functools
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
# int32 ALU peak of an H100 SXM: 132 SMs x 64 int32 lanes x 1.98 GHz =
# 16.7 TOP/s, a quarter of the published 67 TFLOP/s float32 rate (128
# float32 lanes, an FMA counted as 2)
INT32_OPS_PER_S = 67e12 / 4
SF = 20                         # the paper's scale factor (§5.1)
SEED = 20
QUERY_REPS = 5                  # end-to-end runs per query (median)
KERNEL_REPS = 10                # back-to-back launches per timing
PLAIN_REPS = 2
KERNEL = {"name": "ssb_fused.spja", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/ssb_fused.cu",
          "replaces": "src/repro/kernels/ssb_fused.py:115"}

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
]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cases
    from repro_torch.kernels import build, ref, ssb_fused
    from repro_torch.sql import engine, hashtable, ssb
    from repro_torch.sql.compile import compile_plan, fused_inputs

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
    log = build.build("ssb_fused")
    print(build.library_path("ssb_fused").relative_to(ROOT))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()}")
    build.load("ssb_fused")
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
    print(f"phase4_s {time.perf_counter() - t:.3f}")
    print(f"total_s {time.perf_counter() - t_all:.3f}")
    print(f"card {card}", flush=True)

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=main_launches, max_abs_err=max_err,
        ms=tot["kernel_ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        library_ms=None)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
