"""Time the port's radix sort, projection, probe, sum, fused, select,
join-microbenchmark, hash build and group-by kernels on one card, in
turns beside the PyTorch call that computes the same function where
there is one.

    python3 kernel_turns.py [--tree PATH] [--only SECTION ...]

``--tree`` imports ``PATH/src/repro_torch`` in place of the checkout's
(say a ``git archive`` of an earlier commit unpacked under ``build/``),
so two commits are compared by running the script once for each, in
turns (parent, change, change, parent), in one call on the card.
``--only`` runs the named sections alone (sort, project, probe, sum, spja,
wave, select, join, sparse, hist, build, group); sum, join, sparse and
build need no database.

Every timing is ``chip_smoke.turns``: TURN_ROUNDS rounds in turns
(kernel, library, library, kernel), each the mean of back-to-back calls
between CUDA events (TURN_CALLS of the small ones); the report gives
every round and the medians.  Data: ``chip_smoke.SF`` and ``SEED``.

1. ``radix_sort`` of the SSB lineorder's ``lo_orderdate`` keys with
   int32 row ids, and of as many uniform random 32-bit keys (numpy),
   beside ``torch.sort(stable=True)``; the result held to a stable sort
   of the keys as unsigned words.  Then one sort split into its
   launches: the per-pass ``histogram``, the torch offsets scan and the
   scatter where the wrappers have no ``digit_counts`` (before the
   one-sweep redesign), else the digit counts and one pass.
2. ``project`` on the opat pass's three q4 inputs (the ``sub`` measure,
   captured from ``compile_plan(q, "opat").execute``), in turns beside
   ``torch.sub`` per call, and ``torch.profiler``'s device time of each
   over the same calls (``chip_smoke.profiled``).
3. ``project`` of 2^28 random f32 rows, with and without the sigmoid,
   each in turns beside ``torch.sub`` (no one call adds the sigmoid), and
   the 12n-byte bound.
4. ``probe_join`` and ``part_probe`` on the calls captured from the opat,
   part and part_loop passes of the 13 queries (``compile_plan(q,
   strategy).execute``): the first join of q2.1 (120 M rows), the third
   join of q4.2 (4.88 M rows), each call under 10 K rows, and each pass's
   calls back to back.  No one PyTorch call computes either function, so
   each is timed alone, TURN_ROUNDS rounds of ``event_ms`` (TURN_CALLS
   calls, TURN_ROUNDS passes); the parent is the other side of the turns
   (``--tree``).  Every captured call is held bit-identical to the plain
   version (``ref``) before it is timed.
5. ``reduce_sum`` of 2^28 random f32 rows in turns with ``torch.sum``,
   and of 2^28 random int32 rows alone (``torch.sum`` of int32 returns
   int64, another function): the parent is the other side of the turns;
   each sum held to the plain version first (int32 bit for bit, f32
   within one f32 ulp).
6. ``spja`` on the 13 queries' calls (``compile.fused_inputs``, the calls
   ``chip_smoke.py`` phase 4 times), on the plain database and on
   ``storage.pack_database`` of it: each call and the 13 back to back,
   TURN_ROUNDS rounds of ``event_ms`` (KERNEL_REPS calls), each call held
   bit-identical to the plain version first; with the block size and
   blocks an SM of each call where the tree picks them.
7. ``wave``: ``multi_spja`` on the ``chip_smoke.WAVES`` waves' calls
   (``compile.shared_params``, phase 9's), plain and packed, the same way,
   with the probe groups and streams of each.

8. ``select``: ``select_scan`` on the calls captured from one opat pass of
   the 13 queries and ``select_scan_packed`` on those of one opat pass on
   ``storage.pack_database`` of the database (``capture``), each captured
   call held bit-identical to the plain version first; each call and each
   pass timed alone, TURN_ROUNDS rounds of ``event_ms`` (TURN_CALLS calls,
   TURN_ROUNDS passes), beside each call's bound (``chip_smoke.opat_need``)
   and, as a yardstick only (no one PyTorch call computes the function),
   ``torch.nonzero((x >= lo) & (x <= hi))`` followed by the gather of y on
   the same calls (a packed call's x decoded once first).

9. ``join``: ``probe_agg`` of 2^28 rows against ``chip_smoke.py`` phase
   10's six tables (8 KB to 256 MB) on its data, each call held
   bit-identical to the plain version first, then timed in TURN_ROUNDS
   rounds of ``event_ms`` (KERNEL_REPS calls) beside the yardstick
   ``torch.take(htk, home)`` (one random 4-byte gather a probe at the
   probes' home slots, precomputed).
10. ``sparse``: ``select_scan_sparse`` on phase 10's 12 cases (2^28 rows,
   x uniform and sorted, six selectivities), each held bit-identical to
   the plain version and ``select_scan`` first, then in turns with
   ``select_scan`` on the same call, beside ``chip_smoke.sparse_need``'s
   bound.

11. ``hist``: ``histogram`` on every call captured from the part and
   part_loop passes of the 13 queries (``capture``), each held
   bit-identical to the plain version and to a second run first; then
   each pass's calls back to back, the HIST_LARGEST largest calls and
   every call under HIST_SMALL_ROWS rows (fewer tiles than the resident
   grid) timed alone, TURN_ROUNDS rounds of ``event_ms`` (TURN_CALLS
   calls, 5 passes), beside each call's bound (``chip_smoke.opat_need``).
   No PyTorch call computes the per-tile counts, so the parent is the
   other side of the turns.

12. ``build``: the hash ``build`` of ``chip_smoke.py`` phase 10's six
   tables (8 KB to 256 MB, 50 % fill), each built on the card from
   ``cases.join_bench_keys`` (payload = key, in an array of its own) and
   held byte-identical to ``ref.build`` first, then timed in TURN_ROUNDS
   rounds of ``event_ms`` (KERNEL_REPS calls) beside the 8n + 8S-byte
   bound.  No PyTorch call builds the table: the parent is the other
   side of the turns.

13. ``group``: ``group_sum`` on the 13 calls captured from one opat pass
   of the 13 queries (``capture``), each held to the plain version and a
   second run first (``chip_smoke.check_against_plain``: bit-identical,
   or within one f32 ulp for non-integer f32), then each call and the
   pass in turns with ``index_add_`` into a fresh zero grid
   (``chip_smoke.library_call``; TURN_CALLS calls, 5 passes), beside
   each call's bound (``chip_smoke.opat_need``).

Sections 6, 7 and 8 share one database and its packing; no PyTorch call
computes those kernels' functions, nor ``probe_agg``'s or
``select_scan_sparse``'s, so the parent is the other side of the turns
(``--tree``).

Prints the card's name and power limit first and one JSON object last.
Exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
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
SECTIONS = ("sort", "project", "probe", "sum", "spja", "wave", "select",
            "join", "sparse", "hist", "build", "group")
# the sections that read the SSB database
DB_SECTIONS = {"sort", "project", "probe", "spja", "wave", "select", "hist",
               "group"}
# (query, join) of the calls timed alone: the first join of q2.1 and the
# third of q4.2; calls under chip_smoke.SMALL_ROWS rows are timed alone too
PROBE_CALLS = (("q2.1", 0), ("q4.2", 2))
# hist: the largest calls of a pass timed alone, and the calls under this
# many rows (fewer 2,048-row tiles than the kernel's resident grid)
HIST_LARGEST = 3
HIST_SMALL_ROWS = 2_000_000


def rounds(fn, calls: int) -> dict:
    """TURN_ROUNDS rounds of ``event_ms(fn, calls)`` -> every round's time
    and their median."""
    from chip_smoke import TURN_ROUNDS, event_ms
    ms = [event_ms(fn, calls) for _ in range(TURN_ROUNDS)]
    return {"ms": ms, "median": statistics.median(ms)}


def capture(mod, fn: str, strategy: str, db, cache) -> list:
    """Every call of ``mod.fn`` in one pass of the 13 queries through
    ``strategy`` -> [(query, its k-th call in the query, cloned args)]."""
    from repro_torch.sql import engine
    from repro_torch.sql.compile import compile_plan
    calls, kernel, query = [], getattr(mod, fn), [None]

    def record(*args):
        k = sum(c[0] == query[0] for c in calls)
        calls.append((query[0], k, tuple(
            a.clone() if isinstance(a, torch.Tensor) else a for a in args)))
        return kernel(*args)
    setattr(mod, fn, record)
    try:
        for name, plan in engine.ssb_queries().items():
            query[0] = name
            compile_plan(plan, strategy).execute(db, cache=cache)
    finally:
        setattr(mod, fn, kernel)
    return calls


def probe_turns(db) -> dict:
    """Section 4: ``probe_join`` on the opat and part_loop passes' calls,
    ``part_probe`` on the part pass's; each captured call held to the
    plain version first."""
    from chip_smoke import SMALL_ROWS, TURN_CALLS, opat_need
    from repro_torch.kernels import hash_join, part_probe, ref
    from repro_torch.sql import hashtable
    cache = hashtable.HashTableCache()
    report = {}
    for strategy, mod, fn in (("opat", hash_join, "probe_join"),
                              ("part", part_probe, "part_probe"),
                              ("part_loop", hash_join, "probe_join")):
        calls = capture(mod, fn, strategy, db, cache)
        kernel, plain = getattr(mod, fn), getattr(ref, fn)
        for query, k, args in calls:
            for got, want in zip(kernel(*args), plain(*args)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{fn} {strategy} {query} call {k}"
                                         ": kernel != plain")

        def timed(args):
            need = opat_need(fn, args, kernel(*args))
            return dict(n=int(args[0].shape[0]), **rounds(
                lambda: kernel(*args), TURN_CALLS),
                bound_ms=max(need["bytes_ms"], need["ops_ms"]))

        def whole_pass():
            for _, _, args in calls:
                kernel(*args)
        row = {"fn": fn, "calls": len(calls),
               "rows": sum(int(a[0].shape[0]) for _, _, a in calls),
               "pass": rounds(whole_pass, 5),
               "picked": {f"{q} join {j}": timed(args)
                          for q, j, args in calls
                          if strategy != "part_loop" and
                          (q, j) in PROBE_CALLS},
               "small": [timed(args) for _, _, args in calls
                         if args[0].shape[0] < SMALL_ROWS]}
        report[f"{fn}_{strategy}"] = row
        print(f"{fn} {strategy} " + json.dumps(row), flush=True)
        del calls
        torch.cuda.empty_cache()
    return report


def select_turns(db, pdb) -> dict:
    """Section 8: ``select_scan`` on the opat pass's calls,
    ``select_scan_packed`` on the packed opat pass's; each captured call
    held to the plain version first, then each call and the pass timed,
    beside the nonzero-and-gather yardstick."""
    from chip_smoke import TURN_CALLS, opat_need
    from repro_torch.kernels import ref, select_scan
    from repro_torch.sql import hashtable
    cache = hashtable.HashTableCache()
    report = {}
    for kind, database, fn in (("plain", db, "select_scan"),
                               ("packed", pdb, "select_scan_packed")):
        calls = capture(select_scan, fn, "opat", database, cache)
        kernel, plain = getattr(select_scan, fn), getattr(ref, fn)
        for query, k, args in calls:
            for got, want in zip(kernel(*args), plain(*args)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{fn} {query} call {k}: kernel "
                                         "!= plain")

        def yardstick(args):
            x, y, lo, hi = args[:4]
            if fn == "select_scan_packed":
                x = ref.decode_words(x, args[4])[:y.shape[0]]
            return lambda: y[torch.nonzero((x >= lo) & (x <= hi))
                             .squeeze(1)]

        def timed(args):
            out = kernel(*args)
            need = opat_need(fn, args, out)
            return dict(n=int(args[1].shape[0]), count=int(out[1]),
                        **rounds(lambda: kernel(*args), TURN_CALLS),
                        bound_ms=max(need["bytes_ms"], need["ops_ms"]),
                        nonzero_gather=rounds(yardstick(args),
                                              TURN_CALLS)["median"])

        def whole_pass():
            for _, _, args in calls:
                kernel(*args)
        row = {"fn": fn, "calls": len(calls),
               "rows": sum(int(a[1].shape[0]) for _, _, a in calls),
               "pass": rounds(whole_pass, 5),
               "each": {f"{q} call {k}": timed(args)
                        for q, k, args in calls}}
        row["sum_of_medians"] = sum(c["median"]
                                    for c in row["each"].values())
        row["bound_ms"] = sum(c["bound_ms"] for c in row["each"].values())
        row["nonzero_gather_ms"] = sum(c["nonzero_gather"]
                                       for c in row["each"].values())
        report[fn] = row
        print(f"{fn} " + json.dumps(row), flush=True)
        del calls
        torch.cuda.empty_cache()
    return report


def join_turns(dev) -> dict:
    """Section 9: ``probe_agg`` of ``chip_smoke.JOIN_ROWS`` rows against
    phase 10's six tables, on phase 10's data (the host build of
    ``cases.join_bench_keys``, payload = key; the probe keys every found),
    each call held bit-identical to its plain version first, then timed
    in TURN_ROUNDS rounds of ``event_ms`` (KERNEL_REPS calls) beside the
    yardstick ``torch.take(htk, home)``: one random 4-byte gather a probe
    at the probes' home slots, precomputed, what a design with one access
    a probe can reach (no one PyTorch call computes the function)."""
    from chip_smoke import JOIN_ROWS, JOIN_TABLE_KB, KERNEL_REPS, SEED
    from repro_torch import cases
    from repro_torch.core import blocks
    from repro_torch.kernels import hash_join, ref
    from repro_torch.sql import hashtable
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    base = torch.randint(0, 1 << 30, (JOIN_ROWS,), generator=gen,
                         device=dev, dtype=torch.int32)
    vals = torch.randint(0, 100, (JOIN_ROWS,), generator=gen, device=dev,
                         dtype=torch.int32)
    report = {}
    for kb in JOIN_TABLE_KB:
        bkeys, n_slots = cases.join_bench_keys(SEED, kb * 1024)
        htk, htv = (torch.from_numpy(a).to(dev)
                    for a in hashtable.np_build(bkeys, bkeys, n_slots))
        keys = torch.remainder(base, len(bkeys))
        got = hash_join.probe_agg(keys, vals, htk, htv)
        if not torch.equal(got, ref.probe_agg(keys, vals, htk, htv)):
            raise AssertionError(f"probe_agg {kb} KB: kernel != plain")
        home = blocks.hash_fn(keys, n_slots)
        row = {"table_KB": kb, "n_slots": n_slots,
               **rounds(lambda: hash_join.probe_agg(keys, vals, htk, htv),
                        KERNEL_REPS),
               "take_ms": rounds(lambda: torch.take(htk, home),
                                 KERNEL_REPS)["median"]}
        report[f"{kb}KB"] = row
        print(f"probe_agg {kb} KB " + json.dumps(row), flush=True)
        del keys, home, htk, htv
        torch.cuda.empty_cache()
    report["all_medians"] = sum(r["median"] for k, r in report.items())
    print("probe_agg six tables " + json.dumps(report["all_medians"]),
          flush=True)
    return report


def sparse_turns(dev) -> dict:
    """Section 10: ``select_scan_sparse`` on phase 10's 12 cases
    (``chip_smoke.SPARSE_ROWS`` rows, x uniform and sorted, the
    ``SPARSE_SELECTIVITY`` selectivities, y phase 10's), each call held
    bit-identical to its plain version and to ``select_scan`` first, then
    in turns with ``select_scan`` on the same call (``chip_smoke.turns``:
    sparse, dense, dense, sparse; KERNEL_REPS calls a side), beside the
    bound of ``chip_smoke.sparse_need``."""
    from chip_smoke import (JOIN_ROWS, KERNEL_REPS, SEED, SPARSE_ROWS,
                            SPARSE_SELECTIVITY, sparse_need, turns)
    from repro_torch.kernels import ref, select_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    y = torch.randint(0, 1 << 30, (JOIN_ROWS,), generator=gen, device=dev,
                      dtype=torch.int32)[:SPARSE_ROWS]
    torch.randint(0, 100, (JOIN_ROWS,), generator=gen, device=dev,
                  dtype=torch.int32)        # phase 10's vals: the same x
    x_uniform = torch.randint(0, 1 << 30, (SPARSE_ROWS,), generator=gen,
                              device=dev, dtype=torch.int32)
    report = {"cases": []}
    for order, x in (("uniform", x_uniform),
                     ("sorted", torch.sort(x_uniform).values)):
        for selectivity in SPARSE_SELECTIVITY:
            hi = int(selectivity * (1 << 30)) - 1
            got = select_scan.select_scan_sparse(x, y, 0, hi)
            for other in (select_scan.select_scan(x, y, 0, hi),
                          ref.select_scan_sparse(x, y, 0, hi)):
                if not all(torch.equal(g, w) for g, w in zip(got, other)):
                    raise AssertionError(f"select_scan_sparse {order} "
                                         f"{selectivity}: != select_scan "
                                         "or plain")
            del got, other
            need = sparse_need(x, 0, hi)
            row = turns(lambda: select_scan.select_scan_sparse(x, y, 0, hi),
                        lambda: select_scan.select_scan(x, y, 0, hi),
                        calls=KERNEL_REPS)
            row.update(order=order, selectivity=selectivity,
                       count=need["count"],
                       bound_ms=max(need["bytes_ms"], need["ops_ms"]))
            row["bound_share"] = row["bound_ms"] / row["kernel_median"]
            report["cases"].append(row)
            print(f"select_scan_sparse {order} {selectivity} " +
                  json.dumps(row), flush=True)
    for side in ("kernel_median", "library_median", "bound_ms"):
        report[side] = sum(r[side] for r in report["cases"])
    print("select_scan_sparse 12 cases " + json.dumps(
        {k: v for k, v in report.items() if k != "cases"}), flush=True)
    return report


def build_turns(dev) -> dict:
    """Section 12: ``build`` of phase 10's six tables, each held
    byte-identical to ``ref.build`` first, then timed beside its
    bound."""
    from chip_smoke import HBM_BYTES_PER_S, JOIN_TABLE_KB, KERNEL_REPS, SEED
    from repro_torch import cases
    from repro_torch.kernels import hash_join, ref
    report = {}
    for kb in JOIN_TABLE_KB:
        host_keys, n_slots = cases.join_bench_keys(SEED, kb * 1024)
        keys = torch.from_numpy(host_keys).to(dev)
        vals = keys.clone()
        got = hash_join.build(keys, vals, n_slots)
        if not all(torch.equal(g, w) for g, w in
                   zip(got, ref.build(keys, vals, n_slots))):
            raise AssertionError(f"build {kb} KB: kernel != plain")
        del got
        row = {"table_KB": kb, "n_build": len(host_keys), "n_slots": n_slots,
               **rounds(lambda: hash_join.build(keys, vals, n_slots),
                        KERNEL_REPS),
               "bound_ms": 8 * (len(host_keys) + n_slots) / HBM_BYTES_PER_S
               * 1e3}
        report[f"{kb}KB"] = row
        print(f"build {kb} KB " + json.dumps(row), flush=True)
        del keys, vals
        torch.cuda.empty_cache()
    report["all_medians"] = sum(r["median"] for r in report.values())
    print("build six tables " + json.dumps(report["all_medians"]),
          flush=True)
    return report


def group_turns(db) -> dict:
    """Section 13: ``group_sum`` on the opat pass's calls, each held to
    the plain version and a second run first, then each call and the pass
    in turns with ``index_add_``."""
    from chip_smoke import (TURN_CALLS, check_against_plain, library_call,
                            opat_need, turns)
    from repro_torch.kernels import agg, ref
    from repro_torch.sql import hashtable
    calls = capture(agg, "group_sum", "opat", db,
                    hashtable.HashTableCache())
    index_add = library_call("group_sum")
    for query, k, args in calls:
        check_against_plain("group_sum", f"{query} call {k}",
                            agg.group_sum(*args), ref.group_sum(*args),
                            again=agg.group_sum(*args))

    def timed(args):
        need = opat_need("group_sum", args, None)
        return dict(turns(lambda: agg.group_sum(*args),
                          lambda: index_add(*args), calls=TURN_CALLS),
                    n=int(args[0].shape[0]), n_groups=args[2],
                    bound_ms=max(need["bytes_ms"], need["ops_ms"]))

    def whole_pass(fn):
        def run():
            for _, _, args in calls:
                fn(*args)
        return run
    row = {"calls": len(calls),
           "each": {query: timed(args) for query, _, args in calls},
           "pass": turns(whole_pass(agg.group_sum), whole_pass(index_add),
                         calls=5)}
    row["bound_ms"] = sum(c["bound_ms"] for c in row["each"].values())
    row["sum_of_medians"] = sum(c["kernel_median"]
                                for c in row["each"].values())
    row["index_add_sum_of_medians"] = sum(c["library_median"]
                                          for c in row["each"].values())
    print("group_sum opat " + json.dumps(row), flush=True)
    return {"group_sum_opat": row}


def sum_turns(dev) -> dict:
    """Section 5: ``reduce_sum`` of 2^28 random f32 rows in turns with
    ``torch.sum``, and of 2^28 random int32 rows alone, each beside the
    4n-byte bound and held to the plain version first."""
    from chip_smoke import HBM_BYTES_PER_S, KERNEL_REPS, SEED, SUM_ROWS, \
        turns
    from repro_torch.kernels import agg, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(SUM_ROWS, device=dev, generator=gen)
    xi = torch.randint(-(1 << 31), (1 << 31) - 1, (SUM_ROWS,), generator=gen,
                       device=dev, dtype=torch.int32)
    got, want = agg.reduce_sum(x), ref.reduce_sum(x)
    if abs(float(got) - float(want)) > abs(
            float(torch.nextafter(want, want + 1)) - float(want)):
        raise AssertionError("reduce_sum f32: more than 1 ulp from plain")
    if not torch.equal(agg.reduce_sum(xi), ref.reduce_sum(xi)):
        raise AssertionError("reduce_sum int32: kernel != plain")
    bound_ms = 4 * SUM_ROWS / HBM_BYTES_PER_S * 1e3
    row = turns(lambda: agg.reduce_sum(x), lambda: torch.sum(x),
                calls=KERNEL_REPS)
    row.update(n=SUM_ROWS, bound_ms=bound_ms, kernel_sum=got.item(),
               library_sum=torch.sum(x).item())
    print("reduce_sum f32 2^28 " + json.dumps(row), flush=True)
    row_i = dict(rounds(lambda: agg.reduce_sum(xi), KERNEL_REPS),
                 n=SUM_ROWS, bound_ms=bound_ms)
    print("reduce_sum int32 2^28 " + json.dumps(row_i), flush=True)
    return {"f32": row, "int32": row_i}


def hist_turns(db) -> dict:
    """Section 11: ``histogram`` on the part and part_loop passes' calls;
    each captured call held to the plain version and a second run first,
    then each pass, its largest calls and its small ones timed."""
    from chip_smoke import TURN_CALLS, opat_need
    from repro_torch.kernels import radix_part, ref
    from repro_torch.sql import hashtable
    cache = hashtable.HashTableCache()
    report = {}
    for strategy in ("part", "part_loop"):
        calls = capture(radix_part, "histogram", strategy, db, cache)
        for query, k, args in calls:
            got = radix_part.histogram(*args)
            if not (torch.equal(got, ref.histogram(*args)) and
                    torch.equal(got, radix_part.histogram(*args))):
                raise AssertionError(f"histogram {strategy} {query} call "
                                     f"{k}: kernel != plain or two runs "
                                     "differ")

        def bound_ms(args):
            need = opat_need("histogram", args, None)
            return max(need["bytes_ms"], need["ops_ms"])

        def timed(args):
            return dict(n=int(args[0].shape[0]), r=args[2], **rounds(
                lambda: radix_part.histogram(*args), TURN_CALLS),
                bound_ms=bound_ms(args))

        def whole_pass():
            for _, _, args in calls:
                radix_part.histogram(*args)
        largest = sorted(calls, key=lambda c: -c[2][0].shape[0])
        row = {"calls": len(calls),
               "rows": sum(int(a[0].shape[0]) for _, _, a in calls),
               "bits": [a[2] for _, _, a in calls],
               "pass": rounds(whole_pass, 5),
               "bound_ms": sum(bound_ms(a) for _, _, a in calls),
               "largest": {f"{q} call {k}": timed(args)
                           for q, k, args in largest[:HIST_LARGEST]},
               "small": {f"{q} call {k}": timed(args)
                         for q, k, args in calls
                         if args[0].shape[0] < HIST_SMALL_ROWS}}
        row["bound_share"] = row["bound_ms"] / row["pass"]["median"]
        report[f"histogram_{strategy}"] = row
        print(f"histogram {strategy} " + json.dumps(row), flush=True)
        del calls
        torch.cuda.empty_cache()
    return report


def fused_turns(db, pdb, dev, sections) -> dict:
    """Sections 6 and 7: ``spja`` on the 13 queries' calls and
    ``multi_spja`` on the waves' calls, plain and packed, each held to
    the plain version first, each call and the whole set timed."""
    from chip_smoke import WAVES
    from repro_torch.kernels import multi_fused, ref, ssb_fused
    from repro_torch.sql import engine, hashtable
    from repro_torch.sql.compile import fused_inputs, shared_params
    plans = engine.ssb_queries()
    cache = hashtable.HashTableCache()
    report = {}
    lib = ssb_fused.library()
    for kind, database in (("plain", db), ("packed", pdb)):
        calls = []
        for name, plan in plans.items():
            a, k = fused_inputs(plan, database, cache, dev)
            calls.append((name, functools.partial(ssb_fused.spja, *a, **k),
                          functools.partial(ref.spja, *a, **k), {
                              "n_groups": plan.n_groups}))
            if hasattr(ssb_fused, "launch_shape"):
                _, blocks = ssb_fused.launch_shape(
                    lib, dev.index, len(a[0]), len(a[2]), plan.n_groups)
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                calls[-1][3].update(block=ssb_fused.THREADS,
                                    blocks_per_sm=blocks // sms)
        if "spja" in sections:
            report[f"spja_{kind}"] = held_and_timed("spja", kind, calls)
        if "wave" not in sections:
            continue
        waves = []
        for wave, names in WAVES.items():
            members = [plans[q] for q in (names or plans)]
            _, a, k, n_groups = shared_params(
                members, database, cache=cache,
                pad_to=16 if names is None else None, device=dev)
            plain_kw = {x: v for x, v in k.items() if x != "member_groups"}
            info = {"members": len(members), "streams": len(a[2])}
            if "probe_groups" in k:
                info["probe_groups"] = [len(g) for g, _ in k["probe_groups"]]
            waves.append((wave, functools.partial(
                multi_fused.multi_spja, *a, n_groups=n_groups, **k),
                functools.partial(ref.multi_spja, *a, n_groups=n_groups,
                                  **plain_kw), info))
        report[f"wave_{kind}"] = held_and_timed("multi_spja", kind, waves)
    return report


def held_and_timed(fn: str, kind: str, calls: list) -> dict:
    """Each call held bit-identical to its plain version, then each call
    and all of them back to back timed in TURN_ROUNDS rounds."""
    from chip_smoke import KERNEL_REPS
    for name, call, plain, _ in calls:
        if not torch.equal(call(), plain()):
            raise AssertionError(f"{fn} {kind} {name}: kernel != plain")

    def every():
        for _, call, _, _ in calls:
            call()
    row = {"calls": {name: dict(info, **rounds(call, KERNEL_REPS))
                     for name, call, _, info in calls},
           "all": rounds(every, KERNEL_REPS)}
    print(f"{fn} {kind} " + json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    help="root of the checkout whose src/repro_torch to "
                    "import (default: this one)")
    ap.add_argument("--only", nargs="+", choices=SECTIONS,
                    default=list(SECTIONS), help="the sections to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str((args.tree or ROOT).resolve() / "src"))
    from chip_smoke import (HBM_BYTES_PER_S, KERNEL_REPS, PROJECT_ROWS, SEED,
                            SF, TURN_CALLS, event_ms, profiled, turns)
    from repro_torch.kernels import project as proj
    from repro_torch.kernels import radix_part as radix
    from repro_torch.sql import engine, hashtable, ssb
    from repro_torch.sql.compile import SORT_BITS, compile_plan

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    report = {"card": card, "tree": str(args.tree or ROOT),
              "one_sweep": hasattr(radix, "digit_counts")}

    if "join" in args.only:
        report["probe_agg"] = join_turns(dev)
    if "sparse" in args.only:
        report["select_scan_sparse"] = sparse_turns(dev)
    if "sum" in args.only:
        report["reduce_sum"] = sum_turns(dev)
    if "build" in args.only:
        report["build"] = build_turns(dev)
    if not DB_SECTIONS & set(args.only):
        print(json.dumps(report))
        return 0
    t0 = time.perf_counter()
    db = ssb.generate(sf=SF, seed=SEED)
    n = db.lineorder.n_rows
    print(f"setup_s {time.perf_counter() - t0:.3f}", flush=True)

    if "sort" in args.only:
        rng = np.random.default_rng(SEED)
        sort_keys = {
            "lo_orderdate": torch.from_numpy(db.lineorder["lo_orderdate"]),
            "random32": torch.from_numpy(rng.integers(
                -(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32))}
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        for name, host_keys in sort_keys.items():
            keys = host_keys.to(dev)
            got_k, got_v = radix.radix_sort(keys, vals, r=SORT_BITS)
            order = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF,
                               stable=True).indices.to(torch.int32)
            if not (torch.equal(got_v, order) and
                    torch.equal(got_k, keys[order])):
                raise AssertionError(f"radix_sort {name}: not a stable sort "
                                     "by the keys as unsigned words")
            row = turns(lambda: radix.radix_sort(keys, vals, r=SORT_BITS),
                        lambda: torch.sort(keys, stable=True), calls=1)
            row.update(n=n, bound_ms=16 * n / HBM_BYTES_PER_S * 1e3)
            if report["one_sweep"]:
                passes = radix.sort_passes(32, SORT_BITS)
                counts = radix.digit_counts(keys, 0, SORT_BITS, passes)
                row["passes_run"] = radix.pass_plan(counts.cpu(), n)
                row["counts_ms"] = event_ms(lambda: radix.digit_counts(
                    keys, 0, SORT_BITS, passes), TURN_CALLS)
                row["pass_ms"] = event_ms(lambda: radix.sweep(
                    keys, (vals,), 0, SORT_BITS, counts[0]), TURN_CALLS)
            else:
                hist = radix.histogram(keys, 0, SORT_BITS)

                def scan():
                    flat = hist.t().reshape(-1)
                    return torch.cumsum(flat, 0, dtype=torch.int32) - flat
                row["pass_histogram_ms"] = event_ms(
                    lambda: radix.histogram(keys, 0, SORT_BITS), TURN_CALLS)
                row["pass_offsets_ms"] = event_ms(scan, TURN_CALLS)
                row["pass_scatter_ms"] = event_ms(
                    lambda: radix.partition_multi(keys, (vals,), 0, SORT_BITS,
                                                  hist=hist), TURN_CALLS)
            report[f"radix_sort_{name}"] = row
            print(f"radix_sort {name} " + json.dumps(row), flush=True)
            del keys, got_k, got_v, order
        del vals
        torch.cuda.empty_cache()

    db.to(dev)
    if {"spja", "wave", "select"} & set(args.only):
        from repro_torch.sql import storage
        pdb = storage.pack_database(db).to(dev)
        if {"spja", "wave"} & set(args.only):
            report.update(fused_turns(db, pdb, dev, args.only))
        if "select" in args.only:
            report.update(select_turns(db, pdb))
        del pdb
        torch.cuda.empty_cache()
    if "project" in args.only:
        # the opat pass's project calls: q4's sub measure on its survivors
        cache = hashtable.HashTableCache()
        captured, kernel_project = [], proj.project

        def record(x1, x2, a, b, sigmoid=False):
            captured.append((x1.clone(), x2.clone(), a, b))
            return kernel_project(x1, x2, a, b, sigmoid=sigmoid)
        proj.project = record
        try:
            for name, plan in engine.ssb_queries().items():
                compile_plan(plan, "opat").execute(db, cache=cache)
        finally:
            proj.project = kernel_project
        for x1, x2, a, b in captured:
            if not torch.equal(proj.project(x1, x2, a, b), torch.sub(x1, x2)):
                raise AssertionError("project differs from torch.sub")

        def each(fn):
            def run():
                for x1, x2, a, b in captured:
                    fn(x1, x2, a, b)
            return run
        kernel_calls = each(proj.project)
        sub_calls = each(lambda x1, x2, a, b: torch.sub(x1, x2))
        row = turns(kernel_calls, sub_calls)
        calls = len(captured)
        row.update(rows=[int(c[0].shape[0]) for c in captured],
                   kernel_per_call_ms=row["kernel_median"] / calls,
                   library_per_call_ms=row["library_median"] / calls,
                   bound_ms=sum(12 * c[0].shape[0] for c in captured)
                   / HBM_BYTES_PER_S * 1e3)

        def profile(run):
            return profiled(lambda: [run() for _ in range(TURN_CALLS)])
        row["profile_kernel"] = profile(kernel_calls)
        row["profile_library"] = profile(sub_calls)
        report["project_opat"] = row
        print("project opat " + json.dumps(row), flush=True)
        del captured, cache
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(SEED)
        x1 = torch.randn(PROJECT_ROWS, device=dev, generator=gen)
        x2 = torch.randn(PROJECT_ROWS, device=dev, generator=gen)
        if not torch.equal(proj.project(x1, x2, 1.0, -1.0), torch.sub(x1, x2)):
            raise AssertionError("project differs from torch.sub at 2^28 rows")
        big = {"n": PROJECT_ROWS,
               "bound_ms": 12 * PROJECT_ROWS / HBM_BYTES_PER_S * 1e3}
        big["plain"] = turns(lambda: proj.project(x1, x2, 1.0, -1.0),
                             lambda: torch.sub(x1, x2), calls=KERNEL_REPS)
        big["sigmoid"] = turns(
            lambda: proj.project(x1, x2, 1.0, -1.0, sigmoid=True),
            lambda: torch.sub(x1, x2), calls=KERNEL_REPS)
        big["bound_share"] = big["bound_ms"] / big["plain"]["kernel_median"]
        report["project_2e28"] = big
        print("project 2^28 " + json.dumps(big), flush=True)
        del x1, x2
        torch.cuda.empty_cache()
    if "probe" in args.only:
        report.update(probe_turns(db))
    if "hist" in args.only:
        report.update(hist_turns(db))
    if "group" in args.only:
        report.update(group_turns(db))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
