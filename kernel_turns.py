"""Time the port's radix sort and projection kernels in turns beside the
PyTorch call that computes the same function, on one card.

    python3 kernel_turns.py [--tree PATH]

``--tree`` imports ``PATH/src/repro_torch`` in place of the checkout's
(say a ``git archive`` of an earlier commit unpacked under ``build/``),
so two commits are compared by running the script once for each, in
turns (parent, change, change, parent), in one call on the card.

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

Prints the card's name and power limit first and one JSON object last.
Exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    help="root of the checkout whose src/repro_torch to "
                    "import (default: this one)")
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

    t0 = time.perf_counter()
    db = ssb.generate(sf=SF, seed=SEED)
    n = db.lineorder.n_rows
    rng = np.random.default_rng(SEED)
    sort_keys = {
        "lo_orderdate": torch.from_numpy(db.lineorder["lo_orderdate"]),
        "random32": torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32))}
    print(f"setup_s {time.perf_counter() - t0:.3f}", flush=True)

    vals = torch.arange(n, dtype=torch.int32, device=dev)
    for name, host_keys in sort_keys.items():
        keys = host_keys.to(dev)
        got_k, got_v = radix.radix_sort(keys, vals, r=SORT_BITS)
        order = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF,
                           stable=True).indices.to(torch.int32)
        if not (torch.equal(got_v, order) and torch.equal(got_k, keys[order])):
            raise AssertionError(f"radix_sort {name}: not a stable sort by "
                                 "the keys as unsigned words")
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

    # the opat pass's project calls: q4's sub measure on its survivors
    db.to(dev)
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
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
