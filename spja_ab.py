"""Time the fused SPJA kernel, the shared-scan kernel or the select
sweep against other builds of it, in turns, on one card.

    python3 spja_ab.py [--other PATH/ssb_fused.cu ...] [--packed]
                       [--pairs 10] [--sf 20] [--seed 20]
    python3 spja_ab.py --kernel multi_spja [--other PATH/multi_fused.cu]
                       [--acc-budget 0] [--wave q1.1 --wave q1.1,q1.2 ...]
    python3 spja_ab.py --kernel select_scan [--other PATH/select_scan.cu]
                       [--packed]

Builds the checkout's ``src/repro_torch/kernels/csrc/ssb_fused.cu`` (or
``multi_fused.cu``) and each source named by ``--other`` (a variant of
the kernel: a header resolves in its own directory first, then in the
checkout's ``csrc``) with the same ``nvcc`` flags.  Then it generates the
SSB database at ``--sf`` on the card and times the kernel's launches:
for ``spja`` the 13 queries', the calls ``compile.fused_inputs`` gives
and ``chip_smoke.py`` phase 4 times; for ``multi_spja`` the waves of
``chip_smoke.WAVES`` (the 13 queries padded to 16 members, flight 1,
flight 2, flights 2 + 4) or those ``--wave`` names (one of those, or
comma-separated queries), the calls ``compile.shared_params`` gives and
phase 9 times; for ``select_scan`` the calls of one opat pass of the 13
queries (``kernel_turns.capture``), and with ``--packed`` the
``select_scan_packed`` calls of one opat pass on the packed database in
place of the plain calls.  Without ``--other`` the other build is the
checkout's
own source; ``--acc-budget`` runs the other builds with
``multi_fused.ACC_BUDGET_BYTES`` set to that many bytes (the
shared-memory grid of the wave kernel's smallest members).  A round is
the sum of the calls' means over ``chip_smoke.KERNEL_REPS`` launches
with one library; pair i runs the builds in order for even i and in
reverse for odd i.  With ``--packed`` the same pairs then run on
``storage.pack_database`` of the database.

Another source must take the checkout's C interface: ``spja_launch``
with its arguments by one pointer and ``spja_shape`` (since the ninth
slice), ``multi_spja_launch`` with probe groups in its words and
``multi_spja_shape``, or ``select_scan_launch`` with its arguments by one
pointer and ``select_scan_shape`` (since the tenth).  A source of the interface before (the eighth
slice's and earlier) is refused with a message and exit code 2: compare
commits with ``kernel_turns.py --tree`` instead.  Before any timing,
each query's result from every build must equal this build's and the
plain version's bit for bit.

Prints the card's name and power limit, every build's ptxas register
lines, every round, and as its last line one JSON object with the
rounds, the medians and the pairs each build won against this one, in
all and per call.  Exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def registers(log: str) -> list:
    return [line.strip() for line in log.splitlines() if "registers" in line]


# a symbol of each kernel's C interface since the ninth slice
INTERFACE = {"spja": "spja_shape", "multi_spja": "multi_spja_shape",
             "select_scan": "select_scan_shape"}


class OldInterface(Exception):
    """Another source takes the C interface of an earlier slice."""


def build_other(build, src: Path, signatures, symbol: str = "") -> tuple:
    """Compile ``src`` as ``build`` compiles the checkout's kernels; the
    library and its ptxas log.  Raises ``OldInterface`` when the library
    lacks ``symbol``."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=build.BUILD_DIR)) / "other.so"
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{src}: nvcc exited {res.returncode}\n"
                           f"{res.stdout}")
    lib = ctypes.CDLL(str(out))
    if symbol and not hasattr(lib, symbol):
        raise OldInterface(f"{src} lacks {symbol}: it takes the C interface "
                           "of an earlier slice, which this script cannot "
                           "drive; compare commits with kernel_turns.py "
                           "--tree")
    sigs = {"kernel_error_string": (ctypes.c_char_p, [ctypes.c_int]),
            **signatures}
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib, res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("spja", "multi_spja",
                                         "select_scan"),
                    default="spja")
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="an ssb_fused.cu (or multi_fused.cu) to compare "
                    "with (repeat)")
    ap.add_argument("--acc-budget", type=int,
                    help="multi_spja: the other side's ACC_BUDGET_BYTES")
    ap.add_argument("--wave", action="append",
                    help="multi_spja: a wave of chip_smoke.WAVES or of "
                    "comma-separated query names (repeat; default: all of "
                    "chip_smoke.WAVES)")
    ap.add_argument("--packed", action="store_true",
                    help="also time the packed database")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sf", type=float, default=20)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spja_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import KERNEL_REPS, WAVES, event_ms, outputs
    from kernel_turns import capture
    from repro_torch.kernels import (build, multi_fused, ref, select_scan,
                                     ssb_fused)
    from repro_torch.sql import engine, hashtable, ssb, storage
    from repro_torch.sql.compile import fused_inputs, shared_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    mod, lib_name = {"spja": (ssb_fused, "ssb_fused"),
                     "multi_spja": (multi_fused, "multi_fused"),
                     "select_scan": (select_scan, "select_scan")
                     }[args.kernel]
    own = build.CSRC / f"{lib_name}.cu"
    others = [(str(p), p.resolve()) for p in args.other] or \
        [(str(own), own)]
    this_log = build.build(lib_name) or "(built earlier)"
    libs, logs = {"this": mod.library()}, {"this": registers(this_log)}
    print("this", logs["this"])
    for name, src in others:
        try:
            libs[name], log = build_other(build, src, mod._SIGNATURES,
                                          INTERFACE[args.kernel])
        except OldInterface as e:
            print(f"spja_ab: {e}", file=sys.stderr)
            return 2
        logs[name] = registers(log)
        print("other", name, logs[name], flush=True)
    budgets = {name: multi_fused.ACC_BUDGET_BYTES
               if name == "this" or args.acc_budget is None
               else args.acc_budget for name in libs}

    def with_lib(name, fn):
        saved = mod.library, multi_fused.ACC_BUDGET_BYTES
        mod.library = lambda: libs[name]
        multi_fused.ACC_BUDGET_BYTES = budgets[name]
        try:
            return fn()
        finally:
            mod.library, multi_fused.ACC_BUDGET_BYTES = saved

    t0 = time.perf_counter()
    db = ssb.generate(sf=args.sf, seed=args.seed)
    db.to(dev)
    cache = hashtable.HashTableCache()
    plans = engine.ssb_queries()
    databases = {"plain": db}
    if args.packed:
        databases["packed"] = storage.pack_database(db).to(dev)
        if args.kernel == "select_scan":
            del databases["plain"]
    print(f"setup_s {time.perf_counter() - t0:.3f}", flush=True)

    def spja_calls(database):
        """(name, the kernel's call, its plain version's) per query."""
        out = []
        for name, plan in plans.items():
            a, k = fused_inputs(plan, database, cache, dev)
            out.append((name, functools.partial(ssb_fused.spja, *a, **k),
                        functools.partial(ref.spja, *a, **k)))
        return out

    def wave_calls(database):
        """(name, the kernel's call, its plain version's) per wave."""
        waves = WAVES if not args.wave else {
            w: WAVES[w] if w in WAVES else tuple(w.split(","))
            for w in args.wave}
        out = []
        for wave, names in waves.items():
            members = [plans[q] for q in (names or plans)]
            _, a, k, n_groups = shared_params(
                members, database, cache=cache,
                pad_to=16 if names is None else None)
            plain_kw = {x: v for x, v in k.items() if x != "member_groups"}
            out.append((wave, functools.partial(
                multi_fused.multi_spja, *a, n_groups=n_groups, **k),
                functools.partial(ref.multi_spja, *a, n_groups=n_groups,
                                  **plain_kw)))
        return out

    def select_calls(database):
        """(name, the kernel's call, its plain version's) per captured
        call of one opat pass."""
        fn = "select_scan_packed" if database is not db else "select_scan"
        return [(f"{q} call {k}",
                 functools.partial(getattr(select_scan, fn), *a),
                 functools.partial(getattr(ref, fn), *a))
                for q, k, a in capture(select_scan, fn, "opat", database,
                                       cache)]

    report = {"kernel": args.kernel, "others": [o[0] for o in others],
              "acc_budget": budgets, "pairs": args.pairs,
              "kernel_reps": KERNEL_REPS, "registers": logs}
    for kind, database in databases.items():
        calls = {"spja": spja_calls, "multi_spja": wave_calls,
                 "select_scan": select_calls}[args.kernel](database)
        for name, call, plain in calls:
            want = plain()
            for lib in libs:
                got = with_lib(lib, call)
                if not all(torch.equal(g, w) for g, w in
                           zip(outputs(got), outputs(want))):
                    raise AssertionError(f"{kind} {name}: the {lib} build "
                                         "differs from the plain version")

        def round_ms(lib):
            return with_lib(lib, lambda: [
                event_ms(call, KERNEL_REPS) for _, call, _ in calls])

        def summary(this_ms, other_ms):
            return {"this_median": statistics.median(this_ms),
                    "other_median": statistics.median(other_ms),
                    "this_wins": sum(t < o for t, o in zip(this_ms,
                                                            other_ms))}

        order = list(libs)
        rounds = {lib: [] for lib in order}
        for i in range(args.pairs):
            for lib in order if i % 2 == 0 else order[::-1]:
                rounds[lib].append(round_ms(lib))
            print(f"{kind} pair {i}: " + " ".join(
                f"{lib} {sum(rounds[lib][-1])}" for lib in order),
                flush=True)
        total = {lib: [sum(r) for r in rounds[lib]] for lib in order}
        report[kind] = {
            "ms": total, "median": {lib: statistics.median(total[lib])
                                    for lib in order},
            "against_this": {
                lib: {**summary(total["this"], total[lib]),
                      "calls": {name: summary([r[i] for r in rounds["this"]],
                                              [r[i] for r in rounds[lib]])
                                for i, (name, _, _) in enumerate(calls)}}
                for lib in order[1:]}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
