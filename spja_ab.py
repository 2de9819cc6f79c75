"""Time the fused SPJA kernel, or the shared-scan kernel, against another
build of it, in turns, on one card.

    python3 spja_ab.py --other PATH/ssb_fused.cu [--packed] [--pairs 10]
                       [--sf 20] [--seed 20]
    python3 spja_ab.py --kernel multi_spja --other PATH/multi_fused.cu ...
    python3 spja_ab.py --kernel multi_spja --acc-budget 0 \
                       [--wave q1.1 --wave q1.1,q1.2,q1.3 ...]

Builds the checkout's ``src/repro_torch/kernels/csrc/ssb_fused.cu`` (or
``multi_fused.cu``) and the other source with the same ``nvcc`` flags (a
header resolves in the other file's own directory first, then in the
checkout's ``csrc``), generates the SSB database at ``--sf`` on the card
and times the kernel's launches: for ``spja`` the 13 queries', the calls
``compile.fused_inputs`` gives and ``chip_smoke.py`` phase 4 times; for
``multi_spja`` the waves of ``chip_smoke.WAVES`` (the 13 queries padded
to 16 members, flight 1, flight 2, flights 2 + 4) or those ``--wave``
names (one of those, or comma-separated queries), the calls
``compile.shared_params`` gives and phase 9 times.  Without ``--other``
the other build is the checkout's own source; ``--acc-budget`` runs the
other side with ``multi_fused.ACC_BUDGET_BYTES`` set to that many bytes
(the shared-memory grid of the wave kernel's smallest members).  A round
is the sum of the calls' means over ``chip_smoke.KERNEL_REPS`` launches
with one library; pair i runs this build then the other for even i, the other
first for odd i.  With ``--packed`` the same pairs then run on
``storage.pack_database`` of the database.

The other source must take the checkout's C interface or a prefix of it
(a build from before packed streams reads only the plain fields, so it
can run the plain database but not ``--packed``).  Before any timing,
each query's result from the other build must equal this build's and the
plain version's bit for bit.

Prints the card's name and power limit, both builds' ptxas register
lines, every round, and as its last line one JSON object with the
rounds, the medians and the pairs each build won, in all and per call.
Exits nonzero without CUDA.
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


def build_other(build, src: Path, signatures) -> tuple:
    """Compile ``src`` as ``build`` compiles the checkout's kernels; the
    library and its ptxas log."""
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
    sigs = {"kernel_error_string": (ctypes.c_char_p, [ctypes.c_int]),
            **signatures}
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib, res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("spja", "multi_spja"),
                    default="spja")
    ap.add_argument("--other", type=Path,
                    help="the ssb_fused.cu (or multi_fused.cu) to compare "
                    "with (default: the checkout's)")
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
    from chip_smoke import KERNEL_REPS, WAVES, event_ms
    from repro_torch.kernels import build, multi_fused, ref, ssb_fused
    from repro_torch.sql import engine, hashtable, ssb, storage
    from repro_torch.sql.compile import fused_inputs, shared_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    mod, lib_name = {"spja": (ssb_fused, "ssb_fused"),
                     "multi_spja": (multi_fused, "multi_fused")}[args.kernel]
    other = args.other or build.CSRC / f"{lib_name}.cu"
    this_log = build.build(lib_name) or "(built earlier)"
    libs = {"this": mod.library()}
    libs["other"], other_log = build_other(build, other.resolve(),
                                           mod._SIGNATURES)
    print("this", registers(this_log))
    print("other", other, registers(other_log), flush=True)
    budgets = {"this": multi_fused.ACC_BUDGET_BYTES,
               "other": multi_fused.ACC_BUDGET_BYTES
               if args.acc_budget is None else args.acc_budget}

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

    report = {"kernel": args.kernel, "other": str(other),
              "acc_budget": budgets, "pairs": args.pairs,
              "kernel_reps": KERNEL_REPS,
              "this_registers": registers(this_log),
              "other_registers": registers(other_log)}
    for kind, database in databases.items():
        calls = (spja_calls if args.kernel == "spja" else
                 wave_calls)(database)
        for name, call, plain in calls:
            want = plain()
            for lib in libs:
                got = with_lib(lib, call)
                if not torch.equal(got, want):
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

        rounds = {"this": [], "other": []}
        for i in range(args.pairs):
            for lib in ("this", "other") if i % 2 == 0 else ("other", "this"):
                rounds[lib].append(round_ms(lib))
            print(f"{kind} pair {i}: this {sum(rounds['this'][-1])} "
                  f"other {sum(rounds['other'][-1])}", flush=True)
        this_ms = [sum(r) for r in rounds["this"]]
        other_ms = [sum(r) for r in rounds["other"]]
        report[kind] = {
            "this_ms": this_ms, "other_ms": other_ms,
            **summary(this_ms, other_ms),
            "calls": {name: summary([r[i] for r in rounds["this"]],
                                    [r[i] for r in rounds["other"]])
                      for i, (name, _, _) in enumerate(calls)}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
