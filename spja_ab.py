"""Time the fused SPJA kernel against another build of it, in turns, on
one card.

    python3 spja_ab.py --other PATH/ssb_fused.cu [--packed] [--pairs 10]
                       [--sf 20] [--seed 20]

Builds the checkout's ``src/repro_torch/kernels/csrc/ssb_fused.cu`` and
the other source with the same ``nvcc`` flags (a header resolves in the
other file's own directory first, then in the checkout's ``csrc``),
generates the SSB database at ``--sf`` on the card and times the 13
queries' kernel launches, the calls ``compile.fused_inputs`` gives and
``chip_smoke.py`` phase 4 times.  A round is the sum of the 13 per-query
means over ``chip_smoke.KERNEL_REPS`` launches with one library; pair i
runs this build then the other for even i, the other first for odd i.
With ``--packed`` the same pairs then run on ``storage.pack_database``
of the database.

The other source must take the checkout's C interface or a prefix of it
(a build from before packed streams reads only the plain fields, so it
can run the plain database but not ``--packed``).  Before any timing,
each query's result from the other build must equal this build's and the
plain version's bit for bit.

Prints the card's name and power limit, both builds' ptxas register
lines, every round, and as its last line one JSON object with the
rounds, the medians and the pairs each build won.  Exits nonzero without
CUDA.
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
    ap.add_argument("--other", type=Path, required=True,
                    help="the ssb_fused.cu to compare with")
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
    from chip_smoke import KERNEL_REPS, event_ms
    from repro_torch.kernels import build, ref, ssb_fused
    from repro_torch.sql import engine, hashtable, ssb, storage
    from repro_torch.sql.compile import fused_inputs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    this_log = build.build("ssb_fused") or "(built earlier)"
    libs = {"this": ssb_fused.library()}
    libs["other"], other_log = build_other(build, args.other.resolve(),
                                           ssb_fused._SIGNATURES)
    print("this", registers(this_log))
    print("other", args.other, registers(other_log), flush=True)

    def with_lib(name, fn):
        saved = ssb_fused.library
        ssb_fused.library = lambda: libs[name]
        try:
            return fn()
        finally:
            ssb_fused.library = saved

    t0 = time.perf_counter()
    db = ssb.generate(sf=args.sf, seed=args.seed)
    db.to(dev)
    cache = hashtable.HashTableCache()
    plans = engine.ssb_queries()
    databases = {"plain": db}
    if args.packed:
        databases["packed"] = storage.pack_database(db).to(dev)
    print(f"setup_s {time.perf_counter() - t0:.3f}", flush=True)

    report = {"other": str(args.other), "pairs": args.pairs,
              "kernel_reps": KERNEL_REPS,
              "this_registers": registers(this_log),
              "other_registers": registers(other_log)}
    for kind, database in databases.items():
        calls = [fused_inputs(plan, database, cache, dev)
                 for plan in plans.values()]
        for name, (a, k) in zip(plans, calls):
            want = ref.spja(*a, **k)
            for lib in libs:
                got = with_lib(lib, functools.partial(ssb_fused.spja, *a, **k))
                if not torch.equal(got, want):
                    raise AssertionError(f"{kind} {name}: the {lib} build "
                                         "differs from the plain version")

        def round_ms(lib):
            return with_lib(lib, lambda: sum(
                event_ms(functools.partial(ssb_fused.spja, *a, **k),
                         KERNEL_REPS) for a, k in calls))

        rounds = {"this": [], "other": []}
        for i in range(args.pairs):
            for lib in ("this", "other") if i % 2 == 0 else ("other", "this"):
                rounds[lib].append(round_ms(lib))
            print(f"{kind} pair {i}: this {rounds['this'][-1]} "
                  f"other {rounds['other'][-1]}", flush=True)
        report[kind] = {
            "this_ms": rounds["this"], "other_ms": rounds["other"],
            "this_median": statistics.median(rounds["this"]),
            "other_median": statistics.median(rounds["other"]),
            "this_wins": sum(t < o for t, o in zip(rounds["this"],
                                                    rounds["other"]))}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
