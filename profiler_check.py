#!/usr/bin/env python3
"""Show which device records torch.profiler keeps of a fixed run, as the
process ages, on one card.

    python3 profiler_check.py [--seconds 150] [--every 15]

The run is 25 kernels in a known order: a fill (F), ten matmuls (m), a
fill, ``reduce_sum``'s two kernels (r, f), ten matmuls, a fill.  Every
``--every`` seconds (the card kept busy with matmuls between) it is
profiled twice: alone, and after ``chip_smoke.PROFILE_HEAD`` tiny spin
kernels (S, left out of the line) that ``chip_smoke.profiled`` runs
first for the profiler to lose in the run's place.  Each line gives the
seconds since the first run, the kernel launches the host recorded (the
spin kernels' left out), the device records kept and their order; a
lost record is a letter missing from ``FmmmmmmmmmmFrfmmmmmmmmmmF``.
Prints the card's name and power limit first.  Exits nonzero without
CUDA.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
LETTERS = (("Fill", "F"), ("gemm", "m"), ("reduce_sum", "r"),
           ("finish_sum", "f"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=150)
    ap.add_argument("--every", type=float, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import PROFILE_HEAD
    from repro_torch.kernels import agg

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    cuda = torch.autograd.DeviceType.CUDA
    x = torch.ones(1 << 26, dtype=torch.int32, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    b = torch.empty_like(a)
    c = torch.empty(1 << 20, device=dev)

    def run():
        c.fill_(1.0)
        for _ in range(10):
            torch.mm(a, a, out=b)
        agg.reduce_sum(x)
        for _ in range(10):
            torch.mm(a, a, out=b)
        c.fill_(2.0)

    run()
    t0 = time.perf_counter()
    at = 0.0
    while at <= args.seconds:
        while time.perf_counter() - t0 < at:
            for _ in range(50):
                torch.mm(a, a, out=b)
            torch.cuda.synchronize()
            time.sleep(0.05)
        for head in (0, PROFILE_HEAD):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(head):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                run()
                torch.cuda.synchronize()
            events = list(prof.events())
            launches = sum(e.device_type != cuda and "LaunchKernel" in e.name
                           for e in events) - head
            kept = sorted((e for e in events if e.device_type == cuda
                           and "spin_kernel" not in e.name),
                          key=lambda e: e.time_range.start)
            line = "".join(next((ch for sub, ch in LETTERS if sub in e.name),
                                "?") for e in kept)
            print(f"after_s {time.perf_counter() - t0:.1f} head {head} "
                  f"launches {launches} kept {len(kept)} {line}", flush=True)
        at += args.every
    return 0


if __name__ == "__main__":
    sys.exit(main())
