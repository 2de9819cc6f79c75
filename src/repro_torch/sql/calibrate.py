"""Measured rates for the cost model, on the caller's device.

The port of ``repro.sql.calibrate``.  The model's static entries are the
published rates (``cost.model.H100``) or a guess at the host (``HOST``);
strategy choice rests on the rates the device really reaches and on the
dispatch cost, so this module measures the five quantities the model
reads, with plain torch ops (the reference's microbenchmarks are plain
jnp, outside any kernel):

  read_bw   — a streaming sum over an array several times the cache (on
              the card 1 GiB, 20 times the 50 MB L2): one read pass;
  write_bw  — a triad ``a + 2b -> y``, the read time at the measured
              ``read_bw`` subtracted;
  cache_bw  — a random gather from a table inside the cache (on the card
              8 MB of the L2), priced per line like the model's probe term
              (§4.3), the index and output streams subtracted;
  launch_overhead_s — a tiny op, timed round trip to a synchronise: what
              each of a partition loop's 2^bits dispatches costs;
  interconnect_bw — over a process group of two or more ranks
              (``_measure_interconnect(..., group=)``, which every rank of
              the group calls), the reference's all-reduce microbenchmark: an
              f32 payload of ``ALLREDUCE_ELEMS`` a rank all-reduced, priced
              at the ring volume ``2(D-1) * elems * 4`` bytes over the
              slowest rank's time, with the group's backend beside it
              (``interconnect_backend``).  With no group, or a world of
              one, on a card the host-to-device copy rate from host memory
              page-locked in place, as a morsel's upload reads it
              (``morsel_pipeline_time``'s link), PCIe as in the paper's
              Table 2 (backend ``"h2d"``; the reference gives None on one
              device); None on the CPU, as in the reference.

Every time on the card is taken with CUDA events around launches queued
back to back, or ends at a synchronise, never at the enqueue.

Results are cached as JSON (the directory is ``REPRO_CALIB_CACHE``, else
``~/.cache/repro``, as the reference's; the file is the port's own, keyed
on the device type, the torch version and the device name), so a
measurement runs once a machine and ``model.default_hardware`` reads it
for free.  A corrupt file is discarded and measured again.

    PYTHONPATH=src python -m repro_torch.sql.calibrate               # card
    PYTHONPATH=src python -m repro_torch.sql.calibrate --device cpu
    PYTHONPATH=src python -m repro_torch.sql.calibrate --refresh --json OUT
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.cost.model import H100, Hardware
from repro_torch.device import resolve

# sizes per device type: the stream dwarfs the last cache, the gather
# table sits well inside it (the host's are the reference's)
STREAM_BYTES = {"cuda": 1 << 30, "cpu": 1 << 26}
GATHER_TABLE_BYTES = {"cuda": 8 << 20, "cpu": 1 << 16}
GATHER_PROBES = {"cuda": 1 << 26, "cpu": 1 << 21}
LINE_BYTES = {"cuda": H100.line_bytes, "cpu": 64}
H2D_BYTES = 256 << 20
ALLREDUCE_ELEMS = 1 << 20       # f32 a rank, the reference's payload


@dataclass(frozen=True)
class Calibration:
    backend: str                # device type: "cuda" or "cpu"
    read_bw: float              # B/s
    write_bw: float
    cache_bw: float
    launch_overhead_s: float
    measured_at: float          # unix time
    interconnect_bw: Optional[float] = None     # B/s; None on the CPU
    device_name: str = "cpu"
    # what interconnect_bw crossed: "nccl" or "gloo" (an all-reduce over
    # a group), "h2d" (the host link), None (nothing, on the CPU)
    interconnect_backend: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Calibration":
        fields = {f.name for f in dataclasses.fields(Calibration)}
        return Calibration(**{k: v for k, v in d.items() if k in fields})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench(fn: Callable[[], object], device: torch.device, warmup: int = 2,
           iters: int = 5, reps: int = 4) -> float:
    """Seconds a call: the least over ``iters`` of the mean of ``reps``
    back-to-back calls (bandwidth wants the unperturbed run), from CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            s = time.perf_counter() - t0
        best = min(best, s / reps)
    return best


def _round_trip(fn: Callable[[], object], device: torch.device,
                warmup: int = 4, iters: int = 20) -> float:
    """The least seconds of one call timed on the host from its start to
    a synchronise: the launch and its completion, as a dispatch costs a
    loop that waits on each."""
    for _ in range(warmup):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def interconnect_backend(device: torch.device, group=None) -> Optional[str]:
    """What :func:`_measure_interconnect` measures on ``device`` with
    ``group``: the group's backend over two or more ranks, else ``"h2d"``
    on a card, None on the CPU."""
    if _world_of(group) >= 2:
        return str(dist.get_backend(group))
    return "h2d" if device.type == "cuda" else None


def _measure_allreduce(device: torch.device, group, warmup: int = 2,
                       iters: int = 5) -> float:
    """The reference's all-reduce rate over ``group`` in B/s: the ring
    volume ``2(D-1) * elems * 4`` over the least seconds of one
    ``all_reduce`` of ``elems = ALLREDUCE_ELEMS`` f32 a rank (host clock to a synchronise:
    gloo stages a card's tensors through the host), the slowest rank's
    least, so every rank returns the same rate.  A collective: every rank
    of ``group`` calls it."""
    d, elems = _world_of(group), ALLREDUCE_ELEMS
    x = torch.ones(elems, dtype=torch.float32, device=device)
    best = float("inf")
    for i in range(warmup + iters):
        _sync(device)
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        _sync(device)
        if i >= warmup:
            best = min(best, time.perf_counter() - t0)
    slowest = torch.tensor([best], dtype=torch.float64, device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
    return float(2.0 * (d - 1) * elems * 4 / slowest.item())


def _measure_interconnect(device: torch.device,
                          n_bytes: int = H2D_BYTES,
                          group=None) -> Optional[float]:
    """The interconnect rate of ``device`` in B/s: over a ``group`` of two
    or more ranks the all-reduce rate (:func:`_measure_allreduce`, a
    collective); otherwise the host-to-device copy rate as a morsel
    crosses it (a host array page-locked in place, ``morsel.page_lock``,
    copied asynchronously), or None on the CPU (no link to cross)."""
    if _world_of(group) >= 2:
        return _measure_allreduce(device, group)
    if device.type != "cuda":
        return None
    from repro_torch.sql.morsel import page_lock
    host = np.ones(n_bytes, np.uint8)
    start, end = page_lock(host)
    at = host.ctypes.data
    src = torch.from_numpy(host[start - at:end - at])
    dst = torch.empty(src.shape[0], dtype=torch.uint8, device=device)
    t = _bench(lambda: dst.copy_(src, non_blocking=True), device, reps=2)
    return float(src.shape[0] / t)


def measure(device=None, stream_bytes: Optional[int] = None,
            table_bytes: Optional[int] = None,
            probes: Optional[int] = None,
            line_bytes: Optional[int] = None,
            h2d_bytes: int = H2D_BYTES) -> Calibration:
    """Run the microbenchmarks on ``device`` (the card unless named), at
    the sizes of its type unless given."""
    device = resolve(device)
    kind = device.type
    n = (stream_bytes or STREAM_BYTES[kind]) // 4
    m = (table_bytes or GATHER_TABLE_BYTES[kind]) // 4
    probes = probes or GATHER_PROBES[kind]
    line = line_bytes or LINE_BYTES[kind]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn(n, generator=gen, device=device)
    b = torch.randn(n, generator=gen, device=device)
    y = torch.empty_like(a)

    # read: one streaming pass, a scalar out
    read_bw = 4 * n / _bench(lambda: torch.sum(a), device)
    # triad: reads two columns, writes one -> solve for write_bw given
    # read_bw, the residual floored at a tenth of the triad (a read rate
    # that swallows the whole triad must not give a nonsense write rate)
    t_triad = _bench(lambda: torch.add(a, b, alpha=2.0, out=y), device)
    write_bw = 4 * n / max(t_triad - 2 * 4 * n / read_bw, t_triad * 0.1)
    del a, b, y

    # random gather from a cache-resident table, priced per line like
    # the model's probe term, the index and output streams subtracted
    table = torch.arange(m, dtype=torch.int32, device=device)
    idx = torch.randint(0, m, (probes,), generator=gen, device=device)
    out = torch.empty(probes, dtype=torch.int32, device=device)
    t_gather = _bench(lambda: torch.index_select(table, 0, idx, out=out),
                      device)
    stream_s = probes * (idx.element_size() / read_bw + 4 / write_bw)
    cache_bw = probes * line / max(t_gather - stream_s, t_gather * 0.1)
    del table, idx, out

    tiny = torch.zeros(8, dtype=torch.int32, device=device)
    t_launch = _round_trip(lambda: tiny + 1, device)
    return Calibration(backend=kind, read_bw=float(read_bw),
                       write_bw=float(write_bw), cache_bw=float(cache_bw),
                       launch_overhead_s=float(t_launch),
                       measured_at=time.time(),
                       interconnect_bw=_measure_interconnect(device,
                                                             h2d_bytes),
                       device_name=_device_name(device),
                       interconnect_backend=interconnect_backend(device))


# ---------------------------------------------------------------------------
# disk cache
# ---------------------------------------------------------------------------


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def cache_dir() -> str:
    """Directory of the calibration cache: ``REPRO_CALIB_CACHE``, else
    ``~/.cache/repro``."""
    return os.environ.get("REPRO_CALIB_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro")


def _key(backend: str, device_name: str) -> str:
    key = f"{backend}-torch{torch.__version__}-{device_name}"
    return re.sub(r"[^A-Za-z0-9._-]+", "-", key).strip("-").lower()


def _path(backend: str, device_name: str) -> str:
    return os.path.join(cache_dir(),
                        f"torch-calibration-{_key(backend, device_name)}"
                        ".json")


def fingerprint(device=None) -> str:
    """``device``'s cache key (the card unless named): its type, the torch
    version and the device name — the tuner's file shares it."""
    device = resolve(device)
    return _key(device.type, _device_name(device))


def cache_path(device=None) -> str:
    """The calibration file of ``device`` (the card unless named): one per
    device type, torch version and device name, so an upgrade or another
    card measures again instead of reading stale rates."""
    device = resolve(device)
    return _path(device.type, _device_name(device))


# in-process memo over the disk cache: ``model.default_hardware`` sits on
# the per-query auto path, so the JSON is read once a path (absent too);
# a serving loop's worker reads it beside the caller's thread, so under a
# lock
_MEMO: dict = {}
_LOCK = threading.Lock()


def save(calib: Calibration) -> str:
    path = _path(calib.backend, calib.device_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with _LOCK:
        with open(path, "w") as f:
            json.dump(calib.to_json(), f, indent=1)
        _MEMO[path] = calib
    return path


def load_cached(device=None) -> Optional[Calibration]:
    """The cached calibration of ``device``, or None when there is none.
    A corrupt or truncated file (torn write, wrong schema, junk) is
    logged, removed and reported as none, so the caller measures again
    and writes a fresh one."""
    path = cache_path(device)
    with _LOCK:
        if path in _MEMO:
            return _MEMO[path]
        calib = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    calib = Calibration.from_json(json.load(f))
            except (ValueError, TypeError, KeyError, AttributeError,
                    OSError) as e:
                logging.getLogger(__name__).warning(
                    "discarding corrupt calibration cache %s (%s: %s); "
                    "will re-measure", path, type(e).__name__, e)
                calib = None
                try:
                    os.remove(path)
                except OSError:
                    pass
        _MEMO[path] = calib
        return calib


# ---------------------------------------------------------------------------
# Hardware integration
# ---------------------------------------------------------------------------


def apply(calib: Calibration, base: Hardware) -> Hardware:
    """``base`` with its rates replaced by the measured ones.  Geometry
    (cache size, line bytes, capacity) stays the base's: the
    microbenchmarks measure rates, not topology.  The interconnect rate
    replaces the base's only where one was measured (on a card)."""
    kw = dict(name=base.name + "-calibrated",
              read_bw=calib.read_bw, write_bw=calib.write_bw,
              cache_bw=calib.cache_bw,
              launch_overhead_s=calib.launch_overhead_s)
    if calib.interconnect_bw:
        kw["interconnect_bw"] = calib.interconnect_bw
    return dataclasses.replace(base, **kw)


def calibrated_hardware(base: Hardware, device=None,
                        refresh: bool = False) -> Hardware:
    """Measure on ``device`` (or load its cached measurement) and fold
    it into ``base``."""
    calib = None if refresh else load_cached(device)
    if calib is None:
        calib = measure(device)
        save(calib)
    return apply(calib, base)


def cached_hardware(base: Hardware, device=None) -> Optional[Hardware]:
    """The calibrated Hardware when ``device`` has a cached measurement,
    else None: reading the model never starts a measurement."""
    calib = load_cached(device)
    return None if calib is None else apply(calib, base)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="measure memory rates, launch overhead and the host "
                    "link for the cost model; cached per device")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--refresh", action="store_true",
                    help="measure again even if a cache exists")
    ap.add_argument("--json", metavar="OUTDIR",
                    help="also write OUTDIR/CALIBRATION.json")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    calib = None if args.refresh else load_cached(device)
    source = "cached"
    if calib is None:
        calib = measure(device)
        save(calib)
        source = "measured"
    print(f"device={calib.device_name} ({calib.backend}, torch "
          f"{torch.__version__}; {source}; cache={cache_path(device)})")
    print(f"read_bw={calib.read_bw / 1e9:.2f} GB/s")
    print(f"write_bw={calib.write_bw / 1e9:.2f} GB/s")
    print(f"cache_bw={calib.cache_bw / 1e9:.2f} GB/s")
    print(f"launch_overhead={calib.launch_overhead_s * 1e6:.2f} us")
    if calib.interconnect_bw:
        print(f"interconnect_bw={calib.interconnect_bw / 1e9:.2f} GB/s "
              f"({calib.interconnect_backend})")
    else:
        print("interconnect_bw=n/a (no host link on the CPU)")
    if args.json:
        os.makedirs(args.json, exist_ok=True)
        out = os.path.join(args.json, "CALIBRATION.json")
        with open(out, "w") as f:
            json.dump(calib.to_json(), f, indent=1)
        print(f"# wrote {out}")


if __name__ == "__main__":
    main()
