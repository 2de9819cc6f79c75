"""Per-device empirical kernel tuner (measured, not modelled).

The port of ``repro.sql.tune``.  The reference sweeps each kernel
family's launch knobs on synthetic data, checks every swept
configuration against an oracle BEFORE timing it, and keeps the winners
beside the calibration (``repro_torch.sql.calibrate``).  The port's
kernels are each compiled with one launch shape (``compile.LAUNCH_SHAPES``;
the shapes that lost on the card are in PERF.md), so the reference's
``tile`` knob has nothing to choose here and is not swept.  What is
measured, family by family:

  select_scan — the scan rate the compaction kernel reaches
               (``eff_bw``: bytes read and written over the best time),
               at the calibration's streaming size (``STREAM_BYTES`` of
               the device's type: 2^27 rows on a card, the size of the
               SF 20 fact table).  It is recorded only at that size or
               above: a smaller call is bound by its launch's round trip,
               not by bandwidth, and would misprice every strategy.
  radix_sort — the digit width: the widths its kernel takes (r <=
               ``radix_part.MAX_BITS`` = 8 with passes x 2^r <= 1024 digit
               counts: ``radix_ok``).  The reference's r = 16 has no
               instance here.
  part_probe — the partitioned join's radix depth: ``ops.part_join`` at
               each depth of the grid on a build side the size of SF 20's
               part table (2^20 rows), every depth first held to the same
               rows and groups.  The winner goes back as a per-partition
               byte budget (``part_budget_bytes``) that makes
               ``model.part_bits`` — the execute path's and the cost
               model's — give the measured depth at the sweep's build
               size and scale it with table size.

The reference's ``digit`` knob (the pass width of its host LSD shuffle)
has no counterpart: the port partitions by all the bits in one kernel
pass.

Tie rule: a candidate replaces the default only when it is faster by
more than ``WIN_MARGIN``, so an inert knob keeps the default; a tuned
launch never changes an answer (every swept configuration is checked
first).

Winners persist in ``torch-tunings-{device type}-torch{version}-{device
name}.json`` beside the calibration file (``REPRO_CALIB_CACHE``, else
``~/.cache/repro``), with an in-process memo (under a lock: a serving
loop's worker reads it too); a torn file is discarded.

    PYTHONPATH=src python -m repro_torch.sql.tune              # card
    PYTHONPATH=src python -m repro_torch.sql.tune --device cpu --smoke
    PYTHONPATH=src python -m repro_torch.sql.tune --retune --json OUT
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cost.model import H100
from repro_torch.device import resolve
from repro_torch.kernels import ops, radix_part
from repro_torch.sql import calibrate
from repro_torch.sql.hashtable import build_dim_partitions

FAMILIES = ("select_scan", "radix_sort", "part_probe")

DEFAULT_R = 8                   # radix_sort's default digit width
WIN_MARGIN = 0.03               # a winner must beat the default by > 3 %

# n: radix_sort's and part_probe's probe rows; n_build: part_probe's build
# side (SF 20's part table is 1.0 M rows); n_scan: select_scan's rows,
# None for the calibration's streaming size on the device
FULL_GRID = dict(rs=(4, 5, 6, 7, 8), bits=(1, 2, 3, 4, 5, 6, 8),
                 n=1 << 24, n_build=1 << 20, n_scan=None, warmup=1, iters=3)
# a build side of 2^20 rows: the static rule gives 6 bits on the card
SMOKE_GRID = dict(rs=(4, 8), bits=(4, 8), n=1 << 24, n_build=1 << 20,
                  n_scan=None, warmup=1, iters=2)


def radix_ok(r: int) -> bool:
    """Whether ``radix_sort``'s kernel takes digit width ``r``: 1..8, and
    the passes' digit counts (passes x 2^r) fit its counters."""
    return (1 <= r <= radix_part.MAX_BITS and
            radix_part.sort_passes(32, r) << r <= radix_part.MAX_COUNTERS)


def scan_rows(device: torch.device) -> int:
    """``select_scan``'s rows at the calibration's streaming size on
    ``device``: two 4-byte inputs of ``STREAM_BYTES`` together."""
    return calibrate.STREAM_BYTES[device.type] // 8


@dataclass(frozen=True)
class TunedConfig:
    """Winner of one family's sweep.  ``r`` is ``radix_sort``'s digit
    width; ``part_bits``/``part_budget_bytes`` are set for ``part_probe``
    only; ``eff_bw`` is ``select_scan``'s measured rate (bytes touched
    over the best time) where it was measured at the streaming size —
    what ``apply_hardware`` folds into the cost model."""
    family: str
    width: int                  # packed-width bucket (32 = plain int32)
    r: Optional[int] = None
    part_bits: Optional[int] = None
    part_budget_bytes: Optional[int] = None
    best_us: float = 0.0
    default_us: float = 0.0
    eff_bw: Optional[float] = None

    @property
    def speedup(self) -> float:
        """Default over best time (1.0 when the default won)."""
        if self.best_us <= 0 or self.default_us <= 0:
            return 1.0
        return self.default_us / self.best_us


@dataclass(frozen=True)
class Tunings:
    """One device's sweep results."""
    backend: str                # device type: "cuda" or "cpu"
    fingerprint: str            # calibrate.fingerprint()
    measured_at: float
    configs: Dict[str, TunedConfig] = field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Tunings":
        fields_ = {f.name for f in dataclasses.fields(Tunings)}
        d = {k: v for k, v in d.items() if k in fields_}
        cfg_fields = {f.name for f in dataclasses.fields(TunedConfig)}
        d["configs"] = {
            k: TunedConfig(**{kk: vv for kk, vv in v.items()
                              if kk in cfg_fields})
            for k, v in dict(d.get("configs") or {}).items()}
        return Tunings(**d)


def _key(family: str, width: int = 32) -> str:
    return f"{family}/w{width}"


class TuneStore:
    """Lookup view over a :class:`Tunings` record, what ``sql/compile.py``
    and the cost model consult.  Unknown families and width buckets fall
    back to the defaults, so a store never makes a launch illegal; a
    missing packed bucket falls back to the family's plain (w32)
    winner."""

    def __init__(self, tunings: Tunings):
        self.tunings = tunings

    def get(self, family: str, width: int = 32) -> Optional[TunedConfig]:
        cfg = self.tunings.configs.get(_key(family, width))
        if cfg is None and width != 32:
            cfg = self.tunings.configs.get(_key(family, 32))
        return cfg

    def r(self, family: str = "radix_sort",
          default: int = DEFAULT_R) -> int:
        cfg = self.get(family)
        return cfg.r if cfg is not None and cfg.r and radix_ok(cfg.r) \
            else default

    def part_budget_bytes(self) -> Optional[int]:
        cfg = self.get("part_probe")
        return cfg.part_budget_bytes if cfg is not None else None

    def eff_read_bw(self) -> Optional[float]:
        cfg = self.get("select_scan")
        return cfg.eff_bw if cfg is not None else None


# ---------------------------------------------------------------------------
# disk cache (the calibration's directory, memo and torn-file discipline)
# ---------------------------------------------------------------------------


def _file(fingerprint: str) -> str:
    return os.path.join(calibrate.cache_dir(),
                        f"torch-tunings-{fingerprint}.json")


def cache_path(device=None) -> str:
    """The tunings file of ``device`` (the card unless named), beside the
    calibration file and keyed like it."""
    return _file(calibrate.fingerprint(device))


# memoizes absence too: compile consults the store at every launch
_MEMO: dict = {}
_LOCK = threading.Lock()


def save(tunings: Tunings) -> str:
    path = _file(tunings.fingerprint)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with _LOCK:
        with open(path, "w") as f:
            json.dump(tunings.to_json(), f, indent=1)
        _MEMO[path] = tunings
    return path


def load_cached(device=None) -> Optional[Tunings]:
    """The cached sweep results of ``device``, or None.  A corrupt file
    (torn write, schema drift, junk) is logged, removed and reported as
    none: the launches then take the defaults until a retune."""
    path = cache_path(device)
    with _LOCK:
        if path in _MEMO:
            return _MEMO[path]
        tunings = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    tunings = Tunings.from_json(json.load(f))
            except (ValueError, TypeError, KeyError, AttributeError,
                    OSError) as e:
                logging.getLogger(__name__).warning(
                    "discarding corrupt tuning cache %s (%s: %s); "
                    "launching with defaults until --retune", path,
                    type(e).__name__, e)
                tunings = None
                try:
                    os.remove(path)
                except OSError:
                    pass
        _MEMO[path] = tunings
        return tunings


def cached_store(device=None) -> Optional[TuneStore]:
    """The store when ``device`` has sweep results on disk, else None (the
    defaults): never measures."""
    tunings = load_cached(device)
    return None if tunings is None else TuneStore(tunings)


def tuned_r(family: str = "radix_sort", default: int = DEFAULT_R,
            device=None) -> int:
    st = cached_store(device)
    return st.r(family, default) if st is not None else default


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _bench(fn: Callable[[], object], device: torch.device, warmup: int = 1,
           iters: int = 3) -> float:
    """Least seconds of one call: CUDA events on a card (the call's host
    work included), the host clock on the CPU (``calibrate._bench``)."""
    return calibrate._bench(fn, device, warmup=warmup, iters=iters, reps=1)


def _pick(timed: List[Tuple[dict, float]], default_cfg: dict
          ) -> Tuple[dict, float, float]:
    """(winner config, winner seconds, default seconds).  The default must
    be in ``timed``; a candidate displaces it only when faster by more
    than WIN_MARGIN, so an inert knob ties within noise and the default
    survives."""
    default_s = next(s for c, s in timed if c == default_cfg)
    best_cfg, best_s = default_cfg, default_s
    for cfg, s in timed:
        if s < best_s * (1.0 - 1e-12) and s < default_s * (1 - WIN_MARGIN):
            best_cfg, best_s = cfg, s
    return best_cfg, best_s, default_s


def _assert_identical(family: str, cfg: dict, got, want) -> None:
    """Each of ``got`` equal to ``want``'s, in shape and every element
    (tensors are compared where they lie, so a sweep's check at the
    streaming size stays on the card)."""
    for g, w in zip(got, want):
        g = g if torch.is_tensor(g) else torch.as_tensor(np.asarray(g))
        w = w.to(g.device) if torch.is_tensor(w) else \
            torch.as_tensor(np.asarray(w), device=g.device)
        if g.shape != w.shape or not torch.equal(g, w.to(g.dtype)):
            raise AssertionError(
                f"tuner sweep {family} {cfg}: result differs from the "
                "oracle — refusing to time (a tuned config must never "
                "change answers)")


def _gen(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _sweep_select_scan(g: dict, gen, device) -> List[TunedConfig]:
    """Time the compaction at ``n_scan`` rows (the streaming size by
    default) after checking it; its rate is ``eff_bw`` only when the scan
    streams at least the calibration's bytes."""
    n = g.get("n_scan") or scan_rows(device)
    x = torch.randint(0, 1000, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    y = torch.arange(n, dtype=torch.int32, device=device)
    lo, hi = 100, 900
    want = y[(x >= lo) & (x <= hi)]

    def run():
        return ops.select_scan(x, y, lo, hi)

    sel, cnt = run()
    _assert_identical("select_scan", {}, (sel[:int(cnt)],), (want,))
    best = _bench(run, device, g["warmup"], g["iters"])
    moved = 2 * 4 * n + 4 * want.numel()
    streaming = 8 * n >= calibrate.STREAM_BYTES[device.type]
    return [TunedConfig("select_scan", 32, best_us=best * 1e6,
                        default_us=best * 1e6,
                        eff_bw=moved / best if streaming else None)]


def _sweep_radix_sort(g: dict, gen, device) -> List[TunedConfig]:
    n = g["n"]
    keys = torch.randint(0, 1 << 30, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device=device)
    sk, order = torch.sort(keys, stable=True)
    want = (sk, vals[order])
    rs = sorted({r for r in g["rs"] if radix_ok(r)} | {DEFAULT_R})
    timed = []
    for r in rs:
        cfg = {"r": r}
        _assert_identical("radix_sort", cfg, ops.radix_sort(keys, vals, r=r),
                          want)
        timed.append((cfg, _bench(lambda rr=r: ops.radix_sort(keys, vals,
                                                               r=rr),
                                  device, g["warmup"], g["iters"])))
    cfg, best, dflt = _pick(timed, {"r": DEFAULT_R})
    return [TunedConfig("radix_sort", 32, r=cfg["r"], best_us=best * 1e6,
                        default_us=dflt * 1e6)]


def _part_default_bits(n_build: int, device: torch.device) -> int:
    """The untuned radix depth for ``n_build``: the static rule on the
    device's published entry (``H100``, or ``HOST`` on the CPU), never a
    tuned hardware, so the sweep's baseline is what runs without it."""
    from repro_torch.sql import model as M
    return M.part_bits(n_build, hw=H100 if device.type == "cuda"
                       else M.HOST)


def _sweep_part_probe(g: dict, gen, device) -> List[TunedConfig]:
    """Sweep the partitioned join's radix depth, each depth first held to
    the same (rowid, group) pairs — every row, since every key hits a
    dense dimension — in rowid order (the output is partition-major, so
    its order depends on the depth; the aggregation downstream does not),
    then express the winner as a per-partition byte budget."""
    from repro_torch.sql import model as M
    n, n_build = g["n"], g["n_build"]
    fk = torch.randint(0, n_build, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    dimk = np.arange(n_build, dtype=np.int32)
    dimv = (dimk % 64).astype(np.int32)
    rowids = torch.arange(n, dtype=torch.int32, device=device)
    groups = torch.zeros(n, dtype=torch.int32, device=device)
    want_groups = torch.from_numpy(dimv).to(device)[fk.long()]
    default_bits = _part_default_bits(n_build, device)
    bits_grid = sorted(set(g["bits"]) | {default_bits})

    def by_row(out):
        outr, outg, cnt = out
        cnt = int(cnt)
        r, order = torch.sort(outr[:cnt], stable=True)
        return r, outg[:cnt][order]

    timed = []
    for b in bits_grid:
        parts = build_dim_partitions(None, None, b, side=(dimk, dimv),
                                     packed=True, device=device)

        def run(bb=b, p=parts):
            return ops.part_join(fk, rowids, groups, p.htk, p.htv, 1, bb)

        _assert_identical("part_probe", {"bits": b}, by_row(run()),
                          (rowids, want_groups))
        timed.append(({"bits": b}, _bench(run, device, g["warmup"],
                                          g["iters"])))
        del parts
    cfg, best, dflt = _pick(timed, {"bits": default_bits})
    best_bits = cfg["bits"]
    # the budget for which ceil(log2(ht_bytes / budget)) == best_bits at
    # this build size: 2/3 of ht / 2^(bits-1) lies inside that interval
    budget = int(M.ht_bytes(n_build) * 2 / (3 << (best_bits - 1)))
    return [TunedConfig("part_probe", 32, part_bits=best_bits,
                        part_budget_bytes=budget, best_us=best * 1e6,
                        default_us=dflt * 1e6)]


def measure(grid: Optional[dict] = None, seed: int = 0,
            device=None) -> Tunings:
    """Run every family's sweep on ``device`` (the card unless named) and
    return the winners (not saved: callers decide, :func:`save`)."""
    device = resolve(device)
    g = dict(FULL_GRID if grid is None else grid)
    configs: Dict[str, TunedConfig] = {}
    for i, sweep in enumerate((_sweep_select_scan, _sweep_radix_sort,
                               _sweep_part_probe)):
        for c in sweep(g, _gen(device, seed + i), device):
            configs[_key(c.family, c.width)] = c
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return Tunings(backend=device.type,
                   fingerprint=calibrate.fingerprint(device),
                   measured_at=time.time(), configs=configs)


def tuned_store(refresh: bool = False, grid: Optional[dict] = None,
                device=None) -> TuneStore:
    """Measure (or load the cached sweep) and return the store: the
    measuring counterpart of :func:`cached_store`."""
    tunings = None if refresh else load_cached(device)
    if tunings is None:
        tunings = measure(grid=grid, device=device)
        save(tunings)
    return TuneStore(tunings)


# ---------------------------------------------------------------------------
# Hardware integration (cost model feedback)
# ---------------------------------------------------------------------------


def apply_hardware(store: TuneStore, base):
    """``base`` with the tuner's feedback: the partitioned join's
    per-partition byte budget (so ``model.part_bits``, shared by the
    execute path and the cost model, gives the measured depth) and the
    scan rate ``select_scan`` reached at the streaming size (so
    strategies are priced at what a scan kernel moves, not the generic
    streaming read; a store without it keeps ``base``'s)."""
    kw = {}
    budget = store.part_budget_bytes()
    if budget:
        kw["part_budget_bytes"] = budget
    eff = store.eff_read_bw()
    if eff:
        kw["read_bw"] = eff
    if not kw:
        return base
    kw["name"] = base.name + "-tuned"
    return dataclasses.replace(base, **kw)


def tuned_hardware(base, device=None):
    """``base`` with the tuned feedback when ``device`` has sweep results
    cached, else ``base`` itself: reading the model never sweeps."""
    store = cached_store(device)
    return base if store is None else apply_hardware(store, base)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def describe(c: TunedConfig) -> str:
    """One line of a family's winner, as the CLI prints it."""
    knobs = []
    if c.r is not None:
        knobs.append(f"r={c.r}")
    if c.part_bits is not None:
        knobs.append(f"bits={c.part_bits} budget={c.part_budget_bytes}B")
    eff = f" eff_bw={c.eff_bw / 1e9:.2f}GB/s" if c.eff_bw else ""
    return (f"{_key(c.family, c.width):24s} {' '.join(knobs):32s} "
            f"{c.best_us:10.1f}us  ({c.speedup:.2f}x default{eff})")


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="empirical per-device kernel tuner; winners cached "
                    "beside the calibration")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--retune", action="store_true",
                    help="measure again even if a tunings file exists")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced sweep grid")
    ap.add_argument("--json", metavar="OUTDIR",
                    help="also write OUTDIR/TUNINGS.json")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    grid = SMOKE_GRID if args.smoke else None
    tunings = None if args.retune else load_cached(device)
    source = "cached"
    if tunings is None:
        tunings = measure(grid=grid, device=device)
        save(tunings)
        source = "measured"
    print(f"backend={tunings.backend} fingerprint={tunings.fingerprint} "
          f"({source}; cache={cache_path(device)})")
    for key in sorted(tunings.configs):
        print(describe(tunings.configs[key]))
    if args.json:
        os.makedirs(args.json, exist_ok=True)
        out = os.path.join(args.json, "TUNINGS.json")
        with open(out, "w") as f:
            json.dump(tunings.to_json(), f, indent=1)
        print(f"# wrote {out}")


if __name__ == "__main__":
    main()
