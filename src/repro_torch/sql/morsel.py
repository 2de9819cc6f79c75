"""MorselStream: bounded device memory for a fact table on the host.

The port of ``repro.sql.morsel``.  The fact table is cut into morsels of
a fixed byte budget (row ranges re-sliced by ``storage.slice_rows``),
every executor in ``sql.compile`` folds over the stream, and the uploads
are double-buffered: morsel N+1's columns go to the card while morsel N
computes, so at most two morsels of fact columns are on the device,
whatever the scale factor.

Cut geometry
------------
Cuts land on multiples of ``LANE`` (32) rows, a word boundary of every
packed width, so a packed morsel is a window of its parent's word
stream: no decode, no repack.  The rows per morsel come from the budget
over the table's encoded bytes a row of the columns the query scans,
floored at one lane.

Uploads
-------
The upload of a morsel runs on a side CUDA stream: each scanned column
of the cut (a plain column's values, a packed column's word window) is
copied with ``non_blocking`` from host memory that is page-locked in
place (``cudaHostRegister`` of the whole pages of the array that owns
the column's memory, once), so the copy engine reads it straight from the table, with
no staging copy on the host.  An event fences the upload; the compute
stream waits on it and ``record_stream`` marks each uploaded tensor as
read there, so the caching allocator hands its memory out again only
after the kernels that read it.  The uploaded tensors are the morsel
table's device copies (``Table.on_device``), which the executor reads;
a finished morsel drops them.  On the CPU the same fold runs with no
streams.

A fact table made resident with ``Database.to(device)`` is one morsel:
its columns are already where the kernels read them.  Otherwise the
stream reads the host arrays and never makes the whole table resident.

Delta batches
-------------
Append-only batches (``storage.append_rows``) are spliced in after the
base rows, each cut by the same geometry: queries see ingested rows with
no flush and no repack of the base.

Accounting
----------
``MorselReport`` carries ``n_morsels`` and ``peak_resident_bytes``: the
largest encoded bytes of two adjacent morsels' scanned columns (while
morsel N computes, only N and N+1 are on the device).
"""
from __future__ import annotations

import mmap
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.sql import faults
from repro_torch.sql import storage as ST

# Morsel cuts land on multiples of LANE rows: one int32-word boundary of
# every packed width (lcm of 32/phys for phys in PHYS_WIDTHS).
LANE = 32

# Default per-morsel budget, the reference's: every test database stays
# one morsel and takes the whole-table pass.
DEFAULT_MORSEL_BYTES = 64 << 20

# host memory page-locked in place: (start, end) of the locked pages -> the
# finalizer that unlocks them when the array owning them goes
_REGISTERED: Dict[Tuple[int, int], weakref.finalize] = {}
_PAGE = mmap.PAGESIZE


def rows_per_morsel(bytes_per_row: float, morsel_bytes: int) -> int:
    """LANE-aligned row count whose encoded footprint fits the budget
    (floored at one lane: a sub-lane budget still makes progress, it
    just overshoots to 32 rows)."""
    if bytes_per_row <= 0:
        return LANE
    rows = int(morsel_bytes // bytes_per_row)
    return max(LANE, (rows // LANE) * LANE)


def plan_cuts(n_rows: int, rows_per: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` row ranges covering ``[0, n_rows)`` in
    ``rows_per``-row steps (the tail morsel is shorter; an empty table
    yields no cuts)."""
    return [(lo, min(lo + rows_per, n_rows))
            for lo in range(0, n_rows, rows_per)]


@dataclass(frozen=True)
class Morsel:
    """One fact-table cut: a table of ``hi - lo`` rows plus where it
    came from (``base`` rows are offset ``lo`` of the base table; delta
    morsels carry their batch index)."""
    table: object                # sliced Table / PackedTable
    lo: int                      # row range within its source
    hi: int
    source: str = "base"         # "base" | "delta"
    batch: int = -1              # delta batch index ("delta" only)
    offset: int = 0              # global row index of row ``lo`` in the
    #   base+deltas concatenation (row-plan folds offset their
    #   morsel-local survivor ids by this)

    @property
    def n_rows(self) -> int:
        return self.hi - self.lo


@dataclass
class MorselReport:
    """Per-query out-of-core accounting (mutated by the fold)."""
    n_morsels: int = 0
    peak_resident_bytes: int = 0

    def observe(self, resident_bytes: int) -> None:
        self.n_morsels += 1
        if resident_bytes > self.peak_resident_bytes:
            self.peak_resident_bytes = resident_bytes


def scanned_morsel_bytes(table, cols: Optional[Iterable[str]]) -> int:
    """Encoded bytes of the columns a query actually streams from one
    morsel (all columns when ``cols`` is None)."""
    if isinstance(table, ST.PackedTable):
        if cols is None:
            return table.nbytes
        return sum(table.encoding(c).nbytes for c in cols)
    names = table.columns if cols is None else cols
    return sum(4 * len(table.columns[c]) for c in names)


def _host_array(table, col: str) -> np.ndarray:
    """What a column uploads from: a plain column's int32 values, a packed
    column's word stream."""
    if isinstance(table, ST.PackedTable):
        return table.columns[col].words
    return table.columns[col]


def _owner(arr: np.ndarray) -> np.ndarray:
    """The array that owns ``arr``'s memory: the last ndarray in its chain
    of bases (a view keeps its owner alive, so the owner outlives every
    view of it)."""
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


def _unregister(start: int, end: int) -> None:
    """Unlock the pages ``page_lock`` locked, and forget them: another
    array may later be allocated at the same addresses."""
    del _REGISTERED[start, end]
    torch.cuda.cudart().cudaHostUnregister(start)


def page_lock(arr: np.ndarray) -> Tuple[int, int]:
    """Page-lock the memory of a host array in place (``cudaHostRegister``,
    once per owning array) so the copy engine reads it with no staging
    copy.  The lock covers the whole pages inside the array that owns the
    memory, so every view of it shares one lock and two arrays never
    claim one page; it is undone when the owner goes.  Returns the locked
    address range ``(start, end)`` (empty when the owner spans no whole
    page)."""
    own = _owner(arr)
    start = -(-own.ctypes.data // _PAGE) * _PAGE
    end = (own.ctypes.data + own.nbytes) // _PAGE * _PAGE
    if not own.flags.c_contiguous or end <= start:
        return (0, 0)
    if (start, end) not in _REGISTERED:
        rc = int(torch.cuda.cudart().cudaHostRegister(start, end - start,
                                                      0))
        if rc != 0:
            raise RuntimeError(f"cudaHostRegister of {end - start} bytes "
                               f"failed: CUDA error {rc}")
        _REGISTERED[start, end] = weakref.finalize(own, _unregister, start,
                                                   end)
    return start, end


def upload(host: np.ndarray, device: torch.device,
           locked: Tuple[int, int]) -> torch.Tensor:
    """A contiguous int32 host view as a tensor on ``device``, queued on
    the current stream: the part inside the ``locked`` pages in one
    asynchronous copy, and the few values outside them (in the array's
    first and last partial pages, which a copy must not mix with locked
    ones) in copies of their own."""
    n = host.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=device)
    src = torch.from_numpy(host)
    a = host.ctypes.data
    lo = min(max((locked[0] - a) // 4, 0), n)
    hi = min(max((locked[1] - a) // 4, lo), n)
    for i, j in ((0, lo), (lo, hi), (hi, n)):
        if j > i:
            out[i:j].copy_(src[i:j], non_blocking=True)
    return out


class MorselStream:
    """The bounded-memory scan spine: cuts a fact table (base rows plus
    any pending delta batches) into LANE-aligned morsels under a byte
    budget and drives the double-buffered fold every executor uses, on
    ``device`` (the card unless named).

    ``n_morsels == 1`` is the in-memory case — the single morsel IS the
    table (no slice, no copy), so small databases, and a fact table made
    resident on the device, take the whole-table pass.
    """

    def __init__(self, table, morsel_bytes: int = DEFAULT_MORSEL_BYTES,
                 cols: Optional[Iterable[str]] = None, device=None):
        self.table = table
        self.device = resolve(device)
        self.morsel_bytes = int(morsel_bytes)
        self.cols = list(dict.fromkeys(cols)) if cols is not None else None
        self.deltas = ST.delta_batches(table)
        if table.is_pinned(self.device):
            self.rows_per = max(table.n_rows, 1)
        else:
            self.rows_per = rows_per_morsel(self._bytes_per_row(table),
                                            self.morsel_bytes)
        self._items: List[Tuple[object, int, int, str, int, int]] = []
        for lo, hi in plan_cuts(table.n_rows, self.rows_per):
            self._items.append((table, lo, hi, "base", -1, lo))
        rows_per = rows_per_morsel(self._bytes_per_row(table),
                                   self.morsel_bytes)
        off = table.n_rows
        for bi, batch in enumerate(self.deltas):
            for lo, hi in plan_cuts(batch.n_rows, rows_per):
                self._items.append((batch, lo, hi, "delta", bi, off + lo))
            off += batch.n_rows
        self._side: Optional[torch.cuda.Stream] = None
        self._ready: Dict[int, torch.cuda.Event] = {}

    def _names(self, table) -> List[str]:
        return self.cols if self.cols is not None else list(table.columns)

    def _bytes_per_row(self, table) -> float:
        names = self._names(table)
        if isinstance(table, ST.PackedTable):
            return sum(table.encoding(c).bytes_per_row for c in names)
        return 4.0 * len(names)

    @property
    def n_morsels(self) -> int:
        return len(self._items)

    @property
    def total_rows(self) -> int:
        return self.table.n_rows + sum(b.n_rows for b in self.deltas)

    def morsel_nbytes(self, i: int) -> int:
        """Encoded bytes of the scanned columns of morsel ``i`` (exact
        per-cut math, no slicing needed)."""
        src, lo, hi, _, _, _ = self._items[i]
        if isinstance(src, ST.PackedTable):
            total = 0
            for c in self._names(src):
                e = src.encoding(c)
                if e.kind == "plain":
                    total += 4 * (hi - lo)
                else:
                    vw = e.values_per_word
                    total += 4 * ((hi + vw - 1) // vw - lo // vw)
            return total
        return 4 * len(self._names(src)) * (hi - lo)

    def peak_resident_bytes(self) -> int:
        """The double-buffer bound: the largest encoded footprint of any
        two adjacent morsels (just the largest single morsel when the
        stream has one)."""
        sizes = [self.morsel_nbytes(i) for i in range(self.n_morsels)]
        if not sizes:
            return 0
        if len(sizes) == 1:
            return sizes[0]
        return max(a + b for a, b in zip(sizes, sizes[1:]))

    def morsels(self) -> Iterator[Morsel]:
        """Materialize each cut lazily.  A single-item stream of the
        whole base table yields the table itself (identity — the
        in-memory pass keeps its resident column uploads)."""
        for src, lo, hi, kind, bi, off in self._items:
            if lo == 0 and hi == src.n_rows:
                yield Morsel(src, lo, hi, kind, bi, off)
            else:
                yield Morsel(ST.slice_rows(src, lo, hi), lo, hi, kind, bi,
                             off)

    def fold(self, compute: Callable[[Morsel], object],
             report: Optional[MorselReport] = None) -> List[object]:
        """Run ``compute`` over every morsel with double-buffered
        uploads: morsel N+1's copy is issued on the side stream before
        morsel N computes, so copy and compute overlap and at most two
        morsels are on the device.  Returns the per-morsel results in
        stream order; ``report`` (if given) accumulates n_morsels and the
        residency peak.  A fault anywhere releases both buffers."""
        results: List[object] = []
        it = self.morsels()
        cur = next(it, None)
        if cur is not None:
            try:
                self._prefetch(cur)
            except Exception:
                self._release(cur, keep=None)
                raise
        i = 0
        while cur is not None:
            nxt = next(it, None)
            try:
                if nxt is not None:
                    self._prefetch(nxt)
                if report is not None:
                    resident = self.morsel_nbytes(i)
                    if nxt is not None:
                        resident += self.morsel_nbytes(i + 1)
                    report.observe(resident)
                self._await(cur)
                results.append(compute(cur))
            except Exception:
                # a fault at morsel k must not leave either in-flight
                # buffer on the device
                self._release(cur, keep=None)
                if nxt is not None:
                    self._release(nxt, keep=None)
                raise
            self._release(cur, keep=nxt)
            cur, i = nxt, i + 1
        return results

    def _prefetch(self, m: Morsel) -> None:
        """Issue the host-to-device copy of a morsel's scanned columns
        (on the card: on the side stream, from page-locked host memory,
        fenced by an event the compute stream waits on).  The in-memory
        identity, the whole base table, uploads nothing here: the
        executor reads its columns through ``on_device``'s cache."""
        faults.maybe_fault("upload")
        if m.table is self.table:
            return
        names = self._names(m.table)
        if self.device.type != "cuda":
            for c in names:
                m.table.on_device(c, self.device)
            return
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        src = self.table if m.source == "base" else self.deltas[m.batch]
        locked = {c: page_lock(_host_array(src, c)) for c in names}
        with torch.cuda.stream(self._side):
            for c in names:
                _keep_device_copy(m.table, c, self.device, upload(
                    np.ascontiguousarray(_host_array(m.table, c), np.int32),
                    self.device, locked[c]))
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._ready[id(m.table)] = ev

    def _await(self, m: Morsel) -> None:
        """Before a morsel computes: the compute stream waits for its
        upload, and each uploaded tensor is marked as read there."""
        ev = self._ready.pop(id(m.table), None)
        if ev is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ev)
        for t in _device_copies(m.table, self.device):
            t.record_stream(compute)

    def _release(self, m: Morsel, keep: Optional[Morsel]) -> None:
        """Drop a finished morsel's device copies and decode memos —
        unless the morsel IS the base table (the in-memory pass keeps its
        uploads) or the next morsel's."""
        if m.table is self.table or (keep is not None
                                     and m.table is keep.table):
            return
        self._ready.pop(id(m.table), None)
        m.table.release(device=True)


def _keep_device_copy(table, col: str, device: torch.device,
                      t: torch.Tensor) -> None:
    """Make ``t`` the column's device copy, which ``on_device`` (and so
    the executor) reads."""
    if isinstance(table, ST.PackedTable):
        table.columns[col]._resident[str(device)] = t
    else:
        table._resident[col, str(device)] = t


def _device_copies(table, device: torch.device) -> List[torch.Tensor]:
    """The device copies of a morsel table's columns on ``device``."""
    dev = str(device)
    if isinstance(table, ST.PackedTable):
        return [t for c in table.columns.values()
                for d, t in c._resident.items() if d == dev]
    return [t for (_, d), t in table._resident.items() if d == dev]
