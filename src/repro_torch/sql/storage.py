"""Compressed columnar storage: per-column lightweight encodings.

The port of ``repro.sql.storage``, with the word layout bit for bit:

  plain    — raw int32 passthrough (domain needs the full word)
  bitpack  — values packed ``phys`` bits each into int32 words, lanes
             within a word (value k of a word lives at bit ``k*phys``)
  for      — frame-of-reference: ``value - ref`` bit-packed

``phys`` is the logical width (minimal bits for the domain) rounded up
to a divisor of 32 (1, 2, 4, 8, 16, 32), so values never span words and
a decode is one shift and one mask.  Once the fused pass streams at the
memory rate, moving fewer bytes is the only way left to go faster.

Decode has three consumers, and only the first materializes:

  * ``PackedColumn.decode()`` / ``table[col]`` — host paths (the numpy
    oracle, ``pred_mask``, the hash build, ``db_fingerprint``);
  * ``column_stream`` — the (words, phys, ref) triple the CUDA kernels
    (``spja``, ``select_scan_packed``) decode in registers;
  * ``take`` — the gather-decode of the operator-at-a-time chain: only
    the words the row ids touch move.

Range predicates on packed columns are rewritten into the encoded domain
at lowering time (``encoded_bounds``), so the kernels compare raw lanes.

Device residency: ``PackedColumn.on_device`` uploads the word stream
once per (column, device), as ``ssb.Table.on_device`` does for a plain
column, and ``PackedTable`` answers ``on_device``/``resident_bytes``
like ``ssb.Table``, so ``column_stream`` and ``Database.to`` treat both
kinds alike.

Append-only delta batches (``append_rows``) ride on a table without a
repack of its base columns; the morsel stream (``repro_torch.sql.morsel``)
splices them in after the base rows, so queries see ingested rows with
no flush, and ``flush_deltas`` compacts them into one fresh table.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.common import PHYS_WIDTHS, gather_decode
from repro_torch.sql import ssb

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

# ``PackedColumn.decode()`` pins its full-width result only while the
# decoded column stays under this budget; larger columns decode on
# demand (``decode_range`` for windows) and ``release`` drops the pin.
DECODE_MEMO_LIMIT = 1 << 24             # 16 MiB decoded bytes


def phys_width(width: int) -> int:
    """Smallest lane-aligned physical width >= the logical width."""
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")
    return next(p for p in PHYS_WIDTHS if p >= width)


@dataclass(frozen=True)
class ColumnEncoding:
    """Per-column encoding descriptor — the one source of the layout
    rule shared by the numpy decode, ``take`` and the CUDA kernels."""
    kind: str                   # "plain" | "bitpack" | "for"
    width: int                  # logical bits: minimal for (max - ref)
    phys: int                   # physical bits per value: 1,2,4,8,16,32
    ref: int                    # frame of reference (0 unless kind="for")
    n_rows: int

    @property
    def values_per_word(self) -> int:
        return 32 // self.phys

    @property
    def bytes_per_row(self) -> float:
        """Encoded bytes per value as streamed (4.0 for plain)."""
        return self.phys / 8.0

    @property
    def nbytes(self) -> int:
        """Total encoded bytes of the stored column."""
        if self.kind == "plain":
            return 4 * self.n_rows
        c = self.values_per_word
        return 4 * ((self.n_rows + c - 1) // c)


def bits_for(span: int) -> int:
    """Minimal width that represents values in [0, span]."""
    return max(int(span).bit_length(), 1)


def encoding_from_stats(vmin: int, vmax: int, n: int) -> ColumnEncoding:
    """The cheapest encoding from min/max statistics alone: ``bitpack``
    (ref 0) when the zero-referenced width lands on the same physical
    width as the frame-of-reference one, else ``for``; ``plain`` when
    packing would not shrink the column (phys 32)."""
    if n == 0:
        return ColumnEncoding("plain", 32, 32, 0, 0)
    vmin, vmax = int(vmin), int(vmax)
    w_for = bits_for(vmax - vmin)
    if phys_width(w_for) >= 32:
        return ColumnEncoding("plain", 32, 32, 0, n)
    if vmin >= 0 and phys_width(bits_for(vmax)) == phys_width(w_for):
        w = bits_for(vmax)
        return ColumnEncoding("bitpack", w, phys_width(w), 0, n)
    return ColumnEncoding("for", w_for, phys_width(w_for), vmin, n)


def choose_encoding(values: np.ndarray) -> ColumnEncoding:
    """The cheapest encoding for a materialized column."""
    n = len(values)
    if n == 0:
        return ColumnEncoding("plain", 32, 32, 0, 0)
    return encoding_from_stats(int(values.min()), int(values.max()), n)


# ---------------------------------------------------------------------------
# encode / decode (numpy)
# ---------------------------------------------------------------------------


def pack_words(values: np.ndarray, width: int, ref: int = 0) -> np.ndarray:
    """Pack ``values - ref`` into int32 words, ``phys_width(width)`` bits
    per value, lane k of a word at bit ``k*phys``.  Values must satisfy
    ``0 <= v - ref < 2**width``; the result is the int32 view of the
    uint32 word stream."""
    enc = np.asarray(values).astype(np.int64) - int(ref)
    if enc.size and (enc.min() < 0 or enc.max() >= (1 << width)):
        raise ValueError(
            f"values out of range for width={width} ref={ref}: "
            f"[{int(enc.min()) + ref}, {int(enc.max()) + ref}]")
    phys = phys_width(width)
    if phys == 32:
        return enc.astype(np.uint32).view(np.int32)
    c = 32 // phys
    pad = (-len(enc)) % c
    enc = np.pad(enc, (0, pad)).astype(np.uint32).reshape(-1, c)
    shifts = (np.arange(c, dtype=np.uint32) * phys).astype(np.uint32)
    return np.bitwise_or.reduce(enc << shifts[None, :], axis=1).view(np.int32)


def unpack_words(words: np.ndarray, n: int, width: int,
                 ref: int = 0) -> np.ndarray:
    """The exact inverse of :func:`pack_words` for the first ``n``
    values."""
    phys = phys_width(width)
    w = np.asarray(words).view(np.uint32)
    if phys == 32:
        vals = w.astype(np.int64)
        if width < 32:          # width<32 values are stored zero-extended
            vals &= (1 << width) - 1
    else:
        c = 32 // phys
        shifts = (np.arange(c, dtype=np.uint32) * phys).astype(np.uint32)
        vals = ((w[:, None] >> shifts[None, :])
                & np.uint32((1 << phys) - 1)).reshape(-1).astype(np.int64)
    return (vals[:n] + int(ref)).astype(np.int32)


# ---------------------------------------------------------------------------
# packed tables
# ---------------------------------------------------------------------------


@dataclass
class PackedColumn:
    """One encoded column.  ``np.asarray(col)`` (and ``decode()``) gives
    the original int32 values, so host paths stay transparent, while
    ``on_device`` serves the packed word stream the kernels read."""
    encoding: ColumnEncoding
    words: np.ndarray                   # packed stream (plain: raw data)
    _decoded: Optional[np.ndarray] = field(default=None, repr=False)
    # device -> resident word stream; filled by ``on_device``
    _resident: Dict[str, torch.Tensor] = field(default_factory=dict,
                                               repr=False)

    def decode(self) -> np.ndarray:
        if self.encoding.kind == "plain":
            return self.words
        if self._decoded is not None:
            return self._decoded
        e = self.encoding
        out = unpack_words(self.words, e.n_rows, e.width, e.ref)
        if 4 * e.n_rows <= DECODE_MEMO_LIMIT:
            self._decoded = out
        return out

    def decode_range(self, lo: int, hi: int) -> np.ndarray:
        """Decode rows ``[lo, hi)`` touching only the words that hold
        them."""
        if self.encoding.kind == "plain":
            return self.words[lo:hi]
        if self._decoded is not None:
            return self._decoded[lo:hi]
        e = self.encoding
        c = e.values_per_word
        w0, w1 = lo // c, (hi + c - 1) // c
        vals = unpack_words(self.words[w0:w1], (w1 - w0) * c, e.width,
                            e.ref)
        return vals[lo - w0 * c: hi - w0 * c]

    def release(self, device: bool = False) -> None:
        """Drop the pinned decode (and, with ``device=True``, the
        uploaded word streams)."""
        self._decoded = None
        if device:
            self._resident.clear()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.decode()
        if dtype is not None and arr.dtype != np.dtype(dtype):
            return arr.astype(dtype)
        if copy:
            return arr.copy()
        return arr

    def __len__(self) -> int:
        return self.encoding.n_rows

    def on_device(self, device) -> torch.Tensor:
        """The word stream (a plain column: its int32 values) on
        ``device``, uploaded on first use and held for every later
        query."""
        device = resolve(device)
        dev = str(device)
        t = self._resident.get(dev)
        if t is None:
            t = ssb.host_to_device(self.words, device)
            self._resident[dev] = t
        return t


@dataclass
class PackedTable:
    """Drop-in ``ssb.Table``: ``table[col]`` returns decoded numpy (host
    paths and the oracle never notice); the lowering asks
    :func:`column_stream` / :func:`encoding_of` instead."""
    name: str
    columns: Dict[str, PackedColumn]
    # devices the whole table was made resident on (``pin``)
    _pinned: Set[str] = field(default_factory=set, repr=False,
                              compare=False)

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col].decode()

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def encoding(self, col: str) -> ColumnEncoding:
        return self.columns[col].encoding

    @property
    def nbytes(self) -> int:
        return sum(c.encoding.nbytes for c in self.columns.values())

    @property
    def plain_nbytes(self) -> int:
        return sum(4 * c.encoding.n_rows for c in self.columns.values())

    def on_device(self, col: str, device) -> torch.Tensor:
        """The column's word stream on ``device`` (see
        :meth:`PackedColumn.on_device`)."""
        return self.columns[col].on_device(device)

    def resident_bytes(self, device) -> int:
        dev = str(resolve(device))
        return sum(t.numel() * t.element_size()
                   for c in self.columns.values()
                   for d, t in c._resident.items() if d == dev)

    def pin(self, device) -> None:
        """Upload every word stream to ``device`` and keep the table
        there (see ``ssb.Table.pin``)."""
        for col in self.columns.values():
            col.on_device(device)
        self._pinned.add(str(resolve(device)))

    def is_pinned(self, device) -> bool:
        return str(resolve(device)) in self._pinned

    def release(self, device: bool = False) -> None:
        """Release every column's pinned decode (see
        :meth:`PackedColumn.release`), and the delta batches' too; with
        ``device=True`` the table is no longer resident."""
        for col in self.columns.values():
            col.release(device=device)
        for batch in delta_batches(self):
            batch.release(device=device)
        if device:
            self._pinned.clear()


def pack_column(values: np.ndarray,
                enc: Optional[ColumnEncoding] = None) -> PackedColumn:
    values = np.asarray(values, np.int32)
    enc = choose_encoding(values) if enc is None else enc
    if enc.kind == "plain":
        return PackedColumn(enc, values)
    return PackedColumn(enc, pack_words(values, enc.width, enc.ref))


def slice_rows(table, lo: int, hi: int):
    """Row-range copy ``[lo, hi)`` of a table.  Packed columns keep the
    parent encoding (kind, width, ref), so predicate rewrites and stream
    widths computed against the parent stay valid.  A cut whose ``lo``
    lands on a word boundary is a word-window view (its last word may
    carry lanes of the parent's next rows, which every reader masks);
    any other cut decodes the range and packs it again."""
    if isinstance(table, PackedTable):
        cols = {}
        for name, col in table.columns.items():
            enc = replace(col.encoding, n_rows=hi - lo)
            if enc.kind == "plain":
                cols[name] = PackedColumn(enc, col.words[lo:hi])
                continue
            c = enc.values_per_word
            if lo % c == 0:
                cols[name] = PackedColumn(
                    enc, col.words[lo // c:(hi + c - 1) // c])
            else:
                cols[name] = pack_column(col.decode_range(lo, hi), enc)
        return PackedTable(table.name, cols)
    return ssb.Table(table.name, {c: v[lo:hi]
                                  for c, v in table.columns.items()})


def pin_slice(part, table, lo: int, hi: int, device) -> None:
    """Make ``part``, the ``slice_rows(table, lo, hi)`` of a table pinned
    on ``device``, pinned there too without a second copy of the table: a
    plain column, and a packed one cut on a word boundary, is a view of
    the parent's device tensor (the rows, or the words, that
    ``slice_rows`` kept); a packed column cut off a word boundary was
    packed again on the host and is uploaded, once."""
    dev = str(resolve(device))
    if isinstance(table, PackedTable):
        for name, col in part.columns.items():
            enc = col.encoding
            c = enc.values_per_word
            if enc.kind == "plain":
                col._resident[dev] = table.on_device(name, dev)[lo:hi]
            elif lo % c == 0:
                col._resident[dev] = table.on_device(name, dev)[
                    lo // c:(hi + c - 1) // c]
            else:
                col.on_device(dev)
    else:
        for name in part.columns:
            part._resident[name, dev] = table.on_device(name, dev)[lo:hi]
    part._pinned.add(dev)


# columns packed at once by ``pack_table``: numpy's array passes release
# the GIL; each column in flight holds about 24 bytes a row of temporaries
PACK_THREADS = 4


def pack_table(table: ssb.Table) -> PackedTable:
    """Encode every column of a table, ``PACK_THREADS`` columns at once."""
    names = list(table.columns)
    with ThreadPoolExecutor(max(1, min(PACK_THREADS, len(names)))) as pool:
        cols = pool.map(lambda c: pack_column(table.columns[c]), names)
        return PackedTable(table.name, dict(zip(names, cols)))


def pack_database(db: ssb.Database) -> ssb.Database:
    """Encode every table of a Database.  The result serves every entry
    point; ``db_fingerprint`` of a packed database equals its plain
    original's, so a warmed ``HashTableCache`` carries over."""
    return ssb.Database(
        lineorder=pack_table(db.lineorder), date=pack_table(db.date),
        supplier=pack_table(db.supplier), customer=pack_table(db.customer),
        part=pack_table(db.part), sf=db.sf)


# ---------------------------------------------------------------------------
# lowering helpers (what the compiler asks)
# ---------------------------------------------------------------------------


def encoding_of(table, col: str) -> Optional[ColumnEncoding]:
    """The column's encoding, or None for a plain ``ssb.Table``."""
    if isinstance(table, PackedTable):
        return table.encoding(col)
    if isinstance(table, ssb.Table):
        return None
    raise TypeError(f"{type(table).__name__} is neither an ssb.Table nor "
                    "a PackedTable")


def column_stream(table, col: str, device
                  ) -> Tuple[torch.Tensor, int, int]:
    """``(tensor, phys, ref)`` as the kernels load it: the packed word
    stream of a packed column, the plain int32 column (phys 32, ref 0)
    otherwise, resident on ``device`` (uploaded once per column and
    device)."""
    enc = encoding_of(table, col)
    t = table.on_device(col, device)
    if enc is None or enc.kind == "plain":
        return t, 32, 0
    return t, enc.phys, enc.ref


def take(table, col: str, rowids: torch.Tensor, device) -> torch.Tensor:
    """Positional column access for the operator-at-a-time chain: a plain
    gather on a plain column, a word gather plus a register decode on a
    packed one — only the touched positions move (plain torch, as the
    reference's ``take`` is plain jnp outside any kernel)."""
    arr, phys, ref = column_stream(table, col, device)
    if phys == 32:
        return arr[rowids]
    return gather_decode(arr, rowids, phys, ref)


def encoded_bounds(enc: Optional[ColumnEncoding], lo: int,
                   hi: int) -> Tuple[int, int]:
    """A closed range predicate in the column's encoded domain: packed
    lanes are compared raw, so the bounds absorb the reference.  Clamped
    to int32 — encoded values are non-negative, so a clamped lower bound
    stays all-pass-correct."""
    if enc is None or enc.kind == "plain":
        return lo, hi
    lo2 = max(_I32_MIN, min(_I32_MAX, int(lo) - enc.ref))
    hi2 = max(_I32_MIN, min(_I32_MAX, int(hi) - enc.ref))
    return lo2, hi2


def scan_bytes_per_row(table, col: str) -> float:
    """Bytes one streamed pass moves per row of this column: the encoded
    width for packed columns, 4 otherwise."""
    enc = encoding_of(table, col)
    return 4.0 if enc is None else enc.bytes_per_row


def sample_column(table, col: str, stride: int) -> np.ndarray:
    """Every ``stride``-th value of a column without a full decode: a
    strided word gather and lane shift on a packed column, a strided
    view otherwise."""
    stride = max(1, int(stride))
    if isinstance(table, PackedTable):
        pc = table.columns[col]
        e = pc.encoding
        if e.kind != "plain" and pc._decoded is None:
            idx = np.arange(0, e.n_rows, stride, dtype=np.int64)
            w = pc.words.view(np.uint32)[idx // e.values_per_word]
            sh = ((idx % e.values_per_word) * e.phys).astype(np.uint32)
            vals = ((w >> sh)
                    & np.uint32((1 << e.phys) - 1)).astype(np.int64)
            return (vals + e.ref).astype(np.int32)
    return np.asarray(table[col])[::stride]


# ---------------------------------------------------------------------------
# append-only delta batches (ingest under load)
# ---------------------------------------------------------------------------
#
# A table takes appended row batches without a repack of its base columns:
# each batch is packed at once (under the parent encoding when its values
# fit the parent's domain, so predicate rewrites stay valid, else from its
# own statistics) and kept on the table.  The morsel stream appends the
# batches after the base rows at scan time; ``flush_deltas`` is the
# explicit compaction into one freshly encoded table.


def append_rows(table, rows: Dict[str, np.ndarray]):
    """Append one delta batch (every column, as a dict of arrays) to a
    table; returns the batch table."""
    if set(rows) != set(table.columns):
        raise ValueError(
            f"delta batch columns {sorted(rows)} != table columns "
            f"{sorted(table.columns)}")
    lens = {len(np.asarray(v)) for v in rows.values()}
    if len(lens) != 1:
        raise ValueError(f"ragged delta batch: column lengths {lens}")
    n_new = lens.pop()
    # stage, then publish: every column goes into ``batch`` before the one
    # append below, so a failure in the loop (an injected ingest fault
    # too) leaves the pending batches as they were
    from repro_torch.sql import faults
    if isinstance(table, PackedTable):
        cols = {}
        for name, col in table.columns.items():
            faults.maybe_fault("ingest")
            vals = np.asarray(rows[name], np.int32)
            enc = replace(col.encoding, n_rows=n_new)
            try:
                cols[name] = pack_column(vals, enc)
            except ValueError:
                # outside the parent's domain: the batch's own encoding
                cols[name] = pack_column(vals)
        batch = PackedTable(table.name, cols)
    else:
        cols = {}
        for name in table.columns:
            faults.maybe_fault("ingest")
            cols[name] = np.asarray(rows[name], np.int32)
        batch = ssb.Table(table.name, cols)
    pending = getattr(table, "_deltas", None)
    if pending is None:
        pending = []
        table._deltas = pending
    pending.append(batch)
    return batch


def delta_batches(table) -> list:
    """The pending delta batches of a table (empty if none)."""
    return list(getattr(table, "_deltas", ()))


def delta_rows(table) -> int:
    """Appended rows not yet flushed."""
    return sum(b.n_rows for b in delta_batches(table))


def flush_deltas(table):
    """Base rows and delta batches compacted into one fresh table,
    encoded from the merged statistics; ``table`` itself when nothing is
    pending.  The source is never mutated, so a failed flush (an injected
    ingest fault too) can simply be retried."""
    pending = delta_batches(table)
    if not pending:
        return table
    from repro_torch.sql import faults
    merged = {}
    for c in table.columns:
        faults.maybe_fault("ingest")
        merged[c] = np.concatenate(
            [np.asarray(table[c])] + [np.asarray(b[c]) for b in pending])
    if isinstance(table, PackedTable):
        return PackedTable(table.name,
                           {c: pack_column(v) for c, v in merged.items()})
    return ssb.Table(table.name, merged)
