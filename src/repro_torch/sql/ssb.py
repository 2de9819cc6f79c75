"""Star Schema Benchmark: schema + scale-factor data generator (paper §5.1).

The PyTorch port's copy of ``repro.sql.ssb``: the same schema, the same
generator and the same rng draw order, so ``generate(sf, seed)`` gives
arrays identical to the reference's.  Host numpy stays the source of
truth (the oracle and the hash-table build read it); each ``Table``
memoizes the device copy of a column the first time a query asks for it
on that device, so a query never re-sends fact bytes over PCIe.

All string attributes are dictionary-encoded int32 (the paper does the same
rewrite, §5.2) with *structured* code spaces so selective predicates become
integer ranges:

  region  0..4                           (AFRICA, AMERICA, ASIA, EUROPE, MIDDLE EAST)
  nation  region*5 + k     (25 total)
  city    nation*10 + j    (250 total)
  mfgr    0..4                           (MFGR#1..5)
  category mfgr*5 + c      (25 total)    (MFGR#11..)
  brand1  category*40 + b  (1000 total)  (MFGR#1101..)
  datekey 0..2555 = (year-1992)*365 + dayofyear   (simplified 365-day calendar)

SF=1 -> 6M lineorder rows (SF 20 in the paper = 120M); dimension
cardinalities follow the SSB spec.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve

N_YEARS = 7
DAYS_PER_YEAR = 365
N_DATES = N_YEARS * DAYS_PER_YEAR
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
AMERICA, ASIA, EUROPE, UNITED_STATES = 1, 2, 3, 1 * 5 + 3  # encodings used
# nation "UNITED STATES" = region AMERICA(1)*5 + 3 = 8
NATION_US = 8
# cities "UNITED KI1" / "UNITED KI5": nation UNITED KINGDOM = EUROPE(3)*5+4=19
NATION_UK = 19
CITY_UKI1 = NATION_UK * 10 + 1
CITY_UKI5 = NATION_UK * 10 + 5


@dataclass
class Table:
    name: str
    columns: Dict[str, np.ndarray] = field(default_factory=dict)
    # (column, device) -> resident tensor; filled by ``on_device``
    _resident: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)
    # devices the whole table was made resident on (``Database.to``)
    _pinned: Set[str] = field(default_factory=set, repr=False,
                              compare=False)

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def on_device(self, col: str, device: torch.device) -> torch.Tensor:
        """The column as an int32 tensor on ``device``, uploaded on first
        use and held for every later query (the host array is the
        source; columns are never mutated in place)."""
        device = resolve(device)
        key = (col, str(device))
        t = self._resident.get(key)
        if t is None:
            t = torch.from_numpy(
                np.ascontiguousarray(self.columns[col], np.int32)).to(device)
            self._resident[key] = t
        return t

    def resident_bytes(self, device: torch.device) -> int:
        dev = str(resolve(device))
        return sum(t.numel() * t.element_size()
                   for (_, d), t in self._resident.items() if d == dev)

    def pin(self, device) -> None:
        """Upload every column to ``device`` and keep the table there: a
        query then reads it whole, never a morsel at a time."""
        for col in self.columns:
            self.on_device(col, device)
        self._pinned.add(str(resolve(device)))

    def is_pinned(self, device) -> bool:
        return str(resolve(device)) in self._pinned

    def release(self, device: bool = False) -> None:
        """With ``device=True``, drop the device copies (and the pins)."""
        if device:
            self._resident.clear()
            self._pinned.clear()


@dataclass
class Database:
    lineorder: Table
    date: Table
    supplier: Table
    customer: Table
    part: Table
    sf: float

    def to(self, device) -> "Database":
        """Make the fact table resident on ``device`` — a plain table's
        int32 columns, a ``storage.PackedTable``'s word streams (the dims
        stay on the host: they only feed the host hash build).  A
        resident fact table is read whole by every query, whatever the
        morsel budget.  Returns ``self``."""
        self.lineorder.pin(device)
        return self


TABLES = tuple(f.name for f in fields(Database) if f.name != "sf")


def from_numpy(tables: Dict[str, Dict[str, np.ndarray]],
               sf: float) -> Database:
    """A port ``Database`` over the given host arrays, keyed by table
    attribute (``lineorder``, ``date``, ...) then column name — how data
    generated by another implementation (the reference package, a
    loader) is carried across.  The arrays are shared, not copied."""
    missing = [t for t in TABLES if t not in tables]
    if missing:
        raise ValueError(f"from_numpy: missing tables {missing}")
    return Database(**{t: Table(t, {c: np.asarray(v)
                                     for c, v in tables[t].items()})
                       for t in TABLES}, sf=sf)


def datekey(year: int, day: int = 0) -> int:
    return (year - 1992) * DAYS_PER_YEAR + day


def _scale(sf: float) -> Tuple[int, int, int, int]:
    """Row counts (n_lo, n_supp, n_cust, n_part) at scale factor sf."""
    n_lo = max(1, int(6_000_000 * sf))
    n_supp = max(8, int(2_000 * sf))
    n_cust = max(8, int(30_000 * sf))
    n_part = int(200_000 * max(1.0, 1 + np.log2(max(sf, 1.0))))
    if sf < 1.0:
        n_part = max(64, int(200_000 * sf))
    return n_lo, n_supp, n_cust, n_part


def _lineorder_specs(n_part: int, n_supp: int,
                     n_cust: int) -> List[Tuple[str, int, int]]:
    """The fact columns as (name, lo, hi) uniform-draw specs, in draw
    order (the reference's order, so the rng streams agree)."""
    return [
        ("lo_orderdate", 0, N_DATES),
        ("lo_partkey", 0, n_part),
        ("lo_suppkey", 0, n_supp),
        ("lo_custkey", 0, n_cust),
        ("lo_quantity", 1, 51),
        ("lo_discount", 0, 11),
        ("lo_extendedprice", 1, 1_000),
        ("lo_revenue", 1, 1_000),
        ("lo_supplycost", 1, 500),
    ]


def _dimensions(rng: np.random.Generator, n_supp: int, n_cust: int,
                n_part: int) -> Tuple[Table, Table, Table, Table]:
    """Generate the four dimension tables, consuming the rng's dimension
    draws (s_city, c_city, p_brand1) in the fixed order the fact
    generator continues from."""
    i32 = np.int32
    dk = np.arange(N_DATES, dtype=i32)
    date = Table("date", {
        "d_datekey": dk,
        "d_year": (1992 + dk // DAYS_PER_YEAR).astype(i32),
        "d_yearmonthnum": (
            (1992 + dk // DAYS_PER_YEAR) * 100
            + ((dk % DAYS_PER_YEAR) // 31 + 1)).astype(i32),
        "d_weeknuminyear": ((dk % DAYS_PER_YEAR) // 7 + 1).astype(i32),
    })

    supplier = Table("supplier", {
        "s_suppkey": np.arange(n_supp, dtype=i32),
        "s_city": rng.integers(0, 250, n_supp, dtype=i32),
    })
    supplier.columns["s_nation"] = (supplier["s_city"] // 10).astype(i32)
    supplier.columns["s_region"] = (supplier["s_nation"] // 5).astype(i32)

    customer = Table("customer", {
        "c_custkey": np.arange(n_cust, dtype=i32),
        "c_city": rng.integers(0, 250, n_cust, dtype=i32),
    })
    customer.columns["c_nation"] = (customer["c_city"] // 10).astype(i32)
    customer.columns["c_region"] = (customer["c_nation"] // 5).astype(i32)

    part = Table("part", {
        "p_partkey": np.arange(n_part, dtype=i32),
        "p_brand1": rng.integers(0, 1000, n_part, dtype=i32),
    })
    part.columns["p_category"] = (part["p_brand1"] // 40).astype(i32)
    part.columns["p_mfgr"] = (part["p_category"] // 5).astype(i32)
    return date, supplier, customer, part


def generate(sf: float = 0.01, seed: int = 0) -> Database:
    rng = np.random.default_rng(seed)
    n_lo, n_supp, n_cust, n_part = _scale(sf)
    date, supplier, customer, part = _dimensions(rng, n_supp, n_cust,
                                                 n_part)
    lineorder = Table("lineorder", {
        name: rng.integers(lo, hi, n_lo, dtype=np.int32)
        for name, lo, hi in _lineorder_specs(n_part, n_supp, n_cust)})
    return Database(lineorder, date, supplier, customer, part, sf)


def generate_packed(sf: float = 0.01, seed: int = 0,
                    chunk_rows: int = 1 << 20) -> Database:
    """Generate straight into the packed representation, drawing the fact
    table ``chunk_rows`` at a time, so the plain lineorder is never held
    whole.

    Bit-identical to ``storage.pack_database(generate(sf, seed))``: the
    rng draw order is shared (``_dimensions`` + ``_lineorder_specs``),
    numpy's Generator draws a chunked stream as it draws a whole one, and
    each column takes two passes over a saved rng state — a stats pass
    for ``storage.encoding_from_stats``, then a pack pass writing
    word-aligned chunks (``chunk_rows`` is floored to a multiple of 32
    rows, a word boundary of every packed width)."""
    from repro_torch.sql import storage as ST  # storage imports ssb

    rng = np.random.default_rng(seed)
    n_lo, n_supp, n_cust, n_part = _scale(sf)
    date, supplier, customer, part = _dimensions(rng, n_supp, n_cust,
                                                 n_part)
    chunk = max(32, (int(chunk_rows) // 32) * 32)
    cols: Dict[str, ST.PackedColumn] = {}
    for name, lo, hi in _lineorder_specs(n_part, n_supp, n_cust):
        state = rng.bit_generator.state
        vmin = vmax = None
        for c0 in range(0, n_lo, chunk):
            vals = rng.integers(lo, hi, min(chunk, n_lo - c0),
                                dtype=np.int32)
            m0, m1 = int(vals.min()), int(vals.max())
            vmin = m0 if vmin is None else min(vmin, m0)
            vmax = m1 if vmax is None else max(vmax, m1)
        enc = ST.encoding_from_stats(vmin, vmax, n_lo)
        rng.bit_generator.state = state
        if enc.kind == "plain":
            words = np.empty(n_lo, np.int32)
            for c0 in range(0, n_lo, chunk):
                m = min(chunk, n_lo - c0)
                words[c0:c0 + m] = rng.integers(lo, hi, m, dtype=np.int32)
        else:
            c = enc.values_per_word
            words = np.empty((n_lo + c - 1) // c, np.int32)
            for c0 in range(0, n_lo, chunk):
                m = min(chunk, n_lo - c0)
                w = ST.pack_words(rng.integers(lo, hi, m, dtype=np.int32),
                                  enc.width, enc.ref)
                words[c0 // c:c0 // c + len(w)] = w
        cols[name] = ST.PackedColumn(enc, words)
    lineorder = ST.PackedTable("lineorder", cols)
    return Database(lineorder, ST.pack_table(date), ST.pack_table(supplier),
                    ST.pack_table(customer), ST.pack_table(part), sf)
