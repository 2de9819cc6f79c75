"""Sharded fact-table execution: S row partitions of the fact table.

The port of ``repro.sql.shard``, the host-loop half.  The paper's
bandwidth argument extends to many devices: N devices scanning disjoint
fact shards deliver N times the scan rate, provided each shard runs the
same one-pass kernel and the only traffic between them is the final
``(n_groups,)`` grid.  This module owns that decomposition:

  shard     — ``shard_database(db, n)`` cuts the fact table into
              contiguous row ranges (``storage.slice_rows``: plain
              columns slice as views, packed columns cut off a word
              boundary are packed again under the parent encoding).
              The dimension tables are the base database's own objects,
              so one hash-table build serves every shard.  A shard of a
              fact table resident on the card is resident too, as views
              of the base's device tensors (``storage.pin_slice``): no
              second copy of the table.
  replicate — :func:`replicate` places small shared state (dimension
              hash tables) on every device once; on one device it is the
              identity.
  reduce    — per-shard partial grids merge pairwise (:func:`tree_merge`,
              :func:`merge_partials`).  The port's partials are exact:
              int64 sums (the fused and wave kernels sum the int32
              measures in int64) or f64 sums (:class:`GroupPartial` of f32
              values), rounded to f32 once after the merge, so any
              association order gives the same bits.  (The reference's
              partials are f32, exact only below 2^24; at SF 20 q1.1's
              sum is 2,246,830,080.)

The compiler's ``sharded`` strategy (``repro_torch.sql.compile``) runs
the shards from a host loop, one fused fold each, over S logical shards
on one card.  The reference's other path, a ``shard_map`` over a mesh of
devices with the merge as a ``psum`` (its ``default_mesh``,
``stacked_stream``/``stacked_window``/``validity_*`` and
``_execute_fused_map``), waits for a host with several GPUs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.sql import ssb
from repro_torch.sql import storage as ST


@dataclass
class ShardedDatabase:
    """A Database plus its row-partitioned fact shards.

    ``base`` is the unsharded original; ``shards[i]`` is a Database
    whose fact attribute is rows ``[bounds[i], bounds[i+1])`` and whose
    dimension tables are the base's own objects.  Attribute access
    delegates to ``base`` (``sdb.lineorder``, ``sdb.sf``, ...), so a
    ShardedDatabase answers like its Database for the oracle, the cost
    model, the hash-table cache and every other strategy; only the
    ``sharded`` paths look inside."""
    base: ssb.Database
    shards: List[ssb.Database]
    bounds: np.ndarray                  # (S+1,) fact-row offsets
    fact: str

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def to(self, device) -> "ShardedDatabase":
        """Make the base's fact table resident on ``device`` and every
        shard with it, as views of its tensors (``storage.pin_slice``).
        Returns ``self``."""
        table = getattr(self.base, self.fact)
        table.pin(device)
        for i, shard in enumerate(self.shards):
            ST.pin_slice(getattr(shard, self.fact), table,
                         int(self.bounds[i]), int(self.bounds[i + 1]),
                         device)
        return self

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.base, name)


def base_of(db) -> ssb.Database:
    """The unsharded Database behind ``db`` (identity for a plain one)."""
    return db.base if isinstance(db, ShardedDatabase) else db


def shard_count(db) -> int:
    return db.n_shards if isinstance(db, ShardedDatabase) else 1


def shard_database(db, parts: Optional[int] = None,
                   fact: str = "lineorder") -> ShardedDatabase:
    """Partition ``db``'s fact table row-wise into ``parts`` contiguous
    shards (None: one per visible card, one on a host without a card).

    Shard ``i`` holds rows ``[i*n//S, (i+1)*n//S)``: sizes differ by at
    most one row, and S may exceed the row count (the tail shards are
    then empty; execution and the merge take zero-row shards).  The
    shard count is a logical choice, decoupled from the devices, so the
    results are the same at any S.  Where the fact table is resident on a
    device, every shard is resident there too (:meth:`ShardedDatabase.to`)."""
    db = base_of(db)
    s = max(1, torch.cuda.device_count()) if parts is None else int(parts)
    if s < 1:
        raise ValueError(f"shard count must be >= 1, got {s}")
    table = getattr(db, fact)
    n = table.n_rows
    bounds = np.array([(i * n) // s for i in range(s + 1)], np.int64)
    shards = [dataclasses.replace(
        db, **{fact: ST.slice_rows(table, int(bounds[i]),
                                   int(bounds[i + 1]))})
        for i in range(s)]
    sdb = ShardedDatabase(db, shards, bounds, fact)
    for dev in sorted(table._pinned):
        sdb.to(dev)
    return sdb


# ---------------------------------------------------------------------------
# tree reduction of partial aggregates
# ---------------------------------------------------------------------------


def tree_merge(partials):
    """Pairwise (binary-tree) reduction of per-shard partial grids, numpy
    arrays or tensors.  On exact partials (int64 sums, f64 sums of
    integer values) every association order gives the same bits; the
    hypothesis property test pins this down."""
    parts = [p if torch.is_tensor(p) else np.asarray(p) for p in partials]
    if not parts:
        raise ValueError("tree_merge needs at least one partial")
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                 else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


@dataclass(frozen=True)
class GroupPartial:
    """Mergeable per-shard partial of a dense group-aggregate grid: exact
    sums (int64 for integer values, f64 for f32 values) and int64 counts
    per group.  ``merge`` is associative and commutative bit for bit
    while the sums are exact (any integer measure below 2^53 in f64);
    ``finalize`` rounds to f32 once, after the merge, and derives avg
    from the merged sum and count, as the unsharded computation does.
    Empty shards contribute all-zero partials."""
    sums: np.ndarray                    # (G,) int64 or f64
    counts: np.ndarray                  # (G,) int64

    @staticmethod
    def from_rows(group_ids, values, n_groups: int) -> "GroupPartial":
        g = np.asarray(group_ids, np.int64)
        v = np.asarray(values)
        if v.dtype.kind in "iub":
            v = v.astype(np.int64)
        else:
            v = v.astype(np.float32).astype(np.float64)
        sums = np.zeros(n_groups, v.dtype)
        np.add.at(sums, g, v)
        counts = np.bincount(g, minlength=n_groups).astype(np.int64)
        return GroupPartial(sums, counts)

    def merge(self, other: "GroupPartial") -> "GroupPartial":
        return GroupPartial(self.sums + other.sums,
                            self.counts + other.counts)

    def finalize(self, op: str = "sum") -> np.ndarray:
        if op == "sum":
            return self.sums.astype(np.float32)
        if op == "count":
            return self.counts.astype(np.float32)
        if op == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out = self.sums.astype(np.float64) / self.counts
            return np.where(self.counts > 0, out, 0.0).astype(np.float32)
        raise ValueError(f"unknown aggregate op {op!r}")


def merge_partials(parts) -> GroupPartial:
    """:func:`tree_merge` over :class:`GroupPartial` shards."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge_partials needs at least one partial")
    while len(parts) > 1:
        parts = [parts[i].merge(parts[i + 1]) if i + 1 < len(parts)
                 else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def replicate(devices: Sequence, tensors):
    """``tensors`` (a tensor or a tuple or list of them) placed on each
    of ``devices`` -> one entry a device.  A tensor already on a device
    is that device's entry itself, so on one device this is the
    identity."""
    def place(x, dev):
        if torch.is_tensor(x):
            return x.to(dev)
        return type(x)(place(t, dev) for t in x)
    return [place(tensors, resolve(d)) for d in devices]
