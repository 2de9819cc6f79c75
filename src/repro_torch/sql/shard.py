"""Sharded fact-table execution: S row partitions of the fact table.

The port of ``repro.sql.shard``.  The paper's bandwidth argument extends
to many devices: N devices scanning disjoint fact shards deliver N times
the scan rate, provided each shard runs the same one-pass kernel and the
only traffic between them is the final ``(n_groups,)`` grid.  This
module owns that decomposition:

  shard     — ``shard_database(db, parts)`` cuts the fact table into
              contiguous row ranges (``storage.slice_rows``: plain
              columns slice as views, packed columns cut off a word
              boundary are packed again under the parent encoding).
              The dimension tables are the base database's own objects,
              so one hash-table build serves every shard.
  replicate — :func:`replicate` places small shared state (dimension
              hash tables) on every device once.
  reduce    — per-shard partial grids merge pairwise (:func:`tree_merge`,
              :func:`merge_partials`), or in one ``all_reduce`` across
              ranks.  The port's partials are exact: int64 sums (the
              fused and wave kernels sum the int32 measures in int64) or
              f64 sums (:class:`GroupPartial` of f32 values), rounded to
              f32 once after the merge, so any association order gives
              the same bits.  (The reference's partials are f32, exact
              only below 2^24; at SF 20 q1.1's sum is 2,246,830,080.)

``parts`` takes two forms, and the compiler's ``sharded`` strategy
(``repro_torch.sql.compile``) runs each:

  an int    — S logical shards in one process: a host loop runs one fused
              fold a shard on one device, in turns.  A shard of a fact
              table resident on the card is resident too, as views of the
              base's device tensors (``storage.pin_slice``).
  a mesh    — a 1-D ``DeviceMesh`` over a process group of S ranks
              (``distributed.mesh.default_mesh``), the counterpart of the
              reference's ``shard_map`` path: each rank holds only its own
              shard (``shards == [own]``, rows ``bounds[rank]`` to
              ``bounds[rank + 1]``; ``to`` makes it alone resident on the
              rank's device), folds it, and the ranks' int64 grids meet in
              one all-reduce.  The reference stacks every shard into one
              ``(S, pad_rows)`` batch with a validity stream, because
              ``shard_map`` needs one shape on every device; a rank folds
              its own contiguous shard, of whatever length, so neither has
              a counterpart here: a ragged or an empty shard is a shorter
              (or no) morsel stream, and its rank still joins the
              all-reduce.  ``hw`` is rank 0's ``Hardware``, broadcast when
              the sharded database is made, so ``auto`` chooses alike on
              every rank.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve
from repro_torch.distributed import mesh as MESH
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
    ``sharded`` paths look inside.  With a ``mesh``, ``shards`` holds
    this rank's shard alone (see the module's docstring)."""
    base: ssb.Database
    shards: List[ssb.Database]
    bounds: np.ndarray                  # (S+1,) fact-row offsets
    fact: str
    mesh: Optional[DeviceMesh] = None
    hw: object = None                   # rank 0's Hardware on a mesh
    # on a mesh, the S shards as logical ones, cut on first need (logical)
    _logical: Optional["ShardedDatabase"] = field(default=None, repr=False,
                                                  compare=False)

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def group(self):
        """The mesh's ``data`` process group (None without a mesh)."""
        return (None if self.mesh is None
                else self.mesh.get_group(MESH.SHARD_AXIS))

    def to(self, device) -> "ShardedDatabase":
        """Make the base's fact table resident on ``device`` and every
        shard with it, as views of its tensors (``storage.pin_slice``);
        on a mesh, this rank's shard alone (the base stays on the host).
        Returns ``self``."""
        if self.mesh is not None:
            getattr(self.shards[0], self.fact).pin(device)
            return self
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


def shard_database(db, parts=None, fact: str = "lineorder",
                   hw=None) -> ShardedDatabase:
    """Partition ``db``'s fact table row-wise into contiguous shards.
    ``parts`` is a shard count (None: one per visible card, one on a host
    without a card) or a 1-D ``DeviceMesh`` of S ranks (every rank of
    which calls this with the same database).

    Shard ``i`` holds rows ``[i*n//S, (i+1)*n//S)``: sizes differ by at
    most one row, and S may exceed the row count (the tail shards are
    then empty; execution and the merge take zero-row shards).  A shard
    count is a logical choice, decoupled from the devices, so the results
    are the same at any S; where the fact table is resident on a device,
    every shard is resident there too (:meth:`ShardedDatabase.to`).  On a
    mesh each rank cuts its own shard alone and keeps the base's
    dimension tables; ``hw`` (this rank's ``Hardware``, else
    ``model.default_hardware`` of its device) is replaced by rank 0's."""
    db = base_of(db)
    mesh = parts if isinstance(parts, DeviceMesh) else None
    if mesh is not None:
        if mesh.ndim != 1:
            raise ValueError(f"a sharded database needs a 1-D mesh, got "
                             f"{mesh.mesh_dim_names}")
        s = mesh.size()
    else:
        s = max(1, torch.cuda.device_count()) if parts is None \
            else int(parts)
    if s < 1:
        raise ValueError(f"shard count must be >= 1, got {s}")
    table = getattr(db, fact)
    n = table.n_rows
    bounds = np.array([(i * n) // s for i in range(s + 1)], np.int64)
    own = range(s) if mesh is None else [mesh.get_local_rank(MESH.SHARD_AXIS)]
    shards = [dataclasses.replace(
        db, **{fact: ST.slice_rows(table, int(bounds[i]),
                                   int(bounds[i + 1]))})
        for i in own]
    if mesh is not None:
        return ShardedDatabase(db, shards, bounds, fact, mesh,
                               _rank0_hardware(mesh, hw))
    sdb = ShardedDatabase(db, shards, bounds, fact)
    for dev in sorted(table._pinned):
        sdb.to(dev)
    return sdb


def _rank0_hardware(mesh: DeviceMesh, hw):
    """Rank 0's ``Hardware`` on every rank of ``mesh`` (one broadcast)."""
    if hw is None:
        from repro_torch.sql.model import default_hardware
        hw = default_hardware(MESH.mesh_device(mesh))
    box = [hw]
    group = mesh.get_group(MESH.SHARD_AXIS)
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def logical(sdb: ShardedDatabase) -> ShardedDatabase:
    """The S shards of ``sdb`` as logical shards in this process (the host
    loop's form): ``sdb`` itself without a mesh; on a mesh, cut once and
    kept on ``sdb``."""
    if sdb.mesh is None:
        return sdb
    if sdb._logical is None:
        sdb._logical = shard_database(sdb.base, sdb.n_shards, sdb.fact)
    return sdb._logical


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
