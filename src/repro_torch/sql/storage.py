"""Column access as the kernels load it — the plain-table subset of
``repro.sql.storage``.

Only plain (un-packed) tables exist in this package so far.  Bit-packed
columns arrive with the compressed-storage slice (ROADMAP queue 1,
item 4); until then every question about a packed column raises
``NotImplementedError`` rather than guessing at a layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sql import ssb

_PACKED = ("bit-packed columns arrive with the compressed-storage slice "
           "(ROADMAP queue 1, item 4: compressed storage)")


def encoding_of(table, col: str) -> Optional[object]:
    """The column's encoding: None for a plain ``ssb.Table`` (the only
    kind this package stores yet)."""
    if isinstance(table, ssb.Table):
        return None
    raise NotImplementedError(f"{type(table).__name__}.{col}: {_PACKED}")


def column_stream(table, col: str, device: torch.device
                  ) -> Tuple[torch.Tensor, int, int]:
    """``(tensor, phys, ref)`` as the kernels load it: the plain int32
    column resident on ``device`` (phys=32, ref=0).  The upload happens
    once per (column, device) and is held by the table."""
    encoding_of(table, col)
    return table.on_device(col, device), 32, 0


def take(table, col: str, rowids: torch.Tensor,
         device: torch.device) -> torch.Tensor:
    """Positional column access for the materializing (opat) path: the
    resident column gathered at ``rowids`` (plain torch, as the
    reference's ``take`` is plain jnp outside any kernel)."""
    return column_stream(table, col, device)[0][rowids]


def encoded_bounds(enc, lo: int, hi: int) -> Tuple[int, int]:
    """A closed range predicate in the column's encoded domain: the
    identity for a plain column."""
    if enc is None:
        return lo, hi
    raise NotImplementedError(f"encoded bounds: {_PACKED}")
