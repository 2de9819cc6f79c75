"""The packed-word layout's decode rule, as plain torch.

The port of ``repro.kernels.common``'s tile helpers and decode rule.
``repro_torch.sql.storage`` owns the layout: value k of a word lives at
bit ``k * phys``, ``phys`` one of 1, 2, 4, 8, 16, 32.  The CUDA kernels
(``csrc/ssb_fused.cu``, ``csrc/select_scan.cu``, ``csrc/unpack.cu``)
decode the same rule in registers; these functions are its plain form,
used by the plain versions, by ``storage.take`` and by the tests.

The reference shifts logically.  torch's ``>>`` on int32 is arithmetic,
but for ``phys < 32`` a shift of at most ``32 - phys`` followed by the
``(1 << phys) - 1`` mask keeps only bits the word itself supplied, so the
result is the same.
"""
from __future__ import annotations

import torch

DEFAULT_TILE = 2048
PHYS_WIDTHS = (1, 2, 4, 8, 16, 32)      # divisors of 32: lane-aligned decode


def pad_to_tile(x: torch.Tensor, tile: int, fill) -> torch.Tensor:
    """``x`` padded with ``fill`` to a multiple of ``tile`` entries."""
    pad = (-x.shape[0]) % tile
    if not pad:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])


def words_per_block(tile: int, phys: int) -> int:
    """Packed int32 words per ``tile`` decoded values at ``phys`` bits
    per value (phys == 32: the block IS the tile)."""
    if 32 % phys or tile % (32 // phys):
        raise ValueError(f"tile={tile} not divisible by lanes of "
                         f"phys={phys}")
    return tile * phys // 32


def _mask(phys: int) -> int:
    return (1 << phys) - 1


def decode_words(words: torch.Tensor, phys: int, ref=0) -> torch.Tensor:
    """``(n_words,)`` int32 words -> ``(n_words * 32 // phys,)`` int32
    values (+ ref).  ``phys == 32`` is the identity (no ref), as in the
    reference."""
    if phys == 32:
        return words
    c = 32 // phys
    shifts = torch.arange(c, dtype=torch.int32, device=words.device) * phys
    vals = ((words[:, None] >> shifts[None, :]) & _mask(phys)).reshape(-1)
    if isinstance(ref, int) and ref == 0:
        return vals
    return vals + ref


def gather_decode(words: torch.Tensor, idx: torch.Tensor, phys: int,
                  ref) -> torch.Tensor:
    """Value ``i`` of a packed column for each ``i`` in ``idx``: a gather
    over the word stream, then a shift and a mask, so only the encoded
    words the row ids touch move."""
    if phys == 32:
        return words[idx] + ref
    c = 32 // phys
    idx = idx.to(torch.int64)
    w = words[idx // c]
    sh = ((idx % c) * phys).to(torch.int32)
    return ((w >> sh) & _mask(phys)) + ref
