"""Crystal block-wide functions (Table 1 of the paper) as torch functions.

The port's counterparts of ``repro.core.blocks``, written over whole
tensors: they are the building blocks of the plain versions
(``repro_torch.kernels.ref``) that every hand-written kernel is held
against, on the CPU in the tests and on the card in ``chip_smoke.py``.
The CUDA kernel ``kernels/csrc/ssb_fused.cu`` inlines the same rules per
thread.
"""
from __future__ import annotations

from typing import Tuple

import torch

EMPTY = -2147483648          # open-addressing empty slot marker (INT32_MIN)
HASH_MUL = 2654435761        # Knuth's multiplicative constant
_LOW32 = 0xFFFFFFFF


def hash_fn(keys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Multiplicative hash into [0, n_slots); n_slots is a power of two.

    Equals ``(uint32(k) * 2654435761) & (n_slots - 1)`` bit for bit: the
    key is masked to its low 32 bits in int64, and only the low 32 bits
    of the product are kept — they survive int64 wraparound.  Returns
    int64 slot indices (torch's index type)."""
    h = (keys.to(torch.int64) & _LOW32) * HASH_MUL
    return h & (n_slots - 1)


def block_pred_range(tile: torch.Tensor, lo, hi) -> torch.Tensor:
    """lo <= tile <= hi as an int32 bitmap."""
    return ((tile >= lo) & (tile <= hi)).to(torch.int32)


def block_scan(bitmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlockScan: exclusive prefix sum of a 0/1 bitmap and its total, both
    int64 on the bitmap's device (the total a 0-d tensor: no host round
    trip)."""
    inc = torch.cumsum(bitmap, 0, dtype=torch.int64)
    total = inc[-1] if inc.numel() else inc.new_zeros(())
    return inc - bitmap, total


def block_shuffle(tile: torch.Tensor, bitmap: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """BlockShuffle: stable compaction of the entries whose bitmap is set
    to the front, by their ``block_scan`` offsets.  The entries past the
    total are zero (the reference leaves them arbitrary; callers read only
    the first ``total``)."""
    n = tile.shape[0]
    idx = torch.where(bitmap > 0, offsets, n)    # unmatched -> drop slot n
    out = torch.zeros((n + 1,), dtype=tile.dtype, device=tile.device)
    return out.scatter_(0, idx, tile)[:n]


def block_lookup(keys: torch.Tensor, ht_keys: torch.Tensor,
                 ht_vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlockLookup: each key's payload by linear probing.

    Returns (payload, found bitmap), both int32.  A lane stops at its key
    (hit) or at an EMPTY slot (miss), as in the reference's lock-step
    loop; here each round probes only the lanes still walking, so a round
    costs its live lanes, not the whole tile.  A walk is capped at one
    lap of the table (a full table without the key is a miss, never a
    hang).

    The tables are one ``(S,)`` table, or the partitioned join's packed
    ``(P, S)`` layout (``hashtable.PackedParts``): a key then probes row
    ``key & (P - 1)``, the partition its low bits name, and walks within
    that row."""
    if ht_keys.dim() == 2:
        n_parts, n_slots = ht_keys.shape
        base = (keys.to(torch.int64) & (n_parts - 1)) * n_slots
        ht_keys, ht_vals = ht_keys.reshape(-1), ht_vals.reshape(-1)
    else:
        n_slots, base = ht_keys.shape[0], None
    mask = n_slots - 1
    payload = torch.zeros(keys.shape, dtype=ht_vals.dtype,
                          device=keys.device)
    found = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    lanes = torch.arange(keys.shape[0], device=keys.device)
    want = keys
    slot = hash_fn(keys, n_slots)
    for _ in range(n_slots):
        if lanes.numel() == 0:
            break
        at = slot if base is None else base + slot
        k_at = ht_keys[at]
        hit = k_at == want
        hit_lanes = lanes[hit]
        payload[hit_lanes] = ht_vals[at[hit]]
        found[hit_lanes] = 1
        walking = ~(hit | (k_at == EMPTY))
        lanes, want = lanes[walking], want[walking]
        slot = (slot[walking] + 1) & mask
        if base is not None:
            base = base[walking]
    return payload, found


def block_group_aggregate(group_ids: torch.Tensor, vals: torch.Tensor,
                          bitmap: torch.Tensor, n_groups: int
                          ) -> torch.Tensor:
    """Group-by-sum: (n_groups,) sums of ``vals`` over the rows whose
    bitmap is set, in ``vals``' dtype.  A live row whose group id lies
    outside [0, n_groups) is dropped, as the reference's scatter drops
    an out-of-range update."""
    keep = (bitmap > 0) & (group_ids >= 0) & (group_ids < n_groups)
    out = torch.zeros((n_groups,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, group_ids[keep].to(torch.int64), vals[keep])
