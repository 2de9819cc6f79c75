"""Fused SPJA full-query kernel on the card — the paper's headline result
(§5.3): one pass over the fact table runs a whole SSB query.

Wrapper of the hand-written CUDA kernel ``csrc/ssb_fused.cu``, the port of
the Pallas TPU kernel ``repro/kernels/ssb_fused.py::spja`` for plain int32
streams.  The kernel sums exactly in int64 (see the source's note), so it
takes the int32 measure columns themselves, not f32 copies, and its result
is bit-identical to ``ref.spja`` and to the numpy oracle.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.spja``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0

MAX_PREDS = 8                   # kMaxPreds in the CUDA source
MAX_JOINS = 8                   # kMaxJoins
_OP_CODE = {"first": 0, "mul": 1, "sub": 2}
_I32 = (-(1 << 31), (1 << 31) - 1)


_SIGNATURES = {"spja_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p])}


def library() -> ctypes.CDLL:
    return build.load("ssb_fused", _SIGNATURES)


def _check_i32(vals, what: str) -> None:
    for v in vals:
        if not _I32[0] <= v <= _I32[1]:
            raise ValueError(f"{what} value {v} is outside int32")


def spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
         join_keys: Sequence[torch.Tensor],
         join_tables: Sequence[torch.Tensor], group_mults,
         m1: torch.Tensor, m2=None, measure_op: str = "first",
         n_groups: int = 1) -> torch.Tensor:
    """Run one SPJA query in one kernel launch -> (n_groups,) f32.

    ``pred_cols``/``join_keys``/``m1``/``m2``: (n,) int32 fact columns on
    one device; ``join_tables``: (htk0, htv0, htk1, htv1, ...) int32
    open-addressing tables with a power-of-two slot count;
    ``pred_bounds`` (P, 2) and ``group_mults`` (J,): host integers, taken
    by value."""
    global LAUNCHES
    if m1.device.type != "cuda":
        raise ValueError(f"spja: no kernel for device {m1.device}")
    device = m1.device
    n = m1.shape[0]
    n_preds, n_joins = len(pred_cols), len(join_keys)
    if measure_op not in _OP_CODE:
        raise ValueError(f"measure_op {measure_op!r} not in {tuple(_OP_CODE)}")
    if n_preds > MAX_PREDS or n_joins > MAX_JOINS:
        raise ValueError(f"spja kernel takes at most {MAX_PREDS} predicates "
                         f"and {MAX_JOINS} joins, got {n_preds}, {n_joins}")
    if len(join_tables) != 2 * n_joins:
        raise ValueError(f"{len(join_tables)} join tables for {n_joins} joins")
    if n_groups < 1 or n_groups * 8 > build.SMEM_LIMIT:
        raise ValueError(f"n_groups={n_groups}: the per-block int64 grid "
                         f"must fit {build.SMEM_LIMIT} bytes of shared memory")
    two = measure_op != "first"
    if two and m2 is None:
        raise ValueError(f"measure_op {measure_op!r} needs m2")
    bounds = ref.bounds_list(pred_bounds, n_preds)
    mults = ref.mults_list(group_mults, n_joins)
    _check_i32([v for b in bounds for v in b], "pred_bounds")
    _check_i32(mults, "group_mults")
    for i, c in enumerate(pred_cols):
        build.check_stream(c, f"pred_cols[{i}]", n, device)
    for j, k in enumerate(join_keys):
        build.check_stream(k, f"join_keys[{j}]", n, device)
    build.check_stream(m1, "m1", n, device)
    if two:
        build.check_stream(m2, "m2", n, device)
    masks = []
    for j in range(n_joins):
        htk, htv = join_tables[2 * j], join_tables[2 * j + 1]
        s = htk.shape[0]
        build.check_stream(htk, f"join_tables[{2 * j}]", s, device)
        build.check_stream(htv, f"join_tables[{2 * j + 1}]", s, device)
        if s < 1 or s & (s - 1) or s > 1 << 32:
            raise ValueError(f"join {j}: slot count {s} is not a power of 2 "
                             "up to 2^32")
        masks.append(s - 1)

    out = torch.zeros((n_groups,), dtype=torch.int64, device=device)
    if n == 0:
        return out.to(torch.float32)

    def pad(xs, k):
        return list(xs) + [0] * (k - len(xs))

    ptrs = (ctypes.c_void_p * (MAX_PREDS + 3 * MAX_JOINS + 2))(
        *pad([c.data_ptr() for c in pred_cols], MAX_PREDS),
        *pad([k.data_ptr() for k in join_keys], MAX_JOINS),
        *pad([join_tables[2 * j].data_ptr() for j in range(n_joins)],
             MAX_JOINS),
        *pad([join_tables[2 * j + 1].data_ptr() for j in range(n_joins)],
             MAX_JOINS),
        m1.data_ptr(), m2.data_ptr() if two else 0)
    ints = (ctypes.c_int * (4 + 2 * MAX_PREDS + 2 * MAX_JOINS))(
        n_preds, n_joins, _OP_CODE[measure_op], n_groups,
        *pad([lo for lo, _ in bounds], MAX_PREDS),
        *pad([hi for _, hi in bounds], MAX_PREDS),
        *pad(masks, MAX_JOINS), *pad(mults, MAX_JOINS))
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.spja_launch(ctypes.addressof(ptrs), ctypes.addressof(ints),
                             n, out.data_ptr(), stream)
    build.check(lib, rc, "spja")
    LAUNCHES += 1
    return out.to(torch.float32)
