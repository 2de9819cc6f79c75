"""Fused SPJA full-query kernel on the card — the paper's headline result
(§5.3): one pass over the fact table runs a whole SSB query.

Wrapper of the hand-written CUDA kernel ``csrc/ssb_fused.cu``, the port of
the Pallas TPU kernel ``repro/kernels/ssb_fused.py::spja`` for plain int32
streams and bit-packed ones (``repro_torch.sql.storage``'s word layout,
decoded in registers).  The kernel sums exactly in int64 (see the source's
note), so it takes the int32 measure columns themselves, not f32 copies,
and its result is bit-identical to ``ref.spja`` and to the numpy oracle.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.spja``'s alone.
``LAUNCHES`` counts the kernel launches of this process.

Any group count runs: a grid past the shared memory a block has sums its
later groups in device memory (see the source's note).  ``acc=`` hands
the kernel an int64 grid to add into, the running sums of a morsel fold,
which is rounded to f32 once at its end.

The launch asks the runtime nothing.  A block is ``THREADS`` threads
sharing one group grid, so a large grid no longer halves the occupancy;
``launch_shape`` asks once per device, plan shape and grid size how many
blocks fit (``build.resident``).  The streams are checked by one cheap
test each
(``build.streams_ok``; ``check_stream`` names what is wrong when it
fails), the arguments cross to C by one pointer, and the launch goes
through ``build.launch``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0

MAX_PREDS = 8                   # kMaxPreds in the CUDA source
MAX_JOINS = 8                   # kMaxJoins
_OP_CODE = {"first": 0, "mul": 1, "sub": 2}
_I32 = (-(1 << 31), (1 << 31) - 1)


THREADS = 1024                  # kBlock

_N_PTRS = MAX_PREDS + 3 * MAX_JOINS + 2
_N_INTS = 8 + 3 * MAX_PREDS + 4 * MAX_JOINS


class _Args(ctypes.Structure):
    """``spja_launch``'s arguments (``csrc/ssb_fused.cu``'s ``SpjaArgs``),
    passed by one pointer."""
    _fields_ = [("ptrs", ctypes.c_void_p * _N_PTRS),
                ("ints", ctypes.c_int * _N_INTS),
                ("n", ctypes.c_longlong), ("out", ctypes.c_void_p),
                ("blocks", ctypes.c_longlong), ("shape", ctypes.c_int)]


_SIGNATURES = {
    "spja_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "spja_grid": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]),
    "spja_shape": (ctypes.c_int, [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]),
}


def library() -> ctypes.CDLL:
    return build.load("ssb_fused", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def launch_shape(lib: ctypes.CDLL, device: int, n_preds: int, n_joins: int,
                 n_groups: int) -> Tuple[int, int]:
    """(shape code, resident blocks) of a launch on card ``device``: the
    instance the plan needs (8 + 8 slots past 4 + 4, the spilling grid
    past a block's shared memory, the no-join instance) and the blocks
    that fit at its grid's shared memory, asked once."""
    smem = ctypes.c_int(0)
    shape = lib.spja_grid(n_preds, n_joins, n_groups, ctypes.byref(smem))
    blocks = build.resident(lib, "spja_shape", device,
                            (shape << 20) | smem.value)
    if blocks < 1:
        raise RuntimeError(f"spja: a grid of {n_groups} groups does not fit "
                           "an SM")
    return shape, blocks


def _check_i32(vals, what: str) -> None:
    for v in vals:
        if not _I32[0] <= v <= _I32[1]:
            raise ValueError(f"{what} value {v} is outside int32")


def _check_width(t: torch.Tensor, what: str, width: int, n: int,
                 device: torch.device) -> None:
    """A plain stream holds n int32 values, a packed one the
    ceil(n / (32 / width)) words that hold n values."""
    c = 32 // width
    build.check_stream(t, what, -(-n // c), device)


def spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
         join_keys: Sequence[torch.Tensor],
         join_tables: Sequence[torch.Tensor], group_mults,
         m1: torch.Tensor, m2=None, measure_op: str = "first",
         n_groups: int = 1, pred_widths=None, key_widths=None,
         key_refs=None, m_widths=None, m_refs=None,
         n_rows=None, acc=None) -> torch.Tensor:
    """Run one SPJA query in one kernel launch -> (n_groups,) f32.

    ``pred_cols``/``join_keys``/``m1``/``m2``: int32 fact streams on one
    device, each a plain (n,) column or, where its width in
    ``pred_widths``/``key_widths``/``m_widths`` is below 32, the packed
    word stream of n values; ``join_tables``: (htk0, htv0, htk1, htv1,
    ...) int32 open-addressing tables with a power-of-two slot count;
    ``pred_bounds`` (P, 2, in each column's encoded domain),
    ``group_mults`` (J,), ``key_refs`` (J,) and ``m_refs``: host
    integers, taken by value.  ``n_rows`` is n (default: m1's length,
    which a packed m1 does not give).  ``acc``: an (n_groups,) int64
    tensor on the streams' device; the sums are added to it and it is
    returned, not rounded."""
    global LAUNCHES
    if not m1.is_cuda:
        raise ValueError(f"spja: no kernel for device {m1.device}")
    device, index = m1.device, m1.get_device()
    n_preds, n_joins = len(pred_cols), len(join_keys)
    if measure_op not in _OP_CODE:
        raise ValueError(f"measure_op {measure_op!r} not in {tuple(_OP_CODE)}")
    n_meas = 1 if measure_op == "first" else 2
    pred_widths = ref.stream_widths(pred_widths, n_preds)
    key_widths = ref.stream_widths(key_widths, n_joins)
    m_widths = ref.stream_widths(m_widths, n_meas)
    krefs = ref.refs_list(key_refs, n_joins)
    mrefs = ref.refs_list(m_refs, n_meas)
    if n_rows is None:
        if m_widths[0] != 32:
            raise ValueError("n_rows is required when the measure stream "
                             "is bit-packed")
        n_rows = m1.shape[0]
    n = int(n_rows)
    if n_preds > MAX_PREDS or n_joins > MAX_JOINS:
        raise ValueError(f"spja kernel takes at most {MAX_PREDS} predicates "
                         f"and {MAX_JOINS} joins, got {n_preds}, {n_joins}")
    if len(join_tables) != 2 * n_joins:
        raise ValueError(f"{len(join_tables)} join tables for {n_joins} joins")
    if n_groups < 1 or n_groups >= 1 << 31:
        raise ValueError(f"n_groups={n_groups}: at least one, under 2^31")
    two = measure_op != "first"
    if two and m2 is None:
        raise ValueError(f"measure_op {measure_op!r} needs m2")
    bounds = ref.bounds_list(pred_bounds, n_preds)
    mults = ref.mults_list(group_mults, n_joins)
    _check_i32([v for b in bounds for v in b], "pred_bounds")
    _check_i32(mults, "group_mults")
    _check_i32(krefs + mrefs, "key_refs/m_refs")
    streams = [(c, f"pred_cols[{i}]", w)
               for i, (c, w) in enumerate(zip(pred_cols, pred_widths))] + \
        [(k, f"join_keys[{j}]", w)
         for j, (k, w) in enumerate(zip(join_keys, key_widths))] + \
        [(m1, "m1", m_widths[0])] + ([(m2, "m2", m_widths[1])] if two else [])
    for t, what, w in streams:
        if not build.streams_ok(-(-n // (32 // w)), index, torch.int32, t):
            _check_width(t, what, w, n, device)
    masks = []
    for j in range(n_joins):
        htk, htv = join_tables[2 * j], join_tables[2 * j + 1]
        s = htk.shape[0]
        if not build.streams_ok(s, index, torch.int32, htk, htv):
            build.check_stream(htk, f"join_tables[{2 * j}]", s, device)
            build.check_stream(htv, f"join_tables[{2 * j + 1}]", s, device)
        if s < 1 or s & (s - 1) or s > 1 << 32:
            raise ValueError(f"join {j}: slot count {s} is not a power of 2 "
                             "up to 2^32")
        masks.append(s - 1)

    if acc is None:
        out = torch.zeros((n_groups,), dtype=torch.int64, device=device)
    else:
        ref.check_acc(acc, (n_groups,), device)
        out = acc
    if n == 0:
        return out if acc is not None else out.to(torch.float32)

    def pad(xs, k, fill=0):
        return list(xs) + [fill] * (k - len(xs))

    lib = library()
    shape, blocks = launch_shape(lib, index, n_preds, n_joins, n_groups)
    args = _Args(
        (ctypes.c_void_p * _N_PTRS)(
            *pad([c.data_ptr() for c in pred_cols], MAX_PREDS),
            *pad([k.data_ptr() for k in join_keys], MAX_JOINS),
            *pad([join_tables[2 * j].data_ptr() for j in range(n_joins)],
                 MAX_JOINS),
            *pad([join_tables[2 * j + 1].data_ptr() for j in range(n_joins)],
                 MAX_JOINS),
            m1.data_ptr(), m2.data_ptr() if two else 0),
        (ctypes.c_int * _N_INTS)(
            n_preds, n_joins, _OP_CODE[measure_op], n_groups,
            *pad([lo for lo, _ in bounds], MAX_PREDS),
            *pad([hi for _, hi in bounds], MAX_PREDS),
            *pad(masks, MAX_JOINS), *pad(mults, MAX_JOINS),
            *pad(list(pred_widths), MAX_PREDS, 32),
            *pad(list(key_widths), MAX_JOINS, 32),
            *pad(list(m_widths), 2, 32),
            *pad(krefs, MAX_JOINS), *pad(mrefs, 2)),
        n, out.data_ptr(), blocks, shape)
    build.launch(lib, lib.spja_launch, device, "spja",
                 ctypes.addressof(args))
    LAUNCHES += 1
    return out if acc is not None else out.to(torch.float32)
