"""Shared-scan SPJA on the card: one pass over the fact table runs a whole
wave of SSB queries (the serving-side generalisation of the paper's
one fused pass per query, §5.3).

Wrapper of the hand-written CUDA kernel ``csrc/multi_fused.cu``, the port
of the Pallas TPU kernel ``repro/kernels/multi_fused.py::multi_spja``.
Same contract as ``ref.multi_spja``: (Q, n_groups) f32, each member's
sums exact in int64 and rounded once, bit for bit.  The stacked member
parameters are lowered here to the kernel's int32 word array (member
masks per column, probe group, stream and measure, each member's own
streams, its span of the shared-memory grid) and uploaded with the
stream pointers; the kernel reads the shapes at run time, so one
instance runs any wave.

``probe_groups`` (``ref.check_probe_groups``; ``sql.compile`` lowers a
wave's joins to them) makes the streams that one fact key column probes
against one dimension key one group, probed once a row through a merged
table; without it every stream is a group of its own, probing its own
table.

Each member's groups [0, span) are summed in a per-block int64 grid in
shared memory and the rest with int64 atomics into the output, which
stays in L2.  The spans are fitted, smallest member first, into
``ACC_BUDGET_BYTES``; ``member_groups`` says how many groups each member
can reach (a plan's ``n_groups``; default: the wave's), and only changes
where a sum is taken, never its bits.  A block also holds the parameters
and, for each of its 256 threads, an 8-byte probe state per probe group
and one value per measure (``smem_bytes``).

The launch asks the runtime nothing: the resident blocks are asked once
per device and shared-memory size (``build.resident``), the arguments
cross to C by one pointer and the launch goes through ``build.launch``.
The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.multi_spja``'s alone.
``LAUNCHES`` counts the kernel launches of this process: one a wave of
up to ``MAX_MEMBERS`` members (a larger wave runs 64 members a launch).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = 0

MAX_MEMBERS = 64                # kMaxMembers: bits of the live mask
THREADS = 256                   # kThreads
# Shared memory a block gives its int64 member grids (64 groups): the
# smallest members only.  On the 13-query SSB wave every sum through L2
# ran 1.17x faster than an 8 KB grid and than a 24 KB one (nine and ten of
# its 13 members in shared memory; PERF.md), but a member whose rows all
# meet at one group would put every row's atomic on one L2 address; in
# shared memory those spread over the SMs.  The server's wave budget
# (ROADMAP queue 1, item 12) derives from it.
ACC_BUDGET_BYTES = 512
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_LG = {1: 5, 2: 4, 4: 3, 8: 2, 16: 1, 32: 0}

_SIGNATURES = {
    "multi_spja_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "multi_spja_shape": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
}


class _Args(ctypes.Structure):
    """``multi_spja_launch``'s arguments (``csrc/multi_fused.cu``'s
    ``MultiArgs``), passed by one pointer."""
    _fields_ = [("host_words", ctypes.c_void_p),
                ("n_words", ctypes.c_longlong), ("params", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("out", ctypes.c_void_p),
                ("blocks", ctypes.c_longlong)]


def library() -> ctypes.CDLL:
    return build.load("multi_fused", _SIGNATURES)


def _i32(v: int) -> int:
    return v - (1 << 32) if v >> 31 else v


def _mask_words(bits: np.ndarray) -> List[int]:
    """A member mask (bool per member) as two int32 words, low first."""
    m = int(sum(1 << q for q in np.flatnonzero(bits)))
    return [_i32(m & 0xFFFFFFFF), _i32(m >> 32)]


def _width_words(phys: int) -> List[int]:
    mask = 0xFFFFFFFF if phys == 32 else (1 << phys) - 1
    return [_LG[phys], phys, _i32(mask)]


def spans(member_groups, valid: np.ndarray, n_groups: int,
          budget_bytes: int) -> np.ndarray:
    """Each member's span of the shared-memory grid: its reachable groups
    (``member_groups``, clipped to n_groups; 0 for a padding member),
    given smallest first while they fit ``budget_bytes`` of int64
    entries; a member that does not fit gets 0 (all its sums go to the
    output)."""
    q = valid.shape[0]
    want = np.full(q, n_groups, np.int64) if member_groups is None else \
        np.clip(np.asarray(member_groups, np.int64).reshape(q), 0, n_groups)
    want = np.where(valid > 0, want, 0)
    out = np.zeros(q, np.int64)
    room = budget_bytes // 8
    for i in np.argsort(want, kind="stable"):
        if 0 < want[i] <= room:
            out[i] = want[i]
            room -= want[i]
    return out


def param_words(bounds, mults, use, valid, sel, n_groups: int,
                pred_widths, key_widths, key_refs, m_widths, m_refs,
                groups, span) -> np.ndarray:
    """The kernel's int32 parameter words for up to 64 members (layout in
    ``csrc/multi_fused.cu``).  ``groups``: the probe groups in probe
    order, each (its streams in bit order, its table's slot mask, its
    payload matrix's entries, 0 for a table of one stream).  Only real
    members (``valid``) enter the column, group, stream and measure
    masks."""
    q, c = bounds.shape[:2]
    j, m = mults.shape[1], len(m_widths)
    real = valid > 0
    every = np.array([_I32_MIN, _I32_MAX])
    filt = real[:, None] & (bounds != every).any(axis=2)        # (Q, C)
    uses = real[:, None] & (use > 0)                            # (Q, J)
    need = uses | (real[:, None] & (mults != 0))
    op = sel[:, 2]
    mneed = np.zeros((q, m), bool)
    for qi in np.flatnonzero(real):
        mneed[qi, sel[qi, 0]] = True
        if op[qi]:
            mneed[qi, sel[qi, 1]] = True
    place = {}                      # stream -> (group, bit)
    for g, (streams, _, _) in enumerate(groups):
        for b, jj in enumerate(streams):
            place[jj] = (g, b)
    offs = np.concatenate([[0], np.cumsum(span)[:-1]])
    pairs, members = [], []
    for qi in range(q):
        own = [(*place[jj], int(mults[qi, jj])) for jj in range(j)
               if real[qi] and mults[qi, jj]]
        members.append([int(sel[qi, 0]), int(sel[qi, 1]), int(op[qi]),
                        int(offs[qi]), int(span[qi]), len(pairs) // 3,
                        len(own)])
        pairs += [v for p in own for v in p]
    words = [q, c, len(groups), j, m, n_groups, int(span.sum()),
             len(pairs) // 3, *_mask_words(real)]
    for ci in range(c):
        words += _width_words(pred_widths[ci]) + _mask_words(filt[:, ci])
    words += bounds.transpose(1, 0, 2).reshape(-1).tolist()
    first, order = 0, []
    for streams, slot_mask, entries in groups:
        s0 = streams[0]
        words += _width_words(key_widths[s0]) + [
            key_refs[s0] if key_widths[s0] != 32 else 0, _i32(slot_mask),
            first, len(streams), entries,
            *_mask_words(need[:, list(streams)].any(axis=1)),
            *_mask_words(uses[:, list(streams)].any(axis=1))]
        first += len(streams)
        order += streams
    for jj in order:
        words += _mask_words(uses[:, jj])
    for mi in range(m):
        words += _width_words(m_widths[mi]) + [
            m_refs[mi] if m_widths[mi] != 32 else 0,
            *_mask_words(mneed[:, mi])]
    for row in members:
        words += row
    words += pairs
    return np.array(words, np.int64).astype(np.int32)


def smem_bytes(words: np.ndarray) -> int:
    """Dynamic shared memory one block takes for these words (the .cu's
    ``smem_bytes``)."""
    q, c, g, j, m, _, acc_groups = (int(v) for v in words[:7])
    n_ptrs = c + 3 * g + m
    return 8 * acc_groups + 8 * n_ptrs + 4 * ((words.size + 1) & ~1) + \
        8 * THREADS * g + 4 * THREADS * m


def blocks_per_sm(smem: int, device=None) -> int:
    """Blocks of the kernel one SM holds at ``smem`` bytes of dynamic
    shared memory (the occupancy PERF.md records)."""
    index = torch.cuda.current_device() if device is None else \
        torch.device(device).index
    return build.resident(library(), "multi_spja_shape", index, smem) // \
        torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_device(measure_cols) -> torch.device:
    """The streams' device, which must be a card."""
    if not measure_cols:
        raise ValueError("multi_spja needs at least one measure column")
    device = measure_cols[0].device
    if device.type != "cuda":
        raise ValueError(f"multi_spja: no kernel for device {device}")
    return device


def _lower(pred_cols, pred_bounds, join_keys, join_tables, join_mults,
           join_use, q_valid, measure_cols, measure_sel, n_groups,
           pred_widths, key_widths, key_refs, m_widths, m_refs, n_rows,
           member_groups, probe_groups):
    """Check a call and lower it -> (device, n, Q, stream pointers,
    [(first member, words)] one entry a launch)."""
    device = _kernel_device(measure_cols)
    n_preds, n_joins, n_meas = len(pred_cols), len(join_keys), \
        len(measure_cols)
    bounds, mults, use, valid, sel = ref.wave_params(
        pred_bounds, join_mults, join_use, q_valid, measure_sel, n_preds,
        n_joins, n_meas)
    pred_widths = ref.stream_widths(pred_widths, n_preds)
    key_widths = ref.stream_widths(key_widths, n_joins)
    m_widths = ref.stream_widths(m_widths, n_meas)
    krefs = ref.refs_list(key_refs, n_joins)
    mrefs = ref.refs_list(m_refs, n_meas)
    if n_rows is None:
        if m_widths[0] != 32:
            raise ValueError("n_rows is required when the measure stream "
                             "is bit-packed")
        n_rows = measure_cols[0].shape[0]
    n = int(n_rows)
    if n_groups < 1 or n_groups > _I32_MAX:
        raise ValueError(f"n_groups={n_groups}: at least one, under 2^31")
    if len(join_tables) != 2 * n_joins:
        raise ValueError(f"{len(join_tables)} join tables for {n_joins} "
                         "joins")
    if any(not _I32_MIN <= v <= _I32_MAX for v in krefs + mrefs):
        raise ValueError("key_refs/m_refs: a value outside int32")
    index = device.index
    for what, streams, widths in (("pred_cols", pred_cols, pred_widths),
                                  ("join_keys", join_keys, key_widths),
                                  ("measure_cols", measure_cols, m_widths)):
        for i, (s, w) in enumerate(zip(streams, widths)):
            length = -(-n // (32 // w))
            if not build.streams_ok(length, index, torch.int32, s):
                build.check_stream(s, f"{what}[{i}]", length, device)
    groups = [((j,), None) for j in range(n_joins)] if probe_groups is None \
        else ref.check_probe_groups(probe_groups, join_keys, key_widths,
                                    krefs)
    lowered, tables = [], []
    for streams, merged in groups:
        if merged is None:
            htk, htv = join_tables[2 * streams[0]:2 * streams[0] + 2]
            s = htk.shape[0]
            what = f"join_tables[{2 * streams[0]}]"
            if not build.streams_ok(s, index, torch.int32, htk, htv):
                build.check_stream(htk, what, s, device)
                build.check_stream(htv, what, s, device)
            entries = 0
        else:
            htk, htv = merged
            s, entries = htk.shape[0], htv.shape[1]
            what = f"probe group {streams}"
            if htk.device != device or htv.device != device or \
                    not htk.is_contiguous() or not htv.is_contiguous() or \
                    htk.data_ptr() % 16:
                raise ValueError(f"{what}: merged tables must be contiguous "
                                 f"on {device}, the slots 16-byte aligned")
            if entries < 1 or entries > _I32_MAX:
                raise ValueError(f"{what}: {entries} entries")
        if s < 1 or s & (s - 1) or s > 1 << 32:
            raise ValueError(f"{what}: slot count {s} is not a power of 2 "
                             "up to 2^32")
        lowered.append((streams, s - 1, entries))
        tables.append((join_keys[streams[0]], htk, htv))
    ptrs = [t.data_ptr() for t in (*pred_cols, *(k for k, _, _ in tables),
                                   *(t for _, t, _ in tables),
                                   *(v for _, _, v in tables),
                                   *measure_cols)]
    q = valid.shape[0]
    span = spans(member_groups, valid, n_groups, ACC_BUDGET_BYTES)
    chunks = []
    for lo in range(0, q, MAX_MEMBERS):
        hi = min(q, lo + MAX_MEMBERS)
        words = param_words(bounds[lo:hi], mults[lo:hi], use[lo:hi],
                            valid[lo:hi], sel[lo:hi], n_groups, pred_widths,
                            key_widths, krefs, m_widths, mrefs, lowered,
                            span[lo:hi])
        smem = smem_bytes(words)
        if smem > build.SMEM_LIMIT:
            raise ValueError(
                f"a {hi - lo}-member wave of {n_preds} columns, "
                f"{len(groups)} probe groups and {n_meas} measures takes "
                f"{smem} bytes of shared memory a block, over "
                f"{build.SMEM_LIMIT}")
        chunks.append((lo, words))
    return device, n, q, ptrs, chunks


def block_smem(pred_cols, pred_bounds, join_keys, join_tables, join_mults,
               join_use, q_valid, measure_cols, measure_sel,
               n_groups: int = 1, pred_widths=None, key_widths=None,
               key_refs=None, m_widths=None, m_refs=None, n_rows=None,
               member_groups=None, probe_groups=None) -> int:
    """Dynamic shared memory a block of this call's (largest) launch takes,
    for the record of its occupancy (``blocks_per_sm``)."""
    _kernel_device(measure_cols)
    *_, chunks = _lower(pred_cols, pred_bounds, join_keys, join_tables,
                        join_mults, join_use, q_valid, measure_cols,
                        measure_sel, n_groups, pred_widths, key_widths,
                        key_refs, m_widths, m_refs, n_rows, member_groups,
                        probe_groups)
    return max(smem_bytes(words) for _, words in chunks)


def multi_spja(pred_cols: Sequence[torch.Tensor], pred_bounds,
               join_keys: Sequence[torch.Tensor],
               join_tables: Sequence[torch.Tensor], join_mults, join_use,
               q_valid, measure_cols: Sequence[torch.Tensor], measure_sel,
               n_groups: int = 1, pred_widths=None, key_widths=None,
               key_refs=None, m_widths=None, m_refs=None, n_rows=None,
               member_groups=None, acc=None,
               probe_groups=None) -> torch.Tensor:
    """Run a wave of Q SPJA queries in one kernel launch -> (Q, n_groups)
    f32 (arguments as ``ref.multi_spja``).  The stacked parameters are
    host integers (numpy or tensors); ``member_groups`` (Q,) only places
    the sums (see the module note); ``probe_groups`` lowers the joins to
    one probe a group (default: each stream its own group).  ``acc``: a
    (Q, n_groups) int64 tensor on the streams' device the sums are added
    to; it is returned, not rounded (a morsel fold's running sums)."""
    global LAUNCHES
    _kernel_device(measure_cols)
    lib = library()
    device, n, q, ptrs, chunks = _lower(
        pred_cols, pred_bounds, join_keys, join_tables, join_mults,
        join_use, q_valid, measure_cols, measure_sel, n_groups, pred_widths,
        key_widths, key_refs, m_widths, m_refs, n_rows, member_groups,
        probe_groups)
    if acc is None:
        out = torch.zeros((q, n_groups), dtype=torch.int64, device=device)
    else:
        ref.check_acc(acc, (q, n_groups), device)
        out = acc
    if n == 0 or q == 0:
        return out if acc is not None else out.to(torch.float32)
    ptr_words = np.array(ptrs, np.uint64).view(np.int64)
    for lo, words in chunks:
        smem = smem_bytes(words)
        blocks = build.resident(lib, "multi_spja_shape", device.index, smem)
        if blocks < 1:
            raise RuntimeError(f"multi_spja: a block of {smem} bytes of "
                               "shared memory does not fit an SM")
        # the pointers, then the words: one upload a launch
        params = torch.from_numpy(np.concatenate([
            ptr_words, np.resize(words, (words.size + 1) & ~1).view(
                np.int64)])).to(device)
        args = _Args(words.ctypes.data, words.size, params.data_ptr(), n,
                     out[lo].data_ptr(), blocks)
        build.launch(lib, lib.multi_spja_launch, device, "multi_spja",
                     ctypes.addressof(args))
        LAUNCHES += 1
    return out if acc is not None else out.to(torch.float32)
