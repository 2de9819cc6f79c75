"""Bit-unpack on the card: packed word stream -> decoded int32 column.

Wrapper of the hand-written CUDA kernel ``csrc/unpack.cu``, the port of
the Pallas TPU kernel ``repro/kernels/unpack.py::unpack``: the
materializing decode of ``repro_torch.sql.storage``'s layout.  The query
paths never call it (``spja`` and ``select_scan_packed`` decode in
registers); it is the decode for callers that need the whole column, and
the check of the layout rule the other kernels decode in registers.  Same
contract as ``ref.unpack``, bit for bit.

The wrapper launches the kernel on CUDA tensors or raises; the choice of
the plain version for a CPU tensor is ``ops.unpack``'s alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import PHYS_WIDTHS

LAUNCHES = 0

_SIGNATURES = {"unpack_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])}


def library() -> ctypes.CDLL:
    return build.load("unpack", _SIGNATURES)


def unpack(words: torch.Tensor, n: int, phys: int, ref=0) -> torch.Tensor:
    """The first ``n`` values of ``words`` (int32, ``phys`` bits a value)
    plus ``ref`` -> (n,) int32 on the words' device."""
    global LAUNCHES
    if words.device.type != "cuda":
        raise ValueError(f"unpack: no kernel for device {words.device}")
    if phys not in PHYS_WIDTHS:
        raise ValueError(f"phys {phys} not in {PHYS_WIDTHS}")
    n_words = words.shape[0]
    build.check_stream(words, "words", n_words, words.device)
    n, ref = int(n), int(ref)
    if not 0 <= n <= n_words * (32 // phys):
        raise ValueError(f"n={n} past the {n_words * (32 // phys)} values "
                         f"of {n_words} words at {phys} bits")
    if not -(1 << 31) <= ref < (1 << 31):
        raise ValueError(f"ref {ref} is outside int32")
    out = torch.empty((n,), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.unpack_launch(words.data_ptr(), n_words, n, phys, ref,
                               out.data_ptr(), stream)
    build.check(lib, rc, "unpack")
    LAUNCHES += 1
    return out
