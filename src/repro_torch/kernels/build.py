"""Build the port's CUDA kernels from the repo's sources and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I csrc \\
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands under ``build/kernels/`` at the repo root (git
ignores it), named by a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, and is built at first use.  No ``nvcc``
or a failed build raises: there is no fallback.

Every library exports ``kernel_error_string(int)``; ``check`` turns a
launcher's nonzero return into a ``RuntimeError`` with that text,
``launch`` calls a launcher on the current stream and checks it, and
``check_stream`` is what every wrapper asks of a tensor before it passes
its pointer (``streams_ok`` the same as one cheap test).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))
SMEM_LIMIT = 232_448            # shared memory one block may use (227 KB)
# every library's C entries: name -> (restype, argtypes)
Signatures = Dict[str, Tuple[object, Sequence[object]]]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def names() -> Tuple[str, ...]:
    """Every kernel library the repo's sources define."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under torch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels are built from source and have no fallback")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    # the flags without the -I path, so a checkout's location does not
    # change the name
    digest.update(" ".join(NVCC_FLAGS[:-2]).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Build the named kernel unless it is built.  Returns the compiler
    log (``-Xptxas -v``: registers, shared memory, spills), empty when
    the library was already there; raises if ``nvcc`` fails."""
    lib = library_path(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp.so")
    res = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{res.returncode}\n{res.stdout}")
    os.replace(tmp, lib)                # atomic: readers see whole files
    return res.stdout


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The kernel's library, built if needed, loaded once per process,
    with ``signatures`` and ``kernel_error_string`` bound."""
    lib = _LOADED.get(name)          # loaded: no lock on a launch's path
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            sigs = {"kernel_error_string": (ctypes.c_char_p, [ctypes.c_int]),
                    **signatures}
            for fn, (restype, argtypes) in sigs.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _LOADED[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")


def launch(lib: ctypes.CDLL, fn, device: torch.device, what: str,
           *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream and raise if it returns a CUDA error.  The per-call path costs
    little: the device guard is entered only when ``device`` is not the
    current device, and two calls of ``torch._C`` replace public ones
    that cost more on every launch: ``_cuda_getCurrentRawStream`` (the
    call Triton's launcher makes) where ``torch.cuda.current_stream``
    builds a ``Stream`` object, and ``_cuda_getDevice`` where
    ``torch.cuda.current_device`` first checks lazy initialisation (a
    CUDA tensor exists, so it has happened)."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc:
        check(lib, rc, what)


@functools.lru_cache(maxsize=None)
def resident(lib: ctypes.CDLL, shape_fn: str, device: int, flag: int) -> int:
    """Blocks of a kernel resident on card ``device``, as the library's
    ``shape_fn(flag, &blocks)`` reports them (asked once)."""
    blocks = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        check(lib, getattr(lib, shape_fn)(flag, ctypes.byref(blocks)),
              shape_fn)
    return blocks.value


def check_stream(t: torch.Tensor, what: str, n: int, device: torch.device,
                 dtypes: Sequence[torch.dtype] = (torch.int32,)) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of ``n`` rows of one
    of ``dtypes`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        kinds = "/".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} must be a contiguous 1-D {kinds} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.shape[0] != n:
        raise ValueError(f"{what} has {t.shape[0]} rows, expected {n}")


def sweep_words(n: int, words: int, rows: int = 2) -> int:
    """int32 words of ``sweep_buffers(n, words, rows=rows)``'s buffer:
    ``rows`` output rows of n, a pad word where that is odd, the count
    (two words) and the scratch."""
    return rows * n + (rows * n & 1) + 2 + words


def sweep_buffers(n: int, words: int, device: torch.device, rows: int = 2,
                  dtype: torch.dtype = torch.int32
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One allocation for a one-sweep compaction (``csrc/lookback.cuh``)
    of n rows -> (out (rows, n) of ``dtype``, a 4-byte type; count 0-d
    int64, 8-byte aligned; the address of ``words`` int32 scratch words).
    The kernel writes all of ``out`` and the count, and its launcher
    clears the scratch."""
    buf = torch.empty((sweep_words(n, words, rows),), dtype=torch.int32,
                      device=device)
    at = rows * n + (rows * n & 1)
    count = buf[at:at + 2].view(torch.int64)[0]
    out = buf[:rows * n].view(rows, n)
    return (out if dtype == torch.int32 else out.view(dtype)), count, \
        buf.data_ptr() + 4 * (at + 2)


def streams_ok(n: int, index: int, dtype: torch.dtype,
               *tensors: torch.Tensor) -> bool:
    """Whether each tensor is a contiguous 1-D ``dtype`` tensor of ``n``
    rows on CUDA device ``index``: what ``check_stream`` asks, as one
    cheap test for a wrapper whose calls are their fixed cost.  The
    wrapper calls ``check_stream`` for the error when it is False."""
    for t in tensors:
        if t.get_device() != index or t.dtype is not dtype or \
                t.dim() != 1 or not t.is_contiguous() or t.shape[0] != n:
            return False
    return True
