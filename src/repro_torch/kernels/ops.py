"""Entry points of the port's kernels, with the reference's ``mode``
contract (``repro.kernels.ops``), decided by the device of the data:

  auto   -> the kernel on a CUDA tensor, the plain version on a CPU tensor
  kernel -> the kernel; raises on a CPU tensor (a CUDA kernel has no CPU
            form — the reference's interpret mode has no counterpart)
  ref    -> the plain version on either device (the kernels' oracle)
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssb_fused as _fused

MODES = ("auto", "kernel", "ref")


def use_kernel(mode: str, device) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode == "ref":
        return False
    if device.type == "cuda":
        return True
    if mode == "kernel":
        raise RuntimeError(f"mode='kernel' needs CUDA tensors, got {device}: "
                           "the CUDA kernels have no CPU form")
    return False


def spja(pred_cols, pred_bounds, join_keys, join_tables, group_mults,
         m1, m2=None, measure_op: str = "first", n_groups: int = 1,
         mode: str = "auto"):
    """Whole SPJA query over int32 fact streams -> (n_groups,) f32 on the
    streams' device.  Arguments as ``ssb_fused.spja``; an m2 given with
    ``measure_op="first"`` is ignored (never loaded)."""
    if measure_op not in ("mul", "sub"):
        m2 = None
    fn = _fused.spja if use_kernel(mode, m1.device) else _ref.spja
    return fn(pred_cols, pred_bounds, join_keys, join_tables, group_mults,
              m1, m2, measure_op=measure_op, n_groups=n_groups)
