"""Entry points of the port's kernels, with the reference's ``mode``
contract (``repro.kernels.ops``), decided by the device of the data:

  auto   -> the kernel on a CUDA tensor, the plain version on a CPU tensor
  kernel -> the kernel; raises on a CPU tensor (a CUDA kernel has no CPU
            form — the reference's interpret mode has no counterpart)
  ref    -> the plain version on either device (the kernels' oracle)
"""
from __future__ import annotations

from repro_torch.kernels import agg as _agg
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import project as _proj
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import select_scan as _sel
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


def select_scan(x, y, lo, hi, mode: str = "auto"):
    """SELECT y WHERE lo <= x <= hi -> (out (n,), count): stable, zeros
    past the count.  x: int32 or f32; y: 4-byte."""
    fn = _sel.select_scan if use_kernel(mode, x.device) else _ref.select_scan
    return fn(x, y, lo, hi)


def probe_join(keys, vals, ht_keys, ht_vals, mode: str = "auto"):
    """The keys found in a linear-probe table -> (payload (n,), vals (n,),
    count): stable, zeros past the count."""
    fn = _hj.probe_join if use_kernel(mode, keys.device) else \
        _ref.probe_join
    return fn(keys, vals, ht_keys, ht_vals)


def project(x1, x2, a, b, sigmoid: bool = False, mode: str = "auto"):
    """a*x1 + b*x2 in f32, optionally sigmoid."""
    fn = _proj.project if use_kernel(mode, x1.device) else _ref.project
    return fn(x1, x2, a, b, sigmoid=sigmoid)


def group_sum(group_ids, vals, n_groups: int, mode: str = "auto"):
    """SUM(vals) GROUP BY dense int32 ids -> (n_groups,) in vals' dtype."""
    fn = _agg.group_sum if use_kernel(mode, vals.device) else \
        _ref.group_sum
    return fn(group_ids, vals, n_groups)
