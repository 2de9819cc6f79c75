"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback, plus a bf16 fast path.

Formulation (per leaf and participant; the reference's):
    g' = g + e                         # apply residual (error feedback)
    s  = max(|g'|) / 127               # per-participant scale
    q  = round(g' / s)  in int8        # half to even, as jnp.round
    r  = sum(q) * mean(s) / n          # reduced value (int32 sum of q)
    e' = g' - q * s                    # new residual (local)
Error feedback keeps the *accumulated* quantization error bounded, so SGD
convergence is preserved (Karimireddy et al., 2019).

``compressed_psum(g, err, group)`` and ``bf16_psum(g, group)`` are the
reference's, over the ranks of a ``torch.distributed`` process group in
place of a mesh axis; each rank passes its own gradient.  On the wire:

  compressed_psum — the int8 q summed as int32 in one ``all_reduce`` (an
                    int8 sum would overflow, so 4 bytes an element), and
                    the scales in one f32 ``all_reduce`` of n slots, each
                    rank writing its own.  Both sums are exact, and the
                    slots are added in rank order as the stacked form
                    adds them, so the result is the stacked form's bits;
  bf16_psum       — one bf16 ``all_reduce`` (2 bytes an element).  The
                    backend adds in bf16, rounding each of the n - 1
                    additions, where the reference's ``psum`` (and the
                    stacked form) adds in f32 and rounds once, so the two
                    differ by at most n - 1 bf16 roundings of the partial
                    sums: 2^-9 (n - 1) of the sum of the |g| a step.

``compressed_psum_stacked`` and ``bf16_psum_stacked`` are the plain
versions: the P participants' gradients stacked on a leading axis of one
process's tensors, the reference's formulas over that axis (its 8-device
``shard_map`` bits).  The group forms are held to them.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.api import tree_map


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar, new_err). Pure local math."""
    gf = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over the ranks of ``group``:
    every rank calls it with its own gradient and residual ->
    (the mean-reduced gradient in ``g``'s dtype, this rank's new
    residual f32)."""
    q, scale, new_err = quantize(g, err)
    n = dist.get_world_size(group)
    reduced = q.to(torch.int32)
    dist.all_reduce(reduced, group=group)
    slots = torch.zeros(n, dtype=torch.float32, device=g.device)
    slots[dist.get_rank(group)] = scale
    dist.all_reduce(slots, group=group)
    scale_sum = slots[0]
    for i in range(1, n):           # rank order, as the stacked form
        scale_sum = scale_sum + slots[i]
    out = reduced.to(torch.float32) * (scale_sum / n) / n
    return out.to(g.dtype), new_err


def bf16_psum(g: torch.Tensor, group) -> torch.Tensor:
    """bf16-on-the-wire all-reduce over the ranks of ``group`` -> the
    mean in ``g``'s dtype (the backend's bf16 sum: see the module's
    notes)."""
    n = dist.get_world_size(group)
    wire = g.to(torch.bfloat16).contiguous()
    dist.all_reduce(wire, group=group)
    return (wire.to(torch.float32) / n).to(g.dtype)


def compressed_psum_stacked(gs: torch.Tensor, errs: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over the leading axis of
    ``gs`` (one slice a participant) -> (the mean-reduced gradient in
    ``gs``' dtype, every participant's new residual (P, ...) f32)."""
    n = gs.shape[0]
    qs, scales, new_errs = zip(*(quantize(g, e) for g, e in zip(gs, errs)))
    reduced = torch.stack(qs).to(torch.int32).sum(dim=0, dtype=torch.int32)
    scale_sum = scales[0]
    for s in scales[1:]:
        scale_sum = scale_sum + s
    out = reduced.to(torch.float32) * (scale_sum / n) / n
    return out.to(gs.dtype), torch.stack(new_errs)


def bf16_psum_stacked(gs: torch.Tensor) -> torch.Tensor:
    """bf16-on-the-wire all-reduce over the leading axis (2x compression,
    no residual needed) -> the mean in ``gs``' dtype.  The bf16 values
    are summed in f32 and the sum rounded to bf16 once, as the
    reference's ``psum`` of bf16 gives them."""
    n = gs.shape[0]
    total = gs.to(torch.bfloat16).to(torch.float32).sum(dim=0)
    return (total.to(torch.bfloat16).to(torch.float32) / n).to(gs.dtype)


def init_error_state(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
