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

``compressed_psum`` and ``bf16_psum`` take the P participants' gradients
stacked on a leading axis and compute the reference's ``psum`` formulas
over it in one process.  The query and MoE paths already reduce across
the ranks of a process group (``distributed.mesh``); these reductions
over a real group come with the sharded train step, which is not ported
yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

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


def compressed_psum(gs: torch.Tensor, errs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over the leading axis of
    ``gs`` (one slice a participant) -> (the mean-reduced gradient in
    ``gs``' dtype, every participant's new residual (P, ...) f32).
    Wire cost on a mesh: 1 byte/element + one f32 scalar, vs 4."""
    n = gs.shape[0]
    qs, scales, new_errs = zip(*(quantize(g, e) for g, e in zip(gs, errs)))
    reduced = torch.stack(qs).to(torch.int32).sum(dim=0, dtype=torch.int32)
    scale_sum = scales[0]
    for s in scales[1:]:
        scale_sum = scale_sum + s
    out = reduced.to(torch.float32) * (scale_sum / n) / n
    return out.to(gs.dtype), torch.stack(new_errs)


def bf16_psum(gs: torch.Tensor) -> torch.Tensor:
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
