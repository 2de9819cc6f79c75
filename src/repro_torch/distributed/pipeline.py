"""Pipeline parallelism: a GPipe schedule over a "pipe" process group.

Each rank of the group holds one stage's slice of the stacked stage
params (the slice of their leading axis); microbatches stream through
the stages, one tick at a time.  Schedule (F = n_micro, S = n_stages,
T = F + S - 1 ticks):

    tick t: stage s computes microbatch (t - s) if 0 <= t - s < F
            then shifts its activation to stage s + 1

Bubble fraction = (S - 1) / T, reported by ``bubble_fraction`` so callers
can size F (F >= 4S keeps the bubble under ~20 %).

The reference shifts with a ``ppermute`` and broadcasts the last stage's
outputs with a masked ``psum``.  Gloo offers no ``send`` / ``recv`` on
CUDA tensors, so here every collective is an ``all_reduce`` through
``all_reduce_sum``, whose backward is one more ``all_reduce`` of the
gradient:
  the shift  — each rank writes its activation into slot (s + 1) mod S
               of an (S, mb...) zero buffer, the buffer is all-reduced,
               and each rank reads its own slot (one all-reduce a tick;
               the last tick's shift, which no stage reads, is skipped);
  the output — the last stage's finished microbatches, zeros elsewhere,
               all-reduced: every rank holds them.

Every rank makes every collective call in the same order, in the backward
pass too: each tick's activation depends on the buffer the last tick
shifted in, on every rank (stage 0 through a ``where`` that passes it a
zero gradient, an idle stage by passing it on), and every tick's output
slot is on the output's graph, so each rank's backward all-reduces form
one chain in reverse tick order.

The gradient of a loss is counted once.  Every rank holds the same
outputs; if each backpropagated its own copy of the loss, the output's
all-reduce would sum S equal gradients.  ``make_pipelined_loss`` gives
every rank the loss's value, but only rank 0 of the group passes its
gradient back (the others' copy of the outputs passes a zero gradient),
and every rank must call ``backward`` on it so that the backward
all-reduces meet.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.api import tree_map


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient is summed over it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable."""
    return _AllReduce.apply(t, group)


class _CountOnce(torch.autograd.Function):
    """The identity; the gradient passes on the counting rank alone."""

    @staticmethod
    def forward(ctx, t, counted):
        ctx.counted = counted
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.counted else torch.zeros_like(grad)), None


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, n_stages: int,
                   group) -> torch.Tensor:
    """The GPipe forward on this rank, every rank of ``group`` calling it.

    stage_fn(params_for_one_stage, h) -> h
    stage_params: this rank's stage, a tree with a leading axis of 1 (the
                  rank's slice of the stacked stages; rank s of the group
                  is stage s)
    x: (n_micro, mb, ...) microbatched input, the same on every rank

    Returns the activations after the LAST stage, (n_micro, mb, ...), on
    every rank.
    """
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages over a group of "
                         f"{dist.get_world_size(group)} ranks")
    stage = dist.get_rank(group)
    last = n_stages - 1
    sparams = tree_map(lambda a: a[0], stage_params)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    zeros = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    # the buffer before the first shift: a leaf, so that every rank's
    # first shift is on the graph whatever its stage computes
    buf = zeros.clone().requires_grad_(torch.is_grad_enabled())
    first = torch.tensor(stage == 0, device=x.device)
    keep = torch.tensor(stage == last, device=x.device)
    outs = [None] * n_micro
    for t in range(ticks):
        mb_idx = t - stage
        if 0 <= mb_idx < n_micro:
            # stage 0 reads its microbatch from x; others read the wire
            h = stage_fn(sparams, torch.where(first, x[min(t, n_micro - 1)],
                                              buf))
        else:
            h = buf
        # the last stage records finished microbatches
        if t >= last:
            outs[t - last] = torch.where(keep, h, zeros)
        if t < ticks - 1:       # shift stage s -> s + 1 (a ring)
            wire = torch.stack([h if i == (stage + 1) % n_stages else zeros
                                for i in range(n_stages)])
            buf = all_reduce_sum(wire, group)[stage]
    return all_reduce_sum(torch.stack(outs), group)


def make_pipelined_loss(stage_fn, loss_fn, n_stages, group):
    """loss over the pipelined forward: ``loss_fn(y, targets)`` on the
    last stage's outputs (targets the same on every rank).  Every rank
    gets the loss's value and must call ``backward`` on it; its gradient
    is counted once (rank 0 of ``group`` passes it back)."""
    def fn(stage_params, x, targets):
        y = pipeline_apply(stage_fn, stage_params, x, n_stages, group)
        y = _CountOnce.apply(y, dist.get_rank(group) == 0)
        return loss_fn(y, targets)
    return fn
