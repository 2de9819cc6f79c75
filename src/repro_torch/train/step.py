"""Train / serve step builders.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the gradients by ``torch.autograd``, accumulated
over ``cfg.train_microbatches`` microbatches in fp32 when there are
several (a Python loop where the reference runs ``lax.scan``), then the
AdamW step written in place.  The reference's ``grad_pspecs`` pins the
gradients' sharding under GSPMD; the port has no partitioner, so it is
left out.

With a ``mesh`` (a ``DeviceMesh`` of "data" and "model" axes) the step
takes this rank's local trees, placed by ``distributed.sharding``'s rules
(``shard_train_state`` cuts them): params by ``param_pspecs`` at tp = the
"model" axis's size, AdamW's m, v and master by ``opt_pspecs(...,
zero1)``, the batch's rows by ``batch_pspecs``.  A step then

  1. gathers the whole params (one all-reduce over "model");
  2. takes the gradients of the rank's rows with them, microbatched as
     the single-rank step, summed in f32;
  3. all-reduces the gradients and the loss over the data axes in one
     f32 buffer and divides by microbatches x ``dp_size``;
  4. takes the norm of the whole reduced gradient;
  5. updates only the rank's AdamW block of each leaf, clipped by it;
  6. with ZeRO-1, re-gathers each param block over the data axes (one
     all-reduce).

Given a ``stats`` dict, the step adds to ``stats[span]`` the bytes, the
all-reduces and the host ms of each span of collectives ("param_gather",
"grad_reduce", "zero1_regather"), synchronising the device at both ends
of each; without one it neither synchronises nor times.

Data parallelism is gradient accumulation over the data shards, so the
step equals the single-rank step on the global batch in ``dp_size`` x
``cfg.train_microbatches`` microbatches (the same means, MoE's aux loss
included).  The reference lets GSPMD split the compute by the
placements; the port keeps the placements for what a rank stores and
updates and computes each data shard with the gathered weights, outside
``ctx.use_mesh`` (a MoE family takes its local path).  Every collective is
an ``all_reduce``, which gloo offers on CUDA tensors too.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import api
from repro_torch.models.api import leaves, tree_map, tree_map_with_path
from repro_torch.train.optim import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state)


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict]:
    """(detached loss, gradient tree in the params' dtypes) of
    ``api.loss`` at ``params``.  The gradients are taken on detached
    aliases of the leaves, so the params themselves stay
    ``requires_grad=False`` and no graph outlives the call."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = [t for _, t in leaves(alias)]
    with torch.enable_grad():
        loss, _ = api.loss(alias, cfg, batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, got)}
    grads = tree_map(lambda t: by_id[id(t)], alias)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    mesh=None, zero1: bool = False) -> Callable:
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, mesh, zero1)

    def train_step(params, opt_state, batch):
        n_micro = cfg.train_microbatches
        if n_micro > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            acc = dict(leaves(grads))
            for i in range(n_micro):
                mb = {k: v.unflatten(0, (n_micro, -1))[i]
                      for k, v in batch.items()}
                lv, g = loss_and_grads(params, cfg, mb)
                for path, gi in leaves(g):
                    acc[path].add_(gi.to(torch.float32))
                loss_sum = loss_sum + lv
            grads = tree_map(lambda g: g / n_micro, grads)
            loss_val = loss_sum / n_micro
        else:
            loss_val, grads = loss_and_grads(params, cfg, batch)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss_val, **opt_metrics}

    return train_step


def placements(cfg: ModelConfig, mesh, zero1: bool = False):
    """-> (the full params' shapes, their specs, the AdamW state's specs)
    on ``mesh``, from ``api.abstract_params`` (no allocation)."""
    full = api.abstract_params(cfg)
    pspecs = SH.param_pspecs(full, cfg, SH.axis_size(mesh, "model"))
    ospecs = SH.opt_pspecs(pspecs, full, mesh, zero1)
    return tree_map(lambda t: tuple(t.shape), full), pspecs, ospecs


def shard_train_state(params, cfg: ModelConfig, mesh, zero1: bool = False):
    """This rank's blocks of the whole ``params`` (copies) and
    ``init_opt_state`` of its optimizer blocks."""
    _, pspecs, ospecs = placements(cfg, mesh, zero1)
    local = tree_map(lambda t: t.detach().clone(),
                     SH.local_tree(params, pspecs, mesh))
    return local, init_opt_state(SH.local_tree(params, ospecs["m"], mesh))


@contextlib.contextmanager
def _span(stats: Optional[dict], name: str, device: torch.device):
    """With ``stats``, yields ``stats[name]`` for the span's collectives
    to add their bytes to and adds the span's host ms to it, the device
    synchronised at both ends; with none, yields None and does nothing."""
    if stats is None:
        yield None
        return
    entry = stats.setdefault(name, {"bytes": 0, "all_reduces": 0,
                                    "ms": 0.0})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield entry
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    entry["ms"] += (time.perf_counter() - t0) * 1e3


def _mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                     zero1: bool) -> Callable:
    shapes, pspecs, ospecs = placements(cfg, mesh, zero1)
    # ZeRO-1's cut of each param block: the data axes its opt spec adds
    rel = SH.relative_specs(ospecs["m"], pspecs)
    daxes, dp = SH.dp_axes(mesh), SH.dp_size(mesh)
    n_micro = cfg.train_microbatches
    shape_of = dict(leaves(shapes))
    total = sum(SH.numel(s) for s in shape_of.values())

    def train_step(params, opt_state, batch, stats: Optional[dict] = None):
        device = batch["tokens"].device
        with _span(stats, "param_gather", device) as span:
            whole = SH.gather_tree(params, pspecs, mesh, shapes, span)
        # the gradients and the loss sum in one f32 buffer: the reduce's
        buf = torch.zeros(total + 1, dtype=torch.float32, device=device)
        views, off = {}, 0
        for path, shape in shape_of.items():
            views[path] = buf[off:off + SH.numel(shape)].view(shape)
            off += SH.numel(shape)
        for i in range(n_micro):
            mb = {k: v.unflatten(0, (n_micro, -1))[i]
                  for k, v in batch.items()} if n_micro > 1 else batch
            lv, g = loss_and_grads(whole, cfg, mb)
            for path, gi in leaves(g):
                views[path].add_(gi.to(torch.float32))
            buf[-1:].add_(lv.reshape(1))
            del g
        del whole
        with _span(stats, "grad_reduce", device) as span:
            SH.all_reduce(buf, mesh, daxes, span)
        buf.div_(n_micro * dp)
        grads = tree_map_with_path(lambda path, _: views[path], shapes)
        blocks = SH.local_tree(grads, ospecs["m"], mesh)
        targets = SH.local_tree(params, rel, mesh) if zero1 else params
        _, opt_state, opt_metrics = adamw_update(
            opt_cfg, targets, blocks, opt_state,
            grad_norm=global_norm(grads))
        if zero1:
            # each param block from the data ranks' updated sub-blocks
            with _span(stats, "zero1_regather", device) as span:
                got = SH.gather_tree(
                    tree_map(torch.Tensor.contiguous, targets), rel, mesh,
                    tree_map(lambda t: tuple(t.shape), params), span)
                for (_, p), (_, g) in zip(leaves(params), leaves(got)):
                    if g is not p:
                        p.copy_(g)
        return params, opt_state, {"loss": buf[-1].clone(), **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, tokens, pos) -> (next tokens (B,1) int32, logits,
    cache): the greedy token (the first of equal maxima) after one decode
    step, the cache updated in place."""
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = api.decode(params, cfg, cache, tokens, pos)
        next_tokens = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_tokens.to(torch.int32), logits, new_cache
    return serve_step
