"""Train / serve step builders.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the gradients by ``torch.autograd``, accumulated
over ``cfg.train_microbatches`` microbatches in fp32 when there are
several (a Python loop where the reference runs ``lax.scan``), then the
AdamW step written in place.  The reference's ``grad_pspecs`` pins the
gradients' sharding on a mesh; one card has no mesh, so it is left out.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.api import leaves, tree_map
from repro_torch.train.optim import AdamWConfig, adamw_update


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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None
                    ) -> Callable:
    opt_cfg = opt_cfg or AdamWConfig()

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
