"""Serve step builders: prefill, and one greedy decode step.

``make_train_step`` (the optimizer step) comes with the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


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
