"""One pass of every LM entry point on a seeded batch: what the card
tests and ``chip_smoke.py`` hold the card to the host with.

``pass_outputs`` runs ``forward``, ``loss``, a ``prefill`` of all but the
last two tokens and two ``decode`` steps, and returns every result (each
cache leaf copied after its step, since decode updates the cache in
place) as host tensors keyed by name.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api

BATCH, SEQ, MAX_LEN = 2, 13, 24


def batch(cfg: ModelConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """Tokens (and the stub frontend's inputs) from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a tree, in key order."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def pass_outputs(params, cfg: ModelConfig, b: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    prompt = SEQ - 2
    out = {}
    out["forward"], out["aux"] = api.forward(params, cfg, b)
    out["loss"], _ = api.loss(params, cfg, b)
    out["prefill"], cache = api.prefill(
        params, cfg, dict(b, tokens=b["tokens"][:, :prompt]), MAX_LEN)
    out.update({k: v.clone() for k, v in leaves(cache, "prefill.")})
    for step in range(2):
        pos = prompt + step
        out[f"decode{step}"], cache = api.decode(
            params, cfg, cache, b["tokens"][:, pos:pos + 1], pos)
        out.update({k: v.clone()
                    for k, v in leaves(cache, f"decode{step}.")})
    return {k: v.detach().cpu() for k, v in out.items()}


def assert_close(got, want, tol: float) -> float:
    """Every output within rtol = atol = ``tol`` (int8 caches equal);
    returns the largest absolute difference."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"outputs {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for k in want:
        g, w = got[k].double(), want[k].double()
        if got[k].shape != want[k].shape or got[k].dtype != want[k].dtype:
            raise AssertionError(f"{k}: {got[k].dtype} {tuple(got[k].shape)}"
                                 f" vs {want[k].dtype} {tuple(want[k].shape)}")
        if want[k].dtype == torch.int8:
            ok = torch.equal(got[k], want[k])
        else:
            ok = torch.allclose(g, w, rtol=tol, atol=tol)
        err = float((g - w).abs().max()) if g.numel() else 0.0
        if not ok:
            raise AssertionError(f"{k}: max abs diff {err} over "
                                 f"rtol = atol = {tol}")
        worst = max(worst, err)
    return worst
