"""Family dispatch: one functional API over all 10 architectures.

  init(cfg, generator=None, device=None)  -> params
  forward(params, cfg, batch)             -> (logits, aux)
  loss(params, cfg, batch)                -> (scalar loss, metrics)
  prefill(params, cfg, batch, max_len)    -> (logits, cache)
  decode(params, cfg, cache, tokens, pos) -> (logits, cache), in place
  init_cache(cfg, batch, max_len, device) -> zero cache
  abstract_*                              -> trees on the meta device
  from_numpy(tree, cfg, device)           -> params from numpy arrays
  to(tree, device), param_bytes(tree)     -> a copy elsewhere, its bytes
  leaves(tree), tree_map(fn, tree)        -> (key path, leaf) pairs, a map

Parameters and caches are nested dicts of tensors with the reference's
keys and shapes.  Entry points that make tensors run on the card unless
the caller names another device.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import lm, whisper

Params = Dict[str, Any]
META = torch.device("meta")


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Random parameters drawn from ``generator`` (a generator seeded 0 on
    ``device`` when None), on ``device`` (the card when None)."""
    device = resolve(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return _init(L.Init(generator, device), cfg)


def _init(init: L.Init, cfg: ModelConfig) -> Params:
    if cfg.family == "audio":
        return whisper.init_params(init, cfg)
    return lm.init_params(init, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.family == "audio":
        return whisper.forward(params, cfg, batch["tokens"], batch["frames"])
    return lm.forward(params, cfg, batch["tokens"],
                      patch_embeds=batch.get("patch_embeds"))


def loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(params, cfg, batch)
    mask = batch.get("loss_mask")
    ce = L.cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         None if mask is None else mask[:, 1:])
    total = ce + 0.01 * aux
    return total, {"ce": ce, "aux": aux}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    if cfg.family == "audio":
        return whisper.prefill(params, cfg, batch["tokens"],
                               batch["frames"], max_len)
    return lm.prefill(params, cfg, batch["tokens"], max_len,
                      patch_embeds=batch.get("patch_embeds"))


def decode(params: Params, cfg: ModelConfig, cache: Params,
           tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Params]:
    """One token at position ``pos`` for the whole batch; writes it into
    ``cache`` in place and returns the cache."""
    if cfg.family == "audio":
        return whisper.decode_step(params, cfg, cache, tokens, pos)
    return lm.decode_step(params, cfg, cache, tokens, pos)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    if device is None or torch.device(device).type != "meta":
        device = resolve(device)
    if cfg.family == "audio":
        return whisper.init_cache(cfg, batch, max_len, device)
    return lm.init_cache(cfg, batch, max_len, device)


# ---------------------------------------------------------------------------
# abstract trees (the meta device: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig) -> Params:
    return _init(L.Init(None, META), cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return init_cache(cfg, batch, max_len, device=META)


def abstract_batch(cfg: ModelConfig, batch: int, seq: int) -> Params:
    cd = L.cdtype(cfg)
    out: Params = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                         device=META)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.empty(
            (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=cd,
            device=META)
    if cfg.family == "audio":
        out["frames"] = torch.empty((batch, cfg.encoder_len, cfg.d_model),
                                    dtype=cd, device=META)
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def leaves(tree: Params, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, tensor) of every leaf of a nested dict, keys sorted at
    every level (the reference's tree order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn, tree: Params) -> Params:
    """``fn`` of every leaf, in the same structure."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def to(tree: Params, device) -> Params:
    """A copy of a tree of tensors on ``device``."""
    return tree_map(lambda v: v.to(device), tree)


def param_bytes(params: Params) -> int:
    """Bytes of every tensor in a tree."""
    return sum(v.numel() * v.element_size() for _, v in leaves(params))


# ---------------------------------------------------------------------------
# carrying parameters across
# ---------------------------------------------------------------------------


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` too) as a tensor of the
    same dtype and bits."""
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve(device))


def carry(want: Params, got, device, path: str = "",
          cast: bool = True) -> Params:
    """``got`` (nested dicts of numpy arrays) as tensors on ``device`` in
    the structure of ``want``: every key of ``want`` must be there with
    its shape, and no other.  Values keep their bits; each leaf takes its
    ``want`` leaf's dtype when ``cast``, else keeps its own."""
    if set(want) != set(got):
        raise ValueError(f"{path or 'params'}: keys {sorted(got)}, "
                         f"expected {sorted(want)}")
    out = {}
    for k, w in want.items():
        where = f"{path}.{k}" if path else k
        if isinstance(w, dict):
            out[k] = carry(w, got[k], device, where, cast)
            continue
        t = tensor_from_numpy(got[k], device)
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"{where}: shape {tuple(t.shape)}, "
                             f"expected {tuple(w.shape)}")
        out[k] = t.to(w.dtype) if cast else t
    return out


def from_numpy(tree, cfg: ModelConfig, device=None) -> Params:
    """The parameters ``tree`` (nested dicts of numpy arrays, such as the
    reference's ``api.init`` gives) as this package's parameter tree:
    every key of ``abstract_params(cfg)`` must be there with its shape,
    and no other.  Values keep their bits; dtypes become the port's."""
    return carry(abstract_params(cfg), tree, resolve(device))
