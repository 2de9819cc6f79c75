"""AdamW, written out leaf by leaf as the reference writes it.

Mixed precision as the reference keeps it: params may be bf16; the
optimizer then holds an fp32 ``master`` copy of every leaf, and the
first and second moments in ``moments_dtype``.  When every param is
already fp32 the master copy is skipped.

The schedule and the bias corrections are f32 tensors on the params'
device (``step`` an int32 0-d tensor), as the reference computes them
under ``jit``: no step is read back to the host.  ``adamw_update``
writes the new params, moments and master into the given tensors under
``torch.no_grad()`` and returns the same trees: this stands where the
reference donates its buffers (``donate_argnums``).

Weight decay follows the reference's ``ndim > 1`` rule on the stacked
trees, so the per-layer norms and biases, of shape ``(L, d)``, are
decayed too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import api
from repro_torch.models.api import leaves, tree_map

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` a 0-d tensor -> 0-d f32."""
    step = step.to(torch.float32)
    warm = step * cfg.lr / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1.0 + torch.cos(prog * math.pi))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Tree, moments_dtype: torch.dtype = torch.float32
                   ) -> Tree:
    """Zero moments in ``moments_dtype`` (bf16 halves their memory), an
    int32 step, and an fp32 master copy when any param is not fp32 —
    every tensor on its param's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moments_dtype,
                                  device=p.device)
    device = next(t for _, t in leaves(params)).device
    state: Tree = {"m": tree_map(zeros, params),
                   "v": tree_map(zeros, params),
                   "step": torch.zeros((), dtype=torch.int32, device=device)}
    if any(p.dtype != torch.float32 for _, p in leaves(params)):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def state_from_numpy(state: Tree, params: Tree) -> Tree:
    """The reference's optimizer state (nested dicts of numpy arrays) as
    this package's, on the params' device: the moments and master keep
    their own dtypes (fp32, or bf16 moments) and the step its int32, so
    the state carries across bit for bit; every moment and master leaf
    must have its param's shape."""
    device = next(t for _, t in leaves(params)).device
    want = {"m", "v", "step"} | ({"master"} if "master" in state else set())
    if set(state) != want:
        raise ValueError(f"opt state keys {sorted(state)}, expected "
                         f"{sorted(want)}")
    out = {k: api.carry(params, state[k], device, k, cast=False)
           for k in sorted(want - {"step"})}
    out["step"] = api.tensor_from_numpy(state["step"], device).to(torch.int32)
    if out["step"].shape != ():
        raise ValueError(f"step: shape {tuple(out['step'].shape)}, "
                         f"expected ()")
    return out


def global_norm(tree: Tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for _, g in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree, state: Tree,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step, written in place into ``params`` and ``state``
    (which are returned).  -> (params, state, {"grad_norm", "lr"}).

    ``grad_norm``: the norm to clip by, when ``grads`` is a part of the
    gradient (a rank's blocks): the whole gradient's.  Without it the
    norm is ``grads``' own."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(gnorm.new_full((), cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-12), max=1.0) \
        if cfg.grad_clip > 0 else gnorm.new_ones(())
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    masters = state.get("master", params)
    grad_of = dict(leaves(grads))
    m_of, v_of = dict(leaves(state["m"])), dict(leaves(state["v"]))
    master_of = dict(leaves(masters))
    for path, p in leaves(params):
        m, v, master = m_of[path], v_of[path], master_of[path]
        g = grad_of[path].to(torch.float32) * scale
        m.copy_(cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v.to(torch.float32)
                + (1 - cfg.b2) * torch.square(g))
        mh = m.to(torch.float32) / b1c
        vh = v.to(torch.float32) / b2c
        mast = master.to(torch.float32)
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        if mast.ndim > 1:
            upd = upd + cfg.weight_decay * mast
        new_master = mast - lr * upd
        if master is not p:
            master.copy_(new_master)
        p.copy_(new_master)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
