"""Fine-grained Mixture-of-Experts FFN (DeepSeekMoE / Qwen3-MoE style).

Dispatch turns the (token, expert) assignments into a contiguous block of
token slots per expert by a stable sort, a prefix sum of the per-expert
counts and a shuffle into (capacity,) blocks, the reference's compaction
layout; the expert FFNs then run on the gathered blocks only.  Slots past
an expert's capacity are dropped (GShard semantics).

One card holds the whole expert set, so ``moe_ffn`` always takes the local
path; the reference's expert-parallel ``shard_map`` path needs a mesh of
several cards and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import _ambient_axes
from repro_torch.models.layers import Init, Params, _act, dense_init, dtype_of


def moe_init(init: Init, cfg: ModelConfig) -> Params:
    d, e, dff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = dtype_of(cfg.param_dtype)
    experts = init.stacked(e)
    p: Params = {
        "router": dense_init(init, d, e, torch.float32, scale=0.02),
        "w_gate": dense_init(experts, d, dff, dt),
        "w_up": dense_init(experts, d, dff, dt),
        "w_down": dense_init(experts, dff, d, dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = {
            "w_gate": dense_init(init, d, cfg.shared_d_ff, dt),
            "w_up": dense_init(init, d, cfg.shared_d_ff, dt),
            "w_down": dense_init(init, cfg.shared_d_ff, d, dt),
        }
    return p


def _capacity(cfg: ModelConfig, tokens_per_sample: int) -> int:
    c = int(cfg.moe_top_k * tokens_per_sample * cfg.moe_capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # rounded up to a multiple of 8


def _route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """(B,S,d) -> gates (B,S,E) f32, top_w (B,S,k), top_i (B,S,k).  Ties
    go to the lower expert index, as ``lax.top_k`` breaks them."""
    logits = x.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :cfg.moe_top_k], top_i[..., :cfg.moe_top_k]
    if cfg.moe_renormalize:
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return gates, top_w, top_i


def _experts_slice(cfg: ModelConfig, x, top_w, top_i, wg, wu, wd,
                   e_start: int, e_local: int, cap: int):
    """Run the expert slice [e_start, e_start+e_local) over its assigned
    tokens.  x: (B,S,d); wg/wu/wd: (e_local, ...).  Returns the (B,S,d)
    partial output (zeros for tokens routed elsewhere or dropped) and the
    (B,E) per-expert counts.

    Per sample: a stable sort of the (token, choice) slots by expert id,
    a prefix sum of the per-expert counts, and a shuffle of each expert's
    slots into a contiguous (cap,) block; every dropped slot is written to
    one scrap cell that is cut away.
    """
    b, s, d = x.shape
    k = cfg.moe_top_k
    sk = s * k
    dev = x.device
    flat_e = top_i.reshape(b, sk)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort_idx)
    b_idx = torch.arange(b, device=dev)[:, None]
    counts = torch.zeros((b, cfg.n_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts           # exclusive
    pos_in_e = torch.arange(sk, device=dev)[None, :] \
        - torch.gather(offsets, -1, sorted_e)
    rel = sorted_e - e_start
    in_slice = (rel >= 0) & (rel < e_local) & (pos_in_e < cap)
    row = torch.where(in_slice, rel, e_local)
    col = torch.where(in_slice, pos_in_e, cap)
    table = torch.full((b, e_local + 1, cap + 1), sk, dtype=torch.int64,
                       device=dev)
    table[b_idx, row, col] = sort_idx
    dispatch = table[:, :e_local, :cap]                       # (B,El,cap)
    valid = dispatch < sk
    token_idx = torch.where(valid, dispatch // k, s)          # pad row = s

    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xg = x_pad[b_idx[..., None], token_idx]                   # (B,El,cap,d)
    h = _act(torch.einsum("becd,edf->becf", xg, wg), cfg.activation)
    h = h * torch.einsum("becd,edf->becf", xg, wu)
    y = torch.einsum("becf,efd->becd", h, wd)                 # (B,El,cap,d)

    w_pad = torch.cat([top_w.reshape(b, sk), top_w.new_zeros((b, 1))], dim=1)
    safe = torch.where(valid, dispatch, sk)
    disp_w = w_pad[b_idx[..., None], safe]                    # (B,El,cap)
    y = y * disp_w[..., None].to(y.dtype)
    out = torch.zeros((b, s + 1, d), dtype=y.dtype, device=dev)
    out.index_put_((b_idx[..., None].expand_as(token_idx), token_idx), y,
                   accumulate=True)
    return out[:, :s].to(x.dtype), counts


def _aux_loss(cfg: ModelConfig, gates, counts, sk: int) -> torch.Tensor:
    frac_tokens = counts.float() / sk                         # (B,E)
    frac_prob = torch.mean(gates, dim=1)                      # (B,E)
    return cfg.n_experts * torch.mean(
        torch.sum(frac_tokens * frac_prob, dim=-1))


def _shared_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    sp = p["shared"]
    hs = _act(x @ sp["w_gate"], cfg.activation) * (x @ sp["w_up"])
    return hs @ sp["w_down"]


def _moe_ffn_local(p: Params, cfg: ModelConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full expert set on one device."""
    b, s, d = x.shape
    cap = _capacity(cfg, s)
    gates, top_w, top_i = _route(p, cfg, x)
    out, counts = _experts_slice(cfg, x, top_w, top_i, p["w_gate"],
                                 p["w_up"], p["w_down"], 0,
                                 cfg.n_experts, cap)
    if "shared" in p:
        out = out + _shared_ffn(p, cfg, x)
    return out, _aux_loss(cfg, gates, counts, s * cfg.moe_top_k)


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out, aux_loss)."""
    if _ambient_axes() is not None:
        raise NotImplementedError("expert-parallel MoE over a mesh of cards "
                                  "is not ported")
    return _moe_ffn_local(p, cfg, x)
