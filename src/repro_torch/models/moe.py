"""Fine-grained Mixture-of-Experts FFN (DeepSeekMoE / Qwen3-MoE style).

Dispatch turns the (token, expert) assignments into a contiguous block of
token slots per expert by a stable sort, a prefix sum of the per-expert
counts and a shuffle into (capacity,) blocks, the reference's compaction
layout; the expert FFNs then run on the gathered blocks only.  Slots past
an expert's capacity are dropped (GShard semantics).

Under an ambient mesh with a "model" axis that divides the expert count
(``ctx.use_mesh``), ``moe_ffn`` takes the expert-parallel path, the
reference's ``shard_map`` layout on a process group: each rank runs its
own batch rows (``local_rows``) through its slice of the experts
(``moe_shard_params``), the partial outputs are all-reduced over the
"model" ranks and the aux loss averaged over the data ranks.  Otherwise
the local path runs the whole expert set.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import mesh as MESH
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


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's batch rows of ``x`` (B, ...): the reference's ``bspec``
    split of B over the data axes when they divide it, else all of
    ``x``, as the reference replicates an indivisible batch."""
    daxes = MESH.dp_axes(mesh)
    dtot, index = 1, 0
    for a in daxes:
        n = MESH.axis_size(mesh, a)
        dtot, index = dtot * n, index * n + mesh.get_local_rank(a)
    if dtot == 1 or x.shape[0] % dtot:
        return x
    return x.chunk(dtot)[index]


def _expert_slice(mesh, cfg: ModelConfig) -> Tuple[int, int]:
    e_local = cfg.n_experts // MESH.axis_size(mesh, "model")
    return mesh.get_local_rank("model") * e_local, e_local


def moe_shard_params(p: Params, mesh) -> Params:
    """``p`` (a MoE block's parameters, or any tree holding them, such as a
    model's from ``api.from_numpy``) with every block's expert weights cut
    to this rank's slice ``[e_start, e_start + E/model)`` on the expert
    axis (copies, so the full set can be freed); the router and the
    shared experts stay whole, and a block whose expert count the
    "model" axis does not divide (it runs the local path) stays whole."""
    if not isinstance(p, dict):
        return p
    if "router" in p and "w_gate" in p:
        e, model = p["w_gate"].shape[-3], MESH.axis_size(mesh, "model")
        if e % model:
            return p
        e_local = e // model
        e_start = mesh.get_local_rank("model") * e_local
        return {k: (v.narrow(-3, e_start, e_local).clone()
                    if k in ("w_gate", "w_up", "w_down") else v)
                for k, v in p.items()}
    return {k: moe_shard_params(v, mesh) for k, v in p.items()}


def _moe_ffn_mesh(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel layout over ``mesh`` ("model" plus data axes):
    ``x`` is this rank's batch rows (``local_rows``), ``p`` its expert
    slice (``moe_shard_params``) or the whole set (cut here, as views).
    Routing runs over every expert; the slice's partial output is
    all-reduced over the "model" ranks (in f32, then cast back: the
    ranks' experts are disjoint, so the sum is the local path's up to
    its rounding), and the aux loss is the mean over the data ranks."""
    b, s, d = x.shape
    e_start, e_local = _expert_slice(mesh, cfg)
    cap = _capacity(cfg, s)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if wg.shape[-3] == cfg.n_experts:
        wg, wu, wd = (w.narrow(-3, e_start, e_local) for w in (wg, wu, wd))
    elif wg.shape[-3] != e_local:
        raise ValueError(f"{wg.shape[-3]} experts on a rank of {e_local}")
    gates, top_w, top_i = _route(p, cfg, x)
    out, counts = _experts_slice(cfg, x, top_w, top_i, wg, wu, wd,
                                 e_start, e_local, cap)
    total = out.float().contiguous()
    dist.all_reduce(total, group=mesh.get_group("model"))
    out = total.to(out.dtype)
    aux = _aux_loss(cfg, gates, counts, s * cfg.moe_top_k).reshape(1)
    dtot = 1
    for a in MESH.dp_axes(mesh):
        dtot *= MESH.axis_size(mesh, a)
        dist.all_reduce(aux, group=mesh.get_group(a))
    if "shared" in p:
        out = out + _shared_ffn(p, cfg, x)
    return out, aux[0] / dtot


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out, aux_loss).  Under an ambient mesh whose "model"
    axis divides the experts, the expert-parallel path on this rank's
    rows; else the local path (the reference's rule)."""
    am = _ambient_axes()
    if am is not None and "model" in am.axis_names \
            and cfg.n_experts % am.shape["model"] == 0:
        return _moe_ffn_mesh(p, cfg, x, am.mesh)
    return _moe_ffn_local(p, cfg, x)
