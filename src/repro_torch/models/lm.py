"""Decoder-only language model for the dense / moe / vlm / ssm / hybrid
families.

The parameter tree is the reference's: every per-layer tensor is stacked
on a leading ``L`` axis under ``params["layers"]``, and a Python loop over
the layers takes the place of ``lax.scan``.  Three entry points per
family:

  * ``forward``      — full-sequence logits
  * ``prefill``      — full-sequence forward that also fills a decode cache
  * ``decode_step``  — one-token step against the cache, updated in place

Every entry point takes each layer from one ``unbind(0)`` of every
stacked leaf (``unstack``, views), so that the backward pass of the
training forward gathers the layers' gradients with one ``stack`` a
leaf.  ``forward`` is also the training forward: under
``cfg.remat``, while grad is enabled, each layer body runs under
``torch.utils.checkpoint`` (``run_layer``), where the reference wraps its
scan body in ``jax.checkpoint``.  The reference also checkpoints the
chunked-attention body (``layers._chunked_attention``); the port does
not: that changes the memory a backward pass holds, not its values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import constrain
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _attn_block_init(init: L.Init, cfg: ModelConfig) -> Params:
    dt = L.pdtype(cfg)
    return {
        "attn_norm": init.full((cfg.d_model,), 1.0, dt),
        "attn": L.attn_init(init, cfg),
        "ffn_norm": init.full((cfg.d_model,), 1.0, dt),
        "ffn": L.ffn_init(init, cfg),
    }


def _layer_init(init: L.Init, cfg: ModelConfig) -> Params:
    """The stacked layers' params (family-dependent)."""
    if cfg.family in ("ssm", "hybrid"):
        return {
            "norm": init.full((cfg.d_model,), 1.0, L.pdtype(cfg)),
            "mamba": M.mamba2_init(init, cfg),
        }
    p = _attn_block_init(init, cfg)
    if cfg.family == "moe":
        del p["ffn"]
        p["moe"] = MOE.moe_init(init, cfg)
    return p


def init_params(init: L.Init, cfg: ModelConfig) -> Params:
    dt = L.pdtype(cfg)
    params: Params = {
        "embed": L.embed_init(init, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": init.full((cfg.d_model,), 1.0, dt),
        "layers": _layer_init(init.stacked(cfg.n_layers), cfg),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(init, cfg.d_model, cfg.vocab_size,
                                         dt)
    if cfg.family == "hybrid":
        params["shared_attn"] = _attn_block_init(init, cfg)
    return params


def unstack(tree: Params, n: int) -> list:
    """The ``n`` layers of a stacked tree from one ``unbind(0)`` of each
    leaf (views): under autograd each leaf's gradient is then one stack
    of the layers' gradients, not a zero-filled stack added per layer."""
    flat = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def run_layer(cfg: ModelConfig, body, *args):
    """``body(*args)``, recomputed in the backward pass instead of saved
    when ``cfg.remat`` and grad is enabled."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


# ---------------------------------------------------------------------------
# per-layer bodies
# ---------------------------------------------------------------------------


def _dense_layer(lp: Params, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    a = L.attention(lp["attn"], cfg,
                    L.rms_norm(h, lp["attn_norm"], cfg.norm_eps), positions)
    h = h + a
    hin = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = MOE.moe_ffn(lp["moe"], cfg, hin)
    else:
        f = L.ffn(lp["ffn"], cfg, hin)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f, aux


def _shared_attn_apply(sp: Params, cfg: ModelConfig, h: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    a = L.attention(sp["attn"], cfg,
                    L.rms_norm(h, sp["attn_norm"], cfg.norm_eps), positions)
    h = h + a
    f = L.ffn(sp["ffn"], cfg, L.rms_norm(h, sp["ffn_norm"], cfg.norm_eps))
    return h + f


def _segments(cfg: ModelConfig):
    """Split the mamba stack into (attn_first, start, end) segments: the
    shared attention block runs before each segment that has
    ``attn_first``, and each application has its own KV-cache slot."""
    L_ = cfg.n_layers
    if cfg.family != "hybrid" or not cfg.attn_every:
        return [(False, 0, L_)]
    attn_pos = [i for i in range(L_)
                if i % cfg.attn_every == cfg.attn_every - 1]
    segs = []
    if attn_pos[0] > 0:
        segs.append((False, 0, attn_pos[0]))
    for i, p in enumerate(attn_pos):
        end = attn_pos[i + 1] if i + 1 < len(attn_pos) else L_
        segs.append((True, p, end))
    return segs


def n_attn_slots(cfg: ModelConfig) -> int:
    return sum(1 for s in _segments(cfg) if s[0])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    h = params["embed"][tokens].to(L.cdtype(cfg))
    if cfg.family == "vlm":
        h = h * math.sqrt(cfg.d_model)  # gemma embedding normalizer
        if patch_embeds is not None:
            nf = cfg.n_frontend_tokens
            h = torch.cat([patch_embeds.to(h.dtype), h[:, nf:, :]], dim=1)
    return constrain(h, "batch", None, None)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits fp32, aux_loss)."""
    b, s = tokens.shape
    positions = L.arange_pos(s, tokens.device)
    h = _embed_tokens(params, cfg, tokens, patch_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)

    layers = unstack(params["layers"], cfg.n_layers)
    if cfg.family in ("ssm", "hybrid"):
        shared = params.get("shared_attn")

        def body(h, lp):
            y, _ = M.mamba2_block(lp["mamba"], cfg,
                                  L.rms_norm(h, lp["norm"], cfg.norm_eps))
            return h + y

        for attn_first, s0, s1 in _segments(cfg):
            if attn_first:
                h = _shared_attn_apply(shared, cfg, h, positions)
            for i in range(s0, s1):
                h = run_layer(cfg, body, h, layers[i])
    else:
        def body(h, lp):
            return _dense_layer(lp, cfg, h, positions)

        for i in range(cfg.n_layers):
            h, a = run_layer(cfg, body, h, layers[i])
            aux = aux + a

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return L.logits_from_hidden(params, cfg, h), aux


# ---------------------------------------------------------------------------
# cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    """The cache structure (zeros); mirrors what prefill produces."""
    dt = L.cdtype(cfg)
    dh = cfg.resolved_head_dim

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("ssm", "hybrid"):
        w = cfg.ssm_conv_width
        cache: Params = {
            "ssm": z((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_head_dim), torch.float32),
            "conv_x": z((cfg.n_layers, batch, w - 1, cfg.d_inner), dt),
            "conv_bc": z((cfg.n_layers, batch, w - 1,
                          2 * cfg.ssm_groups * cfg.ssm_state), dt),
        }
        if cfg.family == "hybrid":
            ns = n_attn_slots(cfg)
            shape = (ns, batch, cfg.n_kv_heads, max_len, dh)
            cache["attn_k"] = z(shape, dt)
            cache["attn_v"] = z(shape, dt)
        return cache
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, dh)
    if cfg.kv_cache_dtype == "int8":
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "k_scale": z(shape[:-1], torch.bfloat16),
                "v_scale": z(shape[:-1], torch.bfloat16)}
    return {"k": z(shape, dt), "v": z(shape, dt)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, return (last-position logits fp32, filled cache)."""
    b, s = tokens.shape
    positions = L.arange_pos(s, tokens.device)
    h = _embed_tokens(params, cfg, tokens, patch_embeds)

    layers = unstack(params["layers"], cfg.n_layers)
    if cfg.family in ("ssm", "hybrid"):
        shared = params.get("shared_attn")
        states = []
        attn_ks, attn_vs = [], []
        for attn_first, s0, s1 in _segments(cfg):
            if attn_first:
                xin = L.rms_norm(h, shared["attn_norm"], cfg.norm_eps)
                a, ck, cv = L.attention_prefill(shared["attn"], cfg, xin,
                                                positions, max_len)
                h = h + a
                h = h + L.ffn(shared["ffn"], cfg,
                              L.rms_norm(h, shared["ffn_norm"], cfg.norm_eps))
                attn_ks.append(ck)
                attn_vs.append(cv)
            for i in range(s0, s1):
                lp = layers[i]
                y, st = M.mamba2_block(lp["mamba"], cfg,
                                       L.rms_norm(h, lp["norm"], cfg.norm_eps))
                h = h + y
                states.append(st)
        cache: Params = {k: torch.stack([st[k] for st in states])
                         for k in ("ssm", "conv_x", "conv_bc")}
        if attn_ks:
            cache["attn_k"] = torch.stack(attn_ks)
            cache["attn_v"] = torch.stack(attn_vs)
    else:
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = layers[i]
            xin = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            a, ck, cv = L.attention_prefill(lp["attn"], cfg, xin, positions,
                                            max_len)
            h = h + a
            hin = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
            if cfg.family == "moe":
                f, _ = MOE.moe_ffn(lp["moe"], cfg, hin)
            else:
                f = L.ffn(lp["ffn"], cfg, hin)
            h = h + f
            ks.append(ck)
            vs.append(cv)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cfg.kv_cache_dtype == "int8":
            kq, ksc = L.quantize_kv(cache["k"])
            vq, vsc = L.quantize_kv(cache["v"])
            cache = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}

    h = L.rms_norm(h[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.logits_from_hidden(params, cfg, h), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  tokens: (B,1) int; pos: the position (one for the
    whole batch).  Updates ``cache`` in place and returns it."""
    pos = int(pos)
    h = params["embed"][tokens].to(L.cdtype(cfg))
    if cfg.family == "vlm":
        h = h * math.sqrt(cfg.d_model)

    layers = unstack(params["layers"], cfg.n_layers)
    if cfg.family in ("ssm", "hybrid"):
        shared = params.get("shared_attn")
        slot = 0
        for attn_first, s0, s1 in _segments(cfg):
            if attn_first:
                xin = L.rms_norm(h, shared["attn_norm"], cfg.norm_eps)
                a, _, _ = L.attention_decode(shared["attn"], cfg, xin, pos,
                                             cache["attn_k"][slot],
                                             cache["attn_v"][slot])
                h = h + a
                h = h + L.ffn(shared["ffn"], cfg,
                              L.rms_norm(h, shared["ffn_norm"], cfg.norm_eps))
                slot += 1
            for i in range(s0, s1):
                lp = layers[i]
                st = {k: cache[k][i] for k in ("ssm", "conv_x", "conv_bc")}
                y, st_new = M.mamba2_decode(
                    lp["mamba"], cfg, L.rms_norm(h, lp["norm"], cfg.norm_eps),
                    st)
                h = h + y
                for k, v in st_new.items():
                    cache[k][i] = v
    else:
        quant = cfg.kv_cache_dtype == "int8"
        for i in range(cfg.n_layers):
            lp = layers[i]
            xin = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            if quant:
                a, *_ = L.attention_decode_q8(
                    lp["attn"], cfg, xin, pos, cache["k"][i], cache["v"][i],
                    cache["k_scale"][i], cache["v_scale"][i])
            else:
                a, _, _ = L.attention_decode(lp["attn"], cfg, xin, pos,
                                             cache["k"][i], cache["v"][i])
            h = h + a
            hin = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
            if cfg.family == "moe":
                f, _ = MOE.moe_ffn(lp["moe"], cfg, hin)
            else:
                f = L.ffn(lp["ffn"], cfg, hin)
            h = h + f

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return L.logits_from_hidden(params, cfg, h), cache
