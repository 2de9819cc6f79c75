"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].

The conv frontend is a stub: the model consumes precomputed frame
embeddings (B, encoder_len, d_model).  Positions are sinusoidal on both
sides.  The decode cache holds the decoder's self-attention K/V and the
encoder's cross-attention K/V, computed once at prefill.  Every entry
point walks its layers as ``lm`` does: one ``unstack`` of each stack;
the encoder and the training forward run each body under
``lm.run_layer`` (remat).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import run_layer, unstack

Params = Dict[str, Any]


def _enc_layer_init(init: L.Init, cfg: ModelConfig) -> Params:
    dt = L.pdtype(cfg)
    return {
        "attn_norm": init.full((cfg.d_model,), 1.0, dt),
        "attn": L.attn_init(init, cfg),
        "ffn_norm": init.full((cfg.d_model,), 1.0, dt),
        "ffn": L.ffn_init(init, cfg),
    }


def _dec_layer_init(init: L.Init, cfg: ModelConfig) -> Params:
    p = _enc_layer_init(init, cfg)
    p["cross_norm"] = init.full((cfg.d_model,), 1.0, L.pdtype(cfg))
    p["cross"] = L.attn_init(init, cfg)
    return p


def init_params(init: L.Init, cfg: ModelConfig) -> Params:
    dt = L.pdtype(cfg)
    return {
        "embed": L.embed_init(init, cfg.vocab_size, cfg.d_model, dt),
        "enc_layers": _enc_layer_init(init.stacked(cfg.n_encoder_layers),
                                      cfg),
        "dec_layers": _dec_layer_init(init.stacked(cfg.n_layers), cfg),
        "enc_norm": init.full((cfg.d_model,), 1.0, dt),
        "dec_norm": init.full((cfg.d_model,), 1.0, dt),
    }


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    b, f, d = frames.shape
    cdt = L.cdtype(cfg)
    pos = L.arange_pos(f, frames.device)
    h = frames.to(cdt) + L.sinusoid_positions(f, d, frames.device).to(cdt)

    def body(h, lp):
        a = L.attention(lp["attn"], cfg,
                        L.rms_norm(h, lp["attn_norm"], cfg.norm_eps),
                        pos, causal=False, use_rope=False)
        h = h + a
        return h + L.ffn(lp["ffn"], cfg,
                         L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps))

    for lp in unstack(params["enc_layers"], cfg.n_encoder_layers):
        h = run_layer(cfg, body, h, lp)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    cdt = L.cdtype(cfg)
    s = tokens.shape[1]
    return params["embed"][tokens].to(cdt) \
        + L.sinusoid_positions(s, cfg.d_model, tokens.device).to(cdt)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B,S); frames: (B,F,d) -> (logits, aux)."""
    enc = encode(params, cfg, frames)
    s = tokens.shape[1]
    pos = L.arange_pos(s, tokens.device)
    enc_pos = L.arange_pos(enc.shape[1], tokens.device)
    h = _embed(params, cfg, tokens)

    def body(h, lp):
        a = L.attention(lp["attn"], cfg,
                        L.rms_norm(h, lp["attn_norm"], cfg.norm_eps),
                        pos, causal=True, use_rope=False)
        h = h + a
        c = L.attention(lp["cross"], cfg,
                        L.rms_norm(h, lp["cross_norm"], cfg.norm_eps),
                        pos, causal=False, use_rope=False,
                        kv_source=enc, kv_positions=enc_pos)
        h = h + c
        return h + L.ffn(lp["ffn"], cfg,
                         L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps))

    for lp in unstack(params["dec_layers"], cfg.n_layers):
        h = run_layer(cfg, body, h, lp)
    h = L.rms_norm(h, params["dec_norm"], cfg.norm_eps)
    return (L.logits_from_hidden(params, cfg, h),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    dt = L.cdtype(cfg)
    dh = cfg.resolved_head_dim
    lkv = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, dh)
    lcross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_len, dh)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, shape in (("k", lkv), ("v", lkv), ("cross_k", lcross),
                             ("cross_v", lcross))}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, max_len: int
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames and run the decoder prompt; cache self-KV and
    cross-KV."""
    enc = encode(params, cfg, frames)
    b, s = tokens.shape
    pos = L.arange_pos(s, tokens.device)
    enc_pos = L.arange_pos(enc.shape[1], tokens.device)
    h = _embed(params, cfg, tokens)
    ks, vs, xks, xvs = [], [], [], []
    for lp in unstack(params["dec_layers"], cfg.n_layers):
        xin = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, ck, cv = L.attention_prefill(lp["attn"], cfg, xin, pos, max_len,
                                        use_rope=False)
        h = h + a
        cin = L.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
        c = L.attention(lp["cross"], cfg, cin, pos, causal=False,
                        use_rope=False, kv_source=enc, kv_positions=enc_pos)
        # cross K/V once, reused at every decode step
        xk = (enc @ lp["cross"]["wk"]).reshape(
            b, enc.shape[1], cfg.n_kv_heads, -1).transpose(1, 2)
        xv = (enc @ lp["cross"]["wv"]).reshape(
            b, enc.shape[1], cfg.n_kv_heads, -1).transpose(1, 2)
        h = h + c
        h = h + L.ffn(lp["ffn"], cfg,
                      L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps))
        ks.append(ck)
        vs.append(cv)
        xks.append(xk)
        xvs.append(xv)
    h = L.rms_norm(h[:, -1:, :], params["dec_norm"], cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "cross_k": torch.stack(xks), "cross_v": torch.stack(xvs)}
    return L.logits_from_hidden(params, cfg, h), cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Params]:
    """One-token step with the cached self-KV (updated in place) and
    cross-KV."""
    pos = int(pos)
    h = params["embed"][tokens].to(L.cdtype(cfg))
    h = h + L.sinusoid_at(pos, cfg.d_model, tokens.device).to(h.dtype)
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        xin = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, _, _ = L.attention_decode(lp["attn"], cfg, xin, pos,
                                     cache["k"][i], cache["v"][i],
                                     use_rope=False)
        h = h + a
        cin = L.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
        c, _, _ = L.attention_decode(lp["cross"], cfg, cin, pos,
                                     cache["cross_k"][i], cache["cross_v"][i],
                                     use_rope=False, cross=True,
                                     cross_len=cfg.encoder_len)
        h = h + c
        h = h + L.ffn(lp["ffn"], cfg,
                      L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps))
    h = L.rms_norm(h, params["dec_norm"], cfg.norm_eps)
    return L.logits_from_hidden(params, cfg, h), cache
