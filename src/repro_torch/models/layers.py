"""Shared NN layers: RMSNorm, RoPE, GQA attention (direct / chunked online
softmax / cached decode), the int8 KV cache, dense FFNs, embeddings and the
loss.

Conventions (the reference's):

* params are nested dicts of tensors; linear weights are (d_in, d_out).
* activations flow in ``cfg.compute_dtype``; norms, softmax and loss in fp32.
* attention is grouped-query: q heads = n_kv_heads * group_size.
* a product the reference accumulates in f32 from narrower inputs
  (``preferred_element_type``) casts its inputs to f32 here.

Every op is plain PyTorch: the reference computes the LM outside Pallas,
so there is no kernel of its to port here.  ``scaled_dot_product_attention``
is not used: the masking and the chunked online softmax are the
reference's, so that the results can be held to it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import constrain

Params = Dict[str, Any]

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class Init:
    """Where parameters are drawn: normal draws from ``generator`` on
    ``device`` (in f32, then cast), or shapes alone on the meta device.
    ``lead`` is a leading shape (the stacked-layer axis) given to every
    tensor it makes."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Init":
        return Init(self.generator, self.device, self.lead + (n,))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)

    def row(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` (one row) repeated along ``lead``."""
        shape = self.lead + tuple(values.shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=values.dtype, device=self.device)
        return values.to(self.device).expand(shape).clone()


def dense_init(init: Init, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), scale, dtype)


def embed_init(init: Init, vocab: int, d: int, dtype) -> torch.Tensor:
    return init.normal((vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# norm / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(dt)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[:, None] * freqs[None, :]   # (S, half)
    cos = torch.cos(angles)[:, None, :]                    # (S, 1, half)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def _expand_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B,S,Hkv,Dh) -> (B,S,Hq,Dh), each KV head repeated g times."""
    if g == 1:
        return x
    return torch.repeat_interleave(x, g, dim=2)


def _direct_attention(q, k, v, q_pos, kv_pos, causal: bool) -> torch.Tensor:
    """q: (B,Sq,Hq,Dh)  k,v: (B,Skv,Hkv,Dh)  -> (B,Sq,Hq,Dh)."""
    dh = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    k = _expand_kv(k, g)
    v = _expand_kv(v, g)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]           # (Sq, Skv)
        s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)


def _chunked_attention(q, k, v, q_pos, kv_pos, causal: bool, chunk: int
                       ) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` positions.

    Never materializes the (Sq, Skv) score matrix; peak score memory is
    (B,Hq,Sq,chunk).  A Python loop over the chunks takes the place of
    the reference's ``lax.scan``; padded KV positions carry INT32_MAX and
    are masked out.
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    n = -(-skv // chunk)
    pad = n * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=INT32_MAX)
    pc = kv_pos.reshape(n, chunk)

    qf = q.float()
    g = hq // hkv
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, dh), dtype=torch.float32, device=q.device)
    for ci in range(n):
        pb = pc[ci]
        kb = _expand_kv(k[:, ci * chunk:(ci + 1) * chunk], g)
        vb = _expand_kv(v[:, ci * chunk:(ci + 1) * chunk], g)
        s = torch.einsum("bqhd,bshd->bhqs", qf, kb.float()) * scale
        valid = pb[None, :] < INT32_MAX
        if causal:
            valid = valid & (pb[None, :] <= q_pos[:, None])
        s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p, vb.float())
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)                   # (B,Sq,Hq,Dh)


# ---------------------------------------------------------------------------
# attention module
# ---------------------------------------------------------------------------


def attn_init(init: Init, cfg: ModelConfig) -> Params:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = pdtype(cfg)
    p: Params = {
        "wq": dense_init(init, d, hq * dh, dt),
        "wk": dense_init(init, d, hkv * dh, dt),
        "wv": dense_init(init, d, hkv * dh, dt),
        "wo": dense_init(init, hq * dh, d, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((hq * dh,), 0.0, dt)
        p["bk"] = init.full((hkv * dh,), 0.0, dt)
        p["bv"] = init.full((hkv * dh,), 0.0, dt)
    if cfg.qk_norm:
        p["q_norm"] = init.full((dh,), 1.0, dt)
        p["k_norm"] = init.full((dh,), 1.0, dt)
    return p


def _project_qkv(p: Params, cfg: ModelConfig, xq, xkv, q_pos, kv_pos,
                 use_rope: bool):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, sq, hq, dh)
    k = k.reshape(b, skv, hkv, dh)
    v = v.reshape(b, skv, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def arange_pos(n: int, device) -> torch.Tensor:
    """Positions 0..n-1 (int32)."""
    return torch.arange(n, dtype=torch.int32, device=device)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True,
              use_rope: bool = True,
              kv_source: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (train / prefill / encoder / cross) attention.

    kv_source: if given, cross-attention against that sequence.
    """
    b, sq, _ = x.shape
    xkv = kv_source if kv_source is not None else x
    kv_pos = kv_positions if kv_positions is not None else positions
    q, k, v = _project_qkv(p, cfg, x, xkv, positions, kv_pos, use_rope)
    if cfg.sp_attention:
        q = constrain(q, "batch", "model", None, None)
    if max(sq, xkv.shape[1]) > cfg.attn_chunk_threshold:
        o = _chunked_attention(q, k, v, positions, kv_pos, causal,
                               cfg.attn_chunk)
    else:
        o = _direct_attention(q, k, v, positions, kv_pos, causal)
    o = o.reshape(b, sq, cfg.n_heads * cfg.resolved_head_dim).to(x.dtype)
    if cfg.sp_attention:
        o = constrain(o, "batch", "model", None)
    out = o @ p["wo"]
    if cfg.sp_attention:
        out = constrain(out, "batch", None, None)
    return out


def attention_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, cache_len: int,
                      use_rope: bool = True):
    """Prefill: causal attention, and (k, v) to seed a cache of length
    ``cache_len`` (>= S) in the layout (B, Hkv, S, Dh)."""
    b, sq, _ = x.shape
    if cache_len < sq:
        raise ValueError(f"a cache of {cache_len} positions cannot hold a "
                         f"prompt of {sq}")
    q, k, v = _project_qkv(p, cfg, x, x, positions, positions, use_rope)
    if sq > cfg.attn_chunk_threshold:
        o = _chunked_attention(q, k, v, positions, positions, True,
                               cfg.attn_chunk)
    else:
        o = _direct_attention(q, k, v, positions, positions, True)
    o = o.reshape(b, sq, cfg.n_heads * cfg.resolved_head_dim).to(x.dtype)
    out = o @ p["wo"]
    pad = cache_len - sq
    ck = F.pad(k.transpose(1, 2), (0, 0, 0, pad))
    cv = F.pad(v.transpose(1, 2), (0, 0, 0, pad))
    return out, ck, cv


def _check_pos(pos: int, sq: int, s_max: int) -> None:
    if not 0 <= pos <= s_max - sq:
        raise ValueError(f"decode position {pos} outside a cache of "
                         f"{s_max} positions")


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     pos: int, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     use_rope: bool = True, cross: bool = False,
                     cross_len: Optional[int] = None):
    """One-token decode.  x: (B,1,d); cache_k/v: (B,Hkv,S_max,Dh);
    pos: the current position (one for the whole batch).

    The new token's k and v are written into the caches in place (the
    returned caches are the ones given).  cross=True: the caches hold
    precomputed encoder K/V (no update, no causal mask).  The grouped
    einsums run against the (B,Hkv,S,Dh) cache with no expanded-KV copy;
    scores and outputs accumulate in f32.
    """
    b, sq, _ = x.shape
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    s_max = cache_k.shape[2]
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, sq, hq, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q_pos = torch.full((sq,), pos, dtype=torch.int32, device=x.device)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)

    kv_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    if not cross:
        _check_pos(pos, sq, s_max)
        k_new = x @ p["wk"]
        v_new = x @ p["wv"]
        if cfg.qkv_bias:
            k_new, v_new = k_new + p["bk"], v_new + p["bv"]
        k_new = k_new.reshape(b, sq, hkv, dh)
        v_new = v_new.reshape(b, sq, hkv, dh)
        if cfg.qk_norm:
            k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
        if use_rope:
            k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
        cache_k[:, :, pos:pos + sq] = k_new.transpose(1, 2)
        cache_v[:, :, pos:pos + sq] = v_new.transpose(1, 2)
        valid = kv_pos <= pos
    else:
        valid = kv_pos < (cross_len if cross_len is not None else s_max)

    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh).to(cache_k.dtype)
    s = torch.einsum("bqhgd,bhsd->bhgqs", qg.float(), cache_k.float()) \
        * scale
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bhsd->bqhgd", w.to(cache_v.dtype).float(),
                     cache_v.float())
    o = o.reshape(b, sq, hq * dh).to(x.dtype)
    return o @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (per-token-per-head scales over Dh)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S, Dh) -> (int8 values, (..., S) bf16 scales).  Rounds half
    to even, as the reference does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def attention_decode_q8(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        pos: int, cache_k, cache_v, k_scale, v_scale,
                        use_rope: bool = True):
    """attention_decode against an int8 cache: the new token is quantized
    and written in place, then the cache is dequantized for the dots."""
    cdt = cdtype(cfg)
    b, sq, _ = x.shape
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    s_max = cache_k.shape[2]
    _check_pos(pos, sq, s_max)
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, sq, hq, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q_pos = torch.full((sq,), pos, dtype=torch.int32, device=x.device)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)

    k_new = x @ p["wk"]
    v_new = x @ p["wv"]
    if cfg.qkv_bias:
        k_new, v_new = k_new + p["bk"], v_new + p["bv"]
    k_new = k_new.reshape(b, sq, hkv, dh)
    v_new = v_new.reshape(b, sq, hkv, dh)
    if cfg.qk_norm:
        k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    if use_rope:
        k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
    kq, ks = quantize_kv(k_new.transpose(1, 2))            # (B,Hkv,1,Dh)
    vq, vs = quantize_kv(v_new.transpose(1, 2))
    cache_k[:, :, pos:pos + sq] = kq
    cache_v[:, :, pos:pos + sq] = vq
    k_scale[:, :, pos:pos + sq] = ks
    v_scale[:, :, pos:pos + sq] = vs

    kv_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    valid = kv_pos <= pos
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh).to(cdt)
    kf = dequantize_kv(cache_k, k_scale, cdt)
    s = torch.einsum("bqhgd,bhsd->bhgqs", qg.float(), kf.float()) * scale
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    vf = dequantize_kv(cache_v, v_scale, cdt)
    o = torch.einsum("bhgqs,bhsd->bqhgd", w.to(cdt).float(), vf.float())
    o = o.reshape(b, sq, hq * dh).to(x.dtype)
    return o @ p["wo"], cache_k, cache_v, k_scale, v_scale


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

_GATED = ("swiglu", "geglu")


def ffn_init(init: Init, cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> Params:
    d = cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dt = pdtype(cfg)
    p: Params = {
        "w_up": dense_init(init, d, d_ff, dt),
        "w_down": dense_init(init, d_ff, d, dt),
    }
    if cfg.activation in _GATED:
        p["w_gate"] = dense_init(init, d, d_ff, dt)
    return p


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(h)
    if activation in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    if activation == "squared_relu":
        r = F.relu(h)
        return r * r
    raise ValueError(activation)


def ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation in _GATED:
        h = _act(x @ p["w_gate"], cfg.activation) * (x @ p["w_up"])
    else:
        h = _act(x @ p["w_up"], cfg.activation)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# embedding / logits / loss
# ---------------------------------------------------------------------------


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sinusoid_at(pos: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding of one position. -> (d,)"""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    angle = torch.tensor(float(pos), dtype=torch.float32, device=device) \
        / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def logits_from_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor
                       ) -> torch.Tensor:
    """(B,S,d) -> (B,S,V) f32 logits, the products accumulated in f32."""
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", h.float(), params["embed"].float())
    else:
        out = torch.einsum("bsd,dv->bsv", h.float(),
                           params["unembed"].float())
    return constrain(out, "batch", None, "model")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V); labels (B,S) int -> mean next-token NLL (over the
    mask's ones when a mask is given)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
