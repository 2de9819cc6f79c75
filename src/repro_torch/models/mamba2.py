"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Prefill uses the chunked SSD algorithm: intra-chunk attention-like matmuls
plus an inter-chunk state recurrence (a loop over the chunks).  Decode is
the O(1)-state recurrent update.

The fused [z|x|B|C|dt] input projection is split into separate
projections (the same math: the depthwise conv is per channel, so
conv(x|B|C) == conv(x)|conv(B)|conv(C)), as in the reference.

Layout: d_inner = expand * d_model, H = d_inner / head_dim SSD heads of
dim P, state size N per head, G B/C groups.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Init, Params, dense_init, dtype_of,
                                       rms_norm)


def mamba2_init(init: Init, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g, w = cfg.ssm_groups, cfg.ssm_conv_width
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    return {
        "z_proj": dense_init(init, d, di, dt),
        "x_proj": dense_init(init, d, di, dt),
        "b_proj": dense_init(init, d, g * n, dt),
        "c_proj": dense_init(init, d, g * n, dt),
        "dt_proj": dense_init(init, d, h, dt),
        "conv_x": init.normal((w, di), 0.1, dt),
        "conv_x_b": init.full((di,), 0.0, dt),
        "conv_bc": init.normal((w, 2 * g * n), 0.1, dt),
        "conv_bc_b": init.full((2 * g * n,), 0.0, dt),
        "A_log": init.row(torch.log(torch.linspace(1.0, 16.0, h))),
        "dt_bias": init.full((h,), 0.0, f32),
        "D": init.full((h,), 1.0, f32),
        "norm": init.full((di,), 1.0, dt),
        "out_proj": dense_init(init, di, d, dt),
    }


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU.  xc: (B,S,C); w: (W,C).  Unrolled
    f32 adds (no cuDNN convolution, whose TF32 would move the card's
    result away from the host's)."""
    width = w.shape[0]
    s = xc.shape[1]
    xp = F.pad(xc, (0, 0, width - 1, 0))
    out = torch.zeros(xc.shape, dtype=torch.float32, device=xc.device)
    for i in range(width):
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xc.dtype)


def _conv_decode(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """window: (B,W,C), the last W inputs with the current one -> (B,C)."""
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(out + b.float())


def _ssd_chunked(cfg: ModelConfig, xh, dtv, bmat, cmat, a_log):
    """Chunked SSD scan.

    xh:   (B,S,H,P) inputs per head
    dtv:  (B,S,H)   softplus'd timestep
    bmat: (B,S,G,N) input projection  (G broadcast onto H)
    cmat: (B,S,G,N) output projection
    returns y (B,S,H,P), final_state (B,H,N,P)
    """
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // q
    heads_per_group = h // g

    def expand(m):  # (B,Sp,G,N) -> (B,nc,Q,H,N)
        m = torch.repeat_interleave(m, heads_per_group, dim=2)
        return m.reshape(b, nc, q, h, n)

    xc = xh.reshape(b, nc, q, h, p).float()
    dtc = dtv.reshape(b, nc, q, h).float()
    bc = expand(bmat).float()
    cc = expand(cmat).float()

    a = -torch.exp(a_log)                   # (H,) negative
    da = dtc * a[None, None, None, :]       # (B,nc,Q,H) log-decay per step
    cum = torch.cumsum(da, dim=2)           # inclusive
    cum_last = cum[:, :, -1:, :]            # (B,nc,1,H)

    # intra-chunk: decay(i,j) = exp(cum[i] - cum[j]) for i >= j, else 0.
    # Mask before the exp: for i < j the difference is positive and the
    # exp would overflow.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    seg = torch.exp(torch.where(mask[None, None, :, :, None], diff, -1e30))
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * seg
    scores = scores * dtc[:, :, None, :, :]                # weight by dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk states
    w_in = torch.exp(cum_last - cum) * dtc                 # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", bc * w_in[..., None], xc)
    chunk_decay = torch.exp(cum_last[:, :, 0, :])          # (B,nc,H)

    # inter-chunk recurrence over the nc chunks
    h_state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, c, :, None, None] \
            + chunk_state[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           cc * torch.exp(cum)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, h_state


def _tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """Last (width-1) timesteps of (B,S,C), left-padded if S < width-1."""
    s = x.shape[1]
    if s >= width - 1:
        return x[:, s - (width - 1):, :]
    return F.pad(x, (0, 0, width - 1 - s, 0))


def mamba2_block(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence block.  x: (B,S,d) -> (y, state dict for decode)."""
    b, s, _ = x.shape
    di, n, h, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    ph = cfg.ssm_head_dim
    z = x @ p["z_proj"]
    x_in = x @ p["x_proj"]
    bc_in = torch.cat([x @ p["b_proj"], x @ p["c_proj"]], dim=-1)
    dt_raw = x @ p["dt_proj"]

    xh_full = _causal_conv(x_in, p["conv_x"], p["conv_x_b"])
    bc = _causal_conv(bc_in, p["conv_bc"], p["conv_bc_b"])
    xh = xh_full.reshape(b, s, h, ph)
    bmat = bc[..., :g * n].reshape(b, s, g, n)
    cmat = bc[..., g * n:].reshape(b, s, g, n)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])

    y, h_final = _ssd_chunked(cfg, xh, dtv, bmat, cmat, p["A_log"])
    y = y + xh.float().reshape(b, s, h, ph) * p["D"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    state = {
        "ssm": h_final,                                    # (B,H,N,P) fp32
        "conv_x": _tail(x_in, cfg.ssm_conv_width),         # (B,W-1,di)
        "conv_bc": _tail(bc_in, cfg.ssm_conv_width),       # (B,W-1,2GN)
    }
    return out, state


def mamba2_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  state: Dict[str, torch.Tensor]):
    """One-token step.  x: (B,1,d); state: {ssm (B,H,N,P),
    conv_x (B,W-1,di), conv_bc (B,W-1,2GN)} -> (y, new state)."""
    b = x.shape[0]
    di, n, h, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    ph = cfg.ssm_head_dim
    z = x @ p["z_proj"]                                    # (B,1,di)
    x_in = x @ p["x_proj"]
    bc_in = torch.cat([x @ p["b_proj"], x @ p["c_proj"]], dim=-1)
    dt_raw = x @ p["dt_proj"]

    win_x = torch.cat([state["conv_x"], x_in], dim=1)      # (B,W,di)
    win_bc = torch.cat([state["conv_bc"], bc_in], dim=1)
    xh = _conv_decode(win_x, p["conv_x"], p["conv_x_b"]).reshape(b, h, ph)
    bcv = _conv_decode(win_bc, p["conv_bc"], p["conv_bc_b"])
    bvec = bcv[:, :g * n].reshape(b, g, n)
    cvec = bcv[:, g * n:].reshape(b, g, n)
    hpg = h // g
    bvec = torch.repeat_interleave(bvec, hpg, dim=1)       # (B,H,N)
    cvec = torch.repeat_interleave(cvec, hpg, dim=1)
    dtv = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * a)                             # (B,H)
    upd = torch.einsum("bhn,bhp->bhnp", bvec, xh * dtv[..., None])
    ssm_new = state["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", cvec, ssm_new)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    new_state = {"ssm": ssm_new, "conv_x": win_x[:, 1:, :],
                 "conv_bc": win_bc[:, 1:, :]}
    return y @ p["out_proj"], new_state
