"""The port's nontrivial numerics, each as in ``test_numerics.py`` and
also held to the reference's function on the same inputs (numpy, from a
seed), on the CPU in float32:

* Mamba2 chunked SSD == the naive per-step recurrence
* Mamba2 decode steps continue the full-sequence block's state
* chunked online-softmax attention == direct attention
* RoPE: <rope(q,i), rope(k,j)> depends only on i - j
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro_torch.configs.base import smoke_config
from repro_torch.models import api as TA
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

REF_TOL = 1e-5      # the port's function against the reference's, f32


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_ssd_chunked_equals_naive_recurrence_and_reference():
    cfg = smoke_config("mamba2-2.7b").replace(ssm_chunk=8)
    b, s = 2, 37   # deliberately not a multiple of the chunk
    h, p, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    bmat = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cmat = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)

    y, state = M._ssd_chunked(cfg, t(xh), t(dtv), t(bmat), t(cmat),
                              t(a_log))

    # naive O(S) recurrence oracle, in float64
    a = -np.exp(a_log.astype(np.float64))
    hpg = h // g
    bexp = np.repeat(bmat, hpg, axis=2).astype(np.float64)
    cexp = np.repeat(cmat, hpg, axis=2).astype(np.float64)
    st = np.zeros((b, h, n, p))
    ys = []
    for step in range(s):
        decay = np.exp(dtv[:, step] * a)
        upd = np.einsum("bhn,bhp->bhnp", bexp[:, step],
                        xh[:, step] * dtv[:, step][..., None])
        st = st * decay[..., None, None] + upd
        ys.append(np.einsum("bhn,bhnp->bhp", cexp[:, step], st))
    close(y, np.stack(ys, axis=1), 2e-4)
    close(state, st, 2e-4)

    ry, rstate = jax.jit(lambda *a: RM._ssd_chunked(cfg, *a))(
        xh, dtv, bmat, cmat, a_log)
    close(y, ry, REF_TOL)
    close(state, rstate, REF_TOL)


def test_mamba2_decode_continues_prefill_state_and_matches_reference():
    """S steps of mamba2_decode == one mamba2_block over S tokens; both
    held to the reference's on the reference's parameters."""
    cfg = smoke_config("mamba2-2.7b").replace(ssm_chunk=8)
    rparams = RM.mamba2_init(jax.random.PRNGKey(0), cfg)
    params = {k: TA.tensor_from_numpy(v, "cpu") for k, v in rparams.items()}
    b, s = 2, 11
    x = (np.random.default_rng(1).standard_normal((b, s, cfg.d_model))
         * 0.5).astype(np.float32)
    y_full, state_full = M.mamba2_block(params, cfg, t(x))
    ry_full, rstate_full = jax.jit(
        lambda p, x: RM.mamba2_block(p, cfg, x))(rparams, x)
    close(y_full, ry_full, REF_TOL)
    for k in rstate_full:
        close(state_full[k], rstate_full[k], REF_TOL)

    w = cfg.ssm_conv_width
    shapes = {"ssm": (b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
              "conv_x": (b, w - 1, cfg.d_inner),
              "conv_bc": (b, w - 1, 2 * cfg.ssm_groups * cfg.ssm_state)}
    state = {k: torch.zeros(v) for k, v in shapes.items()}
    rstate = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    ref_decode = jax.jit(lambda p, x, st: RM.mamba2_decode(p, cfg, x, st))
    ys = []
    for step in range(s):
        y, state = M.mamba2_decode(params, cfg, t(x[:, step:step + 1]),
                                   state)
        ry, rstate = ref_decode(rparams, x[:, step:step + 1], rstate)
        close(y, ry, REF_TOL)
        ys.append(y)
    close(torch.cat(ys, dim=1), y_full.detach().numpy(), 3e-4)
    close(state["ssm"], state_full["ssm"].numpy(), 3e-4)
    for k in rstate:
        close(state[k], rstate[k], REF_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_equals_direct_and_reference(causal):
    b, s, hq, hkv, dh = 2, 50, 6, 2, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    pos = torch.arange(s, dtype=torch.int32)
    direct = L._direct_attention(t(q), t(k), t(v), pos, pos, causal)
    chunked = L._chunked_attention(t(q), t(k), t(v), pos, pos, causal,
                                   chunk=16)
    close(chunked, direct.numpy(), 2e-5)
    jpos = jnp.arange(s, dtype=jnp.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    close(direct, RL._direct_attention(jq, jk, jv, jpos, jpos, causal),
          REF_TOL)
    close(chunked, RL._chunked_attention(jq, jk, jv, jpos, jpos, causal,
                                         chunk=16), REF_TOL)


def test_rope_relative_property_and_reference():
    """RoPE: <rope(q,i), rope(k,j)> depends only on (i - j)."""
    dh = 32
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 1, 1, dh)).astype(np.float32)
    k = rng.standard_normal((1, 1, 1, dh)).astype(np.float32)

    def rope(x, i):
        return L.apply_rope(t(x), torch.tensor([i], dtype=torch.int32),
                            10_000.0)

    def dot_at(i, j):
        return float(torch.sum(rope(q, i) * rope(k, j)))

    assert abs(dot_at(5, 3) - dot_at(102, 100)) < 1e-4
    assert abs(dot_at(7, 7) - dot_at(0, 0)) < 1e-4
    for i in (0, 7, 102, 4095):
        close(rope(q, i), RL.apply_rope(jnp.asarray(q),
                                        jnp.array([i], jnp.int32),
                                        10_000.0), REF_TOL)
