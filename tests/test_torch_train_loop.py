"""The port's train step beyond one step of the reference's: microbatched
accumulation against the reference's ``lax.scan`` (params, moments and
metrics within rtol = atol = 1e-4), the in-place update, remat on
against off, the bf16 step against its own f32 step, and the port's
counterparts of the reference's smoke train step
(``test_models.py::test_smoke_forward_and_train``) and loss-reduction
test (``test_system.py::test_training_reduces_loss``), on the CPU at
smoke width."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.models import api as RA
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch.configs.base import ARCH_IDS, smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import api as TA
from repro_torch.models import lm as TLM
from repro_torch.models import smoke
from repro_torch.train import optim as TO
from repro_torch.train import step as TS
from test_torch_train import (REF_OPT, TOL, assert_trees_close, carry_state,
                              flat_np, jax_batch)


def test_train_step_updates_in_place_and_leaves_no_graph():
    cfg = smoke_config("qwen2-0.5b")
    params = TA.init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.init_opt_state(params)
    wq = params["layers"]["attn"]["wq"]
    before = wq.clone()
    p2, o2, m = TS.make_train_step(cfg)(params, opt,
                                        smoke.batch(cfg, 0, "cpu"))
    assert p2 is params and o2 is opt
    assert p2["layers"]["attn"]["wq"] is wq and not torch.equal(wq, before)
    assert not any(t.requires_grad for _, t in TA.leaves(params))
    assert all(v.ndim == 0 and v.grad_fn is None for v in m.values())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_microbatched_step_matches_reference(arch):
    """Two microbatches of one row each: the reference's ``lax.scan``
    accumulation against the port's loop, f32 gradient sums."""
    cfg = smoke_config(arch).replace(train_microbatches=2)
    rparams = RA.init(jax.random.PRNGKey(0), cfg)
    batch = smoke.batch(cfg, 3, "cpu")
    step = jax.jit(RS.make_train_step(cfg, REF_OPT))
    rp, ro, rm = step(rparams, RO.init_opt_state(rparams), jax_batch(batch))
    start, moved = flat_np(rparams), flat_np(rp)
    assert min(np.abs(moved[k] - start[k]).max() for k in start) > 5 * TOL
    tparams = TA.from_numpy(rparams, cfg, device="cpu")
    # the loss of each row alone and of both in one pass, before the
    # step updates the params in place
    halves = [TS.loss_and_grads(tparams, cfg, {k: v[i:i + 1] for k, v in
                                               batch.items()})[0]
              for i in range(2)]
    one = TS.loss_and_grads(
        tparams, cfg.replace(train_microbatches=1), batch)[0]
    tp, to, tm = TS.make_train_step(cfg, smoke.TRAIN_OPT)(
        tparams, carry_state(RO.init_opt_state(rparams), tparams), batch)
    assert_trees_close(tp, rp, TOL, "params")
    assert_trees_close(to["m"], ro["m"], TOL, "m")
    assert_trees_close(to["v"], ro["v"], TOL, "v")
    for k in rm:
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the microbatched loss is the mean of the two rows' losses
    np.testing.assert_allclose(float(tm["loss"]),
                               float(sum(halves) / 2), rtol=1e-6)
    assert abs(float(tm["loss"]) - float(one)) < 1e-4


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_remat_on_and_off_give_the_same_loss_and_grads(arch, monkeypatch):
    """Each layer body under ``torch.utils.checkpoint`` recomputes the
    same ops, so the loss and gradients keep their bits; the checkpoint
    runs once a layer, and only while grad is enabled."""
    calls = []
    real = TLM.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TLM, "checkpoint", counted)
    cfg = smoke_config(arch)
    params = TA.init(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = smoke.batch(cfg, 1, "cpu")
    on = TS.loss_and_grads(params, cfg.replace(remat=True), batch)
    layers = cfg.n_layers + (cfg.n_encoder_layers
                             if cfg.family == "audio" else 0)
    assert len(calls) == layers
    off = TS.loss_and_grads(params, cfg.replace(remat=False), batch)
    with torch.no_grad():
        TA.forward(params, cfg.replace(remat=True), batch)
    assert len(calls) == layers
    assert torch.equal(on[0], off[0])
    for (path, a), (_, b) in zip(TA.leaves(on[1]), TA.leaves(off[1])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train(arch):
    """The counterpart of the reference's per-arch smoke test: one
    forward and one train step, finite, the params changed."""
    cfg = smoke_config(arch)
    params = TA.init(cfg, torch.Generator().manual_seed(0), "cpu")
    before = TA.tree_map(torch.clone, params)
    batch = smoke.batch(cfg, 2, "cpu")
    logits, aux = TA.forward(params, cfg, batch)
    assert logits.shape == (smoke.BATCH, smoke.SEQ, cfg.vocab_size)
    assert not torch.isnan(logits).any()
    _, _, m = TS.make_train_step(cfg)(params, TO.init_opt_state(params),
                                      batch)
    assert math.isfinite(float(m["loss"]))
    assert math.isfinite(float(m["grad_norm"]))
    delta = sum(float((a - b).abs().sum()) for (_, a), (_, b) in
                zip(TA.leaves(params), TA.leaves(before)))
    assert delta > 0


def test_training_reduces_loss():
    """The counterpart of the reference's test: a memorizable stream (one
    fixed batch from the pipeline), 40 steps at lr 1e-2."""
    cfg = smoke_config("qwen2-0.5b").replace(vocab_size=97)
    batch = TokenPipeline(cfg, DataConfig(batch=8, seq=32)).batch_at(
        0, "cpu")
    params = TA.init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.init_opt_state(params)
    step = TS.make_train_step(cfg, TO.AdamWConfig(
        lr=1e-2, warmup_steps=2, total_steps=60, weight_decay=0.0))
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_bf16_step_matches_its_f32_step():
    """The reference's bf16 backward does not run on this CPU (XLA's CPU
    dot refuses bf16 x bf16 -> f32, as in its bf16 decode), so the port's
    bf16 step (bf16 params with an f32 master copy) is held to its own
    f32 step from the same weights over three steps: the losses within
    bf16's rounding, the master copy moved as the f32 params moved (the
    updates over every leaf within 15 % in L2: Adam's normalised steps
    carry the bf16 forward's gradient noise at full size), and each bf16
    param its master rounded."""
    cfg32 = smoke_config("qwen2-0.5b")
    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    p16 = TA.init(cfg16, torch.Generator().manual_seed(0), "cpu")
    p32 = TA.tree_map(lambda t: t.to(torch.float32), p16)
    start = TA.tree_map(torch.clone, p32)
    batch = smoke.batch(cfg32, 4, "cpu")
    opt_cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1)
    o16, o32 = TO.init_opt_state(p16), TO.init_opt_state(p32)
    assert "master" in o16 and "master" not in o32
    for _ in range(3):
        p16, o16, m16 = TS.make_train_step(cfg16, opt_cfg)(p16, o16, batch)
        p32, o32, m32 = TS.make_train_step(cfg32, opt_cfg)(p32, o32, batch)
        assert abs(float(m16["loss"]) - float(m32["loss"])) < 1e-2
    assert float(m32["loss"]) < 5.5
    diff = norm = 0.0
    for (path, mast), (_, p), (_, s0) in zip(
            TA.leaves(o16["master"]), TA.leaves(p32), TA.leaves(start)):
        assert mast.dtype == torch.float32
        diff += float(((mast - s0) - (p - s0)).square().sum())
        norm += float((p - s0).square().sum())
    assert (diff / norm) ** 0.5 < 0.15
    for (path, p), (_, mast) in zip(TA.leaves(p16),
                                    TA.leaves(o16["master"])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, mast.to(torch.bfloat16)), path
