"""The port's training path (``repro_torch.train``) against the
reference's on the CPU, at smoke width in float32: the reference's
``api.init`` parameters and ``init_opt_state`` carried across, the same
batch from a numpy seed, then the loss and every gradient leaf
(``jax.value_and_grad`` of ``api.loss``) and one jitted
``make_train_step`` (params, moments, step and metrics), each within
rtol = atol = 1e-4; AdamW on carried gradients, f32 and bf16 with its
master copy, clipped and not; and the schedule.  The step's loop
(microbatches, remat, bf16, the smoke step, loss reduction) is in
``test_torch_train_loop.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as RA
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch.configs.base import ARCH_IDS, smoke_config
from repro_torch.models import api as TA
from repro_torch.models import smoke
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

TOL = 1e-4          # float32: both sides do the same f32 math in other orders


def flat_np(tree) -> dict:
    """Every leaf of a nested dict of jax arrays or tensors as a float64
    (or int) numpy array keyed by its key path."""
    out = {}
    for path, v in TA.leaves(tree):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.numpy() if not v.is_floating_point() else \
                v.double().numpy()
        else:
            v = np.asarray(v)
            v = v if v.dtype.kind in "iu" else v.astype(np.float64)
        out[path] = v
    return out


def assert_trees_close(got, want, tol, what):
    got, want = flat_np(got), flat_np(want)
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {'/'.join(k)}")


def carry_state(ref_state, tparams):
    return TO.state_from_numpy(jax.tree.map(np.asarray, ref_state), tparams)


def jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


# the step both sides take: ``smoke.TRAIN_OPT``, whose rate moves every
# param leaf by 1e-3 to 1e-2, so that the params compared below see the
# update
REF_OPT = RO.AdamWConfig(**vars(smoke.TRAIN_OPT))


def reference_run(cfg, rparams, batch):
    """(loss, grads, params, opt state, metrics) of the reference: the
    value and gradient of ``api.loss``, then one train step, in one
    jit."""
    def run(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: RA.loss(q, cfg, b), has_aux=True)(p)
        p2, o2, m = RS.make_train_step(cfg, REF_OPT)(p, o, b)
        return loss, g, p2, o2, m

    return jax.jit(run)(rparams, RO.init_opt_state(rparams),
                        jax_batch(batch))


def port_run(cfg, rparams, batch):
    tparams = TA.from_numpy(rparams, cfg, device="cpu")
    loss, grads = TS.loss_and_grads(tparams, cfg, batch)
    opt = carry_state(RO.init_opt_state(rparams), tparams)
    p2, o2, m = TS.make_train_step(cfg, smoke.TRAIN_OPT)(tparams, opt,
                                                         batch)
    return loss, grads, p2, o2, m


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_train(request):
    cfg = smoke_config(request.param)
    rparams = RA.init(jax.random.PRNGKey(0), cfg)
    batch = smoke.batch(cfg, 0, "cpu")
    return (rparams, reference_run(cfg, rparams, batch),
            port_run(cfg, rparams, batch))


def test_loss_and_grads_match_reference(arch_train):
    _, (rloss, rgrads, *_), (tloss, tgrads, *_) = arch_train
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=TOL,
                               atol=TOL)
    assert_trees_close(tgrads, rgrads, TOL, "grad")


def test_train_step_matches_reference(arch_train):
    rparams, (_, _, rp, ro, rm), (_, _, tp, to, tm) = arch_train
    # every leaf moved far beyond the tolerance: a step that skipped a
    # write, or got v or a bias correction wrong, shows in the params
    start, moved = flat_np(rparams), flat_np(rp)
    assert min(np.abs(moved[k] - start[k]).max() for k in start) > 5 * TOL
    assert_trees_close(tp, rp, TOL, "params")
    assert sorted(to) == sorted(ro) == ["m", "step", "v"]
    assert_trees_close(to["m"], ro["m"], TOL, "m")
    assert_trees_close(to["v"], ro["v"], TOL, "v")
    # v is about 0.05 g^2, far under TOL: held again at TOL of its size
    for k, want in flat_np(ro["v"]).items():
        np.testing.assert_allclose(flat_np(to["v"])[k], want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg="/".join(k))
    assert to["step"].dtype == torch.int32
    assert int(to["step"]) == int(ro["step"]) == 1
    assert sorted(tm) == sorted(rm)
    for k in rm:
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def _random_tree(params, rng, scale):
    return {k: _random_tree(v, rng, scale) if isinstance(v, dict) else
            (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_reference(dtype, clip):
    """Three steps on carried gradients: params, master, moments, step
    and metrics.  The gradients' norm (about 16) is under a clip of 1e9
    and over 0.5.  bf16 params keep an f32 master copy on both sides; the
    param is its master rounded to bf16, so it may land one bf16 step
    apart where the masters differ in the last f32 bits."""
    cfg = smoke_config("qwen2-0.5b").replace(param_dtype=dtype)
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                   grad_clip=clip)
    rparams = RA.init(jax.random.PRNGKey(0), cfg)
    rstate = RO.init_opt_state(rparams)
    tparams = TA.from_numpy(rparams, cfg, device="cpu")
    tstate = carry_state(rstate, tparams)
    assert ("master" in tstate) == (dtype == "bfloat16") == \
        ("master" in rstate)
    rng = np.random.default_rng(5)
    update = jax.jit(lambda p, g, s: RO.adamw_update(
        RO.AdamWConfig(**opt_cfg), p, g, s))
    for _ in range(3):
        g = _random_tree(rparams, rng, 0.05)
        rparams, rstate, rm = update(
            rparams, jax.tree.map(
                lambda a, p: jnp.asarray(a, p.dtype), g, rparams), rstate)
        tg = TA.from_numpy(g, cfg, device="cpu")
        tparams, tstate, tm = TO.adamw_update(TO.AdamWConfig(**opt_cfg),
                                              tparams, tg, tstate)
    assert float(tm["grad_norm"]) > 10
    tol = TOL if dtype == "float32" else 2 ** -7
    assert_trees_close(tparams, rparams, tol, "params")
    for k in ("m", "v") + (("master",) if dtype == "bfloat16" else ()):
        assert_trees_close(tstate[k], rstate[k], TOL, k)
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    for k in rm:
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=TOL,
                                   atol=0, err_msg=k)


def test_lr_schedule_matches_reference():
    cfg = RO.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=1000)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        want = float(RO.lr_at(cfg, jnp.int32(step)))
        got = TO.lr_at(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=str(step))
