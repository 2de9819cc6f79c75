"""The port's model families (``repro_torch.models``) against the
reference's on the CPU, at smoke width in float32: the reference's
``api.init`` parameters carried across with ``api.from_numpy``, the same
batch from a numpy seed, then ``forward`` (logits and aux), ``loss``,
``prefill`` (last-position logits and every cache leaf) and two
``decode`` steps (logits and every cache leaf), each within
rtol = atol = 1e-4.  Also the int8 KV cache, one bf16 case, and the
config registry's values."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as RB
from repro.models import api as RA
from repro_torch.configs import base as TB
from repro_torch.configs.base import ARCH_IDS, SHAPES, all_configs, \
    cell_is_runnable, get_config, smoke_config
from repro_torch.models import api as TA
from repro_torch.models import smoke

TOL = 1e-4          # float32: both sides do the same f32 math in other orders
# bfloat16 keeps 8 significant bits (a step of 2^-8 at 1.0): the two
# packages round the activations at the same points, but the f32 sums
# under each rounding run in other orders, so a value can land one bf16
# step apart and carry that through the next layer.
BF16_TOL = 3e-2
B, S, MAX_LEN = smoke.BATCH, smoke.SEQ, smoke.MAX_LEN
PROMPT = S - 2      # prefill takes S - 2 tokens; two decode steps follow
LOGITS = ("forward", "prefill", "decode0", "decode1")


def leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def to_np(x) -> np.ndarray:
    """A jax array or a tensor as a float64 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy() if x.dtype in (torch.int8, torch.int32,
                                        torch.int64) else x.double().numpy()
    a = np.asarray(x)
    return a if a.dtype.kind in "iu" else a.astype(np.float64)


def reference(cfg, params, batch, decode=True):
    """What ``smoke.pass_outputs`` computes, through the reference in one
    jit, under the same flat names: the forward, the loss, a prefill of
    the first PROMPT tokens and two decode steps, each cache leaf as
    ``prefill.<leaf>`` / ``decode<i>.<leaf>``."""
    def run(p, b):
        out = {}
        out["forward"], out["aux"] = RA.forward(p, cfg, b)
        out["loss"], _ = RA.loss(p, cfg, b)
        out["prefill"], cache = RA.prefill(
            p, cfg, dict(b, tokens=b["tokens"][:, :PROMPT]), MAX_LEN)
        out.update(leaves(cache, "prefill."))
        for step in range(2 if decode else 0):
            pos = PROMPT + step
            out[f"decode{step}"], cache = RA.decode(
                p, cfg, cache, b["tokens"][:, pos:pos + 1], jnp.int32(pos))
            out.update(leaves(cache, f"decode{step}."))
        return out

    out = jax.jit(run)(params, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
    return {k: to_np(v) for k, v in out.items()}


def carried(cfg, decode=True):
    """(reference outputs, port outputs, reference params) for ``cfg`` on
    ``smoke.batch``, the reference's parameters carried across."""
    rparams = RA.init(jax.random.PRNGKey(0), cfg)
    tparams = TA.from_numpy(rparams, cfg, device="cpu")
    batch = smoke.batch(cfg, 0, "cpu")
    got = {k: to_np(v)
           for k, v in smoke.pass_outputs(tparams, cfg, batch).items()}
    return reference(cfg, rparams, batch, decode), got, rparams


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_run(request):
    cfg = smoke_config(request.param)
    ref, got, rparams = carried(cfg)
    return cfg, ref, got, rparams


def assert_close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def assert_leaves_close(got, ref, prefix, tol):
    """Every cache leaf under ``prefix``: the same names, int8 leaves
    equal, the rest within ``tol``."""
    names = sorted(k for k in ref if k.startswith(prefix))
    assert names and names == sorted(k for k in got
                                     if k.startswith(prefix))
    for k in names:
        if ref[k].dtype == np.int8:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert_close(got[k], ref[k], tol, k)


def test_forward_and_aux_match_reference(arch_run):
    cfg, ref, got, _ = arch_run
    assert got["forward"].shape == (B, S, cfg.vocab_size)
    assert np.isfinite(got["forward"]).all()
    assert_close(got["forward"], ref["forward"], TOL, "forward")
    assert_close(got["aux"], ref["aux"], TOL, "aux")


def test_loss_matches_reference(arch_run):
    _, ref, got, _ = arch_run
    assert np.isfinite(got["loss"])
    assert_close(got["loss"], ref["loss"], TOL, "loss")


def test_prefill_logits_and_cache_match_reference(arch_run):
    cfg, ref, got, _ = arch_run
    assert got["prefill"].shape == (B, 1, cfg.vocab_size)
    assert_close(got["prefill"], ref["prefill"], TOL, "prefill")
    assert_leaves_close(got, ref, "prefill.", TOL)


def test_two_decode_steps_match_reference(arch_run):
    _, ref, got, _ = arch_run
    for step in range(2):
        assert_close(got[f"decode{step}"], ref[f"decode{step}"], TOL,
                     f"decode {step}")
        assert_leaves_close(got, ref, f"decode{step}.", TOL)


def test_decode_continues_forward(arch_run):
    """The port alone: prefill, then a decode step, give the forward's
    logits at those positions."""
    _, _, got, _ = arch_run
    np.testing.assert_allclose(got["prefill"][:, 0],
                               got["forward"][:, PROMPT - 1],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["decode0"][:, 0],
                               got["forward"][:, PROMPT],
                               rtol=2e-3, atol=2e-3)


def test_param_tree_and_abstract_shapes_match_reference(arch_run):
    """``abstract_params`` (meta tensors) has the reference's keys, shapes
    and dtypes; so does ``abstract_cache``, and ``init`` draws that tree."""
    cfg, _, _, rparams = arch_run
    meta = dict(leaves(TA.abstract_params(cfg)))
    ref = dict(leaves(rparams))
    assert sorted(meta) == sorted(ref)
    for k, v in ref.items():
        assert tuple(meta[k].shape) == tuple(v.shape), k
        assert meta[k].device.type == "meta"
        assert str(meta[k].dtype).replace("torch.", "") == str(v.dtype), k
    drawn = dict(leaves(TA.init(cfg, torch.Generator().manual_seed(1),
                                device="cpu")))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == \
        {k: tuple(v.shape) for k, v in meta.items()}
    rcache = jax.eval_shape(lambda: RA.init_cache(cfg, B, MAX_LEN))
    tcache = dict(leaves(TA.abstract_cache(cfg, B, MAX_LEN)))
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in leaves(rcache)}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
def test_int8_kv_cache_matches_reference(arch):
    """``kv_cache_dtype="int8"``: the dense arch's int8 cache is equal to
    the reference's and its bf16 scales and logits within 1e-4; the
    hybrid keeps its attention cache in the compute dtype in both."""
    cfg = smoke_config(arch).replace(kv_cache_dtype="int8")
    ref, got, _ = carried(cfg)
    for prefix in ("prefill.", "decode0.", "decode1."):
        assert_leaves_close(got, ref, prefix, TOL)
    int8_leaves = [k for k, v in got.items() if v.dtype == np.int8]
    assert int8_leaves == ([] if cfg.family == "hybrid" else
                           [f"{p}.{x}" for p in ("prefill", "decode0",
                                                 "decode1")
                            for x in ("k", "v")])
    for key in LOGITS:
        assert_close(got[key], ref[key], TOL, key)


def test_bf16_matches_reference():
    """qwen2-0.5b's smoke config in bfloat16: forward, loss and prefill
    (logits and the bf16 cache) within BF16_TOL of the reference.  The
    reference's bf16 decode step does not run on the CPU (XLA's CPU dot
    refuses bf16 x bf16 -> f32 there), so the port's two bf16 decode
    steps are held to the port's own bf16 forward at those positions."""
    cfg = smoke_config("qwen2-0.5b").replace(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    ref, got, rparams = carried(cfg, decode=False)
    assert np.asarray(rparams["embed"]).dtype.name == "bfloat16"
    for key in ("forward", "loss", "prefill"):
        assert_close(got[key], ref[key], BF16_TOL, key)
    assert_leaves_close(got, ref, "prefill.", BF16_TOL)
    for step in range(2):
        assert_close(got[f"decode{step}"][:, 0],
                     got["forward"][:, PROMPT + step], BF16_TOL,
                     f"bf16 decode {step}")


def test_all_configs_registered_exactly():
    cfgs = all_configs()
    assert set(cfgs) == set(ARCH_IDS)
    assert ARCH_IDS == RB.ARCH_IDS
    c = cfgs["nemotron-4-340b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size) == (96, 18432, 96, 8, 73728, 256000)
    c = cfgs["qwen3-moe-30b-a3b"]
    assert (c.n_experts, c.moe_top_k, c.moe_d_ff) == (128, 8, 768)
    c = cfgs["mamba2-2.7b"]
    assert (c.n_layers, c.d_model, c.ssm_state) == (64, 2560, 128)
    c = cfgs["zamba2-1.2b"]
    assert c.attn_every == 6 and c.shared_attn
    c = cfgs["qwen2-0.5b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.vocab_size) == (24, 896, 14, 2, 151936)
    # 40 cells: 32 runnable + 8 long_500k skips for full-attention archs
    runnable = sum(cell_is_runnable(cfgs[a], sh)[0]
                   for a in ARCH_IDS for sh in SHAPES.values())
    assert runnable == 32
    assert sorted(SHAPES) == sorted(RB.SHAPES)
    for name, shape in SHAPES.items():
        assert vars(shape) == vars(RB.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_param_counts_match_reference(arch):
    """Every field of the full and the smoke config, ``param_count`` (all
    and active) and ``cell_is_runnable`` equal the reference's."""
    for mine, theirs in ((get_config(arch), RB.get_config(arch)),
                         (smoke_config(arch), RB.smoke_config(arch))):
        assert vars(mine) == vars(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.param_count(active_only=True) == \
            theirs.param_count(active_only=True)
        for name in SHAPES:
            assert cell_is_runnable(mine, SHAPES[name]) == \
                RB.cell_is_runnable(theirs, RB.SHAPES[name])
    assert type(get_config(arch)) is TB.ModelConfig


def test_param_counts_are_plausible():
    """Analytic N vs the arch's nameplate size (within 40%); qwen2-0.5b
    is 494.0 M parameters."""
    expect = {
        "nemotron-4-340b": 340e9, "mistral-nemo-12b": 12e9,
        "qwen2-0.5b": 0.5e9, "qwen2.5-3b": 3e9, "mamba2-2.7b": 2.7e9,
        "deepseek-moe-16b": 16e9, "qwen3-moe-30b-a3b": 30e9,
        "zamba2-1.2b": 1.2e9, "paligemma-3b": 3e9,
    }
    for arch, n in expect.items():
        got = get_config(arch).param_count()
        assert 0.6 * n < got < 1.6 * n, (arch, got, n)
    assert get_config("qwen2-0.5b").param_count() == 494_004_224


def test_moe_capacity_drop_matches_reference():
    """At capacity factor 0.25 overflowed slots are dropped: the logits
    are finite, equal the reference's within 1e-4, and differ from the
    no-drop smoke config's."""
    drop = smoke_config("qwen3-moe-30b-a3b").replace(moe_capacity_factor=0.25)
    ref, got, rparams = carried(drop, decode=False)
    assert np.isfinite(got["forward"]).all()
    assert_close(got["forward"], ref["forward"], TOL, "forward")
    assert_close(got["aux"], ref["aux"], TOL, "aux")
    full = smoke_config("qwen3-moe-30b-a3b")
    no_drop, _ = TA.forward(TA.from_numpy(rparams, full, "cpu"), full,
                            smoke.batch(full, 0, "cpu"))
    assert np.abs(to_np(no_drop) - got["forward"]).max() > 1e-3


def test_from_numpy_refuses_a_tree_of_another_config():
    cfg = smoke_config("qwen2-0.5b")
    tree = {k: np.asarray(v) for k, v in RA.init(jax.random.PRNGKey(0),
                                                 cfg).items()
            if not isinstance(v, dict)}
    with pytest.raises(ValueError, match="keys"):
        TA.from_numpy(tree, cfg, "cpu")
    other = RA.init(jax.random.PRNGKey(0), cfg.replace(d_ff=64))
    with pytest.raises(ValueError, match="shape"):
        TA.from_numpy(other, cfg, "cpu")
