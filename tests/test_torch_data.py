"""The port's token pipeline, watchdog and gradient compression on the
CPU: the pipeline's determinism and sharding; ``assemble`` on the
reference's own ``jax.random`` draws (recomputed here) gives the
reference's ``batch_at`` tokens and frontend inputs bit for bit, with
every doc kept, some, and none; ``quantize`` bit for bit, error
feedback; and ``compressed_psum_stacked`` / ``bf16_psum_stacked`` over 8
logical participants against the reference's 8-device ``shard_map`` run
in a subprocess."""
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.distributed import compression as RC
from repro_torch.configs.base import smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed import compression as TC
from repro_torch.train.watchdog import StepWatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_data_pipeline_deterministic_and_sharded():
    cfg = smoke_config("qwen2-0.5b")
    p0 = TokenPipeline(cfg, DataConfig(batch=4, seq=16), shard=0, n_shards=2)
    p1 = TokenPipeline(cfg, DataConfig(batch=4, seq=16), shard=1, n_shards=2)
    a = p0.batch_at(7, "cpu")["tokens"]
    b = p0.batch_at(7, "cpu")["tokens"]
    c = p1.batch_at(7, "cpu")["tokens"]
    d = p0.batch_at(8, "cpu")["tokens"]
    assert a.shape == (4, 16) and a.dtype == torch.int32
    assert torch.equal(a, b)                          # deterministic
    assert not torch.equal(a, c)                      # sharded
    assert not torch.equal(a, d)                      # a stream per step
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def reference_draws(pipe: RefPipeline, step: int):
    """The reference's ``batch_at`` draws, recomputed from its keys."""
    d, cfg = pipe.data, pipe.cfg
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(d.seed), step), pipe.shard)
    pool = d.batch * d.pool_factor
    docs = jax.random.randint(key, (pool, d.seq), 0, cfg.vocab_size,
                              jnp.int32)
    scores = jax.random.uniform(jax.random.fold_in(key, 1), (pool,))
    return np.asarray(docs), np.asarray(scores)


@pytest.mark.parametrize("band", [(0.2, 1.0), (0.0, 1.0), (0.8, 1.0),
                                  (2.0, 3.0)],
                         ids=["default", "all", "few", "none"])
@pytest.mark.parametrize("step", [0, 5])
def test_assemble_gives_the_reference_tokens_on_its_draws(band, step):
    """The filter and the wrap, bit for bit: with the band (2, 3) no doc
    passes (count 0: every row is doc 0); with (0.8, 1) fewer docs than
    rows pass, so the survivors repeat."""
    lo, hi = band
    cfg = ref_smoke_config("qwen2-0.5b")
    ref = RefPipeline(cfg, RefDataConfig(batch=8, seq=16, quality_lo=lo,
                                         quality_hi=hi))
    docs, scores = reference_draws(ref, step)
    kept = int(((scores >= lo) & (scores <= hi)).sum())
    assert (kept == 0) == (band == (2.0, 3.0))
    if band == (0.8, 1.0):
        assert 0 < kept < 8
    port = TokenPipeline(smoke_config("qwen2-0.5b"), DataConfig(
        batch=8, seq=16, quality_lo=lo, quality_hi=hi))
    got = port.assemble(docs, scores, {}, "cpu")
    want = np.asarray(ref.batch_at(step)["tokens"])
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("arch,key,k", [("paligemma-3b", "patch_embeds", 2),
                                        ("whisper-medium", "frames", 3)])
def test_frontend_extras(arch, key, k):
    """The vlm's patch embeddings and the audio model's frames: on the
    reference's draws, its values; from the port's own draws, the shape
    and the compute dtype, and a stream of their own."""
    cfg = ref_smoke_config(arch)
    ref = RefPipeline(cfg, RefDataConfig(batch=4, seq=16))
    want = ref.batch_at(3)
    rkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 3), 0)
    shape = want[key].shape
    extra = np.asarray(jax.random.normal(jax.random.fold_in(rkey, k), shape,
                                         jnp.float32))
    port = TokenPipeline(smoke_config(arch), DataConfig(batch=4, seq=16))
    got = port.assemble(*reference_draws(ref, 3), {key: extra}, "cpu")
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    own = port.batch_at(3, "cpu")
    assert own[key].shape == shape and own[key].dtype == torch.float32
    assert not torch.equal(own[key], port.batch_at(4, "cpu")[key])
    half = TokenPipeline(smoke_config(arch).replace(
        compute_dtype="bfloat16"), DataConfig(batch=4, seq=16))
    assert half.batch_at(3, "cpu")[key].dtype == torch.bfloat16


def test_watchdog_flags_stragglers():
    dog = StepWatchdog(trip_factor=5.0, warmup_steps=3)
    for i in range(8):
        dog.start()
        time.sleep(0.002 if i != 6 else 0.05)
        dog.stop(i)
    assert 6 in dog.straggler_steps
    assert 0 < dog.p50 < 0.05


def test_quantize_matches_reference_bits():
    rng = np.random.default_rng(1)
    for shape, scale in (((1000,), 1.0), ((8, 33), 1e-3), ((5,), 1e3)):
        g = (scale * rng.standard_normal(shape)).astype(np.float32)
        err = (0.01 * scale * rng.standard_normal(shape)).astype(np.float32)
        q, s, e = TC.quantize(torch.from_numpy(g), torch.from_numpy(err))
        rq, rs, re = RC.quantize(jnp.asarray(g), jnp.asarray(err))
        assert q.dtype == torch.int8 and s.ndim == 0
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(e.numpy(), np.asarray(re))
        np.testing.assert_array_equal(
            TC.dequantize(q, s).numpy(), np.asarray(RC.dequantize(rq, rs)))


def test_quantize_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s, _ = TC.quantize(g, torch.zeros_like(g))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_int8_compression_error_feedback():
    """Error feedback keeps the accumulated quantization error bounded:
    the running sum of compressed grads tracks the true sum."""
    rng = np.random.default_rng(0)
    g_stream = [rng.normal(size=(256,)).astype(np.float32)
                for _ in range(50)]
    err = TC.init_error_state({"g": torch.zeros(256)})["g"]
    acc_q = np.zeros(256, np.float64)
    acc_t = np.zeros(256, np.float64)
    for g in g_stream:
        q, scale, err = TC.quantize(torch.from_numpy(g), err)
        acc_q += TC.dequantize(q, scale).double().numpy()
        acc_t += g
    gap = np.abs(acc_q - acc_t).max()
    one_step = max(np.abs(g).max() for g in g_stream) / 127
    assert gap < 3 * one_step, (gap, one_step)


REFERENCE_PSUM = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed import compression as C

    g = np.load(sys.argv[1] + "/g.npy")
    err = np.load(sys.argv[1] + "/err.npy")
    mesh = jax.make_mesh((8,), ("data",))

    def f(g, err):
        out, new_err = C.compressed_psum(g[0], err[0], "data")
        return out, new_err[None], C.bf16_psum(g[0], "data")

    with jax.sharding.set_mesh(mesh):
        out, new_err, b16 = jax.jit(jax.shard_map(
            f, in_specs=(P("data", None), P("data", None)),
            out_specs=(P(), P("data", None), P())))(
                jnp.asarray(g), jnp.asarray(err))
    np.save(sys.argv[1] + "/out.npy", np.asarray(out))
    np.save(sys.argv[1] + "/new_err.npy", np.asarray(new_err))
    np.save(sys.argv[1] + "/b16.npy", np.asarray(b16))
    print("REFERENCE_PSUM_OK")
"""


def test_compressed_psum_matches_reference_shard_map(tmp_path):
    """8 logical participants on a leading axis against the reference's
    8 host devices: the reduced value's bits and the bf16 all-reduce's.
    The residuals agree to the last bits of the scale: under ``jit`` XLA
    computes the reference's ``max / 127`` as ``max * (1 / 127)`` and
    ``g' - q * s`` as one fused multiply-add, where its eager
    ``quantize`` (held bit for bit above) and the port do neither; q is
    the same, so a residual moves by at most 127 units in the last
    place of its scale (under 1e-6 here)."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 1024)).astype(np.float32)
    err = (0.01 * rng.standard_normal((8, 1024))).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    np.save(tmp_path / "err.npy", err)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_PSUM),
         str(tmp_path)], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert "REFERENCE_PSUM_OK" in res.stdout, res.stderr[-3000:]
    out, new_err = TC.compressed_psum_stacked(torch.from_numpy(g),
                                              torch.from_numpy(err))
    assert out.shape == (1024,) and new_err.shape == (8, 1024)
    np.testing.assert_allclose(new_err.numpy(),
                               np.load(tmp_path / "new_err.npy"),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.numpy(), np.load(tmp_path / "out.npy"))
    np.testing.assert_array_equal(
        TC.bf16_psum_stacked(torch.from_numpy(g)).numpy(),
        np.load(tmp_path / "b16.npy"))
    exact = g.mean(axis=0)
    assert np.abs(out.numpy() - exact).max() / np.abs(exact).max() < 0.15
