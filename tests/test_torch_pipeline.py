"""The port's GPipe (``repro_torch.distributed.pipeline``) on a world of 4
CPU gloo ranks, one stage a rank, held to the reference's
``pipeline_apply`` and to the serial network.

Inputs: the reference test's network (``tests/test_pipeline.py``: S = 4
stages of ``h + tanh(h @ w + b)``, w scaled 0.3, b 0.1), drawn with numpy
from a seed (``ranks.pipe_inputs``), at the reference test's shapes (F =
8 microbatches of 2 rows of width 16) and with fewer microbatches than
stages (F = 2).  The reference runs in a subprocess that sees 4 forced
host devices: its ``pipeline_apply`` under ``jax.sharding.set_mesh`` on
a ``("pipe",)`` mesh, and ``jax.value_and_grad`` of ``mean((y -
tgt[None]) ** 2)`` over its (S, F, mb, D) output (every stage's copy, so
the mean is one copy's).  Its ``make_pipelined_loss`` slices that output
with ``y[0]``, which jax 0.9 refuses on a pipe-sharded dim, so the slice
is taken outside (``np.asarray(y)[0]``).

The port: ``make_pipelined_loss`` on every rank, ``backward`` on every
rank, each rank's gradients those of its own stage.  Tolerances: the
reference test's (loss rtol 1e-5; outputs and grads rtol 1e-4, atol
1e-6).  A gradient counted on every rank would be S = 4 times the
serial one.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import pipeline as PL
from repro_torch.distributed import ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"reference_shapes": {"S": 4, "F": 8, "MB": 2, "D": 16, "seed": 0},
         "fewer_microbatches": {"S": 4, "F": 2, "MB": 3, "D": 8, "seed": 1}}

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
out = {}
for name in sys.argv[3:]:
    with np.load(sys.argv[2] + "/" + name + ".npz") as f:
        params = {"w": jnp.asarray(f["w"]), "b": jnp.asarray(f["b"])}
        x, tgt = jnp.asarray(f["x"]), jnp.asarray(f["tgt"])
    S = params["w"].shape[0]

    def stage_fn(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def loss(params, x, tgt):
        y = pipeline_apply(stage_fn, params, x, S)(params, x)
        return jnp.mean((y - tgt[None]) ** 2), y

    mesh = jax.make_mesh((S,), ("pipe",))
    with jax.sharding.set_mesh(mesh):
        (val, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, x, tgt)
    out[name + "|y"] = np.asarray(y)[0]
    out[name + "|loss"] = np.asarray(val)
    out[name + "|w"] = np.asarray(g["w"])
    out[name + "|b"] = np.asarray(g["b"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs, loss and grads for each case."""
    tmp = tmp_path_factory.mktemp("pipe")
    for name, case in CASES.items():
        params, x, tgt = ranks.pipe_inputs(case)
        np.savez(tmp / f"{name}.npz", x=x, tgt=tgt, **params)
    path = str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, path,
                             str(tmp), *CASES], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, path


@pytest.fixture(scope="module")
def port(reference):
    """Every rank's results for each case (the world runs while the
    reference's subprocess does)."""
    out = MESH.spawn(ranks.pipe_rank, 4, "gloo",
                     {"device": "cpu", "cases": list(CASES.values())},
                     device="cpu", timeout_s=300)
    return {name: [r["cases"][i] for r in out]
            for i, name in enumerate(CASES)}


@pytest.fixture(scope="module")
def ref_out(reference):
    proc, path = reference
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def stage_grads(rs):
    """The stacked grads, each stage's from its rank."""
    by_rank = {r["rank"]: r for r in rs}
    return {k: np.concatenate([by_rank[s]["grads"][k]
                               for s in range(len(rs))])
            for k in ("w", "b")}


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_serial(port, name):
    y, loss, grads = ranks.pipe_serial(CASES[name])
    rs = port[name]
    np.testing.assert_allclose(rs[0]["y"], y, rtol=1e-4, atol=1e-6)
    for r in rs:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
    got = stage_grads(rs)
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_reference_pipeline_apply(port, ref_out, name):
    rs = port[name]
    np.testing.assert_allclose(rs[0]["y"], ref_out[name + "|y"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(rs[0]["loss"], ref_out[name + "|loss"],
                               rtol=1e-5)
    got = stage_grads(rs)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], ref_out[name + "|" + k],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_outputs_and_calls_all_reduce_alone(port,
                                                                 name):
    rs = port[name]
    assert len({r["digest"] for r in rs}) == 1
    assert {r["rank"] for r in rs} == {0, 1, 2, 3}
    for r in rs:
        assert r["collectives"] == ["all_reduce"]


def test_bubble_fraction():
    assert abs(PL.bubble_fraction(8, 4) - 3 / 11) < 1e-12
    assert abs(PL.bubble_fraction(2, 4) - 3 / 5) < 1e-12
    assert PL.bubble_fraction(5, 1) == 0.0
    assert abs(PL.bubble_fraction(16, 4) - 3 / 19) < 1e-12
