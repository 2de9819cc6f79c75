"""The port's expert-parallel MoE on the CPU: ``moe.moe_ffn`` under
``ctx.use_mesh`` on a 2 x 2 ``("data", "model")`` mesh of gloo ranks,
held to the reference's ``shard_map`` MoE (``tests/test_distributed.py:73``).

The reference's parameters and input are drawn here (``moe_init`` of
``PRNGKey(0)``, a normal input of ``PRNGKey(1)``) and saved with numpy.
The reference then runs in a subprocess that sees 4 forced host devices:
``moe_ffn`` of both MoE smoke configs (deepseek-moe-16b has shared
experts) under ``jax.sharding.set_mesh`` on a 2 x 2 mesh, its output
saved with numpy, while the port runs a world of 4 CPU ranks on the same
parameters, each on its own batch rows and expert slice.
Tolerances: the reference's own for its mesh path against its local one
(``test_distributed.py``): rtol 2e-4, atol 2e-5 for the rows, 1e-4 for
the aux loss; the port's mesh path against its own local path on one
process is exact (the two "model" ranks' experts are disjoint, and their
f32 sum adds each token's contributions in the same order here).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import smoke_config
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import ranks
from repro_torch.distributed.ctx import _ambient_axes, use_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.layers import Init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
MESH_SHAPE = (2, 2)

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import smoke_config
from repro.models import moe as MOE
with np.load(sys.argv[2]) as f:
    given = {k: f[k] for k in f.files}
out = {}
for arch in sys.argv[3:]:
    cfg = smoke_config(arch)
    p = {}
    for key, v in given.items():
        if key.startswith(arch + "|p|"):
            *head, last = key.split("|p|")[1].split("/")
            node = p
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(v)
    x = jnp.asarray(given[arch + "|x"])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    with jax.sharding.set_mesh(mesh):
        got, aux = jax.jit(lambda p, x: MOE.moe_ffn(p, cfg, x))(p, x)
    out[arch + "|out"] = np.asarray(got)
    out[arch + "|aux"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
"""


def reference_inputs():
    """The reference's MoE parameters and input of each arch, drawn as its
    own tests draw them -> ``{arch|p|path: array, arch|x: array}``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import smoke_config as ref_config
    from repro.models import moe as RMOE
    out = {}
    for arch in ARCHS:
        cfg = ref_config(arch)
        p = RMOE.moe_init(jax.random.PRNGKey(0), cfg)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, cfg.d_model),
                              jnp.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = "/".join(k.key for k in path)
            out[arch + "|p|" + key] = np.asarray(leaf)
        out[arch + "|x"] = np.asarray(x)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    given = reference_inputs()
    np.savez(tmp / "inputs.npz", **given)
    path = str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, path,
                             str(tmp / "inputs.npz"), *ARCHS],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cases = []
    for arch in ARCHS:
        params = unflatten({k.split("|p|")[1]: v for k, v in given.items()
                            if k.startswith(arch + "|p|")})
        cases.append({"arch": arch, "mesh": MESH_SHAPE, "params": params,
                      "x": given[arch + "|x"], "seed": 7, "batch": 4,
                      "seq": 16, "forward": True})
    try:
        port = MESH.spawn(ranks.moe_rank, 4, "gloo",
                          {"device": "cpu", "cases": cases}, device="cpu",
                          timeout_s=300)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    with np.load(path) as f:
        want = {arch: (f[arch + "|out"], float(f[arch + "|aux"]))
                for arch in ARCHS}
    return want, port


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_moe_matches_reference_shard_map(worlds, arch):
    want, port = worlds
    out, aux = want[arch]
    for r in port:
        [case] = [c for c in r["cases"] if c["arch"] == arch]
        data_rank = r["rank"] // MESH_SHAPE[1]      # ranks [[0, 1], [2, 3]]
        rows = np.split(out, MESH_SHAPE[0])[data_rank]
        assert case["out"].shape == rows.shape
        np.testing.assert_allclose(case["out"], rows, rtol=2e-4, atol=2e-5)
        assert abs(case["aux"] - aux) <= 1e-4 * max(1.0, abs(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_moe_equals_port_local_path(worlds, arch):
    _, port = worlds
    e = smoke_config(arch).n_experts
    for r in port:
        [case] = [c for c in r["cases"] if c["arch"] == arch]
        assert case["max_abs_err"] == 0.0 and case["aux_err"] == 0.0
        # each rank holds E / model experts of the 3 expert weights
        d, f = smoke_config(arch).d_model, smoke_config(arch).moe_d_ff
        assert case["expert_bytes"] == 3 * (e // MESH_SHAPE[1]) * d * f * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_mesh_runs_on_every_rank(worlds, arch):
    """``api.forward`` of the MoE model under ``use_mesh``: each rank's
    logits rows are the local forward's, to f32 rounding."""
    _, port = worlds
    for r in port:
        [case] = [c for c in r["cases"] if c["arch"] == arch]
        assert case["forward_err"] <= 1e-5


class FakeMesh(types.SimpleNamespace):
    """What ``use_mesh`` reads of a mesh, with no process group behind it:
    a path that reaches a collective raises."""


def test_indivisible_experts_take_the_local_path():
    cfg = smoke_config("deepseek-moe-16b").replace(n_experts=6)
    gen = torch.Generator().manual_seed(0)
    p = MOE.moe_init(Init(gen, torch.device("cpu")), cfg)
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    want, want_aux = MOE._moe_ffn_local(p, cfg, x)
    mesh = FakeMesh(mesh_dim_names=("data", "model"), shape=(1, 4))
    with use_mesh(mesh):
        assert _ambient_axes().shape == {"data": 1, "model": 4}
        got, aux = MOE.moe_ffn(p, cfg, x)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert _ambient_axes() is None


def test_divisible_experts_take_the_mesh_path():
    cfg = smoke_config("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(0)
    p = MOE.moe_init(Init(gen, torch.device("cpu")), cfg)
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    mesh = FakeMesh(mesh_dim_names=("data", "model"), shape=(1, 4),
                    get_local_rank=lambda name: 0,
                    size=lambda dim: (1, 4)[dim],
                    get_group=lambda name: None)
    with use_mesh(mesh), pytest.raises((RuntimeError, ValueError)):
        MOE.moe_ffn(p, cfg, x)      # the all-reduce: no process group
