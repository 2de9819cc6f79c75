"""The port's sharded AdamW step, its compression over a group and the
collectives its paths call, on one world of 4 CPU gloo ranks.

The sharded step (``make_train_step(cfg, opt, mesh=, zero1=)``, each rank
holding its blocks by ``distributed.sharding``'s rules) on 2 x 2, 4 x 1
and 1 x 4 ``("data", "model")`` meshes, ZeRO-1 off and on, for three
smoke configs: qwen2.5-3b with the reference test's overrides
(``tests/test_distributed.py:31``, vocab 512), mamba2-2.7b (the
``ssm_ok`` branch) and qwen3-moe-30b-a3b (the ``in_moe`` branch), both
with vocab 503, which 2 and 4 ranks do not divide.  Two steps of a batch
of 8 x 32 tokens under ``smoke.TRAIN_OPT``, whose first step moves every
param leaf by far more than the tolerance (the default schedule's 3e-6
would not).  Each is held to the port's single-rank step
(``ranks.single_rank_train``) on the whole batch in dp microbatches:
data parallelism is gradient accumulation over the data shards.  The
reference's own sharded step cannot be the target: jax 0.9 refuses its
embedding gather on a model-sharded table, and its test has failed on
every run.  So that single-rank target is itself held to the reference's
single-device jitted ``make_train_step`` with ``train_microbatches`` =
dp, on the same initial params (carried to jax), batches and steps, at
``test_torch_train.py``'s tolerances (rtol = atol = 1e-4; v also at
1e-4 of its largest entry); the reference runs in a subprocess while the
world runs.  Tolerances of the ranks against the single rank, tightened from the reference test's (loss rtol
2e-4; params rtol 3e-3, atol 3e-4) to what holds with margin: loss and
``grad_norm`` rtol 1e-5; params rtol 1e-5, atol 1e-6; the moments rtol
1e-4 (m atol 1e-7, v 1e-9).  The ranks' results differ from the single
rank's only by the f32 sum order of 4 ranks and their thread counts.

``compressed_psum`` / ``bf16_psum`` over the world against the stacked
plain versions: the int8 path bit for bit (the int32 sum and the scale
slots are exact), the bf16 sum within 2^-8 of the sum of |bf16(g)| an
element (the backend's roundings against one).

A recorder wraps ``torch.distributed`` during the steps, the reduces and
a GPipe run: only ``all_reduce`` and ``broadcast`` may appear, the two
collectives gloo offers on CUDA tensors (gloo on CPU tensors accepts
more, so a CPU run alone would not catch it).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed import compression as C
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import ranks
from repro_torch.models import api as TA
from repro_torch.models import smoke

ARCHS = {"qwen2.5-3b": dict(n_heads=4, n_kv_heads=2, head_dim=16,
                            vocab_size=512),
         "mamba2-2.7b": {}, "qwen3-moe-30b-a3b": {}}
MESHES = [(2, 2), (4, 1), (1, 4)]
TOL = {"params": (1e-5, 1e-6), "master": (1e-5, 1e-6), "m": (1e-4, 1e-7),
       "v": (1e-4, 1e-9)}
STEP_RTOL = 1e-5
COMPRESS = {"n": 10_007, "seed": 5, "reps": 1}
PIPE = {"S": 4, "F": 4, "MB": 2, "D": 8, "seed": 2}
ALLOWED = {"all_reduce", "broadcast"}
IDS = [f"{a}-{d}x{m}-{'zero1' if z else 'plain'}" for a, (d, m), z in
       itertools.product(ARCHS, MESHES, (False, True))]
REF_TOL = 1e-4                  # tests/test_torch_train.py's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's single-device step on the single-rank target's inputs:
# the port's initial params (``ranks.train_params``) and batches
# (``ranks.train_batch``), each case's steps, ``train_microbatches`` = dp
REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs.base import smoke_config
from repro.train import optim as RO, step as RS
from repro_torch.distributed import ranks
from repro_torch.models import api as TA

def nest(flat):
    out = {}
    for path, v in flat:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out

cpu = torch.device("cpu")
out = {}
for case in json.loads(sys.argv[2]):
    cfg = ranks.train_config(case)
    dp = case["mesh"][0]
    rcfg = smoke_config(case["arch"]).replace(
        **case["overrides"], train_microbatches=dp * cfg.train_microbatches)
    params = nest((k, jnp.asarray(v.numpy())) for k, v in
                  TA.leaves(ranks.train_params(case, cfg, cpu)))
    opt = RO.init_opt_state(params)
    step = jax.jit(RS.make_train_step(rcfg, RO.AdamWConfig(**case["opt"])))
    key = case["arch"] + "|" + str(dp)
    losses, norms = [], []
    for k in range(case["steps"]):
        batch = ranks.train_batch(case, cfg, k, cpu, None, dp)
        params, opt, m = step(params, opt, {n: jnp.asarray(t.numpy())
                                            for n, t in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[key + "|loss"] = np.asarray(losses)
    out[key + "|grad_norm"] = np.asarray(norms)
    out[key + "|step"] = np.asarray(opt["step"])
    for name, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for path, leaf in TA.leaves(tree):
            out[key + "|" + name + "|" + "/".join(path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def base_case(arch, mesh):
    return {"arch": arch, "overrides": ARCHS[arch], "mesh": mesh,
            "seed": 3, "batch": 8, "seq": 32, "steps": 2,
            "opt": dataclasses.asdict(smoke.TRAIN_OPT), "tol": TOL}


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """The reference's subprocess, started before the world so that the
    two run together; -> (process, the npz it writes)."""
    tmp = tmp_path_factory.mktemp("train_mesh_ref")
    path = str(tmp / "reference.npz")
    cases = [base_case(arch, (dp, 4 // dp)) for arch in ARCHS
             for dp, _ in MESHES]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, path,
                             json.dumps(cases)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(tmp_path_factory, reference_proc):
    """The single-rank steps here, then one world of 4 ranks: the 18
    sharded cases, the compressed reduces and a GPipe run."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    single, cases = {}, []
    for arch, mesh, zero1 in itertools.product(ARCHS, MESHES,
                                               (False, True)):
        path = str(tmp / f"{arch}-{mesh[0]}.pt")
        if (arch, mesh[0]) not in single:
            single[arch, mesh[0]] = ranks.single_rank_train(
                base_case(arch, mesh), torch.device("cpu"), path)
        cases.append(dict(base_case(arch, mesh), zero1=zero1, want=path))
    out = MESH.spawn(ranks.chain_rank, 4, "gloo", {"bodies": [
        ("train_rank", {"device": "cpu", "cases": cases}),
        ("compress_rank", dict(COMPRESS, device="cpu")),
        ("pipe_rank", {"device": "cpu", "cases": [PIPE]})]},
        device="cpu", timeout_s=300)
    return single, cases, out


@pytest.fixture(scope="module")
def reference(world, reference_proc):
    proc, path = reference_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def flat_np(tree, prefix: str) -> dict:
    return {prefix + "/".join(p): v.detach().double().numpy()
            for p, v in TA.leaves(tree)}


@pytest.mark.parametrize("arch,dp", [(a, d) for a in ARCHS
                                     for d, _ in MESHES],
                         ids=[f"{a}-dp{d}" for a in ARCHS for d, _ in MESHES])
def test_single_rank_target_equals_the_reference_step(world, reference,
                                                      arch, dp):
    """The target the ranks are held to is the reference's own step: the
    loss and gradient norm of each step, then the params and moments."""
    _, cases, _ = world
    path = next(c["want"] for c in cases
                if c["arch"] == arch and c["mesh"][0] == dp)
    want = torch.load(path, weights_only=True)
    key = f"{arch}|{dp}|"
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(want[name], reference[key + name],
                                   rtol=REF_TOL, atol=REF_TOL, err_msg=name)
    assert int(want["opt"]["step"]) == int(reference[key + "step"]) == 2
    got = {**flat_np(want["params"], "params|"),
           **flat_np(want["opt"]["m"], "m|"),
           **flat_np(want["opt"]["v"], "v|")}
    assert sorted(key + k for k in got) == sorted(
        k for k in reference if k.startswith(key) and k.count("|") == 3)
    for k, g in got.items():
        ref = reference[key + k]
        np.testing.assert_allclose(g, ref, rtol=REF_TOL, atol=REF_TOL,
                                   err_msg=k)
        if k.startswith("v|"):
            # v is about 0.05 g^2, far under REF_TOL: held again at
            # REF_TOL of its size
            np.testing.assert_allclose(g, ref, rtol=REF_TOL,
                                       atol=REF_TOL * np.abs(ref).max(),
                                       err_msg=k)


@pytest.mark.parametrize("i", range(len(IDS)), ids=IDS)
def test_sharded_step_equals_the_single_rank_step(world, i):
    single, cases, out = world
    case = cases[i]
    want = single[case["arch"], case["mesh"][0]]
    # the step moves every leaf by far more than the tolerance
    assert want["least_move"] > 100 * TOL["params"][1]
    for r in out:
        got = r["train_rank"]["cases"][i]
        assert got["mesh"] == list(case["mesh"]) and got["zero1"] == \
            case["zero1"]
        assert got["loss_rel"] <= STEP_RTOL, got["loss"]
        assert got["grad_norm_rel"] <= STEP_RTOL, got["grad_norm"]
        assert got["step_equal"]
        assert set(got["errors"]) == {"params", "m", "v"}
        for name, e in got["errors"].items():
            assert e["excess"] <= 1.0, (name, e)
        # the plain versions on the CPU: no kernel launched
        assert got["launches"] == {}
        assert got["collectives"] == ["all_reduce"]


@pytest.mark.parametrize("mesh", MESHES)
def test_zero1_shards_the_moments_over_the_data_axis(world, mesh):
    """A rank's optimizer blocks shrink by the data axis under ZeRO-1
    (each leaf whose dim the data ranks divide), its params do not."""
    _, cases, out = world
    for r in out:
        got = {(c["arch"], c["zero1"]): r["train_rank"]["cases"][i]
               for i, c in enumerate(cases) if c["mesh"] == mesh}
        for arch in ARCHS:
            off, on = got[arch, False], got[arch, True]
            assert on["block_bytes"]["params"] == \
                off["block_bytes"]["params"]
            if mesh[0] == 1:
                assert on["block_bytes"]["opt"] == off["block_bytes"]["opt"]
            else:
                assert on["block_bytes"]["opt"] < \
                    0.75 * off["block_bytes"]["opt"]
            if mesh[0] > 1 and mesh[1] == 1:
                # the re-gather is one all-reduce a step
                assert [s["zero1_regather"]["all_reduces"]
                        for s in on["stats"]] == [1, 1]
            assert [s["grad_reduce"]["all_reduces"] for s in on["stats"]] \
                == [int(mesh[0] > 1)] * 2


def test_compressed_psum_over_the_group_equals_the_stacked_form(world):
    _, _, out = world
    res = [r["compress_rank"] for r in out]
    g, err = ranks.compress_inputs(COMPRESS["n"], 4, COMPRESS["seed"])
    want, new_errs = C.compressed_psum_stacked(torch.from_numpy(g),
                                               torch.from_numpy(err))
    assert len({r["digest"]["compressed"] for r in res}) == 1
    assert np.array_equal(res[0]["compressed"].view(np.int32),
                          want.numpy().view(np.int32))
    for r in res:
        assert r["digest"]["new_err"] == ranks.digest(new_errs[r["rank"]])
    assert res[0]["wire_bytes"]["compressed"] == 4 * COMPRESS["n"] + 16


def test_bf16_psum_over_the_group_within_the_backends_roundings(world):
    _, _, out = world
    res = [r["compress_rank"] for r in out]
    g, _ = ranks.compress_inputs(COMPRESS["n"], 4, COMPRESS["seed"])
    gs = torch.from_numpy(g)
    want = C.bf16_psum_stacked(gs).double()
    assert len({r["digest"]["bf16"] for r in res}) == 1
    got = torch.from_numpy(res[0]["bf16"]).double()
    # the mean of bf16 values: n - 1 roundings of partial sums against one
    bound = 2.0 ** -8 * gs.to(torch.bfloat16).double().abs().sum(dim=0)
    assert bool(((got - want).abs() <= bound).all())
    assert float((got - gs.double().mean(dim=0)).abs().max()) < 0.05


def test_training_paths_call_only_all_reduce_and_broadcast(world):
    _, _, out = world
    for r in out:
        seen = [c["collectives"] for c in r["train_rank"]["cases"]]
        seen += [r["compress_rank"]["collectives"],
                 r["pipe_rank"]["cases"][0]["collectives"]]
        for names in seen:
            assert names and set(names) <= ALLOWED, names


def test_the_recorder_sees_what_gloo_on_cuda_refuses(tmp_path):
    """The recorder itself: a gather in its block is listed."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        with ranks.recording() as names:
            dist.all_reduce(torch.ones(2))
            dist.all_gather([torch.empty(2)], torch.ones(2))
        assert names == ["all_reduce", "all_gather"]
        # restored on leaving the block
        with ranks.recording() as again:
            pass
        dist.all_reduce(torch.ones(2))
        assert again == [] and len(names) == 2
    finally:
        dist.destroy_process_group()
