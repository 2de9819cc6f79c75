"""The port's checkpoints (``repro_torch.checkpoint.manager``): the
counterparts of the reference's round trip, corruption, async and torn
save tests; an async snapshot that a later in-place step does not
change; and the layout shared with the reference, both ways: a
checkpoint either package writes is restored by the other bit for bit
(f32 smoke trees with the optimizer state, and a bf16 tree, whose leaves
both packages store as ``|V2`` bits under manifest dtype
``bfloat16``)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import api as RA
from repro.train import optim as RO
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import smoke_config
from repro_torch.models import api as TA
from repro_torch.models import smoke
from repro_torch.train import optim as TO
from repro_torch.train import step as TS


def port_tree(arch="qwen2-0.5b", seed=0, dtype="float32"):
    cfg = smoke_config(arch).replace(param_dtype=dtype)
    params = TA.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, {"params": params, "opt": TO.init_opt_state(params)}


def bits(x) -> np.ndarray:
    """A tensor's or a numpy array's raw bits (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                ).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and \
        x.dtype.kind not in "iu" else x


def assert_same_bits(got, want):
    """Every leaf of two trees (tensors or arrays) keyed alike: the same
    shape, dtype name and bits."""
    got = {"/".join(p): v for p, v in TA.leaves(got)}
    want = {"/".join(p): v for p, v in TA.leaves(jax.tree.map(
        np.asarray, want) if not _is_torch(want) else want)}
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = bits(got[k]), bits(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _is_torch(tree) -> bool:
    return isinstance(next(v for _, v in TA.leaves(tree)), torch.Tensor)


def test_checkpoint_roundtrip_and_corruption(tmp_path):
    _, tree = port_tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30):
        mgr.save(step, tree)
    assert mgr.all_steps() == [20, 30]          # keep=2 retention
    step, got = mgr.restore_latest(port_tree(seed=1)[1])
    assert step == 30
    assert_same_bits(got, tree)
    assert got["opt"]["step"].dtype == torch.int32
    npz = tmp_path / "step_000000030" / "arrays.npz"
    data = npz.read_bytes()
    npz.write_bytes(data[:-10] + b"corrupted!")
    with pytest.raises(IOError):
        mgr.restore(30, tree)


def test_restore_checks_shapes_and_puts_leaves_where_asked(tmp_path):
    _, tree = port_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    got = mgr.restore(1, tree, device="cpu")
    assert got["params"]["embed"].device.type == "cpu"
    # the template's dtype wins: an f64 template gets f64 leaves
    t64 = {"params": TA.tree_map(lambda t: t.double(), tree["params"])}
    got = mgr.restore(1, t64)
    assert got["params"]["embed"].dtype == torch.float64
    assert torch.equal(got["params"]["embed"],
                       tree["params"]["embed"].double())
    bad = {"params": dict(tree["params"], embed=torch.zeros(3, 5))}
    with pytest.raises(ValueError, match="params/embed"):
        mgr.restore(1, bad)


def test_checkpoint_async(tmp_path):
    _, tree = port_tree()
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    mgr.save(1, {"params": tree["params"]})
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_snapshot_is_not_aliased_by_an_in_place_step(tmp_path):
    """``save`` returns before the thread writes; the next train step
    then updates every param and moment in place.  The checkpoint must
    hold the values of the moment ``save`` was called."""
    cfg, tree = port_tree()
    want = TA.tree_map(torch.clone, tree)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, tree)
    step = TS.make_train_step(cfg)
    for i in range(3):
        step(tree["params"], tree["opt"], smoke.batch(cfg, i, "cpu"))
    mgr.wait()
    assert not torch.equal(tree["params"]["embed"], want["params"]["embed"])
    assert_same_bits(mgr.restore(1, tree), want)


def test_torn_save_is_invisible(tmp_path):
    _, tree = port_tree()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, {"params": tree["params"]})
    (tmp_path / "step_000000007.tmp").mkdir()
    (tmp_path / "step_000000007.tmp" / "arrays.npz").write_bytes(b"torn")
    assert mgr.all_steps() == [5]
    (tmp_path / "step_000000009").mkdir()
    assert mgr.latest_step() == 5


def _reference_tree(arch="qwen2-0.5b", dtype="float32"):
    cfg = ref_smoke_config(arch).replace(param_dtype=dtype)
    params = RA.init(jax.random.PRNGKey(0), cfg)
    return {"params": params, "opt": RO.init_opt_state(params)}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    ref = _reference_tree(arch)
    ref["opt"]["m"] = jax.tree.map(lambda x: x + 0.25, ref["opt"]["m"])
    RefManager(tmp_path).save(3, ref)
    cfg, template = port_tree(arch, seed=7)
    got = CheckpointManager(tmp_path).restore(3, template)
    assert_same_bits(got, ref)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    """After one train step (so the moments and step are not zeros), the
    port's save restored by the reference's manager: every leaf's bits,
    and the same manifest keys, shapes and dtypes as the reference's own
    save of that tree."""
    cfg, tree = port_tree(arch, seed=3)
    TS.make_train_step(cfg)(tree["params"], tree["opt"],
                            smoke.batch(cfg, 0, "cpu"))
    CheckpointManager(tmp_path / "port").save(4, tree)
    ref = RefManager(tmp_path / "port").restore(4, _reference_tree(arch))
    assert_same_bits(tree, ref)
    RefManager(tmp_path / "ref").save(4, ref)
    manifests = [json.loads((tmp_path / who / "step_000000004" /
                             "manifest.json").read_text())
                 for who in ("port", "ref")]
    for k in ("step", "keys", "shapes", "dtypes", "extra"):
        assert manifests[0][k] == manifests[1][k], k


def test_bf16_leaves_cross_as_v2_bits(tmp_path):
    """The reference writes a bf16 leaf as numpy ``|V2`` under dtype
    ``bfloat16``; the port reads its bits, and writes its own bf16 leaves
    the same way."""
    ref = {"params": _reference_tree(dtype="bfloat16")["params"]}
    RefManager(tmp_path / "ref").save(1, ref)
    with np.load(tmp_path / "ref" / "step_000000001" / "arrays.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
    _, tree = port_tree(dtype="bfloat16")
    got = CheckpointManager(tmp_path / "ref").restore(
        1, {"params": tree["params"]})
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert_same_bits(got, ref)
    CheckpointManager(tmp_path / "port").save(1, got)
    with np.load(tmp_path / "port" / "step_000000001" / "arrays.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            z["params/embed"].view(np.int16),
            bits(np.asarray(ref["params"]["embed"])))
    manifest = json.loads((tmp_path / "port" / "step_000000001" /
                           "manifest.json").read_text())
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
