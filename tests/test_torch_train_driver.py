"""End-to-end kill/restart of the port's training CLI on the CPU
(``python -m repro_torch.launch.train --smoke --device cpu``, a
subprocess each run): the resumed run continues from the checkpoint
step and finishes, its losses are the uninterrupted run's exactly, and
the final checkpoints hold the same bits (deterministic pipeline + exact
state restore).

The killed run is the same 15-step command, cut with ``os._exit`` as
step 12 starts (after the step-10 checkpoint has committed), where the
reference's test runs ``--steps 10`` first: the schedule's length is
``--steps``, so a 10-step run trains its first ten steps at other rates
and only a tolerance could hold its continuation to the 15-step run."""
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--steps",
        "15", "--batch", "2", "--seq", "32", "--ckpt-every", "5",
        "--log-every", "1"]
# the CLI run in-process, killed (os._exit, no clean-up) when its
# train step is called for the KILL_AT-th time, once the checkpoints
# saved so far have committed
KILLED = """
import os, runpy, sys
from repro_torch.checkpoint import manager
from repro_torch.train import step as S
kill_at, managers, calls = int(sys.argv[1]), [], [0]
save = manager.CheckpointManager.save
def tracked(self, *a, **kw):
    managers.append(self)
    return save(self, *a, **kw)
manager.CheckpointManager.save = tracked
make = S.make_train_step
def make_killed(*a, **kw):
    fn = make(*a, **kw)
    def step(*sa):
        calls[0] += 1
        if calls[0] == kill_at:
            for m in managers:
                m.wait()
            sys.stdout.flush()
            os._exit(137)
        return fn(*sa)
    return step
S.make_train_step = make_killed
sys.argv = ["train"] + sys.argv[2:]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
"""
KILL_AT = 13


def _train(ckpt_dir, kill_at=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = ["-m", "repro_torch.launch.train"] if kill_at is None else \
        ["-c", KILLED, str(kill_at)]
    out = subprocess.run(
        [sys.executable, *cmd, *ARGS, "--ckpt-dir", ckpt_dir],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == (0 if kill_at is None else 137), \
        out.stderr[-2000:]
    assert out.stdout.startswith("arch=qwen2-0.5b layers=2 d=64 ")
    assert out.stdout.rstrip().endswith("done") == (kill_at is None)
    return out.stdout


def _losses(stdout):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step\s+(\d+) loss ([\d.]+) gnorm [\d.]+ lr [\d.e+-]+ ", stdout)}


def _arrays(step_dir):
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "arrays.npz") as z:
        return manifest, {k: np.array(z[k]) for k in z.files}


def test_kill_resume_matches_uninterrupted(tmp_path):
    ref = _losses(_train(str(tmp_path / "ref")))
    assert sorted(ref) == list(range(15))
    # killed as step 12 starts (checkpoints at 5 and 10), then resumed
    killed = _losses(_train(str(tmp_path / "ckpt"), KILL_AT))
    assert sorted(killed) == list(range(12))
    assert [killed[s] for s in range(12)] == [ref[s] for s in range(12)]
    out2 = _train(str(tmp_path / "ckpt"))
    assert "resumed from step 10" in out2
    resumed = _losses(out2)
    assert sorted(resumed) == list(range(10, 15))
    for step in (12, 14):
        assert resumed[step] == ref[step], (step, resumed, ref)
    want_manifest, want = _arrays(tmp_path / "ref" / "step_000000015")
    got_manifest, got = _arrays(tmp_path / "ckpt" / "step_000000015")
    assert sorted(got) == sorted(want) == want_manifest["keys"]
    assert got_manifest["dtypes"] == want_manifest["dtypes"]
    assert int(got["opt/step"]) == 15
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
