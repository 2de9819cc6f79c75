"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the real single CPU device; only
launch/dryrun.py (its own process) forces 512 host devices."""
import os
import tempfile
import warnings

import numpy as np
import pytest

warnings.filterwarnings("ignore", category=DeprecationWarning)

# hermetic cost-model predictions: a developer's (or CI's) on-disk
# bandwidth calibration must not leak into test expectations — point the
# calibration cache at a fresh empty dir unconditionally (tests that
# need their own use monkeypatch).
os.environ["REPRO_CALIB_CACHE"] = tempfile.mkdtemp(
    prefix="repro-calib-test-")


def pytest_addoption(parser):
    parser.addoption(
        "--deselect-from", action="store", default=None, metavar="FILE",
        help="deselect every test node id listed in FILE (one per line, "
             "# comments ignored).  tests/seed-skips.txt holds the "
             "seed-failing set both CI and local runs skip: "
             "pytest -q --deselect-from tests/seed-skips.txt")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels "
                   "have no CPU form); skips without one")


def pytest_collection_modifyitems(config, items):
    path = config.getoption("--deselect-from")
    if not path:
        return
    with open(path) as f:
        skip_ids = {line.strip() for line in f
                    if line.strip() and not line.strip().startswith("#")}
    deselected = [it for it in items if it.nodeid in skip_ids]
    if deselected:
        config.hook.pytest_deselected(items=deselected)
        items[:] = [it for it in items if it.nodeid not in skip_ids]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.  The suite jits
    hundreds of distinct kernel shapes; letting them all stay live in
    one process eventually segfaults a later XLA CPU compile (observed
    deterministically once the morsel-stream module joined the suite).
    Clearing per module bounds the live-executable footprint at the cost
    of some recompilation."""
    yield
    import jax
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
