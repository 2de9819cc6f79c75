"""The port's mesh path of ``sharded`` on the CPU: ranks of a gloo process
group (``repro_torch.distributed.mesh.spawn``), each folding its own fact
shard, the int64 grids all-reduced — held to the reference's
``shard_map`` + ``psum`` path (``tests/test_shard.py:150``,
``tests/test_morsel.py:226``).

The reference runs in a subprocess that sees 4 forced host devices
(``--xla_force_host_platform_device_count=4``): ``shard_database`` of its
SF 0.005 database (seed 11) at S = 4, plain and packed, the 13 queries in
mode ``jnp``, each answer saved with numpy.  The port runs a world of 4
CPU ranks on the same data (``ssb.from_numpy``), mode ``auto`` (the plain
versions on the CPU).  Tolerance: none — every rank's answer is
bit-identical to the reference's, to the oracle and to every other
rank's (both sides' partials are exact at this scale).
"""
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.sql import ssb as RSSB
from repro_torch.cost.model import H100
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import ranks
from repro_torch.sql import calibrate as CAL
from repro_torch.sql import engine, ssb
from repro_torch.sql import model as M
from repro_torch.sql import morsel as MS
from repro_torch.sql import shard as SH
from repro_torch.sql.model import HOST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DB = RSSB.generate(sf=0.005, seed=11)
DB = ssb.from_numpy({t: getattr(REF_DB, t).columns for t in ssb.TABLES},
                    REF_DB.sf)
QUERIES = engine.ssb_queries()
NAMES = list(QUERIES)
WORLD = 4
# a budget that cuts each rank's shard of the packed table into windows
BUDGET = 24 << 10

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
from repro.sql import compile as C, engine, hashtable as HT
from repro.sql import shard as SH, ssb, storage as ST
db = ssb.generate(0.005, seed=11)
out = {}
for kind, d in (("plain", db), ("packed", ST.pack_database(db))):
    sdb = SH.shard_database(d, 4)
    assert sdb.mesh is not None
    cache = HT.HashTableCache()
    for name, plan in engine.ssb_queries().items():
        cq = C.compile_plan(plan, "sharded")
        out[kind + "/" + name] = np.asarray(cq.execute(sdb, mode="jnp",
                                                       cache=cache))
        assert cq.device_count == 4 and len(cq.shard_times_s) == 1
np.savez(sys.argv[1], **out)
"""


def spawn(fn, world, *args, **kw):
    return MESH.spawn(fn, world, "gloo", *args, device="cpu",
                      timeout_s=kw.pop("timeout_s", 300), **kw)


@pytest.fixture(scope="module")
def oracle():
    return {name: engine.run_query_oracle(DB, plan)
            for name, plan in QUERIES.items()}


def cut(rows: int):
    """``DB`` with its first ``rows`` fact rows alone."""
    return ssb.from_numpy(
        {t: ({c: v[:rows] for c, v in DB.lineorder.columns.items()}
             if t == "lineorder" else getattr(DB, t).columns)
         for t in ssb.TABLES}, DB.sf)


TINY = cut(2)
WINDOWED = ["q1.1", "q2.1", "q3.4", "q4.3"]


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's subprocess, started before the file's first test so
    that it runs while the other worlds do -> (process, its output
    file)."""
    path = str(tmp_path_factory.mktemp("mesh") / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, path],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ragged():
    """S = 3 over 29,998 rows: shards of 9,999, 9,999 and 10,000 rows,
    plain and packed, and the ``group=`` hooks on each rank's shard."""
    db = cut(DB.lineorder.n_rows - 2)
    port = spawn(ranks.sql_rank, 3, {"device": "cpu", "db": db, "runs": [
        {"label": "plain"}, {"label": "packed", "pack": True}],
        "hooks": True})
    return {name: engine.run_query_oracle(db, plan)
            for name, plan in QUERIES.items()}, port


def test_ragged_shards_at_three_ranks(ragged):
    want, port = ragged
    assert [r["runs"]["plain"]["shard_rows"] for r in port] == \
        [9999, 9999, 10000]
    for name in NAMES:
        for r in port:
            for kind in ("plain", "packed"):
                run = r["runs"][kind]
                assert np.array_equal(run["results"][name], want[name])
                assert run["device_count"][name] == 3


@pytest.mark.parametrize("hook", ["spja", "multi_spja"])
def test_group_hooks_all_reduce_each_rank_shard(ragged, hook):
    """``ops.spja(..., group=)`` and ``ops.multi_spja(..., group=)`` on each
    rank's own shard: after the all-reduce every rank holds the whole
    table's answer, the f32 of the exact int64 sums."""
    want, port = ragged
    for r in port:
        for name in NAMES:
            got = r["hooks"][hook][name]
            assert got.dtype == np.float32
            assert np.array_equal(got, want[name]), (hook, name)


def test_spawn_reraises_a_rank_exception():
    with pytest.raises(MESH.RankError, match="math domain error"):
        spawn(math.sqrt, 2, -1.0)


def test_spawn_kills_a_world_past_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="outlived"):
        spawn(time.sleep, 2, 300.0, timeout_s=3)
    assert time.monotonic() - t0 < 60


def test_default_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="no process group"):
        MESH.default_mesh(device="cpu")


@pytest.mark.parametrize("devices, backend", [
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cuda:0"], "gloo"),
    (["cpu", "cpu"], "gloo"), (["cuda:0"], "nccl"),
    (["cuda:0", "cpu"], "gloo")])
def test_backend_for(devices, backend):
    assert MESH.backend_for(devices) == backend


# the port's world of 4 and the reference's answers (the reference has
# run beside the worlds above)


@pytest.fixture(scope="module")
def worlds(reference):
    """The reference's mesh answers and every rank's result of the port's
    one world of 4: plain and packed in mode ``auto``, ``mode="ref"``,
    ``auto`` with each rank given its own ``Hardware``, ``auto`` on
    resident shards, a fact table of two rows, the packed table in windows
    over meshes of two ranks, and the interconnect over groups of two
    ranks and of one."""
    proc, path = reference
    # rank 0 prices with the host, the others with the card's rates
    hw = [HOST] + [H100] * (WORLD - 1)
    port = spawn(ranks.sql_rank, WORLD, {"device": "cpu", "db": DB, "runs": [
        {"label": "plain"}, {"label": "packed", "pack": True},
        {"label": "ref", "mode": "ref"},
        {"label": "auto", "strategy": "auto", "hw": hw},
        {"label": "resident auto", "strategy": "auto", "resident": True,
         "hw": [H100] * WORLD, "morsel_bytes": BUDGET},
        {"label": "tiny", "db": TINY},
        {"label": "windows", "pack": True, "morsel_bytes": BUDGET,
         "queries": WINDOWED, "ranks": 2}],
        "interconnect": [2, 1]})
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    with np.load(path) as ref:
        return {k: ref[k] for k in ref.files}, port


@pytest.mark.parametrize("kind", ["plain", "packed"])
@pytest.mark.parametrize("name", NAMES)
def test_world_of_four_matches_reference_mesh_and_oracle(worlds, oracle,
                                                         kind, name):
    ref, port = worlds
    assert np.array_equal(ref[f"{kind}/{name}"], oracle[name])
    for r in port:
        run = r["runs"][kind]
        got = run["results"][name]
        assert got.dtype == np.float32
        assert np.array_equal(got, ref[f"{kind}/{name}"]), (r["rank"], name)
        assert run["device_count"][name] == WORLD
        assert run["shard_times"][name] == 1     # one whole-mesh launch
        assert run["decided"][name] == "sharded"
        assert run["launches"] == {}             # plain versions on the CPU


def test_world_ranks_hold_their_own_shards(worlds):
    _, port = worlds
    n = DB.lineorder.n_rows
    assert [r["rank"] for r in port] == list(range(WORLD))
    assert [r["backend"] for r in port] == ["gloo"] * WORLD
    rows = [r["runs"]["plain"]["shard_rows"] for r in port]
    assert rows == [(i + 1) * n // WORLD - i * n // WORLD
                    for i in range(WORLD)]
    assert all(r["db"] == "handed over" for r in port)


def test_ref_mode_runs_the_host_loop_of_all_shards(worlds, oracle):
    _, port = worlds
    for r in port:
        run = r["runs"]["ref"]
        for name in NAMES:
            assert np.array_equal(run["results"][name], oracle[name])
            assert run["shard_times"][name] == WORLD     # one a shard
            assert run["morsels"][name] >= WORLD


def test_auto_chooses_alike_across_ranks(worlds, oracle):
    """Rank 0 prices with ``HOST``, ranks 1-3 with ``H100``: the sharded
    database carries rank 0's ``Hardware`` to every rank, so every rank
    runs rank 0's choice (on the CPU, ``default_hardware`` is ``HOST``
    whatever the calibration caches hold, so the ranks' ``Hardware``
    differs here by being handed over)."""
    _, port = worlds
    logical = SH.shard_database(DB, WORLD)
    own = {name: (M.choose(plan, logical, hw=HOST, n_shards=WORLD,
                           morsel_bytes=MS.DEFAULT_MORSEL_BYTES).strategy,
                  M.choose(plan, logical, hw=H100, n_shards=WORLD,
                           morsel_bytes=MS.DEFAULT_MORSEL_BYTES).strategy)
           for name, plan in QUERIES.items()}
    assert any(a != b for a, b in own.values()), own
    for r in port:
        run = r["runs"]["auto"]
        assert run["hw"] == HOST
        for name in NAMES:
            assert run["decided"][name] == port[0]["runs"]["auto"][
                "decided"][name]
            assert np.array_equal(run["results"][name], oracle[name])


def test_empty_shards_join_the_reduce(worlds):
    """A fact table of 2 rows over 4 ranks: ranks 0 and 2 hold no row,
    fold nothing, and still all-reduce a zero grid."""
    _, port = worlds
    assert [r["runs"]["tiny"]["shard_rows"] for r in port] == [0, 1, 0, 1]
    for name, plan in QUERIES.items():
        want = engine.run_query_oracle(TINY, plan)
        for r in port:
            assert np.array_equal(r["runs"]["tiny"]["results"][name], want)
            assert r["runs"]["tiny"]["morsels"][name] <= 1


def test_windows_under_budget_at_two_ranks(worlds, oracle):
    """The counterpart of ``tests/test_morsel.py:226``: the world of 4
    splits into two meshes of 2 ranks, and each rank's shard of the packed
    table streams in several windows, ragged counts between ranks
    allowed, before its mesh's one all-reduce."""
    _, port = worlds
    n = DB.lineorder.n_rows
    rows = [(i + 1) * n // 2 - i * n // 2 for i in range(2)] * 2
    assert [r["runs"]["windows"]["shard_rows"] for r in port] == rows
    for name in WINDOWED:
        for r in port:
            run = r["runs"]["windows"]
            assert run["morsels"][name] > 1
            assert run["device_count"][name] == 2
            assert np.array_equal(run["results"][name], oracle[name])


def test_auto_prices_a_resident_mesh_shard_as_one_morsel(worlds, oracle):
    """Each rank's own shard is resident and the base stays on the host:
    ``auto`` prices ``sharded`` at one morsel a shard and the other
    strategies streaming the base under the budget, so it runs
    ``sharded``."""
    _, port = worlds
    for name, plan in QUERIES.items():
        want = M.predict(plan, DB, hw=H100, n_shards=WORLD,
                         morsel_bytes=BUDGET, shard_morsel_bytes=1 << 40)
        streamed = M.predict(plan, DB, hw=H100, n_shards=WORLD,
                             morsel_bytes=BUDGET)
        assert want["sharded"] < streamed["sharded"], name
        for r in port:
            run = r["runs"]["resident auto"]
            assert run["predictions"][name] == want, (r["rank"], name)
            assert run["decided"][name] == "sharded"
            assert np.array_equal(run["results"][name], oracle[name])


def test_measure_interconnect_all_reduce_at_two_ranks(worlds):
    _, port = worlds
    links = [r["interconnect"][0] for r in port]
    assert [x["world"] for x in links] == [2] * WORLD
    assert [x["backend"] for x in links] == ["gloo"] * WORLD
    for pair in (links[:2], links[2:]):
        assert pair[0]["rate"] > 0 and pair[0]["rate"] == pair[1]["rate"]


def test_measure_interconnect_world_of_one_keeps_host_link_rule(worlds):
    """A group of one rank has no interconnect: the host-link rule, which
    on the CPU is no rate, as without a group."""
    _, port = worlds
    for r in port:
        one = r["interconnect"][1]
        assert (one["world"], one["rate"], one["backend"]) == (1, None, None)
    cpu = torch.device("cpu")
    assert CAL._measure_interconnect(cpu) is None
    assert CAL.interconnect_backend(cpu) is None
