"""The port stands alone: ``repro_torch``, ``chip_smoke.py``,
``spja_ab.py`` and ``profiler_check.py`` load neither jax nor the
reference package, and the port
never quietly runs on the host when the caller did not ask for it."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import cases
from repro_torch.kernels import (agg, hash_join, multi_fused, ops,
                                 part_probe, project, radix_part,
                                 select_scan, ssb_fused, unpack)
from repro_torch.sql import compile as TC
from repro_torch.sql import engine as TE
from repro_torch.sql import calibrate as TCAL
from repro_torch.sql import hashtable as THT
from repro_torch.sql import model as TM
from repro_torch.sql import morsel as MS
from repro_torch.sql import shard as TSH
from repro_torch.sql import ssb as TSSB

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "spja_ab.py", ROOT / "profiler_check.py"]
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(MODULES) >= 11


@pytest.mark.parametrize("module", ["repro_torch.sql.morsel",
                                    "repro_torch.sql.faults",
                                    "repro_torch.sql.resilience"])
def test_morsel_spine_loads_neither_jax_nor_reference(module):
    """The morsel spine and its fault machinery, each imported alone (the
    fault and resilience modules are the port's own copies of the
    reference's jax-free ones)."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.sql.shard",
                                    "repro_torch.sql.calibrate",
                                    "repro_torch.cost.model"])
def test_shard_cost_and_calibration_load_neither_jax_nor_reference(module):
    """Sharding, the cost model and calibration, each imported alone."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.sql.tune",
                                    "repro_torch.sql.server",
                                    "repro_torch.sql.serving",
                                    "repro_torch.sql.result_cache"])
def test_tuner_and_serving_load_neither_jax_nor_reference(module):
    """The tuner and the serving control plane, each imported alone."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["repro_torch.serve.engine",
                                    "repro_torch.launch.serve"])
def test_lm_serving_path_loads_neither_jax_nor_reference(module):
    """The LM scaffold's serving path, each entry imported alone (with
    the configs, models and step builders beneath it), and every arch
    config loaded from the port's own modules."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "from repro_torch.configs.base import all_configs\n"
            "all_configs()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_reference_or_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), \
                f"{path.name}:{node.lineno} imports {name}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_on_a_host_without_cuda(
        monkeypatch):
    _no_cuda(monkeypatch)
    db = TSSB.generate(sf=0.001, seed=0)
    plan = TE.ssb_queries()["q2.1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.run_query(db, plan)
    for strategy in TC.STRATEGIES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.compile_plan(plan, strategy).execute(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.execute_shared([plan], db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.execute_shared_sharded([plan], TSH.shard_database(db, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCAL.measure()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.default_hardware()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THT.build_dim_table(db, plan.joins[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THT.build_dim_partitions(db, plan.joins[0], 2, packed=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.order_by(db.lineorder, "lo_orderdate")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MS.MorselStream(db.lineorder, morsel_bytes=1 << 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.execute_shared_morsels([plan], db, morsel_bytes=1 << 10)


def test_serving_entry_points_without_device_raise(monkeypatch):
    """The server, the serving loop and the tuner run on the card unless
    the caller names the CPU: with no card and no device they raise."""
    from repro_torch.sql import server as TSV
    from repro_torch.sql import serving as TSVG
    from repro_torch.sql import tune as TTN
    _no_cuda(monkeypatch)
    db = TSSB.generate(sf=0.001, seed=0)
    for make in (lambda: TSV.QueryServer(db), lambda: TSVG.ServingLoop(db),
                 TTN.measure, TTN.cached_store, TTN.tuned_r,
                 lambda: TTN.tuned_hardware(TM.HOST)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_lm_entry_points_without_device_raise(monkeypatch):
    """The models, their caches and the batch server run on the card
    unless the caller names the CPU: with no card and no device they
    raise."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import serve as TLS
    from repro_torch.models import api as TA
    from repro_torch.serve.engine import BatchServer
    cfg = smoke_config("qwen2-0.5b")
    params = TA.init(cfg, device="cpu")
    _no_cuda(monkeypatch)
    for make in (lambda: TA.init(cfg), lambda: TA.init_cache(cfg, 1, 8),
                 lambda: TA.from_numpy({}, cfg),
                 lambda: BatchServer(cfg, params),
                 lambda: TLS.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("mode", ["kernel", "auto", "ref"])
def test_mode_contract_on_cpu_tensors(mode):
    """``kernel`` raises on CPU tensors; ``auto`` and ``ref`` run the
    plain version there."""
    c = cases.spja_case(7, 256, 1, 1, "first", 4)
    args, kw = c.args("cpu")
    if mode == "kernel":
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            ops.spja(*args, mode=mode, **kw)
    else:
        out = ops.spja(*args, mode=mode, **kw)
        assert out.device.type == "cpu" and out.dtype == torch.float32


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; only ``ops`` picks the plain
    version for a CPU tensor."""
    args, kw = cases.spja_case(7, 256, 1, 1, "first", 4).args("cpu")
    before = ssb_fused.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ssb_fused.spja(*args, **kw)
    assert ssb_fused.LAUNCHES == before
    calls = [
        (select_scan, "select_scan", cases.select_case(7, 256), ()),
        (select_scan, "select_scan_packed",
         cases.select_packed_case(7, 256, 4), ()),
        (unpack, "unpack", cases.unpack_case(7, 256, 8), ()),
        (hash_join, "probe_join", cases.probe_case(7, 256), ()),
        (project, "project", cases.project_case(7, 256), (1.0, -1.0)),
        (agg, "group_sum", cases.group_case(7, 256, 4), ()),
        (part_probe, "part_probe", cases.part_probe_case(7, 256, 2), ()),
        (hash_join, "probe_agg", cases.probe_agg_case(7, 256), ()),
        (agg, "reduce_sum", cases.reduce_case(7, 256), ()),
        (hash_join, "build", cases.build_case(7, 256), ()),
        (select_scan, "select_scan_sparse",
         cases.sparse_case(7, 256, 0.5), ()),
    ]
    counters = {"probe_agg": "AGG_LAUNCHES", "reduce_sum": "SUM_LAUNCHES",
                "build": "BUILD_LAUNCHES",
                "select_scan_sparse": "SPARSE_LAUNCHES"}
    for mod, fn, case, extra in calls:
        counter = counters.get(fn, "LAUNCHES")
        before = getattr(mod, counter)
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            getattr(mod, fn)(*cases.tensors(case, "cpu"), *extra)
        assert getattr(mod, counter) == before, fn
    args, kw = cases.multi_spja_case(7, 256, 3, 2, 2, 10, pad=1).args("cpu")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        multi_fused.multi_spja(*args, **kw)
    assert multi_fused.LAUNCHES == 0
    assert select_scan.PACKED_LAUNCHES == 0
    keys, vals, start_bit, r = cases.tensors(
        cases.radix_case(7, 256, 0, 8), "cpu")
    for fn, args in (("histogram", (keys, start_bit, r)),
                     ("partition_multi", (keys, vals, start_bit, r)),
                     ("partition", (keys, vals[0], start_bit, r)),
                     ("radix_sort", (keys, vals[0]))):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            getattr(radix_part, fn)(*args)
    assert radix_part.HIST_LAUNCHES == radix_part.SCATTER_LAUNCHES == 0


def test_every_strategy_lowers_sharded_and_auto_too():
    """Every strategy of the reference lowers in the port: ``shared``
    since the shared-scan slice, ``sharded`` and ``auto`` since the
    sharding and cost-model slice; none raises ``NotImplementedError``."""
    plan = TE.ssb_queries()["q1.1"]
    assert not hasattr(TC, "_NOT_PORTED")
    for strategy in TC.STRATEGIES:
        q = TC.compile_plan(plan, strategy)
        want = "opat" if strategy in ("part", "part_loop") else strategy
        assert (q.strategy, q.requested) == (want, strategy)
    for strategy in ("part", "part_loop", "shared", "sharded", "auto"):
        q = TC.compile_plan(TE.ssb_queries()["q2.1"], strategy)
        assert (q.strategy, q.requested, q.fallback_reason) == \
            (strategy, strategy, None)

    def rows():
        return (TE.QueryBuilder("rows").scan("lineorder")
                .where_range("lo_discount", 1, 3))

    # a row plan ending in OrderBy lowers: fused falls back to opat
    ordered = rows().order_by("lo_orderdate").build()
    q = TC.compile_plan(ordered, "fused")
    assert (q.strategy, q.requested) == ("opat", "fused")
    assert q.fallback_reason.startswith("row-returning plan")
    q = TC.compile_plan(ordered, "opat")
    assert (q.strategy, q.fallback_reason) == ("opat", None)
    q = TC.compile_plan(rows().build(), "fused")
    assert (q.strategy, q.requested) == ("opat", "fused")
    assert q.fallback_reason.startswith("row-returning plan")
    q = TC.compile_plan(ordered, "sharded")
    assert (q.strategy, q.requested) == ("opat", "sharded")
    assert q.fallback_reason.startswith("row-returning plan")
    with pytest.raises(ValueError, match="unknown strategy"):
        TC.compile_plan(plan, "bogus")
    q = TC.compile_plan(plan, "fused")
    assert (q.strategy, q.requested, q.fallback_reason) == \
        ("fused", "fused", None)
    q = TC.compile_plan(plan, "opat")
    assert (q.strategy, q.requested, q.fallback_reason) == \
        ("opat", "opat", None)


def test_packed_storage_raises_naming_the_storage_slice():
    """The compressed-storage slice is in: a packed column streams as its
    words (no ``NotImplementedError``), a plain one as its int32 values,
    and a table of neither kind is refused by name."""
    from repro_torch.sql import storage as ST

    class Packed:
        pass

    with pytest.raises(TypeError, match="neither an ssb.Table nor a "
                       "PackedTable"):
        ST.column_stream(Packed(), "lo_revenue", "cpu")
    assert ST.encoded_bounds(None, 3, 9) == (3, 9)
    db = TSSB.generate(sf=0.001, seed=0)
    arr, phys, ref = ST.column_stream(db.lineorder, "lo_revenue", "cpu")
    assert (phys, ref) == (32, 0)
    np.testing.assert_array_equal(arr.numpy(), db.lineorder["lo_revenue"])
    packed = ST.pack_table(db.lineorder)
    words, phys, ref = ST.column_stream(packed, "lo_revenue", "cpu")
    enc = packed.encoding("lo_revenue")
    assert (phys, ref) == (enc.phys, enc.ref) and phys < 32
    np.testing.assert_array_equal(words.numpy(),
                                  packed.columns["lo_revenue"].words)


def test_library_name_follows_the_source_and_every_shared_header(
        tmp_path, monkeypatch):
    """A stale library is never loaded: editing a ``.cu`` or any shared
    ``.cuh`` renames the library it builds to."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = build.library_path("k")
    assert len({first, second, third}) == 3
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert build.names() == ("k",)
