"""Rank bodies: what ``mesh.spawn`` runs on each rank of a world.

Each is a module-level function (a spawned rank imports it by its module
path) that makes its mesh over the running process group, runs the mesh
paths and returns plain host values (numpy arrays, numbers), one dict a
rank:

  sql_rank — the 13 SSB queries (or some) through
             ``compile_plan(plan, strategy).execute`` on a
             ``shard.shard_database(db, mesh)``, run by run (plain or
             packed, resident or in morsels, any mode, over the world or
             over groups of fewer ranks), with each query's answer,
             launches, morsels, times, the rank's device memory and the
             card's; the queries through ``ops.spja(..., group=)`` and
             ``ops.multi_spja(..., group=)`` on the rank's own shard, the
             counterparts of the reference's ``axis_name`` hook; and
             ``calibrate._measure_interconnect`` over groups of ranks;
  moe_rank — ``moe.moe_ffn`` (and ``api.forward`` of a MoE family) under
             ``ctx.use_mesh`` on a (data, model) mesh, beside the local
             path on the same parameters.

The device follows the rank (``mesh.rank_device``): the CPU when the spec
names it, else the rank's card.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as MESH

# the kernel wrapper modules whose ``*LAUNCHES`` counters a run reads
KERNEL_MODULES = ("agg", "hash_join", "multi_fused", "part_probe", "project",
                  "radix_part", "select_scan", "ssb_fused", "unpack")


def launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of this process, ``module.COUNTER``."""
    import importlib
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for attr in dir(mod):
            if attr.endswith("LAUNCHES"):
                out[f"{name}.{attr}"] = int(getattr(mod, attr))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _align(device: torch.device) -> None:
    """Start every rank's next span together: one tiny all-reduce."""
    dist.all_reduce(torch.zeros(1, device=device))
    _sync(device)


def card_used_bytes(device: torch.device) -> Optional[int]:
    """The card's used memory as ``nvidia-smi`` reports it, every
    process's (None off a card)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index}",
         "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return int(out.strip()) << 20


def _database(spec: dict):
    """The spec's database: the one given, else ``ssb.generate(sf,
    seed)`` here -> (db, how, seconds)."""
    from repro_torch.sql import ssb
    if spec.get("db") is not None:
        return spec["db"], "handed over", 0.0
    t0 = time.perf_counter()
    db = ssb.generate(spec["sf"], seed=spec["seed"])
    return db, "generated", time.perf_counter() - t0


def _table_bytes(cache, device: torch.device) -> int:
    seen, total = set(), 0
    for entry in cache.tables.values():
        for t in (entry if isinstance(entry, (tuple, list)) else ()):
            if torch.is_tensor(t) and t.device == device and \
                    id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def _run_queries(run: dict, db, device: torch.device, mesh, rank: int
                 ) -> dict:
    from repro_torch.kernels import ops, ssb_fused
    from repro_torch.sql import engine, morsel
    from repro_torch.sql import hashtable as HT
    from repro_torch.sql import shard as SH
    from repro_torch.sql.compile import compile_plan
    hw = run.get("hw")
    sdb = SH.shard_database(db, mesh, hw=None if hw is None
                            else hw[dist.get_rank()])
    if run.get("resident"):
        sdb.to(device)
    cache = HT.HashTableCache()
    plans = engine.ssb_queries()
    names = run.get("queries") or list(plans)
    budget = run.get("morsel_bytes") or morsel.DEFAULT_MORSEL_BYTES
    mode = run.get("mode", "auto")
    strategy = run.get("strategy", "sharded")
    out = {k: {} for k in ("results", "spja", "morsels", "decided",
                           "predictions", "device_count", "shard_times",
                           "query_ms")}
    before = launch_counts()
    for name in names:
        first = ssb_fused.LAUNCHES
        q = compile_plan(plans[name], strategy)
        out["results"][name] = np.asarray(q.execute(
            sdb, mode=mode, cache=cache, device=device, morsel_bytes=budget))
        out["spja"][name] = ssb_fused.LAUNCHES - first
        out["morsels"][name] = q.n_morsels
        out["decided"][name] = q.decided
        out["predictions"][name] = q.predictions
        out["device_count"][name] = q.device_count
        out["shard_times"][name] = len(q.shard_times_s or ())
    after = launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
    for name in names if run.get("reps") else ():
        times = []
        for _ in range(run["reps"]):
            _align(device)
            t0 = time.perf_counter()
            compile_plan(plans[name], strategy).execute(
                sdb, mode=mode, cache=cache, device=device,
                morsel_bytes=budget)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out["query_ms"][name] = statistics.median(times)
    if run.get("reps"):
        reduce_ms = []
        for name in names:
            grid = torch.zeros(plans[name].n_groups, dtype=torch.int64,
                               device=device)
            _align(device)
            t0 = time.perf_counter()
            ops.reduce_grid(grid, sdb.group)
            _sync(device)
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"] = statistics.median(reduce_ms)
    out["shard_rows"] = int(sdb.bounds[rank + 1] - sdb.bounds[rank])
    out["shard_bytes"] = getattr(sdb.shards[0], sdb.fact).resident_bytes(
        device)
    out["table_bytes"] = _table_bytes(cache, device)
    if device.type == "cuda":   # the allocator's cached blocks go back
        torch.cuda.empty_cache()
        out["reserved_bytes"] = torch.cuda.memory_reserved(device)
    else:
        out["reserved_bytes"] = None
    _align(device)              # every rank holds its shard and tables
    out["card_used_bytes"] = card_used_bytes(device) if rank == 0 else None
    _align(device)
    out["hw"] = sdb.hw
    getattr(sdb.shards[0], sdb.fact).release(device=True)
    return out


def sql_rank(spec: dict) -> dict:
    """``spec``: ``device`` ("cpu" or None for the rank's card); ``db`` (a
    ``Database``) or ``sf`` and ``seed`` to generate one on the rank;
    ``runs``, each a dict: ``label``, ``db`` (this run's own database, in
    place of the spec's), ``pack`` (``storage.pack_database`` first),
    ``resident`` (the rank's shard on its device), ``mode``, ``strategy``
    (default ``sharded``), ``morsel_bytes``, ``queries`` (names; default
    all 13), ``reps`` (timed runs a query after the first), ``hw`` (a
    ``Hardware`` a rank: rank 0's wins), ``ranks`` (the world splits into
    meshes of this many consecutive ranks, each running the run alone;
    default the whole world); ``hooks`` (the ``group=`` hooks,
    :func:`_hooks`); and ``interconnect`` (group sizes: the all-reduce
    rate measured over groups of each size after the runs).  Returns the
    rank's answers and what it counted, run by run."""
    from repro_torch.sql import storage as ST
    device = MESH.rank_device(spec.get("device"))
    mesh = MESH.default_mesh(device=device)
    world = dist.get_world_size()
    db, how, db_s = _database(spec)
    meshes = {world: mesh}
    packed, pack_s = {}, None
    runs = {}
    for run in spec["runs"]:
        data = run.get("db") or db
        if run.get("pack"):
            if id(data) not in packed:
                t0 = time.perf_counter()
                packed[id(data)] = ST.pack_database(data)
                if data is db:
                    pack_s = time.perf_counter() - t0
            data = packed[id(data)]
        size = run.get("ranks") or world
        if size not in meshes:
            meshes[size] = _sub_mesh(size, device)
        sub = meshes[size]
        runs[run["label"]] = _run_queries(
            run, data, device, sub, sub.get_local_rank(MESH.SHARD_AXIS))
    hooks = (_hooks(db, device, mesh, spec.get("mode", "auto"))
             if spec.get("hooks") else None)
    links = []
    for size in spec.get("interconnect") or ():
        if size not in meshes:
            meshes[size] = _sub_mesh(size, device)
        links.append(_interconnect(
            device, meshes[size].get_group(MESH.SHARD_AXIS)))
    return {"rank": dist.get_rank(), "world": world,
            "backend": str(dist.get_backend()), "device": str(device),
            "db": how, "db_s": db_s, "pack_s": pack_s, "runs": runs,
            "hooks": hooks, "interconnect": links}


def _sub_mesh(size: int, device: torch.device):
    """A 1-D mesh over this rank's group of ``size`` consecutive ranks: the
    world splits into such groups, and every rank calls this."""
    from torch.distributed.device_mesh import DeviceMesh
    group, _ = dist.new_subgroups(group_size=size)
    return DeviceMesh.from_group(group, device.type,
                                 mesh_dim_names=(MESH.SHARD_AXIS,))


def _hooks(db, device: torch.device, mesh, mode: str) -> dict:
    """Each of the 13 queries as one ``ops.spja(..., group=)`` call over
    this rank's shard (``compile.fused_inputs``), and the 13 as one wave
    (``compile.shared_params``, one ``ops.multi_spja(..., group=)``) ->
    every answer, f32, after the all-reduce."""
    from repro_torch.kernels import ops
    from repro_torch.sql import engine
    from repro_torch.sql import compile as C
    from repro_torch.sql import shard as SH
    sdb = SH.shard_database(db, mesh)
    own = sdb.shards[0]
    plans = engine.ssb_queries()
    solo = {}
    for name, plan in plans.items():
        args, kw = C.fused_inputs(plan, own, None, device)
        solo[name] = ops.spja(*args, mode=mode, group=sdb.group,
                              **kw).cpu().numpy()
    _, args, kw, n_groups = C.shared_params(list(plans.values()), own,
                                            device=device)
    wave = ops.multi_spja(*args, n_groups=n_groups, mode=mode,
                          group=sdb.group, **kw).cpu().numpy()
    return {"spja": solo,
            "multi_spja": {name: wave[q, :plan.n_groups]
                           for q, (name, plan) in enumerate(plans.items())}}


def _interconnect(device: torch.device, group) -> dict:
    from repro_torch.sql import calibrate
    t0 = time.perf_counter()
    rate = calibrate._measure_interconnect(device, group=group)
    return {"world": dist.get_world_size(group), "rate": rate,
            "backend": calibrate.interconnect_backend(device, group),
            "seconds": time.perf_counter() - t0}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _moe_case(case: dict, device: torch.device) -> dict:
    """One MoE check on this rank (see :func:`moe_rank`)."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.models import api
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import Init, dtype_of
    cfg = (smoke_config if case.get("smoke", True) else get_config)(
        case["arch"])
    dt = dtype_of(cfg.param_dtype)
    mesh = MESH.make_mesh(case["mesh"], ("data", "model"), device)
    where = device if case.get("params_on") == "card" else \
        torch.device("cpu")
    if case.get("params") is not None:
        p = _tree(case["params"], lambda a: torch.from_numpy(
            np.array(a)).to(where))
        x = torch.from_numpy(np.array(case["x"])).to(where)
    else:
        gen = torch.Generator(device=where).manual_seed(case["seed"])
        p = MOE.moe_init(Init(gen, where), cfg)
        x = torch.randn(case["batch"], case["seq"], cfg.d_model,
                        generator=gen, device=where).to(dt)
    res = {"arch": case["arch"], "mesh": list(case["mesh"]),
           "dtype": cfg.param_dtype, "local_on": str(where)}
    want, want_aux = MOE._moe_ffn_local(p, cfg, x)      # first call: warm
    _align(device)              # rank 0 times the local path alone
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        MOE._moe_ffn_local(p, cfg, x)
        _sync(where)
        res["local_ms"] = (time.perf_counter() - t0) * 1e3
    _align(device)
    mine = MOE.moe_shard_params(_tree(p, lambda v: v.to(device)), mesh)
    xd = MOE.local_rows(x.to(device), mesh)
    del p                                   # the full expert set
    with use_mesh(mesh):
        MOE.moe_ffn(mine, cfg, xd)          # first call: warm
        _align(device)
        t0 = time.perf_counter()
        got, aux = MOE.moe_ffn(mine, cfg, xd)
        _sync(device)
    res["mesh_ms"] = (time.perf_counter() - t0) * 1e3
    rows = MOE.local_rows(want, mesh)
    res["out"] = got.float().cpu().numpy()
    res["aux"] = float(aux)
    res["local_aux"] = float(want_aux)
    res["max_abs_err"] = float((got.float().cpu()
                                - rows.float().cpu()).abs().max())
    res["local_max_abs"] = float(rows.float().abs().max())
    res["aux_err"] = abs(res["aux"] - res["local_aux"])
    res["expert_bytes"] = sum(mine[k].numel() * mine[k].element_size()
                              for k in ("w_gate", "w_up", "w_down"))
    if case.get("forward"):
        gen = torch.Generator().manual_seed(case["seed"] + 1)
        params = api.init(cfg, gen, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (case["batch"],
                                                   case["seq"]),
                               generator=gen)
        logits, _ = api.forward(params, cfg, {"tokens": tokens})
        sharded = MOE.moe_shard_params(api.to(params, device), mesh)
        with use_mesh(mesh):
            got_l, _ = api.forward(sharded, cfg, {
                "tokens": MOE.local_rows(tokens.to(device), mesh)})
        res["forward_err"] = float(
            (got_l.float().cpu()
             - MOE.local_rows(logits, mesh).float()).abs().max())
    return res


def moe_rank(spec: dict) -> dict:
    """``spec``: ``device``; ``cases``, each a dict: ``arch``, ``smoke``
    (its smoke config, default; else the full config), ``mesh`` (data,
    model), then either ``params`` and ``x`` (numpy: a MoE block's
    parameters, such as the reference's, and the whole batch) or
    ``seed``, ``batch`` and ``seq`` (drawn here in the config's dtype, on
    ``params_on``: the host by default, where the local path then runs,
    or ``"card"``); ``forward`` also runs ``api.forward`` of the config's
    model under the mesh against its local forward on the host.
    Returns, a case, this rank's output rows and aux beside the local
    path's on the same parameters (``max_abs_err``, ``aux_err``), the
    mesh path's ms and (rank 0) the local path's, timed alone."""
    device = MESH.rank_device(spec.get("device"))
    return {"rank": dist.get_rank(), "device": str(device),
            "cases": [_moe_case(case, device) for case in spec["cases"]]}
