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
             path on the same parameters;
  train_rank    — the sharded AdamW step (``make_train_step(cfg,
             mesh=, zero1=)``) on a (data, model) mesh, each rank's blocks,
             losses and gradient norms held to the single-rank step's
             (``single_rank_train``, which the parent runs and saves);
  compress_rank — ``compressed_psum`` / ``bf16_psum`` over the world,
             beside an f32 ``all_reduce``;
  pipe_rank     — GPipe (``pipeline.make_pipelined_loss``) over a "pipe"
             world: the outputs, the loss and each stage's gradients;
  chain_rank    — several of these bodies in turn on one world.

``recording()`` lists the ``torch.distributed`` calls a block makes: the
training side's paths may call only ``all_reduce`` and ``broadcast``,
the two collectives gloo offers on CUDA tensors.

The device follows the rank (``mesh.rank_device``): the CPU when the spec
names it, else the rank's card.
"""
from __future__ import annotations

import contextlib
import hashlib
import statistics
import subprocess
import time
from typing import Dict, Iterator, List, Optional

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


# ---------------------------------------------------------------------------
# the training side: the sharded step, compression over a group, GPipe
# ---------------------------------------------------------------------------

# every torch.distributed call that moves tensors or objects between ranks
COLLECTIVES = (
    "all_reduce", "all_reduce_coalesced", "broadcast", "reduce",
    "all_gather", "all_gather_into_tensor", "all_gather_single",
    "all_gather_coalesced", "_all_gather_base", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "_reduce_scatter_base", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter",
    "scatter_object_list", "broadcast_object_list", "send", "recv",
    "isend", "irecv", "batch_isend_irecv", "send_object_list",
    "recv_object_list", "barrier", "monitored_barrier")


@contextlib.contextmanager
def recording() -> Iterator[List[str]]:
    """Inside the block every ``torch.distributed`` collective appends
    its name to the yielded list (and still runs)."""
    import torch.distributed.distributed_c10d as c10d
    names: List[str] = []
    saved = []
    for name in COLLECTIVES:
        for mod in (dist, c10d):
            real = getattr(mod, name, None)
            if real is None:
                continue

            def wrapper(*a, _real=real, _name=name, **kw):
                names.append(_name)
                return _real(*a, **kw)
            saved.append((mod, name, real))
            setattr(mod, name, wrapper)
    try:
        yield names
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def digest(t: torch.Tensor) -> str:
    """A tensor's bits, hashed (its dtype and shape included)."""
    a = t.detach().cpu().contiguous()
    raw = a.view(torch.uint8) if a.element_size() == 1 else a.view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()])
    return hashlib.sha256(str((a.dtype, tuple(a.shape))).encode()
                          + raw.numpy().tobytes()).hexdigest()


def train_config(case: dict):
    """A train case's config: its arch's smoke config (``smoke``, default)
    or full config, with ``overrides``."""
    from repro_torch.configs.base import get_config, smoke_config
    cfg = (smoke_config if case.get("smoke", True) else get_config)(
        case["arch"])
    return cfg.replace(**case.get("overrides", {}))


def train_params(case: dict, cfg, device: torch.device):
    """The case's whole initial params on ``device``: ``api.init`` from
    ``seed``, drawn on the host (``init_on`` "host", default) or on the
    device."""
    from repro_torch.models import api
    if case.get("init_on", "host") == "host":
        return api.to(api.init(cfg, torch.Generator().manual_seed(
            case["seed"]), device="cpu"), device)
    return api.init(cfg, torch.Generator(device=device).manual_seed(
        case["seed"]), device=device)


def train_batch(case: dict, cfg, step: int, device: torch.device,
                shard: Optional[int] = None, n_shards: int = 1):
    """Step ``step``'s batch: the whole batch (``shard`` None) or data
    shard ``shard``'s rows of ``n_shards``.  ``tokens`` "seed": drawn from
    ``np.random.default_rng([seed, step])`` and cut by rows; "pipeline":
    each shard a ``TokenPipeline(cfg, data, shard, n_shards)`` of
    batch / n_shards rows (one ``select_scan`` a batch), the whole batch
    their rows in shard order."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    b, seq = case["batch"], case["seq"]
    if case.get("tokens", "seed") == "seed":
        rng = np.random.default_rng([case["seed"], step])
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, seq)).astype(np.int32))
        if shard is not None:
            rows = b // n_shards
            tokens = tokens[shard * rows:(shard + 1) * rows]
        return {"tokens": tokens.to(device)}
    data = DataConfig(seed=case["seed"], batch=b // n_shards, seq=seq)
    shards = range(n_shards) if shard is None else (shard,)
    parts = [TokenPipeline(cfg, data, shard=d, n_shards=n_shards).batch_at(
        step, device=device) for d in shards]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _train_opt(case: dict):
    from repro_torch.train.optim import AdamWConfig
    return AdamWConfig(**case.get("opt", {}))


def single_rank_train(case: dict, device: torch.device, path: str) -> dict:
    """The single-rank step the sharded one is held to, on ``device``:
    the case's steps on the whole batch in dp x ``train_microbatches``
    microbatches (a data shard's microbatches, in shard order), saved to
    ``path`` (``torch.save``: the losses, gradient norms, params and
    opt state on the host).  Returns the losses, norms, step ms and the
    least largest move of a param leaf over the steps."""
    from repro_torch.models import api
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.step import make_train_step
    cfg = train_config(case)
    dp = case["mesh"][0]
    cfg1 = cfg.replace(train_microbatches=dp * cfg.train_microbatches)
    params = train_params(case, cfg, device)
    start = {k: v.detach().to("cpu", copy=True)
             for k, v in api.leaves(params)}
    opt = init_opt_state(params)
    step_fn = make_train_step(cfg1, _train_opt(case))
    batches = [train_batch(case, cfg, k, device, None, dp)
               for k in range(case["steps"])]
    losses, norms, ms = [], [], []
    for batch in batches:
        _sync(device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    moved = min(float((p.detach().cpu().float() - start[k].float())
                      .abs().max()) for k, p in api.leaves(params))
    torch.save({"loss": losses, "grad_norm": norms,
                "params": api.to(params, "cpu"), "opt": api.to(opt, "cpu")},
               path)
    return {"loss": losses, "grad_norm": norms, "step_ms": ms,
            "least_move": moved}


def _excess(got: torch.Tensor, want: torch.Tensor, tol) -> tuple:
    """(max |got - want|, max of |got - want| / (atol + rtol |want| +
    leaf max |want|)); ``tol`` is (rtol, atol) or (rtol, atol, leaf), the
    last a share of the block's largest |want| (default 0)."""
    rtol, atol, leaf = (tuple(tol) + (0.0,))[:3]
    if not got.numel():
        return 0.0, 0.0
    w = want.double()
    d = (got.double() - w).abs()
    floor = atol + leaf * float(w.abs().max())
    return float(d.max()), float((d / (floor + rtol * w.abs())).max())


def _train_case(case: dict, device: torch.device) -> dict:
    """One sharded train case on this rank (see :func:`train_rank`)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import select_scan as SEL
    from repro_torch.models import api
    from repro_torch.train.step import make_train_step, placements, \
        shard_train_state
    cfg = train_config(case)
    zero1 = bool(case.get("zero1"))
    mesh = MESH.make_mesh(case["mesh"], ("data", "model"), device)
    coord = SH.coordinate(mesh)
    dp = SH.dp_size(mesh)
    full = train_params(case, cfg, device)
    params, opt = shard_train_state(full, cfg, mesh, zero1)
    del full
    _, pspecs, ospecs = placements(cfg, mesh, zero1)
    step_fn = make_train_step(cfg, _train_opt(case), mesh=mesh, zero1=zero1)
    res = {"label": case.get("label", case["arch"]),
           "mesh": list(case["mesh"]), "zero1": zero1, "coord": coord,
           "block_bytes": {"params": api.param_bytes(params),
                           "opt": api.param_bytes(opt)}}
    calls = []
    real_select = ops.select_scan

    def recorded(*args, **kw):
        out = real_select(*args, **kw)
        calls.append((args, out))
        return out

    losses, norms, ms, collectives = [], [], [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        res["allocated_before"] = torch.cuda.memory_allocated(device)
    before = launch_counts()
    ops.select_scan = recorded
    try:
        with recording() as names:
            for k in range(case["steps"]):
                # the batch is drawn before the span, as the single-rank
                # step's batches are
                batch = train_batch(case, cfg, k, device,
                                    coord["data"], dp)
                stats: Dict[str, dict] = {}
                _align(device)
                t0 = time.perf_counter()
                params, opt, metrics = step_fn(params, opt, batch, stats)
                _sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                collectives.append(stats)
    finally:
        ops.select_scan = real_select
    after = launch_counts()
    res["launches"] = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
    res["select_scan_calls"] = len(calls)
    res["select_scan_launches"] = res["launches"].get(
        "select_scan.LAUNCHES", 0)
    res["select_scan_ok"] = all(
        torch.equal(kept, w_kept) and int(count) == int(w_count)
        for (x, y, lo, hi), (kept, count) in calls
        for w_kept, w_count in [ref.select_scan(x, y, lo, hi)])
    res["collectives"] = sorted(set(names))
    res.update(loss=losses, grad_norm=norms, step_ms=ms,
               stats=collectives)
    if device.type == "cuda":
        res["peak_allocated"] = torch.cuda.max_memory_allocated(device)
    want = torch.load(case["want"], mmap=True, weights_only=True)
    tol = case["tol"]
    res["loss_rel"] = max(abs(g - w) / abs(w)
                          for g, w in zip(losses, want["loss"]))
    res["grad_norm_rel"] = max(abs(g - w) / abs(w)
                               for g, w in zip(norms, want["grad_norm"]))
    errs = {}
    trees = [("params", params, want["params"], pspecs)]
    trees += [(k, opt[k], want["opt"][k], ospecs[k])
              for k in ("master", "m", "v") if k in opt]
    for name, got, full_want, specs in trees:
        worst = (0.0, 0.0)
        spec_of = dict(api.leaves(specs))
        want_of = dict(api.leaves(full_want))
        for path, g in api.leaves(got):
            w = SH.local_block(want_of[path], spec_of[path], mesh)
            e = _excess(g.detach(), w.to(device), tol[name])
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        errs[name] = {"max_abs_err": worst[0], "excess": worst[1]}
    res["errors"] = errs
    res["step_equal"] = int(opt["step"]) == int(want["opt"]["step"])
    del params, opt, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def train_rank(spec: dict) -> dict:
    """``spec``: ``device``; ``cases``, each a dict: ``arch``, ``smoke``
    (its smoke config, default), ``overrides``, ``mesh`` (data, model),
    ``zero1``, ``seed``, ``init_on``, ``tokens`` ("seed" or "pipeline"),
    ``batch`` and ``seq`` (the whole batch), ``steps``, ``opt``
    (AdamWConfig's fields), ``want`` (the file ``single_rank_train``
    saved) and ``tol`` ({tree: (rtol, atol[, leaf])} for params, master,
    m, v: ``leaf`` a share of the block's largest value).
    Returns, a case, this rank's losses and gradient norms against the
    single-rank step's (relative), each tree's largest error and its
    largest share of the tolerance over the rank's blocks, the
    collectives the steps called, each step's ms and its collectives'
    bytes and ms, the rank's block bytes, its ``select_scan`` calls held
    to the plain version and the launches."""
    device = MESH.rank_device(spec.get("device"))
    return {"rank": dist.get_rank(), "device": str(device),
            "cases": [_train_case(c, device) for c in spec["cases"]]}


def compress_inputs(n: int, world: int, seed: int):
    """Every rank's gradient (n,) f32 and residual, from ``seed``."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((world, n), dtype=np.float32)
    err = (0.01 * rng.standard_normal((world, n), dtype=np.float32))
    return g, err.astype(np.float32)


def compress_rank(spec: dict) -> dict:
    """``spec``: ``device``, ``n``, ``seed``, ``reps``.  Each rank takes
    its row of ``compress_inputs`` and runs ``compressed_psum`` and
    ``bf16_psum`` over the world, and an f32 ``all_reduce`` of the same
    gradient.  Returns each output's digest (every rank's must agree),
    rank 0's outputs, this rank's residual's digest, the collectives, and
    each form's median ms over ``reps`` with its bytes on the wire."""
    from repro_torch.distributed import compression as C
    device = MESH.rank_device(spec.get("device"))
    world, rank = dist.get_world_size(), dist.get_rank()
    g, err = compress_inputs(spec["n"], world, spec["seed"])
    g = torch.from_numpy(g[rank]).to(device)
    err = torch.from_numpy(err[rank]).to(device)
    group = dist.group.WORLD
    with recording() as names:
        out, new_err = C.compressed_psum(g, err, group)
        b16 = C.bf16_psum(g, group)
    res = {"rank": rank, "collectives": sorted(set(names)),
           "digest": {"compressed": digest(out), "bf16": digest(b16),
                      "new_err": digest(new_err)}}
    if rank == 0:
        res["compressed"] = out.cpu().numpy()
        res["bf16"] = b16.cpu().numpy()
    forms = {"compressed": lambda: C.compressed_psum(g, err, group),
             "bf16": lambda: C.bf16_psum(g, group),
             "f32": lambda: dist.all_reduce(g.clone(), group=group)}
    n = g.numel()
    res["wire_bytes"] = {"compressed": 4 * n + 4 * world, "bf16": 2 * n,
                         "f32": 4 * n}
    res["ms"] = {}
    for name, fn in forms.items():
        times = []
        for _ in range(spec.get("reps", 3)):
            _align(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        res["ms"][name] = statistics.median(times)
    return res


def pipe_inputs(case: dict):
    """A GPipe case's stacked stage params, input and target, from
    ``seed`` (the reference test's shapes and scales)."""
    s, f, mb, d = case["S"], case["F"], case["MB"], case["D"]
    rng = np.random.default_rng(case["seed"])
    w = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((s, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((f, mb, d)).astype(np.float32)
    tgt = rng.standard_normal((f, mb, d)).astype(np.float32)
    return {"w": w, "b": b}, x, tgt


def pipe_stage(p, h):
    """The reference test's stage: a residual tanh layer."""
    return h + torch.tanh(h @ p["w"] + p["b"])


def pipe_loss(y, t):
    return torch.mean((y - t) ** 2)


def pipe_serial(case: dict):
    """The serial network on the host -> (outputs, loss, the stacked
    stages' grads), numpy: what GPipe is held to."""
    params, x, tgt = pipe_inputs(case)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    h = torch.from_numpy(x)
    for s in range(case["S"]):
        h = pipe_stage({k: v[s] for k, v in p.items()}, h)
    loss = pipe_loss(h, torch.from_numpy(tgt))
    loss.backward()
    return (h.detach().numpy(), float(loss.detach()),
            {k: v.grad.numpy() for k, v in p.items()})


def _pipe_case(case: dict, device: torch.device) -> dict:
    from repro_torch.distributed import pipeline as PL
    params, x, tgt = pipe_inputs(case)
    rank = dist.get_rank()
    mine = {k: torch.from_numpy(v[rank:rank + 1]).to(device)
            .requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(x).to(device)
    tgt = torch.from_numpy(tgt).to(device)
    group = dist.group.WORLD
    busy = [0.0]

    def timed_stage(p, h):
        _sync(device)
        t0 = time.perf_counter()
        out = pipe_stage(p, h)
        _sync(device)
        busy[0] += time.perf_counter() - t0
        return out

    loss_fn = PL.make_pipelined_loss(pipe_stage, pipe_loss, case["S"], group)
    with recording() as names:
        loss = loss_fn(mine, x, tgt)
        loss.backward()
    res = {"rank": rank, "collectives": sorted(set(names)),
           "loss": float(loss.detach()),
           "grads": {k: v.grad.cpu().numpy().copy()
                     for k, v in mine.items()},
           "bubble_fraction": PL.bubble_fraction(case["F"], case["S"])}
    with torch.no_grad():
        y = PL.pipeline_apply(pipe_stage, mine, x, case["S"], group)
    res["digest"] = digest(y)
    if rank == 0:
        res["y"] = y.cpu().numpy()
    if case.get("reps"):
        ticks = case["F"] + case["S"] - 1
        fwd, both, idle = [], [], []
        for _ in range(case["reps"]):
            busy[0] = 0.0
            _align(device)
            t0 = time.perf_counter()
            with torch.no_grad():
                PL.pipeline_apply(timed_stage, mine, x, case["S"], group)
            _sync(device)
            total = time.perf_counter() - t0
            fwd.append(total * 1e3)
            idle.append(1.0 - busy[0] / total)
            for v in mine.values():
                v.grad = None
            _align(device)
            t0 = time.perf_counter()
            loss_fn(mine, x, tgt).backward()
            _sync(device)
            both.append((time.perf_counter() - t0) * 1e3)
        res.update(forward_ms=statistics.median(fwd),
                   tick_ms=statistics.median(fwd) / ticks,
                   forward_backward_ms=statistics.median(both),
                   idle_share=statistics.median(idle))
    return res


def pipe_rank(spec: dict) -> dict:
    """``spec``: ``device``; ``cases``, each a dict: ``S`` (the world
    size), ``F``, ``MB``, ``D``, ``seed`` (``pipe_inputs``) and ``reps``
    (timed runs, or none).  Each rank is stage ``rank``: the pipelined
    loss and its backward (the loss, this stage's gradients, the
    collectives), the forward's digest (rank 0 returns the outputs), and
    when timed the forward's ms, ms a tick and the share of it this
    stage spent outside ``stage_fn``, and the forward and backward's
    ms."""
    device = MESH.rank_device(spec.get("device"))
    return {"rank": dist.get_rank(),
            "cases": [_pipe_case(c, device) for c in spec["cases"]]}


def chain_rank(spec: dict) -> dict:
    """``spec``: ``bodies``, a list of (name, spec) of this module's rank
    bodies, run in turn on one world -> {name: result}."""
    return {name: globals()[name](body) for name, body in spec["bodies"]}
