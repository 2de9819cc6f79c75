"""Process groups and device meshes: the port's counterpart of a JAX mesh.

The reference runs its mesh paths in one process that sees N devices
(``jax.make_mesh``, ``sql.shard.default_mesh``, ``jax.sharding.set_mesh``).
PyTorch's counterpart is N processes in a ``torch.distributed`` process
group, one rank a device, with a ``DeviceMesh`` naming the ranks' axes:

  spawn        — runs a module-level function on ``world`` ranks started
                 from ``multiprocessing``'s spawn context, which rendezvous
                 through a ``file://`` store in a fresh temporary directory
                 (no TCP port to collide with another world), and returns
                 every rank's result.  A rank that raises fails the world
                 with its traceback; a world past its time limit is killed.
  default_mesh — a 1-D ``("data",)`` mesh over the world already running;
                 without a process group it raises (it never gives logical
                 shards in its place).
  make_mesh    — a mesh of any shape over the world, ``jax.make_mesh``'s
                 counterpart.
  backend_for  — NCCL when every rank has a card of its own, gloo when
                 ranks share a card or run on the CPU.  NCCL refuses two
                 ranks on one device, so the choice is made before the
                 group starts, never after a failure.

The device of a rank follows its rank and the caller's ``device``: the CPU
when the caller names it, else card ``local_rank % device_count``.  Gloo
moves CUDA tensors through the host and offers only ``broadcast`` and
``all_reduce`` on them, so every collective of the port is one of those.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SHARD_AXIS = "data"
# seconds a world may run unless the caller says otherwise
TIMEOUT_S = 600.0


def backend_for(devices: Sequence) -> str:
    """The backend for ranks on ``devices`` (one entry a rank): ``nccl``
    when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    if cards and len(cards) == len(devs) and \
            len({d.index for d in cards}) == len(cards):
        return "nccl"
    return "gloo"


def local_rank() -> int:
    """This process's rank among the ranks of its host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device of this rank: the CPU when ``device`` names it, else
    card ``local_rank % device_count`` (raising without a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on the GPU unless "
                           "the caller passes device='cpu'")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "mesh.spawn (or torch.distributed."
                           "init_process_group) before making a mesh")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device=None) -> DeviceMesh:
    """A mesh of ``shape`` over the running world (its product must be
    the world size), axes named ``names``, on this rank's device type.
    Every rank must call it: making a mesh is a collective."""
    world = _world()
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} holds {n} ranks, the world {world}")
    return init_device_mesh(rank_device(device).type, shape,
                            mesh_dim_names=tuple(names))


def default_mesh(n: Optional[int] = None, device=None) -> DeviceMesh:
    """A 1-D ``(SHARD_AXIS,)`` mesh over the whole running world; ``n``,
    when given, must be the world size."""
    world = _world()
    if n is not None and int(n) != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}")
    return make_mesh((world,), (SHARD_AXIS,), device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in ``mesh``."""
    return rank_device(mesh.device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """The number of ranks along each axis of ``mesh``, in its order: a
    ``DeviceMesh`` (``mesh_dim_names`` and a ``shape`` tuple), or a view
    with ``axis_names`` and a ``shape`` dict (``sharding.MeshShape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_size(mesh, name: str = SHARD_AXIS) -> int:
    """The number of ranks along ``mesh``'s axis ``name`` (1 for an axis
    it does not have)."""
    return axis_sizes(mesh).get(name, 1)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: every axis but "model", in the mesh's
    order."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------


class RankError(RuntimeError):
    """A rank of a spawned world raised; the message holds its
    traceback."""


def _child(fn: Callable, rank: int, world: int, backend: str, store: str,
           device, args: Tuple, results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:                   # the host's cores, shared by the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str, *args: Any,
          timeout_s: float = TIMEOUT_S, device=None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks of a new process group ->
    every rank's result, in rank order.

    ``fn`` must be a module-level function (each rank imports it by its
    module path) and return something picklable without CUDA tensors.
    ``backend`` is ``"gloo"`` or ``"nccl"`` (``backend_for``); ``device``
    is ``"cpu"`` for host ranks, else each rank takes its card.  If a rank
    raises, every rank is killed and :class:`RankError` carries that
    rank's traceback; a rank that dies without a word fails the world the
    same way; a world still running after ``timeout_s`` is killed and
    raises ``TimeoutError``."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro-world-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, backend,
                               os.path.join(tmp, "store"),
                               None if device is None else str(device),
                               args, results))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {world} ranks ({backend}) outlived "
                        f"{timeout_s} s and was killed") from None
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if not dead:
                    continue
                try:                # its traceback, if it sent one
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    raise RankError(
                        f"rank {dead[0]} of {world} died (exit code "
                        f"{procs[dead[0]].exitcode})") from None
            if not ok:
                raise RankError(f"rank {rank} of {world} raised:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
