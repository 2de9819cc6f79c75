"""Sharding rules: the reference's DP / TP / EP / SP rules, as rank
placements over a ``DeviceMesh``.

Axis convention (the reference's):
  * "model"             — tensor/expert parallel axis
  * "data" (+ "pod")    — data-parallel axes; batch shards over all of them

A spec is a tuple with one entry a dim: ``None``, an axis name, or a tuple
of names — ``PartitionSpec``'s content with no jax type, normalised as
``PartitionSpec`` normalises it (a one-name tuple is the name).  The rules
(``param_pspecs``, ``zero1_pspecs``, ``opt_pspecs``, ``batch_pspecs``,
``cache_pspecs``) are the reference's, name for name and branch for
branch; they read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or a ``MeshShape`` (the same view with no process group).

PyTorch has no partitioner to lay a global array out by a spec, so a spec
says what a rank *stores*:
  local_block — this rank's block of a whole tensor: each dim a spec
                names is cut into ``ceil(n / k)``-row blocks over the k
                ranks of its axes (GSPMD's padded layout: the last blocks
                may be short or empty when k does not divide n), and the
                rank takes the block of its coordinate;
  gather      — the whole tensor from every rank's block: the block
                written into zeros of the full shape, then one
                ``all_reduce`` over the group of each axis the spec names.
                Adding zeros is exact in every dtype, so a gather gives
                the tensor's bits, bf16 included;
  local_tree, gather_tree — both over a tree; ``gather_tree`` packs the
                leaves of one dtype and one set of axes into one buffer,
                so a tree costs one all-reduce a buffer and axis.

``to_named`` has no counterpart: there is no global array to annotate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import axis_size, axis_sizes, dp_axes
from repro_torch.models.api import leaves, tree_map, tree_map_with_path

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, and optionally a rank's coordinate
    along each axis: what the rules and ``local_block`` read of a
    ``DeviceMesh``, without a process group."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]
    coord: Optional[Tuple[int, ...]] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, (int(s) for s in self.sizes)))


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along each axis of ``mesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
    else:
        coord = mesh.coord
        if coord is None:
            raise ValueError("a MeshShape needs a coord to place blocks")
    return dict(zip(axis_sizes(mesh), (int(c) for c in coord)))


def _spec(*dims) -> Spec:
    """A spec as ``PartitionSpec`` holds it: a one-name tuple is the name,
    an empty tuple is None."""
    out = []
    for d in dims:
        if isinstance(d, (tuple, list)):
            d = tuple(d)
            d = None if not d else d[0] if len(d) == 1 else d
        out.append(d)
    return tuple(out)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis ``spec`` names, in the order it names them."""
    return tuple(a for d in spec for a in _axes_of(d))


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= axis_size(mesh, a)
    return out


def _batch_axis(mesh, b: int):
    """Shard batch over all dp axes when divisible, else leave replicated."""
    return dp_axes(mesh) if b % dp_size(mesh) == 0 else None


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_STACKED_ROOTS = ("layers", "enc_layers", "dec_layers")


def _param_rule(names: Sequence[str], q_ok: bool, kv_ok: bool,
                ssm_ok: bool) -> Optional[Tuple[Optional[str], ...]]:
    """Base partition spec (without the stacked-layer axis).

    Attention is sharded by *heads* only when the head count divides the
    model axis (q_ok / kv_ok); otherwise the projection shards its d_model
    input dim (the Megatron fallback).  Flat-dim sharding that crosses
    head boundaries is never produced.
    """
    name = names[-1]
    in_moe = any(n == "moe" for n in names)
    in_mamba = any(n == "mamba" for n in names)
    if name == "embed":
        return ("model", None)
    if name == "unembed":
        return (None, "model")
    if name == "wq":
        return (None, "model") if q_ok else ("model", None)
    if name in ("wk", "wv"):
        return (None, "model") if kv_ok else ("model", None)
    if name == "wo":
        return ("model", None)
    if name == "bq":
        return ("model",) if q_ok else (None,)
    if name in ("bk", "bv"):
        return ("model",) if kv_ok else (None,)
    if name in ("q_norm", "k_norm"):
        return (None,)
    if name == "router":
        return (None, None)
    if name in ("w_gate", "w_up"):
        return ("model", None, None) if in_moe else (None, "model")
    if name == "w_down":
        return ("model", None, None) if in_moe else ("model", None)
    if name in ("z_proj", "x_proj"):
        return (None, "model") if ssm_ok else ("model", None)
    if name in ("b_proj", "c_proj"):
        return (None, None)
    if name == "dt_proj":
        return (None, "model") if ssm_ok else (None, None)
    if name == "conv_x":
        return (None, "model") if ssm_ok else (None, None)
    if name == "conv_x_b":
        return ("model",) if ssm_ok else (None,)
    if name in ("conv_bc", "conv_bc_b"):
        return (None,) * (2 if name == "conv_bc" else 1)
    if name in ("A_log", "dt_bias", "D"):
        return ("model",) if ssm_ok else (None,)
    if name == "norm" and in_mamba:
        return ("model",) if ssm_ok else (None,)
    if name == "out_proj":
        return ("model", None) if ssm_ok else (None, None)
    # norms / scalars / anything else: replicated
    return None


def param_pspecs(params_tree, cfg=None, tp: int = 16) -> Any:
    """Spec tree matching ``params_tree`` (tensors, meta tensors too)."""
    q_ok = bool(cfg and cfg.n_heads % tp == 0)
    kv_ok = bool(cfg and cfg.n_kv_heads % tp == 0)
    ssm_ok = bool(cfg and cfg.family in ("ssm", "hybrid")
                  and cfg.ssm_heads % tp == 0 and cfg.d_inner % tp == 0)

    def rule(names, leaf):
        base = _param_rule(names, q_ok, kv_ok, ssm_ok)
        ndim = len(leaf.shape)
        if base is None:
            base = (None,) * ndim
        base = tuple(base)
        if names and names[0] in _STACKED_ROOTS:
            base = (None,) + base
        # pad/trim defensively to leaf rank
        if len(base) < ndim:
            base = base + (None,) * (ndim - len(base))
        base = base[:ndim]
        return _spec(*base)

    return tree_map_with_path(rule, params_tree)


def zero1_pspecs(param_specs, params_tree, mesh) -> Any:
    """ZeRO-1: additionally shard optimizer-state leaves over the dp axes.

    Picks the first unsharded axis divisible by dp_size; falls back to the
    param spec when nothing divides.
    """
    dsize = dp_size(mesh)
    daxes = dp_axes(mesh)

    def rule(spec, leaf):
        dims = list(spec)
        dims += [None] * (len(leaf.shape) - len(dims))
        if set(spec_axes(tuple(dims))) & set(daxes):
            return _spec(*dims)     # already dp-sharded (e.g. fsdp spec)
        for i, (d, n) in enumerate(zip(dims, leaf.shape)):
            if d is None and n % dsize == 0 and n > 0:
                dims[i] = daxes if len(daxes) > 1 else daxes[0]
                return _spec(*dims)
        return _spec(*dims)

    return tree_map(rule, param_specs, params_tree)


def opt_pspecs(param_specs, params_tree, mesh, zero1: bool = False):
    """Specs for the AdamW state {m, v, (master), step}."""
    base = zero1_pspecs(param_specs, params_tree, mesh) if zero1 \
        else param_specs
    out = {"m": base, "v": base, "step": ()}
    if any(leaf.dtype != torch.float32 for _, leaf in leaves(params_tree)):
        out["master"] = base
    return out


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def batch_pspecs(batch_tree, mesh) -> Any:
    def rule(leaf):
        b = leaf.shape[0] if len(leaf.shape) else 1
        ax = _batch_axis(mesh, b)
        rest = (None,) * (len(leaf.shape) - 1)
        return _spec(ax, *rest) if len(leaf.shape) else ()
    return tree_map(rule, batch_tree)


def cache_pspecs(cache_tree, mesh, seq_axis_name: str = "model") -> Any:
    """KV caches: (L,B,S,H,D) -> shard B over dp, S over model.
    SSM states:  ssm (L,B,H,N,P) -> shard H over model.
                 conv_x (L,B,W-1,di) -> shard di over model.
    Hybrid attn caches (slots,B,S,H,D) handled like KV.
    """
    msize = axis_sizes(mesh)["model"]

    def rule(names, leaf):
        name = names[-1] if names else ""
        shp = leaf.shape
        b = shp[1] if len(shp) > 1 else 1
        bax = _batch_axis(mesh, b)
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            # layout (L, B, Hkv, S, D): shard the sequence dim over "model"
            seq = shp[3]
            sax = "model" if seq % msize == 0 else None
            return _spec(None, bax, None, sax, None)
        if name in ("k_scale", "v_scale"):
            seq = shp[3]
            sax = "model" if seq % msize == 0 else None
            return _spec(None, bax, None, sax)
        if name == "ssm":
            h = shp[2]
            hax = "model" if h % msize == 0 else None
            return _spec(None, bax, hax, None, None)
        if name == "conv_x":
            c = shp[3]
            cax = "model" if c % msize == 0 else None
            return _spec(None, bax, None, cax)
        if name == "conv_bc":
            return _spec(None, bax, None, None)
        return _spec(*([None] * len(shp)))

    return tree_map_with_path(rule, cache_tree)


def relative_specs(specs, within) -> Any:
    """``relative_spec`` leaf by leaf."""
    return tree_map(relative_spec, specs, within)


def relative_spec(spec: Spec, within: Spec) -> Spec:
    """The cuts ``spec`` makes beyond ``within``'s: each dim keeps the
    axes ``within`` does not name there.  ZeRO-1's optimizer block is the
    relative spec's block of the param block (``zero1_pspecs`` only adds
    axes to dims the param spec leaves whole)."""
    within = tuple(within) + (None,) * (len(spec) - len(within))
    out = []
    for d, w in zip(spec, within):
        if _axes_of(w) and _axes_of(d) != _axes_of(w):
            raise ValueError(f"{spec} does not refine {within}")
        out.append(None if _axes_of(w) else d)
    return _spec(*out)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def block_range(n: int, k: int, i: int) -> Tuple[int, int]:
    """Rows [start, stop) of block ``i`` of ``k`` over a dim of ``n``:
    blocks of ``ceil(n / k)`` rows, the last ones short or empty."""
    size = -(-n // k) if k > 1 else n
    start = min(i * size, n)
    return start, min(start + size, n)


def _split(entry, sizes: Dict[str, int], coord: Dict[str, int]
           ) -> Tuple[int, int]:
    """(ranks over the dim, this rank's block): a tuple of axes is one
    row-major index over them, as a mesh lays out devices."""
    k, i = 1, 0
    for a in _axes_of(entry):
        k, i = k * sizes[a], i * sizes[a] + coord[a]
    return k, i


def _cuts(shape, spec: Spec, mesh) -> List[Tuple[int, int]]:
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return [block_range(int(n), *_split(d, sizes, coord))
            for n, d in zip(shape, spec)]


def block_shape(full_shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``full_shape``."""
    return tuple(b - a for a, b in _cuts(full_shape, spec, mesh))


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` (a view)."""
    for dim, (a, b) in enumerate(_cuts(t.shape, spec, mesh)):
        if b - a != t.shape[dim]:
            t = t.narrow(dim, a, b - a)
    return t


def place(block: torch.Tensor, spec: Spec, mesh, full_shape,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block`` written at its place in zeros of ``full_shape`` (into
    ``out`` when given, which must hold zeros): one rank's addend of the
    gather's all-reduce."""
    if out is None:
        out = torch.zeros(tuple(full_shape), dtype=block.dtype,
                          device=block.device)
    local_block(out, spec, mesh).copy_(block)
    return out


def _reduce_axes(axes: Iterable[str], mesh) -> Tuple[str, ...]:
    """The named axes with more than one rank, in the mesh's order."""
    axes = set(axes)
    return tuple(a for a, n in axis_sizes(mesh).items()
                 if a in axes and n > 1)


def all_reduce(t: torch.Tensor, mesh, axes: Iterable[str],
               stats: Optional[dict] = None) -> torch.Tensor:
    """Sum ``t`` (contiguous) in place over the ranks of ``axes``: one
    ``all_reduce`` over the group of each axis of more than one rank.
    ``stats``, when given, gains the bytes all-reduced and the
    all-reduces made."""
    axes = _reduce_axes(axes, mesh)
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    if stats is not None:
        stats["bytes"] = stats.get("bytes", 0) + \
            len(axes) * t.numel() * t.element_size()
        stats["all_reduces"] = stats.get("all_reduces", 0) + len(axes)
    return t


def gather(block: torch.Tensor, spec: Spec, mesh, full_shape
           ) -> torch.Tensor:
    """The whole tensor from every rank's ``block``: every rank of the
    axes ``spec`` names must call it."""
    if not _reduce_axes(spec_axes(spec), mesh):
        return block
    out = place(block, spec, mesh, full_shape)
    all_reduce(out, mesh, spec_axes(spec))
    return out


def local_tree(tree, specs, mesh) -> Any:
    """This rank's block of every leaf (views)."""
    return tree_map(lambda t, s: local_block(t, s, mesh), tree, specs)


def gather_tree(blocks, specs, mesh, shapes, stats: Optional[dict] = None
                ) -> Any:
    """Every leaf whole (``shapes``: the full shapes, a tree of tuples),
    the leaves of one dtype and one set of axes packed into one buffer:
    one all-reduce a buffer and axis.  A leaf whose spec names no axis of
    more than one rank is returned as it is.  ``stats``, when given,
    gains the bytes all-reduced and the all-reduces made."""
    flat = list(leaves(blocks))
    spec_of, shape_of = dict(leaves(specs)), dict(leaves(shapes))
    groups: Dict[Tuple, List] = {}
    out_of = {}
    for path, block in flat:
        axes = _reduce_axes(spec_axes(spec_of[path]), mesh)
        if not axes:
            out_of[path] = block
            continue
        groups.setdefault((block.dtype, axes), []).append(path)
    block_of = dict(flat)
    for (dtype, axes), paths in groups.items():
        sizes = [numel(shape_of[p]) for p in paths]
        buf = torch.zeros(sum(sizes), dtype=dtype,
                          device=block_of[paths[0]].device)
        off = 0
        for p, n in zip(paths, sizes):
            view = buf[off:off + n].view(shape_of[p])
            place(block_of[p], spec_of[p], mesh, shape_of[p], out=view)
            out_of[p] = view
            off += n
        all_reduce(buf, mesh, axes, stats)
    return tree_map_with_path(lambda path, _: out_of[path], blocks)


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
