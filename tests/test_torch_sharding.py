"""The port's sharding rules and placements on one process, no group.

The rules (``repro_torch.distributed.sharding``) against the reference's
(``repro.distributed.sharding``), leaf by leaf: ``param_pspecs``,
``opt_pspecs`` with and without ZeRO-1, ``batch_pspecs`` and
``cache_pspecs`` of every arch's smoke config on (4, 1), (2, 2) and (2, 4)
``("data", "model")`` meshes at tp = the mesh's "model" size, and of
every full config's abstract shapes at tp 16 on a (16, 16) mesh.  The
reference's rules read only a mesh's names and sizes, so they run on a
``jax.sharding.AbstractMesh`` (no devices), the port's on a
``MeshShape``; a spec is compared as ``tuple(PartitionSpec)``.

The placements: every rank's ``local_block`` of a (2, 4) mesh, each
written into zeros by ``place`` and summed (what ``gather``'s all-reduce
adds), gives the tensor back bit for bit, bf16 included, with dims the
axis does not divide (ceil blocks, the last short or empty); and
``local_block`` -> ``gather`` / ``gather_tree`` on a world of one.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import base as RB
from repro.distributed import sharding as RS
from repro.models import api as RAPI
from repro_torch.configs import base as TB
from repro_torch.distributed import sharding as SH
from repro_torch.models import api

MESHES = [(4, 1), (2, 2), (2, 4)]
NAMES = ("data", "model")
BATCH, SEQ, MAX_LEN = 8, 32, 64


def ref_flat(tree):
    """{key path: tuple(spec)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(k.key) for k in path): tuple(spec)
            for path, spec in flat}


def port_flat(tree):
    return dict(api.leaves(tree))


def ref_batch(cfg, batch, seq):
    return {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
            for k, v in api.abstract_batch(cfg, batch, seq).items()}


def both_specs(arch, sizes, smoke, tp):
    """Every rule's specs, reference and port -> [(rule, ref, port)]."""
    rcfg = (RB.smoke_config if smoke else RB.get_config)(arch)
    tcfg = (TB.smoke_config if smoke else TB.get_config)(arch)
    rmesh = AbstractMesh(sizes, NAMES)
    tmesh = SH.MeshShape(sizes, NAMES)
    rp = RAPI.abstract_params(rcfg)
    tp_tree = api.abstract_params(tcfg)
    rps, tps = RS.param_pspecs(rp, rcfg, tp), SH.param_pspecs(tp_tree, tcfg,
                                                              tp)
    out = [("params", ref_flat(rps), port_flat(tps))]
    for zero1 in (False, True):
        ro = RS.opt_pspecs(rps, rp, rmesh, zero1=zero1)
        to = SH.opt_pspecs(tps, tp_tree, tmesh, zero1=zero1)
        assert sorted(ro) == sorted(to)
        for k in ro:
            want = ref_flat(ro[k]) if k != "step" else {(): tuple(ro[k])}
            got = port_flat(to[k]) if k != "step" else {(): to[k]}
            out.append((f"opt[{k}] zero1={zero1}", want, got))
    batch, seq = (BATCH, SEQ) if smoke else (2 * sizes[0], 4096)
    tb = api.abstract_batch(tcfg, batch, seq)
    out.append(("batch", ref_flat(RS.batch_pspecs(ref_batch(tcfg, batch,
                                                             seq), rmesh)),
                port_flat(SH.batch_pspecs(tb, tmesh))))
    max_len = MAX_LEN if smoke else 8192
    rc = RAPI.abstract_cache(rcfg, batch, max_len)
    tc = api.abstract_cache(tcfg, batch, max_len)
    out.append(("cache", ref_flat(RS.cache_pspecs(rc, rmesh)),
                port_flat(SH.cache_pspecs(tc, tmesh))))
    return out


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_smoke_config_specs_equal_the_reference(arch, sizes):
    for rule, want, got in both_specs(arch, sizes, True, sizes[1]):
        assert want == got, (arch, sizes, rule)


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_full_config_specs_equal_the_reference_at_tp16(arch):
    checked = both_specs(arch, (16, 16), False, 16)
    for rule, want, got in checked:
        assert want == got, (arch, rule)
    # the rules shard something at full width: a spec names "model"
    assert any("model" in SH.spec_axes(s) for s in checked[0][2].values())


def test_uneven_dims_keep_the_references_padded_blocks():
    """503 rows over 2 and 4 ranks: ceil blocks, the last one short."""
    assert [SH.block_range(503, 2, i) for i in range(2)] == \
        [(0, 252), (252, 503)]
    assert [SH.block_range(503, 4, i) for i in range(4)] == \
        [(0, 126), (126, 252), (252, 378), (378, 503)]
    assert [SH.block_range(5, 4, i) for i in range(4)] == \
        [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert SH.block_range(7, 1, 0) == (0, 7)


CASES = [((503, 10), ("model", None)), ((10, 5), ("data", "model")),
         ((5, 503), (None, ("data", "model"))), ((6, 4, 3), (None, None,
                                                             "data")),
         ((4,), (None,)), ((), ())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("shape,spec", CASES)
def test_every_rank_gathers_the_tensor_from_its_group(shape, spec, dtype):
    """``gather`` on a (2, 4) mesh, written out for every rank: the
    ``place`` of each block of its group (the ranks that differ from it
    only along the axes the spec names), added, is the tensor's bits."""
    gen = torch.Generator().manual_seed(7)
    t = (torch.randn(shape, generator=gen) * 100).to(dtype)
    named = SH.spec_axes(spec)
    held = 0
    for d in range(2):
        for m in range(4):
            mesh = SH.MeshShape((2, 4), NAMES, coord=(d, m))
            block = SH.local_block(t, spec, mesh)
            assert tuple(block.shape) == SH.block_shape(shape, spec, mesh)
            held += block.numel()
            total = torch.zeros(shape, dtype=dtype)
            for d2 in (range(2) if "data" in named else (d,)):
                for m2 in (range(4) if "model" in named else (m,)):
                    peer = SH.MeshShape((2, 4), NAMES, coord=(d2, m2))
                    total += SH.place(SH.local_block(t, spec, peer), spec,
                                      peer, shape)
            bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
            view = bits.get(dtype)
            assert torch.equal(total.view(view) if view else total,
                               t.view(view) if view else t)
    copies = 8
    for a in named:
        copies //= {"data": 2, "model": 4}[a]
    # each element is held by the ranks along the axes the spec leaves
    assert held == copies * t.numel()


def test_zero1_block_is_a_block_of_the_param_block():
    """``relative_spec``: ZeRO-1's optimizer block, cut from the param
    block, is the opt spec's block of the whole tensor."""
    cfg = TB.smoke_config("qwen3-moe-30b-a3b")
    full = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    pspecs = SH.param_pspecs(full, cfg, 2)
    ospecs = SH.opt_pspecs(pspecs, full, SH.MeshShape((2, 2), NAMES), True)
    rel = SH.relative_specs(ospecs["m"], pspecs)
    for d in range(2):
        for m in range(2):
            mesh = SH.MeshShape((2, 2), NAMES, coord=(d, m))
            for path, t in api.leaves(full):
                ps, os_, rs = (dict(api.leaves(x))[path]
                               for x in (pspecs, ospecs["m"], rel))
                assert "model" not in SH.spec_axes(rs)
                got = SH.local_block(SH.local_block(t, ps, mesh), rs, mesh)
                assert torch.equal(got, SH.local_block(t, os_, mesh)), path


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_gather_on_a_world_of_one(world_of_one):
    from repro_torch.distributed import mesh as MESH
    mesh = MESH.make_mesh((1, 1), NAMES, device="cpu")
    assert SH.coordinate(mesh) == {"data": 0, "model": 0}
    cfg = TB.smoke_config("mamba2-2.7b")
    full = api.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    full = api.tree_map(lambda t: t.to(torch.bfloat16), full)
    specs = SH.param_pspecs(full, cfg, 1)
    shapes = api.tree_map(lambda t: tuple(t.shape), full)
    blocks = SH.local_tree(full, specs, mesh)
    stats = {}
    got = SH.gather_tree(blocks, specs, mesh, shapes, stats)
    for (path, g), (_, w) in zip(api.leaves(got), api.leaves(full)):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16)), path
        assert torch.equal(SH.gather(SH.local_block(w, ("model",), mesh),
                                     ("model",), mesh, w.shape), w)
    assert stats == {}      # no axis of more than one rank: no collective
    assert SH.dp_axes(mesh) == ("data",) and SH.dp_size(mesh) == 1
