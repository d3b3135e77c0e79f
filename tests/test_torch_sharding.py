"""The port's sharding rules and layouts against the reference's.

* ``tests/test_sharding.py``'s nine cases, mirrored on the port's
  ``spec_for``, each also held equal to the reference's spec on the same
  axis sizes (the port's spec is a tuple, equal to ``tuple(jax_spec)``).
* Every config's ``model_schema`` and ``cache_schema`` at the production
  sizes, ``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``:
  each leaf's shape, logical dims and spec equal the reference's, whose
  side runs on a ``_FakeMesh`` (axis sizes only), as its own tests do.
* On a spawned gloo world of (data 2, model 4) (``tests/_torch_world.py``),
  each rank's local shard of every leaf, by ``ShardingCtx.slices`` and by
  DTensor's ``distribute_tensor`` with ``param_shardings``' placements,
  equals the reference's addressable shard at the same mesh coordinate of
  ``make_host_mesh(2, 4)``; and ``init_params`` on the mesh holds the
  blocks of the one-device ``init_params``, bit for bit.

The ranks import torch and the port only: jax and the reference are
imported inside the tests.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.distribution.sharding import (
    FSDP_RULES, ShardingCtx, make_rules, padded_heads,
    param_shardings, placements_for, resolve_dim, spec_for,
    strip_axes_from_rules,
)
from repro_torch.models.model import build_schedule, cache_schema, \
    model_schema
from repro_torch.models.params import init_params
from repro_torch.models.schema import walk

MESH = {"data": 2, "model": 4}
POD_MESH = {"pod": 2, "data": 2, "model": 2}
PRODUCTION = {"2d": {"data": 16, "model": 16},
              "multi_pod": {"pod": 2, "data": 16, "model": 16}}
WORLD_SHAPE = (2, 4)
WORLD_NAMES = ("data", "model")
WORLD_ARCHS = ("llama3.2-3b", "arctic-480b")


class _FakeMesh:
    """Only axis sizes matter for the reference's spec math."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(tuple(axes.values()))


def _ref_spec(shape, dims, sizes, rules=None):
    from repro.distribution.sharding import spec_for as j_spec_for
    return tuple(j_spec_for(shape, dims, _FakeMesh(**sizes), rules))


def _both(shape, dims, sizes, rules=None):
    """The port's spec, after checking it equals the reference's."""
    got = spec_for(shape, dims, sizes, rules)
    assert got == _ref_spec(shape, dims, sizes, rules), (shape, dims, sizes)
    return got


# ---------------------------------------------------------------------------
# tests/test_sharding.py, mirrored
# ---------------------------------------------------------------------------


def test_divisible_dims_shard():
    assert _both((8, 16), ("batch", "ffn"), MESH) == ("data", "model")


def test_indivisible_dims_replicate():
    # 6 % 4 != 0 -> ffn falls back to replicated; 3 % 2 != 0 -> batch too
    assert _both((3, 6), ("batch", "ffn"), MESH) == ()


def test_axis_used_at_most_once():
    # both dims want 'model'; second falls back
    assert _both((8, 8), ("ffn", "vocab"), MESH) == ("model",)


def test_trailing_nones_trimmed():
    assert _both((8, 16, 32), ("batch", None, None), MESH) == ("data",)


def test_multi_axis_candidates():
    assert _both((8, 4), ("batch", None), POD_MESH) == (("pod", "data"),)
    # batch=6 not divisible by pod*data=4 -> falls to data alone
    assert _both((6, 4), ("batch", None), POD_MESH) == ("data",)


def test_fsdp_variant_uses_whole_mesh():
    rules = make_rules("fsdp")
    assert rules is FSDP_RULES
    assert _both((16, 4), ("batch", None), MESH, rules) == \
        (("data", "model"),)
    assert _both((16, 8), ("vocab", "embed"), MESH, rules) == \
        (None, ("data", "model"))


def test_strip_axes():
    from repro.distribution.sharding import strip_axes_from_rules as j_strip
    stripped = strip_axes_from_rules(("pod",))
    assert "pod" not in str(stripped["batch"])
    assert stripped["stage"] == ()
    assert stripped == j_strip(("pod",))
    assert resolve_dim("batch", 8, POD_MESH, stripped) == "data"


def test_padded_heads():
    from repro.distribution.sharding import padded_heads as j_padded
    mesh = PRODUCTION["2d"]
    for h, want in ((24, 32), (25, 32), (12, 16), (56, 64), (96, 96)):
        assert padded_heads(h, mesh) == want
        assert padded_heads(h, mesh) == j_padded(h, _FakeMesh(**mesh))


def test_production_spec_resolution():
    mesh = PRODUCTION["2d"]
    # whisper's 51865 vocab is not 16-divisible -> replicated; d=768 shards
    assert _both((51865, 768), ("vocab", "embed"), mesh) == (None, "data")
    # nemotron: everything divides
    assert _both((256000, 18432), ("vocab", "embed"), mesh) == \
        ("model", "data")
    # deepseek experts 160 over model
    assert _both((160, 5120, 1536), ("experts", "embed", None), mesh) == \
        ("model", "data")


def test_placements_follow_mesh_order():
    """A dim sharded over two mesh axes gets Shard on both, in mesh order;
    a tuple out of mesh order is refused by name."""
    from torch.distributed.tensor import Replicate, Shard
    assert placements_for((("pod", "data"), None, "model"), POD_MESH) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements_for((), MESH) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        placements_for((("data", "pod"),), POD_MESH)


# ---------------------------------------------------------------------------
# every config's schemas at the production sizes
# ---------------------------------------------------------------------------


def _stacked_leaves(tree, prefix=()):
    """(path, ParamDesc) of a reference schema tree (dicts and tuples)."""
    from repro.distribution.sharding import ParamDesc as JDesc
    if isinstance(tree, JDesc):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _stacked_leaves(tree[k], prefix + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _stacked_leaves(v, prefix + (i,))


def _check_leaf(port, ref, sizes, what):
    assert tuple(port.shape) == tuple(ref.shape), what
    assert tuple(port.dims) == tuple(ref.dims), what
    assert port.dtype == ref.dtype, what
    assert spec_for(port.shape, port.dims, sizes) == \
        _ref_spec(ref.shape, ref.dims, sizes), what


def _port_stacked(cfg, sizes):
    """The port's per-layer schema in the reference's layout: each
    segment's first layer, its leaves stacked over the segment's layers
    (logical dim "layers"); every layer of a segment has the same schema."""
    schema = model_schema(cfg, sizes)
    out = {"embed": schema["embed"], "final_norm": schema["final_norm"]}
    segs, first = [], 0
    for seg in build_schedule(cfg):
        layers = schema["layers"][first:first + seg.count]
        assert all(s == layers[0] for s in layers)
        segs.append({path: dataclasses.replace(
            d, shape=(seg.count,) + d.shape, dims=("layers",) + d.dims)
            for path, d in walk(layers[0])})
        first += seg.count
    if cfg.encoder_layers:
        enc = schema["encoder"]
        out["encoder"] = {
            "final_norm": enc["final_norm"],
            "segments": ({path: dataclasses.replace(
                d, shape=(cfg.encoder_layers,) + d.shape,
                dims=("layers",) + d.dims)
                for path, d in walk(enc["layers"][0])},)}
    out["segments"] = tuple(segs)
    return out


@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_schemas_match_reference_at_production_sizes(arch, mesh):
    from repro.configs import get_config as j_config
    from repro.models.model import cache_schema as j_cache_schema
    from repro.models.model import model_schema as j_model_schema
    sizes = PRODUCTION[mesh]
    cfg, jcfg = ARCHS[arch], j_config(arch)
    ref = j_model_schema(jcfg, _FakeMesh(**sizes))
    port = _port_stacked(cfg, sizes)
    n = 0
    for path, jd in _stacked_leaves(ref):
        if path[0] in ("segments",) or path[:2] == ("encoder", "segments"):
            si = 1 if path[0] == "segments" else 2
            seg = (port["segments"] if si == 1
                   else port["encoder"]["segments"])[path[si]]
            td = seg[tuple(path[si + 1:])]
        else:
            td = port
            for key in path:
                td = td[key]
        _check_leaf(td, jd, sizes, (arch, mesh) + path)
        n += 1
    assert n == sum(1 for _ in _stacked_leaves(ref))
    # caches: a production decode batch and length
    jc = j_cache_schema(jcfg, 128, 4096)
    tc = cache_schema(cfg, 128, 4096)
    assert len(jc) == len(tc)
    for jseg, tseg in zip(jc, tc):
        assert set(jseg) == set(tseg)
        for k in jseg:
            _check_leaf(tseg[k], jseg[k], sizes, (arch, mesh, "cache", k))


# ---------------------------------------------------------------------------
# each rank's shard on a gloo world of (data 2, model 4)
# ---------------------------------------------------------------------------

world = world_fixture(__name__, WORLD_SHAPE, WORLD_NAMES)


def _leaves(arch):
    """(name, ParamDesc) of the port's schema on the world's mesh, in the
    order ``_ref_leaves`` gives the reference's."""
    cfg = get_smoke_config(arch)
    schema = model_schema(cfg, dict(zip(WORLD_NAMES, WORLD_SHAPE)))
    out = [(("embed",) + p, d) for p, d in walk(schema["embed"])]
    for i, layer in enumerate(schema["layers"]):
        out += [(("layers", i) + p, d) for p, d in walk(layer)]
    return out


def _rank_shards(axes, arch, fulls):
    """This rank's shard of every leaf, by slices and by DTensor."""
    from torch.distributed.tensor import distribute_tensor
    shd = ShardingCtx(axes)
    leaves = _leaves(arch)
    out = []
    for (name, d), full in zip(leaves, fulls):
        pl = param_shardings(d, axes)
        by_slice = full[shd.slices(full.shape, spec_for(d.shape, d.dims,
                                                        axes))]
        by_dtensor = distribute_tensor(full, axes.mesh, pl).to_local()
        out.append((by_slice.clone(), by_dtensor))
    return out


def _rank_init(axes, arch):
    """init_params on the mesh against the one-device init's blocks: the
    largest |difference| over all leaves (0 when every layout agrees)."""
    cfg = get_smoke_config(arch)
    shd = ShardingCtx(axes)
    sharded = init_params(cfg, device="cpu", seed=3, shd=shd)
    whole = init_params(cfg, device="cpu", seed=3)
    worst, n = 0.0, 0
    for (name, p), (_, q) in zip(sharded.named_parameters(),
                                 whole.named_parameters()):
        node, key = sharded, name.split(".")
        for k in key[:-1]:
            node = node[int(k)] if k.isdigit() else getattr(node, k)
        blk = q[shd.slices(q.shape, node.spec(key[-1]))] \
            if node.spec(key[-1]) else q
        assert blk.shape == p.shape, name
        worst = max(worst, float((blk.float() - p.float()).abs().max()))
        n += int(p.numel() != q.numel())
    return worst, n


def _ref_leaves(arch):
    """The reference's (path, full array, sharded array) for the leaves of
    ``_leaves``, on ``make_host_mesh(2, 4)``: the stacked leaves split per
    layer (their "layers" dim is never sharded)."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.distribution.sharding import param_shardings as j_shardings
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import build_params, model_schema as j_schema
    mesh = make_host_mesh(*WORLD_SHAPE)
    jcfg = j_smoke(arch)
    params = build_params(jcfg, mesh, jax.random.PRNGKey(0))
    placed = jax.device_put(params, j_shardings(j_schema(jcfg, mesh), mesh))
    cfg = get_smoke_config(arch)
    out = []
    for path, _d in _leaves(arch):
        if path[0] == "embed":
            out.append((params["embed"][path[1]],
                        placed["embed"][path[1]], None))
            continue
        layer, rest = path[1], path[2:]
        first = 0
        for si, seg in enumerate(build_schedule(cfg)):
            if layer < first + seg.count:
                break
            first += seg.count
        node, pnode = params["segments"][si], placed["segments"][si]
        for k in rest:
            node, pnode = node[k], pnode[k]
        out.append((node, pnode, layer - first))
    return mesh, out


@pytest.mark.parametrize("arch", WORLD_ARCHS)
def test_rank_shards_match_reference_addressable_shards(world, arch):
    """Every leaf of the smoke config (llama3.2-3b: data-sharded embed
    rows, model-sharded heads, ffn and vocab; arctic-480b: experts over
    model too) on (data 2, model 4): rank r's block, by slices and by
    DTensor, equals the reference's shard on the device at r's mesh
    coordinate, bit for bit."""
    from repro_torch.models.params import to_torch
    mesh, ref = _ref_leaves(arch)
    fulls = []
    for full, _placed, layer in ref:
        a = np.asarray(full)
        fulls.append(to_torch(a if layer is None else a[layer]))
    outs = world.run(_rank_shards, arch, fulls)
    devices = mesh.devices
    for rank, shards in enumerate(outs):
        coord = np.unravel_index(rank, WORLD_SHAPE)
        dev = devices[coord]
        for (full, placed, layer), (by_slice, by_dtensor), (name, _d) in \
                zip(ref, shards, _leaves(arch)):
            (shard,) = [s for s in placed.addressable_shards
                        if s.device == dev]
            want = np.asarray(shard.data)
            if layer is not None:
                want = want[layer]
            want = to_torch(want)
            assert torch.equal(by_slice, want), (rank, name)
            assert torch.equal(by_dtensor, want), (rank, name)


@pytest.mark.parametrize("arch", ("llama3.2-3b",))
def test_init_params_on_a_mesh_holds_the_one_device_values(world, arch):
    """Every layout draws the same values: each rank's shards equal the
    blocks of the one-device init, and some leaves are split."""
    outs = world.run(_rank_init, arch)
    for worst, split in outs:
        assert worst == 0.0
        assert split > 0


def test_constrain_redistributes_a_dtensor_and_passes_a_tensor():
    """``constrain`` on a DTensor is ``redistribute`` to the placements
    the rules give; on a plain tensor (the port's per-rank shards) it is
    a no-op. A world of one rank, in this process."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distribution.sharding import constrain
    from repro_torch.launch import make_host_mesh
    x = torch.arange(12.0).reshape(4, 3)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        ctx = ShardingCtx(mesh)
        assert ctx.constrain(x, ("batch", None)) is x
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        got = constrain(d, ("batch", "ffn"), mesh)
        assert got.placements == (Shard(0), Shard(1))
        assert torch.equal(got.full_tensor(), x)
        assert ctx.constrain_act(d).placements == (Shard(0), Replicate())
    finally:
        dist.destroy_process_group()


def test_mesh_factories_need_a_world_of_the_mesh_size():
    """The factories raise by name without a world, or with a world of
    another size; the rule math runs on sizes alone."""
    import torch.distributed as dist

    from repro_torch.launch import (
        axis_sizes, data_axes, make_host_mesh, make_production_mesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        make_host_mesh(1, 2, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")
        mesh = make_host_mesh(1, 1, pod=1, device="cpu")
        assert axis_sizes(mesh) == {"pod": 1, "data": 1, "model": 1}
        assert data_axes(mesh) == ("pod", "data")
    finally:
        dist.destroy_process_group()
    assert axis_sizes(PRODUCTION["multi_pod"]) == PRODUCTION["multi_pod"]
    assert data_axes(PRODUCTION["2d"]) == ("data",)
