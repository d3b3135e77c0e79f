"""The moe family on the model axis against the reference: arctic-480b.

The smoke arctic-480b (GQA, a parallel dense branch, 4 experts top-2) on
spawned gloo worlds of (data 2, model 2), (data 1, model 2) and (data 1,
model 8) (``tests/_torch_world.py``), one rank a device of the
reference's ``make_host_mesh``; helpers and the checks shared with
deepseek-v2-236b (``tests/test_torch_tp_mla.py``) in
``tests/_torch_tp_families.py``. On (2, 2) and (1, 2) each rank holds 2
of the 4 experts (expert parallelism: the router's logits gathered, the
f32 partial combines summed over ``model``); on (1, 8) the experts are
replicated (4 % 8) and the 4 query heads pad to 8. On (2, 2) the
reference routes and truncates each data group alone (``G = data``): the
rows split over ``data``, one group a rank. Checks, each with its
tolerance:

* prefill + 8 greedy decode steps at f32 (f32 caches): logits within
  1e-4, identical tokens and identical routing choices, call by call;
* bf16 (bf16 caches), teacher-forced with the tokens of the reference
  compiled to round where its source casts: within 2e-2 of max |logit|
  of that run or of the reference compiled with XLA's default at every
  step before the first whose routing differs, that step no earlier than
  measured, and the steps from it on within P20's noise floor (ROADMAP
  P20, P21);
* every rank's parameter shards equal, bit for bit, the reference's
  addressable shards on the serving layout, and its cache blocks the
  reference's shards of its final caches within 1e-4;
* ``apply_moe`` on (2, 2) with a capacity factor of 0.5 against the
  reference's: the rows split over ``data`` (B 2: one dispatch group a
  rank) and whole (B 1: every rank routes both groups, which cut the
  sequence), y within 1e-5 and the drop share equal, and unequal to one
  group's; and on a (pod 2, data 2, model 1) world, where a group spans
  two ranks' rows and is gathered;
* a ``ServeEngine`` drain at f32 on (2, 2): identical tokens, served
  tokens and steps;
* at a world of one (in-process gloo): the sharded engine's tokens equal
  the unsharded engine's, with the psums a forward that
  ``chip_smoke.model_psums`` reckons from the layers.
"""
import numpy as np
import pytest
import torch

# the ranks run rank_engine and rank_forward by name from this module
from _torch_threads import one_thread  # noqa: F401
from _torch_tp_families import (  # noqa: F401
    NAMES, cfg_of, check_moe_bf16, check_moe_drain,
    check_moe_f32, check_moe_shards, pair, rank_engine, rank_forward, rel,
    world1_serve,
)
from _torch_world import World
from repro_torch.distribution.sharding import ShardingCtx

ARCH = "arctic-480b"
# pytest keeps one module-scoped world per shape alive while the tests on
# it run, grouping tests by the shape's index in this tuple: a test on
# fewer worlds lists them as a prefix of it
SHAPES = ((2, 2), (1, 2), (1, 8))
DROP_S = 64
DROP_CF = (("capacity_factor", 0.5),)
_RUNS = {}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request):
    w = World(__name__, request.param, NAMES)
    w.mesh_shape = request.param
    yield w
    procs = list(w.procs)
    w.close()
    assert not any(p.is_alive() for p in procs)


def test_forward_matches_reference_f32(world):
    check_moe_f32(world, ARCH, _RUNS)


def test_forward_matches_reference_bf16(world):
    check_moe_bf16(world, ARCH)


def test_shards_match_reference(world):
    check_moe_shards(world, ARCH, _RUNS)


def _rank_apply_moe(axes, arch, tree, x, layer):
    from repro_torch.models.model import _rows
    from repro_torch.models.moe import apply_moe, dispatch_groups
    from repro_torch.models.params import params_from_jax
    shd = ShardingCtx(axes)
    cfg = cfg_of(arch, "float32", DROP_CF)
    model = params_from_jax(tree, cfg, device="cpu", shd=shd)
    rows = _rows(shd, x)
    groups = dispatch_groups(shd, x.shape[0], x.shape[1], rows.shape[0])
    y, aux = apply_moe(model.blocks[layer]["moe"], rows, cfg, shd=shd,
                       groups=groups)
    return y, float(aux["moe_drop_frac"]), groups


@pytest.mark.parametrize("world", SHAPES[:1], indirect=True, ids=["2x2"])
@pytest.mark.parametrize("b", (2, 1), ids=("rows_split", "rows_whole"))
def test_dispatch_groups_match_reference_capacity(world, b):
    """The reference's per-data-group capacity on (2, 2): with B 2 each
    data rank routes its row as one group of 64 tokens; with B 1 every
    rank holds the row and routes its two halves as two groups of 32. y
    within 1e-5 of max |y| and the drop share equal to the reference's
    mean over groups (and unequal to one group's over all tokens)."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.models import moe as jmoe
    from _torch_tp_families import jmesh
    arch, shape = ARCH, world.mesh_shape
    jcfg, tree, ttree = pair(shape, arch, "float32", DROP_CF)
    layer = 0
    p = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                     tree["segments"][0]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (b, DROP_S, jcfg.d_model)).astype(np.float32)
    j_y, j_aux = jax.jit(functools.partial(
        jmoe.apply_moe, cfg=jcfg, shd=JCtx(jmesh(shape)),
        rcfg=JRunConfig()))(p, jnp.asarray(x))
    _y1, one_aux = jax.jit(functools.partial(
        jmoe.apply_moe, cfg=jcfg, shd=JCtx(None), rcfg=JRunConfig()))(
        p, jnp.asarray(x))
    outs = world.run(_rank_apply_moe, arch, ttree, torch.from_numpy(x),
                     layer)
    data, model = shape
    if b % data == 0:
        y = np.concatenate([outs[d * model][0].numpy() for d in range(data)])
        drop = np.mean([outs[d * model][1] for d in range(data)])
        assert all(g.local == 1 and not g.gather for _y, _d, g in outs)
    else:
        y, drop = outs[0][0].numpy(), outs[0][1]
        assert all(g.local == data for _y, _d, g in outs)
    assert rel(y, np.asarray(j_y)) <= 1e-5
    assert abs(drop - float(j_aux["moe_drop_frac"])) <= 1e-6
    assert float(j_aux["moe_drop_frac"]) > 0
    assert abs(float(one_aux["moe_drop_frac"])
               - float(j_aux["moe_drop_frac"])) > 1e-3


def test_dispatch_groups_count():
    """``dispatch_groups``: the reference's G = data, halved until it
    divides the tokens, and the share a rank's rows hold of them."""
    from repro_torch.models.moe import Groups, dispatch_groups
    shd = ShardingCtx({"data": 2, "model": 2})
    assert dispatch_groups(None, 4, 9, 4) == Groups()
    assert dispatch_groups(shd, 4, 1, 2) == Groups(1)   # rows split
    assert dispatch_groups(shd, 1, 14, 1) == Groups(2)  # the sequence halves
    assert dispatch_groups(shd, 1, 9, 1) == Groups(1)   # 9 % 2: G halves to 1
    assert dispatch_groups(ShardingCtx({"data": 4, "model": 1}), 2, 3,
                           2) == Groups(2)              # G 4 -> 2, rows whole
    # rows over pod x data, groups over data: test_dispatch_groups_span_ranks


POD_SHAPE, POD_NAMES = (2, 2, 1), ("pod", "data", "model")


@pytest.fixture
def pod_world():
    w = World(__name__, POD_SHAPE, POD_NAMES)
    yield w
    procs = list(w.procs)
    w.close()
    assert not any(p.is_alive() for p in procs)


def test_dispatch_groups_span_ranks_match_reference(pod_world):
    """A multi-pod mesh (pod 2, data 2, model 1): a batch of 4 rows splits
    over pod x data, a row a rank, while the reference's G = data = 2
    groups hold 2 rows each, so each group spans two ranks (pod-major:
    ranks 0-1 and 2-3). Each rank gathers its group's rows, routes and
    truncates them as one group at a capacity factor of 0.5, and keeps its
    row: every row's y within 1e-5 of max |y| of the reference's
    ``apply_moe`` on ``make_host_mesh(2, 1, pod=2)``, the two groups' drop
    shares' mean equal to the reference's, and unequal to the share of
    one group over all tokens or of a group a rank."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe as jmoe
    from repro_torch.models.moe import _capacity
    arch, layer = ARCH, 0
    jcfg, tree, ttree = pair((2, 1), arch, "float32", DROP_CF)
    p = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                     tree["segments"][0]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (4, DROP_S, jcfg.d_model)).astype(np.float32)
    j_y, j_aux = jax.jit(functools.partial(
        jmoe.apply_moe, cfg=jcfg, shd=JCtx(make_host_mesh(2, 1, pod=2)),
        rcfg=JRunConfig()))(p, jnp.asarray(x))
    outs = pod_world.run(_rank_apply_moe, arch, ttree, torch.from_numpy(x),
                         layer)
    for r, (_y, _d, g) in enumerate(outs):
        assert g.gather == ("pod", "data")
        assert (g.rows, g.mine) == (slice(r // 2 * 2, r // 2 * 2 + 2),
                                    slice(r % 2, r % 2 + 1))
    y = np.concatenate([o[0].numpy() for o in outs])
    assert rel(y, np.asarray(j_y)) <= 1e-5
    drops = [o[1] for o in outs]
    assert drops[0] == drops[1] and drops[2] == drops[3]
    drop = float(j_aux["moe_drop_frac"])
    assert abs((drops[0] + drops[2]) / 2 - drop) <= 1e-6
    # the layouts a port could fall back to truncate other tokens
    tcfg = cfg_of(arch, "float32", DROP_CF)
    assert _capacity(2 * DROP_S, tcfg.moe) != _capacity(DROP_S, tcfg.moe)
    for g in (1, 4):
        _y, aux = jax.jit(functools.partial(
            jmoe.apply_moe, cfg=jcfg,
            shd=JCtx(make_host_mesh(g, 1) if g > 1 else None),
            rcfg=JRunConfig()))(p, jnp.asarray(x))
        assert abs(float(aux["moe_drop_frac"]) - drop) > 1e-3


@pytest.mark.parametrize("world", SHAPES[:1], indirect=True, ids=["2x2"])
def test_engine_drain_matches_reference(world):
    """On (2, 2): the one-request prefills route their sequence's halves
    as the reference's two data groups (14 tokens) or as one (9); each
    decode step's 4 rows split over ``data``, one group a rank."""
    check_moe_drain(world, ARCH)


def test_sharded_serve_on_a_world_of_one_equals_the_unsharded_engine():
    """``chip_smoke.py``'s world-of-one sharded serve, on the CPU: the
    smoke model through ``ServeEngine`` with ``ShardingCtx(make_host_mesh(
    1, 1))`` gives the unsharded engine's tokens on the same seeded
    weights, and the CoreEngine's ledger holds ``chip_smoke.model_psums``
    psums over ``model`` a forward."""
    got, want, psums, expected = world1_serve(cfg_of(ARCH, "bfloat16"))
    assert got == want
    assert psums == expected
