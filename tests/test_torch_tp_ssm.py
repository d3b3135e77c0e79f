"""The ssm and hybrid families on the model axis against the reference.

mamba2-370m and hymba-1.5b smoke configs on spawned gloo worlds of (data
1, model 2), (data 2, model 2) and (data 1, model 8)
(``tests/_torch_world.py``), one rank a device of the reference's
``make_host_mesh``; helpers in ``tests/_torch_tp_families.py``. Each rank
holds its channels of the SSM path's inner width (``ffn``) and its heads
(``ssm_heads``); the gated RMSNorm sums its squares over ``model``. hymba
adds attention (its 4 query heads pad to 8 on (1, 8)) and a ring cache of
32 slots in its windowed layer, a contiguous chunk of it a rank. A third
config, mamba2 with an SSM head dim of 32 (4 heads against an inner width
of 128), splits the width 8 ways on (1, 8) but not the heads: each rank
gathers the x stream and scans every head. Checks, each with its
tolerance:

* prefill of 40 tokens (past hymba's window of 32) + 8 greedy decode
  steps at f32 (f32 caches): logits within 1e-4, identical tokens;
* bf16 (bf16 caches), teacher-forced with the tokens of the reference
  compiled to round where its source casts: within 2e-2 of max |logit|;
* every rank's parameter shards equal, bit for bit, the reference's
  addressable shards on the serving layout, and its cache blocks (state,
  conv tails, ring k/v) the reference's shards within 1e-4;
* ``gated_norm`` over a width split 2 and 8 ways equals the norm over the
  whole width;
* a ``ServeEngine`` drain of mamba2 and hymba at f32 on (2, 2): identical
  tokens, served tokens and steps;
* at a world of one (in-process gloo): the sharded engine's tokens equal
  the unsharded engine's, with ``chip_smoke.model_psums`` psums a
  forward.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_tp_families import (
    B, NAMES, SOURCE_ROUNDING, cfg_of, check_cache_shards,
    check_param_shards, pair, rank_engine, rank_forward, ref_engine,
    ref_forward, rel, request_table, world1_serve,
)
from _torch_world import World
from repro_torch.distribution.sharding import ShardingCtx

# pytest keeps one module-scoped world per shape alive while the tests on
# it run, grouping tests by the shape's index in this tuple: a test on
# fewer worlds lists them as a prefix of it
SHAPES = ((2, 2), (1, 2), (1, 8))
PROMPT, MAX_SEQ = 40, 64
SPLIT = (("ssm_head_dim", 32),)     # 4 heads, an inner width of 128
CASES = {"mamba2": ("mamba2-370m", ()), "hymba": ("hymba-1.5b", ()),
         "mamba2_heads_whole": ("mamba2-370m", SPLIT)}
# the two cases each world runs (``case`` 0 and 1): hymba's padded heads
# and the whole-heads config on (1, 8)
ON = {(2, 2): ("mamba2", "hymba"), (1, 2): ("mamba2", "hymba"),
      (1, 8): ("hymba", "mamba2_heads_whole")}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request):
    w = World(__name__, request.param, NAMES)
    w.mesh_shape = request.param
    yield w
    procs = list(w.procs)
    w.close()
    assert not any(p.is_alive() for p in procs)


def _prompt():
    return np.random.default_rng(7).integers(0, 256, (B, PROMPT)).astype(
        np.int32)


_RUNS = {}


def _f32_run(world, name):
    shape = world.mesh_shape
    key = (name, shape)
    if key not in _RUNS:
        arch, changes = CASES[name]
        jcfg, tree, ttree = pair(shape, arch, "float32", changes)
        ref = ref_forward(shape, jcfg, tree, _prompt(), MAX_SEQ,
                          cache_dtype="float32")
        ranks = world.run(rank_forward, arch, "float32", changes, ttree,
                          _prompt(), MAX_SEQ, None, None, "float32")
        _RUNS[key] = jcfg, tree, ref, ranks
    return _RUNS[key]


@pytest.mark.parametrize("case", (0, 1))
def test_forward_matches_reference_f32(world, case):
    name = ON[world.mesh_shape][case]
    _jcfg, _tree, (j_logits, j_toks, _c, _r), ranks = _f32_run(world, name)
    for logits, toks, *_ in ranks:
        np.testing.assert_array_equal(toks, j_toks)
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")


@pytest.mark.parametrize("case", (0, 1))
def test_forward_matches_reference_bf16(world, case):
    shape = world.mesh_shape
    name = ON[shape][case]
    arch, changes = CASES[name]
    jcfg, tree, ttree = pair(shape, arch, "bfloat16", changes)
    j_logits, j_toks, _c, _r = ref_forward(
        shape, jcfg, tree, _prompt(), MAX_SEQ, cache_dtype="bfloat16",
        compiler_options=SOURCE_ROUNDING)
    ranks = world.run(rank_forward, arch, "bfloat16", changes, ttree,
                      _prompt(), MAX_SEQ, j_toks, None, "bfloat16")
    for logits, *_ in ranks:
        gaps = [rel(a, b) for a, b in zip(logits, j_logits)]
        assert max(gaps) <= 2e-2, gaps


@pytest.mark.parametrize("case", (0, 1))
def test_shards_match_reference(world, case):
    shape = world.mesh_shape
    name = ON[shape][case]
    arch, changes = CASES[name]
    jcfg, tree, (_l, _t, j_caches, _r), ranks = _f32_run(world, name)
    split = check_param_shards(shape, arch, "float32", changes, tree,
                               [r[3] for r in ranks])
    assert split > 0
    n = check_cache_shards(shape, jcfg, j_caches, [r[2] for r in ranks], B,
                           MAX_SEQ, atol=1e-4)
    assert n == len(ranks) * sum(len(seg) for seg in j_caches)


def test_heads_whole_config_splits_the_width_only():
    """The config of ``SPLIT`` on (1, 8): ``ffn`` resolves to ``model``
    and ``ssm_heads`` does not, as ``resolve_dim`` resolves them apart."""
    cfg = cfg_of("mamba2-370m", "float32", SPLIT)
    shd = ShardingCtx({"data": 1, "model": 8})
    di, nh = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.num_heads(cfg.d_model)
    assert (di, nh) == (128, 4)
    assert shd.split("ffn", di) == "model"
    assert shd.split("ssm_heads", nh) is None


def _rank_norm(axes, x, scale, di):
    from repro_torch.models.ssm import gated_norm
    shd = ShardingCtx(axes)
    n = x.shape[-1] // shd.tp
    lo = shd.index("model") * n
    return gated_norm({"scale": scale}, x[..., lo:lo + n].contiguous(), di,
                      shd, "model")


def test_gated_norm_sums_squares_over_the_model_axis(world):
    """On every world: each rank's channels normalized by the mean square
    over all ``di`` channels (its f32 mean square, weighted by its share,
    summed over ``model``), equal to the one-device norm's block at f32;
    normalizing by the rank's own channels would not be."""
    from repro_torch.models.layers import apply_norm
    rng = np.random.default_rng(2)
    di = 128
    x = torch.from_numpy(rng.standard_normal((2, 3, di)).astype(
        np.float32) * np.linspace(0.1, 3.0, di, dtype=np.float32))
    scale = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    full = apply_norm({"scale": scale}, x, "rmsnorm")
    outs = world.run(_rank_norm, x, scale, di)
    n = di // world.mesh_shape[1]
    model = world.mesh_shape[1]
    for rank, o in enumerate(outs):
        r = rank % model
        block = full[..., r * n:(r + 1) * n]
        torch.testing.assert_close(o, block, rtol=1e-6, atol=1e-6)
        local = apply_norm({"scale": scale[r * n:(r + 1) * n]},
                           x[..., r * n:(r + 1) * n], "rmsnorm")
        assert (local - block).abs().max() > 1e-2


def _drain_requests(arch):
    # hymba: prompts at least its window (ROADMAP R7); mamba2: at least
    # its conv width - 1 (R5)
    return request_table(5, 6, (33, 40) if arch == "hymba-1.5b" else (3, 5))


@pytest.mark.parametrize("world", SHAPES[:1], indirect=True, ids=["2x2"])
@pytest.mark.parametrize("name", ("mamba2", "hymba"))
def test_engine_drain_matches_reference(world, name):
    """Both engines serve six requests (WFQ, prompt-charged buckets, a
    RateController every 4 steps) at f32 on (2, 2), the batch's 4 rows
    split over ``data``: identical tokens, served tokens and decode steps
    on every rank."""
    shape, arch = world.mesh_shape, CASES[name][0]
    jcfg, tree, ttree = pair(shape, arch, "float32")
    ref = ref_engine(shape, jcfg, tree, _drain_requests(arch), MAX_SEQ)
    for port in world.run(rank_engine, arch, ttree, _drain_requests(arch),
                          MAX_SEQ):
        assert port == ref


@pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b"))
def test_sharded_serve_on_a_world_of_one_equals_the_unsharded_engine(arch):
    """``chip_smoke.py``'s world-of-one sharded serve of the ssm and
    hybrid families, on the CPU: the smoke model through ``ServeEngine``
    with ``ShardingCtx(make_host_mesh(1, 1))`` gives the unsharded
    engine's tokens on the same seeded weights, and the CoreEngine's
    ledger holds ``chip_smoke.model_psums`` psums over ``model`` a
    forward (mamba2: 1 + 2 a layer; hymba: 1 + 4 a layer)."""
    got, want, psums, expected = world1_serve(cfg_of(arch, "bfloat16"))
    assert got == want
    assert psums == expected
