"""The ssm family's sharded train step against the reference's GSPMD step,
on the CPU.

mamba2-370m's smoke config (2 layers, 8 SSD heads of 16 over an inner
width of 128) in one spawned gloo world of 8 ranks as (pod 2, data 2,
model 2), with (data 1, model 8) and (data 2, model 4) made over the same
ranks; helpers in ``tests/_torch_mesh_train.py``. Each rank holds its
channels of the inner width and its heads; ``x``, ``w_B``/``w_C``, their
convs and the gated norm's scale enter the split under autograd, and the
norm's sum of squares is a ``psum_partial``. Checked, each with its
tolerance:

* one step under ``"2d"``, ``"fsdp"`` and ``"tp"`` at f32: loss and grad
  norm within 1e-5 relative, every rank's param, ``mu`` and ``nu`` shard
  within 1e-4 of the leaf's max |.| against the reference's block at the
  rank's coordinate (a parameter element also within what that lets
  through Adam's first step, ``_torch_mesh_train.adam_slack``); under
  ``"2d"`` at bf16 within 2e-2 plus twice the leaf's one-device gap to
  the reference (its bf16 noise floor, ROADMAP P5, P19), the reference
  compiled with ``SOURCE_ROUNDING``;
* the gather case: an SSM head dim of 32 (4 heads against 128 channels)
  on (data 1, model 8), where the width splits 8 ways and the heads do
  not: each rank gathers the x stream and scans every head, its heads'
  parameters entering the split; at f32 as above;
* Megatron-SP under ``"2d"`` at f32 and bf16, and in the gather case at
  f32, against the reference's SP step, each within the tolerances
  above: the rows split over model between blocks, gathered for the SSM
  path and reduce-scattered after it, the leaves every rank holds whole
  summed over model after the backward instead of entered;
* ``psum_partial`` alone: ``gated_norm`` over a width split 2 and 8 ways,
  under autograd, gives the one-device norm's input and scale gradients
  within 1e-6 at f32; with ``psum`` (the identity backward) in its place
  it would not;
* checkpoints: a mamba2 one-device save restored onto (data 2, model 4)
  gives every rank its block of every leaf (the SSM heads' and channels'
  dims included) bit for bit; a mamba2 ``Runner`` on the mesh remeshed
  onto (data 2, model 4) restores its saved state and trains on;
* ``state_shardings`` and ``batch_shardings`` of the three families'
  full configs equal the reference's specs leaf by leaf (a stacked
  slot's, ``A_log``/``D``/``dt_bias`` over model, the stacked leaf's).
"""
from __future__ import annotations

import tempfile

import numpy as np
import pytest

from _torch_mesh_train import SHAPE, cfg_of, mesh_axes, local_state, \
    rank_step, step_matches  # noqa: F401  (rank_step: run by the ranks)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

ARCH = "mamba2-370m"
HEADS_WHOLE = (("ssm_head_dim", 32),)
WHOLE_MESH = (1, 8)
RESHARD = (2, 4)
SSM_LEAVES = ("A_log", "ssm.D", "dt_bias", "conv_B", "conv_C", "w_B",
              "w_C", "ssm.norm.scale", "w_x", "w_dt", "w_out")

world = world_fixture(__name__, SHAPE)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def rank_norm_grads(axes, shape, x, scale, g, di, partial):
    """``gated_norm`` on the rank's channels of ``x`` under autograd, on
    ``shape``'s mesh, its output's cotangent the rank's block of ``g``:
    (the input's gradient block, the whole scale's gradient). With
    ``partial`` False the mean square is summed by ``psum`` (whose
    backward is the identity) instead."""
    import torch

    from repro_torch.distribution.sharding import ShardingCtx
    from repro_torch.models.ssm import gated_norm
    shd = ShardingCtx(mesh_axes(axes, shape))
    if not partial:
        shd.psum_partial = shd.psum
    n = di // shd.tp
    lo = shd.index("model") * n
    xl = x[..., lo:lo + n].clone().requires_grad_()
    sc = scale.clone().requires_grad_()
    y = gated_norm({"scale": sc}, xl, di, shd, "model")
    dx, ds = torch.autograd.grad(y, (xl, sc), g[..., lo:lo + n])
    return dx, ds


def rank_reshard(axes, src):
    """Restore the one-device checkpoint in ``src`` onto (data 2, model
    4): (local shards, the restored step)."""
    from repro_torch.configs import RunConfig
    from repro_torch.train import (CheckpointManager, make_train_state,
                                   state_shardings)
    from repro_torch.train.train_loop import train_ctx
    cfg = cfg_of(ARCH, "bfloat16")
    rcfg = RunConfig()
    shd = train_ctx(mesh_axes(axes, RESHARD), rcfg)
    state = make_train_state(cfg, rcfg, device="cpu", abstract=True,
                             shd=shd)
    CheckpointManager(src).restore(
        state, shardings=state_shardings(cfg, rcfg, shd))
    return local_state(state), int(state["step"])


def rank_remesh(axes, d):
    """A mamba2 ``Runner`` on the world's (2, 2, 2) mesh: 2 steps, a save,
    ``remesh`` onto (data 2, model 4), one more step: (the state saved,
    the state restored, both gathered; the final step; the rank's
    ``A_log`` shape after the remesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.models import train_state_to_numpy
    from repro_torch.train import Runner
    cfg = cfg_of(ARCH, "bfloat16")
    r = Runner(cfg, RunConfig(warmup_steps=1, learning_rate=1e-2), axes,
               for_model(cfg, ShapeConfig("t", 40, 8, "train"),
                         device="cpu"), d, device="cpu")
    r.init_state(seed=1)
    r.run(2)
    r.ckpt.save(r.step, r.state, blocking=True, shardings=r.state_sh)
    saved = train_state_to_numpy(r.state, r.cfg)
    r.remesh(init_device_mesh("cpu", RESHARD,
                              mesh_dim_names=("data", "model")))
    restored = train_state_to_numpy(r.state, r.cfg)
    a_log = tuple(r.state["params"].blocks[0]["ssm"]["A_log"].shape)
    return saved, restored, r.run(1)["final_step"], a_log


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,dtype", [
    ("2d", "float32"), ("fsdp", "float32"), ("tp", "float32"),
    ("2d", "bfloat16")])
def test_sharded_step_matches_reference(world, variant, dtype):
    """One step on (pod 2, data 2, model 2) under ``variant``: the SSM
    path's inner width and heads over model ("2d", "tp"), FSDP rows over
    data (and model under "fsdp"); the leaves every rank holds whole
    (``A_log``, ``D``, ``dt_bias`` per head; ``w_B``/``w_C``,
    ``conv_B``/``conv_C``, the norm's scale) summed over the axes they
    are replicated on."""
    step_matches(world, ARCH, dtype, variant, must=SSM_LEAVES)


def test_heads_whole_gathers_the_x_stream(world):
    """(data 1, model 8) with an SSM head dim of 32: ``ffn`` splits the
    128 channels 8 ways, ``ssm_heads`` (4) does not, so every rank
    gathers the post-conv x stream, scans all 4 heads and keeps its
    channels; the gather's backward reduce-scatters the x stream's
    gradient and ``w_dt``, ``dt_bias``, ``A_log`` and ``D`` enter the
    split. Every shard matches the reference at f32."""
    from repro_torch.distribution.sharding import ShardingCtx
    cfg = cfg_of(ARCH, "float32", HEADS_WHOLE)
    shd = ShardingCtx(dict(zip(("data", "model"), WHOLE_MESH)))
    di, nh = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.num_heads(cfg.d_model)
    assert shd.split("ffn", di) == "model"
    assert shd.split("ssm_heads", nh) is None
    step_matches(world, ARCH, "float32", "2d", HEADS_WHOLE, WHOLE_MESH,
                 must=SSM_LEAVES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_step_matches_reference(world, dtype):
    """One step on (pod 2, data 2, model 2) under ``"2d"`` with
    Megatron-SP: the residual stream holds each rank's 20 of 40 rows
    between blocks; the SSM path gathers every row (its conv and scan
    read them all) and reduce-scatters ``w_out``'s partial sums back to
    the rank's rows; ``w_B``/``w_C``, their convs and the gated norm's
    scale are not entered, and their gradients and ``ln1``'s are summed
    over model after the backward (``train_loop.sum_axes``), once."""
    step_matches(world, ARCH, dtype, "2d", must=SSM_LEAVES, sp=True)


def test_sp_heads_whole_gathers_the_x_stream(world):
    """(data 1, model 8) with an SSM head dim of 32 and Megatron-SP: each
    rank's 5 of 40 rows gathered, the post-conv x stream gathered over
    the channels, all 4 heads scanned; ``w_dt``, ``dt_bias``, ``A_log``
    and ``D`` are not entered but summed over model after the backward.
    Every shard matches the reference's SP step at f32."""
    step_matches(world, ARCH, "float32", "2d", HEADS_WHOLE, WHOLE_MESH,
                 must=SSM_LEAVES, sp=True)


@pytest.mark.parametrize("shape", [None, WHOLE_MESH], ids=["model2",
                                                           "model8"])
def test_psum_partial_gives_the_one_device_norm_gradients(world, shape):
    """``gated_norm`` over a width of 128 split over model 2 (the world's
    own mesh) and 8: each rank's input gradient is the one-device
    norm's block and its scale gradient, summed over model by the
    scale's ``enter``, the whole one-device gradient, within 1e-6 at
    f32. With ``psum`` in place of ``psum_partial`` (the identity
    backward) each rank would miss the other ranks' part of the mean
    square's cotangent."""
    import torch

    from repro_torch.models.layers import apply_norm
    rng = np.random.default_rng(2)
    di = 128
    x = torch.from_numpy(rng.standard_normal((2, 3, di)).astype(
        np.float32) * np.linspace(0.1, 3.0, di, dtype=np.float32))
    scale = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, di)).astype(np.float32))
    xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
    dx, ds = torch.autograd.grad(apply_norm({"scale": sr}, xr, "rmsnorm"),
                                 (xr, sr), g)
    model = (shape or SHAPE)[-1]
    n = di // model
    for partial in (True, False):
        outs = world.run(rank_norm_grads, shape, x, scale, g, di, partial)
        gaps = []
        for rank, (gx, gs) in enumerate(outs):
            r = rank % model
            gaps.append(float((gx - dx[..., r * n:(r + 1) * n]).abs().max()))
            if partial:
                torch.testing.assert_close(gs, ds, rtol=1e-6, atol=1e-6)
        if partial:
            assert max(gaps) <= 1e-6, gaps
        else:
            assert max(gaps) > 1e-3, gaps


def test_checkpoint_restores_resharded(world):
    """A one-device mamba2 train state (bf16 params, random f32 moments,
    step 7) saved, then restored onto (data 2, model 4): every rank
    holds its block of every leaf bit for bit: ``w_x``/``w_z``/``conv_x``
    by channel, ``w_dt``/``A_log``/``D``/``dt_bias`` by head, ``w_out``
    by row, each FSDP dim over data."""
    import torch

    from repro_torch.configs import RunConfig
    from repro_torch.distribution.sharding import shard_slices
    from repro_torch.train import (CheckpointManager, make_train_state,
                                   state_shardings)
    cfg, rcfg = cfg_of(ARCH, "bfloat16"), RunConfig()
    state = make_train_state(cfg, rcfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in list(state["opt"]["mu"].values()) + [
                x for v in state["opt"]["nu"].values() for x in v.values()]:
            t.copy_(torch.randn(t.shape, generator=gen))
    state["step"].fill_(7)
    sizes = dict(zip(("data", "model"), RESHARD))
    sh = state_shardings(cfg, rcfg, sizes)
    split = [n for n, s in sh["params"].items() if "model" in s.spec]
    assert any("A_log" in n for n in split) and \
        any("w_x" in n for n in split)
    with tempfile.TemporaryDirectory() as src:
        CheckpointManager(src).save(7, state)
        ranks = world.run(rank_reshard, src)
    for rank, (shards, step) in enumerate(ranks):
        assert step == 7
        coord = dict(zip(("data", "model"), np.unravel_index(rank,
                                                             RESHARD)))

        def block(t, spec):
            return t[shard_slices(tuple(t.shape), spec, sizes, coord)]
        for name, p in state["params"].named_parameters():
            assert torch.equal(shards["params"][name], block(
                p.detach().float(), sh["params"][name].spec)), name
        for name, m in state["opt"]["mu"].items():
            assert torch.equal(shards["mu"][name], block(
                m.float(), sh["opt"]["mu"][name].spec)), name
            for k, v in state["opt"]["nu"][name].items():
                assert torch.equal(shards["nu"][name][k], block(
                    v.float(), sh["opt"]["nu"][name][k].spec)), (name, k)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b",
                                  "whisper-small"])
def test_state_shardings_match_reference(arch):
    """Every leaf's spec of the three families' full configs under the
    three rule variants, at (2, 2, 2) and at the production 2 x 16 x 16,
    against the reference's ``state_shardings``: a per-layer slot's spec
    is the stacked leaf's without its layer entry, a stacked slot's (the
    SSM heads' ``A_log``, ``D``, ``dt_bias`` over model, the norm scales
    whole) the stacked leaf's; the batch's too, ``frames`` included."""
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_config as j_config
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from repro.train.train_loop import state_shardings as j_state_sh
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import opt_slots
    from repro_torch.train import batch_shardings, state_shardings
    from test_torch_train_mesh import _FakeMesh, _per_layer, _ref_leaf, \
        _spec_tree
    split = set()
    for sizes in ({"pod": 2, "data": 2, "model": 2},
                  {"pod": 2, "data": 16, "model": 16}):
        fake = _FakeMesh(sizes)
        for variant in ("2d", "fsdp", "tp"):
            rcfg = RunConfig(rules_variant=variant)
            jrcfg = JRunConfig(rules_variant=variant)
            tcfg, jcfg = get_config(arch), j_config(arch)
            got = state_shardings(tcfg, rcfg, sizes)
            want = _spec_tree(j_state_sh, jcfg, jrcfg, fake)
            for slot in opt_slots(tcfg):
                ref = _per_layer(tuple(_ref_leaf(want["params"],
                                                 slot.ref_path)), slot)
                for name in slot.params:
                    spec = got["params"][name].spec
                    assert ((None,) + spec if slot.stacked and spec
                            else spec) == ref, (sizes, name)
                assert got["opt"]["mu"][slot.name].spec == ref, slot.name
                if slot.stacked and ref:
                    split.add(slot.name.split(".")[-1])
            b = batch_shardings(tcfg, sizes, rcfg=rcfg, global_batch=64)
            jb = _spec_tree(j_batch_sh, jcfg, fake, rcfg=jrcfg,
                            global_batch=64)
            assert {k: v.spec for k, v in b.items()} == \
                {k: tuple(v) for k, v in jb.items()}, (sizes, variant)
    if arch != "whisper-small":
        assert {"A_log", "D", "dt_bias"} <= split, split


def test_runner_remesh_carries_the_ssm_state(world):
    """``Runner`` on the mesh with a mamba2 state: 2 steps on (pod 2, data
    2, model 2), a save, ``remesh`` onto (data 2, model 4) over the same
    ranks: the restored state equals the saved one leaf by leaf (the SSM
    heads' ``A_log`` now 2 of 8 a rank), and training goes on to step 3."""
    from test_torch_train import _leaves_with_paths
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(rank_remesh, d)
    for saved, restored, final, a_log in ranks:
        assert final == 3
        assert a_log == (8 // RESHARD[1],)
        for (path, a), (_, b) in zip(_leaves_with_paths(saved),
                                     _leaves_with_paths(restored)):
            np.testing.assert_array_equal(a, b, err_msg=path)
