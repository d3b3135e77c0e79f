"""The port's sharded train step against the reference's GSPMD step, on the
CPU.

One spawned gloo world of 8 ranks (``tests/_torch_world.py``) as a
(pod 2, data 2, model 2) ``DeviceMesh``, one rank per device of the
reference's ``make_host_mesh(2, 2, pod=2)`` (the 8 host devices of
``tests/conftest.py``). Other meshes over the same 8 ranks, (data 1,
model 8) and (data 2, model 4), are made inside the world. The ranks
import torch, the port and this module only: jax and the reference are
imported inside the tests.

Both sides start from the reference's ``make_train_state`` on the mesh,
its layer weights rescaled to their true fan-in
(``tests/test_torch_train.py::_rescale``), carried to each rank's shards
by ``train_state_from_jax(..., shd=)``; the batch is the reference's
pipeline's, each rank taking its block (``batch_shardings``). Checked,
each with its tolerance:

* one step under each rule variant ``"2d"``/``"fsdp"``/``"tp"`` at f32
  (and under ``"2d"`` with the factored second moment):
  loss and grad norm within 1e-5 relative, every rank's param, ``mu`` and
  ``nu`` shard within 1e-4 of the max |.| of the reference's addressable
  shard on the device at the rank's mesh coordinate (lr 1e-3, so Adam's
  first step, which moves an element by about lr whatever its gradient,
  stays inside it); at bf16 under ``"2d"`` the loss, the grad norm and
  every shard within 2e-2, the tolerance ``tests/test_torch_train.py``
  holds one-device bf16 gradients to (``nu``, 0.05 g^2 after a step, by
  its square root, on the gradient's scale), the reference compiled to
  round where its source casts (``SOURCE_ROUNDING``);
* under ``"2d"`` with Megatron-SP at bf16 with the settings the reference
  trains models over 100B parameters with (bf16 moments, factored nu,
  bf16 accumulation) at 2 micro-batches: every shard and the grad norm
  within 2e-2 as above but two kv-head moments, held at their measured
  2.24% and 2.19% (``LARGE_GAPS``, ROADMAP P31); not the loss, the last
  micro-batch's, whose rows differ (P25);
* chameleon-34b (vlm, q/k layernorm) under ``"2d"`` with Megatron-SP at
  f32, as above;
* (data 1, model 8): llama's 4 query heads pad to 8; the padded heads'
  ``mu`` (0.1 x the gradient) is exactly zero in ``wq`` and ``wo``, and
  the rest matches the reference at f32 as above;
* ``state_shardings`` and ``batch_shardings`` equal the reference's specs
  leaf by leaf (a per-layer slot's spec is the stacked leaf's without the
  layer entry) for the three variants at (2, 2, 2) and at the production
  2 x 16 x 16;
* ``DataPipeline(shardings=)``: each rank's rows equal the reference's
  addressable block of the same step, bit for bit;
* checkpoints: a one-device save restored onto (data 2, model 4) gives
  every rank its block bit for bit, and that mesh's save writes the same
  files the one-device save wrote.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

SHAPE = (2, 2, 2)                # (pod, data, model)
ARCH = "llama3.2-3b"
RUN = dict(attn_q_block=8, attn_kv_block=8, warmup_steps=1,
           learning_rate=1e-3)
BATCH = (8, 24)                  # global batch, sequence length
PADDED = (1, 8)                  # (data, model): 4 query heads pad to 8
RESHARD = (2, 4)
F32_TOL = {"metric": 1e-5, "shard": 1e-4}
BF16_TOL = {"metric": 2e-2, "shard": 2e-2}
# the optimizer settings of a case (``opt``): the defaults (False), the
# factored second moment (True), and the settings the reference trains
# every model over 100B parameters with (``launch/dryrun.py``'s
# ``run_config_for``: bf16 moments, factored nu, bf16 accumulation), at
# grad_accum 2
OPTS = {False: {}, True: {"factored_nu": True},
        "large": {"factored_nu": True, "moment_dtype": "bfloat16",
                  "grad_accum_dtype": "bfloat16", "grad_accum": 2}}
# the metrics a step reports whatever rows its micro-batches hold; with
# grad_accum > 1 the others are the last micro-batch's, whose rows the
# ranks cut from their own blocks (ROADMAP P25)
STEP_METRICS = ("grad_norm", "lr")
# the two leaves of the "large" case past BF16_TOL's shard bound, each at
# its measured gap (2.24% and 2.19% of the leaf's max): bf16 moments and
# bf16 accumulation round in another order than the reference's, on the
# kv heads whose gradient sums both micro-batches, both ranks' rows and
# the heads' enters (ROADMAP P31)
LARGE_GAPS = {"mu blocks.0.attn.wk": 0.0225, "nu blocks.0.attn.wk vc": 0.0225}

world = world_fixture(__name__, SHAPE)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _cfg(dtype, arch=ARCH):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return cfg


def _mesh_axes(axes, shape):
    """``axes`` itself, or a (data, model) or (pod, data, model) mesh of
    ``shape`` over the same ranks."""
    if shape is None:
        return axes
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.nsm import MeshAxes
    from repro_torch.launch.mesh import AXES, POD_AXES
    return MeshAxes(init_device_mesh(
        "cpu", shape, mesh_dim_names=POD_AXES if len(shape) == 3 else AXES))


def _local_state(state):
    """{"params": {name: shard}, "mu": {slot: shard}, "nu": {slot: {k:
    shard}}} as f32 tensors."""
    def f(t):
        return t.detach().float().clone()
    return {"params": {n: f(p) for n, p in
                       state["params"].named_parameters()},
            "mu": {k: f(v) for k, v in state["opt"]["mu"].items()},
            "nu": {k: {j: f(t) for j, t in v.items()}
                   for k, v in state["opt"]["nu"].items()}}


def _rank_step(axes, dtype, variant, state, batch, shape=None,
               opt=False, sp=False, arch=ARCH):
    """One sharded step of ``arch`` from the carried state (``OPTS[opt]``'s
    optimizer settings, Megatron-SP activations with ``sp``): (metrics,
    local shards)."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import train_state_from_jax
    from repro_torch.train import batch_shardings, make_train_step
    from repro_torch.train.train_loop import train_ctx
    cfg = _cfg(dtype, arch)
    rcfg = RunConfig(rules_variant=variant, seq_parallel_activations=sp,
                     **OPTS[opt], **RUN)
    shd = train_ctx(_mesh_axes(axes, shape), rcfg)
    port = train_state_from_jax(state, cfg, device="cpu", shd=shd)
    bsh = batch_shardings(cfg, shd, rcfg=rcfg, global_batch=BATCH[0])
    rows = {k: v[bsh[k].block(tuple(v.shape))].contiguous()
            for k, v in batch.items()}
    port, metrics = make_train_step(cfg, rcfg, shd)(port, rows)
    return {k: float(v) for k, v in metrics.items()}, _local_state(port)


def _rank_rows(axes, step):
    """This rank's rows of step ``step`` from a pipeline with shardings."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.train import batch_shardings
    cfg = _cfg("bfloat16")
    bsh = batch_shardings(cfg, axes, rcfg=RunConfig(),
                          global_batch=BATCH[0])
    feed = for_model(cfg, ShapeConfig("t", BATCH[1], BATCH[0], "train"),
                     axes, bsh, seed=3, device="cpu")
    return {k: v.clone() for k, v in feed.batch_at(step).items()}


def _rank_reshard(axes, src, dst):
    """Restore the one-device checkpoint in ``src`` onto (data 2, model
    4), then save it from there into ``dst``: (local shards, the
    restored step)."""
    from repro_torch.configs import RunConfig
    from repro_torch.train import (CheckpointManager, make_train_state,
                                   state_shardings)
    from repro_torch.train.train_loop import train_ctx
    cfg = _cfg("bfloat16")
    rcfg = RunConfig()
    shd = train_ctx(_mesh_axes(axes, RESHARD), rcfg)
    state = make_train_state(cfg, rcfg, device="cpu", abstract=True,
                             shd=shd)
    sh = state_shardings(cfg, rcfg, shd)
    _, extras = CheckpointManager(src).restore(state, shardings=sh)
    CheckpointManager(dst).save(int(state["step"]), state, shardings=sh,
                                extras=extras)
    return _local_state(state), int(state["step"])


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


def _jmesh(shape):
    from repro.launch.mesh import make_host_mesh
    return make_host_mesh(*shape[1:], pod=shape[0]) if len(shape) == 3 \
        else make_host_mesh(*shape)


def _ref_state(dtype, shape, opt=False, arch=ARCH):
    """The reference's train state of ``arch`` on ``shape``'s mesh
    (numpy; its moments as ``OPTS[opt]`` keeps them), its layer weights
    rescaled to their true fan-in, and the ranks' copy (torch)."""
    import jax

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_smoke_config as j_smoke
    from repro.train.train_loop import make_train_state as j_make_state
    from repro_torch.launch.mesh import AXES, POD_AXES
    from repro_torch.models import build_schedule, model_schema
    from repro_torch.models.params import to_torch
    from test_torch_train import _rescale
    jcfg = j_smoke(arch)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype="float32",
                                   param_dtype="float32")
    state = jax.tree.map(np.asarray, j_make_state(
        jcfg, JRunConfig(**OPTS[opt], **RUN), _jmesh(shape),
        jax.random.PRNGKey(1)))
    names = POD_AXES if len(shape) == 3 else AXES
    schema = model_schema(_cfg(dtype, arch), dict(zip(names, shape)))
    first = 0
    for seg, stacked in zip(build_schedule(_cfg(dtype, arch)),
                            state["params"]["segments"]):
        _rescale(stacked, schema["layers"][first])
        first += seg.count
    return jcfg, state, jax.tree.map(to_torch, state)


def _ref_batch(jcfg):
    from repro.configs import ShapeConfig as JShape
    from repro.data import for_model as j_for_model
    from repro_torch.models.params import to_torch
    b = j_for_model(jcfg, JShape("t", BATCH[1], BATCH[0], "train"),
                    seed=3).batch_at(0)
    return {k: np.asarray(v) for k, v in b.items()}, \
        {k: to_torch(np.asarray(v)) for k, v in b.items()}


def _ref_step(jcfg, variant, state, batch, shape, compiler=None,
              opt=False, sp=False):
    """One step of the reference's ``make_train_step`` on ``shape``'s mesh
    (``OPTS[opt]``'s optimizer settings, Megatron-SP activations with
    ``sp``), state and batch placed by its own shardings: (new state,
    metrics)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as JRunConfig
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from repro.train.train_loop import make_train_step as j_make_step
    from repro.train.train_loop import state_shardings as j_state_sh
    jrcfg = JRunConfig(rules_variant=variant, seq_parallel_activations=sp,
                       **OPTS[opt], **RUN)
    mesh = _jmesh(shape)
    st = jax.device_put(jax.tree.map(jnp.asarray, state),
                        j_state_sh(jcfg, jrcfg, mesh))
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       j_batch_sh(jcfg, mesh, rcfg=jrcfg,
                                  global_batch=BATCH[0]))
    new, metrics = jax.jit(j_make_step(jcfg, jrcfg, mesh),
                           compiler_options=compiler)(st, b)
    return new, {k: float(v) for k, v in metrics.items()}


def _addressable(arr, shape, rank, layer=None):
    """The reference leaf ``arr``'s shard on the device at rank's mesh
    coordinate, ``[layer]`` of a stacked leaf, as f32."""
    dev = arr.sharding.mesh.devices[np.unravel_index(rank, shape)]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    data = np.asarray(shard.data).astype(np.float32)
    return data if layer is None else data[layer]


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _pairs(tcfg, local, ref_state):
    """(what, the port's local shard, the reference leaf, layer) of every
    param, mu and nu leaf of a rank."""
    from repro_torch.models import opt_slots
    out = []
    for slot in opt_slots(tcfg):
        mu = _ref_leaf(ref_state["opt"]["mu"], slot.ref_path)
        for i, name in enumerate(slot.params):
            layer = i if slot.stacked else slot.layer
            out.append((name, local["params"][name],
                        _ref_leaf(ref_state["params"], slot.ref_path),
                        layer))
        out.append((f"mu {slot.name}", local["mu"][slot.name], mu,
                    slot.layer))
        for k, t in local["nu"][slot.name].items():
            out.append((f"nu {slot.name} {k}", t, _ref_leaf(
                ref_state["opt"]["nu"], slot.ref_path)[k], slot.layer))
    return out


def _check_ranks(ranks, ref_state, ref_metrics, tcfg, shape, tol,
                 keys=("loss", "ce_loss", "z_loss") + STEP_METRICS,
                 pinned=None):
    """Every rank's ``keys`` metrics and every shard within ``tol``;
    ``pinned``: {leaf: its measured gap}, held there instead."""
    for key in keys:
        for metrics, _ in ranks:
            np.testing.assert_allclose(metrics[key], ref_metrics[key],
                                       rtol=tol["metric"], err_msg=key)
    for rank, (_, local) in enumerate(ranks):
        for what, got, ref, layer in _pairs(tcfg, local, ref_state):
            want = _addressable(ref, shape, rank, layer)
            got = got.numpy()
            if what.startswith("nu") and tol is BF16_TOL:
                # a second moment is 0.05 g^2: its square root is on the
                # gradient's scale, which the bf16 tolerance is for
                got, want = np.sqrt(got), np.sqrt(want)
            assert got.shape == want.shape, (rank, what)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got - want).max()) / scale
            bound = (pinned or {}).get(what, tol["shard"])
            assert err <= bound, (rank, what, err)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,dtype,opt,sp", [
    ("2d", "float32", False, False), ("fsdp", "float32", False, False),
    ("tp", "float32", False, False), ("2d", "bfloat16", False, False),
    ("2d", "float32", True, False), ("2d", "float32", False, True),
    ("tp", "float32", False, True), ("2d", "bfloat16", False, True),
    ("2d", "bfloat16", "large", True)])
def test_sharded_step_matches_reference(world, variant, dtype, opt, sp):
    """One step on (pod 2, data 2, model 2) under ``variant``: FSDP rows
    over data (and model under "fsdp"), TP heads/ffn/vocab over model
    ("2d", "tp"), the batch over pod x data (x model under "fsdp"); kv
    heads and norm scales replicated, their gradients summed. With the
    factored second moment (``opt`` True) its means run over dims split
    over data and model. With ``sp`` (Megatron-SP) the residual stream
    holds each rank's 12 of 24 positions between blocks: the embedding's
    and each block's sums reduce-scatter it, each block gathers it, and
    the norms, kv heads' and norm scales' gradients are summed over model
    after the backward. ``opt`` "large" adds bf16 moments, bf16
    accumulation and 2 micro-batches: the step's new state and its
    gradient's norm are held, not the last micro-batch's loss (P25)."""
    from test_torch_train import SOURCE_ROUNDING
    world.spawn()
    jcfg, state, tstate = _ref_state(dtype, SHAPE, opt)
    batch, tbatch = _ref_batch(jcfg)
    ranks, (new, metrics) = world.run_beside(
        lambda: _ref_step(jcfg, variant, state, batch, SHAPE,
                          SOURCE_ROUNDING if dtype == "bfloat16" else None,
                          opt, sp),
        _rank_step, dtype, variant, tstate, tbatch, None, opt, sp)
    accum = OPTS[opt].get("grad_accum", 1) > 1
    _check_ranks(ranks, new, metrics, _cfg(dtype), SHAPE,
                 F32_TOL if dtype == "float32" else BF16_TOL,
                 *([STEP_METRICS, LARGE_GAPS] if accum else []))


def test_sp_step_with_qk_norm_matches_reference(world):
    """chameleon-34b's smoke config (the vlm family, llama's widths with
    q/k layernorm) under ``"2d"`` with Megatron-SP at f32: the q/k norm
    scales, which every model rank holds whole but reads for its own
    heads of its gathered rows, are not entered under SP
    (``ShardingCtx.enter_weight``) and are summed over model after the
    backward (``train_loop.sum_axes``); every shard as in
    ``test_sharded_step_matches_reference``."""
    from repro_torch.models import opt_slots
    arch = "chameleon-34b"
    jcfg, state, tstate = _ref_state("float32", SHAPE, arch=arch)
    batch, tbatch = _ref_batch(jcfg)
    ranks, (new, metrics) = world.run_beside(
        lambda: _ref_step(jcfg, "2d", state, batch, SHAPE, sp=True),
        _rank_step, "float32", "2d", tstate, tbatch, None, False, True,
        arch)
    tcfg = _cfg("float32", arch)
    assert tcfg.family == "vlm" and tcfg.qk_norm
    names = [s.name for s in opt_slots(tcfg)]
    assert any("attn.q_norm" in n for n in names) and \
        any("attn.k_norm" in n for n in names), names
    _check_ranks(ranks, new, metrics, tcfg, SHAPE, F32_TOL)


def test_padded_heads_get_zero_gradient(world):
    """(data 1, model 8): llama's 4 query heads pad to 8, one a rank; ranks
    4-7 hold only padded heads. Their ``wq`` columns and ``wo`` rows have
    zero gradient (``mu`` = 0.1 g exactly 0) on every rank, the real
    heads' do not, and every shard matches the reference at f32."""
    from repro_torch.models import opt_slots
    jcfg, state, tstate = _ref_state("float32", PADDED)
    batch, tbatch = _ref_batch(jcfg)
    ranks, (new, metrics) = world.run_beside(
        lambda: _ref_step(jcfg, "2d", state, batch, PADDED), _rank_step,
        "float32", "2d", tstate, tbatch, PADDED)
    tcfg = _cfg("float32")
    _check_ranks(ranks, new, metrics, tcfg, PADDED, F32_TOL)
    wq = [s.name for s in opt_slots(tcfg) if s.name.endswith("attn.wq")]
    wo = [s.name for s in opt_slots(tcfg) if s.name.endswith("attn.wo")]
    for rank, (_, local) in enumerate(ranks):
        padded = rank >= tcfg.num_heads      # one head a rank
        for name in wq + wo:
            mu = local["mu"][name]
            assert (mu == 0).all().item() == padded, (rank, name)


@pytest.mark.parametrize("variant", ["2d", "fsdp", "tp"])
def test_state_and_batch_shardings_match_reference(variant):
    """Every leaf's spec: the port's per-layer slot against the reference's
    stacked leaf without its layer entry, a stacked slot against the
    whole; at (2, 2, 2) and at the production 2 x 16 x 16, where the 24
    query heads of llama3.2-3b pad to 32."""
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_config as j_config
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from repro.train.train_loop import state_shardings as j_state_sh
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import opt_slots
    from repro_torch.train import batch_shardings, state_shardings

    for sizes in ({"pod": 2, "data": 2, "model": 2},
                  {"pod": 2, "data": 16, "model": 16}):
        fake = _FakeMesh(sizes)
        for factored in (False, True):
            rcfg = RunConfig(rules_variant=variant, factored_nu=factored)
            jrcfg = JRunConfig(rules_variant=variant, factored_nu=factored)
            tcfg, jcfg = get_config(ARCH), j_config(ARCH)
            got = state_shardings(tcfg, rcfg, sizes)
            want = _spec_tree(j_state_sh, jcfg, jrcfg, fake)
            for slot in opt_slots(tcfg):
                ref = tuple(_ref_leaf(want["params"], slot.ref_path))
                ref = _per_layer(ref, slot)
                for name in slot.params:
                    assert got["params"][name].spec == ref, (sizes, name)
                assert got["opt"]["mu"][slot.name].spec == ref, slot.name
                ref_nu = _ref_leaf(want["opt"]["nu"], slot.ref_path)
                assert sorted(got["opt"]["nu"][slot.name]) == sorted(ref_nu)
                for k, sh in got["opt"]["nu"][slot.name].items():
                    assert sh.spec == _per_layer(tuple(ref_nu[k]), slot), \
                        (sizes, slot.name, k)
            assert got["step"].spec == got["opt"]["count"].spec == ()
            for gb in (None, 8, 64):
                b = batch_shardings(tcfg, sizes, rcfg=rcfg, global_batch=gb)
                jb = _spec_tree(j_batch_sh, jcfg, fake, rcfg=jrcfg,
                                global_batch=gb)
                assert {k: v.spec for k, v in b.items()} == \
                    {k: tuple(v) for k, v in jb.items()}, (sizes, gb)


class _FakeMesh:
    """Axis sizes only, as the reference's ``tests/test_sharding.py``
    has it: the production mesh exists only in its dry run."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


def _spec_tree(fn, *args, **kw):
    """``fn``'s tree of ``NamedSharding``s on a ``_FakeMesh``, as a tree of
    ``PartitionSpec``s: the reference's ``NamedSharding`` takes a real
    mesh, so its constructor is swapped for one that keeps the spec."""
    import repro.distribution.sharding as jsh
    import repro.train.train_loop as jtl
    real = jsh.NamedSharding, jtl.NamedSharding
    jsh.NamedSharding = jtl.NamedSharding = lambda mesh, spec: spec
    try:
        return fn(*args, **kw)
    finally:
        jsh.NamedSharding, jtl.NamedSharding = real


def _per_layer(spec, slot):
    """A stacked reference leaf's spec as the port's slot holds it: the
    leading layer entry dropped for a per-layer slot."""
    if slot.layer is None:
        return spec
    spec = list(spec[1:])
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_pipeline_rows_are_the_references_addressable_blocks(world):
    """Steps 0 and 5 at a global batch of 8 over pod x data: each rank's
    tokens and labels are the reference pipeline's shard on the device at
    its coordinate, bit for bit (the ranks of one data block alike)."""
    from repro.configs import RunConfig as JRunConfig
    from repro.configs import ShapeConfig as JShape
    from repro.configs import get_smoke_config as j_smoke
    from repro.data import for_model as j_for_model
    from repro.train.train_loop import batch_shardings as j_batch_sh
    jcfg = j_smoke(ARCH)
    mesh = _jmesh(SHAPE)
    jfeed = j_for_model(jcfg, JShape("t", BATCH[1], BATCH[0], "train"),
                        mesh, j_batch_sh(jcfg, mesh, rcfg=JRunConfig(),
                                         global_batch=BATCH[0]), seed=3)
    for step in (0, 5):
        want = jfeed.batch_at(step)
        ranks = world.run(_rank_rows, step)
        for rank, got in enumerate(ranks):
            assert sorted(got) == sorted(want)
            for k, arr in want.items():
                np.testing.assert_array_equal(
                    got[k].numpy(), _addressable(arr, SHAPE, rank).astype(
                        got[k].numpy().dtype), err_msg=(step, rank, k))
            assert got["tokens"].shape[0] == BATCH[0] // 4


def test_checkpoint_restores_resharded_and_saves_the_same_files(world):
    """A one-device train state (bf16 params, f32 moments, step 7) saved,
    restored onto (data 2, model 4): each rank holds its block of every
    leaf bit for bit; saved from there, the files equal the one-device
    save's byte for byte (the manifest's leaves too), and restore on one
    device gives the state back."""
    import torch

    from repro_torch.configs import RunConfig
    from repro_torch.train import (CheckpointManager, make_train_state,
                                   state_shardings)
    cfg, rcfg = _cfg("bfloat16"), RunConfig()
    state = make_train_state(cfg, rcfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in list(state["opt"]["mu"].values()) + [
                x for v in state["opt"]["nu"].values() for x in v.values()]:
            t.copy_(torch.randn(t.shape, generator=gen))
    state["step"].fill_(7)
    sh = state_shardings(cfg, rcfg, {"data": RESHARD[0],
                                     "model": RESHARD[1]})
    with tempfile.TemporaryDirectory() as src, \
            tempfile.TemporaryDirectory() as dst:
        CheckpointManager(src).save(7, state, extras={"note": 1})
        ranks = world.run(_rank_reshard, src, dst)
        local = {"params": dict(state["params"].named_parameters()),
                 "mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}
        assert any(v.spec for v in sh["params"].values())
        for rank, (shards, step) in enumerate(ranks):
            assert step == 7
            coord = dict(zip(("data", "model"),
                             np.unravel_index(rank, RESHARD)))

            def block(t, spec):
                from repro_torch.distribution.sharding import shard_slices
                return t[shard_slices(tuple(t.shape), spec, {
                    "data": RESHARD[0], "model": RESHARD[1]}, coord)]
            for name, p in local["params"].items():
                want = block(p.detach().float(),
                             sh["params"][name].spec)
                assert torch.equal(shards["params"][name], want), name
            for name, m in local["mu"].items():
                assert torch.equal(shards["mu"][name], block(
                    m.float(), sh["opt"]["mu"][name].spec)), name
                for k, v in local["nu"][name].items():
                    assert torch.equal(shards["nu"][name][k], block(
                        v.float(), sh["opt"]["nu"][name][k].spec))
        names = sorted(os.listdir(os.path.join(src, "step_000000007")))
        assert names == sorted(os.listdir(os.path.join(dst,
                                                       "step_000000007")))
        for name in names:
            with open(os.path.join(src, "step_000000007", name), "rb") as f:
                a = f.read()
            with open(os.path.join(dst, "step_000000007", name), "rb") as f:
                b = f.read()
            if name == "manifest.json":
                a, b = json.loads(a), json.loads(b)
            assert a == b, name
        back = make_train_state(cfg, rcfg, device="cpu", abstract=True)
        CheckpointManager(dst).restore(back)
        for (n, p), (_, q) in zip(back["params"].named_parameters(),
                                  state["params"].named_parameters()):
            assert torch.equal(p, q), n
