"""The moe family's sharded train step against the reference's GSPMD step,
on the CPU: arctic-480b (GQA, a parallel dense branch).

arctic-480b's smoke config (2 moe layers, 4 experts of 64 top-2, a dense
branch of 128, 4/2 heads) in one spawned gloo world of 8 ranks as (pod 2,
data 2, model 2), with (pod 2, data 1, model 4) and (data 1, model 8)
made over the same ranks; helpers in ``tests/_torch_mesh_train.py``,
deepseek-v2-236b's MLA in ``tests/test_torch_train_mesh_mla.py``. On
(2, 2, 2) the 8 rows split over pod x data, so each of the reference's
``G = data`` dispatch groups spans two ranks' rows (gathered, routed and
truncated as one group); each rank holds 2 of the 4 experts, so the
router's logits are gathered over model, whose transpose (a
reduce-scatter) would count the aux losses' gradient, which every model
rank computes alike, once a rank: ``ShardingCtx.shared`` divides it.
Checked, each with its tolerance:

* one step under ``"2d"``, ``"fsdp"`` and ``"tp"`` at f32, and under
  ``"2d"`` with Megatron-SP activations: loss, grad norm and the four
  ``moe_*`` metrics (the reference's over the global batch) within 1e-5
  relative, every rank's routing choices identical to the reference's
  on the same rows, every param, ``mu`` and ``nu`` shard within 1e-4 of
  the leaf's max |.| against the reference's block at the rank's
  coordinate (a parameter also within ``adam_slack``);
* at bf16 under ``"2d"``, the reference compiled with
  ``SOURCE_ROUNDING``: the routing choices that flip against the
  reference's counted, reported and held to no more than measured
  (``BF16_FLIPS``); with a flip the losses and the grad norm within
  2e-2, with none every shard within 2e-2 plus twice the leaf's
  one-device gap (ROADMAP P21, P26, P27);
* the router's gradient, of the loss and of the aux losses alone, on
  (pod 2, data 2, model 2) and (pod 2, data 1, model 4) (experts split 2
  and 4 ways), within 1e-4 of its max against the reference's
  ``jax.grad``; with ``shared`` made the identity the aux's gradient is
  off by the model axis's size.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_mesh_train import SHAPE, cfg_of, mesh_axes, rank_step, \
    step_matches  # noqa: F401  (rank_step: run by the ranks)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

ARCH = "arctic-480b"
LEAVES = ("moe.router", "moe.w_in", "moe.w_gate", "moe.w_out",
          "moe.dense.w_in", "attn.wq", "attn.wk", "ln1", "ln2")
ROUTER_MESHES = (None, (2, 1, 4))          # experts split 2 and 4 ways
BATCH = (8, 16)
AUX = (1e-2, 1e-3)                         # lb and z weights in the loss
# the routing choices of the ranks' bf16 forward that differ from the
# source-rounded reference's (each rank's calls, 2,048 choices in all),
# measured on the CPU (gloo, 8 ranks): a change that flips more fails
BF16_FLIPS = 0

world = world_fixture(__name__, SHAPE)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def rank_router_grads(axes, arch, state, batch, shape, shared):
    """The router's gradient of the loss and of the aux losses alone, each
    summed over the ranks as the step sums it (``_sync_grads``), on
    ``shape``'s mesh under ``"2d"``; with ``shared`` False,
    ``ShardingCtx.shared`` the identity: {"loss"|"aux": {name: grad}}."""
    import torch

    from _torch_mesh_train import RUN
    from repro_torch.configs import RunConfig
    from repro_torch.models import train_state_from_jax
    from repro_torch.models.model import forward_train
    from repro_torch.train import batch_shardings
    from repro_torch.train.train_loop import (_sync_grads, _trainable,
                                              loss_fn, train_ctx)
    cfg = cfg_of(arch, "float32")
    rcfg = RunConfig(rules_variant="2d", **RUN)
    shd = train_ctx(mesh_axes(axes, shape), rcfg)
    if not shared:
        shd.shared = lambda x, axes: x
    model = train_state_from_jax(state, cfg, device="cpu",
                                 shd=shd)["params"]
    gb = batch["tokens"].shape[0]
    bsh = batch_shardings(cfg, shd, rcfg=rcfg, global_batch=gb)
    rows = {k: v[bsh[k].block(tuple(v.shape))].contiguous()
            for k, v in batch.items()}
    named = [(n, p) for n, p in _trainable(model)
             if n.endswith("moe.router")]
    out = {}
    for what in ("loss", "aux"):
        if what == "loss":
            loss, _ = loss_fn(model, rows, cfg, rcfg, gb)
        else:
            _, aux = forward_train(model, rows, cfg, rcfg, gb)
            loss = AUX[0] * aux["moe_lb_loss"] + AUX[1] * aux["moe_z_loss"]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        with torch.no_grad():
            out[what] = _sync_grads(model, dict(zip(
                [n for n, _ in named], grads)), seq=BATCH[1])
    return out


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


def ref_router_grads(jcfg, state, batch, shape):
    """The reference's gradient of its loss and of its aux losses alone
    on ``shape``'s mesh: {"loss"|"aux": the params' gradient tree}."""
    import jax
    import jax.numpy as jnp

    from _torch_mesh_train import RUN, jmesh
    from repro.configs import RunConfig as JRunConfig
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.distribution.sharding import make_rules
    from repro.models.model import forward_train as j_forward
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from repro.train.train_loop import loss_fn as j_loss
    from repro.train.train_loop import state_shardings as j_state_sh
    jrcfg = JRunConfig(rules_variant="2d", **RUN)
    mesh = jmesh(shape)
    shd = JCtx(mesh, rules=make_rules("2d"))
    params = jax.device_put(jax.tree.map(jnp.asarray, state["params"]),
                            j_state_sh(jcfg, jrcfg, mesh)["params"])
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       j_batch_sh(jcfg, mesh, rcfg=jrcfg,
                                  global_batch=batch["tokens"].shape[0]))

    def loss(p):
        return j_loss(p, b, jcfg, shd, jrcfg)[0]

    def aux(p):
        a = j_forward(p, b, jcfg, shd, jrcfg)[1]
        return AUX[0] * a["moe_lb_loss"] + AUX[1] * a["moe_z_loss"]

    return {k: jax.tree.map(np.asarray, jax.jit(jax.grad(f))(params))
            for k, f in (("loss", loss), ("aux", aux))}


def router_gaps(ranks, ref, tcfg, shape):
    """Each rank's router gradient shard against the reference's block at
    its coordinate, as a share of the reference leaf's max |.|:
    {"loss"|"aux": the largest}."""
    from _torch_mesh_train import ref_block
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import POD_AXES
    from repro_torch.models import opt_slots
    from repro_torch.train import state_shardings
    from test_torch_train_mesh import _ref_leaf
    sh = state_shardings(tcfg, RunConfig(), dict(zip(POD_AXES, shape)))
    gaps = {"loss": 0.0, "aux": 0.0}
    seen = 0
    for slot in opt_slots(tcfg):
        if not slot.name.endswith("moe.router"):
            continue
        for i, name in enumerate(slot.params):
            layer = i if slot.stacked else slot.layer
            spec = sh["params"][name].spec
            for what in gaps:
                leaf = _ref_leaf(ref[what], slot.ref_path)
                scale = float(np.abs(ref_block(leaf, (), shape, 0,
                                               layer)).max())
                for rank, got in enumerate(ranks):
                    want = ref_block(leaf, spec, shape, rank, layer)
                    err = float(np.abs(got[what][name].numpy()
                                       - want).max()) / scale
                    gaps[what] = max(gaps[what], err)
            seen += 1
    assert seen == tcfg.num_layers - tcfg.dense_layer_prefix
    return gaps


def check_router_grads(world, arch, shape):
    """``rank_router_grads`` against ``ref_router_grads`` on ``shape``
    ((pod, data, model); None for the world's own): within 1e-4 with
    ``shared``, the aux's off by more than 1e-2 without it."""
    from _torch_mesh_train import ref_batch, ref_state
    full = shape or SHAPE
    jcfg, state, tstate = ref_state(arch, "float32", (), full)
    nb, tb = ref_batch(jcfg, *BATCH)
    ranks, ref = world.run_beside(
        lambda: ref_router_grads(jcfg, state, nb, full), rank_router_grads,
        arch, tstate, tb, shape, True)
    tcfg = cfg_of(arch, "float32")
    gaps = router_gaps(ranks, ref, tcfg, full)
    assert max(gaps.values()) <= 1e-4, gaps
    ranks = world.run(rank_router_grads, arch, tstate, tb, shape, False)
    gaps = router_gaps(ranks, ref, tcfg, full)
    assert gaps["aux"] > 1e-2, gaps


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,sp", [
    ("2d", False), ("fsdp", False), ("tp", False), ("2d", True)],
    ids=["2d", "fsdp", "tp", "2d-sp"])
def test_sharded_step_matches_reference(world, variant, sp):
    """One f32 step on (pod 2, data 2, model 2) under ``variant``: experts
    over model ("2d", "tp"; replicated under "fsdp"), their ``embed``
    rows over data (and model under "fsdp"), the dispatch groups spanning
    two ranks' rows; with ``sp`` the residual stream holds each rank's 8
    of 16 positions between blocks."""
    step_matches(world, ARCH, "float32", variant, batch=BATCH, must=LEAVES,
                 sp=sp)


def test_sharded_step_bf16(world):
    """One bf16 step under ``"2d"``: the flipped routing choices are
    reported; with none, every shard is held at bf16 (ROADMAP P21)."""
    _, flips = step_matches(world, ARCH, "bfloat16", "2d", batch=BATCH,
                            must=LEAVES)
    print(f"{ARCH} bf16 sharded step: {flips} routing choices flipped")
    assert flips <= BF16_FLIPS, flips


@pytest.mark.parametrize("shape", ROUTER_MESHES, ids=["model2", "model4"])
def test_router_gradient_counts_the_aux_once(world, shape):
    """The router's gradient through the logits' gather: the combine's
    part differs on each model rank and sums to the whole, the aux
    losses' part is the same on every model rank and is divided over
    them, so the reduce-scatter counts it once."""
    check_router_grads(world, ARCH, shape)
