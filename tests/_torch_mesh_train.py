"""Helpers of the families' mesh-training tests
(``test_torch_train_mesh_ssm.py``, ``test_torch_train_mesh_hybrid.py``,
``test_torch_train_mesh_encdec.py``).

Each test file opens one spawned gloo world of 8 ranks
(``tests/_torch_world.py``) as a (pod 2, data 2, model 2) ``DeviceMesh``,
one rank per device of the reference's ``make_host_mesh(2, 2, pod=2)``;
other meshes over the same ranks, (data 1, model 8) and (data 2, model
4), are made inside the world. Both sides start from the reference's
``make_train_state`` on the mesh, its layer weights (an encoder's too)
rescaled to their true fan-in, carried to each rank's shards by
``train_state_from_jax(..., shd=)``; the batch is the reference
pipeline's, each rank taking its block (``batch_shardings``). A rank's
functions (``rank_*``) import torch and the port only: everything of jax
and the reference is imported inside the reference-side helpers.
"""
from __future__ import annotations

import functools

import numpy as np

from _torch_tp_families import _changed, cfg_of
from test_torch_train_mesh import _jmesh as jmesh  # noqa: F401
from test_torch_train_mesh import _local_state as local_state
from test_torch_train_mesh import _mesh_axes as mesh_axes
from test_torch_train_mesh import _ref_leaf

SHAPE = (2, 2, 2)                # (pod, data, model)
RUN = dict(attn_q_block=8, attn_kv_block=8, warmup_steps=1,
           learning_rate=1e-3)
F32_TOL = {"metric": 1e-5, "shard": 1e-4}
BF16_TOL = {"metric": 2e-2, "shard": 2e-2}
# XLA's default lets a chain of elementwise ops skip the bf16 roundings
# between them; the bf16 reference is compiled to round where its source
# casts, as torch does (ROADMAP P15)
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}
MOE_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_max_frac", "moe_drop_frac")


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def rank_step(axes, arch, dtype, changes, variant, state, batch,
              shape=None, sp=False):
    """One sharded step of ``arch`` from the carried state (Megatron-SP
    activations with ``sp``): (metrics, local shards, routes). A moe
    model's ``routes``: (the global rows of the batch each ``route_topk``
    call routes, its calls' expert ids in order, the forward's first and
    the remat's recompute after them); None for the other families."""
    from _torch_tp_families import recorded_routes
    from repro_torch.configs import RunConfig
    from repro_torch.models import train_state_from_jax
    from repro_torch.models.moe import dispatch_groups
    from repro_torch.train import batch_shardings, make_train_step
    from repro_torch.train.train_loop import train_ctx
    cfg = cfg_of(arch, dtype, changes)
    rcfg = RunConfig(rules_variant=variant, seq_parallel_activations=sp,
                     **RUN)
    shd = train_ctx(mesh_axes(axes, shape), rcfg)
    port = train_state_from_jax(state, cfg, device="cpu", shd=shd)
    gb, seq = batch["tokens"].shape
    bsh = batch_shardings(cfg, shd, rcfg=rcfg, global_batch=gb)
    mine = bsh["tokens"].block(tuple(batch["tokens"].shape))[0]
    rows = {k: v[bsh[k].block(tuple(v.shape))].contiguous()
            for k, v in batch.items()}
    step = make_train_step(cfg, rcfg, shd, global_batch=gb)
    if cfg.moe is None:
        port, metrics = step(port, rows)
        return {k: float(v) for k, v in metrics.items()}, \
            local_state(port), None
    groups = dispatch_groups(shd, gb, seq, mine.stop - mine.start)
    routed = groups.rows if groups.gather else mine
    with recorded_routes([]) as calls:
        port, metrics = step(port, rows)
    return {k: float(v) for k, v in metrics.items()}, local_state(port), \
        (routed, calls)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_state(arch, dtype, changes, shape):
    """The reference's train state of ``arch`` on ``shape``'s mesh
    (numpy), its layer weights (an encoder's too) rescaled to their true
    fan-in, and the ranks' copy (torch); kept for the module's other
    tests (the rule variants share one), which read it only."""
    import jax

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_smoke_config as j_smoke
    from repro.train.train_loop import make_train_state as j_make_state
    from repro_torch.launch.mesh import AXES, POD_AXES
    from repro_torch.models import build_schedule, model_schema
    from repro_torch.models.params import to_torch
    from test_torch_train import _rescale
    jcfg = _changed(j_smoke(arch), dtype, changes)
    tcfg = cfg_of(arch, dtype, changes)
    state = jax.tree.map(np.asarray, j_make_state(
        jcfg, JRunConfig(**RUN), jmesh(shape), jax.random.PRNGKey(1)))
    names = POD_AXES if len(shape) == 3 else AXES
    schema = model_schema(tcfg, dict(zip(names, shape)))
    first = 0
    for seg, stacked in zip(build_schedule(tcfg),
                            state["params"]["segments"]):
        _rescale(stacked, schema["layers"][first])
        first += seg.count
    if tcfg.encoder_layers:
        _rescale(state["params"]["encoder"]["segments"][0],
                 schema["encoder"]["layers"][0])
    return jcfg, state, jax.tree.map(to_torch, state)


def ref_batch(jcfg, batch, seq):
    """Step 0 of the reference pipeline (``frames`` f32 for an encoder
    model), as numpy and as torch tensors."""
    from repro.configs import ShapeConfig as JShape
    from repro.data import for_model as j_for_model
    from repro_torch.models.params import to_torch
    b = j_for_model(jcfg, JShape("t", seq, batch, "train"),
                    seed=3).batch_at(0)
    return {k: np.asarray(v) for k, v in b.items()}, \
        {k: to_torch(np.asarray(v)) for k, v in b.items()}


def ref_step(jcfg, variant, state, batch, shape, compiler=None, sp=False):
    """One step of the reference's ``make_train_step`` on ``shape``'s mesh
    (Megatron-SP activations with ``sp``), state and batch placed by its
    own shardings: (new state, metrics, a moe model's routing choices:
    each ``route_topk`` call's expert ids over the global batch)."""
    from _torch_tp_families import ref_routes
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as JRunConfig
    from repro.train.train_loop import batch_shardings as j_batch_sh
    from repro.train.train_loop import make_train_step as j_make_step
    from repro.train.train_loop import state_shardings as j_state_sh
    jrcfg = JRunConfig(rules_variant=variant, seq_parallel_activations=sp,
                       **RUN)
    mesh = jmesh(shape)
    st = jax.device_put(jax.tree.map(jnp.asarray, state),
                        j_state_sh(jcfg, jrcfg, mesh))
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       j_batch_sh(jcfg, mesh, rcfg=jrcfg,
                                  global_batch=batch["tokens"].shape[0]))
    routes = []
    with ref_routes(routes):
        new, metrics = jax.jit(j_make_step(jcfg, jrcfg, mesh),
                               compiler_options=compiler)(st, b)
        jax.effects_barrier()
    return new, {k: float(v) for k, v in metrics.items()}, routes


def ref_block(arr, spec, shape, rank, layer=None):
    """The rank's block of the reference leaf ``arr`` (``[layer]`` of a
    stacked leaf) as f32, laid out by ``spec``, the reference's input
    layout (``state_shardings``, equal to the port's): the step's output
    may come back in another layout XLA chose (a replicated norm scale
    sharded like the channels it scales)."""
    from repro_torch.distribution.sharding import shard_slices
    from repro_torch.launch.mesh import AXES, POD_AXES
    names = POD_AXES if len(shape) == 3 else AXES
    data = np.asarray(arr).astype(np.float32)
    data = data if layer is None else data[layer]
    coord = dict(zip(names, np.unravel_index(rank, shape)))
    return data[shard_slices(data.shape, spec, dict(zip(names, shape)),
                             coord)]


def _pairs(tcfg, local, ref_state_, sh):
    """(what, the port's local shard, the reference leaf, layer, spec,
    the reference's ``mu`` leaf and its name for a parameter, else None)
    of every param, mu and nu leaf of a rank."""
    from repro_torch.models import opt_slots
    out = []
    for slot in opt_slots(tcfg):
        mu = _ref_leaf(ref_state_["opt"]["mu"], slot.ref_path)
        for i, name in enumerate(slot.params):
            layer = i if slot.stacked else slot.layer
            out.append((name, local["params"][name],
                        _ref_leaf(ref_state_["params"], slot.ref_path),
                        layer, sh["params"][name].spec,
                        (mu, f"mu {slot.name}")))
        out.append((f"mu {slot.name}", local["mu"][slot.name], mu,
                    slot.layer, sh["opt"]["mu"][slot.name].spec, None))
        for k, t in local["nu"][slot.name].items():
            out.append((f"nu {slot.name} {k}", t, _ref_leaf(
                ref_state_["opt"]["nu"], slot.ref_path)[k], slot.layer,
                sh["opt"]["nu"][slot.name][k].spec, None))
    return out


def adam_slack(mu, tol):
    """What the ``mu`` tolerance lets through Adam's first step, element
    by element: the step ``lr g / (|g| + eps)`` (g = mu / 0.1, clipped)
    moves by ``lr eps dg / (|g| + eps)^2`` for a gradient error dg, which
    the ``mu`` check bounds by ``tol`` of its max; where |g| is near eps
    (a zero-init ``A_log`` head's 3e-8, a few of ``w_out``'s 16k
    elements) f32 noise in g moves the parameter by a share of lr.
    Capped at 2 lr, the most a step can differ."""
    eps, lr = 1e-8, RUN["learning_rate"]
    g = np.abs(mu) / 0.1
    dg = tol * float(g.max())
    return np.minimum(lr * eps * dg / (g + eps) ** 2, 2 * lr)


def one_device_step(arch, dtype, changes, state, batch):
    """The port's one-device step from the same state and global batch:
    its local state (the whole of every leaf)."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import train_state_from_jax
    from repro_torch.train import make_train_step
    cfg = cfg_of(arch, dtype, changes)
    port = train_state_from_jax(state, cfg, device="cpu")
    port, _ = make_train_step(cfg, RunConfig(**RUN))(port, batch)
    return local_state(port)


def one_device_gaps(tcfg, one, ref_state_, shape):
    """Each leaf's gap, max |one-device port - reference| / max
    |reference| over the whole leaf (a second moment by its square
    root), of the port's one-device bf16 step."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import AXES, POD_AXES
    from repro_torch.train import state_shardings
    names = POD_AXES if len(shape) == 3 else AXES
    sh = state_shardings(tcfg, RunConfig(), {a: 1 for a in names})
    out = {}
    for what, got, ref, layer, _s, _m in _pairs(tcfg, one, ref_state_, sh):
        want = ref_block(ref, (), shape, 0, layer)
        got = got.numpy()
        if what.startswith("nu"):
            got, want = np.sqrt(got), np.sqrt(want)
        out[what] = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
    return out


def check_ranks(ranks, ref_state_, ref_metrics, tcfg, variant, shape, tol,
                must=(), one_gaps=None, turned=None):
    """Every rank's metrics and every param, ``mu`` and ``nu`` shard
    against the reference's block at the rank's coordinate, each within
    ``tol`` of the leaf's max |.| (a parameter element within that plus
    ``adam_slack``: Adam's first step is ill-conditioned where a gradient
    is near its eps); the assertion names the leaf. ``must``: name
    fragments (``A_log``, ``conv_B``, ``encoder.``, ``cross``, ...) each
    of which some checked leaf's name holds. ``one_gaps``: at bf16, each
    leaf's ``one_device_gaps``, its bf16 noise floor: the one-device port
    is itself up to a few percent off the reference on the SSM path's
    small leaves (ROADMAP P5: its scan keeps in f32 what the reference
    rounds to bf16; a random SSM model amplifies one bf16 ulp, P19), and
    the sharded step, a third way to round, is held within ``tol`` plus
    twice that floor, once for each side. ``turned``: {parameter: n}, the
    elements of a parameter (on any one rank) whose first Adam step may
    go the other way from the reference's, each where the reference's
    ``mu`` is within the ``mu`` check's tolerance of zero, so the bf16
    gradient's sign is below its noise (ROADMAP P30): at most ``n`` such
    elements, each off by no more than the step's 2 lr, every other
    element held as above. Returns the names checked."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import AXES, POD_AXES
    from repro_torch.train import state_shardings
    keys = ("loss", "ce_loss", "z_loss", "grad_norm", "lr")
    if tcfg.moe is not None:
        keys += MOE_KEYS
    for key in keys:
        for metrics, *_ in ranks:
            np.testing.assert_allclose(metrics[key], ref_metrics[key],
                                       rtol=tol["metric"], err_msg=key)
    names = POD_AXES if len(shape) == 3 else AXES
    sh = state_shardings(tcfg, RunConfig(rules_variant=variant),
                         dict(zip(names, shape)))
    seen = set()
    for rank, (_, local, *_) in enumerate(ranks):
        for what, got, ref, layer, spec, mu in _pairs(tcfg, local,
                                                      ref_state_, sh):
            def tol_of(name):
                return tol["shard"] + 2 * (one_gaps or {}).get(name, 0.0)
            want = ref_block(ref, spec, shape, rank, layer)
            got = got.numpy()
            if what.startswith("nu") and tol is BF16_TOL:
                # a second moment is 0.05 g^2: its square root is on the
                # gradient's scale, which the bf16 tolerance is for
                got, want = np.sqrt(got), np.sqrt(want)
            assert got.shape == want.shape, (rank, what)
            # the leaf's scale, not the block's: on (1, 8) a block of a
            # per-head leaf is one head, whose gradient may be ~1e-8 of
            # the others' (a 6e-8 dt_bias head beside 1e-3 ones)
            whole = ref_block(ref, (), shape, rank, layer)
            if what.startswith("nu") and tol is BF16_TOL:
                whole = np.sqrt(whole)
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = np.abs(got - want)
            allowed = tol_of(what) * scale
            if mu is not None:
                ref_mu = ref_block(mu[0], spec, shape, rank, layer)
                allowed = allowed + adam_slack(ref_mu, tol_of(mu[1]))
                if turned and what in turned:
                    # the sign of a gradient inside the mu check's
                    # tolerance of zero: its step may turn (2 lr at most)
                    mu_tol = tol_of(mu[1]) * float(np.abs(ref_block(
                        mu[0], (), shape, rank, layer)).max())
                    turn = (err > allowed) & (np.abs(ref_mu) <= mu_tol) \
                        & (err <= 2 * RUN["learning_rate"])
                    assert int(turn.sum()) <= turned[what], (
                        rank, what, int(turn.sum()))
                    allowed = np.where(turn, err, allowed)
            assert (err <= allowed).all(), (rank, what,
                                            float(err.max()) / scale)
            seen.add(what)
    for frag in must:
        assert any(frag in n for n in seen), frag
    return seen


def route_flips(ranks, ref_routes, batch, n_calls: int) -> int:
    """The routing choices of each rank's forward (its first ``n_calls``
    ``route_topk`` calls, one a moe layer) that differ from the
    reference's on the same global rows, summed over the ranks: each
    call is held against the reference's call (one a layer, over the
    global batch, in any order; the remat's recompute calls it again) it
    differs least from. 0 when the routing is identical."""
    b, s = batch
    assert len(ref_routes) >= n_calls, len(ref_routes)
    flips = 0
    for _m, _l, (rows, calls) in ranks:
        assert len(calls) >= n_calls, len(calls)
        for got in calls[:n_calls]:
            got = np.asarray(got)
            flips += min(int((np.asarray(want).reshape(b, s, -1)[rows]
                              .reshape(got.shape) != got).sum())
                         for want in ref_routes)
    return flips


def step_matches(world, arch, dtype, variant, changes=(), shape=SHAPE,
                 batch=(8, 40), must=(), sp=False, turned=None):
    """One sharded step of ``arch`` on ``shape`` (Megatron-SP activations
    with ``sp``) against the reference's GSPMD step, checked by
    ``check_ranks`` at f32 or bf16 (the reference compiled with
    ``SOURCE_ROUNDING``; each leaf's tolerance beyond the port's
    one-device gap to it; ``turned``, its first steps' turns); a moe
    model's routing identical to the reference's at f32. Returns (the
    ranks' results, a moe model's routing flips, else None)."""
    world.spawn()
    jcfg, state, tstate = ref_state(arch, dtype, changes, shape)
    nb, tb = ref_batch(jcfg, *batch)
    bf16 = dtype == "bfloat16"
    ranks, (new, metrics, routes) = world.run_beside(
        lambda: ref_step(jcfg, variant, state, nb, shape,
                         SOURCE_ROUNDING if bf16 else None, sp),
        rank_step, arch, dtype, changes, variant, tstate, tb,
        None if shape == SHAPE else shape, sp)
    tcfg = cfg_of(arch, dtype, changes)
    flips = None
    if tcfg.moe is not None:
        flips = route_flips(ranks, routes, batch,
                            tcfg.num_layers - tcfg.dense_layer_prefix)
        assert bf16 or flips == 0, flips
    if flips:
        # a flipped choice moves its token's expert outputs and every
        # gradient downstream of them by more than bf16 rounding (ROADMAP
        # P20, P21): the step's losses and norm are held, not its shards
        for key in ("loss", "ce_loss", "z_loss", "grad_norm", "lr",
                    "moe_lb_loss", "moe_z_loss"):
            for m, *_ in ranks:
                np.testing.assert_allclose(m[key], metrics[key],
                                           rtol=BF16_TOL["metric"],
                                           err_msg=key)
        return ranks, flips
    gaps = one_device_gaps(tcfg, one_device_step(
        arch, dtype, changes, tstate, tb), new, shape) if bf16 else None
    check_ranks(ranks, new, metrics, tcfg, variant, shape,
                BF16_TOL if bf16 else F32_TOL, must, gaps, turned)
    return ranks, flips
