"""The port's ``pod_step`` in a spawned 2-rank gloo world against the
reference's on ``make_host_mesh(1, 1, pod=2)``, on the CPU.

One rank per pod of a (pod 2, data 1, model 1) ``DeviceMesh``: each rank
computes its pod's rows of the batch and syncs the gradients through the
CoreEngine (``nk_grad_sync`` under ``use_engine``), as the reference's
per-pod ``vmap`` lanes do inside its ``shard_map``. The ranks
(``tests/_torch_world.py``) import torch, the port and this module only:
this file imports jax and the reference lazily, inside the test, so the
ranks never load them. Each world call has a time limit of its own
(``_torch_world.CALL_TIMEOUT_S``), as in ``tests/test_torch_nsm.py``.

Compared, at f32 (llama's smoke config, the reference's weights rescaled
to their true fan-in), after one step under ``ring`` (every psum on the
ring stack) and under ``compressed`` (the int8 stack): the parameters,
each within 5% of a step's size (lr) absolute (Adam divides each element
by |g| + 1e-8, so an element with a ~1e-9 gradient moves by its
gradient's last bits: 1.6% of lr at most here); the metrics within 1e-5;
and the two ledgers' ``("pod",)`` gradient psums: the same bytes, one
psum per leaf of each package's layout (the port syncs each layer's
gradient, the reference each segment's stack). The compressed case runs
a one-layer model: the int8 stack's global scale is taken per synced
tensor, so with more layers to a segment the port's per-layer scales are
finer than the reference's per-stack one and the codes differ (ROADMAP
P17); at one layer the two layouts sync the same tensors.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

SHAPE = (2, 1, 1)           # (pod, data, model)
ARCH = "llama3.2-3b"
RUN = dict(attn_q_block=16, attn_kv_block=16, warmup_steps=1,
           learning_rate=1e-2)
BATCH = (8, 32)             # global batch, sequence length


def _port_cfg(layers):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               param_dtype="float32", num_layers=layers)


def _pod_step(axes, policy, layers, state):
    """One ``pod_step`` on this rank: (params in the reference's layout,
    metrics, the ledger's rows, the NSMs the ops were routed to)."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core import make_engine
    from repro_torch.data import for_model
    from repro_torch.models import train_state_from_jax, train_state_to_numpy
    from repro_torch.train import make_train_step
    cfg = _port_cfg(layers)
    rcfg = RunConfig(explicit_pod_sync=True, nsm_policy=policy, **RUN)
    eng = make_engine(axes, policy)
    if policy == "ring":
        eng.clear_rules()
        eng.add_rule("all-ring", lambda op: op.verb == "psum", "ring2")
    step = make_train_step(cfg, rcfg, axes, eng)
    port = train_state_from_jax(state, cfg, device="cpu")
    batch = for_model(cfg, ShapeConfig("t", BATCH[1], BATCH[0], "train"),
                      device="cpu").batch_at(0)
    port, metrics = step(port, batch)
    return (train_state_to_numpy(port, cfg)["params"],
            {k: float(v) for k, v in metrics.items()},
            eng.ledger_table(), sorted({n for _, n in eng.route_log}),
            len(list(port["params"].parameters())))


# the world: 2 gloo ranks, one DeviceMesh, a command loop per rank
world = world_fixture(__name__, SHAPE)


def _cfgs(layers):
    import dataclasses

    from test_torch_train import _cfgs
    return tuple(dataclasses.replace(c, num_layers=layers)
                 for c in _cfgs(ARCH, "float32"))


def _reference(policy, layers, state):
    """One reference ``pod_step`` through its ``Runner`` (which places the
    state and the batch on the pod mesh): (params, metrics, ledger)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import ShapeConfig as JShape
    from repro.core import make_engine
    from repro.data import for_model
    from repro.launch.mesh import make_host_mesh
    from repro.train import Runner
    jcfg, _ = _cfgs(layers)
    rcfg = JRunConfig(explicit_pod_sync=True, nsm_policy=policy, **RUN)
    mesh = make_host_mesh(1, 1, pod=2)
    eng = make_engine(mesh, policy)
    if policy == "ring":
        eng.clear_rules()
        eng.add_rule("all-ring", lambda op: op.verb == "psum", "ring2")
    with tempfile.TemporaryDirectory() as d:
        r = Runner(jcfg, rcfg, mesh, for_model(
            jcfg, JShape("t", BATCH[1], BATCH[0], "train")), d, engine=eng)
        r.init_state(jax.random.PRNGKey(1))
        r.state = jax.device_put(jax.tree.map(jnp.asarray, state),
                                 r.state_sh)
        r.run(1)
        params = jax.tree.map(np.asarray, r.state["params"])
    return params, r.metrics_log[0], eng.ledger_table(), \
        len(jax.tree.leaves(state["params"]))


@pytest.mark.parametrize("policy,layers", [("ring", 2), ("compressed", 1)])
def test_pod_step_matches_reference(world, policy, layers):
    import jax

    from test_torch_train import _leaves_with_paths, _ref_state
    from repro.configs import RunConfig as JRunConfig
    jcfg, tcfg = _cfgs(layers)
    state = _ref_state(jcfg, tcfg, JRunConfig(**RUN), key=1)
    ranks = world.run(_pod_step, policy, layers, state)
    want_p, want_m, want_ledger, ref_leaves = _reference(policy, layers,
                                                         state)
    lr = RUN["learning_rate"]
    for got_p, got_m, ledger, routed, port_leaves in ranks:
        assert routed == (["compressed"] if policy == "compressed"
                          else ["ring2"])
        for (path, a), (_, b) in zip(_leaves_with_paths(got_p),
                                     _leaves_with_paths(want_p)):
            err = float(np.abs(a - b).max())
            assert err <= 0.05 * lr, (policy, path, err)
        for k in ("loss", "ce_loss", "z_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5,
                                       err_msg=(policy, k))
        pod = [(ops, nbytes) for _, verb, axes, ops, nbytes in ledger
               if verb == "psum" and axes == ("pod",)]
        ref_pod = [(ops, nbytes) for _, verb, axes, ops, nbytes in want_ledger
                   if verb == "psum" and axes == ("pod",)]
        assert len(pod) == len(ref_pod) == 1, (ledger, want_ledger)
        assert pod[0][0] == port_leaves and ref_pod[0][0] == ref_leaves
        assert pod[0][1] == ref_pod[0][1] == 4 * sum(
            a.size for a in jax.tree.leaves(state["params"]))
    # every rank stepped the same params: the sync made them one model
    for (path, a), (_, b) in zip(_leaves_with_paths(ranks[0][0]),
                                 _leaves_with_paths(ranks[1][0])):
        np.testing.assert_array_equal(a, b, err_msg=path)
