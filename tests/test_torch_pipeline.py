"""The port's GPipe pipeline over 'pod' against the reference's.

``tests/test_pipeline.py``'s two cases on a spawned gloo world of 2 ranks
(pod 2; ``tests/_torch_world.py``), rank ``s`` holding stage ``s``: the
forward equals the reference's within 1e-5, and each rank's gradients of
its stage equal the reference's ``jax.grad`` (through its ``ppermute``
ring) within 1e-4 relative, 1e-5 absolute. The inputs are the
reference's ``jax.random`` draws, carried as numpy.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture
from repro_torch.distribution.pipeline import pipeline_forward

world = world_fixture(__name__, (2, 1, 1))


def _stage_fn(p, x):
    h = torch.tanh(x @ p["w1"])
    return h @ p["w2"] + x


def _rank_forward(axes, params, x, n_micro, grad):
    s = axes.index("pod")
    stage = {k: torch.from_numpy(v[s]).requires_grad_(grad)
             for k, v in params.items()}
    y = pipeline_forward(stage, torch.from_numpy(x), _stage_fn, mesh=axes,
                         n_micro=n_micro)
    if not grad:
        return y.detach().numpy()
    (y ** 2).mean().backward()
    return {k: t.grad.numpy() for k, t in stage.items()}


def _ref(seed_p, seed_x, d, h, b):
    import jax
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed_p))
    params = {"w1": np.array(jax.random.normal(k1, (2, d, h)) * 0.3),
              "w2": np.array(jax.random.normal(k2, (2, h, d)) * 0.3)}
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed_x), (b, d)))
    return params, x


def test_pipeline_matches_reference(world, mesh_pod):
    import jax
    import jax.numpy as jnp
    from repro.distribution.pipeline import pipeline_forward as j_pipeline

    def j_stage(p, x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"] + x

    d, h, b, n_micro = 16, 32, 8, 4
    params, x = _ref(0, 1, d, h, b)
    ref = np.asarray(jax.jit(lambda p, v: j_pipeline(
        p, v, j_stage, mesh=mesh_pod, n_micro=n_micro))(params, x))
    for y in world.run(_rank_forward, params, x, n_micro, False):
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
    # and the sequential stages the reference's test holds it against
    seq = torch.from_numpy(x)
    for s in range(2):
        seq = _stage_fn({k: torch.from_numpy(v[s]) for k, v in
                         params.items()}, seq)
    np.testing.assert_allclose(seq.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_reference(world, mesh_pod):
    import jax
    import jax.numpy as jnp
    from repro.distribution.pipeline import pipeline_forward as j_pipeline

    def j_stage(p, x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"] + x

    d, h, b, n_micro = 8, 16, 4, 2
    params, x = _ref(2, 3, d, h, b)
    xj = jnp.asarray(x)

    def loss_pp(p):
        return jnp.mean(j_pipeline(p, xj, j_stage, mesh=mesh_pod,
                                   n_micro=n_micro) ** 2)

    ref = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_pp))(params))
    grads = world.run(_rank_forward, params, x, n_micro, True)
    for s, g in enumerate(grads):
        for k in ("w1", "w2"):
            np.testing.assert_allclose(g[k], ref[k][s], rtol=1e-4,
                                       atol=1e-5, err_msg=f"stage {s} {k}")
        assert np.abs(g["w1"]).max() > 0


@pytest.mark.parametrize("n_micro", (1, 3))
def test_pipeline_microbatch_counts(world, mesh_pod, n_micro):
    """The fill/drain schedule at one microbatch and at an odd count."""
    import jax
    import jax.numpy as jnp
    from repro.distribution.pipeline import pipeline_forward as j_pipeline

    def j_stage(p, x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"] + x

    params, x = _ref(4, 5, 8, 16, 6)
    ref = np.asarray(jax.jit(lambda p, v: j_pipeline(
        p, v, j_stage, mesh=mesh_pod, n_micro=n_micro))(params, x))
    for y in world.run(_rank_forward, params, x, n_micro, False):
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
