"""The port's NSMs over ``torch.distributed`` against the reference's
``shard_map`` outputs, on the CPU.

One spawned gloo world of 8 ranks in a (pod 2, data 2, model 2)
``DeviceMesh`` serves the whole module (a module-scoped fixture,
``tests/_torch_world.py``). The ranks import torch, the port and this
module only: this file imports jax and the reference lazily, inside
fixtures and tests, so the ranks never load them. Every world call has a
time limit of its own (``_torch_world.CALL_TIMEOUT_S``): a hung or failed
rank fails that test, and the world is respawned for the next.

The reference side is the 8-host-device ``mesh_pod`` fixture of
``conftest.py`` (2, 2, pod=2), and each case is one of
``tests/test_nsm_conformance.py``'s: every NSM x every verb it overrides x
``("model",)``, ``("data",)``, ``("pod", "data")`` x f32 and bf16, at that
suite's tolerance tiers (1e-5 relative for the explicit-schedule stacks,
1e-6 for shm, 2e-2 under bf16; compressed psums within the suite's bound
derived from the measured int8 round-trip residuals).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture
from repro_torch.core import nsm as tnsm

WORLD = 8
SHAPE = (2, 2, 2)
NAMES = ("pod", "data", "model")
SIZES = dict(zip(NAMES, SHAPE))

_VERBS_UNDER_TEST = ("psum", "all_gather", "reduce_scatter")
_PSUM_AXES = [("model",), ("data",), ("pod", "data")]
_ONE_AXES = [("model",), ("data",)]
_DTYPES = ["float32", "bfloat16"]


def _overridden(name):
    """The verbs an NSM's class overrides below ``Nsm`` (the conformance
    suite's discovery, on the port's registry)."""
    cls = type(tnsm.get_nsm(name))
    out = []
    for verb in _VERBS_UNDER_TEST:
        for klass in cls.mro():
            if klass in (tnsm.Nsm, object):
                break
            if verb in klass.__dict__:
                out.append(verb)
                break
    return out


CASES = [(name, verb, axes, dt)
         for name in tnsm.available_nsms() if name != "xla"
         for verb in _overridden(name)
         for axes in (_PSUM_AXES if verb == "psum" else _ONE_AXES)
         for dt in _DTYPES]


# the world: 8 gloo ranks, one DeviceMesh, a command loop per rank
world = world_fixture(__name__, SHAPE, NAMES)


# ---------------------------------------------------------------------------
# shards: the reference's in/out PartitionSpecs, on a rank's coordinates
# ---------------------------------------------------------------------------


def _specs(verb, axes):
    """(in, out) layouts of ``test_nsm_conformance._specs``: ("cols", axes),
    ("rows", axes) or ("full",)."""
    if verb == "psum":
        spec = ("cols", axes) if axes == ("model",) else ("rows", axes)
        return spec, spec
    if verb == "reduce_scatter":
        return ("full",), ("rows", axes[:1])
    if verb == "all_gather":
        return ("rows", axes[:1]), ("full",)
    raise AssertionError(verb)


def _local(arr, spec, coord):
    """The block of a global array a rank holds under ``spec`` (shards in
    row-major order over the spec's axes, as a PartitionSpec lays them)."""
    if spec[0] == "full":
        return arr
    idx, n = 0, 1
    for a in spec[1]:
        idx, n = idx * SIZES[a] + coord[a], n * SIZES[a]
    if spec[0] == "rows":
        k = arr.shape[0] // n
        return arr[idx * k:(idx + 1) * k]
    k = arr.shape[1] // n
    return arr[:, idx * k:(idx + 1) * k]


def _coords():
    """Each rank's mesh coordinates (ranks are row-major over the mesh)."""
    return [dict(zip(NAMES, np.unravel_index(r, SHAPE)))
            for r in range(WORLD)]


def _np(t):
    return t.float().numpy() if t.dtype.is_floating_point else t.numpy()


# --- functions the ranks run (first argument: the rank's MeshAxes) --------


def _coord_of(axes):
    return {a: axes.index(a) for a in NAMES}


def _run_case(axes, name, verb, ax, dtype, x, op_data=None):
    """One NSM verb on this rank's input shard; returns its output and
    whether the caller's tensor was left as it was."""
    from repro_torch.core.nqe import CommOp
    in_spec, _ = _specs(verb, ax)
    local = torch.from_numpy(_local(x, in_spec, _coord_of(axes)).copy())
    local = local.to(getattr(torch, dtype))
    before = local.clone()
    kw = {"axis": 0} if verb != "psum" else {}
    op = None if op_data is None else CommOp(verb=verb, axes=ax,
                                             op_data=op_data)
    out = getattr(tnsm.get_nsm(name), verb)(local, ax, axis_sizes=axes,
                                             op=op, **kw)
    return _np(out), bool(torch.equal(local, before))


def _run_compressed_psum(axes, ax, x):
    from repro_torch.core.compression import compressed_psum
    local = torch.from_numpy(_local(x, ("rows", ax), _coord_of(axes)).copy())
    return _np(compressed_psum(local, ax, axis_sizes=axes))


def _run_policy(axes, policy, ax, x):
    """``nk_psum`` through ``make_engine(mesh, policy)`` (the reference's
    ``test_policy_psum_matches_native``); returns (output, ledger bytes)."""
    from repro_torch.core import make_engine, nk_psum, use_engine
    spec = ("cols", ("model",)) if ax == "model" else ("rows", ax)
    local = torch.from_numpy(_local(x, spec, _coord_of(axes)).copy())
    eng = make_engine(axes, policy)
    if policy == "ring":
        eng.clear_rules()
        eng.add_rule("all-ring", lambda op: op.verb == "psum", "ring2")
    with use_engine(eng):
        out = nk_psum(local, ax, gradient=True)
    return _np(out), eng.total_bytes()


def _run_overlap(axes, which, xa, w):
    from repro_torch.core.overlap import (
        all_gather_matmul, matmul_reduce_scatter)
    m = axes.index("model")
    xa, w = torch.from_numpy(xa), torch.from_numpy(w)
    k = w.shape[0] // 2
    if which == "all_gather_matmul":
        return _np(all_gather_matmul(xa, w[m * k:(m + 1) * k], "model", 2,
                                     axes=axes))
    return _np(matmul_reduce_scatter(xa[:, m * k:(m + 1) * k],
                                     w[m * k:(m + 1) * k], "model", 2,
                                     axes=axes))


def _run_native(axes, verb, ax, x, kw):
    """The port's native (xla) stack on a verb the conformance matrix
    does not reach (all_to_all, ppermute, tiled=False gathers)."""
    local = torch.from_numpy(_local(x, ("rows", ax), _coord_of(axes)).copy())
    out = getattr(tnsm.get_nsm("xla"), verb)(local, ax, axis_sizes=axes,
                                             **kw)
    return _np(out)


# ---------------------------------------------------------------------------
# the reference side (jax imported here, in the test process only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_suite():
    import test_nsm_conformance
    return test_nsm_conformance


def _x(ref_suite):
    """The conformance suite's input, (16, 32) f32 from PRNGKey(7)."""
    import jax.numpy as jnp
    return np.asarray(ref_suite._x(jnp.float32), np.float32)


def _jdtype(dt):
    import jax.numpy as jnp
    return getattr(jnp, dt)


def test_case_matrix_is_the_conformance_suites(ref_suite):
    """The port's registry yields the same NSMs and overridden verbs, so
    CASES is the reference suite's matrix case for case."""
    import jax.numpy as jnp
    theirs = [(n, v, a, jnp.dtype(d).name) for n, v, a, d in
              ref_suite.CASES]
    assert CASES == theirs
    assert len(CASES) == 50


@pytest.mark.parametrize("name,verb,axes,dtype", CASES,
                         ids=[f"{n}-{v}-{'+'.join(a)}-{d}"
                              for n, v, a, d in CASES])
def test_nsm_matches_reference(world, ref_suite, mesh_pod, name, verb, axes,
                               dtype):
    """Each rank's output equals its block of the reference's native
    (xla) output at the suite's tier, and of the reference's same NSM;
    no rank's input tensor is written."""
    from repro.core.nsm import get_nsm as jget
    x = _x(ref_suite)
    jx = ref_suite._x(_jdtype(dtype))
    ref = ref_suite._ref(mesh_pod, verb, axes, _jdtype(dtype), jx)
    same = ref_suite._run(mesh_pod, jget(name), verb, axes, jx)
    outs = world.run(_run_case, name, verb, axes, dtype, x)
    _, out_spec = _specs(verb, axes)
    atol_c = None
    if name == "compressed":
        atol_c = ref_suite._compressed_atol(mesh_pod, verb, axes,
                                            _jdtype(dtype), jx, ref)
    tol = ref_suite._tol(name, _jdtype(dtype))
    for coord, (out, untouched) in zip(_coords(), outs):
        assert untouched, "an NSM wrote into the caller's tensor"
        for target, k in ((ref, 1.0), (same, 2.0)):
            want = _local(target, out_spec, coord)
            if atol_c is not None:
                # the bound holds for each side against the exact sum
                np.testing.assert_allclose(out, want, rtol=0.0,
                                           atol=k * atol_c)
            else:
                np.testing.assert_allclose(
                    out, want, rtol=tol,
                    atol=tol * float(np.abs(target).max()))


def test_compressed_integer_passthrough_is_exact(world, ref_suite, mesh_pod):
    """Integer payloads bypass the int8 wire entirely (exact sum)."""
    import jax.numpy as jnp
    from repro.core.nsm import get_nsm as jget
    xi = np.arange(16 * 32, dtype=np.int32).reshape(16, 32)
    ref = ref_suite._run(mesh_pod, jget("xla"), "psum", ("pod", "data"),
                         jnp.asarray(xi))
    outs = world.run(_run_case, "compressed", "psum", ("pod", "data"),
                     "int32", xi)
    for coord, (out, _) in zip(_coords(), outs):
        np.testing.assert_array_equal(
            out, _local(ref, ("rows", ("pod", "data")), coord))


def test_shm_elision_contract(world, ref_suite, mesh_pod):
    """op_data bit0 elides the op (identity); without it shm agrees with
    the native stack."""
    from repro.core.nsm import get_nsm as jget
    x = _x(ref_suite)
    spec = ("cols", ("model",))
    elided = world.run(_run_case, "shm", "psum", ("model",), "float32", x, 1)
    plain = world.run(_run_case, "shm", "psum", ("model",), "float32", x, 0)
    ref = ref_suite._run(mesh_pod, jget("xla"), "psum", ("model",),
                         ref_suite._x(_jdtype("float32")))
    for coord, (out, _), (out0, _) in zip(_coords(), elided, plain):
        np.testing.assert_array_equal(out, _local(x, spec, coord))
        np.testing.assert_allclose(out0, _local(ref, spec, coord),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axes", [("pod",), ("pod", "data")])
def test_compressed_psum_equals_reference_bit_for_bit(world, mesh_pod, axes):
    """``compressed_psum`` itself, rows sharded over ``axes``: the max
    all-reduce is exact, the scale is the reference's bits, the int32 sum
    is exact, so every rank's result equals the reference's to the bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.compression import compressed_psum as jpsum
    x = (np.random.default_rng(11).standard_normal((16, 32))
         * np.exp(np.random.default_rng(12).uniform(-3, 3, (16, 1)))
         ).astype(np.float32)
    name = axes if len(axes) > 1 else axes[0]
    ref = np.asarray(jax.jit(shard_map(
        lambda v: jpsum(v, name, axis_sizes=(2,) * len(axes)),
        mesh=mesh_pod, in_specs=P(axes, None), out_specs=P(axes, None)))(
            jnp.asarray(x)))
    outs = world.run(_run_compressed_psum, axes, x)
    for coord, out in zip(_coords(), outs):
        np.testing.assert_array_equal(out, _local(ref, ("rows", axes),
                                                  coord))


@pytest.mark.parametrize("policy,axes,tol", [
    ("xla", "model", 1e-6),
    ("ring", ("pod", "data"), 1e-5),
    ("hierarchical", ("pod", "data"), 1e-5),
    ("compressed", ("pod", "data"), 2e-2),
])
def test_policy_psum_matches_native(world, mesh_pod, policy, axes, tol):
    """``nk_psum`` under each stock policy against the reference's native
    psum (``tests/test_collectives.py``'s tolerances); the ledger counted
    the intent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 32),
                                     jnp.float32))
    spec = P(None, "model") if axes == "model" else P(("pod", "data"), None)
    ref = np.asarray(jax.jit(shard_map(
        lambda v: jax.lax.psum(v, axes), mesh=mesh_pod, in_specs=spec,
        out_specs=spec))(jnp.asarray(x)))
    outs = world.run(_run_policy, policy, axes, x)
    lspec = ("cols", ("model",)) if axes == "model" else ("rows", axes)
    for coord, (out, nbytes) in zip(_coords(), outs):
        np.testing.assert_allclose(out, _local(ref, lspec, coord), rtol=tol,
                                   atol=tol * float(np.abs(ref).max()))
        assert nbytes == 4 * _local(x, lspec, coord).size


@pytest.mark.parametrize("which", ["all_gather_matmul",
                                   "matmul_reduce_scatter"])
def test_overlapped_matmuls_match_reference(world, mesh_pod, which):
    """Both collective matmuls against the reference's on the same inputs
    (``tests/test_collectives.py``: 1e-4) and the plain product."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import overlap as jov
    k, n, m = 32, 24, 16
    xa = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (m, k)))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (k, n)))
    if which == "all_gather_matmul":
        ref = jax.jit(shard_map(
            lambda xl, wl: jov.all_gather_matmul(xl, wl, "model", 2),
            mesh=mesh_pod, in_specs=(P(None, None), P("model", None)),
            out_specs=P(None, None), check_vma=False))(xa, w)
        out_spec = ("full",)
    else:
        ref = jax.jit(shard_map(
            lambda xl, wl: jov.matmul_reduce_scatter(xl, wl, "model", 2),
            mesh=mesh_pod, in_specs=(P(None, "model"), P("model", None)),
            out_specs=P("model", None)))(xa, w)
        out_spec = ("rows", ("model",))
    ref = np.asarray(ref)
    np.testing.assert_allclose(ref, xa @ w, rtol=1e-4, atol=1e-4)
    outs = world.run(_run_overlap, which, xa, w)
    for coord, out in zip(_coords(), outs):
        np.testing.assert_allclose(out, _local(ref, out_spec, coord),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("verb,axes,kw", [
    ("all_to_all", ("model",), {"split_axis": 1, "concat_axis": 0}),
    ("all_to_all", ("data",), {"split_axis": 0, "concat_axis": 1}),
    ("ppermute", ("data",), {"perm": [(0, 1), (1, 0)]}),
    ("ppermute", ("model",), {"perm": [(0, 1)]}),
    ("all_gather", ("pod", "data"), {"axis": 1, "tiled": True}),
    ("all_gather", ("model",), {"axis": 0, "tiled": False}),
    ("all_gather", ("data",), {"axis": 1, "tiled": False}),
    ("reduce_scatter", ("pod", "data"), {"axis": 0}),
])
def test_native_verbs_match_reference(world, mesh_pod, verb, axes, kw):
    """The native stack's other verbs — all_to_all, ppermute (a rank
    that is no destination gets zeros), multi-axis and untiled gathers,
    a multi-axis reduce-scatter — against ``jax.lax`` under shard_map:
    data movement exactly, the 4-way sum within 1e-6 (its order differs)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.nsm import get_nsm as jget
    x = np.random.default_rng(5).standard_normal((16, 32)).astype(
        np.float32)
    spec = P(axes, None)
    out = jax.jit(shard_map(
        lambda v: getattr(jget("xla"), verb)(
            v, axes, axis_sizes=dict(SIZES), **kw)[None],
        mesh=mesh_pod, in_specs=spec, out_specs=P(NAMES),
        check_vma=False))(jnp.asarray(x))
    per_device = np.asarray(out)          # (8, ...) in mesh (rank) order
    outs = world.run(_run_native, verb, axes, x, kw)
    tol = 1e-6 if verb == "reduce_scatter" else 0.0
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got, per_device[r], rtol=tol,
                                   atol=tol * float(np.abs(per_device).max()))
