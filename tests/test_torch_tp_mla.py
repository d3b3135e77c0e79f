"""The moe family on the model axis against the reference: deepseek-v2-236b.

The smoke deepseek-v2-236b (MLA over a latent cache, a dense prefix
layer, 2 shared experts beside 4 routed, top-2) on spawned gloo worlds of
(data 2, model 2), (data 1, model 2) and (data 1, model 8)
(``tests/_torch_world.py``), one rank a device of the reference's
``make_host_mesh``; the checks are arctic's (``tests/test_torch_tp_moe.py``,
``tests/_torch_tp_families.py``). MLA runs on each rank's heads of
``wq``/``w_uk``/``w_uv``/``wo`` (4 heads, padded to 8 on (1, 8)); its
latent cache splits by sequence over ``model``, and its decode gathers
the absorbed queries and LSE-combines the chunks; the experts split as
arctic's. Checks, each with its tolerance: prefill + 8 greedy decode
steps at f32 (logits within 1e-4, identical tokens and routing), bf16
(within 2e-2 of the reference before the first flipped routing step,
no flip on any world, ROADMAP P21), each rank's parameter and cache shards, a ``ServeEngine``
drain at f32 on (2, 2), and the world-of-one sharded serve.
"""
import pytest

from _torch_threads import one_thread  # noqa: F401
# the ranks run rank_engine and rank_forward by name from this module
from _torch_tp_families import (  # noqa: F401
    NAMES, cfg_of, check_moe_bf16, check_moe_drain,
    check_moe_f32, check_moe_shards, rank_engine, rank_forward,
    world1_serve,
)
from _torch_world import World

ARCH = "deepseek-v2-236b"
# pytest groups the tests by the shape's index in this tuple (see
# test_torch_tp_moe.py)
SHAPES = ((2, 2), (1, 2), (1, 8))
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


@pytest.mark.parametrize("world", SHAPES[:1], indirect=True, ids=["2x2"])
def test_engine_drain_matches_reference(world):
    check_moe_drain(world, ARCH)


def test_sharded_serve_on_a_world_of_one_equals_the_unsharded_engine():
    """``chip_smoke.py``'s world-of-one sharded serve of deepseek on the
    CPU: the unsharded engine's tokens, ``chip_smoke.model_psums`` psums
    over ``model`` a forward (the dense prefix layer's 2, each MoE layer's
    3)."""
    got, want, psums, expected = world1_serve(cfg_of(ARCH, "bfloat16"))
    assert got == want
    assert psums == expected
