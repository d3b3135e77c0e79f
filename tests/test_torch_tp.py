"""The sharded dense path against the reference on the same mesh.

Spawned gloo worlds of (data 1, model 2), (data 2, model 2) and (data 1,
model 8) (``tests/_torch_world.py``; one world at a time) run the port's
sharded path, one rank per device of the reference's
``make_host_mesh(data, model)``. On (1, 8) the smoke llama3.2-3b's 4 query
heads pad to 8, so half the heads are inert and their kv map is not
uniform. Checks, each with its tolerance:

* ``decode_attention_cp``: every rank's chunk of the cache through the
  decode kernel's plain version at its local positions, combined over
  ``model`` by log-sum-exp, against the reference's ``decode_attention_cp``
  (a partial-manual ``shard_map``) at f32 within 1e-5: positions in the
  first chunk only, spread over every chunk, and a window. The reference
  computes the padded heads through its kv map and masks them later; the
  port computes the real heads only and returns zeros for the others, so
  the real heads are compared and the padded ones must be zero.
  ``stacked_lse_combine`` (the arithmetic ``chip_smoke.py`` runs on the
  card) is held against the reference the same way, with no world.
* ``forward_prefill`` + 8 greedy ``forward_decode`` steps of the smoke
  llama3.2-3b and of the smoke chameleon-34b (the vlm family: q/k norms on
  each rank's local heads, untied embeddings): f32 logits within 1e-4 and
  identical tokens; bf16 logits within 2e-2 of max |logit| (ROADMAP P2)
  with the reference's tokens fed back, chameleon's against the reference
  compiled to round where its source casts (ROADMAP P15); a cache length
  that the model axis does not divide (the one-device decode fallback)
  too.
* A ``ServeEngine`` drain (six requests, WFQ, a RateController) of both
  models: the completed requests' tokens identical at f32 to the reference
  engine's on the same mesh, every rank's the same.
* The other families' sharded paths are held in
  ``test_torch_tp_ssm.py``, ``test_torch_tp_moe.py`` and
  ``test_torch_tp_encdec.py``.

Weights are the reference's ``build_params`` on the mesh, each layer
weight rescaled to its true fan-in as in ``tests/test_torch_model.py``.
The harness (the ranks' forward and engine, the reference's, the drain)
is ``tests/_torch_tp_families.py``'s, shared with the families' files.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the ranks run rank_engine and rank_forward by name from this module
from _torch_threads import one_thread  # noqa: F401
from _torch_tp_families import (  # noqa: F401
    B, NAMES, SOURCE_ROUNDING, cfg_of, check_drain, jmesh, np32,
    pair, rank_engine, rank_forward, ref_forward, request_table,
    world1_serve,
)
from _torch_world import World
from repro_torch.configs import get_smoke_config
from repro_torch.distribution.sharding import ShardingCtx
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models.attention import decode_attention_cp, \
    stacked_lse_combine

SHAPES = ((1, 2), (2, 2), (1, 8))
ARCH = "llama3.2-3b"
VLM = "chameleon-34b"
PROMPT, MAX_SEQ = 12, 32
# six requests, prompts of 3 and 5 tokens, drained at a max_seq of 64
DRAIN = request_table(5, 6, (3, 5))
ODD_MAX_SEQ = 36              # 36 % 8 != 0: the cache is not seq-sharded
CP = dict(B=2, S=32, KV=2, H=4, D=16)
CP_POS = {"first_shard": ([1, 3], 0), "spread": ([5, 31], 0),
          "window": ([20, 29], 7)}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request):
    w = World(__name__, request.param, NAMES)
    w.mesh_shape = request.param
    yield w
    procs = list(w.procs)
    w.close()
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _rank_cp(axes, q, k, v, pos, window):
    shd = ShardingCtx(axes)
    chunk = k.shape[1] // shd.tp
    sl = slice(shd.index("model") * chunk, (shd.index("model") + 1) * chunk)
    o = decode_attention_cp(q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                            pos, window=window, n_real_heads=CP["H"],
                            shd=shd, chunked=True, naive=True)
    return o


def _rank_now(axes):
    import time
    time.sleep(0.05 * axes.mesh.get_rank())    # the ranks' clocks differ
    shd = ShardingCtx(axes)
    return shd.agreed_now(None), shd.agreed_now(7.5)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


def _cp_inputs(pos, hp):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((CP["B"], 1, hp, CP["D"])).astype(np.float32)
    k, v = (rng.standard_normal((CP["B"], CP["S"], CP["KV"], CP["D"]))
            .astype(np.float32) for _ in range(2))
    return q, k, v, np.asarray(pos, np.int32)


def _ref_cp(shape, q, k, v, pos, window):
    import jax
    import jax.numpy as jnp
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.models.attention import decode_attention_cp as j_cp
    from repro.models.attention import q_to_kv_map
    hp = q.shape[2]
    kv_map = q_to_kv_map(CP["H"], hp, CP["KV"])
    shd = JCtx(jmesh(shape))
    fn = jax.jit(lambda *a: j_cp(*a, kv_map=kv_map, window=window,
                                 n_real_heads=CP["H"], shd=shd))
    return np.asarray(fn(*map(jnp.asarray, (q, k, v, pos))))


def _forward(shape, jcfg, tree, prompt, max_seq, tokens_in=None,
             compiler_options=None, bf16_cache=True):
    """The reference's logits and tokens (``ref_forward``)."""
    return ref_forward(shape, jcfg, tree, prompt, max_seq, tokens_in,
                       cache_dtype="bfloat16" if bf16_cache else None,
                       compiler_options=compiler_options)[:2]


def _ranks(world, arch, dtype, ttree, prompt, max_seq, tokens_in,
           bf16_cache=True):
    """Every rank's logits and tokens (``rank_forward``)."""
    return [r[:2] for r in world.run(
        rank_forward, arch, dtype, (), ttree, prompt, max_seq, tokens_in,
        None, "bfloat16" if bf16_cache else None)]


def _prompt():
    return np.random.default_rng(7).integers(
        0, get_smoke_config(ARCH).vocab_size, (B, PROMPT)).astype(np.int32)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CP_POS))
def test_decode_attention_cp_matches_reference(world, case):
    shape = world.mesh_shape
    hp = -(-CP["H"] // shape[1]) * shape[1]
    pos, window = CP_POS[case]
    q, k, v, p = _cp_inputs(pos, hp)
    ref = _ref_cp(shape, q, k, v, p, window)
    outs = world.run(_rank_cp, *map(torch.from_numpy, (q, k, v, p)), window)
    for o in outs:
        assert tuple(o.shape) == ref.shape
        np.testing.assert_allclose(np32(o[:, :, :CP["H"]]),
                                   ref[:, :, :CP["H"]], rtol=1e-5, atol=1e-5)
        assert not o[:, :, CP["H"]:].any()
    np.testing.assert_array_equal(np32(outs[0]), np32(outs[-1]))


@pytest.mark.parametrize("tp", (2, 4, 8))
@pytest.mark.parametrize("case", sorted(CP_POS))
def test_stacked_combine_matches_reference(tp, case):
    """The shards' plain decode at their local positions (empty where a
    chunk starts past ``pos``), combined by ``stacked_lse_combine``,
    against the reference's context-parallel decode at (1, tp)."""
    pos, window = CP_POS[case]
    q, k, v, p = _cp_inputs(pos, CP["H"])
    ref = _ref_cp((1, tp), q, k, v, p, window)
    chunk = CP["S"] // tp
    parts = [decode_attention_plain(
        torch.from_numpy(q[:, 0]),
        torch.from_numpy(k[:, r * chunk:(r + 1) * chunk]).contiguous(),
        torch.from_numpy(v[:, r * chunk:(r + 1) * chunk]).contiguous(),
        torch.from_numpy(p - r * chunk), window=window) for r in range(tp)]
    o = stacked_lse_combine(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(o.numpy(), ref[:, 0], rtol=1e-5, atol=1e-5)
    # some shard holds no live position of some sequence: its empty row
    assert any(float(m.min()) < -1e29 for _o, m, _l in parts)


def _check_forward_f32(world, arch, bf16_cache=True):
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, arch, "float32")
    prompt = _prompt()
    j_logits, j_toks = _forward(shape, jcfg, tree, prompt, MAX_SEQ,
                                bf16_cache=bf16_cache)
    for logits, toks in _ranks(world, arch, "float32", ttree, prompt,
                               MAX_SEQ, None, bf16_cache):
        np.testing.assert_array_equal(toks, j_toks)      # identical greedy
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")


def _check_forward_bf16(world, arch, compiler_options=None):
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, arch, "bfloat16")
    prompt = _prompt()
    j_logits, j_toks = _forward(shape, jcfg, tree, prompt, MAX_SEQ,
                                compiler_options=compiler_options)
    for logits, _toks in _ranks(world, arch, "bfloat16", ttree, prompt,
                                MAX_SEQ, j_toks):
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert rel <= 2e-2, (i, rel)


def test_forward_matches_reference_f32(world):
    _check_forward_f32(world, ARCH)


def test_forward_matches_reference_bf16(world):
    _check_forward_bf16(world, ARCH)


def test_vlm_forward_matches_reference_f32(world):
    """chameleon-34b: q/k norms on each rank's local heads (padded to 8 on
    (1, 8)), untied embeddings. Both sides decode from their f32 prefill
    caches: installed into bf16, a few entries that agree within ~2e-6
    straddle a bf16 rounding boundary and move the decode logits by a few
    1e-4 of max |logit| on one device as well (ROADMAP P14); the engine
    drain below installs them and holds the tokens identical."""
    _check_forward_f32(world, VLM, bf16_cache=False)


def test_vlm_forward_matches_reference_bf16(world):
    """chameleon-34b at bf16 amplifies any change of rounding order
    (ROADMAP P15): the reference's own bf16 logits move by up to 2.1e-2
    between its one-device and (1, 8) layouts, so P2's 2e-2 cannot tell
    the port's error from that spread. Held instead at the spread itself:
    the port's bf16 logits, teacher-forced with the source-rounded
    reference's tokens, are no farther from the reference's f32 logits on
    the mesh, nor from its source-rounded bf16 logits, than the
    reference's own bf16 logits (source-rounded or default, on the mesh
    or on one device) are from its f32 ones; and the prefill logits are
    within P2's 2e-2."""
    import jax
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, VLM, "bfloat16")
    prompt = _prompt()
    src, toks = _forward(shape, jcfg, tree, prompt, MAX_SEQ,
                         compiler_options=SOURCE_ROUNDING)
    j32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    f32 = _forward(shape, j32, jax.tree.map(
        lambda a: a.astype(np.float32), tree), prompt, MAX_SEQ, toks)[0]
    variants = (src, _forward(shape, jcfg, tree, prompt, MAX_SEQ, toks)[0],
                _forward((1, 1), jcfg, tree, prompt, MAX_SEQ, toks,
                         compiler_options=SOURCE_ROUNDING)[0])

    def gap(a_runs, b_runs):
        return max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(a_runs, b_runs))
    noise = max(gap(v, f32) for v in variants)
    for logits, _toks in _ranks(world, VLM, "bfloat16", ttree, prompt,
                                MAX_SEQ, toks):
        assert gap(logits[:1], src[:1]) <= 2e-2
        assert gap(logits, f32) <= noise, (gap(logits, f32), noise)
        assert gap(logits, src) <= noise, (gap(logits, src), noise)


@pytest.mark.parametrize("world", [(1, 8)], indirect=True,
                         ids=["1x8"])
def test_forward_with_unsharded_cache_length_matches_reference(world):
    """A cache length the model axis does not divide at tp 8 (36): the
    cache's sequence is replicated and decode reads it whole on every
    rank, the reference's one-device fallback; f32 within 1e-4."""
    shape = world.mesh_shape
    assert ODD_MAX_SEQ % shape[1]
    jcfg, tree, ttree = pair(shape, ARCH, "float32")
    prompt = _prompt()
    j_logits, j_toks = _forward(shape, jcfg, tree, prompt, ODD_MAX_SEQ)
    for logits, toks in _ranks(world, ARCH, "float32", ttree, prompt,
                               ODD_MAX_SEQ, None):
        np.testing.assert_array_equal(toks, j_toks)
        for a, b in zip(logits, j_logits):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_engine_drain_matches_reference(world):
    """Both engines serve the same six requests (WFQ, prompt-charged
    buckets, a RateController every 4 steps) at f32 on the same mesh:
    identical tokens, completion order, served tokens and decode steps,
    the same on every rank."""
    check_drain(world, ARCH, DRAIN, 64)


def test_vlm_engine_drain_matches_reference(world):
    """The same drain of chameleon-34b."""
    check_drain(world, VLM, DRAIN, 64)


def test_every_rank_takes_one_clock(world):
    """A multi-rank engine's host decisions read one clock: the first
    rank's monotonic time, broadcast (a given ``now`` is kept)."""
    outs = world.run(_rank_now)
    assert len({now for now, _ in outs}) == 1
    assert all(given == 7.5 for _, given in outs)


def test_sharded_serve_on_a_world_of_one_equals_the_unsharded_engine():
    """``chip_smoke.py``'s sharded serve, rehearsed on a gloo world of one
    in this process: the smoke llama3.2-3b through ``ServeEngine`` with
    ``ShardingCtx(make_host_mesh(1, 1))`` gives the unsharded engine's
    tokens and ledger on the same seeded weights (every layout draws the
    same values), and the installed CoreEngine's ledger holds one psum over
    ``model`` for the embedding and two per layer for each prefill and
    decode step."""
    import chip_smoke
    cfg = cfg_of(ARCH, "bfloat16")
    got, want, psums, expected = world1_serve(cfg, requests=DRAIN)
    assert got == want
    assert psums == expected
    assert chip_smoke.model_psums(cfg, prefill=True) == \
        chip_smoke.model_psums(cfg, prefill=False) == 1 + 2 * cfg.num_layers


def test_per_rank_bytes_are_reckoned_from_the_layout(capsys):
    """``chip_smoke.py``'s (d), with no device: llama3.2-3b's 24 heads pad
    to 32 at model 16, a rank holds a sixteenth of every model-sharded
    leaf and the whole of the replicated ones, and the cache's sequence
    splits sixteen ways."""
    import chip_smoke
    rows = chip_smoke.per_rank_bytes()
    llama = rows["llama3.2-3b"]
    assert llama["padded_heads"] == 32
    assert llama["padded_weight_bytes"] > llama["one_device_weight_bytes"]
    assert llama["padded_weight_bytes"] / 16 < llama["rank_weight_bytes"] \
        < llama["padded_weight_bytes"] / 4
    assert rows["chameleon-34b"]["padded_heads"] == 64
    for row in rows.values():
        assert row["rank_cache_bytes_decode_32k"] * 16 == \
            row["cache_bytes_decode_32k"]
    assert '"per_rank_bytes"' in capsys.readouterr().out
