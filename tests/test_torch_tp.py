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
* The other families refuse a mesh by name.

Weights are the reference's ``build_params`` on the mesh, each layer
weight rescaled to its true fan-in as in ``tests/test_torch_model.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_world import World
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.distribution.sharding import ShardingCtx
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models.attention import decode_attention_cp, \
    stacked_lse_combine
from repro_torch.models.model import (
    Model, build_schedule, forward_decode, forward_prefill, gather_logits,
    gather_rows, greedy, model_schema,
)
from repro_torch.models.params import params_from_jax
from repro_torch.models.schema import walk

NAMES = ("data", "model")
SHAPES = ((1, 2), (2, 2), (1, 8))
ARCH = "llama3.2-3b"
VLM = "chameleon-34b"
# XLA's default lets a chain of elementwise ops skip the bf16 roundings
# between them; chameleon's bf16 reference is compiled to round where its
# source casts, as torch does (ROADMAP P15, tests/test_torch_model.py)
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}
B, PROMPT, MAX_SEQ, STEPS = 2, 12, 32, 8
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


def _cfg(dtype, arch=ARCH):
    cfg = get_smoke_config(arch)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    return cfg


def _np(t):
    return t.float().numpy()


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


def _rank_forward(axes, tree, dtype, prompt, max_seq, tokens_in, arch=ARCH,
                  bf16_cache=True):
    shd = ShardingCtx(axes)
    model = params_from_jax(tree, _cfg(dtype, arch), device="cpu", shd=shd)
    rcfg = RunConfig()
    logits, caches = forward_prefill(model, torch.from_numpy(prompt), rcfg,
                                     max_seq=max_seq)
    if bf16_cache:
        caches = tuple({k: c.to(torch.bfloat16) for k, c in seg.items()}
                       for seg in caches)
    outs, toks = [_np(gather_logits(model, logits, B))], []
    for i in range(STEPS):
        tok = gather_rows(shd, greedy(model, logits), B).to(torch.int32) \
            if tokens_in is None else torch.from_numpy(tokens_in[i])
        toks.append(tok.numpy())
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, caches = forward_decode(model, caches, tok[:, None], pos,
                                        rcfg, max_seq=max_seq)
        outs.append(_np(gather_logits(model, logits, B)))
    return outs, np.stack(toks)


def _rank_now(axes):
    import time
    time.sleep(0.05 * axes.mesh.get_rank())    # the ranks' clocks differ
    shd = ShardingCtx(axes)
    return shd.agreed_now(None), shd.agreed_now(7.5)


def _rank_engine(axes, tree, arch=ARCH):
    from repro_torch.control.controller import RateController
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    shd = ShardingCtx(axes)
    cfg = _cfg("float32", arch)
    model = params_from_jax(tree, cfg, device="cpu", shd=shd)
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(200.0, alpha=0.6)
    ctrl.attach_scheduler(sched)
    eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=64,
                      scheduler=sched, controller=ctrl, control_every=4,
                      device="cpu", shd=shd)
    return _drain(eng, sched, _requests(Request))


def _requests(request_cls):
    rng = np.random.default_rng(5)
    return [request_cls(
        tenant_id=i % 3,
        prompt=[int(x) for x in rng.integers(1, 256, (3, 5)[i % 2])],
        max_new_tokens=(6, 9, 12)[i % 3], req_id=i, arrival=0.0)
        for i in range(6)]


def _drain(engine, scheduler, requests):
    for r in requests:
        engine.submit(r)
    k = 0
    while scheduler.pending() or any(s.active for s in engine.slots):
        k += 1
        engine.step(now=0.1 * k)
        assert k < 200
    return ([(r.req_id, r.generated) for r in engine.completed],
            dict(scheduler.served_tokens), engine.decode_steps)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmesh(shape):
    from repro.launch.mesh import make_host_mesh
    return make_host_mesh(*shape)


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
    shd = JCtx(_jmesh(shape))
    fn = jax.jit(lambda *a: j_cp(*a, kv_map=kv_map, window=window,
                                 n_real_heads=CP["H"], shd=shd))
    return np.asarray(fn(*map(jnp.asarray, (q, k, v, pos))))


def _pair(shape, dtype, arch=ARCH):
    """The reference's config and weights on ``shape``'s mesh (each layer
    weight rescaled to its true fan-in), and the same tree as torch
    tensors for the ranks."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.models.model import build_params
    from repro_torch.models.params import to_torch
    mesh = _jmesh(shape)
    jcfg = j_smoke(arch)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype="float32",
                                   param_dtype="float32")
    tcfg = _cfg(dtype, arch)
    tree = jax.tree.map(np.asarray,
                        build_params(jcfg, mesh, jax.random.PRNGKey(0)))
    layers = model_schema(tcfg, dict(zip(NAMES, shape)))["layers"]
    first = 0
    for seg, stacked in zip(build_schedule(tcfg), tree["segments"]):
        for path, desc in walk(layers[first]):
            if desc.init not in ("normal", "small_normal"):
                continue
            node = stacked
            for key in path[:-1]:
                node = node[key]
            a = node[path[-1]]
            node[path[-1]] = (a.astype(np.float32) * np.sqrt(
                a.shape[0] / desc.init_fan_in)).astype(a.dtype)
        first += seg.count
    return jcfg, tree, jax.tree.map(to_torch, tree)


def _ref_forward(shape, jcfg, tree, prompt, max_seq, tokens_in=None,
                 compiler_options=None, bf16_cache=True):
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.models.model import forward_decode as j_decode
    from repro.models.model import forward_prefill as j_prefill
    shd = JCtx(_jmesh(shape))
    rcfg = JRunConfig(attn_q_block=16, attn_kv_block=16)
    params = jax.tree.map(jnp.asarray, tree)
    jit = functools.partial(jax.jit, compiler_options=compiler_options)
    logits, caches = jit(functools.partial(
        j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=max_seq))(
        params, jnp.asarray(prompt))
    if bf16_cache:
        caches = jax.tree.map(lambda c: c.astype(jnp.bfloat16), caches)
    dec = jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
    outs, toks = [np.asarray(logits, np.float32)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32) \
            if tokens_in is None else tokens_in[i]
        toks.append(tok)
        logits, caches = dec(params, caches, jnp.asarray(tok)[:, None],
                             jnp.full((B,), PROMPT + i, jnp.int32))
        outs.append(np.asarray(logits, np.float32))
    return outs, np.stack(toks)


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
        np.testing.assert_allclose(_np(o[:, :, :CP["H"]]),
                                   ref[:, :, :CP["H"]], rtol=1e-5, atol=1e-5)
        assert not o[:, :, CP["H"]:].any()
    np.testing.assert_array_equal(_np(outs[0]), _np(outs[-1]))


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
    jcfg, tree, ttree = _pair(shape, "float32", arch)
    prompt = _prompt()
    j_logits, j_toks = _ref_forward(shape, jcfg, tree, prompt, MAX_SEQ,
                                    bf16_cache=bf16_cache)
    for logits, toks in world.run(_rank_forward, ttree, "float32", prompt,
                                  MAX_SEQ, None, arch, bf16_cache):
        np.testing.assert_array_equal(toks, j_toks)      # identical greedy
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")


def _check_forward_bf16(world, arch, compiler_options=None):
    shape = world.mesh_shape
    jcfg, tree, ttree = _pair(shape, "bfloat16", arch)
    prompt = _prompt()
    j_logits, j_toks = _ref_forward(shape, jcfg, tree, prompt, MAX_SEQ,
                                    compiler_options=compiler_options)
    for logits, _toks in world.run(_rank_forward, ttree, "bfloat16", prompt,
                                   MAX_SEQ, j_toks, arch):
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
    jcfg, tree, ttree = _pair(shape, "bfloat16", VLM)
    prompt = _prompt()
    src, toks = _ref_forward(shape, jcfg, tree, prompt, MAX_SEQ,
                             compiler_options=SOURCE_ROUNDING)
    j32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    f32 = _ref_forward(shape, j32, jax.tree.map(
        lambda a: a.astype(np.float32), tree), prompt, MAX_SEQ, toks)[0]
    variants = (src, _ref_forward(shape, jcfg, tree, prompt, MAX_SEQ, toks)[0],
                _ref_forward((1, 1), jcfg, tree, prompt, MAX_SEQ, toks,
                             compiler_options=SOURCE_ROUNDING)[0])

    def gap(a_runs, b_runs):
        return max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(a_runs, b_runs))
    noise = max(gap(v, f32) for v in variants)
    for logits, _toks in world.run(_rank_forward, ttree, "bfloat16", prompt,
                                   MAX_SEQ, toks, VLM):
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
    jcfg, tree, ttree = _pair(shape, "float32")
    prompt = _prompt()
    j_logits, j_toks = _ref_forward(shape, jcfg, tree, prompt, ODD_MAX_SEQ)
    for logits, toks in world.run(_rank_forward, ttree, "float32", prompt,
                                  ODD_MAX_SEQ, None):
        np.testing.assert_array_equal(toks, j_toks)
        for a, b in zip(logits, j_logits):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _check_drain(world, arch):
    from repro.configs import RunConfig as JRunConfig
    from repro.control.controller import RateController as JController
    from repro.serve.engine import ServeEngine as JEngine
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import TenantScheduler as JScheduler
    import jax.numpy as jnp
    import jax
    shape = world.mesh_shape
    jcfg, tree, ttree = _pair(shape, "float32", arch)
    sched = JScheduler(policy="wfq", charge_prompt=True)
    ctrl = JController(200.0, alpha=0.6)
    ctrl.attach_scheduler(sched)
    jeng = JEngine(jcfg, JRunConfig(attn_q_block=16, attn_kv_block=16),
                   _jmesh(shape), params=jax.tree.map(jnp.asarray, tree),
                   batch_slots=4, max_seq=64, scheduler=sched,
                   controller=ctrl, control_every=4)
    ref = _drain(jeng, sched, _requests(JRequest))
    outs = world.run(_rank_engine, ttree, arch)
    for port in outs:
        assert port == ref


def test_engine_drain_matches_reference(world):
    """Both engines serve the same six requests (WFQ, prompt-charged
    buckets, a RateController every 4 steps) at f32 on the same mesh:
    identical tokens, completion order, served tokens and decode steps,
    the same on every rank."""
    _check_drain(world, ARCH)


def test_vlm_engine_drain_matches_reference(world):
    """The same drain of chameleon-34b."""
    _check_drain(world, VLM)


def test_every_rank_takes_one_clock(world):
    """A multi-rank engine's host decisions read one clock: the first
    rank's monotonic time, broadcast (a given ``now`` is kept)."""
    outs = world.run(_rank_now)
    assert len({now for now, _ in outs}) == 1
    assert all(given == 7.5 for _, given in outs)


@pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b",
                                  "whisper-small", "arctic-480b",
                                  "deepseek-v2-236b"))
def test_other_families_refuse_a_mesh(arch):
    """On a mesh the port serves the dense family only: every other family
    is refused by name, before any weight or group is made."""
    shd = ShardingCtx({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="no sharded path"):
        Model(get_smoke_config(arch), device="cpu", shd=shd)


def test_sharded_serve_on_a_world_of_one_equals_the_unsharded_engine():
    """``chip_smoke.py``'s sharded serve, rehearsed on a gloo world of one
    in this process: the smoke llama3.2-3b through ``ServeEngine`` with
    ``ShardingCtx(make_host_mesh(1, 1))`` gives the unsharded engine's
    tokens and ledger on the same seeded weights (every layout draws the
    same values), and the installed CoreEngine's ledger holds one psum over
    ``model`` for the embedding and two per layer for each prefill and
    decode step."""
    import torch.distributed as dist

    from repro_torch.core import make_engine, use_engine
    from repro_torch.launch import make_host_mesh
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    cfg = get_smoke_config(ARCH)

    def serve(shd):
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        model = init_params(cfg, device="cpu", seed=4, shd=shd)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4,
                          max_seq=64, scheduler=sched, device="cpu", shd=shd)
        return eng, _drain(eng, sched, _requests(Request))

    _, want = serve(None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        shd = ShardingCtx(make_host_mesh(1, 1, device="cpu"))
        core = make_engine(shd.axes, "xla")
        with use_engine(core):
            eng, got = serve(shd)
        psums = sum(ops for _t, verb, axes, ops, _b in core.ledger_table()
                    if verb == "psum" and axes == ("model",))
    finally:
        dist.destroy_process_group()
    assert got == want
    assert psums == (eng.admissions + eng.decode_steps) * \
        (1 + 2 * cfg.num_layers)


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
