"""Helpers of the model axis's family tests (``test_torch_tp_ssm.py``,
``test_torch_tp_moe.py``, ``test_torch_tp_encdec.py``).

The reference runs on ``make_host_mesh(data, model)`` over the 8 host
devices; the port's ranks run in a spawned gloo world of the same shape
(``tests/_torch_world.py``), one rank a device. Weights are the
reference's ``build_params`` on that mesh, each layer weight (the
encoder's too) rescaled to its true fan-in, as in
``tests/test_torch_model.py``. ``ref_forward`` and ``rank_forward`` run a
prefill and ``STEPS`` greedy decode steps (or teacher-forced ones) and
return every step's full logits; a rank also returns its cache blocks, its
parameter shards and, for a MoE model, the routing choices it made.

A rank imports torch and the port only: everything of jax and the
reference is imported inside the reference-side helpers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.distribution.sharding import ShardingCtx
from repro_torch.models.model import (
    build_schedule, forward_decode, forward_prefill, gather_logits,
    gather_rows, greedy, model_schema,
)
from repro_torch.models.params import params_from_jax
from repro_torch.models.schema import walk

NAMES = ("data", "model")
B, STEPS = 2, 8
BLOCKS = dict(attn_q_block=16, attn_kv_block=16)
F32 = dict(dtype="float32", param_dtype="float32")
# XLA's default lets a chain of elementwise ops skip the bf16 roundings
# between them; the bf16 reference is compiled to round where its source
# casts, as torch does (ROADMAP P15)
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}


def cfg_of(arch: str, dtype: str, changes=()):
    """The port's smoke config of ``arch`` with ``changes`` (pairs of a
    field and a value, or of ``"ssm_head_dim"`` and the SSM head dim)."""
    return _changed(get_smoke_config(arch), dtype, changes)


def _changed(cfg, dtype, changes):
    for key, value in changes:
        if key == "ssm_head_dim":
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, head_dim=value))
        elif key == "capacity_factor":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=value))
        else:
            cfg = dataclasses.replace(cfg, **{key: value})
    return dataclasses.replace(cfg, **F32) if dtype == "float32" else cfg


def np32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def rel(a, b) -> float:
    a, b = np32(a), np32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def cast_cache(caches, dtype):
    """The engine's install: every leaf but an SSM state (f32) into the
    cache dtype."""
    return tuple({k: c if k == "state" else c.to(dtype)
                  for k, c in seg.items()} for seg in caches)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_routes(out: list):
    """Every ``route_topk`` call's expert ids appended to ``out``."""
    from repro_torch.models import moe
    real = moe.route_topk

    def recorded(*args, **kw):
        gate, eidx, aux = real(*args, **kw)
        out.append(eidx.numpy().copy())
        return gate, eidx, aux

    moe.route_topk = recorded
    try:
        yield out
    finally:
        moe.route_topk = real


@contextlib.contextmanager
def attention_nudged(scale: float):
    """Every flash and decode output of ``models/attention.py`` scaled by
    ``scale``: a bf16 noise floor's perturbation (``chip_smoke.py``'s
    ``attention_nudged``, here on the wrappers the CPU path calls)."""
    from repro_torch.models import attention as attn
    flash, decode = attn.flash_attention, attn.decode_kernel

    def flash_nudged(*args, **kw):
        return flash(*args, **kw) * scale

    def decode_nudged(*args, **kw):
        o, *rest = decode(*args, **kw)
        return (o * scale, *rest)

    attn.flash_attention, attn.decode_kernel = flash_nudged, decode_nudged
    try:
        yield
    finally:
        attn.flash_attention, attn.decode_kernel = flash, decode


def rank_forward(axes, arch, dtype, changes, tree, prompt, max_seq,
                 tokens_in, frames=None, cache_dtype=None, nudge=0.0):
    """Prefill + ``STEPS`` decode steps on this rank's shards (every
    attention output scaled by 1 + ``nudge``). Returns (every step's full
    logits, the tokens fed, the rank's final cache blocks, its parameter
    shards by name, its routing choices: each ``route_topk`` call's expert
    ids for its rows, a None after the prefill and after each step)."""
    shd = ShardingCtx(axes)
    cfg = cfg_of(arch, dtype, changes)
    model = params_from_jax(tree, cfg, device="cpu", shd=shd)
    rcfg = RunConfig(**BLOCKS)
    routes = []
    b, s = prompt.shape
    kw = {} if frames is None else {"frames": torch.from_numpy(frames).to(
        getattr(torch, dtype))}
    nudged = attention_nudged(1.0 + nudge) if nudge \
        else contextlib.nullcontext()
    with recorded_routes(routes), nudged:
        logits, caches = forward_prefill(model, torch.from_numpy(prompt),
                                         rcfg, max_seq=max_seq, **kw)
        routes.append(None)
        if cache_dtype is not None:
            caches = cast_cache(caches, getattr(torch, cache_dtype))
        outs, toks = [np32(gather_logits(model, logits, b))], []
        for i in range(STEPS):
            tok = gather_rows(shd, greedy(model, logits), b).to(
                torch.int32) if tokens_in is None \
                else torch.from_numpy(tokens_in[i])
            toks.append(tok.numpy())
            pos = torch.full((b,), s + i, dtype=torch.int32)
            logits, caches = forward_decode(model, caches, tok[:, None],
                                            pos, rcfg, max_seq=max_seq)
            routes.append(None)
            outs.append(np32(gather_logits(model, logits, b)))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return outs, np.stack(toks), caches, params, routes


def rank_engine(axes, arch, tree, requests, max_seq, slots=4):
    """A ``ServeEngine`` drain of ``requests`` (req_id, tenant, prompt,
    max_new) at f32 on this rank's shards (``drain``'s result)."""
    from repro_torch.control.controller import RateController
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    shd = ShardingCtx(axes)
    cfg = cfg_of(arch, "float32")
    model = params_from_jax(tree, cfg, device="cpu", shd=shd)
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(200.0, alpha=0.6)
    ctrl.attach_scheduler(sched)
    eng = ServeEngine(cfg, RunConfig(**BLOCKS), model, batch_slots=slots,
                      max_seq=max_seq, scheduler=sched, controller=ctrl,
                      control_every=4, device="cpu", shd=shd)
    return drain(eng, sched, make_requests(Request, requests))


def make_requests(request_cls, requests):
    return [request_cls(tenant_id=t, prompt=list(p), max_new_tokens=n,
                        req_id=i, arrival=0.0)
            for i, t, p, n in requests]


def request_table(seed: int, n: int, lengths, vocab: int = 256):
    """(req_id, tenant, prompt, max_new_tokens) of ``n`` requests with
    prompts of ``lengths`` (cycled)."""
    rng = np.random.default_rng(seed)
    return tuple((i, i % 3, tuple(int(x) for x in rng.integers(
        1, vocab, lengths[i % len(lengths)])), (6, 9, 12)[i % 3])
        for i in range(n))


def drain(engine, scheduler, requests):
    for r in requests:
        engine.submit(r)
    k = 0
    while scheduler.pending() or any(s.active for s in engine.slots):
        k += 1
        engine.step(now=0.1 * k)
        assert k < 200
    return ([(r.req_id, r.generated) for r in engine.completed],
            dict(scheduler.served_tokens), engine.decode_steps)


def world1_serve(cfg, seed: int = 4, requests=None):
    """``chip_smoke.py``'s world-of-one sharded serve on the CPU: ``cfg``
    from seeded weights through ``ServeEngine`` unsharded, then on
    ``chip_smoke.world_of_one``'s in-process gloo world of one (every
    layout draws the same values). Returns (the sharded run's completed
    tokens, the unsharded run's, the psums over ``model`` in the installed
    CoreEngine's ledger, the psums ``chip_smoke.model_psums`` reckons for
    its admissions and steps)."""
    import chip_smoke
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    requests = requests or request_table(
        5, 6, (33, 40) if cfg.attn_window else (5, 9))

    def serve(shd):
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        model = init_params(cfg, device="cpu", seed=seed, shd=shd)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4,
                          max_seq=64, scheduler=sched, device="cpu", shd=shd)
        return eng, drain(eng, sched, make_requests(Request, requests))

    _, want = serve(None)
    with chip_smoke.world_of_one(torch, torch.device("cpu")) as (shd, core):
        eng, got = serve(shd)
    return got, want, chip_smoke.ledger_psums(core), \
        eng.admissions * chip_smoke.model_psums(cfg, prefill=True) \
        + eng.decode_steps * chip_smoke.model_psums(cfg, prefill=False)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jmesh(shape):
    from repro.launch.mesh import make_host_mesh
    return make_host_mesh(*shape)


def _rescale(stacked, schema):
    for path, desc in walk(schema):
        if desc.init not in ("normal", "small_normal"):
            continue
        node = stacked
        for key in path[:-1]:
            node = node[key]
        a = node[path[-1]]
        node[path[-1]] = (a.astype(np.float32) * np.sqrt(
            a.shape[0] / desc.init_fan_in)).astype(a.dtype)


@functools.lru_cache(maxsize=None)
def pair(shape, arch, dtype, changes=()):
    """The reference's config and weights on ``shape``'s mesh (layer
    weights rescaled to their true fan-in), as numpy and as torch
    tensors for the ranks."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.models.model import build_params
    from repro_torch.models.params import to_torch
    jcfg = _changed(j_smoke(arch), dtype, changes)
    tcfg = cfg_of(arch, dtype, changes)
    tree = jax.tree.map(np.asarray,
                        build_params(jcfg, jmesh(shape),
                                     jax.random.PRNGKey(0)))
    schema = model_schema(tcfg, dict(zip(NAMES, shape)))
    first = 0
    for seg, stacked in zip(build_schedule(tcfg), tree["segments"]):
        _rescale(stacked, schema["layers"][first])
        first += seg.count
    if tcfg.encoder_layers:
        _rescale(tree["encoder"]["segments"][0],
                 schema["encoder"]["layers"][0])
    return jcfg, tree, jax.tree.map(to_torch, tree)


@contextlib.contextmanager
def ref_routes(out: list):
    """The reference's routing choices, each ``route_topk`` call's expert
    ids appended to ``out`` from inside its compiled forward (an
    unordered callback: ``same_routes`` compares them as a multiset)."""
    import jax
    from repro.models import moe as jmoe
    real = jmoe.route_topk

    def recorded(router_w, x, m):
        gate, eidx, aux = real(router_w, x, m)
        jax.debug.callback(lambda e: out.append(np.asarray(e)), eidx)
        return gate, eidx, aux

    jmoe.route_topk = recorded
    try:
        yield out
    finally:
        jmoe.route_topk = real


def ref_forward(shape, jcfg, tree, prompt, max_seq, tokens_in=None,
                frames=None, cache_dtype=None, compiler_options=None):
    """The reference's prefill + ``STEPS`` decode steps on ``shape``'s
    mesh: (every step's logits, the tokens fed, the final caches as
    numpy, the routing choices)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.distribution.sharding import ShardingCtx as JCtx
    from repro.models.model import forward_decode as j_decode
    from repro.models.model import forward_prefill as j_prefill
    shd = JCtx(jmesh(shape))
    rcfg = JRunConfig(**BLOCKS)
    params = jax.tree.map(jnp.asarray, tree)
    jit = functools.partial(jax.jit, compiler_options=compiler_options)
    b, s = prompt.shape
    kw = {} if frames is None else {
        "frames": jnp.asarray(frames, getattr(jnp, jcfg.dtype))}
    routes = []
    with ref_routes(routes):
        logits, caches = jit(functools.partial(
            j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=max_seq,
            cache_dtype=cache_dtype or "bfloat16"))(
            params, jnp.asarray(prompt), **kw)
        jax.effects_barrier()
        routes.append(None)
        if cache_dtype is not None:
            caches = tuple({k: c if k == "state" else
                            c.astype(getattr(jnp, cache_dtype))
                            for k, c in seg.items()} for seg in caches)
        dec = jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
        outs, toks = [np.asarray(logits, np.float32)], []
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(logits, -1), np.int32) \
                if tokens_in is None else tokens_in[i]
            toks.append(tok)
            logits, caches = dec(params, caches, jnp.asarray(tok)[:, None],
                                 jnp.full((b,), s + i, jnp.int32))
            outs.append(np.asarray(logits, np.float32))
            jax.effects_barrier()
            routes.append(None)
    return outs, np.stack(toks), jax.tree.map(np.asarray, caches), routes


def ref_engine(shape, jcfg, tree, requests, max_seq, slots=4):
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.control.controller import RateController as JController
    from repro.serve.engine import ServeEngine as JEngine
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import TenantScheduler as JScheduler
    sched = JScheduler(policy="wfq", charge_prompt=True)
    ctrl = JController(200.0, alpha=0.6)
    ctrl.attach_scheduler(sched)
    eng = JEngine(jcfg, JRunConfig(**BLOCKS), jmesh(shape),
                  params=jax.tree.map(jnp.asarray, tree), batch_slots=slots,
                  max_seq=max_seq, scheduler=sched, controller=ctrl,
                  control_every=4)
    return drain(eng, sched, make_requests(JRequest, requests))


def by_step(routes):
    """Routing choices split at their None markers: one list of calls for
    the prefill and for each decode step."""
    steps, cur = [], []
    for r in routes:
        if r is None:
            steps.append(cur)
            cur = []
        else:
            cur.append(np.asarray(r, np.int64))
    return steps


def rows_routes(rank_routes, shape, split: bool):
    """The port's routing choices by step over the global rows: each
    call's choices of the data ranks' rows, in row order, where the rows
    ``split`` over ``data`` (rank ``d * model`` holds data block ``d``;
    every rank of a block routes alike), else rank 0's."""
    data, model = shape
    if not split or data == 1:
        return by_step(rank_routes[0])
    ranks = [by_step(rank_routes[d * model]) for d in range(data)]
    return [[np.concatenate([r[i][c] for r in ranks])
             for c in range(len(ranks[0][i]))]
            for i in range(len(ranks[0]))]


def same_calls(a, b) -> bool:
    """One step's routing calls, as multisets of expert-id arrays (the
    reference's callbacks are unordered within a step)."""
    def key(calls):
        return sorted((c.shape, c.tobytes()) for c in calls)
    return key(a) == key(b)


def addressable(shape, arr: np.ndarray, spec, rank: int) -> np.ndarray:
    """The reference's shard of ``arr`` laid out by ``spec`` on the
    device at ``rank``'s mesh coordinate."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    mesh = jmesh(shape)
    placed = jax.device_put(arr, NamedSharding(mesh, PartitionSpec(*spec)))
    dev = mesh.devices[np.unravel_index(rank, shape)]
    (shard,) = [s for s in placed.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def check_cache_shards(shape, jcfg, j_caches, rank_caches, batch, max_seq,
                       atol):
    """Every rank's cache blocks equal the reference's addressable shards
    of its final caches, laid out by the reference's cache schema on the
    mesh (values within ``atol``); returns the leaves compared."""
    from repro.distribution.sharding import spec_for
    from repro.models.model import cache_schema as j_cache_schema
    mesh = jmesh(shape)
    schema = j_cache_schema(jcfg, batch, max_seq)
    n = 0
    for rank, caches in enumerate(rank_caches):
        for seg, j_seg, t_seg in zip(schema, j_caches, caches):
            assert sorted(j_seg) == sorted(t_seg)
            for key, desc in seg.items():
                want = addressable(shape, np.asarray(j_seg[key]),
                                   spec_for(desc.shape, desc.dims, mesh),
                                   rank)
                got = np32(t_seg[key])
                assert got.shape == want.shape, (rank, key)
                np.testing.assert_allclose(got, want.astype(np.float32),
                                           rtol=0, atol=atol,
                                           err_msg=f"rank {rank} {key}")
                n += 1
    return n


def check_param_shards(shape, arch, dtype, changes, tree, rank_params):
    """Every rank's parameter shards equal, bit for bit, the reference's
    addressable shards of its weights laid out by the serving rules (the
    model-sharded ``TP_RULES`` layout: ``pod``/``data`` stripped)."""
    from repro.distribution.sharding import spec_for, strip_axes_from_rules
    from repro_torch.models.params import _stacks, _tops
    cfg = cfg_of(arch, dtype, changes)
    mesh = jmesh(shape)
    rules = strip_axes_from_rules(("pod", "data"))
    schema = model_schema(cfg, dict(zip(NAMES, shape)))
    leaves = []
    for top, sch, name in _tops(cfg, schema):
        for path, desc in walk(sch):
            node = tree
            for key in top + path:
                node = node[key]
            leaves.append((".".join((name,) + path), desc, node))
    for ref, sch, names in _stacks(cfg, schema):
        stacked = tree
        for key in ref:
            stacked = stacked[key]
        for i, name in enumerate(names):
            for path, desc in walk(sch):
                node = stacked
                for key in path:
                    node = node[key]
                leaves.append((".".join((name,) + path), desc, node[i]))
    split = 0
    for rank, params in enumerate(rank_params):
        assert len(params) == len(leaves)
        for name, desc, full in leaves:
            spec = spec_for(desc.shape, desc.dims, mesh, rules)
            split += bool(spec)
            want = addressable(shape, np.asarray(full), spec, rank)
            got = params[name]
            assert tuple(got.shape) == want.shape, (rank, name)
            assert np.array_equal(np32(got), want.astype(np.float32)), \
                (rank, name)
    return split


# ---------------------------------------------------------------------------
# the moe family's checks (test_torch_tp_moe.py: arctic; test_torch_tp_
# mla.py: deepseek), each on the calling module's world
# ---------------------------------------------------------------------------

MOE_PROMPT, MOE_MAX_SEQ = 24, 48


def moe_prompt():
    return np.random.default_rng(7).integers(0, 256, (B, MOE_PROMPT)).astype(
        np.int32)


def moe_f32_run(world, arch, runs: dict):
    """The reference's and every rank's f32 run on this world, once per
    (world, arch) in ``runs``."""
    key = (world.mesh_shape, arch)
    if key not in runs:
        shape = world.mesh_shape
        jcfg, tree, ttree = pair(shape, arch, "float32")
        ref = ref_forward(shape, jcfg, tree, moe_prompt(), MOE_MAX_SEQ,
                          cache_dtype="float32")
        ranks = world.run(rank_forward, arch, "float32", (), ttree,
                          moe_prompt(), MOE_MAX_SEQ, None, None, "float32")
        runs[key] = jcfg, tree, ref, ranks
    return runs[key]


def check_moe_f32(world, arch, runs: dict):
    """f32: identical routing choices call by call (the rows gathered over
    ``data``), identical tokens, logits within 1e-4."""
    _jcfg, _tree, (j_logits, j_toks, _c, j_routes), ranks = \
        moe_f32_run(world, arch, runs)
    want = by_step(j_routes)
    got = rows_routes([r[4] for r in ranks], world.mesh_shape, True)
    assert len(got) == len(want) == STEPS + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert same_calls(a, b), f"routing differs at step {i}"
    for logits, toks, *_ in ranks:
        np.testing.assert_array_equal(toks, j_toks)
        for i, (a, b) in enumerate(zip(logits, j_logits)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")


# The first step whose routing differs from the source-rounded
# reference's, on each world (STEPS + 1: none does), measured by
# check_moe_bf16 (ROADMAP P21): a change that flips a choice earlier fails
BF16_HELD = {"arctic-480b": {(2, 2): STEPS + 1, (1, 2): STEPS + 1,
                             (1, 8): 1},
             "deepseek-v2-236b": {(2, 2): STEPS + 1, (1, 2): STEPS + 1,
                                  (1, 8): STEPS + 1}}
FLOOR_NUDGE = 2 ** -8     # relative, about one bf16 ulp (ROADMAP P20)


def check_moe_bf16(world, arch):
    """bf16, teacher-forced with the source-rounded reference's tokens.
    Every step before the first whose routing differs from that run's is
    within 2e-2 of max |logit| of the reference compiled one of its two
    ways (rounding where its source casts, or with XLA's default excess
    precision: the reference's bf16 function is defined up to that
    choice, and at these models' size the two move apart by up to ~2e-2),
    and that first step is no earlier than ``BF16_HELD`` records. The
    steps from a flipped choice on are held at P20's noise floor: within
    2e-2, or no farther than the port's own bf16 run is from itself with
    every attention output scaled by 1 + 2^-8 or 1 - 2^-8 (its largest
    gap over the steps, each sign teacher-forced alike)."""
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, arch, "bfloat16")
    src, toks, _c, j_routes = ref_forward(
        shape, jcfg, tree, moe_prompt(), MOE_MAX_SEQ, cache_dtype="bfloat16",
        compiler_options=SOURCE_ROUNDING)
    dflt = ref_forward(shape, jcfg, tree, moe_prompt(), MOE_MAX_SEQ, toks,
                       cache_dtype="bfloat16")[0]

    def port(nudge=0.0):
        return world.run(rank_forward, arch, "bfloat16", (), ttree,
                         moe_prompt(), MOE_MAX_SEQ, toks, None, "bfloat16",
                         nudge)
    ranks = port()
    want = by_step(j_routes)
    got = rows_routes([r[4] for r in ranks], shape, True)
    flipped = [i for i, (a, b) in enumerate(zip(got, want))
               if not same_calls(a, b)]
    held = flipped[0] if flipped else len(want)
    assert held >= BF16_HELD[arch][shape], flipped
    floor = 0.0
    if flipped:
        for sign in (1, -1):
            nudged = port(sign * FLOOR_NUDGE)
            floor = max(floor, max(rel(a, b) for a, b in zip(
                nudged[0][0], ranks[0][0])))
    for logits, *_ in ranks:
        gaps = [min(rel(a, b), rel(a, c))
                for a, b, c in zip(logits, src, dflt)]
        assert max(gaps[:held]) <= 2e-2, (gaps, flipped)
        assert max(gaps[held:], default=0.0) <= max(2e-2, floor), \
            (gaps, flipped, floor)
    print(f"{arch} {shape} bf16: steps with a flipped choice {flipped}, "
          f"gaps {['%.2e' % g for g in gaps]}, floor {floor:.2e}")


def check_moe_shards(world, arch, runs: dict):
    shape = world.mesh_shape
    jcfg, tree, (_l, _t, j_caches, _r), ranks = moe_f32_run(world, arch,
                                                            runs)
    split = check_param_shards(shape, arch, "float32", (), tree,
                               [r[3] for r in ranks])
    assert split > 0
    n = check_cache_shards(shape, jcfg, j_caches, [r[2] for r in ranks], B,
                           MOE_MAX_SEQ, atol=1e-4)
    assert n == len(ranks) * sum(len(seg) for seg in j_caches)


def check_drain(world, arch, requests, max_seq):
    """Both engines drain ``requests`` (WFQ, prompt-charged buckets, a
    RateController every 4 steps) at f32 on ``world``'s mesh: identical
    tokens, completion order, served tokens and decode steps on every
    rank."""
    shape = world.mesh_shape
    jcfg, tree, ttree = pair(shape, arch, "float32")
    ref = ref_engine(shape, jcfg, tree, requests, max_seq)
    for port in world.run(rank_engine, arch, ttree, requests, max_seq):
        assert port == ref


def check_moe_drain(world, arch):
    """Six requests with prompts of 9 and 14 tokens."""
    check_drain(world, arch, request_table(12, 6, (9, 14)), MOE_MAX_SEQ)
