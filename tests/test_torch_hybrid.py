"""The port's hybrid family (hymba-1.5b) against the reference's, on the CPU.

The smoke config (``get_smoke_config("hymba-1.5b")``: 2 layers, d_model 64,
4/2 heads of 16, 8 SSD heads of P 16, N 16, chunk 32, window 32, layer 0
global) takes the reference's weights through ``params_from_jax``
(rescaled to true fan-in, ``tests/test_torch_model.py::_pair``). Its
windowed layer keeps a ring cache once ``window < max_seq``. Tolerances:

* f32 (``dtype = param_dtype = "float32"``; both decode from f32 caches,
  the reference's prefill asked for f32 conv tails: with a bf16 cache a
  few k/v and conv entries straddle a bf16 rounding boundary, ROADMAP
  P14): logits within 1e-4, greedy tokens identical, caches within 1e-3;
  at bf16 within 2e-2 of max |logit| (ROADMAP P2);
* the ring decode's kernel call (``pos_eff = min(pos, n_slots - 1)``, no
  window) against the reference's ``kv_pos`` decode: 1e-5 at f32, the
  order of summation only;
* both ``ServeEngine``s: identical tokens, completion order and ledgers.

Prompts of 10, 32 and 40 tokens at ``max_seq`` 64 cover a ring shorter
than the window (valid at model level only: ROADMAP R7), a prompt of
exactly the window (no roll) and one that rolls by 8; decoding runs past
the ring's wrap in each.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.distribution.sharding import ParamDesc, ShardingCtx
from repro.models import attention as jattn
from repro.models.model import build_schedule as j_schedule
from repro.models.model import cache_schema as j_cache_schema
from repro.models.model import model_schema as j_model_schema
from repro.models.model import forward_decode as j_decode, \
    forward_prefill as j_prefill
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import TenantScheduler as JScheduler
from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.kernels import decode_attention as tdk
from repro_torch.models import Model, build_schedule, cache_schema, \
    forward_decode, forward_prefill
from repro_torch.models.attention import is_ring, ring_slots
from repro_torch.models.params import cache_from_jax, params_from_jax
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import TenantScheduler as TScheduler
from _torch_threads import one_thread  # noqa: F401
from test_torch_model import _pair

ARCH = "hymba-1.5b"
B, MAX_SEQ, STEPS = 2, 64, 20
PROMPTS = (10, 32, 40)
WINDOW = 32                  # the smoke config's attn_window
GROUP5 = dict(num_heads=10, num_kv_heads=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cache_dtype(key, dtype):
    """A decode cache keeps the SSM state in f32, the rest in ``dtype``."""
    return "float32" if key == "state" else dtype


def _run_reference(jcfg, params, mesh, prompt, max_seq=MAX_SEQ,
                   tokens_in=None):
    """Prefill + STEPS greedy decode steps from the prefill's own caches
    (its conv tails asked for in the model's dtype), in the model's dtype
    but for the f32 SSM state."""
    shd = ShardingCtx(mesh)
    rcfg = JRunConfig(attn_q_block=16, attn_kv_block=16)
    logits, caches = jax.jit(functools.partial(
        j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=max_seq,
        cache_dtype=jcfg.dtype))(params, jnp.asarray(prompt))
    prefill_caches = caches
    caches = tuple({k: c.astype(getattr(jnp, _cache_dtype(k, jcfg.dtype)))
                    for k, c in seg.items()} for seg in caches)
    dec = jax.jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
    out, toks = [np.asarray(logits, np.float32)], []
    s = prompt.shape[1]
    for i in range(min(STEPS, max_seq - s)):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32) \
            if tokens_in is None else tokens_in[i]
        toks.append(tok)
        pos = jnp.full((prompt.shape[0],), s + i, jnp.int32)
        logits, caches = dec(params, caches, jnp.asarray(tok)[:, None], pos)
        out.append(np.asarray(logits, np.float32))
    return out, np.stack(toks), prefill_caches, caches


def _run_port(model, prompt, max_seq=MAX_SEQ, tokens_in=None, rcfg=None):
    rcfg = rcfg or RunConfig()
    logits, prefill_caches = forward_prefill(
        model, torch.from_numpy(prompt), rcfg, max_seq=max_seq)
    caches = tuple({k: c.to(getattr(torch, _cache_dtype(
        k, model.cfg.dtype)), copy=True) for k, c in seg.items()}
        for seg in prefill_caches)
    out, toks = [_np(logits)], []
    s = prompt.shape[1]
    for i in range(min(STEPS, max_seq - s)):
        tok = torch.argmax(logits, -1).to(torch.int32) if tokens_in is None \
            else torch.from_numpy(tokens_in[i])
        toks.append(tok.numpy())
        pos = torch.full((prompt.shape[0],), s + i, dtype=torch.int32)
        logits, caches = forward_decode(model, caches, tok[:, None], pos,
                                        rcfg)
        out.append(_np(logits))
    return out, np.stack(toks), prefill_caches, caches


def _prompt(cfg, s, b=B):
    return np.random.default_rng(s).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_caches(port, ref):
    """Every leaf in the reference's dtype and shape (the k/v rings or
    padded global caches, the SSM states and conv tails) within 1e-3,
    leaves the reference keeps in bf16 within one bf16 ulp besides."""
    ref = cache_from_jax(jax.tree.map(np.asarray, ref), device="cpu")
    assert len(port) == len(ref)
    for tseg, jseg in zip(port, ref):
        assert set(tseg) == set(jseg) == {"k", "v", "state", "conv_x",
                                          "conv_B", "conv_C"}
        for k in tseg:
            assert tseg[k].shape == jseg[k].shape, k
            rtol = 2 ** -7 if jseg[k].dtype == torch.bfloat16 else 0
            np.testing.assert_allclose(_np(tseg[k].to(jseg[k].dtype)),
                                       _np(jseg[k]), atol=1e-3, rtol=rtol,
                                       err_msg=k)


@pytest.fixture(scope="module")
def f32_pair(mesh1):
    return _pair(ARCH, "float32", mesh1)


# ---------------------------------------------------------------------------
# schedule, schemas, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_build_schedule_matches_reference(smoke):
    """Global layers as one-layer segments with no window, each run of
    windowed layers between them as one: 2 segments at the smoke config,
    5 at full width (layers 0, 15 and 31 global)."""
    tcfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    jcfg = j_smoke(ARCH) if smoke else j_config(ARCH)
    got = [(s.kind, s.count, s.window) for s in build_schedule(tcfg)]
    want = [(s.kind, s.count, s.window) for s in j_schedule(jcfg)]
    assert got == want
    assert len(got) == (2 if smoke else 5)
    assert sum(c for _, c, _ in got) == tcfg.num_layers


@pytest.mark.parametrize("max_seq", [64, 32, 16])
def test_cache_schema_matches_reference(max_seq):
    """Leaf names, shapes and dtypes per segment: the windowed segment
    holds ``min(max_seq, window)`` k/v slots, the global one ``max_seq``;
    SSM states f32, conv tails in the cache dtype."""
    got = cache_schema(get_smoke_config(ARCH), 3, max_seq, "bfloat16")
    want = j_cache_schema(j_smoke(ARCH), 3, max_seq, "bfloat16")
    assert len(got) == len(want)
    for tseg, jseg in zip(got, want):
        assert set(tseg) == set(jseg)
        for k in tseg:
            assert tseg[k].shape == tuple(jseg[k].shape), k
            assert tseg[k].dtype == jseg[k].dtype, k
    assert got[1]["k"].shape[2] == min(max_seq, WINDOW)


def test_full_width_model_builds():
    """hymba-1.5b at full width: 32 layers, every leaf of the reference's
    ``model_schema`` per layer, ~1.6 B parameters (left uninitialized)."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="cpu")
    assert len(model.blocks) == 32
    n = sum(p.numel() for p in model.parameters())
    want = j_model_schema(j_config(ARCH), None)
    assert n == sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, ParamDesc)))
    assert 1.5e9 < n < 1.7e9
    assert set(dict(model.blocks[0].named_children())) >= {
        "ln1", "attn", "ssm", "attn_out_norm", "ssm_out_norm", "ln2", "mlp"}


def test_params_from_jax_covers_every_segment(f32_pair):
    """Each port layer holds its segment's slice of the reference's stacked
    leaves; a reference tree missing a leaf of the second segment is
    refused with that leaf's path."""
    jcfg, tcfg, params, model = f32_pair
    tree = jax.tree.map(np.asarray, params)
    layer = 0
    for si, seg in enumerate(build_schedule(tcfg)):
        for i in range(seg.count):
            blk = model.blocks[layer]
            for path in (("attn", "wq"), ("ssm", "w_x"), ("ssm", "A_log"),
                         ("attn_out_norm", "scale"), ("mlp", "w_in")):
                node = tree["segments"][si]
                for key in path:
                    node = node[key]
                np.testing.assert_array_equal(
                    _np(blk[path[0]][path[1]]), node[i])
            layer += 1
    assert layer == tcfg.num_layers
    del tree["segments"][1]["ssm"]["w_x"]
    with pytest.raises(ValueError, match="ssm.w_x"):
        params_from_jax(tree, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the model: prefill caches, decode past the ring's wrap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", PROMPTS)
def test_model_matches_reference_f32(s, f32_pair, mesh1):
    """Prefill logits and caches (the windowed segment's ring: ``min(32,
    s)`` slots rolled by ``s % 32``; the SSM states and conv tails), then
    decode steps past the ring's wrap: logits within 1e-4, tokens
    identical, caches within 1e-3. The plain path (``naive``: the
    reference's ``kv_pos`` mask) gives the same logits."""
    jcfg, tcfg, params, model = f32_pair
    prompt = _prompt(tcfg, s)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1,
                                                  prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    assert t_pc[1]["k"].shape[2] == min(WINDOW, s)
    assert t_pc[0]["k"].shape[2] == MAX_SEQ
    np.testing.assert_array_equal(t_toks, j_toks)      # identical greedy
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_caches(t_pc, j_pc)
    _assert_caches(t_dc, j_dc)
    n_logits, n_toks, _, _ = _run_port(
        model, prompt, tokens_in=t_toks,
        rcfg=RunConfig(attention_impl="naive"))
    for i, (a, b) in enumerate(zip(n_logits, t_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"naive step {i}")


def test_model_matches_reference_bf16(mesh1):
    """At bf16 (the config as published) within 2e-2 of max |logit| at
    every step, a 40-token prompt decoded past the wrap."""
    jcfg, tcfg, params, model = _pair(ARCH, "bfloat16", mesh1)
    prompt = _prompt(tcfg, 40)
    j_logits, j_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, _, _, _ = _run_port(model, prompt, tokens_in=j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= 2e-2, (i, rel)


@pytest.mark.parametrize("max_seq", [32, 24])
def test_window_at_or_above_max_seq_keeps_the_linear_layout(max_seq,
                                                            f32_pair,
                                                            mesh1):
    """``max_seq <= window``: the windowed segment's cache is the linear
    layout (zero-padded to ``max_seq``, decode writes row ``pos``), as in
    the reference; logits within 1e-4, tokens identical, caches equal."""
    jcfg, tcfg, params, model = f32_pair
    prompt = _prompt(tcfg, 20)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1,
                                                  prompt, max_seq=max_seq)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt, max_seq=max_seq)
    assert t_pc[1]["k"].shape[2] == max_seq
    assert not t_pc[1]["k"][0, :, 20:].any()
    np.testing.assert_array_equal(t_toks, j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_caches(t_pc, j_pc)
    _assert_caches(t_dc, j_dc)


def test_group5_config_matches_reference(mesh1):
    """10/2 heads (group 5, hymba's 25/5 at smoke width): a 40-token
    prompt's prefill and decode past the wrap at f32 within 1e-4, tokens
    identical, caches within 1e-3."""
    jcfg, tcfg, params, model = _pair(ARCH, "float32", mesh1, **GROUP5)
    assert tcfg.num_heads // tcfg.num_kv_heads == 5
    prompt = _prompt(tcfg, 40)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1,
                                                  prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_caches(t_pc, j_pc)
    _assert_caches(t_dc, j_dc)


# ---------------------------------------------------------------------------
# the ring decode's kernel call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [1, 5])
def test_ring_kernel_call_computes_the_references_kv_pos_decode(group):
    """The kernel's function at ``pos_eff = min(pos, n_slots - 1)`` and no
    window, over a ring written at ``pos % n_slots``, equals the
    reference's ring decode (absolute ``kv_pos``, window mask) at every
    position: before the ring fills, at its edge, past one and several
    wraps. ``ring_slots``' slots and positions are the reference's."""
    n, kv, d, window = 32, 2, 16, 32
    pos = np.array([0, 5, 30, 31, 32, 33, 40, 63, 64, 100], np.int32)
    b, hq = len(pos), kv * group
    rng = np.random.default_rng(group)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, n, kv, d)).astype(np.float32)
            for _ in range(2))
    j = np.arange(n)[None, :]
    kv_pos = pos[:, None] - ((pos[:, None] - j) % n)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        kv_map=jnp.arange(hq) // group, window=window,
        kv_pos=jnp.asarray(kv_pos), n_real_heads=hq)
    ring = ring_slots(torch.from_numpy(pos), n, kv_pos=True)
    np.testing.assert_array_equal(ring.kv_pos.numpy(), kv_pos)
    np.testing.assert_array_equal(ring.slot.numpy(), pos % n)
    assert ring.pos_eff.dtype == torch.int32
    got, _, _ = tdk.decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        ring.pos_eff)
    np.testing.assert_allclose(_np(got), np.asarray(want)[:, 0], rtol=1e-5,
                               atol=1e-5)
    assert is_ring(window, n) and is_ring(window, 16)
    assert not is_ring(0, n) and not is_ring(window, 64)


def test_decode_wrapper_takes_groups_1_to_8_and_refuses_off_table_shapes():
    """The kernel's argument check (run before every launch): groups 1-8
    at D 64 (group 7 is arctic-480b's 56/8 heads), not group 12 there, nor
    head dim 192 at group 5 (D 192 is built for group 12 alone)."""
    def check(group, d=64):
        q = torch.zeros(2, 5 * group if group != 12 else 24, d)
        kvh = q.shape[1] // group
        cache = torch.zeros(2, 64, kvh, d, dtype=torch.bfloat16)
        pos = torch.zeros(2, dtype=torch.int32)
        tdk._check(q.to(torch.bfloat16), cache, cache.clone(), pos, 64, 0)

    assert (64, 5) in tdk.SHAPES and (192, 5) not in tdk.SHAPES
    for group in (1, 2, 3, 4, 5, 6, 7, 8):
        check(group)
    with pytest.raises(ValueError, match="group"):
        check(12)
    with pytest.raises(ValueError, match="head dim 192"):
        check(5, d=192)


# ---------------------------------------------------------------------------
# the engines, and R7
# ---------------------------------------------------------------------------


def _requests(request_cls):
    rng = np.random.default_rng(11)
    return [request_cls(
        tenant_id=i % 3,
        prompt=[int(x) for x in rng.integers(1, 256, (32, 37, 45)[i % 3])],
        max_new_tokens=(6, 12, 15)[i % 3], req_id=i, arrival=0.0)
        for i in range(6)]


def _engine_run(engine, scheduler, requests):
    for r in requests:
        engine.submit(r)
    k = 0
    while scheduler.pending() or any(s.active for s in engine.slots):
        k += 1
        engine.step(now=0.1 * k)
        assert k < 200
    return ([(r.req_id, r.generated) for r in engine.completed],
            dict(scheduler.served_tokens), scheduler.ledger(),
            {t: engine.billed_ground_truth(t) for t in range(3)},
            engine.decode_steps)


def test_serve_engine_matches_reference(f32_pair, mesh1):
    """Both engines (WFQ, prompt-charged buckets, 4 slots of 64) serve six
    requests of 32, 37 and 45 tokens, each decoding past its ring's wrap:
    identical tokens, completion order, ledgers and decode steps."""
    jcfg, tcfg, params, model = f32_pair
    jsched = JScheduler(policy="wfq", charge_prompt=True)
    jeng = JEngine(jcfg, JRunConfig(), mesh1, params=params, batch_slots=4,
                   max_seq=MAX_SEQ, scheduler=jsched)
    tsched = TScheduler(policy="wfq", charge_prompt=True)
    teng = TEngine(tcfg, RunConfig(), model, batch_slots=4, max_seq=MAX_SEQ,
                   scheduler=tsched)
    ref = _engine_run(jeng, jsched, _requests(JRequest))
    port = _engine_run(teng, tsched, _requests(TRequest))
    assert port == ref
    for t in range(3):
        assert tsched.served_tokens[t] == teng.billed_ground_truth(t)


def test_short_prompt_is_refused_where_the_reference_fails(f32_pair,
                                                           mesh1):
    """R7: with a ring (window 32 < max_seq 64) a slot holds 32 rows, and
    a 10-token prompt's prefill gives a ring of 10. The reference's engine
    fails at its slot install; the port's refuses the prompt at submit
    with a ValueError naming the limit, queues nothing, and still serves
    a prompt of exactly the window. At ``max_seq <= window`` (no ring)
    the short prompt serves."""
    jcfg, tcfg, params, model = f32_pair
    jeng = JEngine(jcfg, JRunConfig(), mesh1, params=params, batch_slots=2,
                   max_seq=MAX_SEQ)
    jeng.submit(JRequest(tenant_id=0, prompt=list(range(1, 11)),
                         max_new_tokens=4))
    with pytest.raises(ValueError):
        jeng.step()
    eng = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="attn_window = 32"):
        eng.submit(TRequest(tenant_id=0, prompt=list(range(1, 11)),
                            max_new_tokens=4))
    assert not eng.scheduler.pending()
    eng.submit(TRequest(tenant_id=0, prompt=list(range(1, 33)),
                        max_new_tokens=4))
    eng.run_until_drained()
    assert len(eng.completed) == 1 and len(eng.completed[0].generated) == 4
    small = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=WINDOW)
    small.submit(TRequest(tenant_id=0, prompt=list(range(1, 11)),
                          max_new_tokens=4))
    small.run_until_drained()
    assert len(small.completed[0].generated) == 4
