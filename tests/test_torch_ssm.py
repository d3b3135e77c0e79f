"""The port's Mamba-2 (``ssm`` family) against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port's SSD scan runs its kernel's plain version (CPU tensors), the
reference's ``ssd_chunked`` its inline jnp. Tolerances:

* modules at f32 (``causal_conv``, ``conv_step``, ``ssd_chunked``,
  ``ssd_decode_step``, ``_segsum``): 1e-5, summation order only; the
  chunked scan also against the token-by-token recurrence in f64 within
  the reference's own 2e-3 (``tests/test_ssm.py``);
* the smoke model (``get_smoke_config("mamba2-370m")``: 2 layers, d_model
  64, 8 SSD heads of P 16, N 16, chunk 32) with the reference's weights
  (rescaled to true fan-in, as ``tests/test_torch_model.py`` does): at f32
  logits within 1e-4, greedy tokens identical over 16 decode steps, the
  caches within 1e-3 (conv tails compared in the reference's bf16 cache
  dtype, one bf16 ulp apart at most); at bf16 within 2e-2 of max |logit|
  (the two packages round bf16 at different points: ROADMAP P2 and P5);
* both ``ServeEngine``s on the f32 smoke model: identical tokens,
  completion order and ledgers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke_config as j_smoke
from repro.distribution.sharding import ShardingCtx
from repro.models import ssm as jssm
from repro.models.model import forward_decode as j_decode, \
    forward_prefill as j_prefill
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import TenantScheduler as JScheduler
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.models import cache_schema, forward_decode, \
    forward_prefill, init_cache, init_params, model_schema
from repro_torch.models import ssm as tssm
from repro_torch.models.params import cache_from_jax
from repro_torch.models.schema import INITS, ParamDesc, walk
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import TenantScheduler as TScheduler
from _torch_threads import one_thread  # noqa: F401
from test_torch_model import _pair

ARCH = "mamba2-370m"
B, MAX_SEQ, STEPS = 2, 64, 16
PROMPT = 45                 # one full chunk of 32 and a padded one
F32 = dict(dtype="float32", param_dtype="float32")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _scan_inputs(seed, b, l, h, p, n):
    """``tests/test_ssm.py``'s scales: x*dt 0.2, dA = -0.2 |N|, B, C 0.4."""
    return (_rand(seed, b, l, h, p) * 0.2,
            -np.abs(_rand(seed + 1, b, l, h)) * 0.2,
            _rand(seed + 2, b, l, n) * 0.4, _rand(seed + 3, b, l, n) * 0.4)


def _naive_ssd(xdt, dA, B, C):
    """Token-by-token recurrence in f64: h_t = exp(dA_t) h_{t-1} + B_t x_t."""
    b, l, h, p = xdt.shape
    state = np.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        state = state * np.exp(dA[:, t].astype(np.float64))[:, :, None,
                                                              None] \
            + np.einsum("bhp,bn->bhpn", xdt[:, t].astype(np.float64),
                        B[:, t].astype(np.float64))
        ys.append(np.einsum("bhpn,bn->bhp", state,
                            C[:, t].astype(np.float64)))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("l,chunk", [(64, 16), (60, 16), (16, 16),
                                     (13, 16), (48, 64), (45, 32)])
def test_ssd_chunked_matches_reference_and_recurrence(l, chunk):
    """Lengths on, below and across a chunk multiple: y and the final
    state against the reference's ``ssd_chunked`` (1e-5) and the f64
    recurrence (2e-3); with an initial state too."""
    arrays = _scan_inputs(l, 2, l, 4, 8, 16)
    y, st = tssm.ssd_chunked(*map(_t, arrays), chunk)
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk)
    assert y.dtype == st.dtype == torch.float32
    ny, nst = _naive_ssd(*arrays)
    # which side moved, should the two ever disagree: each against the f64
    # recurrence (both sit ~3e-7 from it on this input)
    side = (f"max |y - f64|: port {np.abs(_np(y) - ny).max()}, reference "
            f"{np.abs(_np(jy) - ny).max()}")
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5,
                               err_msg=side)
    np.testing.assert_allclose(_np(st), _np(jst), rtol=1e-5, atol=1e-5,
                               err_msg=side)
    np.testing.assert_allclose(_np(y), ny, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(st), nst, rtol=2e-3, atol=2e-3)
    s0 = _rand(l + 7, 2, 4, 8, 16)
    y0, st0 = tssm.ssd_chunked(*map(_t, arrays), chunk,
                               initial_state=_t(s0))
    jy0, jst0 = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                 initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(y0), _np(jy0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(st0), _np(jst0), rtol=1e-5, atol=1e-5)


def test_ssd_chunked_is_fixed_by_its_inputs():
    """On the CPU the scan's products are summed in f64 and rounded once:
    the same inputs give the same bits whatever thread count the host's
    BLAS runs with."""
    arrays = [_t(a) for a in _scan_inputs(64, 2, 64, 4, 8, 16)]
    threads = torch.get_num_threads()
    try:
        outs = []
        for n in (1, 2, 3, 8):
            torch.set_num_threads(n)
            outs.append(tssm.ssd_chunked(*arrays, 16))
    finally:
        torch.set_num_threads(threads)
    for y, st in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(st, outs[0][1])


def test_ssd_chunked_takes_state_decay_from_the_scan(monkeypatch):
    """``ssd_chunked`` weights the inter-chunk output with the scan's own
    ``state_decay`` and computes no cumsum of its own."""
    import inspect
    asked = []
    plain = tssm.ssd_chunk_scan_plain

    def spy(*args, **kw):
        asked.append(kw.get("state_decay"))
        return plain(*args, **kw)

    arrays = [_t(a) for a in _scan_inputs(6, 2, 40, 4, 8, 16)]
    want = tssm.ssd_chunked(*arrays, 16, naive=True)
    monkeypatch.setattr(tssm, "ssd_chunk_scan_plain", spy)
    got = tssm.ssd_chunked(*arrays, 16, naive=True)
    assert asked == [True]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert "cumsum" not in inspect.getsource(tssm.ssd_chunked)


def test_ssd_chunked_naive_and_kernel_paths_agree():
    """``naive`` picks the kernel's plain version; on the CPU the kernel
    wrapper takes that same plain version, so the two are equal."""
    arrays = [_t(a) for a in _scan_inputs(3, 1, 50, 4, 16, 16)]
    a = tssm.ssd_chunked(*arrays, 32)
    b = tssm.ssd_chunked(*arrays, 32, naive=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_steps_continue_the_chunked_scan():
    """Prefill state + single decode steps == the full-sequence scan, and
    each step equals the reference's ``ssd_decode_step`` (1e-5)."""
    b, l, h, p, n = 1, 24, 2, 4, 8
    xdt, dA, Bm, Cm = _scan_inputs(5, b, l + 4, h, p, n)
    y_full, st_full = tssm.ssd_chunked(*map(_t, (xdt, dA, Bm, Cm)), 8)
    _, st = tssm.ssd_chunked(*(_t(a[:, :l]) for a in (xdt, dA, Bm, Cm)), 8)
    jst = jnp.asarray(st.numpy())
    ones = np.ones((b, h), np.float32)
    for t in range(l, l + 4):
        # dt = 1 turns ssd_decode_step's exp(dt * A) into exp(dA)
        args = (xdt[:, t], ones, dA[0, t], Bm[:, t], Cm[:, t])
        y_t, st = tssm.ssd_decode_step(*map(_t, args), st)
        jy_t, jst = jssm.ssd_decode_step(*map(jnp.asarray, args), jst)
        np.testing.assert_allclose(_np(y_t), _np(jy_t), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(st), _np(jst), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(y_t), _np(y_full[:, t]), rtol=2e-3,
                                   atol=2e-3)
    np.testing.assert_allclose(_np(st), _np(st_full), rtol=2e-3, atol=2e-3)


def test_conv_and_segsum_match_reference():
    """``causal_conv`` and ``conv_step`` against the reference's (1e-5);
    streaming ``conv_step`` reproduces ``causal_conv``; ``_segsum`` equal
    to the reference's, -inf above the diagonal."""
    b, l, c, w = 2, 10, 6, 4
    u, wgt = _rand(40, b, l, c), _rand(41, w, c)
    y = tssm.causal_conv(_t(u), _t(wgt))
    np.testing.assert_allclose(_np(y), _np(jssm.causal_conv(
        jnp.asarray(u), jnp.asarray(wgt))), rtol=1e-5, atol=1e-5)
    state = torch.from_numpy(_rand(42, b, w - 1, c))
    jstate = jnp.asarray(state.numpy())
    for t in range(l):
        y_t, state = tssm.conv_step(_t(u[:, t]), state, _t(wgt))
        jy_t, jstate = jssm.conv_step(jnp.asarray(u[:, t]), jstate,
                                      jnp.asarray(wgt))
        np.testing.assert_allclose(_np(y_t), _np(jy_t), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(state), _np(jstate))
    zero = torch.zeros(b, w - 1, c)
    outs = []
    for t in range(l):
        y_t, zero = tssm.conv_step(_t(u[:, t]), zero, _t(wgt))
        outs.append(y_t)
    torch.testing.assert_close(torch.stack(outs, 1), y, rtol=1e-5,
                               atol=1e-5)
    x = _rand(43, 3, 9) * 0.3
    got, want = _np(tssm._segsum(_t(x))), _np(jssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model: prefill + decode
# ---------------------------------------------------------------------------


def _serving_cache_dtype(key):
    """The serving cache keeps the SSM state in f32, the rest in bf16."""
    return jnp.float32 if key == "state" else jnp.bfloat16


def _run_reference(jcfg, params, mesh, prompt, tokens_in=None):
    shd, rcfg = ShardingCtx(mesh), JRunConfig()
    logits, caches = jax.jit(functools.partial(
        j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=MAX_SEQ))(
        params, jnp.asarray(prompt))
    prefill_caches = caches
    # the serving engine installs the prefill cache into its own cache
    caches = tuple({k: c.astype(_serving_cache_dtype(k))
                    for k, c in seg.items()} for seg in caches)
    dec = jax.jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
    out_logits, toks = [np.asarray(logits, np.float32)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32) \
            if tokens_in is None else tokens_in[i]
        toks.append(tok)
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        logits, caches = dec(params, caches, jnp.asarray(tok)[:, None], pos)
        out_logits.append(np.asarray(logits, np.float32))
    return out_logits, np.stack(toks), prefill_caches, caches


def _run_port(model, prompt, tokens_in=None, rcfg=None):
    rcfg = rcfg or RunConfig()
    logits, prefill_caches = forward_prefill(
        model, torch.from_numpy(prompt), rcfg, max_seq=MAX_SEQ)
    caches = init_cache(model.cfg, B, MAX_SEQ, device="cpu")
    for big, one in zip(caches, prefill_caches):
        for k in big:
            big[k].copy_(one[k])
    out_logits, toks = [_np(logits)], []
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32) if tokens_in is None \
            else torch.from_numpy(tokens_in[i])
        toks.append(tok.numpy())
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, caches = forward_decode(model, caches, tok[:, None], pos,
                                        rcfg)
        out_logits.append(_np(logits))
    return out_logits, np.stack(toks), prefill_caches, caches


def _prompt(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def _assert_caches(port, ref):
    """Leaves in the reference's dtype: the state in f32 within 1e-3, the
    conv tails (bf16 in the reference's caches) within one bf16 ulp."""
    ref = cache_from_jax(jax.tree.map(np.asarray, ref), device="cpu")
    assert len(port) == len(ref)
    for tseg, jseg in zip(port, ref):
        assert set(tseg) == set(jseg) == {"state", "conv_x", "conv_B",
                                          "conv_C"}
        for k in tseg:
            assert tseg[k].shape == jseg[k].shape, k
            got = tseg[k].to(jseg[k].dtype)
            rtol = 0 if k == "state" else 2 ** -7
            np.testing.assert_allclose(_np(got), _np(jseg[k]), atol=1e-3,
                                       rtol=rtol, err_msg=k)


def test_model_matches_reference_f32(mesh1):
    jcfg, tcfg, params, model = _pair(ARCH, "float32", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1,
                                                  prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)       # identical greedy
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    assert t_dc[0]["state"].dtype == torch.float32
    _assert_caches(t_pc, j_pc)
    _assert_caches(t_dc, j_dc)
    # the plain path under "naive" is the same function on the CPU
    n_logits, n_toks, _, _ = _run_port(
        model, prompt, rcfg=RunConfig(attention_impl="naive"))
    np.testing.assert_array_equal(n_toks, t_toks)
    np.testing.assert_allclose(n_logits[-1], t_logits[-1], rtol=0, atol=0)


def test_model_matches_reference_bf16(mesh1):
    jcfg, tcfg, params, model = _pair(ARCH, "bfloat16", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, _, _, t_dc = _run_port(model, prompt, tokens_in=j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= 2e-2, (i, rel)
    assert t_dc[0]["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# cache layout, init, prompt limits
# ---------------------------------------------------------------------------


def test_cache_leaves_carry_their_own_dtypes():
    """Under a bf16 cache dtype the SSM state stays f32 (the reference's
    ``ssm_cache_schema``); the conv tails take the cache dtype."""
    cfg = get_smoke_config(ARCH)
    s = cfg.ssm
    nh = s.num_heads(cfg.d_model)
    (sch,) = cache_schema(cfg, 3, MAX_SEQ, "bfloat16")
    assert sch["state"].dtype == "float32"
    (seg,) = init_cache(cfg, 3, MAX_SEQ, dtype="bfloat16", device="cpu")
    assert seg["state"].dtype == torch.float32
    assert tuple(seg["state"].shape) == (cfg.num_layers, 3, nh, s.head_dim,
                                         s.state_dim)
    for k, c in (("conv_x", s.d_inner(cfg.d_model)), ("conv_B", s.state_dim),
                 ("conv_C", s.state_dim)):
        assert seg[k].dtype == torch.bfloat16, k
        assert tuple(seg[k].shape) == (cfg.num_layers, 3, s.conv_width - 1,
                                       c), k
    dense = init_cache(get_smoke_config("llama3.2-3b"), 2, 16,
                       dtype="float32", device="cpu")[0]
    assert {t.dtype for t in dense.values()} == {torch.float32}


def test_prefill_cache_is_not_padded_along_ssm_leaves():
    """Only sequence-laid-out leaves (k/v) are padded to max_seq; the
    state and conv tails come out of a prefill in their decode shapes."""
    cfg = get_smoke_config(ARCH)
    model = init_params(cfg, device="cpu", seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 37))
    _, (seg,) = forward_prefill(model, tokens, RunConfig(), max_seq=MAX_SEQ)
    (want,) = init_cache(cfg, 1, MAX_SEQ, device="cpu")
    for k in want:
        assert seg[k].shape == want[k].shape, k
    assert seg["state"].dtype == torch.float32


def test_init_params_conv_taps_and_ssm_leaves():
    """The conv taps are "small_normal" at 0.5 over their true fan-in, the
    conv width (std 0.25); A_log and dt_bias are zeros and D ones, all
    f32; an unknown init kind is refused."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), **F32)
    descs = dict(walk(model_schema(cfg)["layers"][0]))
    assert descs[("ssm", "conv_x")].init == "small_normal"
    assert descs[("ssm", "conv_x")].init_fan_in == cfg.ssm.conv_width
    assert "small_normal" in INITS
    with pytest.raises(ValueError):
        ParamDesc((2, 2), "float32", "uniform")
    wide = dataclasses.replace(cfg, d_model=512, num_layers=1)
    model = init_params(wide, device="cpu", seed=0)
    ssm = model.blocks[0]["ssm"]
    std = float(ssm["conv_x"].std())
    assert abs(std - 0.25) < 0.01, std
    assert ssm["A_log"].dtype == ssm["D"].dtype == torch.float32
    assert not ssm["A_log"].any() and not ssm["dt_bias"].any()
    assert (ssm["D"] == 1).all()


def test_short_prompt_is_refused_with_its_limit(mesh1):
    """R5: a prompt shorter than conv_width - 1 = 3 tokens leaves conv
    tails too short to stream from. The port refuses it with a ValueError
    that names the limit (at submit and in forward_prefill); the reference
    fails on it at its slot install. Three tokens serve."""
    cfg = get_smoke_config(ARCH)
    model = init_params(cfg, device="cpu", seed=0)
    eng = TEngine(cfg, RunConfig(), model, batch_slots=2, max_seq=16)
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        eng.submit(TRequest(tenant_id=0, prompt=[1, 2], max_new_tokens=4))
    with pytest.raises(ValueError, match="conv_width - 1 = 3"):
        forward_prefill(model, torch.tensor([[1, 2]]), RunConfig(),
                        max_seq=16)
    assert not eng.scheduler.pending()
    eng.submit(TRequest(tenant_id=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.run_until_drained()
    assert len(eng.completed) == 1 and len(eng.completed[0].generated) == 4
    jcfg = j_smoke(ARCH)
    jeng = JEngine(jcfg, JRunConfig(), mesh1, batch_slots=2, max_seq=16)
    jeng.submit(JRequest(tenant_id=0, prompt=[1, 2], max_new_tokens=4))
    with pytest.raises(ValueError):
        jeng.step()


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged(mesh1):
    return _pair(ARCH, "float32", mesh1)


def _requests(request_cls):
    rng = np.random.default_rng(11)
    return [request_cls(
        tenant_id=i % 3,
        prompt=[int(x) for x in rng.integers(1, 256, (5, 37)[i % 2])],
        max_new_tokens=(6, 9, 12)[i % 3], req_id=i, arrival=0.0)
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


def test_serve_engine_matches_reference(bridged, mesh1):
    """Both engines (WFQ, prompt-charged buckets) serve six requests of
    5 and 37 tokens with the same f32 weights: identical tokens,
    completion order, ledgers and decode steps."""
    jcfg, tcfg, params, model = bridged
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


def test_suspend_resume_serves_bit_identical(bridged):
    """suspend() drops the SSM cache and slot table; serving after
    resume() is bit-identical to serving before."""
    _, tcfg, _, model = bridged
    sched = TScheduler(policy="wfq", charge_prompt=True)
    eng = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32,
                  scheduler=sched)

    def serve(req_id):
        eng.submit(TRequest(tenant_id=0, prompt=[4, 5, 6, 7],
                            max_new_tokens=5, req_id=req_id, arrival=0.0))
        for k in range(12):
            eng.step(now=0.1 * (k + 1))
        return eng.completed[-1]

    before = serve(0)
    resident = eng.resident_bytes()
    assert resident > 0 and eng.suspend() == resident
    assert eng.caches is None
    eng.resume()
    after = serve(1)
    assert eng.resident_bytes() == resident
    assert after.generated == before.generated


def test_slot_install_overwrites_the_whole_slot(bridged):
    """Idle slots keep stepping their SSM state (token 0 at position 0);
    an admission must overwrite the slot's state and conv tails whole, so
    a request served after others equals one served on a fresh engine."""
    _, tcfg, _, model = bridged
    eng = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32)
    eng.submit(TRequest(tenant_id=0, prompt=[5, 6, 7, 8, 9, 10],
                        max_new_tokens=8))
    eng.run_until_drained()
    eng.submit(TRequest(tenant_id=1, prompt=[3, 4, 5], max_new_tokens=2))
    eng._admit()
    fresh = TEngine(tcfg, RunConfig(), model, batch_slots=2, max_seq=32)
    fresh.submit(TRequest(tenant_id=1, prompt=[3, 4, 5], max_new_tokens=2))
    fresh._admit()
    for seg, seg_fresh in zip(eng.caches, fresh.caches):
        for k in seg:
            assert torch.equal(seg[k][:, 0], seg_fresh[k][:, 0]), k
    assert any(seg["state"][:, 1].any() for seg in eng.caches)
