"""The port's moe family against the reference's, on the CPU.

Inputs are made from a seed with numpy; weights are the reference's
(``build_params``, rescaled to their true fan-in as
``tests/test_torch_model.py::_pair`` does) or drawn with numpy at that
fan-in, and cross with ``params_from_jax``. Both smoke configs run:
arctic (4 experts top-2 beside a parallel dense branch of 128, 4/2 heads)
and deepseek (a ``dense_prefix`` layer of 128, then 2 ``moe`` layers of 4
experts top-2 with 2 shared experts, MLA). Tolerances:

* ``_capacity`` and ``_dispatch_tables``: exact integers (tables, slots,
  drops), ``route_topk``'s expert ids exact, ties included;
* ``apply_moe``: y and the four aux values within 1e-5 of their largest
  magnitude at f32 and 2e-2 at bf16 (the reference compiled with XLA's
  excess precision off, ``SOURCE_ROUNDING``: both round where the source
  casts), with the default capacity factor (drops) and with 100 (none);
* the whole model: f32 logits within 1e-4 with identical greedy tokens
  over 16 decode steps, caches within 1e-3 (one bf16 ulp, 2^-7, where the
  decode cache is bf16); bf16 logits within 2e-2 of max |logit|;
* both ``ServeEngine``s at f32 (4 slots of 64, decode drops included):
  identical tokens, completion order, ledgers and decode steps;
* training at f32: ``loss_fn`` (with the aux terms) within 1e-5, every
  gradient within 1e-4 of its leaf's largest, one ``make_train_step``
  with every parameter within 1% of lr and the moments within 1e-4.
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
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import TenantScheduler as JScheduler
from repro.train.train_loop import loss_fn as j_loss_fn
from repro.train.train_loop import make_train_step as j_make_step
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_schedule, cache_schema
from repro_torch.models.params import to_torch, train_state_from_jax, \
    train_state_to_numpy
from repro_torch.models.schema import walk
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import TenantScheduler as TScheduler
from repro_torch.train import make_train_step
from repro_torch.train.train_loop import _grads
from _torch_threads import one_thread  # noqa: F401
from test_torch_model import (_assert_caches, _pair, _prompt, _run_port,
                              _run_reference)
from test_torch_train import (_assert_trees, _batch, _by_ref, _cfgs,
                              _leaves_with_paths, _ref_at, _ref_state, _rel,
                              _rcfgs)

ARCHS = ("arctic-480b", "deepseek-v2-236b")
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}



def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _gap(a, b):
    """max |a - b| / max |b| (|a - b| where b is all zero)."""
    a, b = _np(a), _np(b)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / (scale or 1.0)


# ---------------------------------------------------------------------------
# capacity, dispatch tables, routing
# ---------------------------------------------------------------------------


class _M:
    def __init__(self, num_experts, top_k, capacity_factor=1.25):
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor


@pytest.mark.parametrize("tokens,e,k,cf", [
    (1, 4, 2, 1.25), (7, 4, 2, 1.25), (8, 4, 2, 1.25), (64, 4, 2, 1.25),
    (8, 128, 2, 1.25), (512, 128, 2, 1.25), (509, 128, 2, 1.25),
    (8, 160, 6, 1.25), (512, 160, 6, 1.25), (4, 4, 2, 1.25),
    (40, 4, 2, 100.0), (3, 4, 2, 0.5)])
def test_capacity_matches_reference(tokens, e, k, cf):
    """arctic's decode (8 slots: C 8) and a 512-token prefill (C 11),
    deepseek's (C 8 and 25), the smoke engine's 4 slots (C 3), T < 8."""
    m = _M(e, k, cf)
    assert tmoe._capacity(tokens, m) == jmoe._capacity(tokens, m)


# (T, k, E, C, skew): skew draws experts from a power law, so the busiest
# ones overflow their capacity
DISPATCH_CASES = [(32, 2, 4, 10, 0.0), (32, 2, 4, 10, 2.0),
                  (7, 2, 4, 2, 1.0), (8, 2, 128, 8, 0.0),
                  (64, 6, 16, 8, 3.0), (512, 2, 128, 11, 1.0),
                  (16, 1, 2, 32, 0.0), (40, 2, 4, 3, 5.0)]


def _assignments(t, k, e, skew, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, e + 1) ** skew
    eidx = np.stack([rng.choice(e, k, replace=False, p=w / w.sum())
                     for _ in range(t)]).astype(np.int32)
    gate = rng.random((t, k)).astype(np.float32)
    return eidx, gate / gate.sum(-1, keepdims=True)


@pytest.mark.parametrize("t,k,e,cap,skew", DISPATCH_CASES)
def test_dispatch_tables_match_reference(t, k, e, cap, skew):
    """Every integer equal: the token in each expert slot (T where empty),
    each assignment's slot (E*C where dropped), the weights, the drop
    share; a skewed draw drops assignments, the lower flat index first."""
    eidx, gate = _assignments(t, k, e, skew, seed=t + e)
    want = [np.asarray(a) for a in jmoe._dispatch_tables(
        jnp.asarray(eidx), jnp.asarray(gate), e, cap, t, k)]
    got = [a.numpy() for a in tmoe._dispatch_tables(
        torch.from_numpy(eidx).long(), torch.from_numpy(gate), e, cap, t,
        k)]
    for name, a, b in zip(("table", "slot_of", "w_flat", "drop"), got,
                          want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if skew >= 2.0:
        assert float(got[3]) > 0          # the case drops


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("e,k", [(4, 2), (16, 6), (128, 2)])
def test_route_topk_matches_reference(e, k, ties):
    """Expert ids equal, gates and the three aux within 1e-6. With ties
    (experts sharing one router column, so their probabilities are equal)
    the lower expert is picked first in both."""
    rng = np.random.default_rng(e * 10 + k)
    d, t = 32, 24
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if ties:
        router[:, 1::2] = router[:, 0::2]
    x = rng.standard_normal((t, d)).astype(np.float32)
    m = _M(e, k)
    jg, je, jaux = jmoe.route_topk(jnp.asarray(router), jnp.asarray(x), m)
    tg, te, taux = tmoe.route_topk(torch.from_numpy(router),
                                   torch.from_numpy(x), m)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    if ties:
        pairs = te.numpy() // 2
        assert (pairs[:, 0] == pairs[:, 1]).any()   # tied pairs were picked
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    assert sorted(taux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------


def _moe_weights(cfg, seed):
    """numpy weights of one moe block at their true fan-in (the router in
    f32, the rest in the parameter dtype), as a nested dict."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, desc in walk(tmoe.moe_schema(cfg)):
        a = rng.standard_normal(desc.shape) / np.sqrt(desc.init_fan_in)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(jnp.asarray(
            a, getattr(jnp, desc.dtype)))
    return out


def _moe_cfgs(arch, dtype, cf):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf), **kw)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf), **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("cf", [1.25, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype, cf, mesh1):
    """y and the four aux of one moe block on (3, 20, 64) tokens: arctic's
    parallel dense branch, deepseek's shared experts; the tokens share a
    direction that the router favours expert 0 along, so the default
    capacity factor (1.25) drops assignments; 100 drops none."""
    jcfg, tcfg = _moe_cfgs(arch, dtype, cf)
    w = _moe_weights(tcfg, seed=5)
    rng = np.random.default_rng(6)
    u = rng.standard_normal(tcfg.d_model).astype(np.float32)
    w["router"][:, 0] += 0.3 * u / np.linalg.norm(u)
    x = rng.standard_normal((3, 20, tcfg.d_model)).astype(np.float32) + u
    jx = jnp.asarray(x, getattr(jnp, dtype))
    fn = jax.jit(functools.partial(jmoe.apply_moe, cfg=jcfg,
                                   shd=ShardingCtx(mesh1), rcfg=None),
                 compiler_options=SOURCE_ROUNDING if dtype == "bfloat16"
                 else None)
    jy, jaux = fn(jax.tree.map(jnp.asarray, w), jx)
    tw = jax.tree.map(to_torch, w)
    ty, taux = tmoe.apply_moe(tw, to_torch(np.asarray(jx)), tcfg)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == x.shape
    assert _gap(ty, jy) <= TOL[dtype], _gap(ty, jy)
    assert sorted(taux) == sorted(jaux) == sorted(tmoe.AUX_KEYS)
    for key in jaux:
        assert _gap(taux[key], jaux[key]) <= TOL[dtype], key
    assert (float(taux["moe_drop_frac"]) > 0) == (cf < 2)


def test_dropped_assignments_add_exactly_zero():
    """With capacity 1 (6 tokens: below 8, the floor of 8 does not apply)
    every assignment past an expert's first is dropped: y equals the
    dense branch plus the kept picks alone, computed by hand, and a token
    all of whose picks dropped gets the dense branch only."""
    _, tcfg = _moe_cfgs("arctic-480b", "float32", 1e-9)
    assert tmoe._capacity(6, tcfg.moe) == 1
    w = jax.tree.map(to_torch, _moe_weights(tcfg, seed=8))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 6, tcfg.d_model)).astype(np.float32))
    y, aux = tmoe.apply_moe(w, x, tcfg)
    xf = x[0]
    gate, eidx, _ = tmoe.route_topk(w["router"], xf, tcfg.moe)
    dense = tmoe.apply_mlp(w["dense"], x, tcfg.activation)[0]
    want = dense.clone()
    seen = set()
    for j in range(6 * tcfg.moe.top_k):
        t, kk = divmod(j, tcfg.moe.top_k)
        e = int(eidx[t, kk])
        if e in seen:
            continue
        seen.add(e)
        h = xf[t] @ w["w_in"][e]
        g = xf[t] @ w["w_gate"][e]
        want[t] += gate[t, kk] * ((torch.nn.functional.silu(g) * h)
                                  @ w["w_out"][e])
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-5)
    assert float(aux["moe_drop_frac"]) == pytest.approx(1 - len(seen) / 12,
                                                        rel=1e-6)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_and_cache_schema(arch):
    """arctic: one segment of 2 ``moe`` layers, k/v caches; deepseek: a
    ``dense_prefix`` layer (d_ff 128) then 2 ``moe`` layers, each caching
    a latent of kv_lora_rank + rope = 40 in place of k/v."""
    cfg = get_smoke_config(arch)
    sched = [(s.kind, s.count) for s in build_schedule(cfg)]
    caches = cache_schema(cfg, 4, 64)
    if arch == "arctic-480b":
        assert sched == [("moe", 2)]
        assert sorted(caches[0]) == ["k", "v"]
    else:
        assert sched == [("dense_prefix", 1), ("moe", 2)]
        assert [sorted(c) for c in caches] == [["lat"], ["lat"]]
        assert caches[1]["lat"].shape == (2, 4, 64, 40)
        from repro_torch.models.model import model_schema
        layers = model_schema(cfg)["layers"]
        assert layers[0]["mlp"]["w_in"].shape == (64, 128)
        assert "moe" in layers[1] and "mlp" not in layers[1]
        assert layers[1]["moe"]["shared"]["w_in"].shape == (64, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference_f32(arch, mesh1):
    """Prefill + 16 greedy decode steps of B 2: identical tokens, logits
    within 1e-4, the prefill caches (f32) and decode caches (bf16) within
    1e-3."""
    jcfg, tcfg, params, model = _pair(arch, "float32", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_caches(t_pc, j_pc, atol=1e-3, rtol=0)
    _assert_caches(t_dc, j_dc, atol=1e-3, rtol=2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference_bf16(arch, mesh1):
    """The configs as published (bf16): logits within 2e-2 of max |logit|
    at every step, the port teacher-forced with the reference's tokens,
    against the reference compiled to round where its source casts."""
    jcfg, tcfg, params, model = _pair(arch, "bfloat16", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, _, _ = _run_reference(
        jcfg, params, mesh1, prompt, compiler_options=SOURCE_ROUNDING)
    t_logits, _, _, _ = _run_port(model, prompt, tokens_in=j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= 2e-2, (i, rel)


def _requests(cls):
    rng = np.random.default_rng(12)
    return [cls(tenant_id=i % 3, prompt=[int(t) for t in rng.integers(
        1, 256, 9 if i % 2 else 14)], max_new_tokens=6 + i % 4, req_id=i,
        arrival=0.0) for i in range(8)]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch, mesh1, monkeypatch):
    """Both engines (WFQ, prompt-charged buckets, 4 slots of 64) serve 8
    requests of 9 and 14 tokens at f32: identical tokens, completion
    order, ledgers and decode steps. Every slot is routed at decode, the
    empty ones too, so 4 tokens top-2 over 4 experts of capacity 3 can
    drop: the run has decode steps that drop."""
    jcfg, tcfg, params, model = _pair(arch, "float32", mesh1)
    drops = []
    apply_moe = tblocks.apply_moe

    def recorded(p, x, cfg, *args):
        y, aux = apply_moe(p, x, cfg, *args)
        if x.shape[1] == 1:
            drops.append(float(aux["moe_drop_frac"]))
        return y, aux

    monkeypatch.setattr(tblocks, "apply_moe", recorded)
    jsched = JScheduler(policy="wfq", charge_prompt=True)
    jeng = JEngine(jcfg, JRunConfig(), mesh1, params=params, batch_slots=4,
                   max_seq=64, scheduler=jsched)
    tsched = TScheduler(policy="wfq", charge_prompt=True)
    teng = TEngine(tcfg, RunConfig(), model, batch_slots=4, max_seq=64,
                   scheduler=tsched)
    ref = _engine_run(jeng, jsched, _requests(JRequest))
    port = _engine_run(teng, tsched, _requests(TRequest))
    assert port == ref
    assert max(drops) > 0
    for t in range(3):
        assert tsched.served_tokens[t] == teng.billed_ground_truth(t)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_bridge_round_trips(arch):
    """The reference's train state (router, stacked experts, shared and
    dense branches, MLA's 3-D projections and kv_norm) crosses into the
    port and back unchanged, leaf by leaf and slot by slot."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jrcfg, _ = _rcfgs(factored_nu=True)
    state = _ref_state(jcfg, tcfg, jrcfg)
    port = train_state_from_jax(state, tcfg, device="cpu")
    back = train_state_to_numpy(port, tcfg)
    for key in ("params", "opt"):
        want = state[key] if key == "params" else \
            {"mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}
        got = back[key] if key == "params" else \
            {"mu": back["opt"]["mu"], "nu": back["opt"]["nu"]}
        gl, wl = _leaves_with_paths(got), _leaves_with_paths(want)
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                          err_msg=path)
    names = dict(port["params"].named_parameters())
    moe = [n for n in names if ".moe." in n]
    assert any(n.endswith("moe.router") for n in moe)
    assert names[moe[0]].dtype == torch.float32 or "router" not in moe[0]
    if arch == "deepseek-v2-236b":
        assert names["blocks.1.attn.w_uk"].dim() == 3
        assert "blocks.1.moe.shared.w_in" in names
    else:
        assert "blocks.0.moe.dense.w_gate" in names


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_reference(arch):
    """f32, B 2 x 16 tokens (capacity 10 of 32 x 2 assignments: drops):
    ``loss_fn`` with the aux terms and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's, then one step of each
    package's ``make_train_step`` from the same state: every element
    whose clipped gradient is at least 1e-7 within 1% of lr (one element
    in a few leaves has a gradient near Adam's eps of 1e-8, where the step
    depends on the gradient's last bits), the moments within 1e-4."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jrcfg, trcfg = _rcfgs(warmup_steps=1, learning_rate=1e-2)
    state = _ref_state(jcfg, tcfg, jrcfg)
    jb, tb = _batch(jcfg, 2, 16)
    mesh = make_host_mesh(1, 1)
    vg = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=jcfg, shd=ShardingCtx(mesh), rcfg=jrcfg),
        has_aux=True))
    (jloss, jmet), jgrads = vg(jax.tree.map(jnp.asarray, state["params"]),
                               jax.tree.map(jnp.asarray, jb))
    port = train_state_from_jax(state, tcfg, device="cpu")
    grads, tmet = _grads(port["params"], tb, tcfg, trcfg)
    assert float(tmet["moe_drop_frac"]) > 0
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    stacked = _by_ref(grads, tcfg)
    assert len(stacked) == len(jax.tree.leaves(jgrads))
    for ref_path, got in stacked.items():
        want = np.asarray(_ref_at(jgrads, ref_path))
        assert got.shape == want.shape, ref_path
        assert np.abs(got).max() > 0 or np.abs(want).max() == 0, ref_path
        assert _rel(got, want) <= 1e-4, (ref_path, _rel(got, want))
    jstep = jax.jit(j_make_step(jcfg, jrcfg, mesh))
    jstate, jm = jstep(jax.tree.map(jnp.asarray, state),
                       jax.tree.map(jnp.asarray, jb))
    port, tm = make_train_step(tcfg, trcfg)(port, tb)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    got = train_state_to_numpy(port, tcfg)
    want = jax.tree.map(np.asarray, jstate)
    # Adam's first step moves an element by lr * g / (|g| + 1e-8) (g
    # clipped): where |g| is near 1e-8 the step rides on the gradient's
    # last bits, which the two packages sum in different orders. Every
    # element whose clipped |g| is 0 or at least 1e-7 moves within 1% of
    # lr; the few below that are held only to lr (plus its decay)
    clip = min(1.0, jrcfg.grad_clip / float(jm["grad_norm"]))
    for (path, a), (_, b), (_, g) in zip(
            _leaves_with_paths(got["params"]),
            _leaves_with_paths(want["params"]),
            _leaves_with_paths(jax.tree.map(np.asarray, jgrads))):
        err = np.abs(a - b)
        loud = (np.abs(g) * clip >= 1e-7) | (g == 0)
        assert float(err[loud].max(initial=0)) <= 0.01 * trcfg.learning_rate, \
            (path, float(err[loud].max()))
        assert float(err.max()) <= 1.1 * trcfg.learning_rate, path
        assert (~loud).sum() <= max(2, err.size // 1000), path
    _assert_trees(got["opt"]["mu"], want["opt"]["mu"], 1e-4, "mu")
    _assert_trees(got["opt"]["nu"], want["opt"]["nu"], 1e-4, "nu")


# ---------------------------------------------------------------------------
# chip_smoke.py's moe phase, rehearsed
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch,f32_layers", [("arctic-480b", 1),
                                             ("deepseek-v2-236b", 2)])
def test_moe_phase_rehearses_on_the_cpu(arch, f32_layers, monkeypatch):
    """``chip_smoke.py``'s moe phase at the smoke config (8 slots of 1024,
    12 requests of 64-512 tokens, 32 new tokens each), with ``torch.cuda``'s
    synchronize and memory calls stubbed, the profile left out and the
    plain attention wrapped to count launches: flash once per layer and
    admission (deepseek's MLA prefill too), arctic's decode once per layer
    and step and none on deepseek (its absorbed decode is plain torch);
    every check of the serve, parity, f32 and smoke rows. On the CPU the
    kernel path is the plain one, so deepseek's bf16 gap is 0."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    cs = _chip_smoke()
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "phase_profile", lambda *a, **k: None)
    monkeypatch.setattr(cs, "NEW_TOKENS", 6)
    for mod_name, counter in (("flash_attention", fa.flash_attention),
                              ("decode_kernel", da.decode_attention)):
        real = getattr(attention, mod_name)

        def counted(*args, _real=real, _counter=counter, **kw):
            _counter.launches += 1
            return _real(*args, **kw)

        monkeypatch.setattr(attention, mod_name, counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg = get_smoke_config(arch)
    launches = cs.phase_moe(torch, torch.device("cpu"), arch, cfg,
                            f32_layers)
    serve, moe, parity, f32, smoke = rows
    assert all(r["ok"] for r in rows), rows
    assert serve["completed"] == 12
    if arch == "arctic-480b":
        assert launches["flash_attention"] == 2 * 12
        assert launches["decode_attention"] == 2 * serve["decode_steps"]
        assert parity["per_launch_max_rel_err"]["flash_attention"] <= 2e-2
    else:
        assert launches == {"flash_attention": cfg.num_layers * 12,
                            "decode_attention": 0}
        assert parity["per_launch_max_rel_err"]["flash_attention"] == 0.0
        assert moe["latent_bytes_per_layer"] == 8 * 1024 * 40 * 2
        assert parity["max_rel_logit_err_not_asserted"] == 0.0
    assert moe["capacity_decode_B8"] == 8
    assert moe["decode_drop_frac_max"] == 0.0
    assert f32["routing_choices_differing"] == 0
    assert smoke["checks"]["engine_tokens_and_ledger_equal"]
