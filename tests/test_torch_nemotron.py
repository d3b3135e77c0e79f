"""nemotron-4-340b on the port against the reference, on the CPU.

nemotron is a dense model with 96/8 query/kv heads at head dim 192 (group
12), a squared-ReLU MLP, layernorm with bias and untied embeddings. Its
smoke config (4/2 heads at head dim 16) and a widened smoke config with
its attention shape (24/2 heads at head dim 192: group 12) run both
packages from the reference's weights (``tests/test_torch_model.py``'s
``_pair``, ``_run_reference`` and ``_run_port``: prefill of 12 tokens and
16 greedy decode steps, B 2). Tolerances, as max |Δlogit| / max |logit|
at every step:

* f32: within 1e-4 with identical greedy tokens (summation order only);
  the f32 prefill caches within 1e-3 and the bf16 decode caches within
  one bf16 ulp (2^-7), as for the other dense configs;
* bf16: within 2e-2, the port teacher-forced with the reference's tokens
  (the two packages round bf16 at other points; the reference's own bf16
  logits sit ~1.5e-2 from its f32 ones).

Both ``ServeEngine``s serve the smoke config at f32 to the same tokens,
ledger and decode steps. ``chip_smoke.py``'s nemotron phase is rehearsed
on the smoke config, with ``torch.cuda``'s synchronize and memory calls
stubbed, the profile left out and the plain kernels wrapped to count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import TenantScheduler as JScheduler
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import TenantScheduler as TScheduler
from _torch_threads import one_thread  # noqa: F401
from test_torch_model import (_assert_caches, _pair, _prompt,
                              _run_reference, _run_port)

ARCH = "nemotron-4-340b"
# the smoke config, and one widened to nemotron's head dim and group
SHAPES = {"smoke": {}, "group12_d192": dict(num_heads=24, num_kv_heads=2,
                                            head_dim=192)}


def _gaps(port, ref):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(port, ref)]


def test_smoke_configs_keep_nemotrons_family():
    """Both smoke shapes keep what makes nemotron itself: relu2,
    layernorm, untied embeddings; the widened one has group 12 at head
    dim 192, as the full config does."""
    full = get_smoke_config(ARCH)
    assert (full.activation, full.norm, full.tie_embeddings) == \
        ("relu2", "layernorm", False)
    wide = dataclasses.replace(full, **SHAPES["group12_d192"])
    assert (wide.head_dim, wide.num_heads // wide.num_kv_heads) == (192, 12)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_matches_reference_f32(shape, mesh1):
    jcfg, tcfg, params, model = _pair(ARCH, "float32", mesh1,
                                      **SHAPES[shape])
    prompt = _prompt(tcfg)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)     # identical greedy
    gaps = _gaps(t_logits, j_logits)
    assert max(gaps) <= 1e-4, gaps
    _assert_caches(t_pc, j_pc, atol=1e-3, rtol=0)      # f32 prefill cache
    _assert_caches(t_dc, j_dc, atol=1e-3, rtol=2 ** -7)  # bf16 decode cache


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_matches_reference_bf16(shape, mesh1):
    jcfg, tcfg, params, model = _pair(ARCH, "bfloat16", mesh1,
                                      **SHAPES[shape])
    prompt = _prompt(tcfg)
    j_logits, j_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, _, _, _ = _run_port(model, prompt, tokens_in=j_toks)
    gaps = _gaps(t_logits, j_logits)
    assert max(gaps) <= 2e-2, gaps


def _requests(cls):
    rng = np.random.default_rng(21)
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


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_serve_engine_matches_reference(shape, mesh1):
    """Both engines (WFQ, prompt-charged buckets, 4 slots of 64) serve 8
    requests of 9 and 14 tokens at f32: identical tokens, completion
    order, ledgers and decode steps; every tenant's served tokens equal
    its billed ground truth."""
    jcfg, tcfg, params, model = _pair(ARCH, "float32", mesh1,
                                      **SHAPES[shape])
    jsched = JScheduler(policy="wfq", charge_prompt=True)
    jeng = JEngine(jcfg, JRunConfig(), mesh1, params=params, batch_slots=4,
                   max_seq=64, scheduler=jsched)
    tsched = TScheduler(policy="wfq", charge_prompt=True)
    teng = TEngine(tcfg, RunConfig(), model, batch_slots=4, max_seq=64,
                   scheduler=tsched)
    ref = _engine_run(jeng, jsched, _requests(JRequest))
    port = _engine_run(teng, tsched, _requests(TRequest))
    assert port == ref
    for t in range(3):
        assert tsched.served_tokens[t] == teng.billed_ground_truth(t)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_nemotron_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s nemotron phase on the widened smoke config (8
    slots of 1024, 12 requests of 64-512 tokens, 6 new tokens each):
    flash once per layer and admission, decode once per layer and step,
    every check of the serve, parity and f32 rows; on the CPU the kernel
    path is the plain one, so the bf16 gap is 0 and the ± 2^-8 floors are
    not."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    cs = _chip_smoke()
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "phase_profile", lambda *a, **k: (
        {"device_busy_share": "not measured", "kernel_launches": 0}, {}))
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
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              **SHAPES["group12_d192"])
    launches = cs.phase_nemotron(torch, torch.device("cpu"), cfg)
    serve, nemo, busy, parity, f32 = rows
    assert all(r.get("ok", True) for r in rows), rows
    assert serve["completed"] == 12
    assert launches == {"flash_attention": 2 * 12,
                        "decode_attention": 2 * serve["decode_steps"]}
    assert nemo["group"] == 12 and nemo["checks"]["cache_bytes_are_the_schemas"]
    assert nemo["cache_bytes"] == 2 * 8 * 1024 * 2 * 192 * 2 * 2
    assert busy["launches_per_step"] == 0
    assert parity["max_rel_logit_err_not_asserted"] == 0.0
    assert set(parity["bf16_floors_per_step_rel_err"]) == {"+", "-"}
    assert parity["bf16_floor_plain_vs_plain_attention_nudged_2^-8"] > 0
    assert f32["layers"] == 1 and f32["argmax_agree_share"] == 1.0
