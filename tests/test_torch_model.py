"""The port's model against the reference's, with the reference's weights.

Weights come from the reference's ``build_params`` (``jax.random`` cannot
be reproduced in torch) and cross through ``params_from_jax``. The test
rescales each layer weight to its true fan-in first: the reference's init
reads a layer-stacked leaf's first dim (the layer count) as fan-in, which
gives smoke-width activations of ~10 and ~10% bf16 noise in the reference
itself (its own bf16 logits against f32), swamping any comparison. Checks:

* f32 variants (``dtype = param_dtype = "float32"``; the KV cache stays
  bf16 as in serving): last-token logits within 1e-4, greedy tokens
  identical over 16 decode steps, caches within 1e-3 (one bf16 ulp where
  f32 values straddle a rounding boundary);
* bf16 (the configs as published): logits within 2e-2 of max |logit| —
  XLA and torch round bf16 at different points (XLA computes chains of
  bf16 elementwise ops in f32 and rounds once), so only the loose bound
  holds; the reference's own bf16 logits sit ~1.5e-2 from its f32 ones.
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
from repro.models import layers as jl
from repro.models.model import build_params, forward_decode as j_decode, \
    forward_prefill as j_prefill
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.models import forward_decode, forward_prefill, layers as tl
from repro_torch.models.model import build_schedule, model_schema
from repro_torch.models.params import cache_from_jax, params_from_jax
from repro_torch.models.schema import walk

from _torch_threads import one_thread  # noqa: F401

ARCHS = ("llama3.2-3b", "internlm2-1.8b", "granite-8b")
B, PROMPT, MAX_SEQ, STEPS = 2, 12, 32, 16


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    tol = 1e-5 if dtype == "float32" else 1e-2
    d, ff, v = 64, 96, 50
    x = _rand(0, 2, 5, d)
    jx, tx = _both(x, dtype)
    scale, bias = _rand(1, d), _rand(2, d)
    for kind in ("rmsnorm", "layernorm"):
        jp = {"scale": _both(scale, dtype)[0], "bias": _both(bias, dtype)[0]}
        tp = {"scale": _both(scale, dtype)[1], "bias": _both(bias, dtype)[1]}
        np.testing.assert_allclose(_np(tl.apply_norm(tp, tx, kind)),
                                   _np(jl.apply_norm(jp, jx, kind)),
                                   rtol=tol, atol=tol, err_msg=kind)
    shapes = (("w_in", (d, ff)), ("w_gate", (d, ff)), ("w_out", (ff, d)))
    w = {k: _rand(i + 3, *shape) * 0.1
         for i, (k, shape) in enumerate(shapes)}
    for act in ("silu_glu", "relu2", "gelu"):
        jp = {k: _both(a, dtype)[0] for k, a in w.items()}
        tp = {k: _both(a, dtype)[1] for k, a in w.items()}
        np.testing.assert_allclose(_np(tl.apply_mlp(tp, tx, act)),
                                   _np(jl.apply_mlp(jp, jx, act)),
                                   rtol=tol, atol=tol, err_msg=act)
    pos = np.array([[0, 3, 7, 100, 4095]], np.int32)
    jc, js = jl.rope_tables(jnp.asarray(pos), 16, 500000.0)
    tc, ts = tl.rope_tables(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)
    heads = _rand(9, 1, 5, 3, 16)
    jh, th = _both(heads, dtype)
    np.testing.assert_allclose(_np(tl.apply_rope(th, tc, ts)),
                               _np(jl.apply_rope(jh, jc, js)),
                               rtol=tol, atol=tol)
    table = _rand(10, v, d)
    tokens = np.array([[0, 4, 49], [7, 7, 1]], np.int32)
    jt, tt = _both(table, dtype)
    emb_j = jl.embed_tokens({"tokens": jt}, jnp.asarray(tokens),
                            getattr(jnp, dtype))
    emb_t = tl.embed_tokens({"tokens": tt}, torch.from_numpy(tokens),
                            getattr(torch, dtype))
    np.testing.assert_array_equal(_np(emb_t), _np(emb_j))
    for cap in (0.0, 5.0):
        np.testing.assert_allclose(
            _np(tl.lm_logits({"tokens": tt}, tx, cap)),
            _np(jl.lm_logits({"tokens": jt}, jx, None, cap)),
            rtol=tol, atol=tol * 10, err_msg=f"softcap {cap}")


# ---------------------------------------------------------------------------
# the whole model: prefill + decode
# ---------------------------------------------------------------------------


def _pair(arch, dtype, mesh, **changes):
    """Both packages' smoke configs of ``arch`` (with ``changes``), the
    reference's weights and the port's model holding them."""
    jcfg = dataclasses.replace(j_smoke(arch), **changes)
    tcfg = dataclasses.replace(get_smoke_config(arch), **changes)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype="float32",
                                   param_dtype="float32")
        tcfg = dataclasses.replace(tcfg, dtype="float32",
                                   param_dtype="float32")
    tree = jax.tree.map(np.asarray,
                        build_params(jcfg, mesh, jax.random.PRNGKey(0)))
    layers = model_schema(tcfg)["layers"]
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
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, params, params_from_jax(tree, tcfg, device="cpu")


def _run_reference(jcfg, params, mesh, prompt, tokens_in=None,
                   compiler_options=None):
    """Prefill + STEPS greedy decode steps. ``tokens_in`` (STEPS, B)
    teacher-forces the decoded tokens; ``compiler_options`` go to XLA."""
    shd, rcfg = ShardingCtx(mesh), JRunConfig(attn_q_block=16,
                                              attn_kv_block=16)
    jit = functools.partial(jax.jit, compiler_options=compiler_options)
    logits, caches = jit(functools.partial(
        j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=MAX_SEQ))(
        params, jnp.asarray(prompt))
    prefill_caches = caches
    # the serving engine installs the prefill cache into its bf16 cache
    caches = jax.tree.map(lambda c: c.astype(jnp.bfloat16), caches)
    dec = jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
    out_logits, toks = [np.asarray(logits, np.float32)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32) \
            if tokens_in is None else tokens_in[i]
        toks.append(tok)
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        logits, caches = dec(params, caches, jnp.asarray(tok)[:, None], pos)
        out_logits.append(np.asarray(logits, np.float32))
    return out_logits, np.stack(toks), prefill_caches, caches


def _run_port(model, prompt, tokens_in=None):
    rcfg = RunConfig()
    logits, caches = forward_prefill(model, torch.from_numpy(prompt), rcfg,
                                     max_seq=MAX_SEQ)
    prefill_caches = caches
    caches = tuple({k: c.to(torch.bfloat16) for k, c in seg.items()}
                   for seg in caches)
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


def _assert_caches(port, ref, atol, rtol):
    ref = cache_from_jax(jax.tree.map(np.asarray, ref), device="cpu")
    assert len(port) == len(ref)
    for tseg, jseg in zip(port, ref):
        assert set(tseg) == set(jseg)
        for k in tseg:
            assert tseg[k].shape == jseg[k].shape and \
                tseg[k].dtype == jseg[k].dtype, k
            np.testing.assert_allclose(_np(tseg[k]), _np(jseg[k]),
                                       atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference_f32(arch, mesh1):
    jcfg, tcfg, params, model = _pair(arch, "float32", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)     # identical greedy
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_caches(t_pc, j_pc, atol=1e-3, rtol=0)      # f32 prefill cache
    _assert_caches(t_dc, j_dc, atol=1e-3, rtol=2 ** -7)  # bf16 decode cache


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference_bf16(arch, mesh1):
    jcfg, tcfg, params, model = _pair(arch, "bfloat16", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, _, _, _ = _run_port(model, prompt, tokens_in=j_toks)
    for i, (a, b) in enumerate(zip(t_logits, j_logits)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= 2e-2, (i, rel)


def test_bridge_carries_bf16_bit_for_bit(mesh1):
    jcfg = j_smoke("llama3.2-3b")
    params = build_params(jcfg, mesh1, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_smoke_config("llama3.2-3b"), device="cpu")
    wq = np.asarray(params["segments"][0]["attn"]["wq"][1])
    got = model.blocks[1]["attn"]["wq"].detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))
    emb = np.asarray(params["embed"]["tokens"])
    np.testing.assert_array_equal(
        model.embed["tokens"].detach().view(torch.int16).numpy(),
        emb.view(np.int16))


def test_bridge_refuses_mismatched_trees(mesh1):
    params = build_params(j_smoke("llama3.2-3b"), mesh1,
                          jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError):           # dtype differs (bf16 -> f32)
        params_from_jax(tree, dataclasses.replace(
            get_smoke_config("llama3.2-3b"), dtype="float32",
            param_dtype="float32"), device="cpu")
    with pytest.raises(ValueError):           # leaves differ (no w_gate)
        params_from_jax(tree, get_smoke_config("nemotron-4-340b"),
                        device="cpu")


# ---------------------------------------------------------------------------
# chameleon-34b: the vlm family (dense schedule, untied embeddings, q/k norms)
# ---------------------------------------------------------------------------

CHAMELEON = "chameleon-34b"


def _bf16_straddles(port, ref):
    """Entries where two f32 caches round to different bf16 values. Each
    must be a straddle: f32 values within the packages' rounding distance
    (1e-5) that land on adjacent bf16 values. Returns their count."""
    n = 0
    for tseg, jseg in zip(port, cache_from_jax(
            jax.tree.map(np.asarray, ref), device="cpu")):
        for k in tseg:
            a, b = tseg[k].float(), jseg[k].float()
            a16 = a.to(torch.bfloat16).view(torch.int16).int()
            b16 = b.to(torch.bfloat16).view(torch.int16).int()
            off = a16 != b16
            assert torch.all((a16 - b16)[off].abs() == 1), k
            assert torch.all((a - b)[off].abs() <= 1e-5), k
            n += int(off.sum())
    return n


def test_chameleon_matches_reference_f32(mesh1):
    """Prefill logits within 1e-4, greedy tokens identical over 16 steps,
    caches as the dense families'. ROADMAP P14: the f32 prefill caches
    agree within ~2e-6, but a few entries straddle a bf16 rounding
    boundary and land one bf16 ulp apart once the engine installs them
    into its bf16 cache. Decoding from the reference's installed cache,
    the logits agree within 1e-4 at every step; from the port's own, the
    straddles move them by a few 1e-4 of max |logit| (pinned below 1e-3)."""
    jcfg, tcfg, params, model = _pair(CHAMELEON, "float32", mesh1)
    prompt = _prompt(tcfg)
    j_logits, j_toks, j_pc, j_dc = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, t_toks, t_pc, t_dc = _run_port(model, prompt)
    np.testing.assert_array_equal(t_toks, j_toks)     # identical greedy
    np.testing.assert_allclose(t_logits[0], j_logits[0], rtol=1e-4,
                               atol=1e-4, err_msg="prefill")
    _assert_caches(t_pc, j_pc, atol=1e-3, rtol=0)      # f32 prefill cache
    _assert_caches(t_dc, j_dc, atol=1e-3, rtol=2 ** -7)  # bf16 decode cache
    assert _bf16_straddles(t_pc, j_pc) > 0             # P14's cause
    own = max(np.abs(a - b).max() / np.abs(b).max()
              for a, b in zip(t_logits, j_logits))
    assert own <= 1e-3, own
    # the same decode from the reference's installed bf16 cache
    caches = cache_from_jax(jax.tree.map(
        lambda c: np.asarray(c.astype(jnp.bfloat16)), j_pc), device="cpu")
    for i in range(STEPS):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, caches = forward_decode(
            model, caches, torch.from_numpy(j_toks[i])[:, None], pos,
            RunConfig())
        np.testing.assert_allclose(_np(logits), j_logits[i + 1], rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i + 1}")


# XLA's default lets a chain of elementwise ops skip the bf16 roundings
# between them (excess precision); with this off, the reference rounds
# where its source casts, as torch does
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}


def test_chameleon_matches_reference_bf16(mesh1):
    """Logits within P2's 2e-2 of max |logit| at every step, against the
    reference compiled to round where its source casts (``SOURCE_ROUNDING``).
    ROADMAP P15: XLA's default excess precision skips some of those
    roundings, and this model amplifies the difference (its bf16 logits sit
    3.5e-2 from its own f32 ones, ~1.5e-2 for the dense smoke configs):
    against the default-compiled reference the gap reaches 2.85e-2 at one
    step of 17. Held there: the gap stays within the reference's own bf16
    error, and the port's bf16 logits are no farther from the f32
    reference than the reference's bf16 logits are."""
    jcfg, tcfg, params, model = _pair(CHAMELEON, "bfloat16", mesh1)
    prompt = _prompt(tcfg)
    j_src, src_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt,
                                           compiler_options=SOURCE_ROUNDING)
    t_src = _run_port(model, prompt, tokens_in=src_toks)[0]
    for i, (a, b) in enumerate(zip(t_src, j_src)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= 2e-2, (i, rel)
    j_logits, j_toks, _, _ = _run_reference(jcfg, params, mesh1, prompt)
    t_logits, _, _, _ = _run_port(model, prompt, tokens_in=j_toks)
    j32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    f32 = _run_reference(j32, jax.tree.map(
        lambda a: a.astype(jnp.float32), params), mesh1, prompt,
        tokens_in=j_toks)[0]

    def gap(a_runs, b_runs):
        return max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(a_runs, b_runs))
    noise = gap(j_logits, f32)
    assert gap(t_logits, j_logits) <= noise
    assert gap(t_logits, f32) <= noise


def test_chameleon_qk_norm_leaves_cross_and_matter(mesh1):
    """The (head_dim,) q/k rmsnorm scales and the untied output embedding
    cross bit for bit; with random scales the f32 prefill logits match the
    reference's within 1e-4, and zeroing the scales changes the logits in
    both packages alike."""
    jcfg, tcfg, _, _ = _pair(CHAMELEON, "float32", mesh1)
    tree = jax.tree.map(np.asarray,
                        build_params(jcfg, mesh1, jax.random.PRNGKey(5)))
    attn = tree["segments"][0]["attn"]
    rng = np.random.default_rng(11)
    for name in ("q_norm", "k_norm"):
        scale = attn[name]["scale"]
        assert scale.shape == (2, tcfg.head_dim)
        attn[name]["scale"] = (1.0 + 0.5 * rng.standard_normal(
            scale.shape)).astype(scale.dtype)
    assert "head" in tree["embed"]             # untied embeddings
    model = params_from_jax(tree, tcfg, device="cpu")
    for layer in range(2):
        for name in ("q_norm", "k_norm"):
            np.testing.assert_array_equal(
                model.blocks[layer]["attn"][name]["scale"].detach().numpy(),
                attn[name]["scale"][layer])
    np.testing.assert_array_equal(
        model.embed["head"].detach().numpy(), tree["embed"]["head"])
    prompt = _prompt(tcfg)
    shd, rcfg = ShardingCtx(mesh1), JRunConfig(attn_q_block=16,
                                               attn_kv_block=16)

    def both(tr, m):
        ref, _ = j_prefill(jax.tree.map(jnp.asarray, tr), jnp.asarray(prompt),
                           cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=MAX_SEQ)
        port, _ = forward_prefill(m, torch.from_numpy(prompt), RunConfig(),
                                  max_seq=MAX_SEQ)
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(_np(port), ref, rtol=1e-4, atol=1e-4)
        return ref

    scaled = both(tree, model)
    for name in ("q_norm", "k_norm"):
        attn[name]["scale"] = np.zeros_like(attn[name]["scale"])
    zeroed = both(tree, params_from_jax(tree, tcfg, device="cpu"))
    assert np.abs(scaled - zeroed).max() > 1e-2 * np.abs(scaled).max()
