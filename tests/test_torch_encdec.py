"""The port's encoder-decoder family (whisper-small) against the reference's,
on the CPU.

Weights come from the reference's ``build_params`` and cross through
``params_from_jax``; each layer weight, the encoder's included, is first
rescaled to its true fan-in (``tests/test_torch_model.py::_pair`` says
why). Frames and prompts are made with numpy from a seed. The smoke config
(``get_smoke_config("whisper-small")``: 2 encoder + 2 decoder layers,
d_model 64, 4/4 heads of 16, ``encoder_seq`` 24, layernorm with bias,
gelu, no rope) serves the way the reference's own entry points serve it:
``forward_prefill(..., frames=)``, then greedy ``forward_decode`` steps on
the caches the prefill returns. Tolerances:

* f32 (``dtype = param_dtype = "float32"``, f32 frames): the encoder
  output, every logit (prefill, 4 decode steps, ``forward_train``) within
  1e-4 of max |logit|, greedy tokens identical, every cache leaf (self
  k/v, ``ck``/``cv``) within 1e-5 of its max |value|;
* bf16 (the published dtypes, bf16 frames as ``input_specs`` gives them):
  within 2e-2 (ROADMAP P2: the packages round bf16 at different points);
* training at bf16 with the data pipeline's f32 frames: both encoders run
  in f32 (jnp promotion; the port widens its bf16 weights), the decoder in
  bf16, logits within 2e-2 (ROADMAP P18).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_config
from repro.configs import get_shape as j_shape
from repro.configs import get_smoke_config as j_smoke
from repro.distribution.sharding import ShardingCtx
from repro.models.attention import gqa_attention as j_gqa
from repro.models.model import build_params, encode as j_encode, \
    forward_decode as j_decode, forward_prefill as j_prefill, \
    forward_train as j_train, input_specs as j_input_specs
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import RunConfig, SHAPES, get_config, \
    get_smoke_config
from repro_torch.models import (Model, build_schedule, cache_schema, encode,
                                forward_decode, forward_prefill,
                                forward_train, init_cache, input_specs,
                                model_schema, params_from_jax)
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import sinusoid_positions
from repro_torch.models.params import cache_from_jax
from repro_torch.models.schema import walk
from repro_torch.serve import ServeEngine as TEngine
from _torch_threads import one_thread  # noqa: F401
from test_torch_train import _rescale

ARCH = "whisper-small"
B, PROMPT, MAX_SEQ, STEPS = 2, 12, 32, 4
F32 = dict(dtype="float32", param_dtype="float32")
BLOCKS = dict(attn_q_block=8, attn_kv_block=8)



def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(dtype, mesh, **changes):
    """Both packages' whisper smoke configs, the reference's weights (the
    decoder's and the encoder's rescaled) and the port's model holding
    them."""
    jcfg = dataclasses.replace(j_smoke(ARCH), **changes)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **changes)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, **F32)
        tcfg = dataclasses.replace(tcfg, **F32)
    tree = jax.tree.map(np.asarray,
                        build_params(jcfg, mesh, jax.random.PRNGKey(0)))
    schema = model_schema(tcfg)
    _rescale(tree["segments"][0], schema["layers"][0])
    _rescale(tree["encoder"]["segments"][0], schema["encoder"]["layers"][0])
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg, device="cpu")


def _inputs(dtype, seed=0, s=PROMPT, vocab=256, t=24, d=64):
    prompt = np.random.default_rng(seed).integers(1, vocab, (B, s),
                                                  dtype=np.int32)
    frames = _rand(seed + 1, B, t, d)
    return prompt, frames, torch.from_numpy(prompt), \
        torch.from_numpy(frames).to(getattr(torch, dtype))


def _serve_reference(jcfg, params, mesh, prompt, frames, dtype):
    shd, rcfg = ShardingCtx(mesh), JRunConfig(**BLOCKS)
    logits, caches = jax.jit(functools.partial(
        j_prefill, cfg=jcfg, shd=shd, rcfg=rcfg, max_seq=MAX_SEQ))(
        params, jnp.asarray(prompt),
        frames=jnp.asarray(frames, getattr(jnp, dtype)))
    prefill_caches = jax.tree.map(np.asarray, caches)
    dec = jax.jit(functools.partial(j_decode, cfg=jcfg, shd=shd, rcfg=rcfg))
    out, toks = [np.asarray(logits, np.float32)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        toks.append(tok)
        logits, caches = dec(params, caches, jnp.asarray(tok[:, None]),
                             jnp.full((B,), PROMPT + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out, toks, prefill_caches


def _serve_port(model, prompt, frames):
    rcfg = RunConfig(**BLOCKS)
    logits, caches = forward_prefill(model, prompt, rcfg, max_seq=MAX_SEQ,
                                     frames=frames)
    prefill_caches = tuple({k: v.clone() for k, v in seg.items()}
                           for seg in caches)
    out, toks = [_np(logits)], []
    for i in range(STEPS):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
        logits, caches = forward_decode(
            model, caches, tok[:, None],
            torch.full((B,), PROMPT + i, dtype=torch.int32), rcfg)
        out.append(_np(logits))
    return out, toks, prefill_caches


# ---------------------------------------------------------------------------
# layers and schemas
# ---------------------------------------------------------------------------


def test_sinusoid_positions_match_reference():
    """f32, sin then cos. XLA's exp on the CPU and torch's differ in the
    last bit of some frequencies (43 of whisper's 384), so an angle
    ``pos * freq`` may differ by ``pos`` ulps of the frequency (< 1.2e-7
    pos): the bound grows with the position (1.2e-4 measured at 1499)."""
    from repro.models.layers import sinusoid_positions as j_sin
    pos = np.array([0, 1, 7, 447, 1499], np.int32)
    want = np.asarray(j_sin(jnp.asarray(pos), 768))
    got = sinusoid_positions(torch.from_numpy(pos), 768)
    assert got.dtype == torch.float32 and got.shape == (5, 768)
    bound = 2e-6 + 1.2e-7 * pos[:, None]
    assert (np.abs(got.numpy() - want) <= bound).all()
    per_row = sinusoid_positions(torch.from_numpy(pos)[:, None], 768)
    np.testing.assert_array_equal(per_row[:, 0].numpy(), got.numpy())


def test_whisper_schema_matches_reference(mesh1):
    """Every parameter leaf (the encoder's, ``ln_cross`` and ``cross``
    included) and every cache leaf, by path, shape and dtype. The
    full-width model holds 238,108,416 parameters: the analytic
    ``num_params`` (238,050,816) counts one d-vector per norm and leaves
    out 75 of whisper's layernorm vectors (the biases, ``ln_cross`` and
    the encoder's final norm)."""
    jcfg, tcfg = j_config(ARCH), get_config(ARCH)
    from repro.models.model import cache_schema as j_cache_schema
    from repro.models.model import model_schema as j_model_schema
    ref = j_model_schema(jcfg, None)
    schema = model_schema(tcfg)
    assert [s.kind for s in build_schedule(tcfg)] == ["dec"]
    for key in ("segments",):
        (seg,) = ref[key]
        for path, desc in walk(schema["layers"][0]):
            node = seg
            for k in path:
                node = node[k]
            assert node.shape == (tcfg.num_layers,) + desc.shape, path
            assert node.dtype == desc.dtype, path
    eseg = ref["encoder"]["segments"][0]
    n_enc = 0
    for path, desc in walk(schema["encoder"]["layers"][0]):
        node = eseg
        for k in path:
            node = node[k]
        assert node.shape == (tcfg.encoder_layers,) + desc.shape, path
        n_enc += 1
    assert n_enc == len(jax.tree.leaves(eseg)) == 10
    assert {"ln_cross", "cross"} <= set(schema["layers"][0])
    model = Model(get_smoke_config(ARCH), device="cpu")
    # embed, both final norms' scale and bias; 10 leaves an enc layer, 16
    # a dec layer
    assert len(list(model.parameters())) == 5 + 2 * 10 + 2 * 16
    n = sum(int(np.prod(d.shape)) for tree in (
        schema["embed"], schema["final_norm"],
        schema["encoder"]["final_norm"]) for _, d in walk(tree))
    n += tcfg.num_layers * sum(int(np.prod(d.shape))
                               for _, d in walk(schema["layers"][0]))
    n += tcfg.encoder_layers * sum(
        int(np.prod(d.shape)) for _, d in walk(schema["encoder"]["layers"][0]))
    assert n == 238_108_416 == tcfg.num_params() + 75 * tcfg.d_model
    (cref,) = j_cache_schema(jcfg, 8, 448)
    (cport,) = cache_schema(tcfg, 8, 448)
    assert sorted(cref) == sorted(cport) == ["ck", "cv", "k", "v"]
    for k in cport:
        assert cport[k].shape == cref[k].shape and \
            cport[k].dtype == cref[k].dtype, k
    assert cport["ck"].shape == (12, 8, 1500, 12, 64)


# ---------------------------------------------------------------------------
# the smoke model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_prefill_decode_match_reference(dtype, mesh1):
    """``encode``, the prefill's last logits and every cache leaf, then 4
    greedy decode steps (the self cache grows, ``ck``/``cv`` pass
    through untouched)."""
    jcfg, tcfg, params, model = _pair(dtype, mesh1)
    prompt, frames, tp, tf = _inputs(dtype)
    tol, ctol = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    jf = jnp.asarray(frames, getattr(jnp, dtype))
    want = j_encode(params, jf, jcfg, ShardingCtx(mesh1), JRunConfig(**BLOCKS))
    with torch.no_grad():
        got = encode(model, tf, RunConfig(**BLOCKS))
    assert got.dtype == tf.dtype and got.shape == (B, 24, 64)
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 2e-2)
    ref_logits, ref_toks, ref_caches = _serve_reference(
        jcfg, params, mesh1, prompt, frames, dtype)
    logits, toks, caches = _serve_port(model, tp, tf)
    for i, (a, b) in enumerate(zip(logits, ref_logits)):
        assert _rel(a, b) <= tol, (i, _rel(a, b))
    if dtype == "float32":
        for a, b in zip(toks, ref_toks):
            np.testing.assert_array_equal(a, b)
    (seg,), (jseg,) = caches, cache_from_jax(ref_caches, device="cpu")
    assert sorted(seg) == sorted(jseg) == ["ck", "cv", "k", "v"]
    for k in seg:
        assert seg[k].shape == jseg[k].shape and seg[k].dtype == \
            jseg[k].dtype, k
        assert _rel(seg[k], jseg[k]) <= ctol, (k, _rel(seg[k], jseg[k]))
    assert seg["ck"].shape == (tcfg.num_layers, B, 24, 4, 16)
    assert seg["k"].shape == (tcfg.num_layers, B, MAX_SEQ, 4, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_match_reference(dtype, mesh1):
    """Every position's logits of ``forward_train`` with frames in the
    model's dtype; at f32 also equal to the prefill's last logits."""
    jcfg, tcfg, params, model = _pair(dtype, mesh1)
    prompt, frames, tp, tf = _inputs(dtype, seed=3)
    want, _ = j_train(params, {"tokens": jnp.asarray(prompt),
                               "frames": jnp.asarray(frames, getattr(
                                   jnp, dtype))},
                      jcfg, ShardingCtx(mesh1), JRunConfig(**BLOCKS))
    with torch.no_grad():
        got, aux = forward_train(model, {"tokens": tp, "frames": tf}, tcfg,
                                 RunConfig(**BLOCKS))
        last, _ = forward_prefill(model, tp, RunConfig(**BLOCKS),
                                  max_seq=PROMPT, frames=tf)
    assert aux == {} and got.shape == (B, PROMPT, 256)
    assert _rel(got, want) <= (1e-4 if dtype == "float32" else 2e-2)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got[:, -1]), _np(last), atol=1e-5)


def test_f32_frames_run_the_encoder_in_f32_as_the_reference(mesh1):
    """The dtype trap: the data pipeline's frames are f32, so at bf16
    weights both encoders run in f32 (the reference by jnp promotion, the
    port by widening its weights), the cross-attention's k/v are f32 and
    its q bf16, and its output comes back in bf16. The bf16 logits agree
    within 2e-2 (ROADMAP P18: the port's f32 kernel does not round p to
    bf16 where the reference's mixed product does)."""
    jcfg, tcfg, params, model = _pair("bfloat16", mesh1)
    prompt, frames, tp, _ = _inputs("float32", seed=5)
    tf = torch.from_numpy(frames)
    shd, jr = ShardingCtx(mesh1), JRunConfig(**BLOCKS)
    jenc = j_encode(params, jnp.asarray(frames), jcfg, shd, jr)
    with torch.no_grad():
        enc = encode(model, tf, RunConfig(**BLOCKS))
    assert jenc.dtype == jnp.float32 and enc.dtype == torch.float32
    assert _rel(enc, jenc) <= 1e-3
    want, _ = j_train(params, {"tokens": jnp.asarray(prompt),
                               "frames": jnp.asarray(frames)}, jcfg, shd, jr)
    with torch.no_grad():
        got, _ = forward_train(model, {"tokens": tp, "frames": tf}, tcfg,
                               RunConfig(**BLOCKS))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2e-2


def test_prefill_without_frames_raises():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        forward_prefill(model, torch.ones((1, 4), dtype=torch.int32),
                        RunConfig(), max_seq=8)


# ---------------------------------------------------------------------------
# R8: the reference's prefill and decode disagree about cross-attention
# ---------------------------------------------------------------------------


def test_r8_cross_attention_prefill_is_causal_decode_sees_all_frames(mesh1):
    """Pinned as the reference has it (ROADMAP R8). At prefill (and in
    training) the cross-attention takes the causal mask, so decoder
    position t sees frames 0..t: rows of the encoder output past the last
    prompt position change nothing. At decode every row reads all
    ``encoder_seq`` frames (pos = T - 1): the last frame's k/v change the
    output. Both packages, f32, within 1e-5."""
    jcfg, tcfg, params, model = _pair("float32", mesh1)
    shd, jr, tr = ShardingCtx(mesh1), JRunConfig(**BLOCKS), \
        RunConfig(**BLOCKS)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["cross"])
    tp = model.blocks[0]["cross"]
    s, t = 6, 24
    h, enc = _rand(11, B, s, 64), _rand(12, B, t, 64)
    late = enc.copy()
    late[:, s:] = _rand(13, B, t - s, 64)
    pos = np.arange(s)

    def both(kv):
        want = j_gqa(jp, jnp.asarray(h), jcfg, shd, jr,
                     positions=jnp.asarray(pos), kv_x=jnp.asarray(kv))
        with torch.no_grad():
            got = gqa_attention(tp, torch.from_numpy(h), tcfg, tr,
                                positions=torch.from_numpy(pos),
                                kv_x=torch.from_numpy(kv))
        assert _rel(got, want) <= 1e-5
        return _np(got), np.asarray(want)

    g0, w0 = both(enc)
    g1, w1 = both(late)
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_allclose(w0, w1, atol=1e-6)
    # decode: the encoder k/v as the prefill caches them, read at T - 1
    with torch.no_grad():
        _, kvc = gqa_attention(tp, torch.from_numpy(h), tcfg, tr,
                               positions=torch.from_numpy(pos),
                               kv_x=torch.from_numpy(enc), return_cache=True)
    row = h[:, :1]

    def decode(k, v):
        want = j_gqa(jp, jnp.asarray(row), jcfg, shd, jr,
                     positions=jnp.full((B,), 3, jnp.int32),
                     cache={"k": jnp.asarray(k.numpy()),
                            "v": jnp.asarray(v.numpy())},
                     return_cache=True, cross_decode=True)[0]
        with torch.no_grad():
            got = gqa_attention(tp, torch.from_numpy(row), tcfg, tr,
                                positions=torch.full((B,), 3,
                                                     dtype=torch.int32),
                                cache={"ck": k, "cv": v}, cross_decode=True)
        assert _rel(got, want) <= 1e-5
        return _np(got)

    d0 = decode(kvc["k"], kvc["v"])
    k2 = kvc["k"].clone()
    k2[:, -1] += 1.0
    d1 = decode(k2, kvc["v"])
    assert np.abs(d0 - d1).max() > 1e-3
    # the prefill's row 0 saw frame 0 alone; the decode of the same row
    # sees all 24
    assert np.abs(d0[:, 0] - g0[:, 0]).max() > 1e-3


# ---------------------------------------------------------------------------
# R9: neither ServeEngine serves an encoder model
# ---------------------------------------------------------------------------


def test_r9_both_serve_engines_fail_on_encdec(mesh1):
    """The reference's engine takes whisper and fails at its first
    prefill, which it runs without frames; the port's refuses it at
    construction with a ValueError naming frames (ROADMAP R9)."""
    with pytest.raises(ValueError, match="frames"):
        TEngine(get_smoke_config(ARCH), RunConfig(), batch_slots=2,
                max_seq=16, device="cpu")
    jeng = JEngine(j_smoke(ARCH), JRunConfig(), mesh1, batch_slots=2,
                   max_seq=16)
    jeng.submit(JRequest(tenant_id=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(AttributeError, match="shape"):
        jeng.step()


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

PORTED = sorted(J_ARCHS)         # every family is ported, moe included


def _desc(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_reference(arch, shape):
    """Every input of the cell, by key, shape and dtype: tokens, labels,
    frames, pos, and each segment's cache leaves (meta tensors: nothing
    is allocated, long_500k included)."""
    cfg = get_config(arch)
    want = j_input_specs(j_config(arch), j_shape(shape))
    got = input_specs(cfg, SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "caches":
            assert len(got[k]) == len(want[k])
            for gseg, wseg in zip(got[k], want[k]):
                assert sorted(gseg) == sorted(wseg)
                for leaf in wseg:
                    assert gseg[leaf].device.type == "meta"
                    assert _desc(gseg[leaf]) == (
                        tuple(wseg[leaf].shape), wseg[leaf].dtype.name), \
                        (k, leaf)
        else:
            assert got[k].device.type == "meta"
            assert _desc(got[k]) == (tuple(want[k].shape),
                                     want[k].dtype.name), k


def test_whisper_cache_bytes_at_the_serve_shape():
    """The encdec serve phase's cache at B 8, ``max_seq`` 448, bf16:
    442,368,000 bytes of ``ck``/``cv`` and 132,120,576 of self k/v, as
    ``init_cache`` holds them on the meta device."""
    cfg = get_config(ARCH)
    (seg,) = input_specs(cfg, dataclasses.replace(
        SHAPES["decode_32k"], seq_len=448, global_batch=8))["caches"]
    nbytes = {k: v.numel() * v.element_size() for k, v in seg.items()}
    assert nbytes["ck"] + nbytes["cv"] == 442_368_000
    assert nbytes["k"] + nbytes["v"] == 132_120_576
    small = init_cache(get_smoke_config(ARCH), 2, 8, device="cpu")
    assert sorted(small[0]) == ["ck", "cv", "k", "v"]


# ---------------------------------------------------------------------------
# chip_smoke.py's encdec phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_encdec_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s encdec phase at whisper's smoke config (2
    utterances, ``max_seq`` 32, 6 new tokens, 3 parity steps), with
    ``torch.cuda``'s synchronize and memory calls stubbed and the plain
    kernels wrapped to count launches: flash once per encoder layer,
    decoder layer and cross-attention, decode twice per decoder layer and
    step, the cache's bytes the schema's, both parity runs."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    cs = _chip_smoke()
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    for name, value in (("ENCDEC_BATCH", 2), ("ENCDEC_MAX_SEQ", 32),
                        ("ENCDEC_NEW", 6), ("ENCDEC_PARITY_STEPS", 3)):
        monkeypatch.setattr(cs, name, value)
    for mod_name, counter in (("flash_attention", fa.flash_attention),
                              ("decode_kernel", da.decode_attention)):
        real = getattr(attention, mod_name)

        def counted(*args, _real=real, _counter=counter, **kw):
            _counter.launches += 1
            return _real(*args, **kw)

        monkeypatch.setattr(attention, mod_name, counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg = get_smoke_config(ARCH)
    launches = cs.phase_encdec(torch, torch.device("cpu"), cfg)
    assert launches == {"flash_attention": 2 + 2 * 2,
                        "decode_attention": 2 * 2 * 6}
    serve, parity = rows
    assert serve["ok"] and parity["ok"], rows
    assert serve["cache_bytes"]["ck"] == 2 * 2 * 24 * 4 * 16 * 2
    assert parity["f32_tokens_identical"]
