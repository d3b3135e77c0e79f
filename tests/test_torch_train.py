"""The port's training path against the reference's, on the CPU.

Inputs are made from a seed with numpy, or are the reference's own: its
data pipeline, and its train state from ``make_train_state(cfg, rcfg,
make_host_mesh(1, 1), key)``. Weights cross with ``params_from_jax`` and
whole states with ``train_state_from_jax``; ``train_state_to_numpy``
brings a port state back in the reference's stacked layout. The
reference's block weights are rescaled to their true fan-in first, as
``tests/test_torch_model.py::_pair`` does (its init reads a stacked leaf's
layer count as fan-in, which swamps any bf16 comparison). Tolerances:

* data: bit for bit;
* AdamW: f32 moments, params within 1e-6 relative (of the leaf's max
  |value|) and moments within 1e-5; bf16 moments against the reference
  compiled with XLA's excess precision off (``SOURCE_ROUNDING``, P15), so
  both round where the source casts: moments within one bf16 ulp
  (2^-7 relative), params within 1e-5;
* loss and gradients of every leaf: f32 loss within 1e-5 relative, grads
  within 1e-4 of the leaf's max |grad|; bf16 within 2e-2;
* three train steps at f32: every parameter within 1% of a step's size
  (lr) per step, absolute. Adam divides each element by |g| + 1e-8, so an
  element whose gradient is ~1e-9 of the leaf's largest moves by its
  gradient's last bits (78 of 90,432 elements differ by more than 1e-6
  of their leaf's max, by at most 0.6% of lr; with accumulation the bf16
  cast of the mean flips 756, by at most 1.9% of lr over the 3 steps);
  moments within 1e-4 of the leaf's max (one bf16 ulp, 2^-7, where
  accumulation casts the gradient to bf16), metrics within 1e-5;
* the Runner: losses within 1e-4 of the reference's over 5 steps at f32;
  recovery bit-exact;
* the ssm, hybrid and encdec families (mamba2, hymba, whisper smoke
  configs at f32): loss within 1e-5, every grad within 1e-4, and after one
  train step every parameter within 1% of lr and the moments within 1e-4;
  ``SsdScanFn`` against autograd through the scan's plain version within
  1e-6 (f64 inside both, rounded to f32).
"""
import dataclasses
import functools
import json
import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShape
from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.data import for_model as j_for_model
from repro.distribution.sharding import ShardingCtx
from repro.launch.mesh import make_host_mesh
from repro.train import Runner as JRunner
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import cosine_schedule as j_cosine
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.train_loop import loss_fn as j_loss_fn
from repro.train.train_loop import make_train_state as j_make_state
from repro.train.train_loop import make_train_step as j_make_step
from repro_torch.configs import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.data import DataConfig, DataPipeline, for_model
from repro_torch.models import (forward_prefill, forward_train, init_params,
                                model_schema, opt_slots, params_from_jax,
                                train_state_from_jax, train_state_to_numpy)
from repro_torch.models.attention import (FlashAttentionFn,
                                          blockwise_attention, q_to_kv_map)
from repro_torch.models.model import build_schedule
from repro_torch.models.schema import walk
from repro_torch.train import (CheckpointManager, FailurePlan, Runner,
                               adamw_update, loss_fn, make_train_state,
                               make_train_step)
from repro_torch.train.optimizer import _decay_mask
from repro_torch.train.train_loop import _grads

from _torch_threads import one_thread  # noqa: F401

ARCHS = ("llama3.2-3b", "internlm2-1.8b", "granite-8b")

LLAMA = "llama3.2-3b"
SOURCE_ROUNDING = {"xla_allow_excess_precision": False}
BF16_ULP = 2.0 ** -7


def _cfgs(arch, dtype="bfloat16"):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype="float32",
                                   param_dtype="float32")
        tcfg = dataclasses.replace(tcfg, dtype="float32",
                                   param_dtype="float32")
    return jcfg, tcfg


def _rcfgs(**kw):
    base = dict(attn_q_block=8, attn_kv_block=8)
    base.update(kw)
    return JRunConfig(**base), RunConfig(**base)


def _rescale(stacked, schema):
    """A stacked segment's normal-init leaves rescaled from the
    reference's fan-in (the layer count) to their true one."""
    for path, desc in walk(schema):
        if desc.init not in ("normal", "small_normal"):
            continue
        node = stacked
        for key_ in path[:-1]:
            node = node[key_]
        a = node[path[-1]]
        node[path[-1]] = (a.astype(np.float32) * np.sqrt(
            a.shape[0] / desc.init_fan_in)).astype(a.dtype)


def _ref_state(jcfg, tcfg, jrcfg, key=0):
    """The reference's train state (numpy leaves), its block weights (an
    encoder's too) rescaled to their true fan-in."""
    state = jax.tree.map(np.asarray, j_make_state(
        jcfg, jrcfg, make_host_mesh(1, 1), jax.random.PRNGKey(key)))
    schema = model_schema(tcfg)
    first = 0
    for seg, stacked in zip(build_schedule(tcfg),
                            state["params"]["segments"]):
        _rescale(stacked, schema["layers"][first])
        first += seg.count
    if tcfg.encoder_layers:
        _rescale(state["params"]["encoder"]["segments"][0],
                 schema["encoder"]["layers"][0])
    return state


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _rel(a, b):
    """max |a - b| / max |b| (0 where both are all zero)."""
    a, b = _f32(a), _f32(b)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else \
        float(np.abs(a).max())


def _leaves_with_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(kp), v) for kp, v in flat]


def _assert_trees(port, ref, tol, what):
    pl, rl = _leaves_with_paths(port), _leaves_with_paths(ref)
    assert [p for p, _ in pl] == [p for p, _ in rl], what
    for (path, a), (_, b) in zip(pl, rl):
        assert np.shape(a) == np.shape(b), (what, path)
        err = _rel(a, b)
        assert err <= tol, (what, path, err)


def _by_ref(named: dict, tcfg):
    """A {parameter name: tensor} dict in the reference's stacked layout,
    as numpy, keyed by the reference leaf's path."""
    names = {}
    for slot in opt_slots(tcfg):
        names.setdefault(slot.ref_path, []).extend(slot.params)
    out = {}
    for ref, ns in names.items():
        arrs = [named[n].detach().float().numpy() for n in ns]
        out[ref] = np.stack(arrs) if "segments" in ref else arrs[0]
    return out


def _ref_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch(jcfg, b, s, step=0, seed=0):
    arrs = JDataPipeline(JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        with_frames=bool(jcfg.encoder_layers),
        encoder_seq=jcfg.encoder_seq, d_model=jcfg.d_model)).batch_at(step)
    arrs = {k: np.asarray(v) for k, v in arrs.items()}
    return arrs, {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pipeline_matches_reference_bit_for_bit(seed):
    """Tokens and labels for 4 steps (the last label of each row is 0), and
    an encoder model's frames, drawn after the tokens."""
    for arch, s, b in ((LLAMA, 40, 6), ("whisper-small", 24, 4)):
        jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
        jp = j_for_model(jcfg, JShape("t", s, b, "train"), seed=seed)
        tp = for_model(tcfg, ShapeConfig("t", s, b, "train"), seed=seed,
                       device="cpu")
        for step in range(4):
            want = {k: np.asarray(v) for k, v in jp.batch_at(step).items()}
            got = tp.batch_at(step)
            assert sorted(got) == sorted(want)
            assert ("frames" in got) == (arch == "whisper-small")
            for k in want:
                assert got[k].device.type == "cpu"
                assert str(got[k].dtype).endswith(str(want[k].dtype)), k
                np.testing.assert_array_equal(got[k].numpy(), want[k])
            assert (got["labels"][:, -1] == 0).all()
    dcfg = dict(vocab_size=300, seq_len=20, global_batch=3, seed=seed,
                with_frames=True, encoder_seq=5, d_model=8)
    want = JDataPipeline(JDataConfig(**dcfg)).batch_at(2)
    got = DataPipeline(DataConfig(**dcfg), device="cpu").batch_at(2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

ADAMW_CASES = {
    "f32": dict(),
    "clip0": dict(grad_clip=0.0),
    "factored": dict(factored_nu=True),
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "bf16_factored": dict(moment_dtype="bfloat16", factored_nu=True),
}
# warmup 2, total 10: steps 0-2 cross from warm-up into the cosine, 4-6
# are mid-cosine, 9-11 the end (lr 0 from step 10)
START_COUNTS = {"warmup": 0, "mid": 4, "end": 9}


def _grad_trees(jcfg, params, n, seed):
    """``n`` random gradient trees shaped like ``params`` (numpy)."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.5)
                         .astype(p.dtype), params) for _ in range(n)]


def _run_adamw(jcfg, tcfg, overrides, start, grads_of=None, steps=3):
    jrcfg, trcfg = _rcfgs(warmup_steps=2, total_steps=10, **overrides)
    state = _ref_state(jcfg, tcfg, jrcfg)
    opt = jax.tree.map(np.asarray, j_init_opt(
        jax.tree.map(jnp.asarray, state["params"]), jrcfg))
    opt["count"] = np.int32(start)
    state["opt"] = opt
    port = train_state_from_jax(state, tcfg, device="cpu")
    grads = _grad_trees(jcfg, state["params"], steps, seed=start + 11)
    if grads_of is not None:
        grads = [grads_of(g) for g in grads]
    compiler = SOURCE_ROUNDING if jrcfg.moment_dtype == "bfloat16" else None
    step_fn = jax.jit(functools.partial(j_adamw, rcfg=jrcfg),
                      compiler_options=compiler)
    params, jopt = jax.tree.map(jnp.asarray, (state["params"], opt))
    for g in grads:
        params, jopt, jm = step_fn(params, jax.tree.map(jnp.asarray, g), jopt)
        named = dict(params_from_jax(g, tcfg, device="cpu")
                     .named_parameters())
        _, _, tm = adamw_update(port["params"], named, port["opt"], trcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    ref = {"params": jax.tree.map(np.asarray, params),
           "opt": jax.tree.map(np.asarray, jopt)}
    return train_state_to_numpy(port, tcfg), ref, jrcfg


@pytest.mark.parametrize("start", list(START_COUNTS))
@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_matches_reference(case, start):
    """Three updates in a row from crossed states of llama's smoke config
    at f32 parameters: f32 and bf16 moments, factored nu (the 1-D block
    leaves' ``vc`` averaged over the segment's layers), clipping off and
    on, weight decay 0.1, lr in warm-up, mid-cosine and at the end."""
    jcfg, tcfg = _cfgs(LLAMA, "float32")
    port, ref, jrcfg = _run_adamw(jcfg, tcfg, ADAMW_CASES[case],
                                  START_COUNTS[start])
    assert int(port["opt"]["count"]) == int(ref["opt"]["count"]) \
        == START_COUNTS[start] + 3
    bf16 = jrcfg.moment_dtype == "bfloat16"
    _assert_trees(port["params"], ref["params"], 1e-5 if bf16 else 1e-6,
                  "params")
    _assert_trees(port["opt"]["mu"], ref["opt"]["mu"],
                  BF16_ULP if bf16 else 1e-5, "mu")
    _assert_trees(port["opt"]["nu"], ref["opt"]["nu"],
                  BF16_ULP if bf16 else 1e-5, "nu")
    if jrcfg.factored_nu:     # the stacked 1-D leaves' factors
        vc = port["opt"]["nu"]["segments"][0]["ln1"]["scale"]["vc"]
        assert vc.shape == (jcfg.d_model,)


def test_adamw_decays_the_block_norms_as_the_stacked_reference():
    """Trap (a): the reference decays a leaf iff its stacked ndim >= 2, so
    the block norms' (L, d) scales decay and only top-level 1-D leaves
    (``final_norm``) are spared. With zero gradients an update is the
    decay alone: the block norms shrink by lr * wd, final_norm stays."""
    jcfg, tcfg = _cfgs(LLAMA, "float32")

    def zero(g):
        return jax.tree.map(np.zeros_like, g)

    port, ref, jrcfg = _run_adamw(jcfg, tcfg, {}, START_COUNTS["mid"],
                                  grads_of=zero, steps=1)
    _assert_trees(port["params"], ref["params"], 1e-6, "params")
    ln1 = port["params"]["segments"][0]["ln1"]["scale"]
    start = _ref_state(jcfg, tcfg, jrcfg)["params"]
    lr = float(j_cosine(jrcfg)(START_COUNTS["mid"]))
    np.testing.assert_allclose(
        ln1, start["segments"][0]["ln1"]["scale"] * (1 - lr * 0.1),
        rtol=1e-6)
    np.testing.assert_array_equal(port["params"]["final_norm"]["scale"],
                                  start["final_norm"]["scale"])
    model = init_params(tcfg, device="cpu", seed=0)
    mask = _decay_mask(opt_slots(tcfg), dict(model.named_parameters()))
    assert mask["segments.0.ln1.scale"]
    assert not mask["final_norm.scale"]
    assert mask["embed.tokens"] and mask["blocks.0.attn.wq"]


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    """``loss_fn`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's, B 2, S 24 (three q blocks
    of 8, so the backward's blockwise attention skips blocks)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jrcfg, trcfg = _rcfgs()
    state = _ref_state(jcfg, tcfg, jrcfg)
    jb, tb = _batch(jcfg, 2, 24)
    mesh = make_host_mesh(1, 1)
    compiler = SOURCE_ROUNDING if dtype == "bfloat16" else None
    vg = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=jcfg, shd=ShardingCtx(mesh), rcfg=jrcfg),
        has_aux=True), compiler_options=compiler)
    (jloss, jmet), jgrads = vg(jax.tree.map(jnp.asarray, state["params"]),
                               jax.tree.map(jnp.asarray, jb))
    model = params_from_jax(state["params"], tcfg, device="cpu")
    grads, tmet = _grads(model, tb, tcfg, trcfg)
    tol_loss, tol_g = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    for k in ("loss", "ce_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=tol_loss, err_msg=k)
    stacked = _by_ref(grads, tcfg)
    assert len(stacked) == len(jax.tree.leaves(jgrads))
    for ref_path, got in stacked.items():
        want = np.asarray(_ref_at(jgrads, ref_path))
        assert got.shape == want.shape, ref_path
        assert _rel(got, want) <= tol_g, (ref_path, _rel(got, want))


def test_forward_train_logits_equal_the_prefill_logits():
    """The training forward's last-position logits are the prefill's (the
    same layers, the same kernel forward; remat changes nothing)."""
    _, tcfg = _cfgs(LLAMA, "float32")
    jcfg = _cfgs(LLAMA, "float32")[0]
    jrcfg, trcfg = _rcfgs()
    model = params_from_jax(_ref_state(jcfg, tcfg, jrcfg)["params"], tcfg,
                            device="cpu")
    _, tb = _batch(jcfg, 2, 24)
    last, _ = forward_prefill(model, tb["tokens"], trcfg, max_seq=24)
    for remat in ("full", "none"):
        logits, aux = forward_train(model, tb, tcfg,
                                    dataclasses.replace(trcfg, remat=remat))
        assert aux == {}
        np.testing.assert_allclose(logits[:, -1].detach().numpy(),
                                   last.numpy(), rtol=1e-6, atol=1e-6)


DOTS_ARCHS = ("llama3.2-3b", "arctic-480b", "deepseek-v2-236b")


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_dots_grads_equal_full(arch):
    """``remat="dots"`` (selective checkpointing) against ``"full"`` at
    f32 on the smoke configs (dense, moe, MLA): the loss equal and every
    gradient within 1e-6 of the leaf's max |grad|."""
    jcfg, tcfg = _cfgs(arch, "float32")
    model = init_params(tcfg, device="cpu", seed=0)
    _, tb = _batch(jcfg, 2, 24)
    out = {}
    for remat in ("full", "dots"):
        out[remat] = _grads(model, tb, tcfg, _rcfgs(remat=remat)[1])
    assert float(out["dots"][1]["loss"]) == float(out["full"][1]["loss"])
    for name, g in out["full"][0].items():
        assert _rel(out["dots"][0][name], g) <= 1e-6, name


def test_dots_loss_and_grads_match_reference():
    """``remat="dots"`` on both sides (the reference's
    ``dots_with_no_batch_dims_saveable``), llama's smoke config at f32, B
    2, S 24: loss within 1e-5 relative, every grad within 1e-4 of the
    leaf's max |grad|."""
    jcfg, tcfg = _cfgs(LLAMA, "float32")
    jrcfg, trcfg = _rcfgs(remat="dots")
    state = _ref_state(jcfg, tcfg, jrcfg)
    jb, tb = _batch(jcfg, 2, 24)
    vg = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=jcfg, shd=ShardingCtx(make_host_mesh(1, 1)),
        rcfg=jrcfg), has_aux=True))
    (_, jmet), jgrads = vg(jax.tree.map(jnp.asarray, state["params"]),
                           jax.tree.map(jnp.asarray, jb))
    model = params_from_jax(state["params"], tcfg, device="cpu")
    grads, tmet = _grads(model, tb, tcfg, trcfg)
    for k in ("loss", "ce_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    for ref_path, got in _by_ref(grads, tcfg).items():
        want = np.asarray(_ref_at(jgrads, ref_path))
        assert _rel(got, want) <= 1e-4, (ref_path, _rel(got, want))


def _ref_no_batch_dots(jcfg, seg_index, kind, b, s):
    """(M, K, N) of every ``dot_general`` with no batch dimension in the
    reference's training forward of one ``kind`` layer: the products its
    ``dots_with_no_batch_dims_saveable`` keeps."""
    import jax.extend as jex
    from repro.distribution.sharding import abstract_params
    from repro.models.blocks import apply_block as j_apply_block
    from repro.models.model import model_schema as j_model_schema
    mesh = make_host_mesh(1, 1)
    stacked = abstract_params(j_model_schema(jcfg, mesh))["segments"]
    p = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                     stacked[seg_index])
    x = jax.ShapeDtypeStruct((b, s, jcfg.d_model), jnp.float32)
    jrcfg = _rcfgs()[0]
    closed = jax.make_jaxpr(lambda p, x: j_apply_block(
        p, x, jcfg, ShardingCtx(mesh), jrcfg, kind,
        positions=jnp.arange(s), mode="train")[0])(p, x)
    out = []

    def walk(jaxpr):
        for eq in jaxpr.eqns:
            if eq.primitive.name == "dot_general":
                (lc, rc), (lb, rb) = eq.params["dimension_numbers"]
                ls = eq.invars[0].aval.shape
                rs = eq.invars[1].aval.shape
                if not lb and not rb:
                    out.append((
                        math.prod(d for i, d in enumerate(ls) if i not in lc),
                        math.prod(ls[i] for i in lc),
                        math.prod(d for i, d in enumerate(rs)
                                  if i not in rc)))
            for v in eq.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(sub, jex.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.core.Jaxpr):
                        walk(sub)

    walk(closed.jaxpr)
    return sorted(out)


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_dots_saves_the_references_no_batch_products(arch, monkeypatch):
    """The ops ``remat="dots"`` keeps in one layer's forward (the last
    segment's: dense for llama, moe for arctic and deepseek) are, as (M, K,
    N), the reference's ``dot_general``s with no batch dimension in the
    same layer: the weight products and the router, where the experts'
    products (``bmm``, the expert dim a batch dim in the reference's
    einsum) and attention's are recomputed. For llama each kept product is
    one of the layer's seven weights."""
    from repro_torch.models import model as tmodel
    jcfg, tcfg = _cfgs(arch, "float32")
    model = init_params(tcfg, device="cpu", seed=0)
    segs = build_schedule(tcfg)
    seg = segs[-1]
    b, s = 2, 24
    kept = []
    policy = tmodel._dots_saveable

    def recording(ctx, op, *args, **kw):
        if not ctx.is_recompute and op in tmodel.DOTS_SAVED:
            a, w = args[-2:]
            kept.append((a.shape[0], a.shape[1], w.shape[1]))
        return policy(ctx, op, *args, **kw)

    monkeypatch.setattr(tmodel, "_dots_saveable", recording)
    rcfg = _rcfgs(remat="dots")[1]
    x = torch.randn(b, s, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0), requires_grad=True)
    layer = tmodel._remat(tmodel._train_layer, rcfg)
    y, _ = layer(model.blocks[-1], x, tcfg, rcfg, seg, torch.arange(s),
                 None)
    y.sum().backward()
    assert x.grad is not None and len(kept) > 0
    assert sorted(kept) == _ref_no_batch_dots(jcfg, len(segs) - 1,
                                              seg.kind, b, s)
    if arch == LLAMA:
        sizes = sorted(w.numel() for w in model.blocks[-1].parameters()
                       if w.dim() >= 2)
        assert len(kept) == 7 == len(sizes)
        assert sorted(k * n for _, k, n in kept) == sizes


def test_flash_attention_fn_grads_match_blockwise_autograd():
    """On the CPU the forward is the kernel's plain version; the backward
    is the VJP of ``blockwise_attention``: both match autograd through
    ``blockwise_attention`` at f32 (causal at 4/2 heads, and with a
    window at 6/3)."""
    gen = np.random.default_rng(3)
    for hq, kv, s, window in ((4, 2, 37, 0), (6, 3, 40, 9)):
        q, k, v = (torch.from_numpy(gen.standard_normal((2, s, h, 16))
                                    .astype(np.float32)).requires_grad_()
                   for h in (hq, kv, kv))
        do = torch.from_numpy(gen.standard_normal((2, s, hq, 16))
                              .astype(np.float32))
        o = FlashAttentionFn.apply(q, k, v, True, window, 16, 8)
        got = torch.autograd.grad(o, (q, k, v), do)
        ref_o = blockwise_attention(q, k, v, kv_map=q_to_kv_map(hq, hq, kv),
                                    window=window, q_block=16, kv_block=8)
        want = torch.autograd.grad(ref_o, (q, k, v), do)
        np.testing.assert_allclose(o.detach().numpy(),
                                   ref_o.detach().numpy(), atol=1e-5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-5)


def test_training_other_families_and_remesh_raise():
    """``Runner.remesh`` with no checkpoint raises ``RuntimeError``, as the
    reference's does (the remesh itself is held in
    ``tests/test_torch_train_mesh_runner.py``); every family builds a
    sharded train step with no refusal, the moe family and MLA included
    (their steps are held against the reference in
    ``tests/test_torch_train_mesh_{moe,mla}.py``, the ssm, hybrid and
    encdec families' in ``tests/test_torch_train_mesh_{ssm,hybrid,
    encdec}.py``); Megatron-SP activations train every family (llama's SP
    step in ``tests/test_torch_train_mesh.py``, the others' in their
    ``test_torch_train_mesh_*.py``), so ``check_mesh_training`` refuses
    none and the SP step builds; a moe model's sharded forward without
    the global batch (its dispatch groups' rows) raises."""
    from repro_torch.distribution.sharding import ShardingCtx, make_rules
    from repro_torch.models import Model
    from repro_torch.models.model import check_mesh_training
    cfg = get_smoke_config(LLAMA)
    with tempfile.TemporaryDirectory() as d:
        r = Runner(cfg, RunConfig(), None, for_model(
            cfg, ShapeConfig("t", 16, 2, "train"), device="cpu"), d,
            device="cpu")
        r.init_state()
        with pytest.raises(RuntimeError,
                           match="elastic remesh requires a checkpoint"):
            r.remesh(None)
    sizes = {"data": 1, "model": 1}
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    sp = RunConfig(seq_parallel_activations=True)
    for arch in ("arctic-480b", "deepseek-v2-236b", "mamba2-370m",
                 "hymba-1.5b", "whisper-small", LLAMA, "chameleon-34b"):
        tcfg = get_smoke_config(arch)
        shd = ShardingCtx(sizes, rules=make_rules("2d"), train=True)
        assert check_mesh_training(tcfg, RunConfig()) is None
        state = make_train_state(tcfg, RunConfig(), device="cpu",
                                 abstract=True, shd=shd)
        assert state["params"].shd is shd
        assert callable(make_train_step(tcfg, RunConfig(), shd))
        if tcfg.moe is not None:
            with pytest.raises(ValueError, match=f"{tcfg.name}: .* "
                               f"needs the global batch"):
                forward_train(Model(tcfg, device="cpu", shd=shd), batch,
                              tcfg, RunConfig())
        # every family takes Megatron-SP on a mesh, the ssm, hybrid and
        # encdec families too
        assert check_mesh_training(tcfg, sp) is None
        assert callable(make_train_step(tcfg, sp, shd))
    sp_shd = ShardingCtx(sizes, rules=make_rules("2d"), train=True,
                         seq_parallel=True)
    assert sp_shd.sp_of(8) == "model" and sp_shd.for_seq(8) is not sp_shd
    assert ShardingCtx(sizes, rules=make_rules("fsdp"), train=True,
                       seq_parallel=True).sp_of(8) is None


# ---------------------------------------------------------------------------
# the ssm, hybrid and encdec families
# ---------------------------------------------------------------------------

# sequence lengths of the smoke configs: mamba2 and hymba 40 (a chunk of 32
# and a padded one; past hymba's window of 32), whisper 20 (below its 24
# frames, as whisper's 448 tokens are below its 1500)
FAMILY_SEQ = {"mamba2-370m": 40, "hymba-1.5b": 40, "whisper-small": 20}


def test_ssd_scan_fn_grads_match_plain_autograd():
    """On the CPU ``SsdScanFn``'s forward is the kernel's plain version and
    its backward the VJP of that version: the four outputs and the grads
    of xdt, dA, B and C equal autograd straight through
    ``ssd_chunk_scan_plain``, with every output's cotangent non-zero (a
    padded chunk: dA = 0 and zero inputs past 45 of 64 positions)."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_plain
    from repro_torch.models.ssm import SsdScanFn
    gen = np.random.default_rng(4)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((gen.standard_normal(shape) * scale)
                                .astype(np.float32)).requires_grad_()

    nb, nc, q, h, p, n = 2, 2, 32, 3, 8, 16
    xdt, B, C = leaf(nb, nc, q, h, p, scale=0.2), leaf(nb, nc, q, n,
                                                       scale=0.4), \
        leaf(nb, nc, q, n, scale=0.4)
    dA = torch.from_numpy(-np.abs(gen.standard_normal((nb, nc, q, h)))
                          .astype(np.float32) * 0.2)
    with torch.no_grad():
        for t in (xdt, B, C):
            t[:, -1, 13:] = 0
        dA[:, -1, 13:] = 0
    dA.requires_grad_()
    outs = SsdScanFn.apply(xdt, dA, B, C)
    want = ssd_chunk_scan_plain(xdt, dA, B, C, out_dtype=torch.float32,
                                state_decay=True)
    cots = [torch.from_numpy(gen.standard_normal(o.shape).astype(
        np.float32)) for o in want]
    got_g = torch.autograd.grad(outs, (xdt, dA, B, C), cots)
    want_g = torch.autograd.grad(want, (xdt, dA, B, C), cots)
    for a, b in zip(outs, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    for a, b in zip(got_g, want_g):
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", list(FAMILY_SEQ))
def test_family_loss_grads_and_step_match_reference(arch):
    """mamba2 (the ssm family: every grad through ``SsdScanFn``, A_log and
    dt_bias included), hymba (hybrid: flash and the SSD scan in parallel
    in every layer, a window of 32 over 40 tokens) and whisper (encdec:
    the encoder's grads through the cross-attention, the frames from the
    reference's pipeline) at f32: ``loss_fn`` and the gradient of every
    leaf against ``jax.value_and_grad`` of the reference's, then one step
    of each package's ``make_train_step`` from the same state, the whole
    states compared."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jrcfg, trcfg = _rcfgs(warmup_steps=1, learning_rate=1e-2)
    state = _ref_state(jcfg, tcfg, jrcfg)
    jb, tb = _batch(jcfg, 2, FAMILY_SEQ[arch])
    assert ("frames" in tb) == (arch == "whisper-small")
    mesh = make_host_mesh(1, 1)
    vg = jax.jit(jax.value_and_grad(functools.partial(
        j_loss_fn, cfg=jcfg, shd=ShardingCtx(mesh), rcfg=jrcfg),
        has_aux=True))
    (jloss, jmet), jgrads = vg(jax.tree.map(jnp.asarray, state["params"]),
                               jax.tree.map(jnp.asarray, jb))
    port = train_state_from_jax(state, tcfg, device="cpu")
    grads, tmet = _grads(port["params"], tb, tcfg, trcfg)
    for k in ("loss", "ce_loss", "z_loss"):
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
    for (path, a), (_, b) in zip(_leaves_with_paths(got["params"]),
                                 _leaves_with_paths(want["params"])):
        err = float(np.abs(a - b).max())
        assert err <= 0.01 * trcfg.learning_rate, (path, err)
    _assert_trees(got["opt"]["mu"], want["opt"]["mu"], 1e-4, "mu")
    _assert_trees(got["opt"]["nu"], want["opt"]["nu"], 1e-4, "nu")


def test_family_decay_mask_and_slots_follow_the_stacked_reference():
    """The SSM leaves and an encoder's: every block leaf decays (its
    stacked ndim >= 2: ``A_log``, ``D`` and ``dt_bias`` are (L, H), the
    conv taps (L, W, C)), the 1-D top-level ones (both final norms) do
    not; with factored nu the 1-D per-layer leaves' ``vc`` averages over
    the segment's layers and a per-layer 2-D leaf keeps (vr, vc). Held
    against the reference's mask and its optimizer state's layout."""
    from repro.train.optimizer import _decay_mask as j_decay_mask
    for arch in ("mamba2-370m", "hymba-1.5b", "whisper-small"):
        jcfg, tcfg = _cfgs(arch)
        jrcfg, _ = _rcfgs(factored_nu=True)
        state = _ref_state(jcfg, tcfg, jrcfg)
        model = init_params(tcfg, device="cpu", seed=0)
        mask = _decay_mask(opt_slots(tcfg), dict(model.named_parameters()))
        want = j_decay_mask(state["params"])
        by = {s.ref_path: mask[s.name] for s in opt_slots(tcfg)}
        for path, m in _leaves_with_paths(want):
            ref = tuple(int(k.strip("[]")) if k.strip("[]").isdigit() else
                        k.strip("[]'") for k in path.replace("][", "]|[")
                        .split("|"))
            assert by[ref] == bool(m), (arch, path)
        names = {s.name for s in opt_slots(tcfg)}
        if tcfg.ssm is not None:
            assert mask["segments.0.ssm.A_log"] and \
                mask["segments.0.ssm.dt_bias"]
            assert mask["blocks.0.ssm.conv_x"]
        if tcfg.encoder_layers:
            assert not mask["encoder.final_norm.scale"]
            assert mask["encoder.segments.0.ln1.bias"]
            assert "encoder.blocks.1.cross" not in names
        port = train_state_from_jax(state, tcfg, device="cpu")
        back = train_state_to_numpy(port, tcfg)
        for (p1, a), (p2, b) in zip(
                _leaves_with_paths(back["opt"]["nu"]),
                _leaves_with_paths(state["opt"]["nu"])):
            assert p1 == p2 and a.shape == b.shape, (arch, p1)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_plain_step_matches_reference_three_steps(accum):
    """``make_train_step``'s plain step, three steps from one crossed state
    at f32 (B 4, S 16), whole states compared leaf by leaf, and the
    metrics, the int8 EF residual of the gradients included. With
    accumulation the metrics are the last micro-batch's,
    not the mean (the reference's scan carry)."""
    jcfg, tcfg = _cfgs(LLAMA, "float32")
    jrcfg, trcfg = _rcfgs(grad_accum=accum, warmup_steps=1,
                          learning_rate=1e-2, track_ef_residual=True)
    state = _ref_state(jcfg, tcfg, jrcfg)
    port = train_state_from_jax(state, tcfg, device="cpu")
    jstep = jax.jit(j_make_step(jcfg, jrcfg, make_host_mesh(1, 1)))
    tstep = make_train_step(tcfg, trcfg)
    jstate = jax.tree.map(jnp.asarray, state)
    for step in range(3):
        jb, tb = _batch(jcfg, 4, 16, step=step)
        if accum > 1 and step == 0:
            last = {k: v[2:] for k, v in tb.items()}
            first = {k: v[:2] for k, v in tb.items()}
            with torch.no_grad():
                last_loss = float(loss_fn(port["params"], last, tcfg,
                                          trcfg)[0])
                first_loss = float(loss_fn(port["params"], first, tcfg,
                                           trcfg)[0])
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jb))
        port, tm = tstep(port, tb)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=(step, k))
        if accum > 1 and step == 0:
            assert float(tm["loss"]) == last_loss != first_loss
    got = train_state_to_numpy(port, tcfg)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"]) == 3
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 3
    for (path, a), (_, b) in zip(_leaves_with_paths(got["params"]),
                                 _leaves_with_paths(want["params"])):
        err = float(np.abs(a - b).max())
        assert err <= 0.01 * trcfg.learning_rate * 3, (path, err)
    tol = 1e-4 if accum == 1 else BF16_ULP
    _assert_trees(got["opt"]["mu"], want["opt"]["mu"], tol, "mu")
    _assert_trees(got["opt"]["nu"], want["opt"]["nu"], tol, "nu")


def test_train_state_round_trips_through_the_reference_layout():
    """``train_state_to_numpy(train_state_from_jax(s))`` is ``s``, bit for
    bit (bf16 widened to f32), with factored nu."""
    jcfg, tcfg = _cfgs(LLAMA)
    jrcfg, _ = _rcfgs(factored_nu=True)
    state = _ref_state(jcfg, tcfg, jrcfg)
    state["opt"] = jax.tree.map(
        lambda a: np.random.default_rng(a.size).standard_normal(a.shape)
        .astype(a.dtype), state["opt"])
    state["opt"]["count"], state["step"] = np.int32(5), np.int32(6)
    back = train_state_to_numpy(train_state_from_jax(state, tcfg, "cpu"),
                                tcfg)
    for (p1, a), (p2, b) in zip(_leaves_with_paths(back),
                                _leaves_with_paths(state)):
        assert p1 == p2
        np.testing.assert_array_equal(a, _f32(b) if a.dtype == np.float32
                                      else b, err_msg=p1)


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py on the port)
# ---------------------------------------------------------------------------


def _ck_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g),
            "b": torch.randn((8,), generator=g).to(torch.bfloat16),
            "inner": {"c": torch.arange(10, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_with_bf16():
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d)
        s = _ck_state()
        m.save(3, s, blocking=True, extras={"note": "x"})
        tpl = {k: (torch.empty_like(v) if isinstance(v, torch.Tensor) else
                   {"c": torch.zeros_like(v["c"])}) for k, v in s.items()}
        back, extras = m.restore(tpl)
        assert back is tpl and extras == {"note": "x"}
        for k in ("w", "b", "step"):
            assert back[k].dtype == s[k].dtype
            assert torch.equal(back[k], s[k])
        assert torch.equal(back["inner"]["c"], s["inner"]["c"])


def test_checkpoint_async_save_and_wait():
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d)
        s = _ck_state()
        saved = s["w"].clone()
        m.save(1, s, blocking=False)
        s["w"].add_(1.0)              # the snapshot was taken at save()
        m.wait()
        assert m.latest_step() == 1
        tpl = _ck_state(seed=5)
        m.restore(tpl)
        assert torch.equal(tpl["w"], saved)


def test_checkpoint_keep_last_k_gc():
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d, keep=2)
        for step in (1, 2, 3, 4):
            m.save(step, _ck_state(step), blocking=True)
        assert m.steps() == [3, 4]


def test_checkpoint_tmp_dir_never_visible():
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d)
        os.makedirs(os.path.join(d, "step_000000009.tmp"))
        assert m.latest_step() is None
        with pytest.raises(FileNotFoundError):
            m.restore(_ck_state())


def test_checkpoint_files_hold_the_references_bytes():
    """For one train state, the port's and the reference's ``.npy`` files
    of ``embed.tokens`` (bf16, stored as uint16) and ``final_norm.scale``
    are byte for byte the same; a restore puts the state back in place,
    into the model's own parameters."""
    jcfg, tcfg = _cfgs(LLAMA)
    jrcfg, _ = _rcfgs()
    state = _ref_state(jcfg, tcfg, jrcfg)
    port = train_state_from_jax(state, tcfg, device="cpu")
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        JCheckpointManager(dj).save(4, jax.tree.map(jnp.asarray, state))
        CheckpointManager(dt).save(4, port)
        with open(os.path.join(dt, "step_000000004", "manifest.json")) as f:
            files = {m["path"]: m["file"] for m in json.load(f)["leaves"]}
        ref_files = {p: f"leaf_{i}.npy" for i, (p, _) in
                     enumerate(_leaves_with_paths(state))}
        for port_path, ref_path in (
                ("params.embed.tokens", "['params']['embed']['tokens']"),
                ("params.final_norm.scale",
                 "['params']['final_norm']['scale']")):
            with open(os.path.join(dt, "step_000000004",
                                   files[port_path]), "rb") as f:
                got = f.read()
            with open(os.path.join(dj, "step_000000004",
                                   ref_files[ref_path]), "rb") as f:
                want = f.read()
            assert got == want, port_path
        ids = [id(p) for p in port["params"].parameters()]
        with torch.no_grad():
            for p in port["params"].parameters():
                p.zero_()
        CheckpointManager(dt).restore(port)
        assert [id(p) for p in port["params"].parameters()] == ids
        back = train_state_to_numpy(port, tcfg)
        np.testing.assert_array_equal(back["params"]["embed"]["tokens"],
                                      _f32(state["params"]["embed"]
                                           ["tokens"]))


# ---------------------------------------------------------------------------
# the Runner (tests/test_system.py:36-83 on the port)
# ---------------------------------------------------------------------------

CFG = get_smoke_config(LLAMA)
SHAPE = ShapeConfig("tiny", 32, 8, "train")


def _runner_rcfg(**kw):
    base = dict(attn_q_block=16, attn_kv_block=16, checkpoint_every=5,
                total_steps=40, warmup_steps=5, learning_rate=1e-2)
    base.update(kw)
    return RunConfig(**base)


def _runner(d, **kw):
    return Runner(CFG, _runner_rcfg(), None,
                  for_model(CFG, SHAPE, device="cpu"), d, device="cpu", **kw)


def test_runner_loss_decreases():
    with tempfile.TemporaryDirectory() as d:
        r = _runner(d)
        r.init_state(1)
        r.run(10)
        losses = [m["ce_loss"] for m in r.metrics_log]
        assert losses[-1] < losses[0]


def test_runner_failure_recovery_bit_exact():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        r1 = _runner(d1)
        r1.init_state(1)
        r1.run(12)
        r2 = _runner(d2, failure_plan=FailurePlan(fail_at=[8]))
        r2.init_state(1)
        ids = [id(p) for p in r2.state["params"].parameters()]
        out = r2.run(12)
        assert (out["final_step"], out["recoveries"]) == (12, 1)
        assert [id(p) for p in r2.state["params"].parameters()] == ids
        for (n, a), (_, b) in zip(r1.state["params"].named_parameters(),
                                  r2.state["params"].named_parameters()):
            assert torch.equal(a, b), n
        for k, v in r1.state["opt"]["mu"].items():
            assert torch.equal(v, r2.state["opt"]["mu"][k]), k


def test_runner_straggler_watchdog():
    """Step 7 is delayed by ten times the median of the steps before it
    (at least 2 s): far over the watchdog's 3x, whatever the machine's
    load makes an ordinary step cost."""
    import statistics
    with tempfile.TemporaryDirectory() as d:
        r = _runner(d, delay_injector=lambda step: max(
            2.0, 10 * statistics.median(r.watchdog.times))
            if step == 7 else 0.0)
        r.init_state(1)
        out = r.run(10)
        assert 7 in out["stragglers"]


def test_runner_restore_latest_into_a_fresh_runner():
    with tempfile.TemporaryDirectory() as d:
        r = _runner(d)
        r.init_state(1)
        r.run(5)                    # checkpoint at step 5
        fresh = _runner(d)
        assert fresh.restore_latest() and fresh.step == 5
        for (n, a), (_, b) in zip(r.state["params"].named_parameters(),
                                  fresh.state["params"].named_parameters()):
            assert torch.equal(a, b), n


def test_runner_losses_match_reference_runner():
    """The port's and the reference's ``Runner`` from one crossed state
    at f32 (the reference's, block weights rescaled), 5 steps on the same
    pipeline: every step's loss within 1e-4."""
    jcfg, tcfg = _cfgs(LLAMA, "float32")
    kw = dict(attn_q_block=16, attn_kv_block=16, checkpoint_every=5,
              total_steps=40, warmup_steps=5, learning_rate=1e-2)
    jrcfg, trcfg = JRunConfig(**kw), RunConfig(**kw)
    state = _ref_state(jcfg, tcfg, jrcfg)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jr = JRunner(jcfg, jrcfg, make_host_mesh(1, 1),
                     j_for_model(jcfg, JShape("tiny", 32, 8, "train")), d1)
        jr.init_state(jax.random.PRNGKey(1))
        jr.state = jax.device_put(jax.tree.map(jnp.asarray, state),
                                  jr.state_sh)
        jr.run(5)
        tr = Runner(tcfg, trcfg, None, for_model(tcfg, SHAPE, device="cpu"),
                    d2, device="cpu")
        tr.init_state(model=params_from_jax(state["params"], tcfg,
                                            device="cpu"))
        tr.run(5)
    for a, b in zip(tr.metrics_log, jr.metrics_log):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_train_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s train phase on the CPU at llama's smoke config
    (S 32, a gloo world of one): parity of the two paths at bf16 and f32,
    the Runner's launches (the plain kernel wrapped to count them), every
    parameter moved, the world-1 compressed pod sync's ledger (one psum
    per leaf, the gradients' bytes), and bit-identical recovery."""
    import importlib.util
    import pathlib

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "TRAIN_MIN_DISK", 1e6)
    real = attention.flash_attention

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    launches = cs.phase_train(torch, torch.device("cpu"), CFG, "cpu",
                              backend="gloo")
    assert not dist.is_initialized()
    by = {r["check"]: r for r in rows}
    assert launches == CFG.num_layers * cs.TRAIN_ACCUM * 2 * cs.TRAIN_TIMED
    assert by["parity_bf16"]["wq_wk_wv_grads"] == 3 * CFG.num_layers
    assert by["runner"]["params_moved"] == by["runner"]["params_total"]
    assert by["pod_sync"]["ledger_pod_psums"] == [
        (by["pod_sync"]["grad_leaves"], by["pod_sync"]["grad_bytes"])]
    ft = by["fault_tolerance"]
    assert ft["bit_identical"] and [r["recoveries"] for r in ft["runs"]] \
        == [0, 1]


def test_family_train_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ssm, hybrid and encdec trainers on the CPU at the
    smoke configs (mamba2 and hymba over 40 tokens, whisper over 20 and
    its 24 frames; global batch 4, ``grad_accum`` 4), the plain kernels
    wrapped to count launches: both parity checks, the launches of the 2
    Runner steps (flash and the SSD scan twice per layer and micro-batch
    under remat, whisper's encoder and cross-attention included), every
    parameter moved, and mamba2's bit-identical recovery."""
    import importlib.util
    import pathlib

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import attention, ssm
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "TRAIN_MIN_DISK", 1e6)
    monkeypatch.setattr(cs, "FAMILY_TRAINERS", tuple(
        (arch, seq, 4) for arch, seq in FAMILY_SEQ.items()))
    monkeypatch.setattr(cs, "FAMILY_FT_ARCH", "mamba2-370m-smoke")
    for mod, name, counter in ((attention, "flash_attention",
                                fa.flash_attention),
                               (ssm, "ssd_chunk_scan", ss.ssd_chunk_scan)):
        real = getattr(mod, name)

        def counted(*args, _real=real, _counter=counter, **kw):
            _counter.launches += 1
            if _counter is fa.flash_attention:    # and by route, as on
                q = args[0]                       # the card
                _counter.launches_by_route[fa.route(q.dtype,
                                                    q.shape[-1])] += 1
            else:
                x, b = args[0], args[2]
                _counter.launches_by_route[ss.route(
                    x.dtype, x.shape[-1], b.shape[-1])] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    launches = cs.phase_train_families(
        torch, torch.device("cpu"), "cpu",
        cfgs={arch: get_smoke_config(arch) for arch in FAMILY_SEQ})
    per_step = 4 * 2 * 2          # micro-batches x (forward + remat) x steps
    # the smoke configs' head dim 16 takes no tensor-core route of flash;
    # their SSD widths (P 16, N 16) at bf16 take the SSD scan's "heads"
    assert launches == {"flash_attention": (2 + 6) * per_step,
                        "ssd_chunk_scan": (2 + 2) * per_step,
                        "flash_attention_tf32x3": 0,
                        "ssd_chunk_scan_heads": (2 + 2) * per_step}
    for r in rows:
        if r["check"] == "runner":
            assert r["flash_launches_by_route"] == \
                r["flash_launches_by_route_want"]
            assert r["ssd_launches_by_route"] == \
                r["ssd_launches_by_route_want"]
    runners = [r for r in rows if r["check"] == "runner"]
    assert [r["model"] for r in runners] == [
        get_smoke_config(a).name for a in FAMILY_SEQ]
    for r in runners:
        assert r["params_moved"] == r["params_total"], r["params_not_moved"]
    assert [r["check"] for r in rows].count("fault_tolerance") == 1
    assert all(r["bit_identical"] for r in rows
               if r["check"] == "fault_tolerance")
