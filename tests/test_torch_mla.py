"""The port's multi-head latent attention (DeepSeek-V2) against the
reference's, on the CPU.

``mla_attention`` of both packages on the same inputs, made from a seed
with numpy, with weights drawn with numpy at their true fan-in: the
deepseek smoke config (4 heads, latent 32, rope 8, nope 16, v 16) and
one at full head dims (nope 128, rope 64, v 128, latent 512) over 2 heads
and d 256. Prefill returns the output and the latent ``lat = concat(c_kv,
k_pe)``; decode writes the new latent row into the cache (in place in the
port) and attends in the absorbed form. Tolerances: f32 within 1e-5 of the
largest magnitude (output and latent), bf16 within 2e-2 (the reference
compiled with XLA's excess precision off, so both round where the source
casts); the decode cache's rows other than the written one stay bit for
bit, the written one within the same bounds. The prefill's attention
(``_mla_prefill``: q, k and v zero-padded to one head dim the flash kernel
takes, the output cut back) holds against the reference's
``blockwise_attention``, output and dq/dk/dv, within the same bounds.
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
from repro.configs.base import MLA_BY_NAME as J_MLA
from repro.distribution.sharding import ShardingCtx
from repro.models import attention as jattn
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import MLA_BY_NAME as T_MLA
from repro_torch.configs.base import MLAConfig
from repro_torch.models import attention as tattn
from repro_torch.models.model import cache_schema, init_cache
from repro_torch.models.params import to_torch
from repro_torch.models.schema import walk

from _torch_threads import one_thread  # noqa: F401

SOURCE_ROUNDING = {"xla_allow_excess_precision": False}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
WIDE = "mla-wide-test"       # full head dims over 2 heads (registered below)


@pytest.fixture(autouse=True)
def _wide_mla(monkeypatch):
    """A config name carrying deepseek's full head dims in both packages'
    MLA tables (configs attach MLA by name)."""
    wide = dict(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)
    monkeypatch.setitem(J_MLA, WIDE, type(J_MLA["deepseek-v2-236b"])(**wide))
    monkeypatch.setitem(T_MLA, WIDE, MLAConfig(**wide))


def _cfgs(which, dtype):
    jcfg, tcfg = j_smoke("deepseek-v2-236b"), get_smoke_config(
        "deepseek-v2-236b")
    kw = dict(dtype=dtype, param_dtype=dtype)
    if which == "wide":
        kw.update(name=WIDE, d_model=256, num_heads=2, num_kv_heads=2,
                  head_dim=128)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, desc in walk(tattn.mla_schema(cfg)):
        if desc.init == "ones":
            a = 1.0 + 0.3 * rng.standard_normal(desc.shape)
        else:
            a = rng.standard_normal(desc.shape) / np.sqrt(desc.init_fan_in)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(jnp.asarray(a, getattr(jnp, desc.dtype)))
    return out


def _gap(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jit(fn, dtype):
    return jax.jit(fn, compiler_options=SOURCE_ROUNDING
                   if dtype == "bfloat16" else None)


@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_mla_schema_matches_reference(which, mesh1):
    """Leaf by leaf, shape and dtype: 3-D wq/w_uk/w_uv/wo, the down
    projection w_dkv and the latent's rms norm."""
    jcfg, tcfg = _cfgs(which, "bfloat16")
    want = jattn.mla_schema(jcfg, mesh1)
    got = dict(walk(tattn.mla_schema(tcfg)))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: hasattr(x, "dims"))[0]
    assert len(flat) == len(got)
    for kp, desc in flat:
        path = tuple(k.key for k in kp)
        assert got[path].shape == tuple(desc.shape), path
        assert got[path].dtype == desc.dtype, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_mla_prefill_matches_reference(which, dtype, mesh1):
    """B 2 x 24 tokens (blocks of 8: 3 q blocks, a causal kv range each):
    the output (B, S, d) and the latent (B, S, r + rope) in x's dtype."""
    jcfg, tcfg = _cfgs(which, dtype)
    w = _weights(tcfg, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jr, tr = JRunConfig(attn_q_block=8, attn_kv_block=8), \
        RunConfig(attn_q_block=8, attn_kv_block=8)
    pos = np.arange(24)
    jo, jc = _jit(functools.partial(
        jattn.mla_attention, cfg=jcfg, shd=ShardingCtx(mesh1), rcfg=jr,
        positions=jnp.asarray(pos), return_cache=True), dtype)(
        jax.tree.map(jnp.asarray, w), jx)
    to, tc = tattn.mla_attention(jax.tree.map(to_torch, w),
                                 to_torch(np.asarray(jx)), tcfg, tr,
                                 positions=torch.from_numpy(pos),
                                 return_cache=True)
    assert to.dtype == tc["lat"].dtype == getattr(torch, dtype)
    r = tcfg.mla.kv_lora_rank + tcfg.mla.qk_rope_head_dim
    assert tuple(tc["lat"].shape) == (2, 24, r)
    assert _gap(to, jo) <= TOL[dtype]
    assert _gap(tc["lat"], jc["lat"]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_mla_decode_matches_reference(which, dtype, mesh1):
    """Three sequences at positions 0, 17 and 39 of a 40-slot bf16 latent
    cache (random rows, as left by earlier steps): the output, and the
    cache with the new row written at each position; every other row
    unchanged, bit for bit."""
    jcfg, tcfg = _cfgs(which, dtype)
    w = _weights(tcfg, seed=3)
    rng = np.random.default_rng(4)
    r = tcfg.mla.kv_lora_rank + tcfg.mla.qk_rope_head_dim
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    lat = np.array(jnp.asarray(rng.standard_normal((3, 40, r)),
                               jnp.bfloat16))
    pos = np.array([0, 17, 39], np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jo, jc = _jit(functools.partial(
        jattn.mla_attention, cfg=jcfg, shd=ShardingCtx(mesh1),
        rcfg=JRunConfig()), dtype)(
        jax.tree.map(jnp.asarray, w), jx, positions=jnp.asarray(pos),
        cache={"lat": jnp.asarray(lat)}, decode_pos=jnp.asarray(pos))
    cache = {"lat": to_torch(lat)}
    before = cache["lat"].clone()
    to, tc = tattn.mla_attention(jax.tree.map(to_torch, w),
                                 to_torch(np.asarray(jx)), tcfg,
                                 RunConfig(), positions=torch.from_numpy(pos),
                                 cache=cache, decode_pos=torch.from_numpy(pos))
    assert tc["lat"] is cache["lat"]                 # written in place
    assert tuple(to.shape) == (3, 1, tcfg.d_model)
    assert _gap(to, jo) <= TOL[dtype]
    want = to_torch(np.asarray(jc["lat"]))
    rows = torch.arange(3), torch.from_numpy(pos).long()
    keep = torch.ones(3, 40, dtype=torch.bool)
    keep[rows] = False
    assert torch.equal(tc["lat"][keep], want[keep])
    assert torch.equal(tc["lat"][keep], before[keep])
    assert _gap(tc["lat"][rows], np.asarray(jc["lat"])[
        np.arange(3), pos].astype(np.float32)) <= TOL[dtype]


def test_latent_cache_bytes_are_the_schema():
    """deepseek's cache is one latent row per position and layer: 8 slots
    of 1024 at full width hold 8 * 1024 * 576 * 2 bytes a layer, against
    128 heads x 128 dims of k and v a GQA cache of the same heads would
    hold (56.9 times as many bytes)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=3)
    sch = cache_schema(cfg, 8, 1024)
    assert [tuple(s["lat"].shape) for s in sch] == [(1, 8, 1024, 576),
                                                    (2, 8, 1024, 576)]
    per_layer = 8 * 1024 * 576 * 2
    kv = 2 * 8 * 1024 * cfg.num_heads * 128 * 2
    assert kv // per_layer == 56
    small = get_smoke_config("deepseek-v2-236b")
    caches = init_cache(small, 4, 64, device="cpu")
    assert sum(t.numel() * t.element_size() for seg in caches
               for t in seg.values()) == 3 * 4 * 64 * 40 * 2


# ---------------------------------------------------------------------------
# the prefill's attention through the flash kernel (``_mla_prefill``)
# ---------------------------------------------------------------------------


def _mla_qkv(which, dtype, seed):
    """q, k (B 2, S 24, H, dk) and v (B, S, H, dv) at a config's MLA head
    dims (smoke: dk 24, dv 16; wide: dk 192, dv 128), numpy from a seed."""
    _, tcfg = _cfgs(which, dtype)
    mla, h = tcfg.mla, tcfg.num_heads
    dk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, 24, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 24, h, mla.v_head_dim)).astype(np.float32)
    return [np.array(jnp.asarray(a, getattr(jnp, dtype))) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_mla_padded_prefill_matches_reference_attention(which, dtype,
                                                         mesh1):
    """``_mla_prefill`` (q, k and v zero-padded to a head dim the flash
    kernel takes, the output cut back to dv) against the reference's
    ``blockwise_attention`` with each head its own kv head at scale
    1/sqrt(dk), the attention the reference's MLA prefill runs: the
    output without grad (the kernel's wrapper: its plain version on the
    CPU), and under grad (``FlashAttentionFn``) the output and dq/dk/dv
    against ``jax.vjp`` of the reference, for one cotangent drawn from a
    seed. Within ``TOL`` of the largest magnitude (f32 1e-5: summation
    order; bf16 2e-2)."""
    q, k, v = _mla_qkv(which, dtype, seed=5)
    dk, dv, h = q.shape[-1], v.shape[-1], q.shape[2]
    scale = 1.0 / np.sqrt(dk)
    jdt = getattr(jnp, dtype)

    def ref(qq, kk, vv):
        return jattn.blockwise_attention(
            qq, kk, vv, kv_map=jnp.arange(h), causal=True, q_block=8,
            kv_block=8, softmax_scale=scale)

    jo, vjp = jax.vjp(ref, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    do = np.random.default_rng(6).standard_normal(jo.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(do, jdt))
    rcfg = RunConfig(attn_q_block=8, attn_kv_block=8)
    with torch.no_grad():
        to = tattn._mla_prefill(*(to_torch(a) for a in (q, k, v)), scale,
                                rcfg)
    assert tuple(to.shape) == (2, 24, h, dv) and to.dtype == getattr(
        torch, dtype)
    assert _gap(to, jo) <= TOL[dtype]
    tq, tk, tv = (to_torch(a).requires_grad_() for a in (q, k, v))
    og = tattn._mla_prefill(tq, tk, tv, scale, rcfg)
    assert og.grad_fn is not None
    og.backward(to_torch(np.array(jnp.asarray(do, jdt))))
    assert _gap(og, jo) <= TOL[dtype]
    for name, got, want in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        assert tuple(got.grad.shape) == tuple(want.shape), name
        assert _gap(got.grad, want) <= TOL[dtype], name


@pytest.mark.parametrize("which,want_d", [("smoke", 32), ("wide", 192)])
def test_mla_prefill_hands_the_kernel_one_head_dim(which, want_d,
                                                   monkeypatch):
    """The three-way choice and the padding: without grad the kernel's
    wrapper gets q, k and v at one head dim the kernel is built for (192
    at full width: only v pads, from 128; 32 for the smoke config's 24
    and 16), with the padded columns zero and the scale 1/sqrt(dk); under
    grad ``FlashAttentionFn`` runs it; under ``attention_impl="naive"`` the
    plain version does and the wrapper is not called."""
    calls = []
    real = tattn.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", recorded)
    q, k, v = (to_torch(a) for a in _mla_qkv(which, "float32", seed=7))
    dk, dv = q.shape[-1], v.shape[-1]
    with torch.no_grad():
        tattn._mla_prefill(q, k, v, 1.0 / np.sqrt(dk), RunConfig())
    (pq, pk, pv, kw), = calls
    assert {x.shape[-1] for x in (pq, pk, pv)} == {want_d}
    assert kw == {"causal": True, "scale": 1.0 / np.sqrt(dk)}
    assert not pq[..., dk:].any() and not pk[..., dk:].any()
    assert not pv[..., dv:].any() and torch.equal(pv[..., :dv], v)
    tattn._mla_prefill(q.requires_grad_(), k, v, 1.0 / np.sqrt(dk),
                       RunConfig())
    assert len(calls) == 2                # FlashAttentionFn's forward
    with torch.no_grad():
        tattn._mla_prefill(q, k, v, 1.0 / np.sqrt(dk),
                           RunConfig(attention_impl="naive"))
    assert len(calls) == 2
