"""The port's attention and SSD-scan kernels against the reference's Pallas
kernels.

On the CPU every kernel wrapper runs its plain PyTorch version (a CUDA
kernel has no interpret mode); the reference's Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them. Inputs are made
once with numpy from a seed and handed to both packages. The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: f32 2e-4 (summation order only), bf16 2e-2 (the two packages
round bf16 at different points: the reference's Pallas kernel rounds p per
kv block, the plain version once over the full row; the SSD scan's y
comes out in bf16 at bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (
    SPLIT_ALIGN, decode_attention, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.quant_comm import (
    codec_error_bound, dequantize_int8, dequantize_int8_plain, quantize_int8,
    quantize_int8_plain)
from repro_torch.kernels.ssd_scan import (
    segsum, ssd_chunk_scan, ssd_chunk_scan_plain)
from repro_torch.models import attention as tattn
from _torch_threads import one_thread  # noqa: F401

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """The same array in both frameworks (bf16 rounds identically)."""
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,causal,window,dtype", [
    ((2, 4, 256, 64), True, 0, "float32"),
    ((1, 2, 200, 128), True, 64, "float32"),
    ((2, 2, 128, 64), False, 0, "float32"),
    ((1, 3, 160, 64), True, 32, "bfloat16"),
    # head dim 192: nemotron-4-340b's, and DeepSeek-V2's MLA prefill
    ((1, 2, 96, 192), True, 0, "float32"),
    ((1, 2, 80, 192), True, 0, "bfloat16"),
])
def test_flash_plain_matches_pallas_and_ref(shape, causal, window, dtype):
    q, k, v = (_rand(i, *shape) for i in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    pallas = _np(jops.mha_forward(jq, jk, jv, causal=causal, window=window,
                                  impl="pallas", q_block=64, kv_block=64))
    j_ref = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window))
    t_kernel = tops.mha_forward(tq, tk, tv, causal=causal, window=window,
                                impl="kernel")
    t_ref = tops.mha_forward(tq, tk, tv, causal=causal, window=window,
                             impl="ref")
    assert t_kernel.dtype == tq.dtype and t_kernel.shape == tq.shape
    tol = TOL[dtype]
    for got in (t_kernel, t_ref):
        np.testing.assert_allclose(_np(got), pallas, rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(got), j_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,causal,window,dtype", [
    (100, True, 0, "float32"),
    (128, True, 48, "float32"),
    (96, False, 0, "float32"),
    (80, True, 0, "bfloat16"),
])
def test_flash_gqa_matches_reference_attention(s, causal, window, dtype):
    """Grouped (HQ=4, KV=2) layouts straight from the model, against the
    reference's blockwise and naive attention with their kv_map."""
    b, hq, kv, d = 2, 4, 2, 16
    q, k, v = _rand(10, b, s, hq, d), _rand(11, b, s, kv, d), \
        _rand(12, b, s, kv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    jmap = jattn.q_to_kv_map(hq, hq, kv)
    want = _np(jattn.naive_attention(jq, jk, jv, kv_map=jmap, causal=causal,
                                     window=window))
    want_bw = _np(jattn.blockwise_attention(
        jq, jk, jv, kv_map=jmap, causal=causal, window=window, q_block=32,
        kv_block=32))
    tmap = tattn.q_to_kv_map(hq, hq, kv)
    got = {
        "flash": flash_attention(tq, tk, tv, causal=causal, window=window),
        "blockwise": tattn.blockwise_attention(
            tq, tk, tv, kv_map=tmap, causal=causal, window=window,
            q_block=32, kv_block=32),
        "naive": tattn.naive_attention(tq, tk, tv, kv_map=tmap,
                                       causal=causal, window=window),
    }
    tol = TOL[dtype]
    for name, o in got.items():
        assert o.shape == (b, s, hq, d), name
        np.testing.assert_allclose(_np(o), want, rtol=tol, atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(_np(o), want_bw, rtol=tol, atol=tol,
                                   err_msg=name)


def test_flash_q_offset_continues_a_prefill():
    """A second chunk of queries at q_offset attends to the whole prefix:
    its rows equal the matching rows of the one-shot prefill."""
    b, s, hq, kv, d = 1, 48, 4, 2, 16
    q, k, v = (torch.from_numpy(_rand(20 + i, b, s, h, d))
               for i, h in enumerate((hq, kv, kv)))
    full = flash_attention(q, k, v)
    tail = flash_attention(q[:, 32:].contiguous(), k, v, q_offset=32)
    torch.testing.assert_close(tail, full[:, 32:], rtol=2e-6, atol=2e-6)


def test_flash_routes_follow_dtype_and_head_dim():
    """The kernel each (dtype, head dim) takes on the card, as
    ``csrc/flash_attention.cu::dispatch_d`` has it; the plain version on
    the CPU counts no launch on any route."""
    from repro_torch.kernels.flash_attention import ROUTES, route
    assert ROUTES == ("wgmma", "tf32x3", "simt")
    want = {(torch.bfloat16, 16): "simt", (torch.bfloat16, 32): "simt",
            (torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
            (torch.bfloat16, 192): "wgmma", (torch.float32, 16): "simt",
            (torch.float32, 32): "simt", (torch.float32, 64): "tf32x3",
            (torch.float32, 128): "tf32x3", (torch.float32, 192): "simt"}
    assert {k: route(*k) for k in want} == want
    q, k, v = (torch.from_numpy(_rand(i, 1, 8, 2, 64)) for i in range(3))
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_route))
    flash_attention(q, k, v)
    assert (flash_attention.launches,
            flash_attention.launches_by_route) == before


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,kv_block", [(300, 128), (512, 512), (64, 32)])
def test_decode_plain_matches_pallas_and_ref(t, kv_block):
    b, h, d = 3, 8, 64
    q, k, v = _rand(30, b, h, d), _rand(31, b, t, h, d), _rand(32, b, t, h, d)
    pos = np.array([0, t // 2, t - 1], np.int32)
    jo, jm, jl = jops.decode_step_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        impl="pallas", kv_block=kv_block)
    ro, rm, rl = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(pos))
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, k, v, pos))
    for impl in ("kernel", "ref"):
        o, m, l = tops.decode_step_attention(tq, tk, tv, tpos, impl=impl)
        for want_o, want_m, want_l in ((jo, jm, jl), (ro, rm, rl)):
            np.testing.assert_allclose(_np(o), _np(want_o), rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(_np(m), _np(want_m), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(_np(l), _np(want_l), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("q_dtype,kv_dtype,d,want", [
    (torch.bfloat16, torch.bfloat16, 64, "mma"),
    (torch.bfloat16, torch.bfloat16, 128, "mma"),
    (torch.bfloat16, torch.bfloat16, 192, "mma"),
    (torch.bfloat16, torch.bfloat16, 16, "simt"),
    (torch.bfloat16, torch.bfloat16, 32, "simt"),
    (torch.float32, torch.bfloat16, 128, "simt"),
    (torch.float32, torch.float32, 64, "simt"),
    (torch.float32, torch.float32, 192, "simt"),
])
def test_decode_routes_follow_dtypes_and_head_dim(q_dtype, kv_dtype, d,
                                                  want):
    """The kernel each (q dtype, cache dtype, head dim) takes on the card,
    as ``csrc/decode_attention.cu::launch`` picks it; the plain version on
    the CPU counts no launch on any route."""
    from repro_torch.kernels.decode_attention import ROUTES, route
    assert ROUTES == ("mma", "simt")
    assert route(q_dtype, kv_dtype, d) == want
    q = torch.from_numpy(_rand(33, 2, 4, d)).to(q_dtype)
    k, v = (torch.from_numpy(_rand(34 + i, 2, 8, 2, d)).to(kv_dtype)
            for i in range(2))
    before = (decode_attention.launches,
              dict(decode_attention.launches_by_route))
    decode_attention(q, k, v, torch.tensor([3, 7], dtype=torch.int32))
    assert (decode_attention.launches,
            decode_attention.launches_by_route) == before


@pytest.mark.parametrize("q_dtype,kv_dtype,pos", [
    ("float32", "float32", (0, 37, 99)),
    ("float32", "bfloat16", (99, 1, 50)),
    ("bfloat16", "bfloat16", (0, 64, 99)),
])
def test_decode_plain_at_group_12_d192_matches_pallas_and_ref(
        q_dtype, kv_dtype, pos):
    """nemotron-4-340b's decode shape: 24 query heads over 2 kv heads
    (group 12) at head dim 192. The plain version reads the grouped cache;
    the Pallas kernel (interpret mode) and ``ref.decode_attention_ref``
    take it expanded over each group's query heads. o within ``TOL`` of
    the working type (f32 2e-4 when q is f32), m within 1e-5 and l within
    1e-4 (both f32)."""
    b, hq, kv, t, d = 3, 24, 2, 100, 192
    q = _rand(33, b, hq, d)
    k, v = _rand(34, b, t, kv, d), _rand(35, b, t, kv, d)
    (jq, tq) = _both(q, q_dtype)
    (jk, tk), (jv, tv) = _both(k, kv_dtype), _both(v, kv_dtype)
    pos = np.array(pos, np.int32)
    tpos = torch.from_numpy(pos)
    o, m, l = decode_attention_plain(tq, tk, tv, tpos)
    assert o.dtype == tq.dtype and o.shape == (b, hq, d)
    jk, jv = (jnp.repeat(x.astype(jq.dtype), hq // kv, axis=2)
              for x in (jk, jv))
    tol = TOL[q_dtype]
    for impl in ("pallas", "ref"):
        wo, wm, wl = jops.decode_step_attention(jq, jk, jv, jnp.asarray(pos),
                                                impl=impl, kv_block=64)
        np.testing.assert_allclose(_np(o), _np(wo), rtol=tol, atol=tol,
                                   err_msg=impl)
        np.testing.assert_allclose(_np(m), _np(wm), rtol=1e-5, atol=1e-5,
                                   err_msg=impl)
        np.testing.assert_allclose(_np(l), _np(wl), rtol=1e-4, atol=1e-4,
                                   err_msg=impl)
    assert torch.equal(decode_attention(tq, tk, tv, tpos)[0], o)


def test_decode_lse_combine_across_shards():
    """Partials over two halves of a cache combine to the unsharded result
    (the context-parallel decode contract), and match the reference."""
    b, h, t, d = 2, 4, 256, 32
    q, k, v = _rand(40, b, h, d), _rand(41, b, t, h, d), _rand(42, b, t, h, d)
    pos = np.array([200, 255], np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, k, v, pos))
    o_full, _, _ = decode_attention(tq, tk, tv, tpos)
    half = t // 2
    o0, m0, l0 = decode_attention(tq, tk[:, :half].contiguous(),
                                  tv[:, :half].contiguous(), tpos)
    o1, m1, l1 = decode_attention(tq, tk[:, half:].contiguous(),
                                  tv[:, half:].contiguous(), tpos - half)
    m = torch.maximum(m0, m1)
    w0 = torch.exp(m0 - m) * l0
    w1 = torch.exp(m1 - m) * l1
    o = (o0 * w0[..., None] + o1 * w1[..., None]) / (w0 + w1)[..., None]
    torch.testing.assert_close(o, o_full, rtol=1e-5, atol=1e-5)
    want, _, _ = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(pos))
    np.testing.assert_allclose(_np(o), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,dtype", [(0, "float32"), (24, "float32"),
                                          (0, "bfloat16")])
def test_grouped_decode_matches_reference_decode_attention(window, dtype):
    """The kernel's grouped (B, T, KV, d) cache read, against the model
    decode of the reference (``models/attention.py::decode_attention``)."""
    b, hq, kv, t, d = 3, 6, 2, 40, 16
    q, k, v = _rand(50, b, 1, hq, d), _rand(51, b, t, kv, d), \
        _rand(52, b, t, kv, d)
    pos = np.array([0, 17, 39], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = _np(jattn.decode_attention(
        jq, jk, jv, jnp.asarray(pos), kv_map=jattn.q_to_kv_map(hq, hq, kv),
        window=window, n_real_heads=hq))
    tpos = torch.from_numpy(pos)
    o, _, _ = decode_attention(tq[:, 0].contiguous(), tk, tv, tpos,
                               window=window)
    port_model = tattn.decode_attention(
        tq, tk, tv, tpos, kv_map=tattn.q_to_kv_map(hq, hq, kv),
        window=window, n_real_heads=hq)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o)[:, None], want, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(port_model), want, rtol=tol, atol=tol)


def test_decode_live_prefix_and_empty_rows():
    """kv_len cuts the live prefix; a sequence with nothing live gets
    m = NEG_INF, l = 0, o = 0 (no NaN from the finite mask)."""
    b, hq, kv, t, d = 2, 4, 2, 32, 64
    q = torch.from_numpy(_rand(60, b, hq, d))
    k = torch.from_numpy(_rand(61, b, t, kv, d))
    v = torch.from_numpy(_rand(62, b, t, kv, d))
    pos = torch.tensor([31, 5], dtype=torch.int32)
    o, m, l = decode_attention(q, k, v, pos, kv_len=10)
    o2, m2, l2 = decode_attention(q, k[:, :10].contiguous(),
                                  v[:, :10].contiguous(), pos)
    torch.testing.assert_close((o, m, l), (o2, m2, l2))
    o, m, l = decode_attention_plain(q, k, v, pos, window=3, kv_len=2)
    assert torch.isfinite(o).all()
    assert (l[0] == 0).all() and (o[0] == 0).all() and (m[0] == -2.0e30).all()


@pytest.mark.parametrize("b,kv,kv_len,sms", [
    (8, 8, 1024, 132), (1, 8, 1024, 132), (64, 8, 4096, 132),
    (2, 2, 17, 132), (8, 8, 64, 132), (1, 1, 100000, 132)])
def test_decode_split_plan_covers_the_cache(b, kv, kv_len, sms):
    """The kernel's sequence chunks tile [0, kv_len) with no empty chunk,
    each a whole number of the kernel's passes, and split only as far as
    two blocks per SM need."""
    nsplit, chunk = split_plan(b, kv, kv_len, sms)
    assert nsplit >= 1 and chunk % SPLIT_ALIGN == 0
    assert (nsplit - 1) * chunk < kv_len <= nsplit * chunk
    assert nsplit == 1 or b * kv * (nsplit - 1) < 2 * sms


@pytest.mark.parametrize("b,kv,kv_len,want", [
    (8, 8, 1024, (4, 256)),     # the serving step: 256 blocks, 2 an SM
    (1, 8, 1024, (16, 64)),     # one sequence: every 64-position chunk
    (32, 8, 1024, (2, 512)),
    (4, 8, 16, (1, 64)),        # the replay phase's 16-position cache
])
def test_decode_split_plan_at_the_serving_shapes(b, kv, kv_len, want):
    """The runs the kernel was measured with on the H100 (132 SMs): at the
    serving step's B 8 x 8 kv heads, four runs of 256 positions."""
    assert split_plan(b, kv, kv_len, 132) == want


# ---------------------------------------------------------------------------
# SSD intra-chunk scan
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, nb, nc, q, h, p, n, *, da_scale=0.1):
    """The reference kernel test's inputs (tests/test_kernels.py:70), made
    with numpy: x*dt, dA <= 0, B and C."""
    return (_rand(seed, nb, nc, q, h, p) * 0.1,
            -np.abs(_rand(seed + 1, nb, nc, q, h)) * da_scale,
            _rand(seed + 2, nb, nc, q, n) * 0.3,
            _rand(seed + 3, nb, nc, q, n) * 0.3)


def _assert_ssd(got, want, tol, what=""):
    for name, a, b, t in zip(("y", "states", "decay"), got, want,
                             (tol, tol, min(tol, 1e-5))):
        assert np.isfinite(_np(a)).all(), (what, name)
        np.testing.assert_allclose(_np(a), _np(b), rtol=t, atol=t,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("h,dtype", [(16, "float32"), (8, "float32"),
                                     (32, "float32"), (16, "bfloat16")])
def test_ssd_plain_matches_pallas_and_ref(h, dtype):
    """At the reference kernel test's shapes (nb 2, nc 3, Q 64, P 32,
    N 64): the plain version and ``ops.ssd_intra_chunk`` (both impls)
    against the Pallas kernel in interpret mode and the reference's
    oracle; 2e-4 at f32 (1e-5 on decay, the reference's own bounds),
    2e-2 at bf16."""
    arrays = _ssd_inputs(70, 2, 3, 64, h, 32, 64)
    xdt, da, b, c = arrays
    jx, tx = _both(xdt, dtype)
    (jd, td), (jb, tb), (jc, tc) = (_both(a, "float32") if i == 0
                                    else _both(a, dtype)
                                    for i, a in enumerate((da, b, c)))
    pallas = jops.ssd_intra_chunk(jx, jd, jb, jc, impl="pallas",
                                  head_block=8)
    j_ref = jops.ssd_intra_chunk(jx, jd, jb, jc, impl="ref")
    got = {"plain": ssd_chunk_scan_plain(tx, td, tb, tc),
           "kernel": tops.ssd_intra_chunk(tx, td, tb, tc, impl="kernel"),
           "ref": tops.ssd_intra_chunk(tx, td, tb, tc, impl="ref")}
    for name, out in got.items():
        assert out[0].dtype == tx.dtype and out[1].dtype == torch.float32
        assert tuple(out[1].shape) == (2, 3, h, 32, 64)
        assert tuple(out[2].shape) == (2, 3, h)
        for want in (pallas, j_ref):
            _assert_ssd(out, want, TOL[dtype], name)


@pytest.mark.parametrize("h,q,p,n", [(50, 64, 16, 16), (50, 128, 64, 16),
                                     (3, 40, 8, 24)])
def test_ssd_plain_any_head_count_matches_ref(h, q, p, n):
    """Any H, including hymba's 50 (not a multiple of the Pallas default
    head block of 8, which the Pallas kernel cannot take), and a ragged
    chunk: against the reference's oracle at f32 within 2e-4."""
    xdt, da, b, c = _ssd_inputs(80 + h, 1, 2, q, h, p, n)
    want = jops.ssd_intra_chunk(*(jnp.asarray(a) for a in (xdt, da, b, c)),
                                impl="ref")
    got = ssd_chunk_scan(*(torch.from_numpy(a) for a in (xdt, da, b, c)))
    _assert_ssd(got, want, 2e-4, f"H={h}")
    t_ref = tref.ssd_chunk_ref(*(torch.from_numpy(a[0, 1])
                                 for a in (xdt, da, b, c)))
    _assert_ssd(t_ref, [w[0, 1] for w in want], 2e-4, "ssd_chunk_ref")


def test_ssd_decay_difference_survives_full_width_cumsums():
    """dt ~ 0.7 over a 256-token chunk drives cs to about -180: the decay
    exp(cs[l] - cs[s]) taken from the difference and masked before the
    exponential stays finite (exp(cs) underflows to 0, exp(-cs) would
    overflow to inf); the chunk decay underflows to exactly 0."""
    q = 256
    xdt, _, b, c = _ssd_inputs(90, 1, 1, q, 4, 16, 16)
    da = np.full((1, 1, q, 4), -0.7, np.float32)
    tx, td, tb, tc = (torch.from_numpy(a) for a in (xdt, da, b, c))
    y, st, dec = ssd_chunk_scan_plain(tx, td, tb, tc)
    cs = np.cumsum(da[0, 0, :, 0].astype(np.float64))
    assert cs[-1] < -170
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert (dec == 0).all()
    want = jops.ssd_intra_chunk(*(jnp.asarray(a) for a in (xdt, da, b, c)),
                                impl="ref")
    _assert_ssd((y, st, dec), want, 2e-4)
    L = torch.exp(segsum(td[0, 0].T))          # (H, Q, Q)
    assert torch.isfinite(L).all() and (L.triu(1) == 0).all()


def test_ssd_padded_chunk_leaves_state_and_decay_as_the_prefix():
    """Zero x*dt and zero dA past a chunk's real rows (how ``ssd_chunked``
    pads the last chunk) leave y on the real rows, the state and the decay
    as the unpadded prefix gives them (1e-6: only the sums' blocking
    differs)."""
    q_real, q = 44, 64
    xdt, da, b, c = _ssd_inputs(95, 1, 1, q, 6, 16, 32)
    xdt[:, :, q_real:] = 0.0
    da[:, :, q_real:] = 0.0
    full = ssd_chunk_scan_plain(*(torch.from_numpy(a)
                                  for a in (xdt, da, b, c)))
    prefix = ssd_chunk_scan_plain(*(torch.from_numpy(
        np.ascontiguousarray(a[:, :, :q_real])) for a in (xdt, da, b, c)))
    torch.testing.assert_close(full[0][:, :, :q_real], prefix[0],
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(full[1], prefix[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(full[2], prefix[2], rtol=0, atol=0)


@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 128, "wg"),       # mamba2-370m, on wgmma
    (torch.bfloat16, 64, 16, "heads"),     # hymba-1.5b
    (torch.bfloat16, 32, 64, "heads"),     # the reference's kernel test
    (torch.bfloat16, 16, 16, "heads"),     # the smoke configs
    (torch.bfloat16, 32, 32, "simt"),      # any other width
    (torch.float32, 64, 128, "simt"),
    (torch.float32, 64, 16, "simt"),
    (torch.float32, 32, 64, "simt"),
    (torch.float32, 16, 16, "simt"),
])
def test_ssd_routes_follow_dtype_and_widths(dtype, p, n, want):
    """The kernel each (dtype, P, N) takes on the card, as
    ``csrc/ssd_scan.cu::nk_ssd_chunk_scan`` has it; the plain version on
    the CPU counts no launch on any route."""
    from repro_torch.kernels.ssd_scan import ROUTES, route
    assert ROUTES == ("wg", "heads", "simt")
    assert route(dtype, p, n) == want
    xdt, da, b, c = (torch.from_numpy(a)
                     for a in _ssd_inputs(97, 1, 1, 16, 2, p, n))
    before = (ssd_chunk_scan.launches,
              dict(ssd_chunk_scan.launches_by_route))
    ssd_chunk_scan(xdt.to(dtype), da, b.to(dtype), c.to(dtype))
    assert (ssd_chunk_scan.launches,
            ssd_chunk_scan.launches_by_route) == before


@pytest.mark.parametrize("q,da_scale,x64", [(64, 0.1, False),
                                             (256, 1.0, True)])
def test_ssd_plain_state_decay_matches_reference_cumsum(q, da_scale, x64):
    """The plain scan's fourth output, ``state_decay = exp(cumsum(dA))``
    (f64, rounded once), against the reference model's own expression
    (``repro/models/ssm.py::ssd_chunked``'s ``jnp.exp(A_cum)``): at the
    reference kernel test's scale in f32 as the model runs it, and at
    full-width cumsums (about -180, where f32 values reach the subnormal
    range) in f64, rounded once; 1e-6 relative."""
    xdt, da, b, c = _ssd_inputs(98, 2, 3, q, 8, 16, 32, da_scale=da_scale)
    out = ssd_chunk_scan_plain(*(torch.from_numpy(a)
                                 for a in (xdt, da, b, c)),
                               state_decay=True)
    assert len(out) == 4 and tuple(out[3].shape) == (2, 3, q, 8)
    assert out[3].dtype == torch.float32
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        want = np.asarray(jnp.exp(jnp.cumsum(jnp.asarray(da, dtype=dtype),
                                             axis=2))).astype(np.float32)
    np.testing.assert_allclose(_np(out[3]), want, rtol=1e-6, atol=0)
    # the three-output call is the reference-shaped one, unchanged
    three = ssd_chunk_scan_plain(*(torch.from_numpy(a)
                                   for a in (xdt, da, b, c)))
    assert len(three) == 3
    for a, b_ in zip(three, out):
        assert torch.equal(a, b_)


def test_ssd_plain_computes_in_f32_from_bf16_operands():
    """bf16 operands are widened and everything runs in f32, as in the
    Pallas kernel: bf16 inputs give exactly what their f32 widening gives.
    ``out_dtype`` sets y's dtype alone."""
    xdt, da, b, c = _ssd_inputs(97, 1, 2, 32, 4, 16, 16)
    tx, td, tb, tc = (torch.from_numpy(a) for a in (xdt, da, b, c))
    bx, bb, bc = (t.to(torch.bfloat16) for t in (tx, tb, tc))
    y16, st16, dec16 = ssd_chunk_scan_plain(bx, td, bb, bc,
                                            out_dtype=torch.float32)
    y32, st32, dec32 = ssd_chunk_scan_plain(bx.float(), td, bb.float(),
                                            bc.float())
    assert y16.dtype == st16.dtype == torch.float32
    torch.testing.assert_close((y16, st16, dec16), (y32, st32, dec32),
                               rtol=0, atol=0)
    y_bf16 = ssd_chunk_scan_plain(bx, td, bb, bc)[0]
    assert y_bf16.dtype == torch.bfloat16
    assert torch.equal(y_bf16, y32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# int8 codec (blockwise quantize / dequantize)
# ---------------------------------------------------------------------------


def _codec_input(seed, r, c):
    """Rows scaled from 1e-2 to 1e2 (the regime where a scale off by one
    bit moves codes), plus a block of zeros and one of exact ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c))
         * np.exp(rng.uniform(np.log(0.01), np.log(100.0), (r, 1))))
    x = x.astype(np.float32)
    x[0, :256] = 0.0
    if r > 1:
        # absmax 127 * 2^-3 makes the scale 2^-3 exactly: (k + 0.5) * scale
        # is then a tie that only round-half-to-even resolves as XLA does
        x[1, :256] = 0.0
        x[1, :128] = (np.arange(-64, 64) + 0.5) * 0.125
        x[1, 0] = 127 * 0.125
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("r,c", [(1, 256), (3, 512), (257, 1024),
                                 (300, 768)])
def test_codec_plain_equals_reference_bit_for_bit(dtype, block, r, c):
    """The plain codec against the reference's oracle and its Pallas
    kernel in interpret mode (both jitted, as ``ops.quantize`` runs them):
    codes and scales equal to the bit (rtol 0), and dequantize into f32
    and bf16 equal to the bit; ``ops.quantize(impl="kernel")`` on CPU
    tensors is the plain version."""
    x = _codec_input(r * 7 + c, r, c)
    jx, tx = _both(x, dtype)
    q_t, s_t = tops.quantize(tx, block=block)
    q_p, s_p = quantize_int8_plain(tx, block=block)
    assert torch.equal(q_t, q_p) and torch.equal(s_t, s_p)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == (r, c // block)
    q_r, s_r = tops.quantize(tx, block=block, impl="ref")
    assert torch.equal(q_r, q_t) and torch.equal(s_r, s_t)
    for impl in ("ref", "pallas"):
        jq, js = jops.quantize(jx, block=block, impl=impl)
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(js))
        for out in ("float32", "bfloat16"):
            jd = jops.dequantize(jq, js, block=block, impl=impl,
                                 dtype=getattr(jnp, out))
            td = tops.dequantize(q_t, s_t, block=block,
                                 dtype=getattr(torch, out))
            assert td.dtype == getattr(torch, out)
            np.testing.assert_array_equal(_np(td), _np(jd))
    # a zero block: scale float32(1e-30) * float32(1/127), codes 0
    assert s_t[0, 0].item() == np.float32(1e-30) * np.float32(1 / 127)
    assert not q_t[0, :256].any()
    if r > 1:                       # the ties rounded half to even
        assert s_t[1, 0].item() == 0.125
        assert q_t[1, 1:128].tolist() == [
            int(v) for v in np.round(np.arange(-63, 64) + 0.5)]


def test_codec_scale_is_a_reciprocal_multiply():
    """Pins the scale's bits: ``absmax * float32(1/127)``, which the
    reference computes under jit; a true division by 127 differs in the
    last bit for some absmax, and then codes move too."""
    absmax = np.abs(_rand(3, 4096)) * 10.0
    mul = absmax * np.float32(1.0 / 127.0)
    div = absmax / np.float32(127.0)
    assert (mul != div).any()
    x = np.zeros((4096, 128), np.float32)
    x[:, 0] = absmax
    _, s = quantize_int8_plain(torch.from_numpy(x), block=128)
    np.testing.assert_array_equal(s[:, 0].numpy(), mul)
    _, js = jops.quantize(jnp.asarray(x), block=128, impl="ref")
    np.testing.assert_array_equal(np.asarray(js)[:, 0], mul)


@given(r=st.integers(1, 64), cb=st.integers(1, 8),
       scale=st.floats(0.01, 100.0), block=st.sampled_from([128, 256]),
       out=st.sampled_from(["float32", "bfloat16"]))
@settings(max_examples=40, deadline=None)
def test_codec_round_trip_within_its_stated_bound(r, cb, scale, block, out):
    """The port's own bound (``codec_error_bound``), over the reference's
    property ranges (rows 1-64, 1-8 blocks, scales 0.01-100): the error
    of one round trip is at most half a scale step, plus the f32 roundings
    of ``x / scale`` and ``q * scale`` (2^-24 of the block's absmax and
    2^-22 of |x_hat|), plus half a bf16 ulp (2^-8 |x_hat|) into bf16."""
    x = torch.from_numpy(_rand(r * 1000 + cb, r, cb * block) * scale)
    q, s = quantize_int8(x, block=block)
    x_hat = dequantize_int8(q, s, block=block, dtype=getattr(torch, out))
    err = (x_hat.float() - x).abs()
    assert (err <= codec_error_bound(x, s, x_hat, block=block)).all()


def test_codec_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 384))
    for bad in (dict(block=256), dict(block=64)):
        with pytest.raises(ValueError, match="block"):
            quantize_int8(x, **bad)
    with pytest.raises(ValueError, match="block"):
        quantize_int8(torch.zeros(256))
    with pytest.raises(ValueError, match="block"):
        dequantize_int8_plain(torch.zeros((2, 100), dtype=torch.int8),
                              torch.zeros((2, 1)), block=128)
