"""The numerics of the f32 flash kernel's design, emulated on the CPU.

On the card, f32 flash at head dims 64 and 128 runs as three TF32
products on the tensor cores (``flash_fwd_tf32x3`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``): every f32 operand
goes in as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``), and a product is
a_hi b_hi + a_hi b_lo + a_lo b_hi summed in f32. Here that rounding is
emulated in torch (the low 13 mantissa bits rounded off the word, as the
instruction does), and an attention computed with the kernel's split, its
kv tiles and its online softmax is held against the JAX package's flash
oracle (``repro.kernels.ref.flash_attention_ref``) on the same seeded
numpy inputs within ``FLASH_TOL["float32"]`` (2e-4, as ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the kernel).

The same attention with one TF32 product (hi alone, as a plain TF32
matmul would take it) misses that tolerance. The largest errors of this
emulation on the CPU against the oracle, case by case (``CASES``), are
5.7e-7, 7.2e-7 and 7.7e-7 with three products and 3.9e-4, 1.4e-3 and
7.4e-4 with one (max |o| 0.88, 3.3 and 1.9); the test asserts both
sides.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from _torch_threads import one_thread  # noqa: F401

TOL = 2e-4                     # chip_smoke.FLASH_TOL["float32"]
NEG_INF = -2.0e30
LOG2E = 1.4426950408889634
BN = 32                        # the kernel's kv tile rows at D 64 and 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b on the tensor cores: three TF32 products summed in f32, or the
    first alone."""
    ah, al = split(a)
    bh, bl = split(b)
    if not three:
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def flash_tf32x3(q, k, v, *, causal, window=0, q_offset=0, three=True):
    """The kernel's function as it computes it: q (B, S, HQ, D), k and v
    (B, T, KV, D) f32; per kv tile of ``BN`` rows the scores by
    ``product``, scaled into the log2 domain and masked, the running max,
    p = exp2(s - m) summed unrounded into l, and O rescaled and added
    p @ V by ``product``; O / l at the end."""
    b, s, hq, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = hq // kv
    qh = q.permute(0, 2, 1, 3)                            # (B, HQ, S, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    qp = q_offset + torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), NEG_INF)
    l = torch.zeros((b, hq, s, 1))
    o = torch.zeros((b, hq, s, d))
    scale = LOG2E / math.sqrt(d)
    for k0 in range(0, t, BN):
        kt, vt = kh[:, :, k0:k0 + BN], vh[:, :, k0:k0 + BN]
        sc = product(qh, kt.transpose(-1, -2), three) * scale
        kp = k0 + torch.arange(kt.shape[2])[None, :]
        ok = torch.ones_like(sc[0, 0], dtype=torch.bool)
        if causal:
            ok &= qp >= kp
        if window:
            ok &= (qp - kp) < window
        sc = sc.masked_fill(~ok, NEG_INF)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2(m - mx)
        p = torch.exp2(sc - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + product(p, vt, three)
        m = mx
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-5])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0, float(tf32(x[5:]))])
    assert torch.equal(got, want)
    # TF32 keeps 10 mantissa bits: hi + lo is x to ~2^-22 of |x|
    y = torch.from_numpy(rand(0, 4096))
    hi, lo = split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()
    assert ((hi - y).abs() <= y.abs() * 2.0 ** -11).all()


# (B, S, T, HQ, KV, D, causal, window, q_offset): whisper-small's trained
# encoder (bidirectional) and cross-attention (S below T, causal) at 4 of
# its 12 heads and fewer frames; a windowed group of 5 past a q_offset at
# D 128
CASES = [
    (2, 150, 150, 4, 4, 64, False, 0, 0),
    (2, 48, 150, 4, 4, 64, True, 0, 0),
    (1, 70, 130, 10, 2, 128, True, 40, 60),
]


@pytest.mark.parametrize("b,s,t,hq,kv,d,causal,window,q_offset", CASES)
def test_three_tf32_products_match_the_reference(b, s, t, hq, kv, d, causal,
                                                 window, q_offset):
    q, k, v = rand(1, b, s, hq, d), rand(2, b, t, kv, d), \
        rand(3, b, t, kv, d)
    # the oracle takes (B, H, S, D) with kv heads expanded and masks from
    # position 0: a q_offset is the oracle over a prefix of other queries
    g = hq // kv
    qa = np.concatenate([rand(4, b, q_offset, hq, d), q], axis=1)
    ka, va = (np.repeat(x, g, axis=2) for x in (k, v))
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (qa, ka, va)),
        causal=causal, window=window))
    want = want.transpose(0, 2, 1, 3)[:, q_offset:]
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    err3 = np.abs(flash_tf32x3(*args, **kw).numpy() - want).max()
    err1 = np.abs(flash_tf32x3(*args, three=False, **kw).numpy()
                  - want).max()
    assert err3 <= TOL, err3
    assert err1 > TOL, err1      # one TF32 product would not do
