"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and is marked ``cuda``; without one it
skips, and the check happens inside the ``cuda`` fixture, never while the
module is collected. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX: the card's machine needs only torch.
Tolerances: bf16 2e-2 and f32 2e-4 on outputs (the kernel sums in another
order than the plain version, and rounds p to bf16 per tile rather than
per row), m 1e-4 and l 1e-4 relative (f32 throughout). The water-fill
kernel sums its bisection in another order than the plain version: in f64
the allocations agree within 1e-9 x capacity, in f32 within 1e-3 x
capacity (a 20k-term f32 sum carries ~1e-4 relative rounding, and the
level moves with it); two calls on the same input are bit-identical.
The SSD scan kernel: f32 within 2e-4 abs + rel on y and states and 1e-5 on
the decay (the reference's own bounds, ``tests/test_kernels.py:82-84``);
bf16 within 2e-2 of the largest |y| and |state| (both compute in f32, the
kernel's tensor-core products on hi + lo bf16 pairs; y may be asked in
bf16); state_decay as the decay; a zero-padded chunk gives exactly the
prefix's y, state, decay and state_decay; repeats are bit-identical.
``SsdScanFn`` (the SSD kernel forward, the plain version's VJP) gives
the kernel's outputs bit for bit and the plain autograd's grads within
1e-6 of each grad's largest value. whisper's shapes (12/12 heads, d 64,
1500 frames, group 1) hold ``TOL``. The int8 codec kernels equal their
plain version bit for bit (codes,
scales, and the dequantized values in f32 and bf16). The bytes plane runs
on an NCCL world of one rank: every stock policy's ``nk_grad_sync`` equals
its plain result bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.control.vectorized import VectorizedControlPlane
from repro_torch.kernels.decode_attention import (
    _counters, decode_attention, decode_attention_plain, split_plan)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, route)
from repro_torch.kernels.quant_comm import (
    codec_error_bound, dequantize_int8, dequantize_int8_plain, quantize_int8,
    quantize_int8_plain)
from repro_torch.kernels.ssd_scan import route as ssd_route
from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_chunk_scan_plain
from repro_torch.kernels.waterfill import (
    _scratch, water_fill, water_fill_plain)
from repro_torch.models.params import init_params
from repro_torch.serve import Request, ServeEngine, TenantScheduler

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda "
                    "tests/test_torch_cuda.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full
    torch.backends.cudnn.allow_tf32 = False         # precision, explicitly
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,hq,kv,d,causal,window,q_offset,dtype", [
    (1, 509, 509, 24, 8, 128, True, 0, 0, "bfloat16"),    # the path
    (2, 100, 100, 4, 2, 64, True, 32, 0, "bfloat16"),
    (1, 64, 192, 8, 2, 128, True, 0, 128, "bfloat16"),    # a later chunk
    (1, 50, 50, 4, 2, 32, True, 0, 0, "bfloat16"),        # CUDA-core kernel
    (2, 64, 192, 6, 3, 32, False, 0, 0, "float32"),
    (1, 77, 77, 4, 4, 16, True, 0, 0, "float32"),
    (1, 509, 509, 24, 8, 128, True, 0, 0, "float32"),
    # the wgmma kernel's edges: one row, two rows, a ragged second q tile,
    # the longest prefill, two sequences with a ragged T (the TMA map's
    # sequence boundary) and q_offset > 0, D 64 over two ragged sequences
    (1, 1, 1, 24, 8, 128, True, 0, 0, "bfloat16"),
    (1, 2, 2, 24, 8, 128, True, 0, 0, "bfloat16"),
    (1, 65, 65, 24, 8, 128, True, 0, 0, "bfloat16"),
    (1, 1024, 1024, 24, 8, 128, True, 0, 0, "bfloat16"),
    # the train phase's sequence: 32 kv tiles, the kernel's longest loop
    (1, 4096, 4096, 24, 8, 128, True, 0, 0, "bfloat16"),
    (2, 65, 130, 24, 8, 128, True, 0, 65, "bfloat16"),
    (2, 77, 77, 8, 2, 64, True, 0, 0, "bfloat16"),
    (2, 130, 130, 24, 8, 128, True, 100, 0, "bfloat16"),
    # chameleon-34b's prefills: 64/8 heads (group 8), d 128
    (1, 509, 509, 64, 8, 128, True, 0, 0, "bfloat16"),
    (1, 64, 64, 64, 8, 128, True, 0, 0, "bfloat16"),
    # hymba-1.5b's: 25/5 heads, d 64, the 1024-token window over prompts
    # longer than it (a q tile's first live kv tile cut by the window's
    # edge), a global layer, and the f32 kernel under the window
    (1, 1536, 1536, 25, 5, 64, True, 1024, 0, "bfloat16"),
    (1, 1100, 1100, 25, 5, 64, True, 1024, 0, "bfloat16"),
    (1, 1536, 1536, 25, 5, 64, True, 0, 0, "bfloat16"),
    (1, 1300, 1300, 25, 5, 64, True, 1024, 0, "float32"),
    # hymba-1.5b's trained micro-batch: S 4096, windowed and global
    (1, 4096, 4096, 25, 5, 64, True, 1024, 0, "bfloat16"),
    (1, 4096, 4096, 25, 5, 64, True, 0, 0, "bfloat16"),
    # whisper-small's decoder self-attention, 12/12 heads at d 64: a
    # trained micro-batch (4 x 448) and the served prefill (8 x 4)
    (4, 448, 448, 12, 12, 64, True, 0, 0, "bfloat16"),
    (8, 4, 4, 12, 12, 64, True, 0, 0, "bfloat16"),
    # arctic-480b's prefills: 56/8 heads (group 7), d 128, and f32
    (1, 509, 509, 56, 8, 128, True, 0, 0, "bfloat16"),
    (1, 64, 64, 56, 8, 128, True, 0, 0, "bfloat16"),
    (1, 300, 300, 56, 8, 128, True, 0, 0, "float32"),
    # head dim 192 (three 64-wide atoms a row, wgmma m64n192k16):
    # nemotron-4-340b's 96/8 heads and DeepSeek-V2's MLA prefill at
    # 128/128, ragged S, causal and not, a later chunk, and f32 (SIMT)
    (1, 509, 509, 96, 8, 192, True, 0, 0, "bfloat16"),
    (1, 64, 64, 96, 8, 192, True, 0, 0, "bfloat16"),
    (1, 1, 1, 96, 8, 192, True, 0, 0, "bfloat16"),
    (2, 130, 130, 96, 8, 192, False, 0, 0, "bfloat16"),
    (2, 65, 130, 96, 8, 192, True, 0, 65, "bfloat16"),
    (1, 509, 509, 128, 128, 192, True, 0, 0, "bfloat16"),
    (1, 77, 77, 128, 128, 192, False, 0, 0, "bfloat16"),
    (1, 300, 300, 96, 8, 192, True, 0, 0, "float32"),
    (1, 64, 64, 96, 8, 192, False, 0, 0, "float32"),
    (1, 300, 300, 128, 128, 192, True, 0, 0, "float32"),
    # f32 at D 64 and 128 on the tensor cores (three TF32 products):
    # whisper-small's trained encoder (bidirectional over 1500 frames) and
    # cross-attention (S 448 against T 1500, causal); windows in absolute
    # positions past a q_offset, groups of 5 and 12, ragged S and T
    (4, 1500, 1500, 12, 12, 64, False, 0, 0, "float32"),
    (4, 448, 1500, 12, 12, 64, True, 0, 0, "float32"),
    (2, 100, 301, 25, 5, 64, True, 64, 201, "float32"),
    (1, 77, 130, 10, 2, 64, False, 0, 0, "float32"),
    (1, 200, 200, 24, 2, 64, True, 0, 0, "float32"),
    (2, 65, 130, 25, 5, 128, True, 100, 65, "float32"),
    (1, 130, 200, 5, 1, 128, True, 0, 70, "float32"),
    (1, 1, 33, 12, 12, 64, True, 0, 32, "float32"),
])
def test_flash_kernel_matches_plain_on_card(cuda, b, s, t, hq, kv, d, causal,
                                            window, q_offset, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               .to(getattr(torch, dtype))
               for shape in ((b, s, hq, d), (b, t, kv, d), (b, t, kv, d)))
    before = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    took = route(q.dtype, d)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route == {**by_route,
                                                 took: by_route[took] + 1}
    # every f32 call at D 64 and 128 takes the tensor-core kernel
    assert (took == "tf32x3") == (dtype == "float32" and d in (64, 128))
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


SERVE_POS = (0, 1, 17, 255, 511, 700, 1022, 1023)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,hq,kv,d,window,t,pos,kv_len", [
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024, SERVE_POS, None),  # path
    ("float32", "bfloat16", 24, 8, 128, 0, 1024, SERVE_POS, None),
    ("float32", "float32", 8, 8, 64, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 16, 2, 128, 100, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 4, 2, 16, 0, 1024, SERVE_POS, None),   # smoke
    ("float32", "bfloat16", 8, 4, 32, 0, 1024, SERVE_POS, 600),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 4096, (3001,), None),  # 32 chunks
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 40, (0, 39, 5), None),  # 1 chunk
    # the one-launch kernel's edges: pos 0 and every chunk edge, B 1 (16
    # runs), B 32 (2 runs of 512), the replay phase's T 16, D 64, a window
    # over several runs, kv_len < T on the tensor-core path
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024,
     (0, 63, 64, 127, 128, 255, 256, 1023), None),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024, (1023,), None),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024, (0,), None),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024,
     tuple(range(0, 1024, 33))[:32], None),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 16, (1, 2, 3, 15), None),
    ("bfloat16", "bfloat16", 8, 8, 64, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 24, 8, 128, 300, 4096, (3001, 5, 299, 4095),
     None),
    ("bfloat16", "bfloat16", 24, 8, 128, 0, 1024, SERVE_POS, 600),
    # chameleon-34b's decode: 64/8 heads (group 8), 8 slots at mixed
    # positions, and at the serve phase's live range
    ("bfloat16", "bfloat16", 64, 8, 128, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 64, 8, 128, 0, 1024,
     (64, 132, 201, 269, 338, 406, 475, 544), None),
    # hymba-1.5b's global layers: 25/5 heads (group 5), d 64, 2048 slots;
    # and the f32 path
    ("bfloat16", "bfloat16", 25, 5, 64, 0, 2048,
     (1024, 1100, 1200, 1300, 1400, 1500, 1566, 1567), None),
    ("float32", "float32", 25, 5, 64, 0, 1024, SERVE_POS, None),
    # arctic-480b's decode: 56/8 heads (group 7, 7 query rows padded to
    # mma's 16 on the tensor-core path), mixed and serve-range positions;
    # f32 queries over a bf16 and an f32 cache on the CUDA-core path
    ("bfloat16", "bfloat16", 56, 8, 128, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 56, 8, 128, 0, 1024,
     (64, 132, 201, 269, 338, 406, 475, 544), None),
    ("bfloat16", "bfloat16", 56, 8, 128, 0, 4096, (3001, 5, 299, 4095),
     None),
    ("float32", "bfloat16", 56, 8, 128, 0, 1024, SERVE_POS, None),
    ("float32", "float32", 56, 8, 128, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 14, 2, 64, 0, 1024, SERVE_POS, None),
    # nemotron-4-340b's decode: 96/8 heads (group 12: rows 8-11 of mma's
    # 16 carry heads too), head dim 192, 2 stages of 48 KB chunks; pos 0
    # and T - 1, one sequence split into 16 runs, a 4096-slot cache; f32
    # queries over a bf16 and an f32 cache on the CUDA-core path
    ("bfloat16", "bfloat16", 96, 8, 192, 0, 1024, SERVE_POS, None),
    ("bfloat16", "bfloat16", 96, 8, 192, 0, 1024,
     (64, 132, 201, 269, 338, 406, 475, 544), None),
    ("bfloat16", "bfloat16", 96, 8, 192, 0, 1024, (1023,), None),
    ("bfloat16", "bfloat16", 96, 8, 192, 0, 1024, (0,), None),
    ("bfloat16", "bfloat16", 96, 8, 192, 0, 4096, (3001, 5, 299, 4095),
     None),
    ("bfloat16", "bfloat16", 24, 2, 192, 0, 1024, SERVE_POS, 600),
    ("float32", "bfloat16", 96, 8, 192, 0, 1024, SERVE_POS, None),
    ("float32", "float32", 96, 8, 192, 0, 1024, SERVE_POS, None),
    ("float32", "float32", 24, 2, 192, 0, 1024, (1023,), None),
])
def test_decode_kernel_matches_plain_on_card(cuda, q_dtype, kv_dtype, hq, kv,
                                             d, window, t, pos, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    b = len(pos)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn((b, t, kv, d), generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    o, m, l = decode_attention(q, k, v, pos, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ro, rm, rl = decode_attention_plain(q, k, v, pos, window=window,
                                        kv_len=kv_len)
    tol = TOL[q_dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,d,b", [("bfloat16", 128, 8),
                                         ("bfloat16", 128, 32),
                                         ("float32", 128, 8)])
def test_decode_kernel_repeats_are_bit_identical(cuda, q_dtype, d, b):
    """Two calls on the same inputs give the same (o, m, l) to the bit: the
    last block of a sequence combines the runs' partials in run order, not
    in the order they finished, and leaves its counter at zero."""
    g = torch.Generator(device=cuda).manual_seed(1)
    t = 1024
    q = torch.randn((b, 24, d), generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn((b, t, 8, d), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.randint(0, t, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    first = decode_attention(q, k, v, pos)
    for _ in range(3):
        again = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        for x, y in zip(first, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,b", [
    ("bfloat16", "bfloat16", 8), ("bfloat16", "bfloat16", 1),
    ("float32", "bfloat16", 8), ("float32", "float32", 8)])
def test_decode_group_12_repeats_are_bit_identical(cuda, q_dtype, kv_dtype,
                                                   b):
    """nemotron-4-340b's decode shape (96/8 heads, head dim 192) on both
    paths: repeats give the same (o, m, l) to the bit, B 1 over 16 runs
    and B 8 over 4."""
    g = torch.Generator(device=cuda).manual_seed(2)
    t = 1024
    q = torch.randn((b, 96, 192), generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn((b, t, 8, 192), generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    pos = torch.randint(0, t, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[0] = t - 1
    first = decode_attention(q, k, v, pos)
    for _ in range(3):
        again = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        for x, y in zip(first, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_attention_wrappers_refuse_shapes_outside_their_tables(cuda):
    """On the card the wrappers raise a ValueError that names the shape:
    decode at head dim 192 is built for group 12 alone and group 12 for
    head dim 192 alone; flash takes head dims 16-192 of its table, not
    96. Nothing launches."""
    def decode(hq, kv, d):
        q = torch.zeros((2, hq, d), dtype=torch.bfloat16, device=cuda)
        cache = torch.zeros((2, 64, kv, d), dtype=torch.bfloat16,
                            device=cuda)
        pos = torch.zeros(2, dtype=torch.int32, device=cuda)
        return decode_attention(q, cache, cache.clone(), pos)

    before = (flash_attention.launches, decode_attention.launches)
    for hq, kv, d in ((64, 8, 192), (24, 2, 128), (12, 1, 64)):
        with pytest.raises(ValueError, match=f"head dim {d} / group "
                                             f"{hq // kv}"):
            decode(hq, kv, d)
    x = torch.zeros((1, 8, 4, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention(x, x, x)
    assert (flash_attention.launches, decode_attention.launches) == before
    decode(96, 8, 192)
    assert decode_attention.launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_prefill_kernel_matches_plain_on_card(cuda, which, dtype):
    """``mla_attention``'s prefill through the flash kernel (q, k and v
    padded to one head dim, the output cut back) against the same call
    on the plain path (``attention_impl="naive"``), from the same
    weights: the smoke config's head dims (dk 24, dv 16: padded to 32)
    and the full ones (dk 192, dv 128: v padded), 4 heads, B 2 x 200
    tokens; one flash launch, the output within ``TOL``."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                              dtype=dtype, param_dtype=dtype)
    if which == "full":    # configs attach their MLA dims by name
        cfg = dataclasses.replace(cfg, name="deepseek-v2-236b", d_model=256)
    model = init_params(cfg, device=cuda, seed=4)
    p = model.blocks[0]["attn"]
    x = torch.randn((2, 200, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda).to(getattr(torch, dtype))
    pos = torch.arange(200, device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        o = attention.mla_attention(p, x, cfg, RunConfig(), positions=pos)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = attention.mla_attention(
            p, x, cfg, RunConfig(attention_impl="naive"), positions=pos)
    assert flash_attention.launches == before + 1
    rel = ((o.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel <= TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_decode_at_group_5_matches_the_kv_pos_decode(cuda, dtype):
    """hymba-1.5b's windowed decode: 8 rings of 1024 slots at 25/5 heads,
    d 64, positions before the ring fills, at its edge and past several
    wraps. The kernel at ``pos_eff = min(pos, 1023)`` and no window equals
    its plain version there and the reference's decode over absolute slot
    positions (``kv_pos``, the 1024-token window; p in f32); two calls are
    bit-identical."""
    from repro_torch.models.attention import decode_attention as by_kv_pos
    from repro_torch.models.attention import q_to_kv_map, ring_slots
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = getattr(torch, dtype)
    t, hq, kv, d = 1024, 25, 5, 64
    pos = torch.tensor((1023, 1024, 1300, 1567, 0, 5, 2047, 1100),
                       dtype=torch.int32, device=cuda)
    b = len(pos)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((b, t, kv, d), generator=g, device=cuda).to(dt)
            for _ in range(2))
    ring = ring_slots(pos, t, kv_pos=True)
    before = decode_attention.launches
    o, m, l = decode_attention(q, k, v, ring.pos_eff)
    again = decode_attention(q, k, v, ring.pos_eff)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    for x, y in zip((o, m, l), again):
        assert torch.equal(x, y)
    ro, rm, rl = decode_attention_plain(q, k, v, ring.pos_eff)
    want = by_kv_pos(q[:, None].float(), k, v, pos,
                     kv_map=q_to_kv_map(hq, hq, kv, cuda), window=1024,
                     kv_pos=ring.kv_pos)[:, 0]
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(o.float(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_tickets_are_kept_per_stream(cuda):
    """Decode launches on two streams at once, with different B*KV and
    several runs per sequence (so each combines through its ticket
    counter), each equal to the plain version: the counter is keyed by
    (card, stream), so concurrent launches never share tickets."""
    g = torch.Generator(device=cuda).manual_seed(5)

    def case(b, t, kv):
        q = torch.randn((b, 3 * kv, 128), generator=g, device=cuda).to(
            torch.bfloat16)
        k, v = (torch.randn((b, t, kv, 128), generator=g, device=cuda).to(
            torch.bfloat16) for _ in range(2))
        pos = torch.randint(t // 2, t, (b,), generator=g, device=cuda,
                            dtype=torch.int32)
        return q, k, v, pos

    cases = (case(1, 4096, 8), case(6, 2048, 4))
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    for q, k, _v, _pos in cases:
        assert split_plan(q.shape[0], k.shape[2], k.shape[1], sms)[0] > 1
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(16):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(decode_attention(*args))
    torch.cuda.synchronize()
    for args, got in zip(cases, outs):
        ro, rm, rl = decode_attention_plain(*args)
        for o, m, l in got:
            torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2,
                                       atol=2e-2)
            torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(l, rl, rtol=1e-4, atol=1e-4)
    keys = {key for key in _counters if key[0] == index}
    assert {(index, st.cuda_stream) for st in streams} <= keys


@pytest.mark.cuda
def test_serve_engine_on_card_matches_cpu(cuda):
    """The f32 smoke llama served on the card through both kernels gives
    the tokens and ledger that the plain path gives on the CPU, from the
    same weights, and every attention call went through a kernel."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"),
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 9, 16, 7, 30, 12)]

    def serve(device):
        model = init_params(cfg, device="cpu", seed=0).to(device)
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=64,
                          scheduler=sched, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant_id=i % 3, prompt=p, max_new_tokens=10,
                               req_id=i, arrival=0.0))
        k = 0
        while sched.pending() or any(s.active for s in eng.slots):
            k += 1
            eng.step(now=0.1 * k)
            assert k < 200
        return eng, ([(r.req_id, r.generated) for r in eng.completed],
                     dict(sched.served_tokens), sched.ledger())

    flash0, decode0 = flash_attention.launches, decode_attention.launches
    eng, on_card = serve(cuda)
    torch.cuda.synchronize()
    assert flash_attention.launches - flash0 == \
        cfg.num_layers * eng.admissions
    assert decode_attention.launches - decode0 == \
        cfg.num_layers * eng.decode_steps
    _, on_cpu = serve(torch.device("cpu"))
    assert on_card == on_cpu


def _water_case(n, seed, kind="mixed"):
    """Seeded demands and weights (numpy f64) and a capacity: a mix of
    satisfiable, large and inf demands, zero demands, and zero or
    negative weights; or one of the edge cases."""
    rng = np.random.default_rng(seed)
    cap = 1000.0
    d = rng.uniform(0.1, 2.0, n) * cap / n
    d[rng.random(n) < 0.2] *= 50.0
    d[rng.random(n) < 0.1] = np.inf
    d[rng.random(n) < 0.05] = 0.0
    w = rng.choice([0.5, 1.0, 2.0, 4.0], n)
    w[rng.random(n) < 0.05] = 0.0
    w[rng.random(n) < 0.03] = -1.0
    if kind == "parked":
        w[:] = 0.0
    elif kind == "zero_cap":
        cap = 0.0
    elif kind == "all_inf":
        d[:] = np.inf
        w = np.abs(w) + 0.5
    elif kind == "ties":
        # a third greedy, a third with ratio exactly `level` (w is a
        # power of two, so w * level / w is level), a third satisfied
        # below it; the capacity puts the fill's level at `level`
        level = 0.75 * cap / n
        w = rng.choice([0.5, 1.0, 2.0, 4.0], n)
        part = rng.integers(0, 3, n)
        d = np.where(part == 0, np.inf, w * level)
        d = np.where(part == 2, d * rng.uniform(0.1, 0.9, n), d)
        cap = float(w[part < 2].sum() * level + d[part == 2].sum())
    return d, w, cap


# the bisection's step count of each kind ("itersK": the mixed case in
# K steps; none, one, a count under one pass of any depth, and more passes
# than the grid launch has buffers, so that it reuses them)
WATER_ITERS = {"iters0": 0, "iters1": 1, "iters7": 7, "iters200": 200}


@pytest.mark.cuda
@pytest.mark.parametrize("n,kind,dtype", [
    (1, "mixed", "float64"), (3, "mixed", "float64"),
    (257, "mixed", "float64"),                 # not a multiple of 256
    (1000, "mixed", "float64"), (8192, "mixed", "float64"),   # one block
    (8193, "mixed", "float64"),                # the first grid launch
    (100_000, "mixed", "float64"), (1_048_576, "mixed", "float64"),
    (1_500_000, "mixed", "float64"),           # past the register fit
    (1000, "parked", "float64"), (100_000, "parked", "float64"),
    (1000, "zero_cap", "float64"), (100_000, "all_inf", "float64"),
    (1000, "mixed", "float32"), (20_000, "mixed", "float32"),
    # the one-warp kernel (n <= 32) and its edges, one block's K = 1
    (2, "mixed", "float64"), (4, "mixed", "float64"),
    (31, "mixed", "float64"), (32, "mixed", "float64"),
    (33, "mixed", "float64"), (255, "mixed", "float64"),
    (256, "mixed", "float64"),
    # the remainder pass: each launch kind at 0, 1, 7 and 200 steps
    *[(n, kind, "float64") for n in (4, 1000, 100_000)
      for kind in WATER_ITERS],
    # many ratios exactly at the final level
    (1000, "ties", "float64"), (100_000, "ties", "float64"),
])
def test_water_fill_kernel_matches_plain_on_card(cuda, n, kind, dtype):
    d, w, cap = _water_case(n, seed=n, kind=kind)
    iters = WATER_ITERS.get(kind, 48)
    dt = getattr(torch, dtype)
    dd, ww = (torch.tensor(x, dtype=dt, device=cuda) for x in (d, w))
    before = water_fill.launches
    alloc, level = water_fill(dd, ww, cap, iters=iters)
    again, level2 = water_fill(dd, ww, cap, iters=iters)
    torch.cuda.synchronize()
    assert water_fill.launches == before + 2
    assert torch.equal(alloc, again) and torch.equal(level, level2)
    want, want_level = water_fill_plain(dd.cpu(), ww.cpu(), cap,
                                        iters=iters)
    tol = (1e-9 if dtype == "float64" else 1e-3) * max(cap, 1.0)
    assert torch.isfinite(alloc).all()
    assert (alloc.cpu() - want).abs().max().item() <= tol
    if iters == 48:    # fewer steps leave the level high: over capacity
        assert float(alloc.double().sum()) <= cap + tol * n
    if kind in ("parked", "zero_cap"):
        assert not alloc.any()


@pytest.mark.cuda
def test_water_fill_scratch_is_kept_per_stream(cuda):
    """Water-fills on two streams at once, each a cooperative grid launch
    at another n (40 and 79 blocks: both grids fit on the card at once),
    each bit for bit the same call's result alone and within 1e-9 x
    capacity of the plain version: the partial sums' scratch is kept per
    (card, stream), so concurrent grids never share it."""
    cases = []
    for n in (10_000, 20_000):
        d, w, cap = _water_case(n, seed=n)
        cases.append((*(torch.tensor(x, dtype=torch.float64, device=cuda)
                        for x in (d, w)), cap))
    alone = [water_fill(dd, ww, cap) for dd, ww, cap in cases]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(16):
        for i, (st, (dd, ww, cap)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(water_fill(dd, ww, cap))
    torch.cuda.synchronize()
    for (dd, ww, cap), (a0, l0), got in zip(cases, alone, outs):
        want, _ = water_fill_plain(dd.cpu(), ww.cpu(), cap)
        assert (a0.cpu() - want).abs().max().item() <= 1e-9 * cap
        for a, lvl in got:
            assert torch.equal(a, a0) and torch.equal(lvl, l0)
    index = torch.cuda.current_device()
    keys = {key for key in _scratch if key[0] == index}
    assert {(index, st.cuda_stream) for st in streams} <= keys


@pytest.mark.cuda
def test_fused_tick_on_card_matches_cpu(cuda):
    """The same counter trace through a plane on the card and one on the
    CPU: allocations within 1e-9 relative, NaN positions equal."""
    n = 5000
    rng = np.random.default_rng(7)
    weights = rng.choice([1.0, 2.0, 4.0], n)
    steps = np.maximum(np.round(rng.uniform(0.2, 2.0, n) * 1e6 / n), 1.0)
    queue = np.where(rng.random(n) < 0.1, 1.0, 0.0)
    planes = {dev: VectorizedControlPlane(1e6, min_rate=2.0, device=dev)
              for dev in (cuda, "cpu")}
    for plane in planes.values():
        for t in range(n):
            plane.add_tenant(t, weight=float(weights[t]))
    served = np.zeros(n)
    before = water_fill.launches
    for k in range(5):
        served = served + steps
        out = {dev: plane.tick(served, queue=queue, now=float(k))
               for dev, plane in planes.items()}
    assert water_fill.launches == before + 4      # first tick baselines
    card, cpu = out[cuda], out["cpu"]
    np.testing.assert_allclose(card, cpu, rtol=1e-9, atol=0.0)
    for plane in planes.values():
        plane._sync_host()
    np.testing.assert_array_equal(np.isnan(planes[cuda].ewma_off),
                                  np.isnan(planes["cpu"].ewma_off))
    np.testing.assert_allclose(planes[cuda].level, planes["cpu"].level,
                               rtol=1e-9, atol=0.0)


def _ssd_case(device, nb, nc, q, h, p, n, dtype, *, dt_scale=1.0, seed=0):
    """Model-like inputs: dt = softplus(N(0,1)) (about 0.7, so the cumsum
    reaches about -180 over 256 rows), dA = -dt, x*dt with x ~ N(0, 0.25),
    B and C ~ N(0, 0.25)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)
    dt = torch.nn.functional.softplus(randn(nb, nc, q, h)) * dt_scale
    xdt = (randn(nb, nc, q, h, p) * 0.5 * dt[..., None]).to(
        getattr(torch, dtype))
    B, C = (randn(nb, nc, q, n).mul(0.5).to(getattr(torch, dtype))
            for _ in range(2))
    return xdt, -dt, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nc,q,h,p,n,dtype,out,dt_scale", [
    (1, 1, 256, 32, 64, 128, "bfloat16", "float32", 1.0),   # mamba2: path
    (1, 2, 256, 32, 64, 128, "bfloat16", "float32", 1.0),
    (1, 16, 256, 32, 64, 128, "bfloat16", "float32", 1.0),
    (1, 2, 256, 32, 64, 128, "bfloat16", "bfloat16", 0.01),  # long decay
    (1, 2, 256, 32, 64, 128, "float32", "float32", 1.0),     # CUDA cores
    (2, 3, 128, 50, 64, 16, "bfloat16", "float32", 1.0),     # hymba, H 50
    (2, 3, 128, 50, 64, 16, "float32", "float32", 0.1),
    (1, 2, 32, 8, 16, 16, "bfloat16", "float32", 1.0),       # smoke
    (2, 3, 64, 16, 32, 64, "bfloat16", "bfloat16", 0.1),     # ref test
    (1, 2, 200, 4, 64, 128, "bfloat16", "float32", 1.0),     # ragged Q
    (1, 2, 40, 6, 32, 32, "bfloat16", "float32", 0.1),       # CUDA cores
    # the wgmma kernel at odd H, with a ragged Q and a bf16 y too
    (1, 2, 256, 5, 64, 128, "bfloat16", "float32", 1.0),
    (2, 1, 200, 33, 64, 128, "bfloat16", "bfloat16", 1.0),
    # hymba-1.5b's path: serve (a 1,536-token prompt), train (4,096
    # tokens) and a TP rank's 25 heads at tp 2
    (1, 12, 128, 50, 64, 16, "bfloat16", "float32", 1.0),
    (1, 32, 128, 50, 64, 16, "bfloat16", "float32", 1.0),
    (1, 12, 128, 25, 64, 16, "bfloat16", "float32", 1.0),
])
def test_ssd_kernel_matches_plain_on_card(cuda, nb, nc, q, h, p, n, dtype,
                                          out, dt_scale):
    xdt, dA, B, C = _ssd_case(cuda, nb, nc, q, h, p, n, dtype,
                              dt_scale=dt_scale)
    out_dtype = getattr(torch, out)
    before = ssd_chunk_scan.launches
    by_route = dict(ssd_chunk_scan.launches_by_route)
    took = ssd_route(xdt.dtype, p, n)
    y, st, dec, sd = ssd_chunk_scan(xdt, dA, B, C, out_dtype=out_dtype,
                                    state_decay=True)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    assert ssd_chunk_scan.launches_by_route == {**by_route,
                                                took: by_route[took] + 1}
    assert y.dtype == out_dtype and tuple(y.shape) == tuple(xdt.shape)
    assert tuple(sd.shape) == (nb, nc, q, h)
    ry, rst, rdec, rsd = ssd_chunk_scan_plain(
        xdt, dA, B, C, out_dtype=out_dtype, state_decay=True)
    for t in (y, st, dec, sd):
        assert torch.isfinite(t).all()
    if dtype == "float32":
        torch.testing.assert_close(y, ry, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, rst, rtol=2e-4, atol=2e-4)
    else:
        assert (y.float() - ry.float()).abs().max() <= \
            2e-2 * ry.float().abs().max()
        assert (st - rst).abs().max() <= 2e-2 * rst.abs().max()
    torch.testing.assert_close(dec, rdec, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sd, rsd, rtol=1e-5, atol=1e-5)


MAMBA2_SSD = (256, 32, 64, 128)
HYMBA_SSD = (128, 50, 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,shape,real", [
    ("bfloat16", 2, MAMBA2_SSD, 200), ("float32", 2, MAMBA2_SSD, 200),
    ("bfloat16", 1, MAMBA2_SSD, 200),
    # hymba-1.5b's 1,300-token parity prompt: 11 chunks of 128, the last
    # holding 20 rows (108 padded)
    ("bfloat16", 11, HYMBA_SSD, 20), ("bfloat16", 1, HYMBA_SSD, 20)])
def test_ssd_kernel_padded_chunk_equals_the_prefix(cuda, dtype, nc, shape,
                                                   real):
    """Chunks whose rows past ``real`` are zero x*dt and dA = 0 (how
    ``ssd_chunked`` pads a prompt) give the ``real``-row prefix's y rows,
    state, decay and state_decay rows exactly: mamba2's Q 256 over 200
    rows, hymba's Q 128 over 20."""
    q, h, p, n = shape
    xdt, dA, B, C = _ssd_case(cuda, 1, nc, q, h, p, n, dtype, seed=3)
    xdt[:, :, real:] = 0
    dA[:, :, real:] = 0
    full = ssd_chunk_scan(xdt, dA, B, C, out_dtype=torch.float32,
                          state_decay=True)
    prefix = ssd_chunk_scan(*(t[:, :, :real].contiguous()
                              for t in (xdt, dA, B, C)),
                            out_dtype=torch.float32, state_decay=True)
    torch.cuda.synchronize()
    assert torch.equal(full[0][:, :, :real], prefix[0])
    assert torch.equal(full[1], prefix[1])
    assert torch.equal(full[2], prefix[2])
    assert torch.equal(full[3][:, :, :real], prefix[3])


@pytest.mark.cuda
@pytest.mark.parametrize("nc,h,dtype,qpn", [
    (2, 32, "bfloat16", (256, 64, 128)), (1, 32, "bfloat16", (256, 64, 128)),
    (1, 5, "bfloat16", (256, 64, 128)), (2, 32, "float32", (256, 64, 128)),
    # hymba-1.5b: serve, train, a TP rank at tp 2
    (12, 50, "bfloat16", (128, 64, 16)), (32, 50, "bfloat16", (128, 64, 16)),
    (12, 25, "bfloat16", (128, 64, 16))])
def test_ssd_kernel_repeats_are_bit_identical(cuda, nc, h, dtype, qpn):
    """Two launches on one input give the same four outputs to the bit:
    no atomics, and every sum in a fixed order."""
    q, p, n = qpn
    xdt, dA, B, C = _ssd_case(cuda, 1, nc, q, h, p, n, dtype, seed=4)
    first = ssd_chunk_scan(xdt, dA, B, C, out_dtype=torch.float32,
                           state_decay=True)
    for _ in range(3):
        again = ssd_chunk_scan(xdt, dA, B, C, out_dtype=torch.float32,
                               state_decay=True)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssm_serve_engine_on_card_matches_cpu(cuda):
    """The f32 smoke mamba2 served on the card (prefill through the SSD
    kernel) gives the tokens and ledger of the plain path on the CPU, and
    every prefill layer went through the kernel."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"),
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 33, 16, 7, 60, 12)]

    def serve(device):
        model = init_params(cfg, device="cpu", seed=0).to(device)
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=96,
                          scheduler=sched, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant_id=i % 3, prompt=p, max_new_tokens=10,
                               req_id=i, arrival=0.0))
        k = 0
        while sched.pending() or any(s.active for s in eng.slots):
            k += 1
            eng.step(now=0.1 * k)
            assert k < 200
        return eng, ([(r.req_id, r.generated) for r in eng.completed],
                     dict(sched.served_tokens), sched.ledger())

    before = ssd_chunk_scan.launches
    eng, on_card = serve(cuda)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches - before == \
        cfg.num_layers * eng.admissions
    _, on_cpu = serve(torch.device("cpu"))
    assert on_card == on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 255, 257, 4096])
@pytest.mark.parametrize("c", [256, 3072, 8192])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_kernel_matches_plain_on_card(cuda, r, c, block, dtype):
    """``chip_smoke.py``'s codec shapes: rows scaled 1e-2..1e2, a zero
    block and exact ties; codes, scales and both dequantized dtypes equal
    the plain version's to the bit, within the stated bound, one launch
    each."""
    g = torch.Generator(device=cuda).manual_seed(r * 31 + c)
    x = torch.randn((r, c), generator=g, device=cuda)
    x *= torch.exp(torch.empty((r, 1), device=cuda).uniform_(
        np.log(0.01), np.log(100.0), generator=g))
    x[0, :256] = 0.0
    if r > 1:
        x[1, :256] = 0.0
        x[1, :128] = (torch.arange(-64, 64, device=cuda) + 0.5) * 0.125
        x[1, 0] = 127 * 0.125
    x = x.to(getattr(torch, dtype))
    before = (quantize_int8.launches, dequantize_int8.launches)
    q, s = quantize_int8(x, block=block)
    outs = {o: dequantize_int8(q, s, block=block, dtype=getattr(torch, o))
            for o in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    assert (quantize_int8.launches, dequantize_int8.launches) == \
        (before[0] + 1, before[1] + 2)
    pq, ps = quantize_int8_plain(x, block=block)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    for o, d in outs.items():
        assert torch.equal(d, dequantize_int8_plain(
            q, s, block=block, dtype=getattr(torch, o)))
        assert bool(((d.float() - x.float()).abs()
                     <= codec_error_bound(x, s, d, block=block)).all())
    if r > 1:
        assert s[1, 0].item() == 0.125
        assert q[1, 1:128].tolist() == [2 * ((k + 1) // 2)
                                        for k in range(-63, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(128256, 3072), (3072, 8192), (8192, 3072),
                                 (3072, 3072), (3072, 1024), (1, 3072)])
def test_codec_kernel_matches_plain_at_llama_leaf_shapes(cuda, r, c):
    """The shapes the codec takes on its path in ``chip_smoke.py``:
    llama3.2-3b's leaves as (first dim, rest) at bf16, block 256, round
    trip into bf16. Codes, scales and values equal the plain version's to
    the bit."""
    g = torch.Generator(device=cuda).manual_seed(r + c)
    x = (torch.randn((r, c), generator=g, device=cuda) * 0.02).to(
        torch.bfloat16)
    q, s = quantize_int8(x)
    d = dequantize_int8(q, s, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    pq, ps = quantize_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(d, dequantize_int8_plain(q, s, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_codec_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((4, 512), device=cuda)
    unaligned = torch.zeros(4 * 256 + 1, device=cuda)[1:].view(4, 256)
    with pytest.raises(ValueError, match="aligned"):
        quantize_int8(unaligned)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8(x[:, :256])
    with pytest.raises(TypeError):
        quantize_int8(x.double())
    with pytest.raises(ValueError, match="block"):
        quantize_int8(x, block=512)


@pytest.mark.cuda
def test_nk_grad_sync_on_an_nccl_world_of_one(cuda):
    """The bytes plane on the card: ``chip_smoke.py``'s bytes phase on a
    small pytree (NCCL, world size 1): each policy's output equals its
    plain result, ledgers equal payload bytes, billed bytes survive a
    move."""
    import importlib.util
    import pathlib

    import torch.distributed as dist
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"embed": torch.randn((512, 256), generator=g, device=cuda)
            .to(torch.bfloat16),
            "w": torch.randn((3, 256, 512), generator=g, device=cuda),
            "norm": torch.randn(256, generator=g, device=cuda)}
    rows = cs.phase_bytes(torch, torch.device("cuda", 0), tree)
    assert not dist.is_initialized()
    assert [r["policy"] for r in rows] == list(cs.BYTES_POLICIES)
    assert all(r["ok"] for r in rows)


# ---------------------------------------------------------------------------
# the engine cluster on the card
# ---------------------------------------------------------------------------


def _cluster_run(name, device, intervals=10):
    """A smoke-config 3-engine cluster through one scenario; returns the
    cluster, the report and what two runs must agree on (ledgers, records,
    and a checkpoint's bytes once no drain is open)."""
    from repro_torch.serve.replay import (
        make_replay_cluster, replay_scenario, scenario_spec)
    _trace, cap = scenario_spec(name, n_tenants=4, intervals=intervals)
    cl = make_replay_cluster(capacity=cap, engines=3, device=device,
                             core_plane=name in ("stack_swap", "failover"))
    rep = replay_scenario(name, n_tenants=4, intervals=intervals, engine=cl)
    now = rep.duration_s
    while cl.draining:
        now += 0.05
        cl.step(now=now)
    facts = {
        "per_tenant": {t: dataclasses.astuple(r)
                       for t, r in rep.per_tenant.items()},
        "decode_steps": [e.decode_steps for e in cl.engines],
        "placement": dict(cl.placement),
        "migrations": [vars(r) for r in cl.migration_log],
        "swaps": [vars(r) for r in cl.swap_log],
        "failures": [vars(r) for r in cl.failure_log],
        "served": cl.merged_ledger("served_tokens"),
        "snapshot": cl.checkpoint(now=now).to_bytes()}
    return cl, rep, facts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["migration", "failover"])
def test_cluster_on_card_matches_cpu(cuda, name):
    """Ledgers and records do not depend on the device: the same scenario
    on the card and on the CPU gives the same per-tenant report, records
    and placement, and the same ``FabricSnapshot`` bytes (object
    backend; the clock is virtual). Every attention call of the card's run
    went through a kernel."""
    f0, d0 = flash_attention.launches, decode_attention.launches
    cl, rep, on_card = _cluster_run(name, cuda)
    torch.cuda.synchronize()
    layers = cl.engines[0].cfg.num_layers
    assert flash_attention.launches - f0 == \
        layers * sum(e.admissions for e in cl.engines)
    assert decode_attention.launches - d0 == \
        layers * sum(e.decode_steps for e in cl.engines)
    _, _, on_cpu = _cluster_run(name, torch.device("cpu"))
    assert on_card == on_cpu
    assert rep.migrations >= 1 if name == "migration" else \
        rep.recoveries == 1


@pytest.mark.cuda
def test_cluster_park_frees_the_cache_on_card(cuda):
    """Parking drops exactly the parked engine's KV-cache from the card's
    allocated bytes; unpark allocates nothing; the first admission after
    it re-materialises the cache. The engines share one model."""
    from repro_torch.serve.replay import make_replay_cluster
    cl = make_replay_cluster(capacity=50.0, engines=3, device=cuda)
    assert all(e.params is cl.engines[0].params for e in cl.engines)
    torch.cuda.synchronize()
    cache = cl.engines[2]._cache_bytes()
    before = torch.cuda.memory_allocated(cuda)
    cl.park(2)
    parked = torch.cuda.memory_allocated(cuda)
    assert before - parked == cache > 0
    assert cl.parked_bytes() == cache
    cl.unpark(2)
    assert torch.cuda.memory_allocated(cuda) == parked
    assert cl.engines[2].caches is None
    cl.add_tenant(0, engine=2)
    cl.submit(Request(tenant_id=0, prompt=[1, 2], max_new_tokens=3,
                      req_id=1, arrival=0.0))
    cl.step(now=0.0)
    torch.cuda.synchronize()
    assert cl.engines[2]._cache_bytes() == cache
    assert cache <= torch.cuda.memory_allocated(cuda) - parked < \
        cache + (1 << 20)


@pytest.mark.cuda
def test_chameleon_full_width_two_layers_kernel_vs_plain(cuda):
    """chameleon-34b at full width (d_model 8192, 64/8 heads, head_dim 128,
    d_ff 22016, vocab 65536, q/k norms, untied embeddings) and 2 layers,
    random bf16 weights (~4.9 GB): a 300-token prefill and 4 decode steps
    through the kernels and through the plain path decoding the same
    tokens, logits within 2e-2 of max |logit| at every step; the kernel
    path launches flash once per layer and decode once per layer and
    step."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_decode, forward_prefill, \
        init_cache
    cfg = dataclasses.replace(get_config("chameleon-34b"), num_layers=2)
    model = init_params(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen,
                           device=cuda, dtype=torch.int32)
    paths = {"kernel": RunConfig(), "plain": RunConfig(
        attention_impl="naive")}
    flash_attention.launches = 0
    decode_attention.launches = 0
    logits, caches = {}, {}
    for name, rc in paths.items():
        lg, c1 = forward_prefill(model, prompt, rc, max_seq=512)
        cache = init_cache(cfg, 1, 512, device=cuda)
        for big, one in zip(cache, c1):
            for k in big:
                big[k].copy_(one[k])
        logits[name], caches[name] = [lg.float()], cache
    assert flash_attention.launches == cfg.num_layers
    tok = int(logits["kernel"][0].argmax())
    for step in range(4):
        pos = torch.tensor([300 + step], dtype=torch.int32, device=cuda)
        t = torch.tensor([[tok]], dtype=torch.int32, device=cuda)
        for name, rc in paths.items():
            lg, _ = forward_decode(model, caches[name], t, pos, rc)
            logits[name].append(lg.float())
        tok = int(logits["kernel"][-1].argmax())
    assert flash_attention.launches == cfg.num_layers
    assert decode_attention.launches == 4 * cfg.num_layers
    for i, (a, b) in enumerate(zip(logits["kernel"], logits["plain"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= TOL["bfloat16"], (i, rel)


@pytest.mark.cuda
def test_hymba_full_width_four_layers_kernel_vs_plain(cuda):
    """hymba-1.5b at full width (d_model 1600, 25/5 heads, head_dim 64, SSM
    H 50, P 64, N 16, chunk 128) and 4 layers, 0 and 3 global, 1-2 under
    the 1024-token window: a 1300-token prefill (the rings rolled by 276)
    and 4 decode steps at max_seq 2048 through the kernels and through the
    plain path decoding the same tokens, logits within 2e-2 of max |logit|
    at every step; flash and the SSD scan launched once per layer, decode
    once per layer and step."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_decode, forward_prefill, \
        init_cache
    cfg = dataclasses.replace(get_config("hymba-1.5b"), num_layers=4,
                              global_attn_layers=(0, 3))
    model = init_params(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 1300), generator=gen,
                           device=cuda, dtype=torch.int32)
    paths = {"kernel": RunConfig(), "plain": RunConfig(
        attention_impl="naive")}
    counters = (flash_attention, ssd_chunk_scan, decode_attention)
    for fn in counters:
        fn.launches = 0
    logits, caches = {}, {}
    for name, rc in paths.items():
        lg, c1 = forward_prefill(model, prompt, rc, max_seq=2048)
        cache = init_cache(cfg, 1, 2048, device=cuda)
        assert cache[1]["k"].shape[2] == 1024
        for big, one in zip(cache, c1):
            for k in big:
                big[k].copy_(one[k])
        logits[name], caches[name] = [lg.float()], cache
    tok = int(logits["kernel"][0].argmax())
    for step in range(4):
        pos = torch.tensor([1300 + step], dtype=torch.int32, device=cuda)
        t = torch.tensor([[tok]], dtype=torch.int32, device=cuda)
        for name, rc in paths.items():
            lg, _ = forward_decode(model, caches[name], t, pos, rc)
            logits[name].append(lg.float())
        tok = int(logits["kernel"][-1].argmax())
    assert [fn.launches for fn in counters] == [4, 4, 16]
    for i, (a, b) in enumerate(zip(logits["kernel"], logits["plain"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= TOL["bfloat16"], (i, rel)


@pytest.mark.cuda
def test_hybrid_serve_engine_on_card_matches_cpu(cuda):
    """The f32 smoke hymba (window 32) served on the card at max_seq 64,
    prompts of 32-45 tokens (its rings wrap), gives the tokens and ledger
    the plain path gives on the CPU from the same weights; every prefill
    went through flash and the SSD scan, every decode step through the
    decode kernel."""
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (32, 37, 45, 33, 40, 32)]

    def serve(device):
        model = init_params(cfg, device="cpu", seed=0).to(device)
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=64,
                          scheduler=sched, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant_id=i % 3, prompt=p, max_new_tokens=12,
                               req_id=i, arrival=0.0))
        k = 0
        while sched.pending() or any(s.active for s in eng.slots):
            k += 1
            eng.step(now=0.1 * k)
            assert k < 200
        return eng, ([(r.req_id, r.generated) for r in eng.completed],
                     dict(sched.served_tokens), sched.ledger())

    counters = (flash_attention, ssd_chunk_scan, decode_attention)
    before = [fn.launches for fn in counters]
    eng, on_card = serve(cuda)
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        n * eng.admissions, n * eng.admissions, n * eng.decode_steps]
    _, on_cpu = serve(torch.device("cpu"))
    assert on_card == on_cpu


# ---------------------------------------------------------------------------
# training: the flash kernel under autograd
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,kv,d,window", [
    (509, 24, 8, 128, 0),           # llama3.2-3b's heads
    (4096, 24, 8, 128, 0),          # the train phase's sequence
    (1100, 25, 5, 64, 1024),        # hymba-1.5b's heads under its window
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_fn_on_card(cuda, s, hq, kv, d, window, dtype):
    """``FlashAttentionFn``'s forward is ``flash_attention``'s output bit
    for bit (the kernel) and matches ``flash_attention_plain`` within
    ``TOL``; its grads of q, k and v match autograd through
    ``blockwise_attention`` within 2e-2 (bf16) or 1e-4 (f32) of each
    grad's largest |value|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import (
        FlashAttentionFn, blockwise_attention, q_to_kv_map)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v = (torch.randn((1, s, h, d), generator=gen, device=cuda)
               .to(dt).requires_grad_() for h in (hq, kv, kv))
    do = torch.randn((1, s, hq, d), generator=gen, device=cuda).to(dt)
    before = fa.flash_attention.launches
    o = FlashAttentionFn.apply(q, k, v, True, window, 512, 512)
    assert fa.flash_attention.launches == before + 1
    assert torch.equal(o, fa.flash_attention(q.detach(), k.detach(),
                                             v.detach(), window=window))
    plain = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                  window=window)
    torch.testing.assert_close(o.detach().float(), plain.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    del plain
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = blockwise_attention(q, k, v, kv_map=q_to_kv_map(hq, hq, kv, cuda),
                              window=window, q_block=512, kv_block=512)
    want = torch.autograd.grad(ref, (q, k, v), do)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for name, a, b in zip("qkv", got, want):
        assert a is not None and a.dtype == dt
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_gqa_attention_under_grad_gives_projection_grads_on_card(cuda):
    """A training forward through ``gqa_attention`` on the card (the
    kernel, whose output alone has no ``grad_fn``) gives wq, wk and wv
    gradients, equal to the CPU's plain path within 1e-4 at f32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import gqa_attention
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"),
                              dtype="float32", param_dtype="float32")
    rcfg = RunConfig(attn_q_block=16, attn_kv_block=16)
    grads = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, device="cpu", seed=3).to(dev)
        attn = model.blocks[0]["attn"]
        ws = [attn[n].requires_grad_() for n in ("wq", "wk", "wv")]
        x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                        .manual_seed(4)).to(dev)
        before = fa.flash_attention.launches
        out = gqa_attention(attn, x, cfg, rcfg,
                            positions=torch.arange(40, device=dev))
        if dev == cuda:
            assert fa.flash_attention.launches == before + 1
        g = torch.autograd.grad(out.square().sum(), ws)
        assert all(t is not None for t in g)
        grads[str(dev)] = [t.cpu() for t in g]
    for name, a, b in zip(("wq", "wk", "wv"), grads["cuda"], grads["cpu"]):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(cuda):
    """Two plain train steps (grad accumulation 2) of llama's smoke config
    at f32 on the card, the kernel forward on every layer, against the
    same steps on the CPU: losses within 1e-5, parameters within 1% of a
    step (lr) absolute."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import make_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"),
                              dtype="float32", param_dtype="float32")
    rcfg = RunConfig(attn_q_block=16, attn_kv_block=16, grad_accum=2,
                     warmup_steps=1, learning_rate=1e-2)
    shape = ShapeConfig("t", 32, 4, "train")
    out = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, device="cpu", seed=5).to(dev)
        state = make_train_state(cfg, rcfg, model=model)
        step = make_train_step(cfg, rcfg)
        feed = for_model(cfg, shape, device=dev)
        before = fa.flash_attention.launches
        losses = []
        for i in range(2):
            state, m = step(state, feed.batch_at(i))
            losses.append(m["loss"].item())
        if dev == cuda:
            # forward and remat recompute, per layer and micro-batch
            assert fa.flash_attention.launches - before == \
                2 * cfg.num_layers * rcfg.grad_accum * 2
        out[str(dev)] = (losses, {n: p.detach().cpu() for n, p in
                                  state["params"].named_parameters()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, p in out["cuda"][1].items():
        err = (p - out["cpu"][1][n]).abs().max().item()
        assert err <= 0.01 * rcfg.learning_rate * 2, (n, err)


# ---------------------------------------------------------------------------
# the ssm, hybrid and encdec families in training; whisper's shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,causal", [
    (2, 1500, False),               # the encoder: bidirectional
    (8, 4, True),                   # the served prefill's cross-attention
    (2, 448, True),                 # the trained cross-attention
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_whisper_flash_shapes_on_card(cuda, b, s, causal, dtype):
    """Flash at whisper-small's heads (12/12, d 64) against 1500 frames:
    T not a multiple of any tile, and for the cross-attention the causal
    mask with S < T (position t sees frames 0..t)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, s, 12, 64), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((b, 1500, 12, 64), generator=gen, device=cuda)
            .to(dt) for _ in range(2))
    o = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,pos,dtype,cache_dtype", [
    (1500, (1499,) * 8, "bfloat16", "bfloat16"),     # the cross decode
    (1500, (1499,) * 8, "float32", "float32"),
    (1500, (1499,) * 8, "float32", "bfloat16"),
    (448, (4, 13, 22, 31, 40, 49, 58, 67), "bfloat16", "bfloat16"),
])
def test_whisper_decode_shapes_on_card(cuda, t, pos, dtype, cache_dtype):
    """Decode at group 1 (12/12 heads, d 64): whisper's cross decode over
    1500 frames at pos 1499, and its self decode over 448 slots."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    b = len(pos)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q = torch.randn((b, 12, 64), generator=gen,
                    device=cuda).to(getattr(torch, dtype))
    kc, vc = (torch.randn((b, t, 12, 64), generator=gen, device=cuda)
              .to(getattr(torch, cache_dtype)) for _ in range(2))
    o, m, l = decode_attention(q, kc, vc, p)
    ro, rm, rl = decode_attention_plain(q, kc, vc, p)
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,shape", [
    (16, (256, 32, 64, 128)),       # mamba2-370m, a 4,096-token sequence
    (32, (128, 50, 64, 16)),        # hymba-1.5b, the same
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_scan_fn_on_card(cuda, nc, shape, dtype):
    """``SsdScanFn``: the kernel forward (one launch, its four outputs bit
    for bit) and the plain version's VJP, against autograd straight
    through ``ssd_chunk_scan_plain`` on the same inputs and cotangents."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssm import SsdScanFn
    q, h, p, n = shape
    gen = torch.Generator(device=cuda).manual_seed(nc)
    dt = getattr(torch, dtype)
    dts = torch.nn.functional.softplus(
        torch.randn((1, nc, q, h), generator=gen, device=cuda))
    xdt = (torch.randn((1, nc, q, h, p), generator=gen, device=cuda) * 0.5
           * dts[..., None]).to(dt).requires_grad_()
    dA = (-dts).requires_grad_()
    B, C = (torch.randn((1, nc, q, n), generator=gen, device=cuda)
            .mul(0.5).to(dt).requires_grad_() for _ in range(2))
    before = ss.ssd_chunk_scan.launches
    outs = SsdScanFn.apply(xdt, dA, B, C)
    assert ss.ssd_chunk_scan.launches == before + 1
    kern = ss.ssd_chunk_scan(xdt.detach(), dA.detach(), B.detach(),
                             C.detach(), out_dtype=torch.float32,
                             state_decay=True)
    for a, b in zip(outs, kern):
        assert torch.equal(a.detach(), b)
    plain = ssd_chunk_scan_plain(xdt, dA, B, C, out_dtype=torch.float32,
                                 state_decay=True)
    cots = [torch.randn(o.shape, generator=gen, device=cuda) for o in outs]
    got = torch.autograd.grad(outs, (xdt, dA, B, C), cots)
    want = torch.autograd.grad(plain, (xdt, dA, B, C), cots)
    for name, a, b in zip(("xdt", "dA", "B", "C"), got, want):
        assert a.dtype == b.dtype
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        assert err <= 1e-6, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_one_layer_ssm_and_hybrid_get_grads_on_card(cuda, arch):
    """One full-width layer of mamba2-370m and of hymba-1.5b (bf16, 512
    tokens) trained on the card: the SSD scan kernel launches under
    autograd and ``A_log``, ``dt_bias`` and the ``w_x``/``w_B``/``w_C``/
    ``w_dt`` projections get finite, non-zero gradients."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.train.train_loop import loss_fn
    cfg = dataclasses.replace(get_config(arch), num_layers=1,
                              global_attn_layers=())
    model = init_params(cfg, device=cuda, seed=6)
    gen = torch.Generator(device=cuda).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    ssm = model.blocks[0]["ssm"]
    names = ("A_log", "dt_bias", "w_x", "w_B", "w_C", "w_dt")
    leaves = [ssm[n].requires_grad_() for n in names]
    before = ss.ssd_chunk_scan.launches
    loss, _ = loss_fn(model, batch, cfg, RunConfig(remat="none"))
    assert ss.ssd_chunk_scan.launches == before + 1
    grads = torch.autograd.grad(loss, leaves)
    for name, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), name
        assert g.abs().max().item() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_whisper_cross_attention_on_card(cuda, dtype):
    """whisper's cross-attention at its smoke config on the card against
    the CPU's plain path: at prefill (flash, causal, S 12 < T 24; also
    under grad through ``FlashAttentionFn``, the wq/wk/wv grads) and at
    decode (the decode kernel over the encoder cache at pos T - 1)."""
    from repro_torch.models.attention import gqa_attention
    cfg = get_smoke_config("whisper-small")
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn((2, 12, cfg.d_model), generator=gen).to(dt)
    enc = torch.randn((2, 24, cfg.d_model), generator=gen).to(dt)
    out = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, device="cpu", seed=9).to(dev)
        p = model.blocks[0]["cross"]
        ws = [p[n].requires_grad_() for n in ("wq", "wk", "wv")]
        pos = torch.arange(12, device=dev)
        o, kv = gqa_attention(p, h.to(dev), cfg, RunConfig(),
                              positions=pos, kv_x=enc.to(dev),
                              return_cache=True)
        g = torch.autograd.grad(o.float().square().sum(), ws)
        with torch.no_grad():
            d = gqa_attention(p, h[:, :1].to(dev), cfg, RunConfig(),
                              positions=pos[:2],
                              cache={"ck": kv["k"], "cv": kv["v"]},
                              cross_decode=True)
        out[str(dev)] = [t.detach().float().cpu() for t in (o, d, *g)]
    for name, a, b in zip(("prefill", "decode", "wq", "wk", "wv"),
                          out["cuda"], out["cpu"]):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= TOL[dtype], (name, err)


# ---------------------------------------------------------------------------
# the moe family: apply_moe and both smoke engines on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf", [0.5, 100.0])
def test_apply_moe_on_card_matches_cpu(cuda, arch, cf):
    """One moe layer of the f32 smoke config on (4, 64) tokens: the
    routing and the dispatch tables equal to the integer (stable sorts,
    the same drops: capacity 65 of 512 assignments over 4 experts at
    0.5, none at 100), y and the four aux within 1e-5 of the CPU's."""
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, dtype="float32", param_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    model = init_params(cfg, device="cpu", seed=1)
    p_cpu = model.blocks[cfg.dense_layer_prefix]["moe"]
    p_card = init_params(cfg, device="cpu", seed=1).to(cuda).blocks[
        cfg.dense_layer_prefix]["moe"]
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    outs = []
    for p, dev in ((p_cpu, torch.device("cpu")), (p_card, cuda)):
        xf = x.reshape(-1, cfg.d_model).to(dev)
        gate, eidx, _ = moe.route_topk(p["router"], xf, cfg.moe)
        cap = moe._capacity(xf.shape[0], cfg.moe)
        tables = moe._dispatch_tables(eidx, gate, cfg.moe.num_experts, cap,
                                      xf.shape[0], cfg.moe.top_k)
        y, aux = moe.apply_moe(p, x.to(dev), cfg)
        outs.append((eidx.cpu(), [t.cpu() for t in tables[:2]], y.cpu(),
                     {k: v.cpu() for k, v in aux.items()}))
    (e0, t0, y0, a0), (e1, t1, y1, a1) = outs
    assert torch.equal(e0, e1)
    for a, b in zip(t0, t1):
        assert torch.equal(a, b)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    for k in moe.AUX_KEYS:
        torch.testing.assert_close(a1[k], a0[k], rtol=1e-5, atol=1e-6)
    assert (float(a0["moe_drop_frac"]) > 0) == (cf < 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_serve_engine_on_card_matches_cpu(cuda, arch):
    """The f32 smoke arctic (flash and decode at its 4/2 heads) and
    deepseek (MLA: its prefill through flash, padded to head dim 32; its
    decode plain) served on the card give the tokens and ledger the CPU
    gives from the same weights; 4 slots, so decode routes 4 tokens
    against a capacity of 3 and can drop."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 9, 16, 7, 30, 12)]

    def serve(device):
        model = init_params(cfg, device="cpu", seed=0).to(device)
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=64,
                          scheduler=sched, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant_id=i % 3, prompt=p, max_new_tokens=10,
                               req_id=i, arrival=0.0))
        k = 0
        while sched.pending() or any(s.active for s in eng.slots):
            k += 1
            eng.step(now=0.1 * k)
            assert k < 200
        return eng, ([(r.req_id, r.generated) for r in eng.completed],
                     dict(sched.served_tokens), sched.ledger())

    flash0, decode0 = flash_attention.launches, decode_attention.launches
    eng, on_card = serve(cuda)
    torch.cuda.synchronize()
    decode_layers = 0 if cfg.mla is not None else cfg.num_layers
    assert flash_attention.launches - flash0 == \
        cfg.num_layers * eng.admissions
    assert decode_attention.launches - decode0 == \
        decode_layers * eng.decode_steps
    _, on_cpu = serve(torch.device("cpu"))
    assert on_card == on_cpu


# ---------------------------------------------------------------------------
# the model axis: the per-rank kernel work of the sharded dense path
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(64, 8), (24, 8)])
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_cp_decode_shards_combine_to_one_launch_on_card(cuda, heads, window,
                                                        q_dtype):
    """A cache of 4 x 8,192 positions cut into tp contiguous chunks (each
    its own tensor): the decode kernel on every chunk at its local
    positions (negative before the chunk, where it gives the empty row:
    o 0, m NEG_INF, l 0), combined by ``stacked_lse_combine``, equals one
    launch over the whole cache and the plain version within 4.2e-3 of
    max |o| at bf16 and 1e-5 at f32; positions at 0 and at chunk - 1 and
    chunk of the tp 16 and tp 8 chunks."""
    from repro_torch.kernels.decode_attention import NEG_INF
    from repro_torch.models.attention import stacked_lse_combine
    hq, kv = heads
    b, t, d = 4, 8192, 128
    tol = {"bfloat16": 4.2e-3, "float32": 1e-5}[q_dtype]
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, hq, d), generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn((b, t, kv, d), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    pos_list = (0, 511, 512, 1024)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda)
    full = decode_attention(q, k, v, pos, window=window)[0]
    plain = decode_attention_plain(q, k, v, pos, window=window)[0]
    for tp in (2, 4, 8, 16):
        chunk = t // tp
        parts = []
        for r in range(tp):
            o, m, l = decode_attention(
                q, k[:, r * chunk:(r + 1) * chunk].contiguous(),
                v[:, r * chunk:(r + 1) * chunk].contiguous(),
                pos - r * chunk, window=window)
            for i, p in enumerate(pos_list):
                first = max(0, p - window + 1) if window else 0
                if p < r * chunk or first >= (r + 1) * chunk:
                    assert not o[i].any() and not l[i].any()
                    assert bool((m[i] == NEG_INF).all())
            parts.append((o, m, l))
        got = stacked_lse_combine(
            *(torch.stack(x) for x in zip(*parts))).to(q.dtype)
        torch.cuda.synchronize()
        for want in (full, plain):
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            assert err <= tol, (tp, err)


@pytest.mark.cuda
@pytest.mark.parametrize("tp,rank", [(2, 0), (2, 1), (4, 3), (8, 5),
                                     (16, 0), (16, 1), (16, 11), (16, 12)])
def test_flash_at_tp_rank_shapes_on_card(cuda, tp, rank):
    """llama3.2-3b's prefill at one rank's query heads (24 heads padded to
    the model axis) with the kv heads ``_local_kv`` gives them: against
    the plain version, and on the real heads against one launch over all
    24 heads, within bf16's 2e-2."""
    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.models.attention import _local_kv
    hq, kv, d, s = 24, 8, 128, 509
    g = torch.Generator(device=cuda).manual_seed(7)
    hp = padded_heads(hq, {"model": tp})
    n = hp // tp
    q = torch.randn((1, s, hp, d), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((1, s, kv, d), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    full = flash_attention(q[:, :, :hq].contiguous(), k, v)
    ql = q[:, :, rank * n:(rank + 1) * n].contiguous()
    kl, vl = _local_kv(k, v, hq, hp, rank * n, n)
    o = flash_attention(ql, kl, vl)
    torch.cuda.synchronize()
    assert (o.float() - flash_attention_plain(ql, kl, vl).float()
            ).abs().max().item() <= TOL["bfloat16"]
    real = max(0, min(n, hq - rank * n))
    if real:
        assert (o[:, :, :real].float() - full[:, :, rank * n:rank * n + real]
                .float()).abs().max().item() <= TOL["bfloat16"]


# ---------------------------------------------------------------------------
# the model axis: each rank's kernel work at the other families' shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("q,h,p,n", [
    (256, 16, 64, 128), (256, 8, 64, 128), (256, 4, 64, 128),
    (256, 2, 64, 128),                 # mamba2-370m's 32 heads at tp 2-16
    (128, 25, 64, 16)])                # hymba-1.5b's 50 heads at tp 2
def test_ssd_kernel_at_a_ranks_heads_on_card(cuda, q, h, p, n):
    """The SSD scan on one TP rank's heads at full width (2 chunks,
    bf16): one launch, within 2e-2 of the largest |y| and |state| of the
    plain version; the decays within 1e-5."""
    xdt, dA, B, C = _ssd_case(cuda, 1, 2, q, h, p, n, "bfloat16")
    before = ssd_chunk_scan.launches
    y, st, dec, sd = ssd_chunk_scan(xdt, dA, B, C, out_dtype=torch.float32,
                                    state_decay=True)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    ry, rst, rdec, rsd = ssd_chunk_scan_plain(
        xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)
    assert (y - ry).abs().max() <= 2e-2 * ry.abs().max()
    assert (st - rst).abs().max() <= 2e-2 * rst.abs().max()
    torch.testing.assert_close(dec, rdec, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sd, rsd, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", (2, 16))
def test_ring_chunks_combine_to_one_launch_on_card(cuda, tp):
    """hymba-1.5b's ring of 1,024 slots (8 rows, 25/5 heads, d 64, bf16)
    cut into ``tp`` contiguous chunks: the decode kernel on each chunk at
    the ring's last live slot minus the chunk's offset, with no window,
    combined by ``stacked_lse_combine``, against one launch over the whole
    ring and the plain version, within 2e-2 of max |o|; one launch a
    chunk."""
    from repro_torch.models.attention import ring_slots, \
        stacked_lse_combine
    gen = torch.Generator(device=cuda).manual_seed(9)
    n, hq, kv, d = 1024, 25, 5, 64
    q = torch.randn((8, hq, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((8, n, kv, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.tensor([0, 5, 700, 1023, 1024, 1300, 2047, 5000],
                       dtype=torch.int32, device=cuda)
    at = ring_slots(pos, n).pos_eff
    full = decode_attention(q, k, v, at)[0]
    plain = decode_attention_plain(q, k, v, at)[0]
    c = n // tp
    before = decode_attention.launches
    parts = [decode_attention(q, k[:, r * c:(r + 1) * c].contiguous(),
                              v[:, r * c:(r + 1) * c].contiguous(),
                              at - r * c) for r in range(tp)]
    assert decode_attention.launches == before + tp
    o = stacked_lse_combine(*(torch.stack(x) for x in zip(*parts))).to(
        q.dtype)
    for want in (full, plain):
        assert (o.float() - want.float()).abs().max() <= \
            2e-2 * want.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("tp", (2, 16))
def test_mla_prefill_at_a_ranks_heads_on_card(cuda, tp):
    """deepseek-v2-236b's MLA prefill on one TP rank's heads (128 / tp,
    dk 192, dv 128 padded to 192, group 1, causal, bf16, 1 x 512 tokens):
    one flash launch within ``TOL`` of the plain version."""
    from repro_torch.models.attention import _mla_prefill
    gen = torch.Generator(device=cuda).manual_seed(10)
    h = 128 // tp
    q, k = (torch.randn((1, 512, h, 192), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn((1, 512, h, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    scale = 192 ** -0.5
    before = flash_attention.launches
    with torch.no_grad():
        o = _mla_prefill(q, k, v, scale, RunConfig())
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = _mla_prefill(q, k, v, scale,
                            RunConfig(attention_impl="naive"))
    assert tuple(o.shape) == (1, 512, h, 128)
    assert (o.float() - want.float()).abs().max() <= \
        TOL["bfloat16"] * want.float().abs().max()


# ---------------------------------------------------------------------------
# training on the model axis
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_sharded_train_on_an_nccl_world_of_one(cuda):
    """``chip_smoke.py``'s sharded train path on the card at llama's smoke
    config (f32): two ``Runner`` steps on an NCCL world of one
    (``make_host_mesh(1, 1)``, the ``"2d"`` rules, FSDP gathers and TP
    collectives through the ``nk_*`` verbs) against the same steps
    unsharded on the CPU: losses within 1e-5, parameters within 1% of a
    step (lr) absolute, flash launched per layer, micro-batch and remat."""
    import importlib.util
    import pathlib
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import Runner
    from repro_torch.train.train_loop import train_ctx
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(get_smoke_config("llama3.2-3b"),
                              dtype="float32", param_dtype="float32")
    rcfg = RunConfig(attn_q_block=16, attn_kv_block=16, grad_accum=2,
                     warmup_steps=1, learning_rate=1e-2)
    shape = ShapeConfig("t", 32, 4, "train")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        r = Runner(cfg, rcfg, None, for_model(cfg, shape, device="cpu"),
                   d, device="cpu")
        r.init_state(model=init_params(cfg, device="cpu", seed=5))
        r.run(2)
        out["cpu"] = r
        with cs.world_of_one(torch, torch.device("cuda", 0)) as (shd, _):
            shd = train_ctx(shd.axes, rcfg)
            r = Runner(cfg, rcfg, shd, for_model(cfg, shape, device=cuda),
                       d + "/mesh", device=cuda)
            # the CPU's generator draws other values than the card's
            r.init_state(model=init_params(cfg, device="cpu", seed=5,
                                           shd=shd).to(cuda))
            before = fa.flash_attention.launches
            r.run(2)
            assert fa.flash_attention.launches - before == \
                2 * cfg.num_layers * rcfg.grad_accum * 2
            out["cuda"] = r
    assert not dist.is_initialized()
    np.testing.assert_allclose(
        [m["loss"] for m in out["cuda"].metrics_log],
        [m["loss"] for m in out["cpu"].metrics_log], rtol=1e-5)
    want = dict(out["cpu"].state["params"].named_parameters())
    for n, p in out["cuda"].state["params"].named_parameters():
        err = (p.detach().cpu() - want[n].detach()).abs().max().item()
        assert err <= 0.01 * rcfg.learning_rate * 2, (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("tp,rank", [(2, 0), (4, 3), (8, 5), (16, 1),
                                     (16, 12)])
def test_flash_under_autograd_at_tp_train_rank_shapes_on_card(cuda, tp,
                                                              rank):
    """``FlashAttentionFn`` (the kernel forward, the plain VJP) at one
    rank's query heads of llama3.2-3b's 4,096-token training sequence and
    the kv heads ``_local_kv`` gives them (rank 12 at tp 16: padded heads
    only): o, dq, dk and dv within bf16's 2e-2 of the plain forward and
    its autograd VJP."""
    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.models.attention import FlashAttentionFn, _local_kv
    hq, kv, d, s = 24, 8, 128, 4096
    g = torch.Generator(device=cuda).manual_seed(9)
    hp = padded_heads(hq, {"model": tp})
    n = hp // tp
    q = torch.randn((1, s, n, d), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((1, s, kv, d), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    kl, vl = _local_kv(k, v, hq, hp, rank * n, n)
    do = torch.randn((1, s, n, d), generator=g, device=cuda).to(
        torch.bfloat16)
    ins = [t.detach().requires_grad_() for t in (q, kl, vl)]
    before = flash_attention.launches
    o = FlashAttentionFn.apply(*ins, True, 0, 512, 512)
    assert flash_attention.launches - before == 1
    got = (o,) + torch.autograd.grad(o, ins, do)
    ref_in = [t.detach().requires_grad_() for t in (q, kl, vl)]
    ref_o = flash_attention_plain(*ref_in)
    want = (ref_o,) + torch.autograd.grad(ref_o, ref_in, do)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        assert err <= TOL["bfloat16"], (tp, rank, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case,tp,rank", [
    ("deepseek mla", 1, 0), ("deepseek mla", 2, 0),
    ("deepseek mla", 16, 15), ("arctic", 2, 1),
    ("arctic", 8, 7), ("arctic", 16, 14)])
def test_flash_under_autograd_at_moe_train_rank_shapes_on_card(cuda, case,
                                                               tp, rank):
    """``FlashAttentionFn`` at one TP train rank's heads of the moe
    family's 4,096-token training sequence: deepseek-v2-236b's MLA prefill
    (128 / tp heads, all 128 at tp 1 as one card trains it, each its own
    kv head, dk 192 with v zero-padded from
    128 as ``_mla_prefill`` pads it, the softmax scale 1/sqrt(192)) and
    arctic-480b's 56/8 (64 padded at tp 16: rank 14 holds only padded
    heads) over the kv heads ``_local_kv`` gives them: o, dq, dk and dv
    within bf16's 2e-2 of the plain forward and its autograd VJP."""
    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.models.attention import FlashAttentionFn, _local_kv
    s, bf = 4096, torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(bf)

    if case == "deepseek mla":
        n, d, dv = 128 // tp, 192, 128
        q, k = randn(1, s, n, d), randn(1, s, n, d)
        v = torch.nn.functional.pad(randn(1, s, n, dv), (0, d - dv))
        do = torch.nn.functional.pad(randn(1, s, n, dv), (0, d - dv))
    else:
        hq, kv, d = 56, 8, 128
        hp = padded_heads(hq, {"model": tp})
        n = hp // tp
        q = randn(1, s, n, d)
        k, v = _local_kv(randn(1, s, kv, d), randn(1, s, kv, d), hq, hp,
                         rank * n, n)
        do = randn(1, s, n, d)
    scale = d ** -0.5
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    o = FlashAttentionFn.apply(*ins, True, 0, 512, 512, scale)
    assert flash_attention.launches - before == 1
    got = (o,) + torch.autograd.grad(o, ins, do)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_o = flash_attention_plain(*ref_in, scale=scale)
    want = (ref_o,) + torch.autograd.grad(ref_o, ref_in, do)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        assert err <= TOL["bfloat16"], (case, tp, rank, name, err)
