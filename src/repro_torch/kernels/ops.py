"""Public wrappers for the ported kernels, in the reference's layouts.

The counterpart of ``repro/kernels/ops.py``: the same signatures and
``(B, H, S, d)`` / ``(B, H, d)`` / ``(nb, nc, Q, H, P)`` / ``(n,)`` /
``(R, C)`` layouts, with ``impl="ref"`` running the oracle and
``impl="kernel"`` the hand-written kernel (on CPU tensors, its plain
version). Model and control code call the kernels directly; these wrappers
are the kernel-level test surface, and ``quantize``/``dequantize`` the
codec's entry points, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_comm import (
    dequantize_int8, dequantize_int8_plain, quantize_int8, quantize_int8_plain)
from repro_torch.kernels.ssd_scan import ssd_chunk_scan
from repro_torch.kernels.waterfill import water_fill as _water_fill

IMPLS = ("ref", "kernel")


def _impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def mha_forward(q, k, v, *, causal=True, window=0, impl="kernel"):
    """q,k,v: (B, H, S, d) -> (B, H, S, d)."""
    if _impl(impl) == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=causal, window=window)
    return o.transpose(1, 2)


def decode_step_attention(q, k, v, pos, *, impl="kernel"):
    """q: (B,H,d); k,v: (B,T,H,d); pos: (B,). Returns (o, m, l)."""
    if _impl(impl) == "ref":
        return ref.decode_attention_ref(q, k, v, pos)
    return decode_attention(q, k.contiguous(), v.contiguous(),
                            pos.to(dtype=torch.int32))


def ssd_intra_chunk(xdt, dA, B, C, *, impl="kernel"):
    """(nb, nc, Q, H, P) SSD intra-chunk. Returns (y, states, decay)."""
    if _impl(impl) == "ref":
        outs = [[ref.ssd_chunk_ref(xdt[i, j], dA[i, j], B[i, j], C[i, j])
                 for j in range(xdt.shape[1])] for i in range(xdt.shape[0])]
        return tuple(torch.stack([torch.stack([o[k] for o in row])
                                  for row in outs]) for k in range(3))
    return ssd_chunk_scan(xdt.contiguous(), dA, B.contiguous(),
                          C.contiguous())


def quantize(x, *, block=256, impl="kernel"):
    """x (R, C), C % block == 0 -> (q int8 (R, C), scales f32 (R, C/block))."""
    if _impl(impl) == "ref":
        return quantize_int8_plain(x, block=block)
    return quantize_int8(x, block=block)


def dequantize(q, scales, *, block=256, impl="kernel", dtype=torch.float32):
    if _impl(impl) == "ref":
        return dequantize_int8_plain(q, scales, block=block, dtype=dtype)
    return dequantize_int8(q, scales, block=block, dtype=dtype)


def water_fill(demands, weights, capacity, *, impl="kernel", iters=48):
    """demands, weights: (n,); capacity scalar -> alloc (n,).

    Weighted max-min water-fill over the whole tenant population.
    ``impl="ref"`` is the exact sort-based progressive fill;
    ``impl="kernel"`` the fixed-iteration bisection kernel."""
    if _impl(impl) == "ref":
        return ref.water_fill_ref(demands, weights, capacity)
    return _water_fill(demands, weights, capacity, iters=iters)[0]
