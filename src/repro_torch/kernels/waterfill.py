"""Weighted max-min water-fill: the CUDA kernel and its plain version.

The kernel (``csrc/waterfill.cu``) replaces the Pallas TPU kernel
``repro/kernels/waterfill.py::water_fill_pallas``; its header says what
bounds it on the H100 (the dependent global sums of the bisection, not
bytes or flops) and how the design answers that: each reduction decides
several bisection steps at once. Both versions compute the same function:
slots with demand <= 0 or weight <= 0 are parked at 0, ``inf`` demand is
greedy, and ``iters`` bisection steps on the common level L of
``S(L) = sum w * min(d / w, L)`` run over ``[0, cap / max(min_w, 1e-30)]``;
a slot whose ratio is at or under the final level takes its demand, the
rest ``w * level``.

``water_fill`` takes the plain PyTorch version only for tensors on the CPU
(the CPU tests, ``device="cpu"`` planes). On CUDA tensors it launches the
kernel or raises; it never falls back. ``water_fill.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float64: build.DT_F64, torch.float32: build.DT_F32}
# scratch of the cooperative launch, at most one block per SM: one
# minimum and PASS_BUFFERS buffers of up to 32 node sums per block. A pass
# takes a buffer no earlier pass of its launch used, so it needs no memory
# fence, up to PASS_BUFFERS passes (48 steps take 10-16 on that path);
# more passes reuse them, each behind a fence
PASS_BUFFERS = 32
SCRATCH_PER_SM = 1 + 32 * PASS_BUFFERS


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_scratch = {}


def _part(index: int, stream) -> torch.Tensor:
    """The cooperative launch's partial sums for launches on ``stream`` of
    card ``index`` (f64, wide enough for either dtype). One buffer per
    (card, stream): launches on one stream run in order, so a launch never
    shares it with one in flight, and it is made on that same stream (the
    allocator hands its memory only to later work there). Its contents
    need no initialisation: a launch writes every partial it reads."""
    key = (index, stream.cuda_stream)
    have = _scratch.get(key)
    if have is None:
        with torch.cuda.stream(stream):
            have = torch.empty(SCRATCH_PER_SM * _sm_count(index),
                               dtype=torch.float64,
                               device=torch.device("cuda", index))
        _scratch[key] = have
    return have


def _capacity(capacity, like: torch.Tensor) -> torch.Tensor:
    """``capacity`` (a number or a one-element tensor) as a one-element
    tensor of ``like``'s dtype on its device."""
    if isinstance(capacity, torch.Tensor):
        if capacity.numel() != 1:
            raise ValueError(f"capacity must be a scalar, got shape "
                             f"{tuple(capacity.shape)}")
        return capacity.reshape(1).to(device=like.device, dtype=like.dtype)
    return torch.full((1,), float(capacity), dtype=like.dtype,
                      device=like.device)


_caps = {}
CAPS_KEPT = 256


def _capacity_on(capacity, like: torch.Tensor, index: int, stream):
    """``capacity`` as a one-element tensor on ``like``'s card. A number
    is kept per (card, stream, dtype, value) and made on that stream, so
    a call with a capacity seen before enqueues no fill ahead of the
    kernel; the kernel only reads it."""
    if isinstance(capacity, torch.Tensor):
        return _capacity(capacity, like).contiguous()
    key = (index, stream.cuda_stream, like.dtype, float(capacity).hex())
    have = _caps.get(key)
    if have is None:
        if len(_caps) >= CAPS_KEPT:
            _caps.clear()
        with torch.cuda.stream(stream):
            have = _capacity(capacity, like)
        _caps[key] = have
    return have


def water_fill_plain(demands, weights, capacity, *, iters: int = 48):
    """The kernel's function in plain PyTorch: ``(alloc (n,), level ())``
    in the demands' dtype, the bisection's sums in that dtype."""
    d = demands
    w = weights.to(d.dtype)
    cap = _capacity(capacity, d)[0]
    active = (d > 0) & (w > 0)
    w = torch.where(active, w, 0.0)
    r = torch.where(active, d / torch.where(active, w, 1.0), 0.0)
    min_w = torch.where(active, w, math.inf).amin() if d.numel() \
        else torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    hi = torch.where(torch.isfinite(min_w), cap / min_w.clamp_min(1e-30),
                     0.0)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        over = (w * torch.minimum(r, mid)).sum() > cap
        lo, hi = torch.where(over, lo, mid), torch.where(over, mid, hi)
    alloc = torch.where(active, torch.where(r <= hi, d, w * hi), 0.0)
    return alloc, hi


def _check(d: torch.Tensor, w: torch.Tensor, iters: int) -> None:
    if d.device != w.device:
        raise ValueError("demands and weights must be on one device")
    if d.dtype != w.dtype or d.dtype not in DTYPES:
        raise TypeError(f"demands and weights must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {d.dtype}, "
                        f"{w.dtype}")
    if d.dim() != 1 or d.shape != w.shape:
        raise ValueError(f"want demands and weights of one shape (n,), got "
                         f"{tuple(d.shape)}, {tuple(w.shape)}")
    if not (d.is_contiguous() and w.is_contiguous()):
        raise ValueError("demands and weights must be contiguous")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def water_fill(demands, weights, capacity, *, iters: int = 48):
    """demands, weights: (n,); capacity: a number or a one-element tensor
    -> ``(alloc (n,), level ())``. On CPU tensors this is
    ``water_fill_plain``; on CUDA tensors it launches the kernel on the
    current stream (one launch, no synchronisation)."""
    if demands.device.type == "cpu":
        return water_fill_plain(demands, weights, capacity, iters=iters)
    if demands.device.type != "cuda":
        raise ValueError(f"water_fill runs on cuda or cpu, not "
                         f"{demands.device}")
    _check(demands, weights, iters)
    n = demands.shape[0]
    alloc = torch.empty_like(demands)
    if n == 0:
        return alloc, torch.zeros((), dtype=demands.dtype,
                                  device=demands.device)
    level = torch.empty(1, dtype=demands.dtype, device=demands.device)
    dev = demands.device.index if demands.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(demands.device)
    cap = _capacity_on(capacity, demands, dev, stream)
    part = _part(dev, stream)
    part_len = part.numel() * part.element_size() // demands.element_size()
    rc = build.library().nk_water_fill(
        demands.data_ptr(), weights.data_ptr(), cap.data_ptr(),
        alloc.data_ptr(), level.data_ptr(), part.data_ptr(), n, int(iters),
        part_len, DTYPES[demands.dtype], dev, stream.cuda_stream)
    build.check(rc, "water_fill")
    water_fill.launches += 1
    return alloc, level[0]


water_fill.launches = 0
