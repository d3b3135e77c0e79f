"""Blockwise symmetric int8 codec: the CUDA kernels and their plain version.

The kernels (``csrc/quant_comm.cu``) replace the Pallas TPU kernels
``repro/kernels/quant_comm.py::quantize_int8`` and ``dequantize_int8``; the
source's header says what bounds them on the H100 (bytes) and how the
design answers that. Both versions compute, to the bit, what the reference
computes under jit: one f32 scale per (row, ``block`` columns),
``absmax_scale(max |x|)``, codes ``clamp(round(x / scale), -127, 127)``
(IEEE division, round half to even), and back ``q * scale`` in f32, cast
to the output dtype.

``quantize_int8`` and ``dequantize_int8`` take the plain PyTorch version
only for tensors on the CPU (the CPU tests). On CUDA tensors they launch
the kernel or raise; they never fall back. ``.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCKS = (128, 256)
DTYPES = {torch.float32: build.DT_F32, torch.bfloat16: build.DT_BF16}
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of an f32 absmax: ``max(absmax, 1e-30)``
    times ``float32(1/127)``. The reference writes ``/ 127.0``, and XLA
    compiles that division by a constant into this multiply; a true
    division differs in the last bit for ~5% of values, which moves
    codes."""
    return absmax.float().clamp_min(1e-30) * INV_127


def quantize_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The codec's rounding rule: ``clamp(round(x / scale), -127, 127)``
    as int8, an IEEE division then round half to even. ``scale`` broadcasts
    against ``x``: one per block here, one global scale in
    ``core/compression.py``."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_scaled(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)


def _blocks(shape, block: int):
    if len(shape) != 2 or block not in BLOCKS or shape[1] % block:
        raise ValueError(f"want (R, C) with C % block == 0 and block in "
                         f"{BLOCKS}; got {tuple(shape)}, block {block}")
    r, c = shape
    return r, c, c // block


def quantize_int8_plain(x: torch.Tensor, *, block: int = 256):
    """The kernel's function in plain PyTorch: x (R, C) ->
    (q int8 (R, C), scales f32 (R, C / block))."""
    r, c, nblk = _blocks(x.shape, block)
    xb = x.float().reshape(r, nblk, block)
    scale = absmax_scale(xb.abs().amax(dim=-1))
    return quantize_scaled(xb, scale[..., None]).reshape(r, c), scale


def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor, *,
                          block: int = 256, dtype=torch.float32):
    """``q * scale`` per block in f32, cast to ``dtype``."""
    r, c, nblk = _blocks(q.shape, block)
    return dequantize_scaled(q.reshape(r, nblk, block), scales[..., None],
                             dtype).reshape(r, c)


def codec_error_bound(x: torch.Tensor, scales: torch.Tensor,
                      x_hat: torch.Tensor, *, block: int = 256
                      ) -> torch.Tensor:
    """Elementwise bound on ``|x_hat - x|`` for one round trip of ``x``
    (R, C) at ``scales`` (R, C / block), ``x_hat`` in f32 or bf16.

    With u = 2^-24 and s a block's scale: y = fl(x / s) = (x / s)(1 + d1),
    q = rint(y) with |q - y| <= 1/2 (no clipping: |x / s| <= 127 (1 + 2u)),
    and x_hat = fl(q s) = q s (1 + d2), |d1|, |d2| <= u. So
    |x_hat - x| <= s/2 + u |x| + u |q s| <= s/2 + u absmax + 2u |x_hat|;
    a bf16 ``x_hat`` adds its rounding, at most 2^-8 |x_hat|. The bound
    takes 2^-22 |x_hat| for the last f32 term, which also covers |q s|
    against a bf16 |x_hat|."""
    r, c, nblk = _blocks(x.shape, block)
    xf = x.float().reshape(r, nblk, block)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    mag = x_hat.float().abs().reshape(r, nblk, block)
    bound = scales.float()[..., None] / 2 + absmax * 2.0 ** -24 \
        + mag * 2.0 ** -22
    if x_hat.dtype == torch.bfloat16:
        bound = bound + mag * 2.0 ** -8
    return bound.reshape(r, c)


def _check(name: str, t: torch.Tensor, dtypes, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on cuda, not {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {sorted(map(str, dtypes))},"
                        f" got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_args(t: torch.Tensor):
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def quantize_int8(x: torch.Tensor, *, block: int = 256):
    """x (R, C), f32 or bf16, C % block == 0, block 128 or 256 ->
    (q int8 (R, C), scales f32 (R, C / block)). On CPU tensors this is
    ``quantize_int8_plain``; on CUDA tensors one kernel launch on the
    current stream, no synchronisation."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, block=block)
    r, c, nblk = _blocks(x.shape, block)
    _check("x", x, DTYPES, (r, c))
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((r, nblk), dtype=torch.float32, device=x.device)
    if r == 0 or c == 0:
        return q, scales
    dev, stream = _launch_args(x)
    rc = build.library().nk_quantize_int8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), r, c, block,
        DTYPES[x.dtype], dev, stream)
    build.check(rc, "quantize_int8")
    quantize_int8.launches += 1
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, *,
                    block: int = 256, dtype=torch.float32):
    """q int8 (R, C), scales f32 (R, C / block) -> (R, C) in ``dtype``
    (f32 or bf16). On CPU tensors this is ``dequantize_int8_plain``; on
    CUDA tensors one kernel launch on the current stream."""
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, scales, block=block, dtype=dtype)
    r, c, nblk = _blocks(q.shape, block)
    _check("q", q, {torch.int8: None}, (r, c))
    _check("scales", scales, {torch.float32: None}, (r, nblk))
    if dtype not in DTYPES:
        raise TypeError(f"dtype must be one of {sorted(map(str, DTYPES))},"
                        f" got {dtype}")
    out = torch.empty((r, c), dtype=dtype, device=q.device)
    if r == 0 or c == 0:
        return out
    dev, stream = _launch_args(q)
    rc = build.library().nk_dequantize_int8(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), r, c, block,
        DTYPES[dtype], dev, stream)
    build.check(rc, "dequantize_int8")
    dequantize_int8.launches += 1
    return out


quantize_int8.launches = 0
dequantize_int8.launches = 0
