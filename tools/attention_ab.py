#!/usr/bin/env python3
"""Time the port's two attention kernels of one source tree on the card.

    python3 tools/attention_ab.py [--src DIR] [--label NAME] [--flush MODE]
                                  [--shapes SET]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
that two trees can be compared on one card in one call, in turns (parent,
change, change, parent): each run is its own process, since both trees
name their package ``repro_torch``. The tree's kernels are built into its
own ``build/kernels``.

Shapes (``--shapes``) are ``chip_smoke.py``'s timings phase: ``llama``
(the default), flash attention at B 1, S = T in {64, 509, 1024}, 24/8
heads, D 128, bf16, causal; decode attention at B 8, T 1024, 24/8 heads,
D 128, bf16, with the positions mixed, full, and spread over the serving
phase's live range (64-544); or ``d192``, head dim 192: flash at S 509
with nemotron-4-340b's 96/8 heads and with DeepSeek-V2's MLA prefill at
128/128 (v zero-padded from 128), decode at group 12 (96/8 heads) at the
same three position sets; or ``whisper_f32``, flash in f32 (the
``tf32x3`` route) at whisper-small's two trained shapes (the encoder: B
4, S = T 1500, 12/12 heads, D 64, bidirectional; the cross-attention: S
448 against T 1500, causal), at the encoder's TP train ranks' heads (6,
3, 2 and 1 at tp 2, 4, 8 and 16) and at D 128 (S 509, 24/8 heads,
causal), each with its plain version's time, ``scaled_dot_product_attention``'s
on its own choice of backend, and its bound at the tree's route (the
tensor cores' f32 rate for ``tf32x3``) and at the CUDA cores' f32 rate;
no decode.
Device ms per call: ``chip_smoke.Timer`` (CUDA events around one launch,
the L2 flushed, the host's enqueue hidden), median of 20; ``--flush
write`` (the default, as ``chip_smoke.py``) or ``read`` (a clean L2).
Host µs per call: ``chip_smoke.host_us``, the wrapper's enqueue alone.
Prints one JSON object per shape with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the timing helpers; stdlib imports only)

# (label, B, S, T, HQ, KV, D, v columns, causal, dtype) of each flash
# shape, and (HQ, KV, D) of decode (None: no decode), per shape set
SHAPES = {
    "llama": ([(f"S{s}", 1, s, s, 24, 8, 128, 128, True, "bfloat16")
               for s in (64, 509, 1024)], (24, 8, 128)),
    "d192": ([("nemotron", 1, 509, 509, 96, 8, 192, 192, True, "bfloat16"),
              ("mla", 1, 509, 509, 128, 128, 192, 128, True, "bfloat16")],
             (96, 8, 192)),
    "whisper_f32": (
        [("encoder_train", 4, 1500, 1500, 12, 12, 64, 64, False, "float32"),
         ("cross_train", 4, 448, 1500, 12, 12, 64, 64, True, "float32")]
        + [(f"encoder_train_tp{tp}", 4, 1500, 1500, n, n, 64, 64, False,
            "float32") for tp, n in ((2, 6), (4, 3), (8, 2), (16, 1))]
        + [("d128", 1, 509, 509, 24, 8, 128, 128, True, "float32")], None),
}
DECODE_B, DECODE_T = 8, 1024
DECODE_POS = {
    "mixed": (0, 1, 17, 255, 511, 700, 1022, 1023),
    "full": (DECODE_T - 1,) * DECODE_B,
    "serve": (64, 132, 201, 269, 338, 406, 475, 544),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="llama")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    # the tree's route table; a tree from before it ran f32 on SIMT
    route = getattr(fa, "route", lambda dtype, d: "simt")
    build.library()
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch, dev, flush=args.flush)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash_shapes, dec = SHAPES[args.shapes]
    for name, b, s, t, fq, fkv, fd, dv, causal, dt in flash_shapes:
        dtype = getattr(torch, dt)
        q, k, v = (randn(b, n, h, fd, dtype=dtype)
                   for n, h in ((s, fq), (t, fkv), (t, fkv)))
        v[..., dv:] = 0
        call = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        row = {"label": args.label, "src": args.src, "flush": args.flush,
               "kernel": "flash_attention", "shape": name, "B": b, "S": s,
               "T": t, "hq": fq, "kv": fkv, "d": fd, "causal": causal,
               "dtype": dt, "ms": timer.ms(call),
               "host_us": chip_smoke.host_us(torch, call), "gpu": smi}
        if dt == "float32":
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            nbytes, flops = chip_smoke.flash_work(b, s, t, fq, fkv, fd, 4,
                                                  causal, 0)
            row.update(
                plain_ms=timer.ms(lambda: flash_attention_plain(
                    q, k, v, causal=causal), reps=5),
                **chip_smoke.library_row(torch, timer, qt, kt, vt,
                                         is_causal=causal,
                                         enable_gqa=fq != fkv),
                bound_ms=chip_smoke.bound(nbytes, flops, dt,
                                          route(dtype, fd))[0],
                bound_ms_f32_cuda_cores=chip_smoke.bound(nbytes, flops,
                                                         dt)[0],
                route=route(dtype, fd))
        print(json.dumps(row), flush=True)
    if dec is None:
        return 0
    hq, kv, d = dec
    q = randn(DECODE_B, hq, d)
    kc, vc = (randn(DECODE_B, DECODE_T, kv, d) for _ in range(2))
    for name, pos_list in DECODE_POS.items():
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        call = lambda: decode_attention(q, kc, vc, pos)   # noqa: E731
        print(json.dumps({
            "label": args.label, "src": args.src, "flush": args.flush,
            "kernel": "decode_attention", "pos": name, "hq": hq,
            "kv": kv, "d": d,
            "ms": timer.ms(call),
            "host_us": chip_smoke.host_us(torch, call), "gpu": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
