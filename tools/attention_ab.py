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
same three position sets.
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

# (label, S, HQ, KV, D, v columns) of each flash shape, and (HQ, KV, D)
# of decode, per shape set
SHAPES = {
    "llama": ([(f"S{s}", s, 24, 8, 128, 128) for s in (64, 509, 1024)],
              (24, 8, 128)),
    "d192": ([("nemotron", 509, 96, 8, 192, 192),
              ("mla", 509, 128, 128, 192, 128)], (96, 8, 192)),
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
    from repro_torch.kernels.flash_attention import flash_attention
    build.library()
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch, dev, flush=args.flush)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    flash_shapes, (hq, kv, d) = SHAPES[args.shapes]
    for name, s, fq, fkv, fd, dv in flash_shapes:
        q, k, v = randn(1, s, fq, fd), randn(1, s, fkv, fd), \
            randn(1, s, fkv, fd)
        v[..., dv:] = 0
        call = lambda: flash_attention(q, k, v)   # noqa: E731
        print(json.dumps({
            "label": args.label, "src": args.src, "flush": args.flush,
            "kernel": "flash_attention", "shape": name, "S": s,
            "hq": fq, "kv": fkv, "d": fd, "ms": timer.ms(call),
            "host_us": chip_smoke.host_us(torch, call), "gpu": smi}),
              flush=True)
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
