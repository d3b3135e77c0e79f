#!/usr/bin/env python3
"""Time the port's SSD scan kernel of one source tree on the card.

    python3 tools/ssd_ab.py [--src DIR] [--label NAME] [--flush MODE]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
that two trees can be compared on one card in one call, in turns (parent,
change, change, parent): each run is its own process, since both trees
name their package ``repro_torch``. The tree's kernels are built into its
own ``build/kernels``.

Shapes are ``chip_smoke.py``'s: mamba2-370m's width (Q 256, H 32, P 64,
N 128), bf16 in, f32 y, one sequence of 1, 2 and 16 chunks (a 256-, 512-
and 4,096-token prompt), the inputs of ``chip_smoke.ssd_inputs``. The call
is the reference-shaped three-output one, which every tree takes. Device
ms per call: ``chip_smoke.Timer`` (CUDA events around one launch, the L2
flushed, the host's enqueue hidden), median of 20; ``--flush write`` (the
default, as ``chip_smoke.py``) or ``read`` (a clean L2). Prints one JSON
object per shape with the card's name and power limit. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the timing helpers; stdlib imports only)

CHUNKS = (1, 2, 16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    build.library()
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.Timer(torch, dev, flush=args.flush)
    for nc in CHUNKS:
        xdt, dA, B, C = chip_smoke.ssd_inputs(torch, gen, dev, nc,
                                              "bfloat16")
        call = lambda: ssd_chunk_scan(   # noqa: E731
            xdt, dA, B, C, out_dtype=torch.float32)
        print(json.dumps({
            "label": args.label, "src": args.src, "flush": args.flush,
            "kernel": "ssd_chunk_scan", "nc": nc,
            "tokens": nc * chip_smoke.SSD_Q,
            "ms": timer.ms(call), "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
