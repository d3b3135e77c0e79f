#!/usr/bin/env python3
"""Time the port's water-fill kernel of one source tree on the card.

    python3 tools/waterfill_ab.py [--src DIR] [--label NAME] [--flush MODE]
                                  [--levels FILE]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
that two trees can be compared on one card in one call, in turns (parent,
change, change, parent): each run is its own process, since both trees
name their package ``repro_torch``. The tree's kernels are built into its
own ``build/kernels``.

Sizes are ``chip_smoke.py``'s timings phase: the fairness and replay
phases' 3- and 4-tenant problems and the fused tick's populations (1k,
10k, 100k, 1M tenants), f64, on the inputs of ``chip_smoke.water_case``.
Device ms per call: ``chip_smoke.Timer`` (CUDA events around one launch,
the L2 flushed, the host's enqueue hidden), median of 20; ``--flush
write`` (the default, as ``chip_smoke.py``) or ``read`` (a clean L2).
Host µs per call: ``chip_smoke.host_us``.

``--levels FILE`` keeps each run's levels (as hex floats, by label) in a
JSON file: a run reports, for every other label already there, whether
its level at each n equals that run's bit for bit. That is reported, not
required: two designs may sum in other orders. Prints one JSON object per
size with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the timing helpers; stdlib imports only)

SIZES = chip_smoke.WATER_TIMED_SMALL + chip_smoke.CONTROL_N


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    ap.add_argument("--levels", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("waterfill_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.waterfill import water_fill
    build.library()
    smi = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev, flush=args.flush)
    path = Path(args.levels) if args.levels else None
    book = json.loads(path.read_text()) if path and path.exists() else {}
    mine = {}
    for n in SIZES:
        d, w, cap = chip_smoke.water_case(np, n, seed=n)
        dd, ww = (torch.tensor(x, dtype=torch.float64, device=dev)
                  for x in (d, w))
        call = lambda: water_fill(dd, ww, cap)   # noqa: E731
        level = float(call()[1])
        mine[str(n)] = level.hex()
        same = {label: levels[str(n)] == level.hex()
                for label, levels in book.items()
                if label != args.label and str(n) in levels}
        print(json.dumps({
            "label": args.label, "src": args.src, "flush": args.flush,
            "kernel": "water_fill", "n": n, "dtype": "float64",
            "ms": timer.ms(call), "host_us": chip_smoke.host_us(torch, call),
            "level": level, "same_level_as": same, "gpu": smi}), flush=True)
    if path:
        book[args.label] = mine
        path.write_text(json.dumps(book, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
