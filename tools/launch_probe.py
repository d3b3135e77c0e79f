#!/usr/bin/env python3
"""``chip_smoke.py``'s launch phase alone, without the phases it reads.

    python3 tools/launch_probe.py [--out FILE] [--pairs N]

Builds the kernels, prints the dry run's table (every cell on 16x16 and
2x16x16, one rank's shard on the meta device), makes ``LAUNCH_CELLS`` on
the card (the rise in ``memory_allocated`` against each meta count), and
runs ``remat_dots_vs_full`` ``--pairs`` times (llama3.2-3b at 4 layers,
one 4,096-token micro-batch under remat "full" then "dots"; default 2).
The roofline floors need the serve and train phases' medians and run in
``chip_smoke.py`` only. One JSON object a line goes to stdout and to
``--out``; the card's name and power limit come first. About two minutes
after the build. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    emit = chip_smoke.emit
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def kept(obj):
        """Each line to stdout and, as it comes, to ``--out``."""
        emit(obj)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(obj, default=str) + "\n")

    chip_smoke.emit = kept
    t0 = time.perf_counter()
    kept({"probe": "device", "nvidia_smi": chip_smoke.nvidia_smi(),
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "total_memory": torch.cuda.get_device_properties(0).total_memory})
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.library()
    kept({"probe": "build", "seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    chip_smoke.launch_table()
    kept({"probe": "table", "seconds": time.perf_counter() - t1})
    for arch, shape in chip_smoke.LAUNCH_CELLS:
        chip_smoke.materialise_cell(torch, device, arch, shape)
    for _ in range(args.pairs):
        chip_smoke.remat_dots_vs_full(torch, device,
                                      get_config("llama3.2-3b"))
    kept({"probe": "seconds", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
