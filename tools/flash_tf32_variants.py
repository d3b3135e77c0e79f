#!/usr/bin/env python3
"""Time variants of the f32 flash kernel (``flash_fwd_tf32x3``) on the card.

    python3 tools/flash_tf32_variants.py --set {sweep,ablate} [--turns N]
                                         [--out FILE]

Each variant is a copy of this checkout's ``src/repro_torch`` under
``build/flash_tf32_variants/<name>/src`` with ``csrc/flash_attention.cu``
edited as ``VARIANTS`` says (an edit whose text is not found stops the
tool: the table follows the source). The copies are built in parallel,
then ``tools/attention_ab.py --shapes whisper_f32`` times each in turns,
``--turns`` passes forward and back (base first). Prints one JSON object
per timed shape and a median per (variant, shape), with the card's name
and power limit.

* ``sweep``: the kv tile rows and v stages at D 64 (``base``: 32 rows, 2 k
  and 2 v stages, two blocks an SM; ``v1``: 1 v stage; ``bn64``: 64 rows,
  one block an SM; ``bn64v1``).
* ``ablate``: where the time goes, each copy wrong on purpose (its output
  is not checked): ``nosplit`` skips the k and v splits, ``oneprod``
  keeps one TF32 product of three in S and in P V, ``both`` does both,
  ``nofence`` drops the proxy fence after the split.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch/kernels/csrc/flash_attention.cu")
SPLITS = [("    split_tile(K0 + s * KVB, KLO, std::integral_constant<int, "
           "KVB>());", "    (void)s;"),
          ("    split_v(sv, it & 1);", "    (void)split_v;")]
ONE_PRODUCT = [
    (f"          wgmma_tf32_ss_n{n}(sacc, dqh, sw128_desc(kl + ko, 16), 1);\n"
     f"          wgmma_tf32_ss_n{n}(sacc, sw128_desc(ql + qo, 16), dkh, 1);\n",
     "") for n in (64, 32)] + [
    (f"        wgmma_tf32_rs_n{n}(oacc, ph[kk], dl, 1);\n"
     f"        wgmma_tf32_rs_n{n}(oacc, pl[kk], dh, 1);\n", "")
    for n in (128, 64)]
TILES = "constexpr int XBN_64 = 32, XKST_64 = 2, XVST_64 = 2;"
VARIANTS = {
    "sweep": {
        "base": [],
        "v1": [(TILES, TILES.replace("XVST_64 = 2", "XVST_64 = 1"))],
        "bn64": [(TILES, TILES.replace("XBN_64 = 32", "XBN_64 = 64"))],
        "bn64v1": [(TILES, "constexpr int XBN_64 = 64, XKST_64 = 2, "
                           "XVST_64 = 1;")],
    },
    "ablate": {
        "base": [],
        "nosplit": SPLITS,
        "oneprod": ONE_PRODUCT,
        "both": SPLITS + ONE_PRODUCT,
        "nofence": [("    fence_proxy_async();\n    bar_sync_first<128>();",
                     "    bar_sync_first<128>();")],
    },
}


def make_tree(name: str, edits, work: Path) -> Path:
    src = work / name / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / CU
    text = cu.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: edit target not found in {CU}: "
                             f"{old.strip()[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    work = ROOT / "build" / "flash_tf32_variants"
    trees = {name: make_tree(name, edits, work)
             for name, edits in VARIANTS[args.set].items()}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.library()"], env={**os.environ, "PYTHONPATH": str(src)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for src in trees.values()]
    for name, proc in zip(trees, builds):
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{err[-4000:]}")
    order = list(trees)
    rows = []
    for _ in range(args.turns):
        for name in order + order[::-1]:
            out = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "attention_ab.py"),
                 "--shapes", "whisper_f32", "--src", str(trees[name]),
                 "--label", name], capture_output=True, text=True,
                check=True).stdout
            for line in out.splitlines():
                row = json.loads(line)
                rows.append(row)
                print(json.dumps(row), flush=True)
    ms = collections.defaultdict(list)
    for row in rows:
        ms[(row["label"], row["shape"])].append(row["ms"])
    summary = {"set": args.set, "gpu": rows[0]["gpu"], "median_ms": {
        f"{name} {shape}": statistics.median(v)
        for (name, shape), v in ms.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text("".join(
            json.dumps(r) + "\n" for r in rows + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
