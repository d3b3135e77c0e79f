#!/usr/bin/env python3
"""Time copies of the SSD scan kernel, each with a part removed, in turns.

    python3 tools/ssd_variants.py --set SET [--src DIR] [--turns N]
                                  [--shapes SHAPES] [--only A,B] [--out FILE]

Each variant is a copy of the ``src`` tree ``--src`` (default: this
checkout's) under ``build/ssd_variants/<set>/<name>/src`` with
``csrc/ssd_scan.cu`` edited as ``VARIANTS`` says (an edit whose text is
not found stops the tool: the table follows the source). The copies are
built in parallel, then ``tools/ssd_ab.py --shapes hymba`` times each in
turns, ``--turns`` passes forward and back (base first). Every copy but
``base`` is wrong on purpose: only its time is read. Prints one JSON
object per timed shape and a median per (variant, shape), with the
card's name and power limit.

* ``tc``: where the time of ``ssd_tc`` goes, the kernel that took hymba's
  (P 64, N 16) before ``ssd_heads`` (so ``--src`` is a tree that has it,
  such as commit 9f9b496's): ``nostore`` keeps y's products but stores no
  y row, ``nostate`` stops each block after y (no split pass, no state
  product, no state or decay store), ``oneprod`` feeds M and the decayed
  x to the tensor cores as one bf16 product each instead of the hi + lo
  pair, ``spreadcs`` loads dA one row a thread over all warps in place of
  warp 0's scan (no scan: the values are wrong).
* ``heads``: ``ssd_heads`` in this tree: ``nostore`` and ``oneprod`` as
  above, ``noy`` skips the y row groups, ``nostate`` the state rows,
  ``nounits`` both (what is left is the loads, the cumsums, the decays and
  the ring's waits); design choices undone: ``expf`` forms M with
  ``expf`` instead of the SFU's ``ex2.approx`` (the numerics of the first
  design), ``burst`` lets the producer issue every head's loads at once,
  and two not taken: ``longfirst`` puts a chunk's longer head runs first
  in block order (hymba's serve: runs of 3 heads in the first wave, so an
  SM's two blocks carry 3 + 2 heads, not 3 + 3), ``occ3`` caps the
  registers for three blocks an SM and sizes the runs for three; and
  ``grid1`` and ``grid4`` size the runs for one and four blocks an SM
  instead of two.

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
CU = Path("repro_torch/kernels/csrc/ssd_scan.cu")
# out_bf16 is 0 or 1, so "!= 7" is always true, but the compiler cannot
# know it: the products stay, the stores or phases go
TC = {
    "base": [],
    "nostore": [("      if (r >= Q) continue;\n      const size_t row = ((ch",
                 "      if (r >= Q || out_bf16 != 7) continue;\n"
                 "      const size_t row = ((ch")],
    "nostate": [("  __syncthreads();   // every warp is done reading x and C "
                 "for y\n",
                 "  if (out_bf16 != 7) return;\n  __syncthreads();\n")],
    "oneprod": [("          mma_bf16(yacc[2 * dp], al, b0, b1);\n", ""),
                ("          mma_bf16(yacc[2 * dp + 1], al, b2, b3);\n", ""),
                ("        mma_bf16(acc[2 * np], al, b0, b1);\n", ""),
                ("        mma_bf16(acc[2 * np + 1], al, b2, b3);\n", "")],
    "spreadcs": [("  if (warp == 0) chunk_cumsum(dA + ch * Q * H, H, h, Q, cs, "
                  "lane);\n",
                  "  for (int s = tid; s < Qp; s += NTHR)\n"
                  "    cs[s] = s < Q ? dA[(ch * Q + s) * H + h] : 0.f;\n")],
}
# y is never null, but the compiler cannot know it: "y != nullptr" skips
# what it guards and keeps what feeds it
NO_Y = [("      if (u < R)\n        y_rows<P, N>(",
         "      if (u < R) {\n        if (y == nullptr) y_rows<P, N>("),
        ("out_bf16);\n      else\n", "out_bf16);\n      } else\n")]
NO_STATE = [("        state_rows<P, N>(b_smem,",
             "        if (y == nullptr) state_rows<P, N>(b_smem,")]
HEADS = {
    "base": [],
    "nostore": [("      if (!(i ? ok_b : ok_a)) continue;",
                 "      if (!(i ? ok_b : ok_a) || y != nullptr) continue;")],
    "noy": NO_Y,
    "nostate": NO_STATE,
    "nounits": NO_Y + NO_STATE,
    "oneprod": [("    mma_bf16(acc[2 * dp], al, b0, b1);\n", ""),
                ("    mma_bf16(acc[2 * dp + 1], al, b2, b3);\n", ""),
                ("      mma_bf16(acc[2 * np], al, b0, b1);\n", ""),
                ("      mma_bf16(acc[2 * np + 1], al, b2, b3);\n", "")],
    "expf": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(e) : "f"(x * '
              '1.44269504f));\n  return e;',
              "  (void)e;\n  return expf(x);")],
    "burst": [("      if (i >= 1)\n        mbar_wait(full + 8 * ((i - 1) % "
               "stages), ((i - 1) / stages) & 1);\n", "")],
    "longfirst": [(
        "  const size_t ch = blockIdx.x / ngroups;\n"
        "  const int grp = blockIdx.x % ngroups;\n"
        "  const int h0 = grp * H / ngroups, hb = (grp + 1) * H / ngroups - "
        "h0;\n",
        "  const int nchunks = gridDim.x / ngroups, lo = H / ngroups;\n"
        "  const int nlong = H % ngroups;\n"
        "  size_t ch;\n  int h0, hb;\n"
        "  if ((int)blockIdx.x < nchunks * nlong) {\n"
        "    ch = blockIdx.x / nlong;\n"
        "    h0 = (blockIdx.x % nlong) * (lo + 1);\n    hb = lo + 1;\n"
        "  } else {\n"
        "    const int b = blockIdx.x - nchunks * nlong;\n"
        "    ch = b / (ngroups - nlong);\n"
        "    h0 = nlong * (lo + 1) + (b % (ngroups - nlong)) * lo;\n"
        "    hb = lo;\n  }\n")],
    "occ3": [("__global__ void __launch_bounds__(HD_THREADS, 2)",
              "__global__ void __launch_bounds__(HD_THREADS, 3)"),
             ("const int want = (2 * sms + nchunks / 2) / nchunks;",
              "const int want = (3 * sms + nchunks / 2) / nchunks;")],
    "grid1": [("const int want = (2 * sms + nchunks / 2) / nchunks;",
               "const int want = (sms + nchunks / 2) / nchunks;")],
    "grid4": [("const int want = (2 * sms + nchunks / 2) / nchunks;",
               "const int want = (4 * sms + nchunks / 2) / nchunks;")],
}
VARIANTS = {"tc": TC, "heads": HEADS}


def make_tree(name: str, edits, src_root: Path, work: Path) -> Path:
    src = work / name / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(src_root / "repro_torch", src / "repro_torch",
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
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--shapes", default="hymba")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time "
                         "(base always), default all of the set")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    work = ROOT / "build" / "ssd_variants" / args.set
    keep = None if args.only is None else {"base", *args.only.split(",")}
    trees = {name: make_tree(name, edits, Path(args.src).resolve(), work)
             for name, edits in VARIANTS[args.set].items()
             if keep is None or name in keep}
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
                [sys.executable, str(ROOT / "tools" / "ssd_ab.py"),
                 "--shapes", args.shapes, "--src", str(trees[name]),
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
        f"{name} | {shape}": statistics.median(v)
        for (name, shape), v in ms.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text("".join(
            json.dumps(r) + "\n" for r in rows + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
