#!/usr/bin/env python3
"""Does a train micro-batch's host time grow as ``chip_smoke.py``'s phases
run before it, and is the cycle collector the cause?

    python3 tools/train_host_probe.py [--alone] [--out FILE] [--reps N]

Runs ``chip_smoke.main()`` as it is, with a probe before its first phase
and after every ``phase_*`` call (nested calls included). With
``--alone`` it runs the train phase alone in a fresh process instead
(after the kernels' build, with ``main``'s TF32 settings), between two
probes: the step as the phase reads it with no earlier phase. A probe
builds a 2-layer model at llama3.2-3b's full width (seeded, bf16), takes one
micro-batch of the train phase's shape (1 × 4096 tokens, ``for_model``)
and times ``train_loop._grads`` on it with ``RunConfig()``'s defaults
(remat full, the flash kernel forward, the plain backward attention):
one warm-up, then ``--reps`` runs with the collector on and ``--reps``
with it off (``gc.disable()``), in turns. The host clock around each run
ends in ``torch.cuda.synchronize()``. A probe also reads the µs of a
trivial launch (2,000 ``add_`` back to back), the collector's tracked
objects and collections so far, and the live threads. It is skipped
while more than 30 GiB are allocated (chameleon-34b's phases), and it
restores the flash kernel's launch count, so the script's own asserts
hold. One JSON object per probe goes to stdout and to ``--out``. Needs a
CUDA device; writes the card's name and power limit with each probe.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PROBE_LAYERS = 2
SKIP_ABOVE = 30 << 30           # bytes allocated: a large model is live


def probe(torch, label: str, reps: int, smi: str) -> dict:
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.params import init_params
    from repro_torch.train.train_loop import _grads
    row = {"probe": label, "gpu": smi,
           "memory_allocated": torch.cuda.memory_allocated()}
    if row["memory_allocated"] > SKIP_ABOVE:
        row["skipped"] = "a large model is live"
        return row
    launches = fa.flash_attention.launches
    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=PROBE_LAYERS)
    shape = ShapeConfig("train_4k", chip_smoke.TRAIN_SEQ, 1, "train")
    batch = for_model(cfg, shape, seed=chip_smoke.SEED,
                      device=device).batch_at(0)
    model = init_params(cfg, device=device, seed=chip_smoke.SEED)
    rcfg = RunConfig()

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = _grads(model, batch, cfg, rcfg)
        torch.cuda.synchronize()
        del grads
        return (time.perf_counter() - t0) * 1e3

    run()
    on, off = [], []
    for _ in range(reps):
        on.append(run())
        gc.disable()
        try:
            off.append(run())
        finally:
            gc.enable()
    one = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        one.add_(1.0)
    torch.cuda.synchronize()
    row.update({
        "micro_batch_ms_gc_on": on, "micro_batch_ms_gc_off": off,
        "median_gc_on": statistics.median(on),
        "median_gc_off": statistics.median(off),
        "us_per_trivial_launch": (time.perf_counter() - t0) / 2000 * 1e6,
        "gc_tracked_objects": len(gc.get_objects()),
        "gc_collections": [s["collections"] for s in gc.get_stats()],
        "threads": threading.active_count()})
    del model, batch, one
    torch.cuda.empty_cache()
    fa.flash_attention.launches = launches
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/train_host_probe.jsonl")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--alone", action="store_true",
                    help="run the train phase alone, not the whole script")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_host_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.SRC))
    smi = chip_smoke.nvidia_smi()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fh = out.open("w")
    started = [False]

    def record(label: str) -> None:
        t0 = time.perf_counter()
        row = probe(torch, label, args.reps, smi)
        row["probe_seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        fh.write(line + "\n")
        fh.flush()

    def wrap(name, fn):
        @functools.wraps(fn)
        def probed(*a, **kw):
            if not started[0]:
                started[0] = True
                record("start")
            result = fn(*a, **kw)
            record(f"after {name}")
            return result
        return probed

    for name in [n for n in vars(chip_smoke) if n.startswith("phase_")]:
        setattr(chip_smoke, name, wrap(name, getattr(chip_smoke, name)))
    try:
        if not args.alone:
            return chip_smoke.main()
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        build.library()
        chip_smoke.phase_train(torch, device, get_config("llama3.2-3b"),
                               smi)
        return 0
    finally:
        fh.close()


if __name__ == "__main__":
    sys.exit(main())
