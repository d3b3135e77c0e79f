#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout: it puts ``src`` on ``sys.path`` itself and
imports nothing of the JAX reference package. Phases, each printing one
JSON object per line:

1. device   — card name and count, ``nvidia-smi`` name and power limit;
2. build    — compiles the hand-written CUDA kernels (``build/kernels``);
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving path's shapes, with the tolerance stated;
4. serve    — full-width llama3.2-3b (random weights from a seed) behind a
              WFQ ``TenantScheduler`` and a ``RateController``: 3 tenants x
              4 requests, 32 new tokens each, until drained; checks the
              ledger and that every attention call went through a kernel;
5. profile  — torch.profiler over 4 decode steps with all 8 slots busy and
              over one 512-token prefill: device time by kernel, busy share;
6. parity   — one prompt's prefill + 4 decode steps through the kernels and
              through the plain attention, same weights, logits compared;
7. timings  — each kernel, its plain version and one PyTorch library call,
              timed with CUDA events beside the least time the card could
              take (bytes or operations at the H100 SXM datasheet rates).

Then one ``{"kernels": [...]}`` summary line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Without a CUDA device, or outside a
checkout, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

# H100 SXM datasheet peaks (dense): HBM bytes/s and bf16 tensor flop/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}

FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
DECODE_TOL = {"bfloat16": {"o": 2e-2, "m": 1e-4, "l": 1e-4},
              "float32": {"o": 2e-4, "m": 1e-4, "l": 1e-4}}
PARITY_TOL = 2e-2      # max |dlogit| / max |logit| at bf16, full width

REQUESTS_PER_TENANT = 4
TENANTS = 3
NEW_TOKENS = 32
PROMPT_RANGE = (64, 512)
DECODE_POS = (0, 1, 17, 255, 511, 700, 1022, 1023)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the serving path reads each layer's cache cold). A device-side
    sleep queued ahead of the first event keeps the card busy while the
    host enqueues the call, so the events bracket device time only, not
    the wrapper's Python overhead."""

    SLEEP_CYCLES = 2_000_000      # ~1 ms at H100 clocks

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_work(b, s, t, hq, kv, d, elem, causal, window):
    """Bytes (q, k, v read once, o written once) and flops (QK^T and PV
    over the (query, key) pairs the mask keeps)."""
    pairs = 0
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(hi - lo + 1, 0)
    nbytes = elem * (2 * b * s * hq * d + 2 * b * t * kv * d)
    return nbytes, 4.0 * d * pairs * hq * b


def decode_work(pos, t, hq, kv, d, q_elem, kv_elem):
    live = sum(min(p, t - 1) + 1 for p in pos)
    b = len(pos)
    nbytes = (2 * live * kv * d * kv_elem + 2 * b * hq * d * q_elem
              + 2 * b * hq * 4 + 4 * b)
    return nbytes, 4.0 * d * live * hq


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(torch, device):
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    hq, kv, d = 24, 8, 128
    cases = [(s, "bfloat16", 0) for s in (64, 509, 1024)]
    cases += [(509, "bfloat16", 128), (509, "float32", 0)]
    for s, dt, window in cases:
        dtype = getattr(torch, dt)
        q = torch.randn((1, s, hq, d), generator=gen, device=device).to(dtype)
        k = torch.randn((1, s, kv, d), generator=gen, device=device).to(dtype)
        v = torch.randn((1, s, kv, d), generator=gen, device=device).to(dtype)
        o = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=True, window=window)
        err = (o.float() - ref.float()).abs().max().item()
        ok = err <= FLASH_TOL[dt] and bool(torch.isfinite(o).all())
        emit({"phase": "kernels", "kernel": "flash_attention", "S": s,
              "dtype": dt, "window": window, "max_abs_err": err,
              "tol": FLASH_TOL[dt], "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention S={s} {dt} window="
                                 f"{window}: err {err} > {FLASH_TOL[dt]}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    b, t = 8, 1024
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=device)
    for dt in ("bfloat16", "float32"):
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(getattr(torch, dt))
        kc = torch.randn((b, t, kv, d), generator=gen,
                         device=device).to(torch.bfloat16)
        vc = torch.randn((b, t, kv, d), generator=gen,
                         device=device).to(torch.bfloat16)
        o, m, l = decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        ro, rm, rl = decode_attention_plain(q, kc, vc, pos)
        e_o = (o.float() - ro.float()).abs().max().item()
        e_m = (m - rm).abs().max().item()
        e_l = ((l - rl).abs() / rl.abs()).max().item()
        tol = DECODE_TOL[dt]
        ok = e_o <= tol["o"] and e_m <= tol["m"] and e_l <= tol["l"] \
            and bool(torch.isfinite(o).all())
        emit({"phase": "kernels", "kernel": "decode_attention", "B": b,
              "T": t, "q_dtype": dt, "cache_dtype": "bfloat16",
              "pos": list(DECODE_POS), "max_abs_err_o": e_o,
              "max_abs_err_m": e_m, "max_rel_err_l": e_l, "tol": tol,
              "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention {dt}: o {e_o}, m {e_m}, "
                                 f"l {e_l} against {tol}")
        errs["decode_attention"] = max(errs["decode_attention"], e_o)
    return errs


def make_requests(cfg, request_cls):
    import random
    rng = random.Random(SEED)
    reqs = []
    for i in range(REQUESTS_PER_TENANT):
        for tenant in range(TENANTS):
            n = rng.randint(*PROMPT_RANGE)
            prompt = [rng.randrange(cfg.vocab_size) for _ in range(n)]
            reqs.append(request_cls(tenant_id=tenant, prompt=prompt,
                                    max_new_tokens=NEW_TOKENS,
                                    req_id=len(reqs)))
    return reqs


def phase_serve(torch, device, cfg, layers: int):
    from repro_torch.configs import RunConfig
    from repro_torch.control import RateController
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward_prefill
    from repro_torch.serve import Request, ServeEngine, TenantScheduler

    t0 = time.perf_counter()
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(1e6, alpha=0.6)    # tokens/s: admits everything,
    ctrl.attach_scheduler(sched)             # still ticks and pushes rates
    gen = torch.Generator(device=device).manual_seed(SEED)
    eng = ServeEngine(cfg, RunConfig(), batch_slots=8, max_seq=1024,
                      scheduler=sched, controller=ctrl, control_every=4,
                      device=device, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(cfg, Request)
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    decode_attention.launches = 0
    t_run = time.perf_counter()
    for r in reqs:
        r.arrival = time.monotonic()
        eng.submit(r)
    decode_only = []    # (seconds, active slots) of steps that admitted none
    steps = 0
    while sched.pending() or any(s.active for s in eng.slots):
        a0 = eng.admissions
        ts = time.perf_counter()
        n = eng.step()
        dt = time.perf_counter() - ts
        if eng.admissions == a0 and n:
            decode_only.append((dt, n))
        steps += 1
        if steps > 10000:
            raise AssertionError("engine did not drain")
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}

    done = eng.completed
    assert len(done) == len(reqs), f"{len(done)} of {len(reqs)} completed"
    assert all(len(r.generated) == NEW_TOKENS for r in done), \
        [len(r.generated) for r in done]
    ledger = {}
    for tenant in range(TENANTS):
        truth = sum(len(r.prompt) + len(r.generated) for r in reqs
                    if r.tenant_id == tenant)
        served = sched.served_tokens[tenant]
        billed = eng.billed_ground_truth(tenant)
        ledger[tenant] = {"served_tokens": served, "ground_truth": billed,
                          "requests_truth": truth}
        assert served == billed == truth, ledger
    assert launches["flash_attention"] == layers * eng.admissions, \
        (launches, eng.admissions)
    assert launches["decode_attention"] == layers * eng.decode_steps, \
        (launches, eng.decode_steps)
    peak = torch.cuda.max_memory_allocated()

    # prefill time per request at the longest prompt length drawn
    prompt = torch.tensor([reqs[0].prompt[:1] * PROMPT_RANGE[1]],
                          dtype=torch.int32, device=device)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        forward_prefill(eng.params, prompt, eng.rcfg, max_seq=eng.max_seq)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    dec_tokens = sum(n for _, n in decode_only)
    dec_s = sum(t for t, _ in decode_only)
    out = {"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": cfg.num_params(),
           "requests": len(reqs), "completed": len(done),
           "admissions": eng.admissions, "decode_steps": eng.decode_steps,
           "launches": launches, "ledger": ledger,
           "controller_ticks": ctrl.ticks, "init_s": init_s,
           "run_s": run_s,
           "decode_tok_s": dec_tokens / dec_s if dec_s else None,
           "step_ms_median": (statistics.median(t for t, _ in decode_only)
                              * 1e3 if decode_only else None),
           "prefill_ms_512": statistics.median(times) * 1e3,
           "slot_utilization": eng.slot_utilization(),
           "max_memory_allocated": peak, "ok": True}
    emit(out)
    return eng, launches


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def _profile(torch, fn, top: int = 8):
    """Where ``fn``'s device time goes. ``fn`` runs twice: once with the
    host clock alone (``wall_ms``), once under torch.profiler, whose CUDA
    kernel events (and only those: an operator's own row would count its
    kernels twice) give the device time by kernel. Their ratio is the
    device's busy share of the unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and _device_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "device_busy_share": busy / wall_us if busy else "not measured",
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:top]]}


def phase_profile(torch, device, eng):
    """Where a decode step and a prefill spend their time (torch.profiler
    over the port's own entry points, all 8 slots busy)."""
    from repro_torch.models import forward_prefill
    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(SEED + 3)
    for i in range(eng.B):
        prompt = torch.randint(0, eng.cfg.vocab_size, (256,),
                               generator=rng).tolist()
        eng.submit(Request(tenant_id=i % TENANTS, prompt=prompt,
                           max_new_tokens=16, req_id=1000 + i))
    eng.step()                                  # admits all 8 (+1 decode)
    assert sum(s.active for s in eng.slots) == eng.B
    eng.step()                                  # warm

    def decode4():                              # twice: 8 of 15 steps left
        for _ in range(4):
            eng.step()
    decode = _profile(torch, decode4)
    prompt = torch.randint(0, eng.cfg.vocab_size, (1, PROMPT_RANGE[1]),
                           generator=rng).to(device)
    prefill = _profile(torch, lambda: forward_prefill(
        eng.params, prompt, eng.rcfg, max_seq=eng.max_seq))
    eng.run_until_drained()
    emit({"phase": "profile", "decode_4_steps_B8": decode,
          f"prefill_S{PROMPT_RANGE[1]}": prefill})


def phase_parity(torch, device, eng):
    from repro_torch.configs import RunConfig
    from repro_torch.models import forward_decode, forward_prefill, \
        init_cache
    cfg = eng.cfg
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen,
                           device=device, dtype=torch.int64).int()
    runs = {}
    for name, rc in (("kernel", kernel), ("plain", plain)):
        logits, c1 = forward_prefill(eng.params, prompt, rc,
                                     max_seq=eng.max_seq)
        runs[name] = {"logits": [logits.float()],
                      "cache": init_cache(cfg, 1, eng.max_seq,
                                          device=device)}
        for big, one in zip(runs[name]["cache"], c1):
            for k in big:
                big[k].copy_(one[k])
    # teacher-forced: both paths decode the kernel path's greedy tokens
    tok = int(runs["kernel"]["logits"][0].argmax())
    for step in range(4):
        pos = torch.tensor([prompt.shape[1] + step], dtype=torch.int32,
                           device=device)
        tokens = torch.tensor([[tok]], dtype=torch.int32, device=device)
        for name, rc in (("kernel", kernel), ("plain", plain)):
            lg, _ = forward_decode(eng.params, runs[name]["cache"], tokens,
                                   pos, rc)
            runs[name]["logits"].append(lg.float())
        tok = int(runs["kernel"]["logits"][-1].argmax())
    rel, agree = [], 0
    for a, b in zip(runs["kernel"]["logits"], runs["plain"]["logits"]):
        rel.append(((a - b).abs().max() / b.abs().max()).item())
        agree += int(a.argmax() == b.argmax())
    worst = max(rel)
    out = {"phase": "parity", "prompt": int(prompt.shape[1]),
           "decode_steps": 4, "max_rel_logit_err": worst,
           "per_step_rel_err": rel, "tol": PARITY_TOL,
           "argmax_agree_share": agree / len(rel), "ok": worst <= PARITY_TOL}
    emit(out)
    if worst > PARITY_TOL:
        raise AssertionError(f"kernel path vs plain: {worst} > {PARITY_TOL}")


def phase_timings(torch, device, smi: str):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    timer = Timer(torch, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    hq, kv, d = 24, 8, 128
    rows = {}
    for s in (64, 509, 1024):
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for h in (hq, kv, kv))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_work(1, s, s, hq, kv, d, 2, True, 0)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "flash_attention", "S": s,
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, k, v)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v)),
               "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", s)] = row
    b, t = 8, 1024
    for name, pos_list in (("mixed", DECODE_POS), ("full", (t - 1,) * b)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(torch.bfloat16)
        kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(2))
        q4 = q[:, :, None, :]
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        mask = live_mask(pos, t)[:, None, None, :]
        nbytes, flops = decode_work(pos_list, t, hq, kv, d, 2, 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "decode_attention", "B": b,
               "T": t, "pos": name, "dtype": "bfloat16",
               "ms": timer.ms(lambda: decode_attention(q, kc, vc, pos)),
               "plain_ms": timer.ms(
                   lambda: decode_attention_plain(q, kc, vc, pos)),
               "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   q4, kt, vt, attn_mask=mask, enable_gqa=True)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("decode_attention", name)] = row
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full
    torch.backends.cudnn.allow_tf32 = False         # precision, explicitly
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log = build.build_info.get("log", "")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(build.BUILD_DIR / build.LIB_NAME),
          "sources": build.build_info.get("sources"),
          "spill_lines": [ln.strip() for ln in str(log).splitlines()
                          if "spill" in ln and " 0 bytes spill stores, "
                          "0 bytes spill loads" not in ln]})

    errs = phase_kernels(torch, device)

    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b")
    eng, launches = phase_serve(torch, device, cfg, cfg.num_layers)
    phase_profile(torch, device, eng)
    phase_parity(torch, device, eng)
    del eng
    torch.cuda.empty_cache()

    rows = phase_timings(torch, device, smi)
    flash = rows[("flash_attention", 509)]
    dec = rows[("decode_attention", "mixed")]
    summary = []
    for name, row, src, replaces in (
            ("flash_attention", flash,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:87"),
            ("decode_attention", dec,
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:64")):
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
