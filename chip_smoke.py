#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, control and training paths on
one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout: it puts ``src`` on ``sys.path`` itself and
imports nothing of the JAX reference package. Phases, each printing one
JSON object per line:

1. device   — card name and count, ``nvidia-smi`` name and power limit;
2. build    — compiles the hand-written CUDA kernels (``build/kernels``);
3. kernels  — each kernel against its plain PyTorch version on the card at
              the paths' shapes, with the tolerance stated (flash: S 1, 2,
              64, 65, 509, 1024, two sequences with T > S, a window, f32;
              hymba-1.5b's 25/5 heads at d 64, S 1536 and 1100 under its
              1024-token window, S 1536 global, f32, and its trained S
              4096 windowed and global; decode: mixed and
              serve positions, twice, bit-identical; hymba's group 5 over
              rings of 1024 slots at positions before and past the wrap,
              also against the reference's absolute-position decode, a
              global cache of 2048, f32); the water-fill also against the
              exact sort-based fill, and twice on the same input
              (bit-identical); the SSD scan at mamba2-370m's width (1, 2
              and 16 chunks, a padded last chunk, cumsums to -180) and at
              hymba's (12 and 32 chunks; 11 padded, bf16 and f32; y,
              states, decays and state decays); ``SsdScanFn`` at the
              trainers' shapes (the kernel's outputs, the plain scan's
              grads); whisper-small's 12/12 heads at d 64: flash
              bidirectional over 1500 frames (bf16, f32), causal
              cross-attention with S 4 and 448 below T 1500, causal
              self-attention at S = T 4 and 448, the trained micro-batch's
              f32 encoder and cross-attention (B 4), decode at group 1 over
              1500 frames at pos 1499 and over 448 slots;
              arctic-480b's 56/8 heads: flash S 64 and 509, decode at
              group 7 over 8 caches of 1024, bf16 and f32 queries;
              head dim 192: nemotron-4-340b's 96/8 heads (flash S 64 and
              509 bf16, S 300 f32; decode at group 12 over 8 caches of
              1024, bf16, and f32 queries over bf16 and f32 caches) and
              deepseek-v2-236b's MLA prefill at 128/128 with v padded
              (S 509 bf16, S 300 f32);
4. serve    — full-width llama3.2-3b (random weights from a seed) behind a
              WFQ ``TenantScheduler`` and a ``RateController``: 3 tenants x
              4 requests, 32 new tokens each, until drained; checks the
              ledger and that every attention call went through a kernel;
5. profile  — torch.profiler over 4 decode steps with all 8 slots busy and
              over one 512-token prefill: device time by kernel, busy share;
6. parity   — one prompt's prefill + 4 decode steps through the kernels and
              through the plain path, same weights, logits compared;
   serve, profile and parity then run again on full-width mamba2-370m (the
   ssm family: every prefill layer through the SSD scan kernel; prefill
   also timed at 4,096 tokens; its profile gives the SSD kernel's share of
   a prefill's device time and shows no separate cumsum runs), and on
   full-width chameleon-34b at full depth (the vlm family: 48 layers, 64 GiB
   of bf16 weights, q/k norms; its memory reported; parity at bf16 for
   every attention kernel launch, asserted, and end to end, reported beside
   the model's own bf16 noise floor; then its first 8 layers again at f32
   once the bf16 model is freed, asserted end to end), and on full-width
   hymba-1.5b at full depth (the hybrid family: attention and SSM heads in
   parallel in 32 layers, rings of 1024 slots in the 29 windowed ones;
   ``max_seq`` 2048, prompts of 1024-1536 tokens, one of exactly 1024;
   flash and the SSD scan once per layer and admission, every SSD launch
   on the scan's ``"heads"`` route (``launches_by_route``), decode once per
   layer and step, every decode past the ring's wrap, the cache's bytes
   the schema's; parity at bf16 for every flash, SSD and decode launch,
   asserted, and end to end, reported beside the model's own bf16 noise
   floor; the whole model again at f32 with an f32 cache, asserted), and
   on full-width whisper-small (the encdec family, served through
   ``forward_prefill(..., frames=)`` and greedy ``forward_decode``: 8
   utterances of 1500 bf16 frames, prompts of 4, ``max_seq`` 448, 64 new
   tokens; 36 flash launches a prefill, 24 decode launches a step, the
   cache's bytes the schema's; the kernel path against the plain path at
   bf16 and on an f32 copy), and on the moe family at full width and cut
   depth (the moe phase): arctic-480b's 2 of 35 layers (128 experts top-2
   beside a dense branch, 56/8 heads: flash once per layer and admission,
   decode at group 7 once per layer and step) and deepseek-v2-236b's
   dense layer and 7 moe layers (160 experts top-6, 2 shared; MLA's
   prefill through flash at head dim 192 with v padded from 128, once per
   layer and admission, its decode in plain torch over a latent cache),
   each served, profiled and held against the plain path at bf16 (every
   attention launch asserted; the end-to-end gap and the routing choices
   that differ reported beside the model's own bf16 noise floor), its
   first layers at f32 (1 and 4: identical tokens and routing, logits
   within 1e-4) once the bf16 model is freed, and its smoke config on the
   card against the CPU (dispatch tables, y and aux, and the engine's
   tokens and ledger); capacities, drop shares, weight bytes, the step
   beside the bytes it must read, the latent cache beside a k/v cache
   reported; and on nemotron-4-340b at full width and 6 of 96 layers
   (the nemotron phase: 96/8 heads at head dim 192, squared-ReLU MLP,
   layernorm, untied embeddings, 60.3 GB of bf16 weights; flash once per
   layer and admission, decode at group 12 once per layer and step, the
   cache's bytes the schema's; parity at bf16 for every attention launch,
   asserted, and end to end, reported beside the ± 2^-8 noise floors; its
   first layer at f32 with an f32 cache, asserted; the step beside the
   bytes it must read, busy share, prefill of 512, weights reported);
7. control  — the vectorized control plane's fused tick on the card at
              1k, 10k, 100k and 1M tenants (the fleet-scale control bench's
              counter trace): µs per tick, tenants/s, state bytes; its
              allocations against the object ``RateController`` at 1k and
              10k, and against the same tick on the CPU at 100k; one
              1M-tenant tick taken apart (upload, operations, read-back);
8. replay   — ``replay_scenario`` driving full-width llama3.2-3b: steady
              on the object and the vectorized control plane (fairness, and
              each tenant's rate within 2% across the two), adversarial
              against its hog-free baseline (the isolation bounds);
9. cluster  — 3 engines over the replay phase's model behind one
              ``RateController``: migration, consolidation, hotspot,
              stack_swap and failover (failover on the vectorized plane);
              each scenario's claims, conservation on every plane, every
              attention call through a kernel, the water-fill kernel on
              the vectorized run, the cache's bytes freed on the card by
              each park, the weights resident once, the traces checked by
              ``tools/check_trace.py``, and the ledgers equal to a CPU run
              of the smoke config;
10. watchdog — claim (k) of ``benchmarks/bench_fairness.py`` over the
              replay phase's model: steady and adversarial on one engine,
              failover (recording its scrapes) and stack_swap on 3
              engines, each with the stock fabric watchdog, then a
              watch-free steady replay and the tick timed right after it; every ``e2e_watchdog`` threshold of
              ``bench_thresholds.json``, each run's alerts equal to a CPU
              run of the smoke config, the watched ledgers equal to the
              watch-free ones, the recorded scrapes replayed offline to the
              same alerts, the failover trace checked by
              ``tools/check_trace.py``;
11. codec   — the int8 codec kernels against their plain version, bit
              for bit (R 1/255/257/4,096 x C 256/3,072/8,192, blocks 128
              and 256, f32 and bf16 in and out, a zero block and exact
              ties), then every leaf of full-width llama3.2-3b at bf16
              (3.2e9 elements) through ``ops.quantize``/``ops.dequantize``
              within the codec's stated bound, with its GB/s;
12. bytes   — the bytes plane at world size 1 on the card (an NCCL group
              of one): ``nk_grad_sync`` of that pytree under each stock
              policy's CoreEngine, plus ``nk_psum``/``nk_all_gather``/
              ``nk_reduce_scatter`` on one leaf; each stack's output
              against its plain result (compressed: the plain int8 round
              trip, bit for bit), ledger bytes against payload bytes,
              billed bytes conserved across an export/import; ms per
              ``nk_grad_sync`` (the engine's host cost: no bytes cross a
              wire at world 1);
13. train   — full-width, full-depth llama3.2-3b (random bf16 weights
              from a seed) trained through ``Runner`` -> ``make_train_step``
              -> ``forward_train`` -> ``loss_fn`` -> ``adamw_update`` on
              ``for_model``'s batches (seq 4096, global batch 4,
              ``grad_accum`` 4, remat full, f32 moments, lr 3e-3 with one
              warm-up step): one warm-up step, 3 timed steps (step ms,
              tokens/s, MFU, the state's bytes, peak memory, 224 flash
              launches a step asserted: forward and remat recompute per
              layer and micro-batch, every parameter moved), one
              profiled micro-batch (busy share, top kernels, the plain
              backward attention's share); the kernel path against the plain path
              on one micro-batch (bf16 at full depth: loss, grad norm and
              every wq/wk/wv grad within 2e-2; f32 at 2 layers: loss
              within 1e-5, every grad within 1e-4); one ``pod_step``
              through the compressed stack on an NCCL world of one (254
              gradient psums on ``("pod",)`` of the gradients' bytes, the
              sync's ms); at 2 layers, 5 steps plain against 5 steps with
              a checkpoint at 3 and a failure at 4: bit-identical states;
              then full-width mamba2-370m and hymba-1.5b (seq 4096,
              global batch 4) and whisper-small (448 tokens and 1500 f32
              frames, global batch 16), each through the Runner for 2
              steps (``grad_accum`` 4; flash and the SSD scan under
              autograd; launches a step, whisper's f32 ones through
              flash's tensor-core route and hymba's SSD scans through the
              scan's ``"heads"`` route (``launches_by_route``), every
              parameter moved, step ms,
              tokens/s, MFU, state bytes, peak memory), the kernel path
              against the plain path (bf16 at full depth: loss and grad
              norm asserted, the kernel-fed leaves' grads reported beside
              the model's bf16 noise floor; bf16 at 2 layers: those
              leaves asserted; f32 at 2 layers: every grad), mamba2's
              recovery at 2 layers bit-identical; then the sharded
              train phase: llama3.2-3b at full width and 4 of its 28
              layers on an NCCL world of one (``make_host_mesh(1, 1)``,
              the ``"2d"`` rules: FSDP gathers over ``data``, TP over
              ``model``, every collective through the ``nk_*`` verbs):
              one micro-batch through the sharded path against the
              unsharded ``forward_train`` from the same seeded weights
              (loss, grad norm and every wq/wk/wv grad within 2e-2), two
              ``Runner`` steps on each (step ms sharded against
              unsharded; on the mesh: every leaf moved, flash launches =
              layers x micro-batches x 2, the psums, all-gathers and
              reduce-scatters a step in the CoreEngine's ledger as
              reckoned, peak bytes), a profiled micro-batch at 1 layer
              on each path (busy share), a save, ``Runner.remesh``
              onto a fresh world-1 mesh (the restored state equal to the
              saved one) and one more step; and flash under autograd at each TP rank's
              shapes of a 4,096-token sequence (tp 2/4/8/16) against the
              plain forward and its autograd VJP (o, dq, dk, dv within
              2e-2), its forward timed beside the bound and SDPA's
              forward + backward; then the families' sharded train
              phase: full-width mamba2-370m at 8 of 48 layers, hymba-1.5b
              at 4 of 32 (its global layer 0 and a windowed segment) and
              whisper-small at 2 + 2 of 12 + 12, each on an NCCL world of
              one under ``"2d"`` with the trainers' batches: the sharded
              micro-batch against the unsharded one (loss, grad norm and
              every kernel-fed grad within 2e-2), two ``Runner`` steps on
              each path (step ms; on the mesh: flash and SSD launches,
              the SSD ones by route, every leaf moved, the ledger's collectives a step as
              ``train_collectives`` reckons them, peak bytes), a
              profiled 1-layer sharded micro-batch (whisper's f32 flash
              launches through the tensor-core route); and each TP train
              rank's ``SsdScanFn`` (mamba2's 32 / tp heads, hymba's 25 at
              tp 2 and 50 past it) and f32 flash at whisper's encoder rank
              heads under autograd against the plain forward and its VJP
              (within 2e-2), the forward timed beside its bound (flash:
              SDPA's forward + backward too);
14. fairness — ``bench_fairness.py``'s convergence, isolation and backfill
              scenarios on the port's ``SharedBottleneckSim`` with the
              object controller and the vectorized one on the card (its
              water-fill kernel), claims (a)-(c) and the two backends'
              agreement;
15. timings — each kernel, its plain version and one PyTorch library call
              where one computes the same function, timed with CUDA events
              beside the least time the card could take (bytes or
              operations at the H100 SXM datasheet rates; f32 flash on
              the tensor cores at a third of the TF32 rate); for the
              attention kernels the backend that
              ``scaled_dot_product_attention`` dispatches to (timed pinned
              to it); for them and the water-fill the wrapper's host
              enqueue µs per call; flash at S 64, 509, 1024 and the
              train phase's 4,096; decode at
              mixed, full and serve-range positions; the water-fill at
              the 3- and 4-tenant problems of the fairness and replay
              phases and at the fused tick's populations; the SSD scan at
              a 256-, 512- and 4,096-token prompt; hymba-1.5b's shapes
              (flash over 1536 tokens with the window and without, decode
              over 8 rings, the SSD scan over 12 chunks of its width); the
              codec on the embedding leaf; whisper-small's flash and
              decode shapes and the trainers' SSD scans; arctic-480b's
              flash and group-7 decode shapes; nemotron-4-340b's flash
              and group-12 decode and deepseek-v2-236b's MLA flash, at
              head dim 192;
16. launch  — ``launch/dryrun.py``'s table: every applicable (arch x
              shape) cell on 16x16 and 2x16x16, one rank's shard built on
              the meta device (argument, output and resident bytes
              against 80 GB, parameter bytes in the reference's layout
              beside the port's; temporaries not modelled); llama3.2-3b
              decode_32k and deepseek-v2-236b train_4k made again on the
              card with ``torch.empty`` as one rank's shard of 16x16, the
              rise in ``memory_allocated`` within 512 bytes a tensor of the
              meta count; ``launch/roofline.py``'s floor ``t_ideal`` at the
              llama serve and train phases' shapes beside their measured
              medians, and the collective term of the sharded llama train
              step from its CoreEngine's ledger; llama3.2-3b at 4 layers,
              one 4,096-token micro-batch under remat "full" and "dots"
              (median ms, peak bytes, grads within 1e-3 of max |g|, flash
              recomputed under both, "dots"'s peak at least "full"'s).

Then the seconds of the vlm, hybrid, encdec, moe, nemotron, watchdog,
train, sharded-train, train-families, sharded-train-families and launch
phases and of the whole script,
one ``{"kernels": [...]}`` summary line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Without a CUDA device, or outside a
checkout, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
DECODE_TOL = {"bfloat16": {"o": 2e-2, "m": 1e-4, "l": 1e-4},
              "float32": {"o": 2e-4, "m": 1e-4, "l": 1e-4}}
PARITY_TOL = 2e-2      # max |dlogit| / max |logit| at bf16, full width
# SSD scan at mamba2-370m's width; f32 within the reference's own bounds
# (tests/test_kernels.py:82-84), bf16 within 2e-2 of the largest value
SSD_Q, SSD_H, SSD_P, SSD_N = 256, 32, 64, 128
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL_DECAY = 1e-5
SSM_PREFILL_LENS = (512, 4096)
# chameleon-34b (the vlm family): its first layers again at f32, full
# width, with an f32 cache; logits within P2's f32 bound of max |logit|
VLM_F32_LAYERS = 8
VLM_F32_TOL = 1e-4
SSD_TIMED_CHUNKS = (1, 2, 16)   # a 256-, 512- and 4,096-token prompt
SSD_SUMMARY_CHUNKS = 2          # the kernels line: a 512-token prompt
CODEC_TIMED = (128256, 3072)  # llama3.2-3b's embedding, the largest leaf

REQUESTS_PER_TENANT = 4
TENANTS = 3
NEW_TOKENS = 32
PROMPT_RANGE = (64, 512)
DECODE_POS = (0, 1, 17, 255, 511, 700, 1022, 1023)
# the serve phase's live range: prompts of 64-512 tokens plus 32 new ones
SERVE_DECODE_POS = (64, 132, 201, 269, 338, 406, 475, 544)
HOST_CALLS = 200              # enqueue timing: calls back to back
# (query heads, kv heads) at head_dim 128: llama3.2-3b's and chameleon-34b's
LLAMA_HEADS = (24, 8)
VLM_HEADS = (64, 8)
ARCTIC_HEADS = (56, 8)        # group 7
# hymba-1.5b (the hybrid family) at full width and depth: 25/5 heads at
# head_dim 64 (group 5), a 1024-token window outside layers 0, 15 and 31.
# Its windowed layers keep a ring of 1024 slots only where max_seq is above
# the window, and a slot takes only prompts of at least the window there
# (ROADMAP R7): prompts of 1024-1536 tokens, one of exactly 1024 (no roll)
HYBRID_HEADS, HYBRID_D, HYBRID_WINDOW = (25, 5), 64, 1024
HYBRID_MAX_SEQ = 2048
HYBRID_PROMPT_RANGE = (1024, 1536)
HYBRID_FIXED_LENGTHS = (1024,)
HYBRID_PREFILL_LENS = (1536,)
# the parity prompt: past the window and not a multiple of it
HYBRID_PARITY_PROMPT = 1300
# a ring step: positions before the ring fills, at its edge and past wraps
# (the kernel reads slots 0..min(pos, 1023)); a global layer's positions
RING_DECODE_POS = (1023, 1024, 1300, 1567, 0, 5, 2047, 1100)
GLOBAL_DECODE_POS = (1024, 1100, 1200, 1300, 1400, 1500, 1566, 1567)
# the SSD scan at hymba's width: Q 128, H 50, P 64, N 16; 12 chunks is a
# 1536-token prompt, 11 with 108 padded rows the 1300-token parity prompt
HYBRID_SSD = (128, 50, 64, 16)
HYBRID_SSD_CHUNKS = 12
# whisper-small (the encdec family) at full width and depth: 12 encoder
# and 12 decoder layers, 12/12 heads at head_dim 64, 1500 frames. Served as
# the reference's own entry points serve it (its ServeEngine cannot:
# ROADMAP R9): a prefill with frames, then greedy decode steps; 8
# utterances, prompts of 4 tokens (the SOT sequence), max_seq 448 (the
# published text context, arXiv:2212.04356), 64 new tokens
ENCDEC_HEADS, ENCDEC_D, ENCDEC_FRAMES = (12, 12), 64, 1500
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_MAX_SEQ = 8, 4, 448
ENCDEC_NEW = 64
ENCDEC_PARITY_STEPS = 8       # decode steps of each parity run
ENCDEC_F32_TOL = 1e-4         # f32 kernel path vs plain path, logits
# the serve range of self-decode positions: 4-token prompts + 64 new
ENCDEC_DECODE_POS = (4, 13, 22, 31, 40, 49, 58, 67)
# its cache at the serve shape, bf16 (12 layers x 8 x 1500 / 448 x 12 x 64)
ENCDEC_CROSS_BYTES, ENCDEC_SELF_BYTES = 442_368_000, 132_120_576

# water-fill: |kernel - plain| and |kernel - exact fill| per unit capacity
# the moe phase: (arch, layers served at full width, layers of its f32
# parity); arctic-480b's 2 of 35 layers hold 55.4 GB of bf16 weights,
# deepseek-v2-236b's dense layer and 7 of its 59 moe layers 59.7 GB
MOE_MODELS = (("arctic-480b", 2, 1), ("deepseek-v2-236b", 8, 4))
MOE_F32_TOL = 1e-4
MOE_SMOKE_PROMPTS = (5, 9, 16, 7, 30, 12)   # the smoke engines' requests
MOE_SMOKE_TOL = 1e-5          # apply_moe on the card vs the CPU, f32
# deepseek-v2-236b's MLA prefill through flash: 128 heads, each its own kv
# head, dk 192 (nope 128 + rope 64), v padded from 128 to 192
MLA_HEADS, MLA_DV = (128, 128), 128
# nemotron-4-340b at full width (d 18432, 96/8 heads at head dim 192:
# group 12, d_ff 73728, vocab 256000, untied) and 6 of its 96 layers:
# 60,323,438,592 bytes of bf16 weights (a layer is 6.9 GB more); its
# first layer again at f32 (51.6 GB)
NEMOTRON_LAYERS, NEMOTRON_F32_LAYERS = 6, 1
NEMOTRON_HEADS, NEMOTRON_D = (96, 8), 192

WATER_TOL_PLAIN = 1e-9
WATER_TOL_EXACT = 1e-6
# the one-warp kernel (n <= 32) and past it, one block, the first grid
WATER_N = (1, 3, 4, 32, 33, 1000, 8193, 10_000, 100_000, 1_048_576)
WATER_TIMED_SMALL = (3, 4)    # the fairness and replay phases' problems
# the control-plane scale bench's counter trace
CONTROL_CAPACITY = 1e6
CONTROL_BACKLOG_FRAC = 0.1
CONTROL_N = (1_000, 10_000, 100_000, 1_000_000)
CONTROL_TICKS = 24            # timed ticks per population, after warm-up
CONTROL_WARMUP = 3
# replay phase: tenants and intervals of each scenario
FABRIC_LAYERS = 8             # replay, cluster and watchdog: 8 of 28
REPLAY_TENANTS = 4
REPLAY_INTERVALS = 16
REPLAY_MAX_SEQ = 16           # a request is 2 prompt + 6 new tokens
# make_replay_engine's default: the isolation bounds were set at 4 slots.
# At 8 the virtual step doubles and the victims' p99 admit wait lands on
# the 1 s histogram edge (same on any device: the clock is virtual)
REPLAY_SLOTS = 4
# the replay and cluster phases' decode positions: one per slot, under
# REPLAY_MAX_SEQ and inside the first 64-position chunk
REPLAY_DECODE_POS = (1, 2, 3, 15)
# cluster phase: 3 engines share the replay phase's model; each scenario
# runs REPLAY_INTERVALS intervals of REPLAY_TENANTS tenants with the replay
# phase's slots and cache length, then again on the CPU at the smoke config
CLUSTER_ENGINES = 3
# scenario -> control backend; failover runs the vectorized plane, so the
# shared controller's water-fill goes through its kernel on the card
CLUSTER_RUNS = (("migration", "object"), ("consolidation", "object"),
                ("hotspot", "object"), ("stack_swap", "object"),
                ("failover", "vectorized"))
CLUSTER_CORE_PLANE = ("hotspot", "stack_swap", "failover")
CLUSTER_TRACED = ("migration", "stack_swap", "failover")
# watchdog phase: claim (k) as benchmarks/bench_fairness.py runs it
# (run_e2e_watchdog: 4 tenants, 12 intervals, the object control plane,
# make_replay_engine's and make_replay_cluster's default slots and cache),
# over the replay phase's model; each watched scenario with its watch mode
WATCH_TENANTS = 4
WATCH_INTERVALS = 12
WATCH_RUNS = (("steady", True), ("adversarial", True),
              ("failover", "record"), ("stack_swap", True))
WATCH_TICK_REPS = 100         # timed watchdog ticks, after warm ticks,
WATCH_TICK_BLOCKS = 5         # in blocks; the tick is the median block's
# the gated rows of claim (k): benchmarks/bench_thresholds.json
THRESHOLDS = ROOT / "benchmarks" / "bench_thresholds.json"
# int8 codec: the kernel against its plain version on these shapes (every
# R x C, both blocks, f32 and bf16 in and out), bit for bit; then the
# full-width llama3.2-3b gradient pytree at bf16 through ops.quantize and
# ops.dequantize, within codec_error_bound
CODEC_ROWS = (1, 255, 257, 4096)
CODEC_COLS = (256, 3072, 8192)
CODEC_BLOCKS = (128, 256)
# bytes plane at world size 1: every stock policy, nk_grad_sync repeats
BYTES_POLICIES = ("xla", "ring", "hierarchical", "compressed", "shm-first")
BYTES_AXES = ("pod", "data", "model")
BYTES_REPS = 3
# fairness: benchmarks/bench_fairness.py's parameters (bytes/s, seconds)
# the train phase: llama3.2-3b at full width and depth, the train_4k
# shape's length, one sequence per micro-batch
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_ACCUM = 4
TRAIN_TIMED = 3               # timed steps, after one warm-up step
TRAIN_PROFILE_LAYERS = 4      # the profiled micro-batch's depth (of 28)
# RunConfig's defaults but for the schedule: with its 100 warm-up steps
# the first steps' lr (3e-6 to 1.2e-5) moves a bf16 norm scale of 1.0 by
# less than half an ulp (0.002), so those scales could not move at all
TRAIN_LR = 3e-3
TRAIN_WARMUP = 1
TRAIN_TOL = 2e-2              # bf16 kernel path vs plain path, full depth
TRAIN_F32_LAYERS = 2
TRAIN_F32_TOL = {"loss": 1e-5, "grad": 1e-4}
TRAIN_FT_LAYERS = 2           # fault tolerance: a checkpoint of ~6 GB
TRAIN_FT_STEPS = 5
TRAIN_FT_CKPT_EVERY = 3
TRAIN_FT_FAIL_AT = 4
TRAIN_MIN_DISK = 16e9         # bytes free where the checkpoints go
# the sharded train phase: llama3.2-3b at full width and 4 of 28 layers
# (the train profile's cut), the train phase's batch, 2 Runner steps on
# each path; a profiled sharded micro-batch at 1 layer; flash under
# autograd at each TP rank's shapes of a 4,096-token sequence
SHARDED_TRAIN_LAYERS = 4
SHARDED_TRAIN_STEPS = 2
SHARDED_PROFILE_LAYERS = 1
TRAIN_RANK_S = 4096

# the ssm, hybrid and encdec trainers: (arch, sequence, global batch) at
# full width and depth, grad_accum TRAIN_ACCUM, FAMILY_STEPS steps each;
# whisper's 448 tokens come with the pipeline's 1500 f32 frames
FAMILY_TRAINERS = (("mamba2-370m", TRAIN_SEQ, TRAIN_BATCH),
                   ("hymba-1.5b", TRAIN_SEQ, TRAIN_BATCH),
                   ("whisper-small", ENCDEC_MAX_SEQ, 16))
FAMILY_STEPS = 2
FAMILY_F32_TOL = 1e-4         # loss and grads, f32, 2 layers
FAMILY_FT_ARCH = "mamba2-370m"   # the one whose recovery is checked
FLOOR_NUDGE = 2 ** -8         # relative, about one bf16 ulp: noise floors
# the sharded train phase of the ssm, hybrid and encdec families: (arch,
# decoder layers, encoder layers, sequence, global batch) at full width
# and cut depth (hymba keeps its global layer 0 and a windowed segment),
# "2d" at a world of one, the trainers' batches, SHARDED_TRAIN_STEPS
# Runner steps on each path, as the sharded train phase; a profiled sharded micro-batch at 1 layer
# (whisper 1 + 1); then the sharded path again with Megatron-SP, its
# micro-batch and SHARDED_TRAIN_STEPS steps. Then each TP train rank's
# SsdScanFn (mamba2's 32 / tp heads, hymba's 25 at tp 2 and 50 whole
# past it) and f32 flash at whisper's encoder rank heads (12 / tp,
# padded at 8 and 16)
SHARDED_FAMILIES = (("mamba2-370m", 8, 0, TRAIN_SEQ, TRAIN_BATCH),
                    ("hymba-1.5b", 4, 0, TRAIN_SEQ, TRAIN_BATCH),
                    ("whisper-small", 2, 2, ENCDEC_MAX_SEQ, 16))
TRAIN_RANK_SSD = (("mamba2", (SSD_Q, SSD_H, SSD_P, SSD_N), TRAIN_SEQ // SSD_Q),
                  ("hymba", HYBRID_SSD, TRAIN_SEQ // HYBRID_SSD[0]))
TRAIN_RANK_ENC = (4, ENCDEC_FRAMES, ENCDEC_HEADS[0], ENCDEC_D)  # B, S, H, d
# the moe family's sharded train phase: deepseek-v2-236b at full width,
# its dense prefix layer and one moe layer of 60 (5.5B parameters: ~44 GB
# of state at bf16 moments and accumulators), one device and a world of
# one with Megatron-SP; the grads held sharded against unsharded
SHARDED_MOE_ARCH = "deepseek-v2-236b"
SHARDED_MOE_LAYERS = 2
SHARDED_MOE_SEQ = TRAIN_SEQ
SHARDED_MOE_KEEP = ("moe.router", "moe.w_in", "attn.w_dkv")
TRAIN_RANK_MLA = (128, 192, 128)      # heads, dk, dv (v zero-padded)
# the launch phase (launch/dryrun.py, launch/roofline.py): the dry-run
# table on meta for both production meshes; two of its cells made on the
# card as one rank's shard of 16x16, whose rise in memory_allocated must
# lie within the caching allocator's rounding (512 bytes a tensor) of the
# meta count; llama3.2-3b's micro-batch at the train profile's depth
# under remat "full" and "dots"
LAUNCH_CELLS = (("llama3.2-3b", "decode_32k"),
                ("deepseek-v2-236b", "train_4k"))
LAUNCH_MESH = "16x16"
ALLOC_ROUND = 512
DOTS_LAYERS = TRAIN_PROFILE_LAYERS
DOTS_TIMED = 3                # timed micro-batches a policy, after one
DOTS_TOL = 1e-3               # "dots" vs "full" grads, of max |g|, bf16

# the distribution phase: the model axis's per-rank kernel work. The cp
# decode at chameleon-34b's decode_32k shape (the reference's motivating
# case) and at llama3.2-3b's heads, its cache cut into tp contiguous
# chunks; positions at 0, at chunk - 1 and chunk of every tp's chunks and
# at the last slot, then between them; with a window of 4,096 too
CP_B, CP_T = 8, 32768
CP_TP = (2, 4, 8, 16)
CP_WINDOW = 4096
CP_POS_EDGES = (0, 2047, 2048, 4095, 4096, 8191, 8192, 32767)
CP_POS_MID = (16383, 16384, 1, 100, 5000, 12345, 20000, 30000)
CP_TOL = {"bfloat16": 4.2e-3, "float32": 1e-5}   # of max |o|
TP_FLASH_S = 509              # llama3.2-3b's prefill at each rank's heads
TP_BYTES_AXIS = 16            # per-rank weight bytes at model = 16
FAIR_CAPACITY = 1_000_000.0
FAIR_DT = 0.05
FAIR_T_RUN = 12.0
FAIR_BACKEND_TOL = 1e-6        # |vectorized - object| / capacity, per tick


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
    the wrapper's Python overhead. ``flush="write"`` writes 64 MB, which
    leaves the L2 full of dirty lines that the timed kernel's reads write
    back first; ``flush="read"`` reads them and leaves the L2 clean."""

    SLEEP_CYCLES = 2_000_000      # ~1 ms at H100 clocks

    def __init__(self, torch, device, flush: str = "write"):
        self.torch = torch
        self.flush = flush
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if self.flush == "write":
                self.flush_buf.zero_()
            else:
                self.flush_buf.sum(dtype=torch.int64)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's enqueue time per call of ``fn``: ``calls`` calls back to
    back with no synchronize between them, on the host clock."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def sdpa_backend(torch, q, k, v, **kw):
    """The backend ``scaled_dot_product_attention`` dispatches these inputs
    to, by its own choice function, as an ``SDPBackend``."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw))


def library_row(torch, timer, q, k, v, **kw):
    """``scaled_dot_product_attention`` on these inputs, timed with its
    backend pinned to the one it dispatches to."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel
    backend = sdpa_backend(torch, q, k, v, **kw)
    with sdpa_kernel([backend]):
        ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))
    return {"library_ms": ms, "library": "scaled_dot_product_attention",
            "library_backend": backend.name}


def bound(nbytes: float, flops: float, dtype: str, route: str = ""):
    """(least ms, "bytes" or "operations"): ``roofline.bound_ms``, imported
    at the call so that importing this script imports nothing of the port
    (the tools that time two trees put the other tree's ``src`` first).
    ``route``: the flash kernel that takes the work
    (``flash_attention.route``); ``"tf32x3"`` runs f32 on the tensor cores
    as three TF32 products, so its operations count at
    ``PEAK_FLOPS_F32_TENSOR``."""
    from repro_torch.launch.roofline import PEAK_FLOPS_F32_TENSOR, bound_ms
    return bound_ms(nbytes, flops, dtype,
                    PEAK_FLOPS_F32_TENSOR if route == "tf32x3" else None)


def flash_work(b, s, t, hq, kv, d, elem, causal, window, dv=None):
    """Bytes (q read once, o written once, and k and v read once over
    the keys the mask keeps for some query: the first S of T where a
    causal S is below T) and flops (QK^T and PV over the (query, key)
    pairs the mask keeps). ``dv``: v's and o's head dim where the function
    needs fewer columns than q and k's ``d`` (MLA: the kernel's zero-padded
    columns are not the function's work)."""
    dv = d if dv is None else dv
    pairs, keys = 0, set()
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(hi - lo + 1, 0)
        keys.update((lo, hi + 1))
    kept = max(keys) - min(keys) if keys else 0
    nbytes = elem * (b * s * hq * (d + dv) + b * kept * kv * (d + dv))
    return nbytes, 2.0 * (d + dv) * pairs * hq * b


def ssd_work(nc, elem, shape=None):
    """Bytes (x*dt, B, C in ``elem`` bytes and dA in f32 read once; y in
    f32, the states, decays and state decays written once) and flops (per
    chunk: C.B^T over the Q(Q+1)/2 causal pairs once, M.x over them per
    head, the state x^T B per head) of the SSD scan over ``nc`` chunks of
    ``shape`` (Q, H, P, N; mamba2-370m's by default)."""
    q, h, p, n = shape or (SSD_Q, SSD_H, SSD_P, SSD_N)
    pairs = q * (q + 1) // 2
    nbytes = nc * (q * h * p * elem + q * h * 4 + 2 * q * n * elem
                   + q * h * p * 4 + h * p * n * 4 + h * 4 + q * h * 4)
    flops = nc * (2.0 * pairs * n + h * 2.0 * pairs * p + h * 2.0 * q * p * n)
    return nbytes, flops


def decode_work(pos, t, hq, kv, d, q_elem, kv_elem):
    live = sum(min(p, t - 1) + 1 for p in pos)
    b = len(pos)
    nbytes = (2 * live * kv * d * kv_elem + 2 * b * hq * d * q_elem
              + 2 * b * hq * 4 + 4 * b)
    return nbytes, 4.0 * d * live * hq


def flash_routed(flash_attention, q, k, v, **kw):
    """One ``flash_attention`` call on the card: (its output, the route it
    took). Raises unless it launched once, on the route that
    ``flash_attention.route`` gives its dtype and head dim (f32 at D 64
    and 128: ``"tf32x3"``, the tensor cores)."""
    from repro_torch.kernels.flash_attention import route
    by = dict(flash_attention.launches_by_route)
    took = route(q.dtype, q.shape[-1])
    o = flash_attention(q, k, v, **kw)
    if flash_attention.launches_by_route != {**by, took: by[took] + 1}:
        raise AssertionError(f"flash_attention {q.dtype} D {q.shape[-1]}: "
                             f"launches by route {by} -> "
                             f"{flash_attention.launches_by_route}, want "
                             f"one on {took}")
    return o, took


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(torch, device):
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    # "flash_attention_tf32x3": the f32 calls at D 64 and 128 alone (three
    # TF32 products on the tensor cores)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "flash_attention_tf32x3": 0.0}
    # (B, S, T, dtype, window, q_offset, (hq, kv), d): the path's prefills,
    # the replay phase's 2-token prompts, a ragged second q tile, a later
    # chunk of two sequences (T > S), a window, the f32 kernel;
    # chameleon-34b's prefills at 64/8 heads; hymba-1.5b's at 25/5 heads
    # and d 64: the 1024-token window over 1536 and 1100 tokens (the first
    # live kv tile of a q tile cut by the window's edge), a global layer,
    # and the f32 parity's windowed prefill; the train phase's sequence
    # (32 kv tiles, the kernel's longest loop), and hymba's trained
    # micro-batch of it, windowed and global
    cases = [(1, s, s, "bfloat16", 0, 0, LLAMA_HEADS)
             for s in (64, 509, 1024, TRAIN_SEQ)]
    cases += [(1, 1, 1, "bfloat16", 0, 0, LLAMA_HEADS),
              (1, 2, 2, "bfloat16", 0, 0, LLAMA_HEADS),
              (1, 65, 65, "bfloat16", 0, 0, LLAMA_HEADS),
              (2, 100, 300, "bfloat16", 0, 200, LLAMA_HEADS),
              (1, 509, 509, "bfloat16", 128, 0, LLAMA_HEADS),
              (1, 509, 509, "float32", 0, 0, LLAMA_HEADS)]
    cases += [(1, s, s, "bfloat16", 0, 0, heads) for s in (64, 509)
              for heads in (VLM_HEADS, ARCTIC_HEADS)]
    cases = [c + (128,) for c in cases]
    cases += [(1, 1536, 1536, "bfloat16", HYBRID_WINDOW, 0, HYBRID_HEADS,
               HYBRID_D),
              (1, 1100, 1100, "bfloat16", HYBRID_WINDOW, 0, HYBRID_HEADS,
               HYBRID_D),
              (1, 1536, 1536, "bfloat16", 0, 0, HYBRID_HEADS, HYBRID_D),
              (1, HYBRID_PARITY_PROMPT, HYBRID_PARITY_PROMPT, "float32",
               HYBRID_WINDOW, 0, HYBRID_HEADS, HYBRID_D)]
    cases += [(TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, TRAIN_SEQ, "bfloat16",
               window, 0, HYBRID_HEADS, HYBRID_D)
              for window in (HYBRID_WINDOW, 0)]
    for b, s, t, dt, window, q_offset, (hq, kv), d in cases:
        dtype = getattr(torch, dt)
        q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
        k = torch.randn((b, t, kv, d), generator=gen, device=device).to(dtype)
        v = torch.randn((b, t, kv, d), generator=gen, device=device).to(dtype)
        o, took = flash_routed(flash_attention, q, k, v, causal=True,
                               window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=True, window=window,
                                    q_offset=q_offset)
        err = (o.float() - ref.float()).abs().max().item()
        ok = err <= FLASH_TOL[dt] and bool(torch.isfinite(o).all())
        emit({"phase": "kernels", "kernel": "flash_attention", "B": b,
              "S": s, "T": t, "hq": hq, "kv": kv, "d": d, "dtype": dt,
              "window": window, "route": took,
              "q_offset": q_offset, "max_abs_err": err,
              "tol": FLASH_TOL[dt], "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention B={b} S={s} T={t} "
                                 f"heads {hq}/{kv} {dt} "
                                 f"window={window} q_offset={q_offset}: "
                                 f"err {err} > {FLASH_TOL[dt]}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        if took == "tf32x3":
            errs["flash_attention_tf32x3"] = max(
                errs["flash_attention_tf32x3"], err)
    # (B, T, q dtype, pos, (hq, kv)): the serve phase's cache, the replay
    # and cluster phases' (REPLAY_SLOTS slots of REPLAY_MAX_SEQ positions),
    # chameleon-34b's cache at 64/8 heads, and arctic-480b's at 56/8 (group
    # 7: bf16 q on the tensor-core path, f32 q on the CUDA-core one)
    d = 128
    for b, t, dt, pos_list, (hq, kv) in (
            (8, 1024, "bfloat16", DECODE_POS, LLAMA_HEADS),
            (8, 1024, "bfloat16", SERVE_DECODE_POS, LLAMA_HEADS),
            (8, 1024, "float32", DECODE_POS, LLAMA_HEADS),
            (REPLAY_SLOTS, REPLAY_MAX_SEQ, "bfloat16", REPLAY_DECODE_POS,
             LLAMA_HEADS),
            (8, 1024, "bfloat16", DECODE_POS, VLM_HEADS),
            (8, 1024, "bfloat16", SERVE_DECODE_POS, VLM_HEADS),
            (8, 1024, "bfloat16", DECODE_POS, ARCTIC_HEADS),
            (8, 1024, "bfloat16", SERVE_DECODE_POS, ARCTIC_HEADS),
            (8, 1024, "float32", DECODE_POS, ARCTIC_HEADS)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(getattr(torch, dt))
        kc = torch.randn((b, t, kv, d), generator=gen,
                         device=device).to(torch.bfloat16)
        vc = torch.randn((b, t, kv, d), generator=gen,
                         device=device).to(torch.bfloat16)
        o, m, l = decode_attention(q, kc, vc, pos)
        # a second call on the same inputs: the in-launch combine sums in
        # a fixed order, so it is bit-identical
        o2, m2, l2 = decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(m, m2) \
            and torch.equal(l, l2)
        ro, rm, rl = decode_attention_plain(q, kc, vc, pos)
        e_o = (o.float() - ro.float()).abs().max().item()
        e_m = (m - rm).abs().max().item()
        e_l = ((l - rl).abs() / rl.abs()).max().item()
        tol = DECODE_TOL[dt]
        ok = e_o <= tol["o"] and e_m <= tol["m"] and e_l <= tol["l"] \
            and bool(torch.isfinite(o).all()) and same
        emit({"phase": "kernels", "kernel": "decode_attention", "B": b,
              "T": t, "hq": hq, "kv": kv, "q_dtype": dt, "cache_dtype": "bfloat16",
              "pos": list(pos_list), "max_abs_err_o": e_o,
              "max_abs_err_m": e_m, "max_rel_err_l": e_l, "tol": tol,
              "repeat_bit_identical": same, "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention B={b} T={t} heads "
                                 f"{hq}/{kv} {dt} pos "
                                 f"{pos_list}: o "
                                 f"{e_o}, m {e_m}, l {e_l} against {tol}, "
                                 f"repeat identical {same}")
        errs["decode_attention"] = max(errs["decode_attention"], e_o)
    errs["decode_attention"] = max(errs["decode_attention"],
                                   hybrid_decode_cases(torch, device, gen))
    for k, v in nemotron_kernel_cases(torch, device, gen).items():
        errs[k] = max(errs[k], v)
    for k, v in encdec_kernel_cases(torch, device, gen).items():
        errs[k] = max(errs[k], v)
    return errs


def nemotron_kernel_cases(torch, device, gen):
    """Head dim 192: nemotron-4-340b's flash at 96/8 heads (S 64 and 509,
    bf16; S 300, f32) and deepseek-v2-236b's MLA prefill at 128/128 with v
    zero-padded from 128 (S 509 bf16, S 300 f32), each against its plain
    version within ``FLASH_TOL``; nemotron's decode at group 12 over 8
    caches of 1024 at mixed and serve-range positions (bf16 q and cache,
    twice, bit-identical), and with f32 queries over a bf16 and an f32
    cache, within ``DECODE_TOL``. Returns the worst |kernel - plain| of
    each kernel."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    d = NEMOTRON_D
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for s, dt, (hq, kv), dv in (
            (64, "bfloat16", NEMOTRON_HEADS, d),
            (509, "bfloat16", NEMOTRON_HEADS, d),
            (300, "float32", NEMOTRON_HEADS, d),
            (509, "bfloat16", MLA_HEADS, MLA_DV),
            (300, "float32", MLA_HEADS, MLA_DV)):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
                   .to(dtype) for h in (hq, kv, kv))
        v[..., dv:] = 0
        o = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        err = (o.float() - ref.float()).abs().max().item()
        ok = err <= FLASH_TOL[dt] and bool(torch.isfinite(o).all()) \
            and not o[..., dv:].any()
        emit({"phase": "kernels", "kernel": "flash_attention", "B": 1,
              "S": s, "T": s, "hq": hq, "kv": kv, "d": d, "v_cols": dv,
              "dtype": dt, "max_abs_err": err, "tol": FLASH_TOL[dt],
              "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention S={s} heads {hq}/{kv} "
                                 f"d {d} (v {dv}) {dt}: err {err} > "
                                 f"{FLASH_TOL[dt]} or padded columns set")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    (hq, kv), b, t = NEMOTRON_HEADS, 8, 1024
    for q_dt, kv_dt, pos_list in (
            ("bfloat16", "bfloat16", DECODE_POS),
            ("bfloat16", "bfloat16", SERVE_DECODE_POS),
            ("float32", "bfloat16", DECODE_POS),
            ("float32", "float32", SERVE_DECODE_POS)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(getattr(torch, q_dt))
        kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
                  .to(getattr(torch, kv_dt)) for _ in range(2))
        o, m, l = decode_attention(q, kc, vc, pos)
        again = decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((o, m, l), again))
        ro, rm, rl = decode_attention_plain(q, kc, vc, pos)
        e_o = (o.float() - ro.float()).abs().max().item()
        e_m = (m - rm).abs().max().item()
        e_l = ((l - rl).abs() / rl.abs()).max().item()
        tol = DECODE_TOL[q_dt]
        ok = e_o <= tol["o"] and e_m <= tol["m"] and e_l <= tol["l"] \
            and bool(torch.isfinite(o).all()) and same
        emit({"phase": "kernels", "kernel": "decode_attention", "B": b,
              "T": t, "hq": hq, "kv": kv, "d": d, "q_dtype": q_dt,
              "cache_dtype": kv_dt, "pos": list(pos_list),
              "max_abs_err_o": e_o, "max_abs_err_m": e_m,
              "max_rel_err_l": e_l, "tol": tol,
              "repeat_bit_identical": same, "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention group 12, d {d} "
                                 f"{q_dt}/{kv_dt} pos {pos_list}: o {e_o}, "
                                 f"m {e_m}, l {e_l} against {tol}, repeat "
                                 f"identical {same}")
        errs["decode_attention"] = max(errs["decode_attention"], e_o)
    return errs


def hybrid_decode_cases(torch, device, gen):
    """hymba-1.5b's decode at 25/5 heads (group 5), d 64, 8 slots: a ring
    step of 1024 slots at ``RING_DECODE_POS`` (the kernel reads the ring as
    a linear cache at ``pos_eff = min(pos, 1023)``, no window), held
    against its plain version on the same inputs and against the
    reference's decode over absolute slot positions (``kv_pos``, the
    window mask; p kept in f32, as the kernel keeps it); a global layer's
    cache of 2048 at ``GLOBAL_DECODE_POS``;
    the ring again at f32 (the f32 parity's path). Twice each,
    bit-identical. Returns the worst |kernel - plain| of o."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.models.attention import decode_attention as by_kv_pos
    from repro_torch.models.attention import q_to_kv_map, ring_slots
    (hq, kv), d, b = HYBRID_HEADS, HYBRID_D, 8
    worst = 0.0
    for t, dt, pos_list, ring in (
            (HYBRID_WINDOW, "bfloat16", RING_DECODE_POS, True),
            (HYBRID_MAX_SEQ, "bfloat16", GLOBAL_DECODE_POS, False),
            (HYBRID_WINDOW, "float32", RING_DECODE_POS, True)):
        dtype = getattr(torch, dt)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen, device=device).to(dtype)
        kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
                  .to(dtype) for _ in range(2))
        slots = ring_slots(pos, t, kv_pos=True) if ring else None
        at = slots.pos_eff if ring else pos
        o, m, l = decode_attention(q, kc, vc, at)
        again = decode_attention(q, kc, vc, at)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((o, m, l), again))
        ro, rm, rl = decode_attention_plain(q, kc, vc, at)
        e_o = (o.float() - ro.float()).abs().max().item()
        e_m = (m - rm).abs().max().item()
        e_l = ((l - rl).abs() / rl.abs()).max().item()
        tol = DECODE_TOL[dt]
        e_ref = None
        if ring:    # the ring as the reference reads it, p kept in f32
            want = by_kv_pos(q[:, None].float(), kc, vc, pos,
                             kv_map=q_to_kv_map(hq, hq, kv, device),
                             window=HYBRID_WINDOW, kv_pos=slots.kv_pos)
            e_ref = (o.float() - want[:, 0].float()).abs().max().item()
        ok = e_o <= tol["o"] and e_m <= tol["m"] and e_l <= tol["l"] \
            and (e_ref is None or e_ref <= tol["o"]) \
            and bool(torch.isfinite(o).all()) and same
        emit({"phase": "kernels", "kernel": "decode_attention", "B": b,
              "T": t, "hq": hq, "kv": kv, "d": d, "q_dtype": dt,
              "cache_dtype": dt, "ring": ring, "pos": list(pos_list),
              "kernel_pos": at.tolist(), "max_abs_err_o": e_o,
              "max_abs_err_m": e_m, "max_rel_err_l": e_l,
              "max_abs_err_o_vs_kv_pos_decode": e_ref, "tol": tol,
              "repeat_bit_identical": same, "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention hymba T={t} {dt} ring "
                                 f"{ring}: o {e_o}, m {e_m}, l {e_l}, "
                                 f"kv_pos decode {e_ref} against {tol}, "
                                 f"repeat identical {same}")
        worst = max(worst, e_o)
    return worst


def encdec_kernel_cases(torch, device, gen):
    """whisper-small's attention shapes (12/12 heads, d 64), each against
    its plain version: flash bidirectional over 1500 frames (the encoder;
    bf16 at serving, f32 in training), flash causal with S 4 and 448
    below T 1500 (the decoder's cross-attention at prefill and in
    training: position t sees frames 0..t, ROADMAP R8), flash causal at S
    = T 4 and 448 (the decoder's self-attention at the served prefill and
    in a trained micro-batch, bf16), decode at group 1
    over 1500 frames at pos 1499 (the cross decode; bf16, and f32 with an
    f32 cache for the f32 parity) and over 448 slots at the serve range
    of positions (the self decode). Returns the worst |kernel - plain| of
    flash and of decode."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    (hq, kv), d, t = ENCDEC_HEADS, ENCDEC_D, ENCDEC_FRAMES
    worst = {"flash_attention": 0.0, "decode_attention": 0.0,
             "flash_attention_tf32x3": 0.0}
    micro = FAMILY_TRAINERS[-1][2] // TRAIN_ACCUM
    # the last two: the trained micro-batch's f32 encoder and
    # cross-attention, the shapes the train phases launch the tf32x3
    # route at
    for b, s, tk, dt, causal in (
            (2, t, t, "bfloat16", False),
            (2, t, t, "float32", False),
            (ENCDEC_BATCH, ENCDEC_PROMPT, t, "bfloat16", True),
            (2, ENCDEC_MAX_SEQ, t, "bfloat16", True),
            (2, ENCDEC_MAX_SEQ, t, "float32", True),
            (ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_PROMPT, "bfloat16", True),
            (micro, ENCDEC_MAX_SEQ, ENCDEC_MAX_SEQ, "bfloat16", True),
            (micro, t, t, "float32", False),
            (micro, ENCDEC_MAX_SEQ, t, "float32", True)):
        dtype = getattr(torch, dt)
        q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((b, tk, kv, d), generator=gen, device=device)
                .to(dtype) for _ in range(2))
        o, took = flash_routed(flash_attention, q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=causal)
        err = (o.float() - ref.float()).abs().max().item()
        ok = err <= FLASH_TOL[dt] and bool(torch.isfinite(o).all())
        emit({"phase": "kernels", "kernel": "flash_attention",
              "model": "whisper-small", "B": b, "S": s, "T": tk, "hq": hq,
              "kv": kv, "d": d, "dtype": dt, "causal": causal,
              "route": took, "max_abs_err": err, "tol": FLASH_TOL[dt],
              "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention whisper B={b} S={s} "
                                 f"T={tk} {dt} causal={causal}: err {err}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        if took == "tf32x3":
            worst["flash_attention_tf32x3"] = max(
                worst["flash_attention_tf32x3"], err)
    for tt, dt, cdt, pos_list in (
            (t, "bfloat16", "bfloat16", (t - 1,) * ENCDEC_BATCH),
            (t, "float32", "float32", (t - 1,) * ENCDEC_BATCH),
            (ENCDEC_MAX_SEQ, "bfloat16", "bfloat16", ENCDEC_DECODE_POS)):
        b = len(pos_list)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(getattr(torch, dt))
        kc, vc = (torch.randn((b, tt, kv, d), generator=gen, device=device)
                  .to(getattr(torch, cdt)) for _ in range(2))
        o, m, l = decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        ro, rm, rl = decode_attention_plain(q, kc, vc, pos)
        e_o = (o.float() - ro.float()).abs().max().item()
        e_m = (m - rm).abs().max().item()
        e_l = ((l - rl).abs() / rl.abs()).max().item()
        tol = DECODE_TOL[dt]
        ok = e_o <= tol["o"] and e_m <= tol["m"] and e_l <= tol["l"] \
            and bool(torch.isfinite(o).all())
        emit({"phase": "kernels", "kernel": "decode_attention",
              "model": "whisper-small", "B": b, "T": tt, "hq": hq,
              "kv": kv, "d": d, "q_dtype": dt, "cache_dtype": cdt,
              "pos": list(pos_list), "max_abs_err_o": e_o,
              "max_abs_err_m": e_m, "max_rel_err_l": e_l, "tol": tol,
              "ok": ok})
        if not ok:
            raise AssertionError(f"decode_attention whisper T={tt} {dt}: "
                                 f"o {e_o}, m {e_m}, l {e_l} against {tol}")
        worst["decode_attention"] = max(worst["decode_attention"], e_o)
    return worst


def ssd_fn_cases(torch, device):
    """``SsdScanFn`` on the card at the two trainers' shapes (mamba2-370m:
    16 chunks of Q 256, H 32, P 64, N 128; hymba-1.5b: 32 chunks of Q 128,
    H 50, P 64, N 16), bf16 and f32: its outputs are the kernel's, bit for
    bit, and its gradients of xdt, dA, B and C (random cotangents on all
    four outputs) are autograd's through the plain version on the same
    inputs, within 1e-6 of each gradient's largest value."""
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain)
    from repro_torch.models.ssm import SsdScanFn
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    for name, nc, shape in (("mamba2-370m", 16, None),
                            ("hymba-1.5b", 32, HYBRID_SSD)):
        for dt in ("bfloat16", "float32"):
            ins = [x.requires_grad_() for x in ssd_inputs(
                torch, gen, device, nc, dt, shape=shape)]
            outs = SsdScanFn.apply(*ins)
            with torch.no_grad():
                kern = ssd_chunk_scan(*ins, out_dtype=torch.float32,
                                      state_decay=True)
            plain = ssd_chunk_scan_plain(*ins, out_dtype=torch.float32,
                                         state_decay=True)
            cots = [torch.randn(o.shape, generator=gen, device=device)
                    for o in outs]
            got = torch.autograd.grad(outs, ins, cots)
            want = torch.autograd.grad(plain, ins, cots)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, kern))
            gaps = [rel_err(a, b) for a, b in zip(got, want)]
            ok = same and max(gaps) <= 1e-6 and all(
                bool(torch.isfinite(g).all()) for g in got)
            emit({"phase": "kernels", "kernel": "ssd_chunk_scan",
                  "check": "SsdScanFn", "model": name, "nc": nc,
                  "dtype": dt, "outputs_are_the_kernels": same,
                  "grad_gaps": dict(zip(("xdt", "dA", "B", "C"), gaps)),
                  "tol": 1e-6, "ok": ok})
            if not ok:
                raise AssertionError(f"SsdScanFn {name} {dt}: outputs "
                                     f"{same}, grad gaps {gaps}")


def water_case(np, n, seed, kind="mixed", cap=CONTROL_CAPACITY):
    """Seeded demands and weights (numpy f64) and a capacity: satisfiable,
    large and inf demands, zero demands, zero and negative weights; or an
    edge case (all parked, capacity 0, every demand inf)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.1, 2.0, n) * cap / n
    d[rng.random(n) < 0.2] *= 50.0
    d[rng.random(n) < 0.1] = np.inf
    d[rng.random(n) < 0.05] = 0.0
    w = rng.choice([0.5, 1.0, 2.0, 4.0], n)
    w[rng.random(n) < 0.05] = 0.0
    w[rng.random(n) < 0.03] = -1.0
    if kind == "parked":
        w[:] = 0.0
    elif kind == "zero_cap":
        cap = 0.0
    elif kind == "all_inf":
        d[:] = np.inf
        w = np.abs(w) + 0.5
    return d, w, cap


def phase_water_fill(torch, device):
    """The water-fill kernel against its plain version (1e-9 x capacity)
    and the exact sort-based fill (1e-6 x capacity), twice on the same
    input (bit-identical). Returns the worst |kernel - plain|."""
    import numpy as np
    from repro_torch.kernels.ref import water_fill_ref
    from repro_torch.kernels.waterfill import water_fill, water_fill_plain
    cases = [(n, "mixed") for n in WATER_N]
    cases += [(1000, "parked"), (100_000, "parked"), (1000, "zero_cap"),
              (100_000, "all_inf"), (1_048_576, "all_inf")]
    worst = 0.0
    for n, kind in cases:
        d, w, cap = water_case(np, n, seed=n, kind=kind)
        dd, ww = (torch.tensor(x, dtype=torch.float64, device=device)
                  for x in (d, w))
        alloc, level = water_fill(dd, ww, cap)
        again, level2 = water_fill(dd, ww, cap)
        torch.cuda.synchronize()
        same = bool(torch.equal(alloc, again) and torch.equal(level,
                                                              level2))
        plain, _ = water_fill_plain(dd, ww, cap)
        exact = water_fill_ref(dd, ww, cap)
        e_plain = (alloc - plain).abs().max().item()
        e_exact = (alloc - exact).abs().max().item()
        scale = max(cap, 1.0)
        ok = (same and e_plain <= WATER_TOL_PLAIN * scale
              and e_exact <= WATER_TOL_EXACT * scale
              and bool(torch.isfinite(alloc).all())
              and (kind not in ("parked", "zero_cap")
                   or not bool(alloc.any())))
        emit({"phase": "kernels", "kernel": "water_fill", "n": n,
              "case": kind, "dtype": "float64", "capacity": cap,
              "max_abs_err_plain": e_plain, "max_abs_err_exact": e_exact,
              "tol_plain": WATER_TOL_PLAIN * scale,
              "tol_exact": WATER_TOL_EXACT * scale,
              "bit_identical_repeat": same, "level": float(level),
              "ok": ok})
        if not ok:
            raise AssertionError(f"water_fill n={n} {kind}: plain {e_plain}"
                                 f", exact {e_exact}, repeat {same}")
        worst = max(worst, e_plain)
    return worst


def ssd_inputs(torch, gen, device, nc, dtype, *, dt_scale=1.0,
               pad_rows=0, shape=None):
    """Model-like SSD inputs for one sequence of ``nc`` chunks of ``shape``
    (Q, H, P, N; mamba2-370m's by default): dt = softplus(N(0,1)) (about
    0.7) times ``dt_scale``, dA = -dt (A = -1, the reference's init), x*dt
    with x ~ N(0, 0.25), B and C ~ N(0, 0.25). At ``dt_scale`` 1 the cumsum
    reaches about -180 in a 256-token chunk. The last ``pad_rows`` rows of
    the last chunk are zero x*dt and dA, as ``ssd_chunked`` pads a
    prompt."""
    Q, H, P, N = shape or (SSD_Q, SSD_H, SSD_P, SSD_N)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    dt = torch.nn.functional.softplus(randn(1, nc, Q, H)) * dt_scale
    xdt = randn(1, nc, Q, H, P) * 0.5 * dt[..., None]
    dA = -dt
    if pad_rows:
        xdt[:, -1, Q - pad_rows:] = 0.0
        dA[:, -1, Q - pad_rows:] = 0.0
    B, C = (randn(1, nc, Q, N) * 0.5 for _ in range(2))
    dt_ = getattr(torch, dtype)
    return xdt.to(dt_), dA, B.to(dt_), C.to(dt_)


def phase_ssd(torch, device):
    """The SSD scan kernel against its plain version at mamba2-370m's width
    (Q 256, H 32, P 64, N 128): bf16 at 1, 2 and 16 chunks (the second
    with a padded last chunk, one with dt scaled down so the decay reaches
    across the chunk; 16 is a training sequence), f32 at 2 chunks; and at
    hymba-1.5b's (Q 128, H 50, P 64, N 16): bf16 at 12 chunks (a
    1536-token prompt) and 32 (a training sequence), bf16 and f32 at 11
    with 108 padded rows (the 1300-token parity prompt); all four outputs,
    the state decay included. Then ``SsdScanFn`` at the training shapes
    (``ssd_fn_cases``). Returns the worst |kernel - plain| of y, and of y
    at hymba's bf16 cases alone (the ``"heads"`` route)."""
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    mamba = (SSD_Q, SSD_H, SSD_P, SSD_N)
    pad = 11 * HYBRID_SSD[0] - HYBRID_PARITY_PROMPT
    cases = [(1, "bfloat16", 1.0, 0, mamba), (2, "bfloat16", 1.0, 56, mamba),
             (16, "bfloat16", 1.0, 0, mamba),
             (2, "bfloat16", 0.01, 0, mamba),
             (2, "float32", 1.0, 56, mamba),
             (HYBRID_SSD_CHUNKS, "bfloat16", 1.0, 0, HYBRID_SSD),
             (11, "bfloat16", 1.0, pad, HYBRID_SSD),
             (11, "float32", 1.0, pad, HYBRID_SSD),
             (32, "bfloat16", 1.0, 0, HYBRID_SSD)]
    worst = worst_heads = 0.0
    for nc, dt, dt_scale, pad, shape in cases:
        xdt, dA, B, C = ssd_inputs(torch, gen, device, nc, dt,
                                   dt_scale=dt_scale, pad_rows=pad,
                                   shape=shape)
        y, st, dec, sd = ssd_chunk_scan(xdt, dA, B, C,
                                        out_dtype=torch.float32,
                                        state_decay=True)
        torch.cuda.synchronize()
        ry, rst, rdec, rsd = ssd_chunk_scan_plain(
            xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (y, st, dec, sd))
        e_y = (y - ry).abs().max().item()
        e_st = (st - rst).abs().max().item()
        e_dec = (dec - rdec).abs().max().item()
        e_sd = (sd - rsd).abs().max().item()
        cs_min = torch.cumsum(dA[0].float(), dim=1).min().item()
        if dt == "float32":    # the reference's own bounds, abs + rel
            tol = SSD_TOL["float32"]
            ok = all(bool(((a - b).abs() <= tol * (1 + b.abs())).all())
                     for a, b in ((y, ry), (st, rst)))
            ok = ok and all(bool(((a - b).abs()
                                  <= SSD_TOL_DECAY * (1 + b.abs())).all())
                            for a, b in ((dec, rdec), (sd, rsd)))
            bound = {"y": tol, "states": tol, "decay": SSD_TOL_DECAY,
                     "state_decay": SSD_TOL_DECAY}
        else:                  # relative to the largest value
            tol = SSD_TOL["bfloat16"]
            bound = {"y": tol * ry.abs().max().item(),
                     "states": tol * rst.abs().max().item(),
                     "decay": SSD_TOL_DECAY, "state_decay": SSD_TOL_DECAY}
            ok = e_y <= bound["y"] and e_st <= bound["states"] and \
                e_dec <= bound["decay"] and e_sd <= bound["state_decay"]
        ok = ok and finite
        emit({"phase": "kernels", "kernel": "ssd_chunk_scan", "nc": nc,
              **dict(zip("QHPN", shape)), "dtype": dt,
              "dt_scale": dt_scale, "padded_rows": pad, "min_cumsum": cs_min,
              "max_abs_err_y": e_y, "max_abs_err_states": e_st,
              "max_abs_err_decay": e_dec, "max_abs_err_state_decay": e_sd,
              "tol": bound,
              "tol_rule": "f32: |d| <= tol * (1 + |plain|); bf16: |d| <= "
                          "tol * max |plain|", "finite": finite, "ok": ok})
        if not ok:
            raise AssertionError(f"ssd_chunk_scan nc={nc} {dt}: y {e_y}, "
                                 f"states {e_st}, decay {e_dec}, state "
                                 f"decay {e_sd} against {bound}, finite "
                                 f"{finite}")
        worst = max(worst, e_y)
        if shape == HYBRID_SSD and dt == "bfloat16":
            worst_heads = max(worst_heads, e_y)
    ssd_fn_cases(torch, device)
    return worst, worst_heads


def make_requests(cfg, request_cls, prompt_range=PROMPT_RANGE,
                  fixed_lengths=()):
    """3 tenants x 4 requests, prompt lengths drawn from ``prompt_range``
    (inclusive) but for the first ones, which take ``fixed_lengths``."""
    import random
    rng = random.Random(SEED)
    reqs = []
    for i in range(REQUESTS_PER_TENANT):
        for tenant in range(TENANTS):
            n = rng.randint(*prompt_range)
            if len(reqs) < len(fixed_lengths):
                n = fixed_lengths[len(reqs)]
            prompt = [rng.randrange(cfg.vocab_size) for _ in range(n)]
            reqs.append(request_cls(tenant_id=tenant, prompt=prompt,
                                    max_new_tokens=NEW_TOKENS,
                                    req_id=len(reqs)))
    return reqs


def phase_serve(torch, device, cfg, layers: int, prefill_kernels,
                decode_kernels, prefill_lens=(PROMPT_RANGE[1],), *,
                max_seq: int = 1024, prompt_range=PROMPT_RANGE,
                fixed_lengths=(), row_out=None, shd=None, phase="serve"):
    """Serve 3 tenants x 4 requests until drained, prompts drawn from
    ``prompt_range`` (``make_requests``) into 8 slots of ``max_seq``.
    ``prefill_kernels`` and ``decode_kernels`` map a kernel's name to its
    wrapper: each must have launched once per layer per admission
    (prefill) or per decode step. Returns the engine, the launch counts of
    this run and the positions each decode step ran at (its active
    slots'); ``row_out``, a dict, receives the emitted row. ``shd``: a
    ``ShardingCtx`` the weights and the engine are made with (the
    distribution phase's); ``phase`` tags the row."""
    from repro_torch.configs import RunConfig
    from repro_torch.control import RateController
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    from repro_torch.serve import engine as engine_mod
    kernels = {**prefill_kernels, **decode_kernels}

    t0 = time.perf_counter()
    mem = torch.cuda.memory_allocated
    memory = {"allocated_before_init": mem()}
    torch.cuda.reset_peak_memory_stats()   # the init peak is this model's
    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED), shd=shd)
    torch.cuda.synchronize()
    memory["weight_bytes"] = sum(p.numel() * p.element_size()
                                 for p in params.parameters())
    memory["allocated_after_init"] = mem()
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(1e6, alpha=0.6)    # tokens/s: admits everything,
    ctrl.attach_scheduler(sched)             # still ticks and pushes rates
    eng = ServeEngine(cfg, RunConfig(), params, batch_slots=8,
                      max_seq=max_seq, scheduler=sched, controller=ctrl,
                      control_every=4, shd=shd)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    memory["cache_bytes"] = eng._cache_bytes()
    memory["allocated_after_engine"] = mem()
    memory["max_memory_allocated_init"] = torch.cuda.max_memory_allocated()
    reqs = make_requests(cfg, Request, prompt_range, fixed_lengths)
    torch.cuda.reset_peak_memory_stats()
    # the active slots' positions at each decode step, read off the slot
    # table as the engine calls its decode (no device read)
    decode_pos = []
    decode = engine_mod.forward_decode

    def recorded(*args, **kw):
        decode_pos.append([s.pos for s in eng.slots if s.active])
        return decode(*args, **kw)

    for fn in kernels.values():
        fn.launches = 0
    by_route = getattr(kernels.get("ssd_chunk_scan"), "launches_by_route",
                       None)
    if by_route is not None:
        bank_routes("ssd_chunk_scan", by_route)
    t_run = time.perf_counter()
    for r in reqs:
        r.arrival = time.monotonic()
        eng.submit(r)
    decode_only = []    # (seconds, active slots) of steps that admitted none
    steps = 0
    engine_mod.forward_decode = recorded
    try:
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
    finally:
        engine_mod.forward_decode = decode
    run_s = time.perf_counter() - t_run
    if len(decode_pos) != eng.decode_steps:
        raise AssertionError(f"{len(decode_pos)} decodes recorded, "
                             f"{eng.decode_steps} steps")
    launches = {name: fn.launches for name, fn in kernels.items()}
    # the SSD scan's launches, each on the route of the model's widths
    ssd_by_route = None if by_route is None else dict(by_route)
    if ssd_by_route is not None:
        launches["ssd_chunk_scan_heads"] = ssd_by_route["heads"]
    if ssd_by_route is not None and ssd_by_route != ssd_routes(
            torch, cfg, launches["ssd_chunk_scan"]):
        raise AssertionError(f"{cfg.name} serve: SSD launches by route "
                             f"{ssd_by_route}, want all "
                             f"{launches['ssd_chunk_scan']} on one route "
                             f"{ssd_routes(torch, cfg, 1)}")

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
    for name in prefill_kernels:
        assert launches[name] == layers * eng.admissions, \
            (name, launches, eng.admissions)
    for name in decode_kernels:
        assert launches[name] == layers * eng.decode_steps, \
            (name, launches, eng.decode_steps)
    peak = torch.cuda.max_memory_allocated()

    # prefill time per request: the longest prompt length drawn, and any
    # longer lengths asked for (a cache of max(n, max_seq) positions)
    prefill_ms = {}
    for n in prefill_lens:
        prompt = torch.tensor([reqs[0].prompt[:1] * n], dtype=torch.int32,
                              device=device)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            forward_prefill(eng.params, prompt, eng.rcfg,
                            max_seq=max(n, eng.max_seq))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
        prefill_ms[f"prefill_ms_{n}"] = statistics.median(times) * 1e3
    dec_tokens = sum(n for _, n in decode_only)
    dec_s = sum(t for t, _ in decode_only)
    out = {"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": cfg.num_params(),
           "requests": len(reqs), "completed": len(done),
           "admissions": eng.admissions, "decode_steps": eng.decode_steps,
           "slots": eng.B, "max_seq": eng.max_seq,
           "launches": launches, "ledger": ledger,
           **({"ssd_launches_by_route": ssd_by_route}
              if ssd_by_route is not None else {}),
           "decode_positions": [min(min(p) for p in decode_pos),
                                max(max(p) for p in decode_pos)],
           "controller_ticks": ctrl.ticks, "init_s": init_s,
           "run_s": run_s,
           "decode_tok_s": dec_tokens / dec_s if dec_s else None,
           "step_ms_median": (statistics.median(t for t, _ in decode_only)
                              * 1e3 if decode_only else None),
           **prefill_ms,
           "slot_utilization": eng.slot_utilization(),
           "memory": memory, "max_memory_allocated": peak, "ok": True}
    emit(out)
    if row_out is not None:
        row_out.update(out)
    return eng, launches, decode_pos


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def _profile(torch, fn, top: int = 8, kernel=None, ranges=()):
    """Where ``fn``'s device time goes. ``fn`` runs twice: once with the
    host clock alone (``wall_ms``), once under torch.profiler, whose CUDA
    kernel events (and only those: an operator's own row would count its
    kernels twice) give the device time by kernel. Their ratio is the
    device's busy share of the unprofiled run. ``kernel``: a substring of
    kernel names whose device time and share are reported. ``ranges``:
    names of CPU events (an autograd node's ``evaluate_function``, say)
    whose kernels' device time, their children's included, and share are
    reported. The count of ``aten::cumsum`` calls comes from the
    operators' CPU events."""
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
    avgs = prof.key_averages()      # parsing the trace is the slow part
    rows = sorted(((_device_us(e), e.key, e.count) for e in avgs
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and _device_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"wall_ms": wall_us / 1e3,
           "device_ms": busy / 1e3 if busy else "not measured",
           "device_busy_share": busy / wall_us if busy else "not measured",
           "kernel_launches": sum(r[2] for r in rows),
           "aten_cumsum_calls": sum(
               e.count for e in avgs if e.key == "aten::cumsum"
               and getattr(e, "device_type", None) == DeviceType.CPU),
           "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n}
                   for us, k, n in rows[:top]]}
    if kernel:
        k_us = sum(us for us, k, _n in rows if kernel in k)
        out["kernel"] = kernel
        out["kernel_ms"] = k_us / 1e3 if busy else "not measured"
        out["kernel_share_of_device"] = k_us / busy if busy \
            else "not measured"
    for name in ranges:
        evts = [e for e in avgs if e.key == name
                and getattr(e, "device_type", None) == DeviceType.CPU]
        r_us = sum(float(getattr(e, "device_time_total", 0.0) or 0.0)
                   for e in evts)
        out.setdefault("ranges", {})[name] = {
            "calls": sum(e.count for e in evts),
            "ms": r_us / 1e3 if busy and evts else "not measured",
            "share_of_device": r_us / busy if busy and evts
            else "not measured"}
    return out


def phase_profile(torch, device, eng, kernel=None, prompt_len: int = 256,
                  prefill_len: int = PROMPT_RANGE[1]):
    """Where a decode step and a prefill spend their time (torch.profiler
    over the port's own entry points, all 8 slots busy with prompts of
    ``prompt_len`` tokens; a prefill of ``prefill_len``). ``kernel``: the
    prefill's own scan kernel (a name substring), whose share of the
    prefill's device time is reported; its prefill must run no separate
    ``aten::cumsum`` (the scan returns the in-chunk decays). Returns the
    decode and prefill rows."""
    from repro_torch.models import forward_prefill
    from repro_torch.serve import Request
    rng = torch.Generator().manual_seed(SEED + 3)
    for i in range(eng.B):
        prompt = torch.randint(0, eng.cfg.vocab_size, (prompt_len,),
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
    prompt = torch.randint(0, eng.cfg.vocab_size, (1, prefill_len),
                           generator=rng).to(device)
    prefill = _profile(torch, lambda: forward_prefill(
        eng.params, prompt, eng.rcfg, max_seq=eng.max_seq), kernel=kernel)
    eng.run_until_drained()
    emit({"phase": "profile", "model": eng.cfg.name,
          "decode_4_steps_B8": decode,
          f"prefill_S{prefill_len}": prefill})
    if kernel and (prefill["aten_cumsum_calls"]
                   or not prefill.get("kernel_ms")):
        raise AssertionError(f"{eng.cfg.name} prefill: "
                             f"{prefill['aten_cumsum_calls']} cumsum calls, "
                             f"{prefill.get('kernel_ms')} ms in {kernel}")
    return decode, prefill


def parity_logits(torch, device, params, max_seq: int, paths, tokens=None,
                  cache_dtype: str = "bfloat16", prompt_len: int = 300):
    """One ``prompt_len``-token prompt's prefill + 4 decode steps of
    ``params`` on each of ``paths`` (name -> RunConfig), each into a cache
    made by ``init_cache`` in ``cache_dtype`` (per-leaf dtypes: an SSM
    state is f32). Teacher-forced: every path decodes ``tokens``, by
    default the first path's greedy tokens. Returns (name -> the 5 logit
    rows in f32, the 4 tokens)."""
    from repro_torch.models import forward_decode, forward_prefill, \
        init_cache
    cfg = params.cfg
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=gen, device=device,
                           dtype=torch.int64).int()
    runs = {}
    for name, rc in paths.items():
        logits, c1 = forward_prefill(params, prompt, rc, max_seq=max_seq)
        runs[name] = {"logits": [logits.float()],
                      "cache": init_cache(cfg, 1, max_seq, dtype=cache_dtype,
                                          device=device)}
        for big, one in zip(runs[name]["cache"], c1):
            for k in big:
                big[k].copy_(one[k])
    first = next(iter(paths))
    forced = list(tokens) if tokens is not None else []
    tok = forced[0] if forced else int(runs[first]["logits"][0].argmax())
    used = []
    for step in range(4):
        used.append(tok)
        pos = torch.tensor([prompt.shape[1] + step], dtype=torch.int32,
                           device=device)
        tokens = torch.tensor([[tok]], dtype=torch.int32, device=device)
        for name, rc in paths.items():
            lg, _ = forward_decode(params, runs[name]["cache"], tokens, pos,
                                   rc)
            runs[name]["logits"].append(lg.float())
        tok = forced[step + 1] if step + 1 < len(forced) else \
            int(runs[first]["logits"][-1].argmax())
    return {name: run["logits"] for name, run in runs.items()}, used


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def logit_gap(a, b):
    """Per step max |a - b| / max |b|, and the share of steps whose argmax
    agrees."""
    rel = [rel_err(x, y) for x, y in zip(a, b)]
    agree = sum(int(x.argmax() == y.argmax()) for x, y in zip(a, b))
    return rel, agree / len(rel)


def phase_parity(torch, device, eng):
    """The kernel path against the plain path (``attention_impl="naive"``),
    same weights, logits compared within ``PARITY_TOL``."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    flash_attention.launches = 0
    decode_attention.launches = 0
    runs, _ = parity_logits(torch, device, eng.params, eng.max_seq,
                            {"kernel": RunConfig(),
                             "plain": RunConfig(attention_impl="naive")})
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    # the kernel path: one prefill and 4 decode steps through every layer
    layers = eng.cfg.num_layers
    launched = launches == {"flash_attention": layers,
                            "decode_attention": 4 * layers}
    rel, agree = logit_gap(runs["kernel"], runs["plain"])
    worst = max(rel)
    out = {"phase": "parity", "model": eng.cfg.name, "prompt": 300,
           "decode_steps": 4, "max_rel_logit_err": worst,
           "per_step_rel_err": rel, "tol": PARITY_TOL,
           "argmax_agree_share": agree, "launches": launches,
           "ok": worst <= PARITY_TOL and launched}
    emit(out)
    if worst > PARITY_TOL or not launched:
        raise AssertionError(f"kernel path vs plain: {worst} > {PARITY_TOL}"
                             f" or launches {launches} off the path")


@contextlib.contextmanager
def attention_checked(err: dict):
    """The attention kernels as the model calls them
    (``models.attention.flash_attention``/``decode_kernel``), each launch
    held against its plain version on the same inputs: max |do| / max |o|
    appended to ``err["flash_attention"]``/``err["decode_attention"]``."""
    from repro_torch.models import attention as attn
    flash_k, dec_k = attn.flash_attention, attn.decode_kernel
    flash_p, dec_p = attn.flash_attention_plain, attn.decode_attention_plain

    def flash_checked(q, k, v, **kw):
        o = flash_k(q, k, v, **kw)
        err["flash_attention"].append(rel_err(o, flash_p(q, k, v, **kw)))
        return o

    def decode_checked(q, k, v, pos, **kw):
        out = dec_k(q, k, v, pos, **kw)
        err["decode_attention"].append(
            rel_err(out[0], dec_p(q, k, v, pos, **kw)[0]))
        return out

    attn.flash_attention, attn.decode_kernel = flash_checked, decode_checked
    try:
        yield err
    finally:
        attn.flash_attention, attn.decode_kernel = flash_k, dec_k


@contextlib.contextmanager
def attention_nudged(scale: float):
    """The plain attention versions (the plain path's) with every output
    scaled by ``scale``: a bf16 noise floor's perturbation."""
    from repro_torch.models import attention as attn
    flash_p, dec_p = attn.flash_attention_plain, attn.decode_attention_plain

    def flash_nudged(*args, **kw):
        return flash_p(*args, **kw) * scale

    def decode_nudged(*args, **kw):
        o, *rest = dec_p(*args, **kw)
        return (o * scale, *rest)

    attn.flash_attention_plain, attn.decode_attention_plain = \
        flash_nudged, decode_nudged
    try:
        yield
    finally:
        attn.flash_attention_plain, attn.decode_attention_plain = \
            flash_p, dec_p


def phase_parity_vlm(torch, device, eng):
    """A dense model's kernel path against its plain path at bf16, at a
    depth where random weights amplify rounding past ``PARITY_TOL``
    (chameleon-34b's 48 layers: ROADMAP P15):

    * per layer, asserted: every attention kernel launch of one 300-token
      prefill and 4 decode steps (each layer's flash and decode) held
      against its plain version on the same inputs, max |do| / max |o|
      within ``FLASH_TOL``/``DECODE_TOL`` at bf16;
    * end to end, reported: the logits' gap, beside the model's own bf16
      noise floor (the plain path against itself with every attention
      output nudged by 2^-8 relative, about one bf16 ulp: scaled by 1 +
      2^-8 and by 1 - 2^-8), all decoding the same tokens."""
    from repro_torch.configs import RunConfig
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")
    err = {"flash_attention": [], "decode_attention": []}
    with attention_checked(err):
        runs, tokens = parity_logits(torch, device, eng.params, eng.max_seq,
                                     {"kernel": kernel, "plain": plain})
    floors = {}
    for sign in (1, -1):
        with attention_nudged(1 + sign * FLOOR_NUDGE):
            nudged = parity_logits(torch, device, eng.params, eng.max_seq,
                                   {"plain": plain}, tokens)[0]["plain"]
        floors["+" if sign > 0 else "-"] = logit_gap(nudged,
                                                     runs["plain"])[0]
    layers = eng.cfg.num_layers
    rel, agree = logit_gap(runs["kernel"], runs["plain"])
    checks = {
        "every_layer_checked":
            len(err["flash_attention"]) == layers
            and len(err["decode_attention"]) == 4 * layers,
        "flash_per_layer": max(err["flash_attention"])
        <= FLASH_TOL["bfloat16"],
        "decode_per_layer": max(err["decode_attention"])
        <= DECODE_TOL["bfloat16"]["o"]}
    emit({"phase": "parity", "model": eng.cfg.name, "prompt": 300,
          "decode_steps": 4,
          "per_layer_max_rel_err": {k: max(v) for k, v in err.items()},
          "per_layer_rel_err": err,
          "per_layer_tol": {"flash_attention": FLASH_TOL["bfloat16"],
                            "decode_attention": DECODE_TOL["bfloat16"]["o"]},
          "max_rel_logit_err_not_asserted": max(rel),
          "per_step_rel_err": rel, "parity_tol": PARITY_TOL,
          "argmax_agree_share": agree,
          "bf16_floor_plain_vs_plain_attention_nudged_2^-8": max(
              max(f) for f in floors.values()),
          "bf16_floors_per_step_rel_err": floors,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{eng.cfg.name} parity: {checks}, per layer "
                             f"{ {k: max(v) for k, v in err.items()} }")


def phase_parity_f32(torch, device, cfg, layers: int):
    """The first ``layers`` layers of ``cfg`` at full width in f32 (fresh
    weights from the serve phase's seed, so the same draws), kernel path
    against plain path: greedy tokens identical, logits within
    ``VLM_F32_TOL`` of max |logit|. The cache is f32 too: a bf16 cache
    would round values that differ in their last f32 bits to neighbouring
    bf16 values (ROADMAP P14)."""
    import dataclasses
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                                param_dtype="float32")
    model = init_params(cfg32, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED))
    flash_attention.launches = 0
    decode_attention.launches = 0
    runs, _ = parity_logits(torch, device, model, 1024,
                            {"kernel": RunConfig(),
                             "plain": RunConfig(attention_impl="naive")},
                            cache_dtype="float32")
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    del model
    rel, agree = logit_gap(runs["kernel"], runs["plain"])
    checks = {"launched": launches == {"flash_attention": layers,
                                       "decode_attention": 4 * layers},
              "tokens_identical": agree == 1.0,
              "logits": max(rel) <= VLM_F32_TOL}
    emit({"phase": "parity", "model": cfg.name, "dtype": "float32",
          "layers": layers, "weight_bytes": weight_bytes, "prompt": 300,
          "decode_steps": 4, "max_rel_logit_err": max(rel),
          "per_step_rel_err": rel, "tol": VLM_F32_TOL,
          "argmax_agree_share": agree, "launches": launches,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} f32 x {layers} layers: {checks}, "
                             f"{max(rel)}")


def phase_parity_ssm(torch, device, eng):
    """The SSM model's kernel path against its plain path, three ways:

    * bf16, per layer: every SSD scan launch of the prefill is held against
      the plain scan on the same inputs (y and states within
      ``SSD_TOL["bfloat16"]`` of their largest value, decay within
      ``SSD_TOL_DECAY``), all 48 layers;
    * f32, end to end: the same weights widened to f32, logits within
      ``PARITY_TOL``;
    * bf16, end to end: reported with the model's own bf16 noise floor
      (the plain path against itself with every scan's y nudged by 1e-6
      relative, and against the f32 plain path, all decoding the same
      tokens); not asserted, since a random-weight 48-layer bf16 model
      turns any perturbation into logit gaps of that floor's size."""
    import dataclasses
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_plain
    from repro_torch.models import Model
    from repro_torch.models import ssm as ssm_mod
    cfg = eng.cfg
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")
    scan = ssm_mod.ssd_chunk_scan
    scan_plain = ssm_mod.ssd_chunk_scan_plain
    layer_err = {"y": 0.0, "states": 0.0, "decay": 0.0, "state_decay": 0.0}
    checked = 0

    def scan_checked(xdt, dA, B, C, **kw):
        nonlocal checked
        out = scan(xdt, dA, B, C, **kw)
        want = ssd_chunk_scan_plain(xdt, dA, B, C, **kw)
        for key, a, b in zip(("y", "states"), out, want):
            layer_err[key] = max(layer_err[key], (
                (a.float() - b.float()).abs().max()
                / b.float().abs().max()).item())
        for key, a, b in zip(("decay", "state_decay"), out[2:], want[2:]):
            layer_err[key] = max(layer_err[key],
                                 (a - b).abs().max().item())
        checked += 1
        return out

    def scan_nudged(*args, **kw):
        y, *rest = scan_plain(*args, **kw)
        return (y * (1 + 1e-6), *rest)

    ssm_mod.ssd_chunk_scan = scan_checked
    try:
        bf16, tokens = parity_logits(torch, device, eng.params, eng.max_seq,
                                     {"kernel": kernel, "plain": plain})
    finally:
        ssm_mod.ssd_chunk_scan = scan
    ssm_mod.ssd_chunk_scan_plain = scan_nudged
    try:
        nudged = parity_logits(torch, device, eng.params, eng.max_seq,
                               {"plain": plain}, tokens)[0]["plain"]
    finally:
        ssm_mod.ssd_chunk_scan_plain = scan_plain
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = Model(cfg32, device=device)
    m32.load_state_dict(eng.params.state_dict())     # widened, exactly
    f32, _ = parity_logits(torch, device, m32, eng.max_seq,
                           {"kernel": kernel, "plain": plain}, tokens)
    del m32
    rel32, agree32 = logit_gap(f32["kernel"], f32["plain"])
    rel16, agree16 = logit_gap(bf16["kernel"], bf16["plain"])
    floor_nudge, _ = logit_gap(nudged, bf16["plain"])
    floor_f32, _ = logit_gap(bf16["plain"], f32["plain"])
    checks = {
        "bf16_scan_per_layer": checked >= cfg.num_layers
        and layer_err["y"] <= SSD_TOL["bfloat16"]
        and layer_err["states"] <= SSD_TOL["bfloat16"]
        and layer_err["decay"] <= SSD_TOL_DECAY
        and layer_err["state_decay"] <= SSD_TOL_DECAY,
        "f32_end_to_end": max(rel32) <= PARITY_TOL}
    emit({"phase": "parity", "model": cfg.name, "prompt": 300,
          "decode_steps": 4,
          "bf16_scan_per_layer": {"launches_checked": checked,
                                  "max_rel_err": layer_err,
                                  "tol": {"y": SSD_TOL["bfloat16"],
                                          "states": SSD_TOL["bfloat16"],
                                          "decay": SSD_TOL_DECAY,
                                          "state_decay": SSD_TOL_DECAY}},
          "f32_max_rel_logit_err": max(rel32),
          "f32_per_step_rel_err": rel32, "f32_argmax_agree_share": agree32,
          "tol": PARITY_TOL,
          "bf16_max_rel_logit_err_not_asserted": max(rel16),
          "bf16_per_step_rel_err": rel16, "bf16_argmax_agree_share": agree16,
          "bf16_floor_plain_vs_plain_y_nudged_1e-6": max(floor_nudge),
          "bf16_floor_plain_vs_f32_plain": max(floor_f32),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} parity: {checks}, per-layer "
                             f"{layer_err}, f32 {max(rel32)}")


def phase_parity_hybrid(torch, device, eng):
    """hymba-1.5b's kernel path against its plain path over a
    ``HYBRID_PARITY_PROMPT``-token prompt (past the window, so its windowed
    layers decode from rings that rolled) and 4 decode steps:

    * bf16, per launch, asserted: every flash, SSD scan and decode launch
      of the kernel path held against its plain version on the same inputs
      (max |d| / max |plain| within ``FLASH_TOL``, ``SSD_TOL`` and
      ``DECODE_TOL``; the SSD decays within ``SSD_TOL_DECAY``);
    * f32, end to end, asserted: the same weights widened to f32 with an
      f32 cache (ROADMAP P14), all 32 layers: tokens identical, logits
      within ``VLM_F32_TOL`` of max |logit|, every launch on the kernels;
    * bf16, end to end, reported: the logits' gap beside the model's own
      bf16 noise floor (the plain path against itself with every flash,
      decode and scan output nudged by 2^-8 relative, about one bf16 ulp),
      all decoding the same tokens."""
    import dataclasses
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, \
        ssd_chunk_scan_plain
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    cfg = eng.cfg
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")
    scan_k = ssm_mod.ssd_chunk_scan
    flash_p, dec_p = attn.flash_attention_plain, attn.decode_attention_plain
    dec_ring_p, scan_p = attn.decode_attention, ssm_mod.ssd_chunk_scan_plain
    err = {"flash_attention": [], "decode_attention": [],
           "ssd_chunk_scan": [], "ssd_decays": []}

    def scan_checked(xdt, dA, B, C, **kw):
        out = scan_k(xdt, dA, B, C, **kw)
        want = ssd_chunk_scan_plain(xdt, dA, B, C, **kw)
        err["ssd_chunk_scan"].append(max(rel_err(a, b) for a, b in
                                         zip(out[:2], want[:2])))
        err["ssd_decays"].append(max((a - b).abs().max().item() for a, b
                                     in zip(out[2:], want[2:])))
        return out

    nudge = 1 + 2 ** -8

    def flash_nudged(*args, **kw):
        return flash_p(*args, **kw) * nudge

    def decode_nudged(*args, **kw):
        o, *rest = dec_p(*args, **kw)
        return (o * nudge, *rest)

    def decode_ring_nudged(*args, **kw):
        return dec_ring_p(*args, **kw) * nudge

    def scan_nudged(*args, **kw):
        y, *rest = scan_p(*args, **kw)
        return (y * nudge, *rest)

    def run(params, paths, **kw):
        return parity_logits(torch, device, params, eng.max_seq, paths,
                             prompt_len=HYBRID_PARITY_PROMPT, **kw)

    ssm_mod.ssd_chunk_scan = scan_checked
    try:
        with attention_checked(err):
            bf16, tokens = run(eng.params, {"kernel": kernel,
                                            "plain": plain})
    finally:
        ssm_mod.ssd_chunk_scan = scan_k
    # the plain path's decode: the kernel's plain version at the global
    # layers, the reference's kv_pos decode at the ring layers
    attn.flash_attention_plain, attn.decode_attention_plain, \
        attn.decode_attention = flash_nudged, decode_nudged, \
        decode_ring_nudged
    ssm_mod.ssd_chunk_scan_plain = scan_nudged
    try:
        nudged = run(eng.params, {"plain": plain}, tokens=tokens)[0]["plain"]
    finally:
        attn.flash_attention_plain, attn.decode_attention_plain, \
            attn.decode_attention = flash_p, dec_p, dec_ring_p
        ssm_mod.ssd_chunk_scan_plain = scan_p
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = Model(cfg32, device=device)
    m32.load_state_dict(eng.params.state_dict())     # widened, exactly
    counters = (flash_attention, decode_attention, ssd_chunk_scan)
    for fn in counters:
        fn.launches = 0
    f32, _ = run(m32, {"kernel": kernel, "plain": plain},
                 cache_dtype="float32")
    launches32 = {fn.__name__: fn.launches for fn in counters}
    del m32
    layers = cfg.num_layers
    rel32, agree32 = logit_gap(f32["kernel"], f32["plain"])
    rel16, agree16 = logit_gap(bf16["kernel"], bf16["plain"])
    floor, _ = logit_gap(nudged, bf16["plain"])
    tol = {"flash_attention": FLASH_TOL["bfloat16"],
           "decode_attention": DECODE_TOL["bfloat16"]["o"],
           "ssd_chunk_scan": SSD_TOL["bfloat16"],
           "ssd_decays": SSD_TOL_DECAY}
    checks = {
        "every_launch_checked":
            len(err["flash_attention"]) == layers
            and len(err["ssd_chunk_scan"]) == layers
            and len(err["decode_attention"]) == 4 * layers,
        **{f"bf16_{k}_per_launch": max(v) <= tol[k] for k, v in err.items()},
        "f32_launched": launches32 == {
            "flash_attention": layers, "ssd_chunk_scan": layers,
            "decode_attention": 4 * layers},
        "f32_tokens_identical": agree32 == 1.0,
        "f32_logits": max(rel32) <= VLM_F32_TOL}
    emit({"phase": "parity", "model": cfg.name,
          "prompt": HYBRID_PARITY_PROMPT, "decode_steps": 4,
          "per_launch_max_rel_err": {k: max(v) for k, v in err.items()},
          "per_launch_tol": tol,
          "f32_max_rel_logit_err": max(rel32),
          "f32_per_step_rel_err": rel32, "f32_argmax_agree_share": agree32,
          "f32_tol": VLM_F32_TOL, "f32_launches": launches32,
          "bf16_max_rel_logit_err_not_asserted": max(rel16),
          "bf16_per_step_rel_err": rel16, "bf16_argmax_agree_share": agree16,
          "parity_tol": PARITY_TOL,
          "bf16_floor_plain_vs_plain_nudged_2^-8": max(floor),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} parity: {checks}, per launch "
                             f"{ {k: max(v) for k, v in err.items()} }, "
                             f"f32 {max(rel32)}")


def phase_hybrid(torch, device, cfg=None, out=None):
    """hymba-1.5b (``cfg``: its full-width config by default) at full
    depth: serve (flash and the SSD scan once per layer and admission,
    decode once per layer and step; every decode position past the ring's
    wrap; the cache's bytes the schema's), profile, parity. Returns the
    launch counts of the serve run; ``out``, a dict, receives the served
    tokens by request (``tokens``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_schedule
    cfg = cfg or get_config("hymba-1.5b")
    eng, launches, decode_pos = phase_serve(
        torch, device, cfg, cfg.num_layers,
        {"flash_attention": flash_attention,
         "ssd_chunk_scan": ssd_chunk_scan},
        {"decode_attention": decode_attention},
        prefill_lens=HYBRID_PREFILL_LENS, max_seq=HYBRID_MAX_SEQ,
        prompt_range=HYBRID_PROMPT_RANGE, fixed_lengths=HYBRID_FIXED_LENGTHS)
    if out is not None:
        out["tokens"] = {r.req_id: list(r.generated) for r in eng.completed}
    schema_bytes = schema_cache_bytes(torch, eng)
    rings = [seg.count for seg in build_schedule(cfg) if seg.window]
    checks = {"cache_bytes_are_the_schemas": eng._cache_bytes()
              == schema_bytes,
              "ring_layers": sum(rings)
              == cfg.num_layers - len(cfg.global_attn_layers),
              "every_decode_past_the_wrap": min(min(p) for p in decode_pos)
              >= HYBRID_WINDOW}
    emit({"phase": "serve", "model": cfg.name, "checks": checks,
          "cache_bytes": eng._cache_bytes(), "schema_bytes": schema_bytes,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} serve: {checks}")
    phase_profile(torch, device, eng, kernel="ssd_",
                  prompt_len=HYBRID_PROMPT_RANGE[0],
                  prefill_len=HYBRID_PREFILL_LENS[-1])
    phase_parity_hybrid(torch, device, eng)
    del eng
    torch.cuda.empty_cache()
    return launches


def encdec_serve(torch, model, rcfg, prompts, frames, steps, forced=None):
    """whisper served through the model's entry points: one prefill with
    frames, then ``steps`` greedy decode steps (``forced`` (B, steps):
    teacher-forced tokens instead). Returns (per-step logits in f32, the
    tokens fed, the caches)."""
    from repro_torch.models import forward_decode, forward_prefill
    b, s = prompts.shape
    logits, caches = forward_prefill(model, prompts, rcfg,
                                     max_seq=ENCDEC_MAX_SEQ, frames=frames)
    out, fed = [logits.float()], []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32) if forced is None \
            else forced[:, i]
        fed.append(tok)
        logits, caches = forward_decode(
            model, caches, tok[:, None], torch.full(
                (b,), s + i, dtype=torch.int32, device=prompts.device),
            rcfg, max_seq=ENCDEC_MAX_SEQ)
        out.append(logits.float())
    return out, torch.stack(fed, 1), caches


def phase_encdec(torch, device, cfg=None, out=None):
    """whisper-small (``cfg``: its full-width config by default) at full
    width and depth, random bf16 weights from a seed, served as the
    reference's entry points serve it: ``ENCDEC_BATCH`` utterances of
    ``encoder_seq`` bf16 frames, prompts of ``ENCDEC_PROMPT`` tokens, one
    prefill (flash once per encoder layer, decoder layer and cross
    attention), ``ENCDEC_NEW`` greedy decode steps (decode once per
    decoder layer for the self cache and once for the cross cache, at
    pos T - 1). Checks the launches, the cache's bytes against the
    schema, finite logits; the kernel path against the plain path at bf16
    (teacher-forced, logits within ``PARITY_TOL`` of max |logit|) and on
    an f32 copy (greedy on both, identical tokens, logits within
    ``ENCDEC_F32_TOL``). Returns the launch counts of the served run;
    ``out``, a dict, receives its prompts, frames and tokens."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import (cache_schema, forward_decode,
                                    forward_prefill, init_params)
    from repro_torch.models.model import cache_nbytes
    cfg = cfg or get_config("whisper-small")
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before "
                             f"{cfg.name}'s weights")
    b, t0 = ENCDEC_BATCH, time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    model = init_params(cfg, device=device, seed=SEED)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    prompts = torch.randint(1, cfg.vocab_size, (b, ENCDEC_PROMPT),
                            generator=gen, device=device, dtype=torch.int32)
    rcfg = RunConfig()
    encdec_serve(torch, model, rcfg, prompts, frames, 2)      # warm
    torch.cuda.synchronize()
    fa.flash_attention.launches = da.decode_attention.launches = 0
    t1 = time.perf_counter()
    logits, caches = forward_prefill(model, prompts, rcfg,
                                     max_seq=ENCDEC_MAX_SEQ, frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    launches = {"flash_attention": fa.flash_attention.launches}
    toks, t2 = [], time.perf_counter()
    for i in range(ENCDEC_NEW):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, caches = forward_decode(
            model, caches, tok[:, None], torch.full(
                (b,), ENCDEC_PROMPT + i, dtype=torch.int32, device=device),
            rcfg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t2
    launches["decode_attention"] = da.decode_attention.launches
    if out is not None:
        out.update(prompts=prompts, frames=frames,
                   tokens=torch.stack(toks, 1))
    schema = {k: math.prod(d.shape) * getattr(torch, d.dtype).itemsize
              for seg in cache_schema(cfg, b, ENCDEC_MAX_SEQ)
              for k, d in seg.items()}
    cache = {k: sum(c[k].numel() * c[k].element_size() for c in caches)
             for k in ("k", "v", "ck", "cv")}
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    want = {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
            "decode_attention": 2 * cfg.num_layers * ENCDEC_NEW}
    checks = {
        "launches": launches == want,
        "cache_bytes_are_the_schemas": cache_nbytes(caches)
        == sum(schema.values()) and cache == schema,
        "cache_dtypes_bf16": all(v.dtype == torch.bfloat16
                                 for c in caches for v in c.values()),
        "finite_logits": bool(torch.isfinite(logits).all()),
        "tokens_in_vocab": all(bool(((x >= 0) & (x < cfg.vocab_size))
                                    .all()) for x in toks)}
    if cfg.name == "whisper-small":
        checks["cross_and_self_bytes"] = (
            cache["ck"] + cache["cv"], cache["k"] + cache["v"]) == (
            ENCDEC_CROSS_BYTES, ENCDEC_SELF_BYTES)
    row = {"phase": "serve", "model": cfg.name, "utterances": b,
           "frames": cfg.encoder_seq, "prompt": ENCDEC_PROMPT,
           "max_seq": ENCDEC_MAX_SEQ, "new_tokens": ENCDEC_NEW,
           "parameters": sum(p.numel() for p in model.parameters()),
           "weight_bytes": weight_bytes, "cache_bytes": cache,
           "schema_bytes": schema, "launches": launches,
           "launches_want": want, "prefill_ms": prefill_s * 1e3,
           "decode_step_ms": decode_s / ENCDEC_NEW * 1e3,
           "decode_tokens_per_s": b * ENCDEC_NEW / decode_s,
           "checks": checks, "ok": all(checks.values())}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} serve: {row}")
    del caches, logits

    # the kernel path against the plain path, bf16, teacher-forced on the
    # kernel path's tokens
    ker, fed, _ = encdec_serve(torch, model, rcfg, prompts, frames,
                               ENCDEC_PARITY_STEPS)
    plain, _, _ = encdec_serve(torch, model, RunConfig(
        attention_impl="naive"), prompts, frames, ENCDEC_PARITY_STEPS,
        forced=fed)
    rel, agree = logit_gap(ker, plain)
    del model
    torch.cuda.empty_cache()
    # ... and on an f32 copy (f32 weights, frames and cache), greedy on both
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = init_params(cfg32, device=device, seed=SEED)
    ker32, tok_k, _ = encdec_serve(torch, model, rcfg, prompts,
                                   frames.float(), ENCDEC_PARITY_STEPS)
    plain32, tok_p, _ = encdec_serve(torch, model, RunConfig(
        attention_impl="naive"), prompts, frames.float(),
        ENCDEC_PARITY_STEPS)
    rel32, _ = logit_gap(ker32, plain32)
    del model
    torch.cuda.empty_cache()
    row = {"phase": "parity", "model": cfg.name,
           "steps": ENCDEC_PARITY_STEPS + 1, "bf16_rel_gaps": rel,
           "bf16_argmax_agree": agree, "bf16_tol": PARITY_TOL,
           "f32_rel_gaps": rel32, "f32_tokens_identical":
           torch.equal(tok_k, tok_p), "f32_tol": ENCDEC_F32_TOL,
           "seconds": time.perf_counter() - t0}
    row["ok"] = max(rel) <= PARITY_TOL and max(rel32) <= ENCDEC_F32_TOL \
        and row["f32_tokens_identical"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"{cfg.name} parity: {row}")
    return launches


@contextlib.contextmanager
def recording_routes(out: list):
    """Every ``route_topk`` call appends its expert ids (T, k) to ``out``,
    on the host."""
    from repro_torch.models import moe
    real = moe.route_topk

    def recorded(*args, **kw):
        gate, eidx, aux = real(*args, **kw)
        out.append(eidx.cpu())
        return gate, eidx, aux

    moe.route_topk = recorded
    try:
        yield out
    finally:
        moe.route_topk = real


@contextlib.contextmanager
def recording_moe(out: list):
    """Every moe layer's call appends (tokens in its batch, its sequence
    length, its drop share as a 0-d tensor, left on the device)."""
    from repro_torch.models import blocks
    real = blocks.apply_moe

    def recorded(p, x, cfg, *args, **kw):
        y, aux = real(p, x, cfg, *args, **kw)
        out.append((x.shape[0], x.shape[1], aux["moe_drop_frac"]))
        return y, aux

    blocks.apply_moe = recorded
    try:
        yield out
    finally:
        blocks.apply_moe = real


def route_flips(a, b):
    """The top-k choices of ``a`` that ``b`` did not make, call by call
    (each call's (T, k) expert ids as sets per token), and the choices
    each call made."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} routing calls against {len(b)}")
    return ([int((x[:, :, None] != y[:, None, :]).all(-1).sum())
             for x, y in zip(a, b)], [x.numel() for x in a])


def flips_by_step(flips, n_moe: int):
    """Per-call flips summed per forward: the prefill, then each decode
    step (``n_moe`` routing calls each)."""
    return [sum(flips[i:i + n_moe]) for i in range(0, len(flips), n_moe)]


def decode_read_bytes(params, b: int):
    """The weights' bytes, and the bytes a decode step of ``b`` tokens
    must read: every weight but the input token table, of which it reads
    ``b`` rows (an untied output table is read whole)."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    table = params.embed["tokens"]
    return weight_bytes, weight_bytes - table.numel() * table.element_size() \
        + b * table.shape[1] * table.element_size()


def schema_cache_bytes(torch, eng) -> int:
    """The bytes of the cache ``cache_schema`` gives the engine's shape."""
    from repro_torch.models import cache_schema
    return sum(math.prod(d.shape) * getattr(torch, d.dtype).itemsize
               for seg in cache_schema(eng.cfg, eng.B, eng.max_seq,
                                       eng.rcfg.kv_cache_dtype)
               for d in seg.values())


def phase_moe(torch, device, arch: str, cfg, f32_layers: int, out=None):
    """The moe model ``arch`` (``cfg``: its config, depth already cut; at
    full width on the card): serve 3 tenants x 4 requests through
    ``ServeEngine`` (8 slots of 1024, WFQ, a ``RateController``), profile,
    parity at bf16 (``phase_parity_moe``),
    the model's first ``f32_layers`` layers at f32 (``phase_parity_moe_
    f32``) once the bf16 model is freed, and the smoke config on the card
    against the CPU (``moe_smoke_on_card``). Attention runs through flash
    once per layer and admission (deepseek's MLA prefill at head dim 192,
    v padded from 128), and arctic's decode at group 7 once per layer and
    step (deepseek's absorbed MLA decode is plain torch, no kernel).
    Checks: 12/12 requests and the ledger (in
    ``phase_serve``), the launches, no decode drop (8 tokens top-k against
    a capacity of 8), the cache's bytes the schema's. Reported: the
    capacities, the prefills' drop shares, the weight bytes, the step
    beside the bytes a step must read at 3.35 TB/s, the latent cache
    beside a k/v cache of as many heads. Returns the serve run's launch
    counts; ``out``, a dict, receives its tokens by request."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models.moe import _capacity
    from repro_torch.serve import ServeEngine
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before "
                             f"{cfg.name}'s weights")
    mla = cfg.mla is not None
    kernels = {"flash_attention": flash_attention,
               "decode_attention": decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    n_moe = cfg.num_layers - cfg.dense_layer_prefix
    calls, row = [], {}
    with recording_moe(calls):
        eng, launches, _ = phase_serve(
            torch, device, cfg, cfg.num_layers,
            {"flash_attention": flash_attention},
            {} if mla else {"decode_attention": decode_attention},
            row_out=row)
    # an MLA model's decode launches, which phase_serve does not count
    launches = {"decode_attention": decode_attention.launches, **launches}
    if out is not None:
        out["tokens"] = {r.req_id: list(r.generated) for r in eng.completed}
    prefills = [float(d) for _b, s, d in calls if s > 1]
    prefills = prefills[:eng.admissions * n_moe]
    decode_drops = [float(d) for _b, s, d in calls if s == 1]
    admit_drop = [sum(prefills[i:i + n_moe]) / n_moe
                  for i in range(0, len(prefills), n_moe)]
    params = eng.params
    weight_bytes, read_bytes = decode_read_bytes(params, eng.B)
    schema_bytes = schema_cache_bytes(torch, eng)
    checks = {"cache_bytes_are_the_schemas":
              eng._cache_bytes() == schema_bytes,
              "no_decode_drop": len(decode_drops)
              == eng.decode_steps * n_moe and max(decode_drops) == 0.0,
              "prefills_routed": len(prefills) == eng.admissions * n_moe}
    checks["flash_once_per_layer_and_admission"] = \
        launches["flash_attention"] == cfg.num_layers * eng.admissions
    checks["decode_once_per_layer_and_step"] = \
        launches["decode_attention"] == (0 if mla else cfg.num_layers) \
        * eng.decode_steps
    out = {"phase": "moe", "model": cfg.name, "layers": cfg.num_layers,
           "moe_layers": n_moe, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "launches": launches,
           "admissions": eng.admissions, "decode_steps": eng.decode_steps,
           "capacity_decode_B8": _capacity(eng.B, cfg.moe),
           "capacity_prefill_512": _capacity(PROMPT_RANGE[1], cfg.moe),
           "prefill_drop_frac": {"mean": statistics.mean(admit_drop),
                                 "max": max(admit_drop),
                                 "per_admission": admit_drop},
           "decode_drop_frac_max": max(decode_drops),
           "weight_bytes": weight_bytes, "decode_read_bytes": read_bytes,
           "step_ms_median": row["step_ms_median"],
           "step_floor_ms": read_bytes / HBM_BW * 1e3,
           "step_over_floor": row["step_ms_median"]
           / (read_bytes / HBM_BW * 1e3),
           "prefill_ms_512": row[f"prefill_ms_{PROMPT_RANGE[1]}"],
           "prefill_tok_s_512": PROMPT_RANGE[1]
           / row[f"prefill_ms_{PROMPT_RANGE[1]}"] * 1e3,
           "decode_tok_s": row["decode_tok_s"],
           "max_memory_allocated": row["max_memory_allocated"],
           "cache_bytes": eng._cache_bytes(), "schema_bytes": schema_bytes,
           "checks": checks, "ok": all(checks.values())}
    if mla:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        out["latent_bytes_per_layer"] = eng.B * eng.max_seq * width * 2
        # k and v of every head at the v head dim, as a GQA cache of
        # cfg.num_heads kv heads would hold them
        out["kv_bytes_per_layer_if_gqa"] = \
            2 * eng.B * eng.max_seq * cfg.num_heads * cfg.head_dim * 2
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} moe serve: {checks}")
    # the profile fills all 8 slots in one step: an engine on the same
    # weights with no rate controller, whose buckets would hold back
    # prompts the serve run has just billed
    del eng
    eng = ServeEngine(cfg, RunConfig(), params, batch_slots=8,
                      max_seq=1024)
    phase_profile(torch, device, eng)
    phase_parity_moe(torch, device, eng)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_moe_f32(torch, device, cfg, f32_layers)
    torch.cuda.empty_cache()
    moe_smoke_on_card(torch, device, arch)
    return launches


def phase_parity_moe(torch, device, eng):
    """The moe model's kernel path against its plain path at bf16, each
    run alone (one 300-token prefill and 4 decode steps, the plain run fed
    the kernel run's tokens), every routing call recorded:

    * per launch, asserted: every flash and decode launch of the kernel run
      against its plain version on the same inputs, within
      ``FLASH_TOL``/``DECODE_TOL`` at bf16 (an MLA model's prefill only);
    * end to end, reported: the logits' gap and the top-k choices that
      differ between the two runs (routing is discrete: a bf16 ulp can flip
      a choice, and a capacity drop with it), beside the same two numbers
      for the plain path against itself with every attention output nudged
      by 1 + 2^-8 and by 1 - 2^-8 (the model's own bf16 noise floor; on an
      MLA model the nudge reaches the prefill's attention, the one the
      kernel computes), each per forward (the prefill, then each decode
      step): a flipped choice for a decode token moves that step's
      logits far more than flips among a prefill's 300 tokens."""
    from repro_torch.configs import RunConfig
    kernel, plain = RunConfig(), RunConfig(attention_impl="naive")
    err = {"flash_attention": [], "decode_attention": []}
    routes = {"kernel": [], "plain": []}
    with attention_checked(err), recording_routes(routes["kernel"]):
        k_runs, tokens = parity_logits(torch, device, eng.params,
                                       eng.max_seq, {"kernel": kernel})
    with recording_routes(routes["plain"]):
        p_runs, _ = parity_logits(torch, device, eng.params, eng.max_seq,
                                  {"plain": plain}, tokens)
    cfg = eng.cfg
    n_dec = 0 if cfg.mla is not None else cfg.num_layers
    n_moe = cfg.num_layers - cfg.dense_layer_prefix
    rel, agree = logit_gap(k_runs["kernel"], p_runs["plain"])
    flips, choices = route_flips(routes["kernel"], routes["plain"])
    # the noise floor: the plain path against itself with every attention
    # output scaled by 1 + 2^-8 and by 1 - 2^-8
    floors = {}
    for sign in (1, -1):
        nudged = []
        with attention_nudged(1 + sign * FLOOR_NUDGE), \
                recording_routes(nudged):
            n_runs, _ = parity_logits(torch, device, eng.params, eng.max_seq,
                                      {"plain": plain}, tokens)
        gap, _ = logit_gap(n_runs["plain"], p_runs["plain"])
        floors["+" if sign > 0 else "-"] = {
            "per_step_rel_err": gap, "routing_flips_by_step": flips_by_step(
                route_flips(nudged, routes["plain"])[0], n_moe)}
    checks = {
        "every_launch_checked": len(err["flash_attention"])
        == cfg.num_layers and len(err["decode_attention"]) == 4 * n_dec,
        "every_moe_layer_routed": len(routes["kernel"]) == 5 * n_moe,
        "flash_per_launch": max(err["flash_attention"], default=0.0)
        <= FLASH_TOL["bfloat16"],
        "decode_per_launch": max(err["decode_attention"], default=0.0)
        <= DECODE_TOL["bfloat16"]["o"]}
    emit({"phase": "parity", "model": cfg.name, "prompt": 300,
          "decode_steps": 4,
          "per_launch_max_rel_err": {k: max(v, default=None)
                                     for k, v in err.items()},
          "max_rel_logit_err_not_asserted": max(rel),
          "per_step_rel_err": rel, "parity_tol": PARITY_TOL,
          "argmax_agree_share": agree,
          "routing_choices_differing": sum(flips),
          "routing_choices": sum(choices),
          "routing_flips_by_step": flips_by_step(flips, n_moe),
          "bf16_floor_plain_vs_plain_attention_nudged_2^-8": max(
              max(f["per_step_rel_err"]) for f in floors.values()),
          "bf16_floor_routing_choices_differing": sum(
              sum(f["routing_flips_by_step"]) for f in floors.values()),
          "bf16_floors": floors,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        worst = {k: max(v, default=None) for k, v in err.items()}
        raise AssertionError(f"{cfg.name} parity: {checks}, per launch "
                             f"{worst}")


def phase_parity_moe_f32(torch, device, cfg, layers: int):
    """The first ``layers`` layers of ``cfg`` at full width in f32 (fresh
    weights from the serve phase's seed) with an f32 cache, kernel path
    and plain path each run alone (the plain run fed the kernel run's
    tokens), asserted: identical greedy tokens, identical routing at every
    moe layer and step, logits within ``MOE_F32_TOL`` of max |logit|, the
    kernels launched once per layer (flash) and per layer and step
    (decode, none on an MLA model)."""
    import dataclasses
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                                param_dtype="float32")
    model = init_params(cfg32, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED))
    flash_attention.launches = 0
    decode_attention.launches = 0
    rk, rp = [], []
    with recording_routes(rk):
        k_runs, tokens = parity_logits(torch, device, model, 1024,
                                       {"kernel": RunConfig()},
                                       cache_dtype="float32")
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    with recording_routes(rp):
        p_runs, _ = parity_logits(
            torch, device, model, 1024,
            {"plain": RunConfig(attention_impl="naive")}, tokens,
            cache_dtype="float32")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    del model
    gc.collect()
    rel, agree = logit_gap(k_runs["kernel"], p_runs["plain"])
    flips, choices = route_flips(rk, rp)
    n_dec = 0 if cfg.mla is not None else layers
    checks = {"launched": launches == {"flash_attention": layers,
                                       "decode_attention": 4 * n_dec},
              "tokens_identical": agree == 1.0,
              "routing_identical": sum(flips) == 0
              and len(rk) == 5 * (layers - cfg.dense_layer_prefix),
              "logits": max(rel) <= MOE_F32_TOL}
    emit({"phase": "parity", "model": cfg.name, "dtype": "float32",
          "layers": layers, "weight_bytes": weight_bytes, "prompt": 300,
          "decode_steps": 4, "max_rel_logit_err": max(rel),
          "per_step_rel_err": rel, "tol": MOE_F32_TOL,
          "argmax_agree_share": agree,
          "routing_choices_differing": sum(flips),
          "routing_choices": sum(choices), "launches": launches,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} f32 x {layers} layers: {checks}, "
                             f"{max(rel)}, flips {sum(flips)}")


def moe_smoke_on_card(torch, device, arch: str):
    """The smoke config of ``arch`` at f32 on the card against the same
    port on the CPU, from the same weights: one moe layer's dispatch tables
    equal to the integer, its y and aux within ``MOE_SMOKE_TOL``; then
    both ``ServeEngine``s (4 slots of 64: every slot is routed at decode,
    so decode can drop) serve the same 6 requests to the same tokens and
    ledger."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.serve import Request, ServeEngine, TenantScheduler
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    host = init_params(cfg, device=cpu, seed=0)
    card = init_params(cfg, device=cpu, seed=0).to(device)
    layer = cfg.dense_layer_prefix
    gen = torch.Generator().manual_seed(SEED + 40)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    ys = {}
    for name, model, dev in (("cpu", host, cpu), ("card", card, device)):
        p = model.blocks[layer]["moe"]
        xf = x.reshape(-1, cfg.d_model).to(dev)
        gate, eidx, _ = moe.route_topk(p["router"], xf, cfg.moe)
        cap = moe._capacity(xf.shape[0], cfg.moe)
        tables = moe._dispatch_tables(eidx, gate, cfg.moe.num_experts, cap,
                                      xf.shape[0], cfg.moe.top_k)
        y, aux = moe.apply_moe(p, x.to(dev), cfg)
        ys[name] = ([t.cpu() for t in tables[:2]], y.cpu(),
                    {k: float(v) for k, v in aux.items()})
    tables_equal = all(torch.equal(a, b) for a, b in
                       zip(ys["cpu"][0], ys["card"][0]))
    y_err = rel_err(ys["card"][1], ys["cpu"][1])
    aux_err = max(abs(ys["card"][2][k] - ys["cpu"][2][k])
                  / max(abs(ys["cpu"][2][k]), 1e-30) for k in moe.AUX_KEYS)
    rng = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in MOE_SMOKE_PROMPTS]

    def serve(model, dev):
        sched = TenantScheduler(policy="wfq", charge_prompt=True)
        eng = ServeEngine(cfg, RunConfig(), model, batch_slots=4, max_seq=64,
                          scheduler=sched, device=dev)
        for i, prompt in enumerate(prompts):
            eng.submit(Request(tenant_id=i % TENANTS, prompt=prompt,
                               max_new_tokens=10, req_id=i, arrival=0.0))
        k = 0
        while sched.pending() or any(s.active for s in eng.slots):
            k += 1
            eng.step(now=0.1 * k)
            if k > 200:
                raise AssertionError("smoke engine did not drain")
        return ([(r.req_id, r.generated) for r in eng.completed],
                dict(sched.served_tokens), sched.ledger())

    drops = []
    with recording_moe(drops):
        on_card = serve(card, device)
    decode_drop = max(float(d) for _b, s, d in drops if s == 1)
    on_cpu = serve(host, cpu)
    checks = {"dispatch_tables_equal": tables_equal,
              "y": y_err <= MOE_SMOKE_TOL, "aux": aux_err <= MOE_SMOKE_TOL,
              "engine_tokens_and_ledger_equal": on_card == on_cpu}
    emit({"phase": "moe_smoke", "model": cfg.name, "device": str(device),
          "y_rel_err": y_err, "aux_rel_err": aux_err, "tol": MOE_SMOKE_TOL,
          "requests": len(prompts), "decode_drop_frac_max": decode_drop,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} on the card vs the CPU: {checks}")
    del card
    torch.cuda.empty_cache()


def phase_nemotron(torch, device, cfg=None):
    """nemotron-4-340b (``cfg``: its full-width config cut to
    ``NEMOTRON_LAYERS`` by default): 96/8 heads at head dim 192, group 12,
    squared-ReLU MLP, layernorm with bias, untied embeddings. Served
    through ``ServeEngine`` (``phase_serve``: 8 slots of 1024, the serve
    traffic, a ``RateController``), flash once per layer and admission and
    decode at group 12 once per layer and step; profiled on a
    controller-free engine over the same weights (8 prompts admitted at
    once); parity at bf16 (``phase_parity_vlm``: every attention launch
    held against its plain version, asserted; the end-to-end gap beside
    the plain path nudged by 1 + 2^-8 and by 1 - 2^-8, reported); its first
    ``NEMOTRON_F32_LAYERS`` layers at f32 with an f32 cache once the bf16
    model is freed (``phase_parity_f32``: identical tokens, logits within
    ``VLM_F32_TOL``). Checks: the cache's bytes the schema's. Reported: the
    weight bytes, the step beside the bytes a step must read at 3.35
    TB/s, the busy share, launches a step, the prefill of 512, tokens/s,
    peak memory. Returns the serve run's launch counts."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.serve import ServeEngine
    cfg = cfg or dataclasses.replace(get_config("nemotron-4-340b"),
                                     num_layers=NEMOTRON_LAYERS)
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before "
                             f"{cfg.name}'s weights")
    row = {}
    eng, launches, _ = phase_serve(
        torch, device, cfg, cfg.num_layers,
        {"flash_attention": flash_attention},
        {"decode_attention": decode_attention}, row_out=row)
    params = eng.params
    weight_bytes, read_bytes = decode_read_bytes(params, eng.B)
    schema_bytes = schema_cache_bytes(torch, eng)
    group = cfg.num_heads // cfg.num_kv_heads
    checks = {"cache_bytes_are_the_schemas":
              eng._cache_bytes() == schema_bytes,
              "head_dim_192_group_12": (cfg.head_dim, group) == (192, 12)}
    prefill = row[f"prefill_ms_{PROMPT_RANGE[1]}"]
    floor_ms = read_bytes / HBM_BW * 1e3
    out = {"phase": "nemotron", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                            cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "group": group, "launches": launches,
           "admissions": eng.admissions, "decode_steps": eng.decode_steps,
           "weight_bytes": weight_bytes, "decode_read_bytes": read_bytes,
           "step_ms_median": row["step_ms_median"], "step_floor_ms": floor_ms,
           "step_over_floor": row["step_ms_median"] / floor_ms,
           "prefill_ms_512": prefill,
           "prefill_tok_s_512": PROMPT_RANGE[1] / prefill * 1e3,
           "decode_tok_s": row["decode_tok_s"],
           "max_memory_allocated": row["max_memory_allocated"],
           "cache_bytes": eng._cache_bytes(), "schema_bytes": schema_bytes,
           "checks": checks, "ok": all(checks.values())}
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name} serve: {checks}")
    del eng
    eng = ServeEngine(cfg, RunConfig(), params, batch_slots=8,
                      max_seq=1024)
    decode, _ = phase_profile(torch, device, eng)
    emit({"phase": "nemotron", "model": cfg.name,
          "step_busy_share": decode["device_busy_share"],
          "launches_per_step": decode["kernel_launches"] / 4})
    phase_parity_vlm(torch, device, eng)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_f32(torch, device, cfg, NEMOTRON_F32_LAYERS)
    torch.cuda.empty_cache()
    return launches


def control_trace(np, n: int, seed: int = 0):
    """The control-plane scale bench's counter trace: weights from
    {1, 2, 4}, integer per-tick counter steps summing to ~1.1 x capacity,
    10% of tenants backlogged."""
    rng = np.random.default_rng(seed)
    weights = rng.choice([1.0, 2.0, 4.0], size=n).astype(np.float64)
    rates = rng.uniform(0.2, 2.0, size=n) * (CONTROL_CAPACITY / n)
    steps = np.maximum(np.round(rates), 1.0)
    backlogged = rng.random(n) < CONTROL_BACKLOG_FRAC
    return weights, steps, backlogged


def control_plane(n: int, weights, device):
    from repro_torch.control.vectorized import VectorizedControlPlane
    plane = VectorizedControlPlane(CONTROL_CAPACITY, alpha=0.5,
                                   headroom=1.25, scheduler_buckets=True,
                                   device=device)
    for t in range(n):
        plane.add_tenant(t, weight=float(weights[t]))
    return plane


def control_parity(np, n: int, device, ticks: int = 5) -> float:
    """One counter trace through the port's object TenantScheduler +
    RateController and through the plane on the card: the worst
    |allocation difference| per unit capacity."""
    from repro_torch.control import RateController
    from repro_torch.serve import TenantScheduler
    weights, steps, backlogged = control_trace(np, n)
    sched = TenantScheduler(policy="wfq", charge_prompt=True)
    ctrl = RateController(CONTROL_CAPACITY,
                          weights={t: float(weights[t]) for t in range(n)},
                          alpha=0.5)
    ctrl.attach_scheduler(sched)
    for t in range(n):
        sched.add_tenant(t, weight=float(weights[t]))
        if backlogged[t]:
            sched.queues[t].append(None)     # pending() counts length only
    plane = control_plane(n, weights, device)
    queue = np.where(backlogged, 1.0, 0.0)
    served = np.zeros(n)
    for k in range(ticks):
        served += steps
        for t in range(n):
            sched.served_tokens[t] = int(served[t])
        ctrl.tick(float(k))
        plane.tick(served, queue=queue, now=float(k))
    vec = plane.allocations()
    if set(vec) != set(ctrl.allocations):
        return math.inf
    return max(abs(ctrl.allocations[t] - vec[t])
               for t in vec) / CONTROL_CAPACITY


def tick_parts(torch, np, plane, served, queue, now: float,
               reps: int = 10):
    """Where one fused tick's time goes: the tick's three steps run apart,
    each timed on the host clock around a synchronised call (median of
    ``reps``): the (3, n) sample stack built and copied to the card, the
    ``fused_tick`` operations, and the allocations read back; plus the
    operations' device time alone (CUDA events, host enqueue hidden)."""
    from repro_torch.control.vectorized import fused_tick
    dev = plane._device_state()
    names = ("level", "brate", "bcap", "updated", "ewma_off", "ewma_def",
             "prev_off", "prev_def", "weight", "active")
    zeros = np.zeros_like(served)

    def clock(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3, out

    upload_ms, samples = clock(lambda: torch.tensor(
        np.stack([served, zeros, queue]), device=plane.device))
    params = torch.tensor([now, plane.prev_t, plane.alpha, plane.capacity,
                           plane.headroom, plane.min_rate, plane.burst_s],
                          dtype=torch.float64, device=plane.device)

    def compute():
        return fused_tick(*(dev[k] for k in names), samples, params,
                          iters=plane.iters,
                          scheduler_buckets=plane.scheduler_buckets)

    compute_ms, out = clock(compute)
    alloc, lvl = out[8], out[9]
    readback_ms, _ = clock(
        lambda: torch.cat([alloc, lvl.reshape(1)]).cpu().numpy())
    return {"upload_ms": upload_ms, "compute_host_ms": compute_ms,
            "compute_device_ms": Timer(torch, plane.device).ms(compute,
                                                               reps=reps),
            "readback_ms": readback_ms, "reps": reps}


def phase_control(torch, device, smi: str):
    """The fused tick at fleet scale on the card. Returns the water-fill
    launches of the timed runs."""
    import numpy as np
    from repro_torch.kernels.waterfill import water_fill
    launches = 0
    rows = {}
    for n in CONTROL_N:
        weights, steps, backlogged = control_trace(np, n)
        t0 = time.perf_counter()
        plane = control_plane(n, weights, device)
        setup_s = time.perf_counter() - t0
        queue = np.where(backlogged, 1.0, 0.0)
        served = np.zeros(n)
        for k in range(CONTROL_WARMUP):
            served = served + steps
            plane.tick(served, queue=queue, now=float(k))
        water_fill.launches = 0
        times = []
        for k in range(CONTROL_WARMUP, CONTROL_WARMUP + CONTROL_TICKS):
            served = served + steps
            torch.cuda.synchronize()
            ts = time.perf_counter()
            alloc = plane.tick(served, queue=queue, now=float(k))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
        n_launch = water_fill.launches
        launches += n_launch
        if n_launch != CONTROL_TICKS:
            raise AssertionError(f"{n} tenants: {n_launch} water-fill "
                                 f"launches in {CONTROL_TICKS} ticks")
        # the final level lies at most one bisection step, (cap / min_w)
        # * 2^-48, above the exact one, and each unsatisfied tenant takes
        # w * level: the sum may exceed the capacity by sum(w) times that
        over = weights.sum() * CONTROL_CAPACITY / weights.min() * 2.0 ** -48
        if not (np.isfinite(alloc).all() and alloc.shape == (n,)
                and alloc.sum() <= CONTROL_CAPACITY * (1 + 1e-12) + over):
            raise AssertionError(f"{n} tenants: bad allocations, sum "
                                 f"{alloc.sum()} over {CONTROL_CAPACITY} "
                                 f"+ {over}")
        tick_s = statistics.median(times)
        row = {"phase": "control", "tenants": n,
               "us_per_tick_median": tick_s * 1e6,
               "us_per_tick_min": min(times) * 1e6,
               "us_per_tick_max": max(times) * 1e6,
               "ticks": CONTROL_TICKS, "tenants_per_s": n / tick_s,
               "state_bytes_per_tenant": plane.state_bytes() / n,
               "water_fill_launches": n_launch,
               "allocated_share": float(alloc.sum()) / CONTROL_CAPACITY,
               "water_level": plane.last_level, "setup_s": setup_s,
               "gpu": smi}
        if n in (1_000, 10_000):
            err = control_parity(np, n, device)
            row["object_parity_err_per_capacity"] = err
            row["object_parity_tol"] = 1e-6
            if not err <= 1e-6:
                raise AssertionError(f"{n} tenants: vectorized vs object "
                                     f"{err} x capacity > 1e-6")
        if n == 100_000:
            cpu = control_plane(n, weights, "cpu")
            card = control_plane(n, weights, device)
            srv = np.zeros(n)
            for k in range(4):
                srv = srv + steps
                a_card = card.tick(srv, queue=queue, now=float(k))
                a_cpu = cpu.tick(srv, queue=queue, now=float(k))
            card._sync_host()
            cpu._sync_host()
            rel = float(np.max(np.abs(a_card - a_cpu)
                               / np.maximum(np.abs(a_cpu), 1e-300)))
            nan_eq = all(np.array_equal(np.isnan(getattr(card, nm)),
                                        np.isnan(getattr(cpu, nm)))
                         for nm in card.STATE_ARRAYS)
            state_rel = max(float(np.nanmax(
                np.abs(getattr(card, nm) - getattr(cpu, nm))
                / np.maximum(np.abs(getattr(cpu, nm)), 1e-300)))
                for nm in card.STATE_ARRAYS)
            row.update(cpu_parity_rel=rel, cpu_state_rel=state_rel,
                       cpu_nan_positions_equal=nan_eq, cpu_parity_tol=1e-9)
            if not (rel <= 1e-9 and state_rel <= 1e-9 and nan_eq):
                raise AssertionError(f"100k tick card vs cpu: alloc {rel}, "
                                     f"state {state_rel}, NaN {nan_eq}")
        if n == CONTROL_N[-1]:
            row["tick_parts"] = tick_parts(torch, np, plane, served + steps,
                                           queue, now=float(10_000))
            row["tick_parts"]["device_busy_share"] = \
                row["tick_parts"]["compute_device_ms"] / (tick_s * 1e3)
        emit(row)
        rows[n] = row
        del plane
    return launches, rows


def phase_replay(torch, device, cfg, params=None):
    """``replay_scenario`` over full-width llama3.2-3b (``params``, or a
    model made from a seed): steady on both control planes, adversarial
    against its hog-free baseline. The replayer's clock is virtual, so
    these are the whole path's fairness numbers, not timings. Returns the
    water-fill launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.waterfill import water_fill
    from repro_torch.models.params import init_params
    from repro_torch.serve.replay import (
        ADVERSARIAL_HOG, TraceReplayer, adversarial_baseline,
        make_replay_engine, replay_scenario, scenario_spec)
    if params is None:
        params = init_params(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(SEED + 4))
    n, intervals = REPLAY_TENANTS, REPLAY_INTERVALS
    water = 0
    reports = {}

    def run(label, name, backend, trace=None):
        nonlocal water
        _tr, cap = scenario_spec(name, n_tenants=n, intervals=intervals)
        eng = make_replay_engine(capacity=cap, batch_slots=REPLAY_SLOTS,
                                 max_seq=REPLAY_MAX_SEQ, backend=backend,
                                 params=params)
        flash_attention.launches = 0
        decode_attention.launches = 0
        water_fill.launches = 0
        t0 = time.perf_counter()
        if trace is None:
            rep = replay_scenario(name, n_tenants=n, intervals=intervals,
                                  engine=eng)
        else:
            rep = TraceReplayer(eng, capacity=cap).run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"flash_attention": flash_attention.launches,
               "decode_attention": decode_attention.launches,
               "water_fill": water_fill.launches}
        layers = cfg.num_layers
        if got["flash_attention"] != layers * eng.admissions or \
                got["decode_attention"] != layers * eng.decode_steps:
            raise AssertionError(f"{label}: launches {got} for "
                                 f"{eng.admissions} admissions, "
                                 f"{eng.decode_steps} steps")
        ticks = eng.steps // eng.control_every
        if backend == "vectorized" and not 0 < got["water_fill"] <= ticks:
            raise AssertionError(f"{label}: {got['water_fill']} water-fill "
                                 f"launches in {ticks} controller ticks")
        if backend == "object" and got["water_fill"]:
            raise AssertionError(f"{label}: the object plane launched the "
                                 f"water-fill kernel")
        water += got["water_fill"]
        reports[label] = rep
        emit({"phase": "replay", "run": label, "scenario": name,
              "backend": backend, "model": cfg.name,
              "layers": cfg.num_layers, "tenants": len(rep.per_tenant),
              "intervals": intervals, "capacity_tok_s": cap,
              "decode_steps": rep.decode_steps,
              "admissions": eng.admissions, "controller_ticks": ticks,
              "launches": got, "wall_s": wall,
              "jain": rep.jain(), "max_min_deviation":
                  rep.max_min_deviation(),
              "rates": {t: r.achieved_rate
                        for t, r in rep.per_tenant.items()},
              "served_tokens": {t: r.served_tokens
                                for t, r in rep.per_tenant.items()}})
        del eng
        return rep

    obj = run("steady_object", "steady", "object")
    vec = run("steady_vectorized", "steady", "vectorized")
    for label, rep in (("object", obj), ("vectorized", vec)):
        if not (rep.jain() >= 0.95 and rep.max_min_deviation() < 0.10):
            raise AssertionError(f"steady {label}: Jain {rep.jain()}, "
                                 f"deviation {rep.max_min_deviation()}")
    gap = max(abs(vec.per_tenant[t].achieved_rate
                  / obj.per_tenant[t].achieved_rate - 1.0) for t in range(n))
    if gap >= 0.02:
        raise AssertionError(f"steady: vectorized vs object rates {gap}")
    hog_trace, cap = scenario_spec("adversarial", n_tenants=n,
                                   intervals=intervals)
    shared = run("adversarial_vectorized", "adversarial", "vectorized")
    base = run("adversarial_baseline_vectorized", "adversarial",
               "vectorized", trace=adversarial_baseline(hog_trace))
    hog = shared.per_tenant[n + ADVERSARIAL_HOG]
    victims = range(n - 1)
    degr = {t: 1.0 - shared.per_tenant[t].achieved_rate
            / base.per_tenant[t].achieved_rate for t in victims}
    victim_p99 = max(shared.per_tenant[t].p99_admit_wait_s for t in victims)
    victim_p50 = max(shared.per_tenant[t].p50_admit_wait_s for t in victims)
    victim_wait = max(shared.per_tenant[t].mean_admit_wait_s
                      for t in victims)
    checks = {
        "victims_degraded_under_5pct": all(v < 0.05 for v in degr.values()),
        "hog_between_quarter_and_three_quarters": 0.25 * cap
        < hog.achieved_rate < 0.75 * cap,
        "hog_waits_4x_victims": hog.mean_admit_wait_s
        > 4 * max(victim_wait, 1e-3),
        "victim_p99_under_1s": 0.0 < victim_p99 < 1.0,
        "victim_p50_at_floor": victim_p50 <= 0.01,
        "hog_p99_10x_victims": hog.p99_admit_wait_s > 10 * victim_p99}
    emit({"phase": "replay", "run": "isolation", "steady_rate_gap": gap,
          "victim_degradation": degr, "hog_rate": hog.achieved_rate,
          "capacity_tok_s": cap, "victim_p99_admit_wait_s": victim_p99,
          "hog_p99_admit_wait_s": hog.p99_admit_wait_s, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"adversarial isolation: {checks}")
    return water


def cluster_run(torch, device, name, backend, *, params=None, model=None,
                trace_path=None, mem=None):
    """One cluster scenario: ``CLUSTER_ENGINES`` engines serving one model
    (``params``, or arch ``model``'s smoke config with fresh weights on
    ``device``) behind one controller, driven by ``replay_scenario`` and
    its own operator script. Hooks only measure: the bytes each
    ``CoreEngine.route`` carried per tenant, the engines a serve swap
    retires, and ``mem`` (the card's allocated bytes; None: not measured)
    around every ``park`` and ``fail_engine``. Returns (summary, cluster,
    report, facts)."""
    from repro_torch.core.engine import CoreEngine
    from repro_torch.serve.replay import (
        CLUSTER_SCENARIOS, make_replay_cluster, replay_scenario,
        scenario_spec)
    n, intervals = REPLAY_TENANTS, REPLAY_INTERVALS
    _trace, cap = scenario_spec(name, n_tenants=n, intervals=intervals)
    kw = {"params": params} if params is not None else \
        {"device": device, "model": model}
    cl = make_replay_cluster(
        capacity=cap, engines=CLUSTER_ENGINES, batch_slots=REPLAY_SLOTS,
        max_seq=REPLAY_MAX_SEQ, autopilot=CLUSTER_SCENARIOS[name],
        core_plane=name in CLUSTER_CORE_PLANE, backend=backend, **kw)
    facts = {"parks": [], "crashes": [], "pumped": {}}
    # every engine that served: a serve swap retires one, with its counts
    served_by = list(cl.engines)
    orig_park, orig_swap, orig_fail = \
        cl.park, cl.swap_module, cl.fail_engine

    def park(k, *, now=None):
        cache = cl.engines[k]._cache_bytes()
        before = mem() if mem is not None else None
        orig_park(k, now=now)
        after = mem() if mem is not None else None
        facts["parks"].append({
            "engine": k, "cache_bytes": cache,
            "freed_bytes": cl._suspended_bytes[k],
            "allocated_drop": None if mem is None else before - after})

    def fail_engine(k, *, now=None):
        # a crash wipes the modules' state in place and keeps the slot's
        # stack, its cache included (StackModule.crash): the recovered
        # engine serves again without allocating
        cache = cl.engines[k]._cache_bytes()
        before = mem() if mem is not None else None
        rec = orig_fail(k, now=now)
        after = mem() if mem is not None else None
        facts["crashes"].append({
            "engine": k, "cache_bytes": cache,
            "cache_bytes_after": cl.engines[k]._cache_bytes(),
            "allocated_drop": None if mem is None else before - after})
        return rec

    def swap_module(k, plane, factory, *, now=None):
        rec = orig_swap(k, plane, factory, now=now)
        if plane == "serve":
            served_by.append(cl.engines[k])
        return rec
    cl.park, cl.swap_module, cl.fail_engine = park, swap_module, fail_engine
    orig_route = CoreEngine.route

    def route(self, op):
        facts["pumped"][op.tenant_id] = \
            facts["pumped"].get(op.tenant_id, 0) + op.size_bytes
        return orig_route(self, op)
    CoreEngine.route = route
    t0 = time.perf_counter()
    try:
        rep = replay_scenario(name, n_tenants=n, intervals=intervals,
                              engine=cl, trace_path=trace_path)
    finally:
        CoreEngine.route = orig_route
    if device.type == "cuda":
        torch.cuda.synchronize()
    facts["wall_s"] = time.perf_counter() - t0
    facts["admissions"] = sum(e.admissions for e in served_by)
    facts["engine_decode_steps"] = sum(e.decode_steps for e in served_by)
    summary = {
        "served_tokens": {t: r.served_tokens
                          for t, r in rep.per_tenant.items()},
        "admitted_requests": {t: r.admitted_requests
                              for t, r in rep.per_tenant.items()},
        "completed_requests": {t: r.completed_requests
                               for t, r in rep.per_tenant.items()},
        "decode_steps": rep.decode_steps,
        "engine_decode_steps": facts["engine_decode_steps"],
        "admissions": facts["admissions"],
        "placement": rep.placement, "migrations": rep.migrations,
        "migrations_started": cl.migrations_started,
        "swaps": rep.swaps, "checkpoints": rep.checkpoints,
        "recoveries": rep.recoveries, "max_parked": rep.max_parked,
        "autopilot_moves": rep.autopilot_moves,
        "core_bytes": {t: cl.tenant_core_bytes(t) for t in rep.per_tenant},
        "pumped_bytes": dict(facts["pumped"])}
    return summary, cl, rep, facts


def _cluster_checks(name, cl, rep, facts):
    """The reference's scenario claims (``tests/test_replay.py``'s slow
    tests) and conservation on every plane for every tenant."""
    checks = {"jain_at_least_0.95": rep.jain() >= 0.95}
    for t in rep.per_tenant:
        cl.assert_ledger_conservation(t)          # raises on any plane
    checks["served_equals_billed_ground_truth"] = all(
        cl.tenant_served_tokens(t) == cl.tenant_billed_ground_truth(t)
        for t in rep.per_tenant)
    pumped = facts["pumped"]
    if name in ("hotspot", "stack_swap"):
        # hotspot's script pumps nothing: its bytes plane only moves
        checks["bytes_plane_equals_pumped"] = all(
            cl.tenant_core_bytes(t) == pumped.get(t, 0)
            for t in rep.per_tenant) and bool(pumped) == (
                name == "stack_swap")
    if name == "failover":
        # bytes routed after the restored checkpoint die with the crash
        checks["bytes_plane_at_most_pumped"] = all(
            0 < cl.tenant_core_bytes(t) <= pumped.get(t, 0)
            for t in rep.per_tenant)
    if name == "migration":
        checks["migrated"] = rep.migrations >= 1
        checks["hog_off_engine_0"] = rep.placement[REPLAY_TENANTS - 1] != 0
        checks["parked_and_unparked"] = bool(facts["parks"]) and \
            not cl.parked
    elif name == "consolidation":
        checks["parked"] = rep.max_parked >= 1
        checks["cores_saved"] = rep.cores_saved > 0
        checks["mem_saved"] = rep.mem_saved_bytes > 0
        checks["peak_resident_above_parked"] = \
            rep.peak_resident_cache_bytes > rep.max_parked_bytes
        checks["autopilot_moved"] = rep.autopilot_moves >= 1
        checks["all_served"] = all(r.achieved_rate > 0
                                   for r in rep.per_tenant.values())
    elif name == "hotspot":
        moved = [mv.tenant for _, mv in cl.autopilot.move_log]
        cl.autopilot.assert_no_ping_pong()
        checks["hog_moved_once"] = moved.count(REPLAY_TENANTS - 1) == 1
        checks["nobody_moved_twice"] = len(moved) == len(set(moved))
    elif name == "stack_swap":
        serve = [r for r in cl.swap_log if r.plane == "serve"]
        byts = [r for r in cl.swap_log if r.plane == "bytes"]
        checks["two_swaps_one_per_plane"] = rep.swaps == 2 and \
            len(serve) == 1 and len(byts) == 1
        checks["serve_policy_rr"] = bool(serve) and \
            cl.engines[serve[0].engine].scheduler.policy == "rr"
        checks["core_nsm_compressed"] = bool(byts) and \
            cl.core_engines[byts[0].engine].default_nsm == "compressed"
    elif name == "failover":
        checks["checkpointed"] = rep.checkpoints >= 1
        checks["recovered"] = rep.recoveries >= 1 and \
            all(r.recovered for r in cl.failure_log)
        checks["crash_keeps_the_slot_cache"] = bool(facts["crashes"]) and \
            all(c["cache_bytes_after"] == c["cache_bytes"]
                for c in facts["crashes"])
    return checks


def phase_cluster(torch, device, cfg, params, *, trace_dir=None):
    """The engine cluster over ``params`` (one ``Model``, full-width
    llama3.2-3b on the card): ``CLUSTER_ENGINES`` engines behind one
    ``RateController`` through migration, consolidation, hotspot,
    stack_swap and failover. Per scenario: the reference's scenario claims,
    conservation on every plane, every attention call through a kernel,
    the water-fill kernel on the vectorized run and on no other, the
    cache's bytes freed by each park, the trace checked by
    ``tools/check_trace.py``, and the ledgers equal to the same scenario
    run again on the CPU at the arch's smoke config. The weights
    stay resident once: building a cluster allocates only its caches.
    Traces go to ``trace_dir`` (``build/cluster_traces``). Returns the
    launches of each kernel over the phase."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.waterfill import water_fill
    from repro_torch.serve.replay import make_replay_cluster, scenario_spec
    arch = cfg.name.removesuffix("-smoke")
    on_card = device.type == "cuda"
    mem = (lambda: torch.cuda.memory_allocated(device)) if on_card else None
    layers = cfg.num_layers
    total = {"flash_attention": 0, "decode_attention": 0, "water_fill": 0}

    # one copy of the weights: a cluster's construction adds its caches
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    if on_card:
        torch.cuda.synchronize()
        before = mem()
        _tr, cap = scenario_spec("steady", n_tenants=REPLAY_TENANTS,
                                 intervals=REPLAY_INTERVALS)
        probe = make_replay_cluster(capacity=cap, engines=CLUSTER_ENGINES,
                                    batch_slots=REPLAY_SLOTS,
                                    max_seq=REPLAY_MAX_SEQ, params=params)
        grown = mem() - before
        caches = sum(e._cache_bytes() for e in probe.engines)
        shared = all(e.params is params for e in probe.engines)
        emit({"phase": "cluster", "run": "residency",
              "engines": CLUSTER_ENGINES, "weight_bytes": weight_bytes,
              "cache_bytes": caches, "allocated_growth_bytes": grown,
              "one_model": shared})
        if not (shared and caches <= grown < caches + weight_bytes // 100):
            raise AssertionError(
                f"cluster construction allocated {grown} bytes for "
                f"{caches} cache bytes (weights {weight_bytes})")
        del probe

    trace_dir = Path(trace_dir or ROOT / "build" / "cluster_traces")
    trace_dir.mkdir(parents=True, exist_ok=True)
    for name, backend in CLUSTER_RUNS:
        path = trace_dir / f"{name}.json" if name in CLUSTER_TRACED \
            else None
        flash_attention.launches = 0
        decode_attention.launches = 0
        water_fill.launches = 0
        summary, cl, rep, facts = cluster_run(
            torch, device, name, backend, params=params, trace_path=path,
            mem=mem)
        got = {"flash_attention": flash_attention.launches,
               "decode_attention": decode_attention.launches,
               "water_fill": water_fill.launches}
        ticks = cl.steps // cl.control_every
        checks = _cluster_checks(name, cl, rep, facts)
        checks["flash_per_admission"] = \
            got["flash_attention"] == layers * facts["admissions"] > 0
        checks["decode_per_step"] = got["decode_attention"] == \
            layers * facts["engine_decode_steps"] > 0
        checks["water_fill"] = (0 < got["water_fill"] <= ticks
                                if backend == "vectorized"
                                else got["water_fill"] == 0)
        if on_card:
            checks["park_frees_the_cache"] = all(
                p["allocated_drop"] >= p["cache_bytes"]
                and p["freed_bytes"] == p["cache_bytes"]
                for p in facts["parks"]) and (
                name not in ("migration", "consolidation")
                or any(p["cache_bytes"] > 0 for p in facts["parks"]))
            # the crashed slot's cache stays allocated: the drop is at most
            # a few scheduler buffers, never the cache
            checks["crash_frees_no_cache"] = all(
                abs(c["allocated_drop"]) < max(c["cache_bytes"], 1) // 2
                for c in facts["crashes"])
        if path is not None:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "check_trace.py"),
                 str(path), "--scenario", name], capture_output=True,
                text=True, timeout=120)
            checks["trace_well_formed"] = proc.returncode == 0
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-2000:],
                      file=sys.stderr)
        cpu_summary, *_ = cluster_run(torch, torch.device("cpu"), name,
                                      backend, model=arch)
        diff = sorted(k for k in summary if summary[k] != cpu_summary[k])
        checks["ledgers_equal_a_cpu_run"] = not diff
        for k in got:
            total[k] += got[k]
        steps = cl.steps
        emit({"phase": "cluster", "run": name, "backend": backend,
              "model": cfg.name, "layers": layers,
              "engines": CLUSTER_ENGINES, "tenants": len(rep.per_tenant),
              "intervals": REPLAY_INTERVALS, "capacity_tok_s":
                  rep.capacity, "wall_s": facts["wall_s"],
              "cluster_steps": steps,
              "wall_ms_per_cluster_step": facts["wall_s"] / steps * 1e3,
              "decode_steps_per_engine": [e.decode_steps
                                          for e in cl.engines],
              "admissions_per_engine": [e.admissions for e in cl.engines],
              "admissions": facts["admissions"],
              "engine_decode_steps": facts["engine_decode_steps"],
              "controller_ticks": ticks, "launches": got,
              "migrations": rep.migrations, "swaps": rep.swaps,
              "checkpoints": rep.checkpoints,
              "recoveries": rep.recoveries, "max_parked": rep.max_parked,
              "cores_saved": rep.cores_saved,
              "mem_saved_bytes": rep.mem_saved_bytes,
              "max_parked_bytes": rep.max_parked_bytes,
              "peak_resident_cache_bytes": rep.peak_resident_cache_bytes,
              "parks": facts["parks"], "crashes": facts["crashes"],
              "autopilot_moves":
                  rep.autopilot_moves, "placement": rep.placement,
              "jain": rep.jain(), "served_tokens": summary["served_tokens"],
              "pumped_bytes": facts["pumped"],
              "cpu_mismatch": diff, "checks": checks,
              "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"cluster {name}: {checks} "
                                 f"(CPU mismatch: {diff})")
        del cl, rep
    return total


def watch_run(torch, device, name, watch, *, params=None,
              model="llama3.2-3b", trace_path=None):
    """One replay of claim (k): scenario ``name`` with ``watch`` (True,
    ``"record"``, or None for no watchdog) at the claim's settings, on one
    engine or, for a cluster scenario, on ``CLUSTER_ENGINES`` engines, all
    serving ``params`` (or arch ``model``'s smoke config with fresh weights
    on ``device``). Returns (report, wall seconds, admissions, engine
    decode steps), counting the engines a serve swap retires."""
    from repro_torch.serve.replay import (
        CLUSTER_SCENARIOS, make_replay_cluster, make_replay_engine,
        replay_scenario, scenario_spec)
    _tr, cap = scenario_spec(name, n_tenants=WATCH_TENANTS,
                             intervals=WATCH_INTERVALS)
    kw = {"params": params} if params is not None else \
        {"device": device, "model": model}
    if name in CLUSTER_SCENARIOS:
        eng = make_replay_cluster(
            capacity=cap, engines=CLUSTER_ENGINES,
            autopilot=CLUSTER_SCENARIOS[name],
            core_plane=name in CLUSTER_CORE_PLANE, **kw)
        served = list(eng.engines)
        swap = eng.swap_module

        def swap_module(k, plane, factory, *, now=None):
            rec = swap(k, plane, factory, now=now)
            if plane == "serve":
                served.append(eng.engines[k])
            return rec
        eng.swap_module = swap_module
    else:
        eng = make_replay_engine(capacity=cap, **kw)
        served = [eng]
    t0 = time.perf_counter()
    rep = replay_scenario(name, n_tenants=WATCH_TENANTS,
                          intervals=WATCH_INTERVALS, engine=eng, watch=watch,
                          trace_path=trace_path)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rep, wall, sum(e.admissions for e in served), \
        sum(e.decode_steps for e in served)


def alert_rows(alerts):
    """Alerts as comparable rows: (rule, labels, severity, fired_at,
    resolved_at)."""
    return [[a.rule, [list(kv) for kv in a.labels], a.severity, a.fired_at,
             a.resolved_at] for a in alerts or ()]


def ledgers(rep):
    """A replay's per-tenant ledgers and its decode steps."""
    return {"decode_steps": rep.decode_steps, "tenants": {
        t: [r.served_tokens, r.admitted_requests, r.completed_requests,
            r.deferred_polls, r.achieved_rate]
        for t, r in sorted(rep.per_tenant.items())}}


def watchdog_tick_s(wd, reps: int = WATCH_TICK_REPS) -> float:
    """Seconds per watchdog tick (scrape, ingest, every rule) on a run's
    own registry and store, after warm ticks fill the store's retention,
    as ``run_e2e_watchdog`` measures it, but the median of
    ``WATCH_TICK_BLOCKS`` blocks' means (it times one block of ``reps``):
    a burst of load on a shared host then moves one block, not the
    result."""
    blocks = WATCH_TICK_BLOCKS
    now = wd.store.times()[-1] + 1.0
    for _ in range(wd.store.retention):
        wd.tick(now)
        now += 1.0
    per_block = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(reps // blocks):
            wd.tick(now)
            now += 1.0
        per_block.append((time.perf_counter() - t0) / (reps // blocks))
    return statistics.median(per_block)


def watchdog_claims(reps, base_wall: float, tick_s: float):
    """Claim (k)'s values, as ``run_e2e_watchdog`` computes them, from the
    four watched reports, the watch-free steady wall and the tick cost."""
    hog = str(WATCH_TENANTS - 1)
    adv, fail, swap = (reps["adversarial"], reps["failover"],
                       reps["stack_swap"])
    fairness_on_hog = sum(
        1 for a in adv.alerts or ()
        if a.rule == "fairness_burn" and dict(a.labels).get("tenant") == hog)
    nonhog = [a for a in adv.alerts or ()
              if "tenant" in dict(a.labels)
              and dict(a.labels)["tenant"] != hog]
    dark = [a for a in fail.alerts or () if a.rule == "engine_dark"]
    offscript = [a for a in swap.alerts or ()
                 if a.rule in ("engine_dark", "telemetry_stalled",
                               "conservation_drift", "jain_floor",
                               "parked_leak")
                 or dict(a.labels).get("tenant") not in (hog, None)]
    return {
        "steady_alerts": float(reps["steady"].alerts_fired),
        "adversarial_alerts": float(adv.alerts_fired),
        "adversarial_fairness_on_hog": float(fairness_on_hog),
        "adversarial_nonhog_tenant_alerts": float(len(nonhog)),
        "failover_engine_dark_fired": float(len(dark)),
        "failover_engine_dark_resolved": float(
            sum(1 for a in dark if a.resolved_at is not None)),
        "stack_swap_offscript_alerts": float(len(offscript)),
        "watchdog_tick_us": tick_s * 1e6,
        "step_overhead_frac": tick_s * (WATCH_INTERVALS + 1)
        / max(base_wall, 1e-9)}


def watchdog_limits():
    """The ``e2e_watchdog`` rows of ``bench_thresholds.json``: value name
    -> {"min"/"max": bound}."""
    rows = json.loads(THRESHOLDS.read_text())
    return {k.split(",", 1)[1]: v for k, v in rows.items()
            if k.startswith("e2e_watchdog,")}


def offline_alerts(text: str, interval_s=None):
    """A recorded scrape sequence replayed through a fresh store and the
    stock rules, as ``tools/nk_watch.py`` replays one: windows sized to
    ``interval_s`` (its ``--interval``), else to the median scrape
    spacing. Returns the alert history."""
    from repro_torch.obs import (AlertEngine, SeriesStore, default_rules,
                                 read_scrape_sequence)
    scrapes = read_scrape_sequence(text)
    if interval_s is None:
        times = [ts for ts, _ in scrapes]
        gaps = sorted(b - a for a, b in zip(times, times[1:]) if b > a)
        interval_s = gaps[len(gaps) // 2] if gaps else 1.0
    store, engine = SeriesStore(), AlertEngine(default_rules(interval_s))
    for ts, body in sorted(scrapes):
        store.ingest(body, ts)
        engine.evaluate(store, ts)
    return engine.history


def phase_watchdog(torch, device, cfg, params, *, trace_dir=None):
    """Claim (k) over ``params`` (the replay phase's model: full-width
    llama3.2-3b on the card): steady and adversarial on one engine and
    failover (recording its scrapes) and stack_swap on
    ``CLUSTER_ENGINES`` engines, each with the stock fabric watchdog, then
    one watch-free steady replay and, at once, the tick. Checks every ``e2e_watchdog`` threshold, every
    attention call through a kernel, each run's alerts equal to the same
    scenario on the CPU at the arch's smoke config, the watched steady
    run's ledgers equal to the watch-free run's, the recorded scrapes
    replayed offline to the same alerts, and the failover trace through
    ``tools/check_trace.py``. Returns the launches of each kernel."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    arch = cfg.name.removesuffix("-smoke")
    layers = cfg.num_layers
    trace_dir = Path(trace_dir or ROOT / "build" / "watchdog")
    trace_dir.mkdir(parents=True, exist_ok=True)
    total = {"flash_attention": 0, "decode_attention": 0}
    checks, walls, reps = {}, {}, {}

    def run(label, name, watch, trace_path=None):
        flash_attention.launches = 0
        decode_attention.launches = 0
        rep, wall, admissions, steps = watch_run(
            torch, device, name, watch, params=params, trace_path=trace_path)
        got = {"flash_attention": flash_attention.launches,
               "decode_attention": decode_attention.launches}
        checks[f"{label}_launches"] = \
            got["flash_attention"] == layers * admissions > 0 and \
            got["decode_attention"] == layers * steps > 0
        for k in total:
            total[k] += got[k]
        walls[label] = wall
        emit({"phase": "watchdog", "run": label, "scenario": name,
              "watch": watch, "model": cfg.name, "layers": layers,
              "tenants": WATCH_TENANTS, "intervals": WATCH_INTERVALS,
              "wall_s": wall, "admissions": admissions,
              "decode_steps": steps, "launches": got,
              "alerts_fired": rep.alerts_fired,
              "alerts_resolved": rep.alerts_resolved,
              "alerts_active": rep.alerts_active,
              "alerts": alert_rows(rep.alerts)})
        return rep

    trace = trace_dir / "failover.json"
    for name, watch in WATCH_RUNS:
        reps[name] = run(name, name, watch,
                         trace_path=trace if name == "failover" else None)
    # the watch-free wall, then at once the tick: one host speed for both
    base = run("steady_unwatched", "steady", None)
    claims = watchdog_claims(reps, walls["steady_unwatched"],
                             watchdog_tick_s(reps["steady"].watchdog))
    limits = watchdog_limits()
    for key, lim in limits.items():
        checks[key] = claims[key] >= lim.get("min", -math.inf) and \
            claims[key] <= lim.get("max", math.inf)
    checks["step_overhead_under_0.02"] = claims["step_overhead_frac"] < 0.02
    # the watchdog only reads: watching changes no ledger
    checks["watch_changes_no_ledger"] = ledgers(base) == \
        ledgers(reps["steady"])
    # the virtual clock: the same alerts as a CPU run at the smoke config
    cpu_mismatch = []
    for name, watch in WATCH_RUNS:
        cpu, *_ = watch_run(torch, torch.device("cpu"), name, watch,
                            model=arch)
        if alert_rows(cpu.alerts) != alert_rows(reps[name].alerts):
            cpu_mismatch.append(name)
    checks["alerts_equal_a_cpu_run"] = not cpu_mismatch
    # the recorded failover scrapes, written out and replayed offline
    scrapes = trace_dir / "failover_scrapes.txt"
    reps["failover"].watchdog.write_scrapes(str(scrapes))
    checks["scrapes_replay_offline"] = alert_rows(offline_alerts(
        scrapes.read_text(), reps["failover"].watchdog.interval_s)) \
        == alert_rows(reps["failover"].alerts)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_trace.py"), str(trace),
         "--scenario", "failover"], capture_output=True, text=True,
        timeout=120)
    checks["failover_trace_well_formed"] = proc.returncode == 0
    if proc.returncode:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
    emit({"phase": "watchdog", "run": "claim_k", "model": cfg.name,
          **claims, "limits": limits, "walls_s": walls,
          "watched_steady_over_unwatched":
              walls["steady"] / walls["steady_unwatched"],
          "cpu_mismatch": cpu_mismatch, "launches": total,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"watchdog: {checks} (CPU mismatch: "
                             f"{cpu_mismatch})")
    return total


def codec_input(torch, gen, device, r, c, dtype):
    """Rows scaled from 1e-2 to 1e2, a block of zeros (scale
    1e-30 * float32(1/127)) and, where there are two rows, a block of
    exact ties: absmax 127 * 2^-3 makes the scale 2^-3, so (k + 0.5) *
    2^-3 lands half way between two codes."""
    x = torch.randn((r, c), generator=gen, device=device)
    x *= torch.exp(torch.empty((r, 1), device=device).uniform_(
        math.log(0.01), math.log(100.0), generator=gen))
    x[0, :256] = 0.0
    if r > 1:
        x[1, :256] = 0.0
        x[1, :128] = (torch.arange(-64, 64, device=device) + 0.5) * 0.125
        x[1, 0] = 127 * 0.125
    return x.to(getattr(torch, dtype))


def params_tree(model):
    """A model's parameters as a flat pytree {name: tensor}."""
    return {name: p.detach() for name, p in model.named_parameters()}


def codec_payload(tree):
    """Every leaf as (first dim, the rest): a weight's rows are its input
    features, so a (3072, 24, 128) projection is (3072, 3072) and a norm
    (1, 3072). The row must take the 256-block codec; a leaf whose row
    does not is named. (Its last dim alone may not: the attention
    projections end in head_dim 128.)"""
    out = {}
    for name, leaf in tree.items():
        rows = leaf.reshape(leaf.shape[0], -1) if leaf.dim() > 1 \
            else leaf.reshape(1, -1)
        if rows.shape[1] % 256:
            raise AssertionError(f"leaf {name} {tuple(leaf.shape)}: a row "
                                 f"of {rows.shape[1]} is not a multiple "
                                 f"of 256")
        out[name] = rows
    return out


def codec_bytes(r, c, block, in_elem, out_elem):
    """Bytes one quantize (x read, codes and scales written) and one
    dequantize (codes and scales read, output written) must move."""
    scales = 4 * r * c // block
    return r * c * (in_elem + 1) + scales, r * c * (1 + out_elem) + scales


def phase_codec(torch, device, tree):
    """The codec kernels against their plain version on the card, then
    the full-width gradient pytree through ``ops.quantize`` and
    ``ops.dequantize``, every leaf held against the plain version too.
    Returns (launches, {kernel: max |kernel - plain|})."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_comm import (
        absmax_scale, codec_error_bound, dequantize_int8,
        dequantize_int8_plain, quantize_int8, quantize_int8_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    zero_scale = absmax_scale(torch.zeros((), device=device)).item()
    worst = {"quantize_int8": 0.0, "dequantize_int8": 0.0}

    def against_plain(x, q, s, x_hats, block):
        """Is the kernels' (q, s) and each dequantized x_hat (by dtype)
        equal to the plain version's on the same inputs? Folds the worst
        difference into ``worst``."""
        pq, ps = quantize_int8_plain(x, block=block)
        same = bool(torch.equal(q, pq) and torch.equal(s, ps))
        worst["quantize_int8"] = max(
            worst["quantize_int8"],
            (q.int() - pq.int()).abs().max().item(),
            (s - ps).abs().max().item())
        for odt, d in x_hats.items():
            pd = dequantize_int8_plain(q, s, block=block, dtype=odt)
            same = same and bool(torch.equal(d, pd))
            worst["dequantize_int8"] = max(
                worst["dequantize_int8"],
                (d.float() - pd.float()).abs().max().item())
        return same

    cases = 0
    for r in CODEC_ROWS:
        for c in CODEC_COLS:
            for block in CODEC_BLOCKS:
                for dt in ("float32", "bfloat16"):
                    x = codec_input(torch, gen, device, r, c, dt)
                    q, s = quantize_int8(x, block=block)
                    x_hats = {odt: dequantize_int8(q, s, block=block,
                                                   dtype=odt)
                              for odt in (torch.float32, torch.bfloat16)}
                    torch.cuda.synchronize()
                    same = against_plain(x, q, s, x_hats, block)
                    # (k + 0.5) for k in -63..63 rounds half to even
                    ties = r == 1 or (s[1, 0].item() == 0.125 and q[
                        1, 1:128].tolist() == [2 * ((k + 1) // 2) for k in
                                               range(-63, 64)])
                    zero = s[0, 0].item() == zero_scale and not bool(
                        q[0, :256].any())
                    cases += 1
                    if not (same and ties and zero):
                        raise AssertionError(
                            f"codec R={r} C={c} block={block} {dt}: kernel "
                            f"== plain {same}, ties {ties}, zero block "
                            f"{zero}")
    emit({"phase": "codec", "run": "kernel_vs_plain", "cases": cases,
          "rows": list(CODEC_ROWS), "cols": list(CODEC_COLS),
          "blocks": list(CODEC_BLOCKS), "bit_identical": True,
          "max_abs_err": dict(worst), "ok": True})

    payload = codec_payload(tree)

    def codec_pass():
        for x in payload.values():
            q, s = ops.quantize(x)
            ops.dequantize(q, s, dtype=x.dtype)

    codec_pass()              # warm-up: the allocator's first cudaMallocs
    quantize_int8.launches = 0
    dequantize_int8.launches = 0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    codec_pass()
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    e1.synchronize()
    pass_ms = e0.elapsed_time(e1)
    launches = {"quantize_int8": quantize_int8.launches,
                "dequantize_int8": dequantize_int8.launches}
    if launches != {"quantize_int8": len(payload),
                    "dequantize_int8": len(payload)}:
        raise AssertionError(f"codec pass: launches {launches} for "
                             f"{len(payload)} leaves")
    # each leaf at its own shape: the kernels against the plain version
    # bit for bit, and the round trip within the codec's stated bound
    moved = 0
    worst_err, worst_ratio, elems = 0.0, 0.0, 0
    for name, x in payload.items():
        with torch.no_grad():
            q, s = ops.quantize(x)
            x_hat = ops.dequantize(q, s, dtype=x.dtype)
            torch.cuda.synchronize()
            same = against_plain(x, q, s, {x.dtype: x_hat}, 256)
            err = (x_hat.float() - x.float()).abs()
            bound = codec_error_bound(x, s, x_hat)
            ratio = (err / bound).max().item()
            finite = bool(torch.isfinite(x_hat).all())
        worst_err = max(worst_err, err.max().item())
        worst_ratio = max(worst_ratio, ratio)
        r, c = x.shape
        qb, db = codec_bytes(r, c, 256, x.element_size(), x.element_size())
        moved += qb + db
        elems += x.numel()
        if ratio > 1.0 or not finite or not same:
            raise AssertionError(f"codec {name} {tuple(x.shape)}: kernel "
                                 f"== plain {same}, error "
                                 f"{err.max().item()} is {ratio} of its "
                                 f"bound, finite {finite}")
        del q, s, x_hat, err, bound
    emit({"phase": "codec", "run": "llama3.2-3b_gradients", "leaves":
          len(payload), "elements": elems, "dtype": "bfloat16",
          "block": 256, "launches": launches, "pass_ms": pass_ms,
          "host_enqueue_ms": host_ms,
          "bytes_moved": moved, "gb_per_s": moved / pass_ms / 1e6,
          "max_abs_err": worst_err, "max_err_over_bound": worst_ratio,
          "bit_identical_to_plain": True,
          "kernel_vs_plain_max_abs_err": dict(worst), "ok": True})
    return launches, worst


def world1(device, backend: str):
    """A world of one rank: ``backend`` (NCCL on the card, gloo for a CPU
    rehearsal) over an in-memory HashStore (no address, no network), then
    the (pod, data, model) mesh of size 1 x 1 x 1 and its groups."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import MeshAxes
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = init_device_mesh(device.type, (1, 1, 1),
                            mesh_dim_names=BYTES_AXES)
    return MeshAxes(mesh)


def phase_bytes(torch, device, tree, backend="nccl"):
    """The bytes plane at world size 1: ``nk_grad_sync`` of ``tree`` and
    one leaf's ``nk_psum``/``nk_all_gather``/``nk_reduce_scatter`` under
    each stock policy. Returns the rows it emitted."""
    import torch.distributed as dist

    from repro_torch.core import (
        compression, make_engine, nk_all_gather, nk_grad_sync, nk_psum,
        nk_reduce_scatter, use_engine)
    from repro_torch.core.nqe import payload_bytes
    axes = world1(device, backend)
    rows = []
    try:
        leaf_name = max(tree, key=lambda k: (tree[k].dim(), tree[k].numel()))
        leaf = tree[leaf_name]
        grad_bytes = sum(payload_bytes(g) for g in tree.values())
        for tenant, policy in enumerate(BYTES_POLICIES):
            eng = make_engine(axes, policy)
            times = []
            out = None
            with use_engine(eng):
                # one untimed call first: the groups' communicators and
                # the allocator's blocks are made there
                for _ in range(1 + BYTES_REPS):
                    out = None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = nk_grad_sync(tree, ("pod", "data"),
                                       tenant_id=tenant)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                psum = nk_psum(leaf, "model", tenant_id=tenant)
                gathered = nk_all_gather(leaf, "data", tenant_id=tenant)
                scattered = nk_reduce_scatter(leaf, "data",
                                              tenant_id=tenant)
            torch.cuda.synchronize()
            equal = True
            for name, g in tree.items():
                if policy == "compressed":
                    scale = compression.absmax_scale(g.float().abs().amax())
                    want = compression.dequantize_int8(
                        compression.quantize_int8(g.float(), scale).to(
                            torch.int32), scale, g.dtype)
                else:
                    want = g
                equal = equal and bool(torch.equal(out[name], want))
            equal = equal and all(bool(torch.equal(t, leaf)) for t in
                                  (psum, gathered, scattered))
            del out, psum, gathered, scattered
            verbs = eng.ledger_table()
            billed = eng.billed_ground_truth(tenant)
            want_bytes = (1 + BYTES_REPS) * grad_bytes \
                + 3 * payload_bytes(leaf)
            ledger_ok = eng.total_bytes(tenant) == want_bytes == billed > 0
            # a move to a second engine: carried + both engines' live
            # bytes equal the bytes billed before the move
            dst = make_engine(axes, policy)
            state = eng.export_tenant(tenant)
            dst.import_tenant(tenant, state)
            conserved = (state.carried["bytes"]
                         + eng.live_counter(tenant, "bytes")
                         + dst.live_counter(tenant, "bytes")) == billed \
                and eng.billed_ground_truth(tenant) == billed
            row = {"phase": "bytes", "policy": policy, "world": 1,
                   "backend": backend, "leaves": len(tree),
                   "grad_bytes": grad_bytes, "ledger_rows": len(verbs),
                   "routed_to": sorted({nsm for _, nsm in eng.route_log}),
                   "ms_per_grad_sync": statistics.median(times[1:]),
                   "ms_first": times[0], "ms_runs": times[1:],
                   "ms_per_leaf": statistics.median(times[1:]) / len(tree),
                   "equal_to_plain": equal, "ledger_bytes_ok": ledger_ok,
                   "billed_conserved": conserved,
                   "ok": equal and ledger_ok and conserved}
            emit(row)
            rows.append(row)
            if not row["ok"]:
                raise AssertionError(f"bytes {policy}: {row}")
    finally:
        dist.destroy_process_group()
    return rows


def train_parity(torch, device, cfg, model, batch, keep, nudges=()):
    """The kernel path (``FlashAttentionFn``, ``SsdScanFn``) against the
    plain path (``attention_impl="naive"``: ``flash_attention_plain`` and
    ``ssd_chunk_scan_plain`` under autograd) on the same weights and
    micro-batch: the relative loss gap, the relative gap of the global
    grad norm, and for each leaf that ``keep(name)`` selects max |dgrad|
    / max |grad|. With ``nudges`` (functions of a tensor, as
    ``uniform_nudge`` makes), also ``floor_gaps``, one dict for each: the
    same leaves' gaps of the plain path against itself with every flash
    and scan output nudged, the model's own noise floor."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import attention, ssm
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_loop import _grads

    def run(impl):
        grads, metrics = _grads(model, batch, cfg,
                                RunConfig(attention_impl=impl))
        return (metrics["loss"].item(), global_norm(grads.values()).item(),
                {n: g for n, g in grads.items() if keep(n)})

    (lk, nk, gk), (lp, np_, gp) = run("chunked"), run("naive")
    out = {"loss_kernel": lk, "loss_plain": lp,
           "loss_gap": abs(lk - lp) / abs(lp),
           "grad_norm_kernel": nk, "grad_norm_plain": np_,
           "grad_norm_gap": abs(nk - np_) / abs(np_),
           "grad_gaps": {n: rel_err(gk[n], gp[n]) for n in gk}}
    del gk
    flash_p, scan_p = attention.flash_attention_plain, \
        ssm.ssd_chunk_scan_plain
    for nudge in nudges:
        def flash_nudged(*args, **kw):
            return nudge(flash_p(*args, **kw))

        def scan_nudged(*args, **kw):
            y, *rest = scan_p(*args, **kw)
            return (nudge(y), *rest)

        attention.flash_attention_plain = flash_nudged
        ssm.ssd_chunk_scan_plain = scan_nudged
        try:
            _, _, gn = run("naive")
        finally:
            attention.flash_attention_plain = flash_p
            ssm.ssd_chunk_scan_plain = scan_p
        out.setdefault("floor_gaps", []).append(
            {n: rel_err(gn[n], gp[n]) for n in gn})
    return out


def uniform_nudge(n: float):
    """A noise floor's nudge for ``train_parity``: every element scaled by
    1 + n (``FLOOR_NUDGE``, 2^-8, is about one bf16 ulp)."""
    return lambda t: t * (1 + n)


def state_bytes(state):
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    params = list(state["params"].parameters())
    return {"params": nbytes(params),
            "mu": nbytes(state["opt"]["mu"].values()),
            "nu": nbytes(t for d in state["opt"]["nu"].values()
                         for t in d.values()),
            # _grads' f32 accumulators, one per parameter, live during a
            # step's backward passes
            "grad_accumulators": sum(p.numel() * 4 for p in params)}


def phase_train(torch, device, cfg, smi: str, backend: str = "nccl",
                row_out=None):
    """Training on the port: full-width llama3.2-3b through ``Runner`` ->
    ``make_train_step`` -> ``forward_train`` (the flash kernel forward on
    every layer, twice a micro-batch under remat) -> ``loss_fn`` ->
    ``adamw_update``; the kernel path against the plain path at bf16 (full
    depth) and f32 (2 layers); one ``pod_step`` through the compressed
    stack on an NCCL world of one (``backend``: gloo for a CPU
    rehearsal); bit-exact recovery at 2 layers. Returns the flash launches
    of the Runner's timed steps; ``row_out``, a dict, receives the
    Runner's row."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core import make_engine
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.models.params import init_params
    import repro_torch.train.train_loop as train_loop
    from repro_torch.train import Runner, loss_fn, make_train_step
    # the cluster and watchdog phases' engines hold their model in
    # reference cycles, which only the cycle collector frees
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before the "
                             f"train phase")
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    feed = for_model(cfg, shape, seed=SEED, device=device)
    micro = {k: v[:TRAIN_BATCH // TRAIN_ACCUM]
             for k, v in feed.batch_at(0).items()}
    rcfg = RunConfig(grad_accum=TRAIN_ACCUM, learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    model = init_params(cfg, device=device, seed=SEED)

    # 1. the kernel path against the plain path: bf16, full depth
    t0 = time.perf_counter()
    par = train_parity(torch, device, cfg, model, micro,
                       lambda n: n.endswith(("attn.wq", "attn.wk",
                                             "attn.wv")))
    worst = max(par["grad_gaps"].values())
    emit({"phase": "train", "check": "parity_bf16", "model": cfg.name,
          "layers": cfg.num_layers, "tokens": TRAIN_SEQ,
          **{k: v for k, v in par.items() if k != "grad_gaps"},
          "wq_wk_wv_grads": len(par["grad_gaps"]),
          "wq_wk_wv_worst_gap": worst, "grad_gaps": par["grad_gaps"],
          "tol": TRAIN_TOL, "seconds": time.perf_counter() - t0})
    if len(par["grad_gaps"]) != 3 * cfg.num_layers or max(
            par["loss_gap"], par["grad_norm_gap"], worst) > TRAIN_TOL:
        raise AssertionError(f"train parity at bf16: {par}")

    # 2. the main path: Runner, one warm-up step, then the timed steps
    t_main = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        runner = Runner(cfg, rcfg, None, feed, d, device=device)
        runner.init_state(model=model)
        sizes = state_bytes(runner.state)
        before = [p.detach().to("cpu", copy=True)
                  for p in model.parameters()]
        runner.run(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        runner.run(TRAIN_TIMED)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        want = cfg.num_layers * TRAIN_ACCUM * (1 if rcfg.remat == "none"
                                               else 2) * TRAIN_TIMED
        timed = runner.metrics_log[-TRAIN_TIMED:]
        step_s = statistics.median(m["dt"] for m in timed)
        moved = sum(not torch.equal(p.detach().cpu(), b)
                    for p, b in zip(model.parameters(), before))
        del before
        finite = all(math.isfinite(m["loss"]) and math.isfinite(
            m["grad_norm"]) for m in runner.metrics_log)
        t_prof = time.perf_counter()
        # the profiled window is one micro-batch's forward and backward, a
        # quarter of a step's (the step adds AdamW), of the model's first
        # TRAIN_PROFILE_LAYERS layers: every layer does the same work, and
        # a whole step is ~1.7M trace events, which the profiler takes
        # minutes to parse
        pcfg = dataclasses.replace(cfg, num_layers=min(
            cfg.num_layers, TRAIN_PROFILE_LAYERS))
        pmodel = init_params(pcfg, device=device, seed=SEED)
        params = [p.requires_grad_(True) for p in pmodel.parameters()]

        def micro_batch():
            loss, _ = loss_fn(pmodel, micro, pcfg, rcfg)
            torch.autograd.grad(loss, params)

        prof = _profile(torch, micro_batch, top=10, ranges=(
            "autograd::engine::evaluate_function: FlashAttentionFnBackward",
        ))
        prof["seconds"] = time.perf_counter() - t_prof
        prof["layers"] = pcfg.num_layers
        del pmodel, params
        row = {"phase": "train", "check": "runner", "model": cfg.name,
               "layers": cfg.num_layers, "seq": TRAIN_SEQ,
               "global_batch": TRAIN_BATCH, "grad_accum": TRAIN_ACCUM,
               "remat": rcfg.remat, "moment_dtype": rcfg.moment_dtype,
               "learning_rate": rcfg.learning_rate,
               "warmup_steps": rcfg.warmup_steps,
               "tokens_per_step": tokens,
               "step_ms": [m["dt"] * 1e3 for m in timed],
               "step_ms_median": step_s * 1e3,
               "tokens_per_s": tokens / step_s,
               "mfu": 6 * cfg.num_params() * tokens / step_s
               / PEAK_FLOPS,
               "params": cfg.num_params(),
               "losses": [m["loss"] for m in runner.metrics_log],
               "grad_norms": [m["grad_norm"] for m in runner.metrics_log],
               "flash_launches": launches, "flash_launches_want": want,
               "params_moved": moved,
               "params_total": len(list(model.parameters())),
               "state_bytes": sizes, "max_memory_allocated": peak,
               "profile_micro_batch": prof,
               "seconds": time.perf_counter() - t_main, "gpu": smi}
        emit(row)
        if row_out is not None:
            row_out.update(row)
        if launches != want or moved != row["params_total"] or not finite:
            raise AssertionError(f"train runner: {row}")

        # 3. one pod_step through the compressed stack, world of one
        t0 = time.perf_counter()
        axes = world1(device, backend)
        try:
            eng = make_engine(axes, "compressed")
            step = make_train_step(cfg, dataclasses.replace(
                rcfg, explicit_pod_sync=True, nsm_policy="compressed"),
                axes, eng)
            sync_ms = []
            real = train_loop.nk_grad_sync

            def timed_sync(grads, ax):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(grads, ax)
                torch.cuda.synchronize()
                sync_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            train_loop.nk_grad_sync = timed_sync
            try:
                _, m = step(runner.state, feed.batch_at(runner.step))
            finally:
                train_loop.nk_grad_sync = real
            pod = [(ops, nb) for _, verb, ax, ops, nb in eng.ledger_table()
                   if verb == "psum" and ax == ("pod",)]
            grad_bytes = sum(p.numel() * 2 for p in model.parameters())
            routed = sorted({n for _, n in eng.route_log})
            row = {"phase": "train", "check": "pod_sync", "policy":
                   "compressed", "world": 1, "ledger_pod_psums": pod,
                   "grad_leaves": len(list(model.parameters())),
                   "grad_bytes": grad_bytes, "routed_to": routed,
                   "sync_ms": sync_ms[0], "loss": m["loss"].item(),
                   "seconds": time.perf_counter() - t0, "gpu": smi}
            emit(row)
            if pod != [(row["grad_leaves"], grad_bytes)] \
                    or routed != ["compressed"] \
                    or not math.isfinite(row["loss"]):
                raise AssertionError(f"train pod sync: {row}")
        finally:
            dist.destroy_process_group()
        del runner, model, step
    torch.cuda.empty_cache()

    # 4. the kernel path against the plain path at f32, 2 layers
    cfg32 = dataclasses.replace(cfg, num_layers=TRAIN_F32_LAYERS,
                                dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    model = init_params(cfg32, device=device, seed=SEED + 20)
    par = train_parity(torch, device, cfg32, model, micro, lambda n: True)
    worst = max(par["grad_gaps"].values())
    emit({"phase": "train", "check": "parity_f32", "layers":
          TRAIN_F32_LAYERS, **{k: v for k, v in par.items()
                               if k != "grad_gaps"},
          "grad_leaves": len(par["grad_gaps"]), "worst_grad_gap": worst,
          "tol": TRAIN_F32_TOL, "seconds": time.perf_counter() - t0})
    if par["loss_gap"] > TRAIN_F32_TOL["loss"] \
            or worst > TRAIN_F32_TOL["grad"]:
        raise AssertionError(f"train parity at f32: {par}")
    del model
    torch.cuda.empty_cache()

    # 5. fault tolerance at full width, 2 layers: a failure at step 4,
    # the checkpoint of step 3 restored in place, bit-identical results
    fault_tolerance(torch, device, dataclasses.replace(
        cfg, num_layers=TRAIN_FT_LAYERS), rcfg, feed, SEED + 21)
    return launches


def fault_tolerance(torch, device, cfg2, rcfg, feed, seed):
    """At ``cfg2`` (2 layers): ``TRAIN_FT_STEPS`` steps plain against the
    same steps with a checkpoint every ``TRAIN_FT_CKPT_EVERY`` and a
    failure at ``TRAIN_FT_FAIL_AT``, from the weights of ``seed``: the
    final states must be bit-identical. Emits and returns the row."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.models.params import init_params
    from repro_torch.train import FailurePlan, Runner
    t0 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        if free < TRAIN_MIN_DISK:
            raise RuntimeError(f"{free} bytes free under {d}; the fault "
                               f"tolerance check needs {TRAIN_MIN_DISK:.0f}")
        for every, fail_at in ((10 ** 9, []),
                               (TRAIN_FT_CKPT_EVERY, [TRAIN_FT_FAIL_AT])):
            r = Runner(cfg2, dataclasses.replace(
                rcfg, checkpoint_every=every, keep_checkpoints=1), None,
                feed, os.path.join(d, f"every_{every}"),
                failure_plan=FailurePlan(fail_at=fail_at), device=device)
            r.init_state(model=init_params(cfg2, device=device, seed=seed))
            t1 = time.perf_counter()
            out = r.run(TRAIN_FT_STEPS)
            runs.append((out, time.perf_counter() - t1, r.ckpt.steps(),
                         [t.detach().to("cpu", copy=True)
                          for t in _state_tensors(r)]))
            del r
            torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    row = {"phase": "train", "check": "fault_tolerance", "model": cfg2.name,
           "layers": cfg2.num_layers, "steps": TRAIN_FT_STEPS,
           "checkpoint_every": TRAIN_FT_CKPT_EVERY,
           "fail_at": TRAIN_FT_FAIL_AT,
           "runs": [{"final_step": o["final_step"],
                     "recoveries": o["recoveries"], "seconds": s,
                     "checkpoints_kept": kept}
                    for o, s, kept, _ in runs],
           "tensors_compared": len(runs[0][3]), "bit_identical": same,
           "free_disk_bytes": free, "seconds": time.perf_counter() - t0}
    emit(row)
    if not same or [o["final_step"] for o, *_ in runs] != \
            [TRAIN_FT_STEPS] * 2 or [o["recoveries"] for o, *_ in runs] \
            != [0, 1]:
        raise AssertionError(f"train fault tolerance: {row}")
    return row


def ledger_ops(core) -> dict:
    """Ops so far in the CoreEngine's ledger, by verb."""
    out: dict = {}
    for _t, verb, _axes, ops, _b in core.ledger_table():
        out[verb] = out.get(verb, 0) + ops
    return out


def timed_steps(runner, n: int):
    """``n`` Runner steps, one at a time: each one's ms."""
    out = []
    for _ in range(n):
        runner.run(1)
        out.append(runner.metrics_log[-1]["dt"] * 1e3)
    return out


def phase_sharded_train(torch, device, cfg, smi: str, row_out=None):
    """Training on the model axis at a world of one (``world_of_one``):
    ``cfg`` at full width and ``SHARDED_TRAIN_LAYERS`` layers under the
    ``"2d"`` rules, the train phase's batch. The sharded micro-batch
    against the unsharded one from the same seeded weights, two ``Runner``
    steps on each (the sharded ones counted: flash launches, the ledger's
    collectives, every leaf moved), a profiled micro-batch on each path,
    a checkpoint carried through ``Runner.remesh`` onto a fresh world-1 mesh
    and one more step; then the same with Megatron-SP activations (the
    sharded micro-batch against the unsharded one, a Runner step: its
    flash launches and the ledger's collectives against
    ``train_collectives(..., sp=True)``); then ``train_rank_cases``.
    Returns (the sharded steps' flash launches, the rank cases' checks by
    tp); ``row_out``, a dict, receives the phase's row (with the ledger's
    collective bytes of the first sharded step,
    ``roofline.ledger_collective_bytes``)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.roofline import ledger_collective_bytes
    from repro_torch.models.params import init_params
    from repro_torch.train import Runner, loss_fn
    from repro_torch.train.optimizer import global_norm, grad_norm
    from repro_torch.train.train_loop import _grads, _sync_grads, train_ctx
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before the "
                             f"sharded train phase")
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                  SHARDED_TRAIN_LAYERS))
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    feed = for_model(cfg, shape, seed=SEED, device=device)
    micro = {k: v[:TRAIN_BATCH // TRAIN_ACCUM]
             for k, v in feed.batch_at(0).items()}
    rcfg = RunConfig(grad_accum=TRAIN_ACCUM, learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP)

    def keep(n):
        return n.endswith(("attn.wq", "attn.wk", "attn.wv"))

    # 1. the unsharded path: one micro-batch, then two Runner steps
    model = init_params(cfg, device=device, seed=SEED)
    grads, metrics = _grads(model, micro, cfg, RunConfig())
    want = {"loss": metrics["loss"].item(),
            "grad_norm": global_norm(grads.values()).item(),
            "grads": {n: g for n, g in grads.items() if keep(n)}}
    del grads
    with tempfile.TemporaryDirectory() as d:
        runner = Runner(cfg, rcfg, None, feed, d, device=device)
        runner.init_state(model=model)
        plain_ms = timed_steps(runner, SHARDED_TRAIN_STEPS)
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the sharded path on a world of one
    row = {"phase": "sharded_train", "model": cfg.name,
           "layers": cfg.num_layers, "rules": "2d", "world": 1,
           "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "grad_accum": TRAIN_ACCUM}
    with world_of_one(torch, device) as (serve_shd, core), \
            tempfile.TemporaryDirectory() as d:
        shd = train_ctx(serve_shd.axes, rcfg)
        runner = Runner(cfg, rcfg, shd, feed, d, device=device)
        runner.init_state(seed=SEED)
        model = runner.state["params"]
        grads, metrics = _grads(model, micro, cfg, RunConfig(),
                                lambda g: _sync_grads(model, g))
        got = {"loss": metrics["loss"].item(),
               "grad_norm": grad_norm(model, grads).item()}
        gaps = {n: rel_err(grads[n], want["grads"][n])
                for n in want["grads"]}
        del grads
        row.update({
            "loss_sharded": got["loss"], "loss_unsharded": want["loss"],
            "loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_sharded": got["grad_norm"],
            "grad_norm_unsharded": want["grad_norm"],
            "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"])
            / abs(want["grad_norm"]),
            "wq_wk_wv_grads": len(gaps),
            "wq_wk_wv_worst_gap": max(gaps.values()), "tol": TRAIN_TOL})
        if len(gaps) != 3 * cfg.num_layers or max(
                row["loss_gap"], row["grad_norm_gap"],
                row["wq_wk_wv_worst_gap"]) > TRAIN_TOL:
            raise AssertionError(f"sharded train parity: {row}")
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        ops0, table0 = ledger_ops(core), core.ledger_table()
        runner.run(1)
        ops1 = ledger_ops(core)
        coll_bytes, coll_kinds = ledger_collective_bytes(core, since=table0)
        runner.run(SHARDED_TRAIN_STEPS - 1)
        launches = fa.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        launches_want = cfg.num_layers * TRAIN_ACCUM * 2 \
            * SHARDED_TRAIN_STEPS
        moved = sum(not torch.equal(p.detach(), b)
                    for p, b in zip(model.parameters(), before))
        del before
        steps_ms = [m["dt"] * 1e3 for m in runner.metrics_log]
        finite = all(math.isfinite(m["loss"]) and math.isfinite(
            m["grad_norm"]) for m in runner.metrics_log)
        row.update({
            "step_ms_sharded": steps_ms, "step_ms_unsharded": plain_ms,
            "step_ratio": steps_ms[-1] / plain_ms[-1],
            "ledger_ops_a_step": {v: ops1.get(v, 0) - ops0.get(v, 0)
                                  for v in ops1},
            "ledger_ops_want": train_collectives(cfg, TRAIN_ACCUM),
            "ledger_bytes_a_step": coll_bytes,
            "ledger_bytes_a_step_by_kind": coll_kinds,
            "flash_launches": launches,
            "flash_launches_want": launches_want,
            "params_moved": moved,
            "params_total": len(list(model.parameters())),
            "max_memory_allocated": peak,
            "losses": [m["loss"] for m in runner.metrics_log]})
        if launches != launches_want or moved != row["params_total"] \
                or not finite \
                or row["ledger_ops_a_step"] != row["ledger_ops_want"]:
            raise AssertionError(f"sharded train runner: {row}")

        # a profiled micro-batch, cut to SHARDED_PROFILE_LAYERS, on each
        # path: where the sharded step's extra time goes
        pcfg = dataclasses.replace(cfg, num_layers=SHARDED_PROFILE_LAYERS)
        for key, on in (("profile_micro_batch", shd),
                        ("profile_micro_batch_unsharded", None)):
            pmodel = init_params(pcfg, device=device, seed=SEED, shd=on)
            params = [p.requires_grad_(True) for p in pmodel.parameters()]

            def micro_batch():
                loss, _ = loss_fn(pmodel, micro, pcfg, rcfg)
                torch.autograd.grad(loss, params)

            t0 = time.perf_counter()
            prof = _profile(torch, micro_batch, top=6)
            prof["seconds"] = time.perf_counter() - t0
            prof["layers"] = pcfg.num_layers
            row[key] = prof
            del pmodel, params

        # a checkpoint carried onto a fresh world-1 mesh, then a step
        t0 = time.perf_counter()
        runner.ckpt.save(runner.step, runner.state, blocking=True,
                         shardings=runner.state_sh)
        saved = [t.clone() for t in _state_tensors(runner)]
        t_save = time.perf_counter() - t0
        runner.remesh(make_host_mesh(1, 1, device=device.type))
        same = len(saved) == len(_state_tensors(runner)) and all(
            torch.equal(a, b) for a, b in zip(saved, _state_tensors(runner)))
        del saved
        out = runner.run(1)
        row.update({"remesh_restored_equal": same,
                    "remesh_final_step": out["final_step"],
                    "remesh_loss": runner.metrics_log[-1]["loss"],
                    "save_seconds": t_save,
                    "remesh_seconds": time.perf_counter() - t0 - t_save})
        if not same or out["final_step"] != SHARDED_TRAIN_STEPS + 1 \
                or not math.isfinite(row["remesh_loss"]):
            raise AssertionError(f"sharded train remesh: {row}")
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()

    # 3. Megatron-SP: the residual stream split along the sequence
    sp_rcfg = dataclasses.replace(rcfg, seq_parallel_activations=True)
    with world_of_one(torch, device) as (serve_shd, core), \
            tempfile.TemporaryDirectory() as d:
        shd = train_ctx(serve_shd.axes, sp_rcfg)
        runner = Runner(cfg, sp_rcfg, shd, feed, d, device=device)
        runner.init_state(seed=SEED)
        model = runner.state["params"]
        grads, metrics = _grads(
            model, micro, cfg, dataclasses.replace(sp_rcfg, grad_accum=1),
            lambda g: _sync_grads(model, g, seq=TRAIN_SEQ))
        sp = {"rows_axis": shd.sp_of(TRAIN_SEQ),
              "loss": metrics["loss"].item(),
              "grad_norm": grad_norm(model, grads).item()}
        gaps = {n: rel_err(grads[n], want["grads"][n])
                for n in want["grads"]}
        del grads, want["grads"]
        sp.update({
            "loss_gap": abs(sp["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_gap": abs(sp["grad_norm"] - want["grad_norm"])
            / abs(want["grad_norm"]),
            "wq_wk_wv_worst_gap": max(gaps.values())})
        fa.flash_attention.launches = 0
        ops0 = ledger_ops(core)
        runner.run(1)
        ops1 = ledger_ops(core)
        sp_launches = fa.flash_attention.launches
        sp.update({
            "step_ms": runner.metrics_log[-1]["dt"] * 1e3,
            "loss_step": runner.metrics_log[-1]["loss"],
            "flash_launches": sp_launches,
            "ledger_ops_a_step": {v: ops1.get(v, 0) - ops0.get(v, 0)
                                  for v in ops1},
            "ledger_ops_want": train_collectives(cfg, TRAIN_ACCUM,
                                                 sp=True)})
        row["seq_parallel"] = sp
        if not sp["rows_axis"] or len(gaps) != 3 * cfg.num_layers \
                or max(sp["loss_gap"], sp["grad_norm_gap"],
                       sp["wq_wk_wv_worst_gap"]) > TRAIN_TOL \
                or sp_launches != cfg.num_layers * TRAIN_ACCUM * 2 \
                or not math.isfinite(sp["loss_step"]) \
                or sp["ledger_ops_a_step"] != sp["ledger_ops_want"]:
            raise AssertionError(f"sharded train with Megatron-SP: {sp}")
        launches += sp_launches
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()
    checks = train_rank_cases(torch, device, smi, row)
    row.update({"seconds": time.perf_counter() - t_phase, "gpu": smi})
    emit(row)
    if row_out is not None:
        row_out.update(row)
    return launches, checks


def flash_train_rank(torch, device, gen, timer, smi: str, case: str,
                     tp: int, n: int, kv: int, d: int, rank: int = 0,
                     dv=None):
    """``FlashAttentionFn`` (the kernel forward, the plain VJP) at one TP
    train rank's shape: B 1, ``TRAIN_RANK_S`` tokens, ``n`` query heads
    over ``kv`` kv heads of dim ``d``, bf16, causal; ``dv``: v's head dim,
    zero-padded to ``d`` as ``models/attention.py::_mla_prefill`` pads it
    (the output cut back, so the cotangent of its padded columns is 0;
    the softmax scale 1/sqrt(d)). Held against the plain forward and its
    autograd VJP (o, dq, dk, dv within ``TRAIN_TOL`` of max |.|), its
    forward timed
    beside its bound (the function's own columns) and the plain forward,
    ``scaled_dot_product_attention``'s forward and backward on the same
    inputs timed beside it. Returns the check: launches, the largest
    errors and the row."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models.attention import FlashAttentionFn
    bf, s = torch.bfloat16, TRAIN_RANK_S

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    q, k, v = randn(1, s, n, d), randn(1, s, kv, d), randn(1, s, kv, d)
    do = randn(1, s, n, d)
    if dv is not None:
        v = F.pad(v[..., :dv], (0, d - dv))
        do = F.pad(do[..., :dv], (0, d - dv))
    scale = d ** -0.5
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    o = FlashAttentionFn.apply(*ins, True, 0, 512, 512, scale)
    launched = flash_attention.launches - before
    grads = torch.autograd.grad(o, ins, do)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_o = flash_attention_plain(*ref_in, scale=scale)
    ref_g = torch.autograd.grad(ref_o, ref_in, do)
    errs = {"o": rel_err(o, ref_o)}
    errs.update({f"d{x}": rel_err(a, b)
                 for x, a, b in zip("qkv", grads, ref_g)})
    abs_o = (o.float() - ref_o.float()).abs().max().item()
    ok = max(errs.values()) <= TRAIN_TOL and launched == 1
    del ins, o, grads, ref_in, ref_o, ref_g
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True, scale=scale)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    backend = sdpa_backend(torch, qt, kt, vt, is_causal=True,
                           enable_gqa=True, scale=scale)
    with sdpa_kernel([backend]):
        sdpa_ms = timer.ms(sdpa_fwd_bwd, reps=5)
    nbytes, flops = flash_work(1, s, s, n, kv, d, 2, True, 0, dv=dv)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row = {"case": case, "tp": tp, "rank": rank, "S": s, "hq": n,
           "kv": kv, "d": d, "dv": dv or d, "dtype": "bfloat16",
           "max_rel_err": errs, "max_abs_err_o": abs_o, "tol": TRAIN_TOL,
           "ok": ok,
           "ms": timer.ms(lambda: flash_attention(q, k, v, scale=scale)),
           "plain_ms": timer.ms(lambda: flash_attention_plain(
               q, k, v, scale=scale), reps=5),
           "library_fwd_bwd_ms": sdpa_ms,
           "library": "scaled_dot_product_attention",
           "library_backend": backend.name, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "flops": flops, "gpu": smi}
    del q, k, v, do, qt, kt, vt, dot
    if not ok:
        raise AssertionError(f"flash under autograd at {case}'s rank heads, "
                             f"tp {tp}: {row}")
    return {"launches": launched, "max_abs_err": abs_o,
            "max_rel_err": max(errs.values()), "row": row}


def train_rank_cases(torch, device, smi: str, row: dict):
    """Flash under autograd (``flash_train_rank``) at each TP rank's
    shapes of llama3.2-3b's ``TRAIN_RANK_S``-token training sequence (tp
    2/4/8/16: 12/4, 6/2, 3/1 heads, and 2 of 32 padded heads over 2
    gathered kv heads). Puts the rows into ``row["rank_flash"]``; returns
    the checks by tp."""
    from repro_torch.distribution.sharding import padded_heads
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    timer = Timer(torch, device)
    hq, kv = LLAMA_HEADS
    checks = {}
    for tp in CP_TP:
        hp = padded_heads(hq, {"model": tp})
        n, r = hp // tp, 1 if tp == 16 else 0
        checks[tp] = flash_train_rank(
            torch, device, gen, timer, smi, "llama3.2-3b", tp, n,
            _local_kv_heads(hq, kv, hp, r * n, n), 128, r)
    row["rank_flash"] = [c["row"] for c in checks.values()]
    torch.cuda.empty_cache()
    return checks


def _local_kv_heads(hq: int, kv: int, hp: int, first: int, n: int) -> int:
    """The kv heads ``models/attention.py::_local_kv`` gives a rank's
    ``n`` query heads from ``first`` (of ``hp`` padded over ``hq`` real
    ones reading ``kv``)."""
    import torch

    from repro_torch.models.attention import _local_kv
    z = torch.zeros((1, 1, kv, 1))
    return _local_kv(z, z, hq, hp, first, n)[0].shape[2]


def kernel_fed(name: str) -> bool:
    """The parameters whose gradients come through a kernel's autograd
    wrapper first: the attention and cross-attention projections (flash)
    and the SSD scan's inputs (x, B, C, dt and A)."""
    return name.endswith(("attn.wq", "attn.wk", "attn.wv", "cross.wq",
                          "cross.wk", "cross.wv", "ssm.w_x", "ssm.w_B",
                          "ssm.w_C", "ssm.w_dt", "ssm.A_log",
                          "ssm.dt_bias"))


def per_forward(cfg):
    """Kernel launches of one training forward: flash once per attention
    (every layer of the dense, vlm, hybrid and enc kinds, a dec layer's
    self and cross attention), the SSD scan once per ssm or hybrid
    layer."""
    attn = cfg.num_layers if cfg.family != "ssm" else 0
    return {"flash_attention": attn + cfg.encoder_layers
            + (cfg.num_layers if cfg.encoder_layers else 0),
            "ssd_chunk_scan": cfg.num_layers if cfg.ssm is not None else 0}


def family_trainer(torch, device, cfg, smi: str, seq: int, batch: int):
    """One trainer of the ssm, hybrid or encdec family at full width and
    depth, through ``Runner`` -> ``make_train_step`` -> ``forward_train``
    (flash through ``FlashAttentionFn``, the SSD scan through
    ``SsdScanFn``) -> ``adamw_update``: the kernel path against the plain
    path on one micro-batch at bf16 (full depth, the kernel-fed leaves'
    grads) and f32 (2 layers, loss and every grad); ``FAMILY_STEPS``
    steps with their launches, every parameter moved, step ms, tokens/s,
    MFU, the state's bytes and peak memory. Returns the launches of the
    Runner's steps."""
    import dataclasses
    import tempfile

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.models.params import init_params
    from repro_torch.train import Runner
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before the "
                             f"{cfg.name} trainer")
    t0 = time.perf_counter()
    shape = ShapeConfig("train", seq, batch, "train")
    feed = for_model(cfg, shape, seed=SEED, device=device)
    micro = {k: v[:batch // TRAIN_ACCUM] for k, v in feed.batch_at(0).items()}
    rcfg = RunConfig(grad_accum=TRAIN_ACCUM, learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP)
    model = init_params(cfg, device=device, seed=SEED)

    # 1. the kernel path against the plain path: bf16, full depth. The
    # loss and the grad norm within TRAIN_TOL, asserted; each kernel-fed
    # leaf's grad gap reported beside the model's own bf16 noise floor
    # (ROADMAP P19: random deep models with SSM layers turn a one-ulp
    # nudge into gaps of 0.1-0.7; tools/train_parity_floor.py samples more
    # seeds and floors); the leaves are asserted at bf16 on 2 layers
    # below, and at f32, and every launch at these shapes is held against
    # its plain version in the kernels phase
    par = train_parity(torch, device, cfg, model, micro, kernel_fed,
                       nudges=(uniform_nudge(FLOOR_NUDGE),))
    gaps, (floor,) = par.pop("grad_gaps"), par.pop("floor_gaps")
    emit({"phase": "train", "check": "parity_bf16", "model": cfg.name,
          "layers": cfg.num_layers, "tokens": seq, **par,
          "kernel_fed_grads": len(gaps),
          "kernel_fed_worst_gap": max(gaps.values()),
          "kernel_fed_median_gap": statistics.median(gaps.values()),
          "worst_leaves": sorted(gaps, key=gaps.get)[-3:],
          "floor_worst_gap": max(floor.values()),
          "floor_median_gap": statistics.median(floor.values()),
          "tol": TRAIN_TOL, "seconds": time.perf_counter() - t0})
    if max(par["loss_gap"], par["grad_norm_gap"]) > TRAIN_TOL:
        raise AssertionError(f"{cfg.name} train parity at bf16: {par}")

    # 2. the Runner: FAMILY_STEPS steps (the first one warms up)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        runner = Runner(cfg, rcfg, None, feed, d, device=device)
        runner.init_state(model=model)
        sizes = state_bytes(runner.state)
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().to("cpu", copy=True)
                  for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = ss.ssd_chunk_scan.launches = 0
        routes = counted_flash_routes(fa)
        s_routes = counted_ssd_routes(ss)
        runner.run(FAMILY_STEPS)
        launches = {"flash_attention": fa.flash_attention.launches,
                    "ssd_chunk_scan": ss.ssd_chunk_scan.launches,
                    "flash_attention_tf32x3": routes["tf32x3"],
                    "ssd_chunk_scan_heads": s_routes["heads"]}
        routes, s_routes = dict(routes), dict(s_routes)
        peak = torch.cuda.max_memory_allocated()
        still = [n for n, p, b in zip(names, model.parameters(), before)
                 if torch.equal(p.detach().cpu(), b)]
        del before
        log = runner.metrics_log
        t_data = time.perf_counter()
        feed.batch_at(0)
        data_s = time.perf_counter() - t_data
        del runner
    step_s = log[-1]["dt"]
    enc = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith("encoder."))
    n_all = sum(p.numel() for p in model.parameters())
    positions = batch * (seq + cfg.encoder_seq)
    flops = 6 * ((n_all - enc) * batch * seq
                 + enc * batch * cfg.encoder_seq)
    per_run = TRAIN_ACCUM * (1 if rcfg.remat == "none" else 2) * FAMILY_STEPS
    want = {k: v * per_run for k, v in per_forward(cfg).items()}
    routes_want = {k: v * per_run
                   for k, v in flash_routes_per_forward(torch, cfg).items()}
    want["flash_attention_tf32x3"] = routes_want["tf32x3"]
    want["ssd_chunk_scan_heads"] = ssd_routes(
        torch, cfg, want["ssd_chunk_scan"])["heads"]
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in log)
    row = {"phase": "train", "check": "runner", "model": cfg.name,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "seq": seq, "encoder_seq": cfg.encoder_seq,
           "global_batch": batch, "grad_accum": TRAIN_ACCUM,
           "remat": rcfg.remat, "steps": FAMILY_STEPS,
           "step_ms": [m["dt"] * 1e3 for m in log],
           "timed_step_ms": step_s * 1e3,
           "tokens_per_s": batch * seq / step_s,
           "positions_per_s": positions / step_s,
           "mfu": flops / step_s / PEAK_FLOPS,
           "mfu_formula": "6 * (decoder params * B * S + encoder params * "
                          "B * encoder_seq) / step s / 989e12 (bf16 peak; "
                          "attention flops not counted)",
           "params": n_all, "encoder_params": enc,
           "data_batch_ms": data_s * 1e3,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "launches": launches, "launches_want": want,
           "flash_launches_by_route": routes,
           "flash_launches_by_route_want": routes_want,
           "ssd_launches_by_route": s_routes,
           "ssd_launches_by_route_want": ssd_routes(
               torch, cfg, want["ssd_chunk_scan"]),
           "params_moved": len(names) - len(still), "params_total":
           len(names), "params_not_moved": still[:10],
           "state_bytes": sizes, "state_bytes_total": sum(sizes.values()),
           "max_memory_allocated": peak,
           "seconds": time.perf_counter() - t1, "gpu": smi}
    emit(row)
    if {k: launches[k] for k in want} != want or routes != routes_want \
            or s_routes != row["ssd_launches_by_route_want"] or still \
            or not finite:
        raise AssertionError(f"{cfg.name} train runner: {row}")
    del model
    torch.cuda.empty_cache()

    # 3. the kernel path against the plain path at 2 layers: bf16 (the
    # kernel-fed leaves' grads within TRAIN_TOL) and f32 (the loss and
    # every grad within FAMILY_F32_TOL)
    for dt, keep, tol in (("bfloat16", kernel_fed, TRAIN_TOL),
                          ("float32", lambda n: True, FAMILY_F32_TOL)):
        t1 = time.perf_counter()
        cfg2 = dataclasses.replace(
            cfg, num_layers=TRAIN_F32_LAYERS, dtype=dt, param_dtype=dt,
            encoder_layers=min(cfg.encoder_layers, TRAIN_F32_LAYERS))
        model = init_params(cfg2, device=device, seed=SEED + 20)
        par = train_parity(torch, device, cfg2, model, micro, keep)
        worst = max(par["grad_gaps"].values())
        emit({"phase": "train", "check": f"parity_{dt}_2_layers",
              "model": cfg.name, "layers": TRAIN_F32_LAYERS,
              **{k: v for k, v in par.items() if k != "grad_gaps"},
              "grad_leaves": len(par["grad_gaps"]), "worst_grad_gap": worst,
              "tol": tol, "seconds": time.perf_counter() - t1})
        if max(par["loss_gap"], worst) > tol:
            raise AssertionError(f"{cfg.name} train parity at {dt}, 2 "
                                 f"layers: {par}")
        del model
        torch.cuda.empty_cache()
    if cfg.name == FAMILY_FT_ARCH:
        fault_tolerance(torch, device, dataclasses.replace(
            cfg, num_layers=TRAIN_FT_LAYERS), rcfg, feed, SEED + 21)
    return launches


def phase_train_families(torch, device, smi: str, cfgs=None):
    """The ssm, hybrid and encdec trainers (``FAMILY_TRAINERS``; ``cfgs``:
    their configs by name, the full-width ones by default), one after the
    other, each freed before the next. Returns their launches, summed."""
    from repro_torch.configs import get_config
    total = {"flash_attention": 0, "ssd_chunk_scan": 0,
             "flash_attention_tf32x3": 0, "ssd_chunk_scan_heads": 0}
    for arch, seq, batch in FAMILY_TRAINERS:
        cfg = (cfgs or {}).get(arch) or get_config(arch)
        for k, v in family_trainer(torch, device, cfg, smi, seq,
                                   batch).items():
            total[k] += v
    return total


# per layer kind of a sharded train step at a world of one under "2d",
# beyond each FSDP leaf's two gathers (forward and remat) and one
# reduce-scatter: (all-gathers, reduce-scatters, psums) a micro-batch. A
# dense layer's psums: the attention's and the MLP's row-parallel sums
# forward, the attention's again in the recompute (which stops once the
# saved tensors are back: the MLP's last sum is not replayed), and
# backward x's into attention and MLP, wk's and wv's enters (MLA's w_dkv
# and kv_norm enter as they do: a dense_prefix layer is a dense one). An
# enc layer is a dense one; a dec layer adds a cross attention's 6 psums
# (its sum forward and in the recompute, its query and k/v inputs' and
# wk's and wv's enters). An ssm layer's psums: w_out's sum and the gated
# norm's forward, the norm's again in the recompute, and backward x's,
# w_B's, w_C's, conv_B's, conv_C's and the norm scale's enters and the
# norm sum's transpose. A hybrid layer is an ssm layer, an attention half
# and an MLP: 4 psums forward, 3 in the recompute, and backward h's one
# enter (both paths read it), wk's, wv's, the MLP input's and the SSM
# path's 6. A moe layer gathers the router's logits forward and in the
# recompute (their transpose one reduce-scatter); its psums: the
# attention half's 5, the routed and the dense (shared) branch's sums and
# the global aux's forward, the aux's and the routed sum's again in the
# recompute, and x's one enter backward
KIND_OPS = {"dense": (0, 0, 7), "dense_prefix": (0, 0, 7),
            "enc": (0, 0, 7), "dec": (0, 0, 13), "ssm": (0, 0, 10),
            "hybrid": (0, 0, 17), "moe": (2, 1, 11)}
# the same under Megatron-SP, where every sum a block's output makes is a
# reduce-scatter of the rows, every enter of its input a gather of them,
# and no weight enters (the step sums them): a dense layer gathers its
# rows for the attention and the MLP forward and in the recompute, and
# their transposes gather the outputs' cotangents (6); it reduce-scatters
# the two outputs forward, the attention's again in the recompute, and
# the two gathers' cotangents (5). A moe layer adds to the attention half
# the experts' row gather and the logits' gather forward and in the
# recompute and the three branches' outputs' transposes (9); the
# attention's output forward and in the recompute, the routed and dense
# branch's forward, the routed one's in the recompute, and the logits'
# and the two row gathers' transposes (8); the global aux's psum forward
# and in the recompute (2). An ssm layer gathers its rows forward and in
# the recompute and, backward, its output's cotangent (3); it
# reduce-scatters its output forward (the layer's last op, which the
# recompute stops short of) and the gather's cotangent (2); the gated
# norm's sum of squares forward, in the recompute and its transpose (3).
# A hybrid layer gathers h once for both paths and the MLP's input, each
# forward and in the recompute, and the three outputs' cotangents (7);
# it reduce-scatters the attention's, the SSM path's and the MLP's
# outputs forward, the first two again in the recompute, and the two
# gathers' cotangents (7); the norm's 3 psums. An enc layer is a dense
# one; a dec layer adds a cross attention half that gathers its rows
# forward and in the recompute and its output's cotangent (9 in all) and
# reduce-scatters its output forward and in the recompute and its
# gather's cotangent (8); the encoder's output it reads is gathered
# once a micro-batch (``train_collectives``), so no enter sums it
KIND_OPS_SP = {"dense": (6, 5, 0), "dense_prefix": (6, 5, 0),
               "moe": (9, 8, 2), "ssm": (3, 2, 3), "hybrid": (7, 7, 3),
               "enc": (6, 5, 0), "dec": (9, 8, 0)}


def train_collectives(cfg, accum: int, sp: bool = False,
                      factored: bool = False) -> dict:
    """The collectives of one sharded train step of a dense, moe, ssm,
    hybrid or encdec model (no q/k norms) at a world of one under the
    ``"2d"`` rules (``sp``: with Megatron-SP), reckoned from ``KIND_OPS``
    (``KIND_OPS_SP``) and the schema's layouts (the CPU rehearsals hold it
    against the ledger). Per micro-batch: the embedding (its table, and
    an untied head) gathered for the lookup and for the head and
    reduce-scattered after each, the lookup's and the head's sums (under
    SP the lookup's reduce-scatter, the head's row gather and their
    transposes instead, and an encoder's output's row gather, outside
    the layers' remat, and its transpose) and the loss's 3 psums (the
    vocabulary's exps and picked logits, the tokens' sums over data),
    and each layer's FSDP
    leaves gathered twice (forward and remat) and reduce-scattered once,
    and its ops. Per step: the gradient sum of every leaf ``sum_axes``
    sums, one clip norm psum for each set of axes the leaves split over,
    and with ``factored`` (Adafactor's second moment) a psum for each of
    its three means (the rows', the columns' and the rows' mean's) over a
    dim that a mesh axis splits."""
    from repro_torch.distribution import ShardingCtx
    from repro_torch.distribution.sharding import fsdp_entry, split_axes
    from repro_torch.models.params import opt_slots, schema_layouts, \
        slot_spec
    from repro_torch.train.train_loop import sum_axes
    shd = ShardingCtx({"data": 1, "model": 1}, train=True)
    layouts = schema_layouts(cfg, shd)
    leaves = sum(fsdp_entry(spec, dims) is not None
                 for n, (spec, dims) in layouts.items()
                 if n.startswith(("blocks.", "encoder.blocks.")))
    from repro_torch.models.model import build_schedule
    kinds = [seg.kind for seg in build_schedule(cfg)
             for _ in range(seg.count)] + ["enc"] * cfg.encoder_layers
    ops = KIND_OPS_SP if sp else KIND_OPS
    gathers, scatters, psums = (sum(ops[k][i] for k in kinds)
                                for i in range(3))
    synced = sum(bool(sum_axes(shd, spec, dims, "model" if sp else None))
                 for spec, dims in layouts.values())
    groups = {tuple(sorted(split_axes(spec)))
              for spec, _dims in layouts.values()} - {()}
    means = 0
    for slot in opt_slots(cfg) if factored else ():
        nd = len(layouts[slot.params[0]][1]) + slot.stacked
        spec = list(slot_spec(slot, layouts)) + [None] * nd
        if nd >= 2:
            means += bool(spec[nd - 1]) + 2 * bool(spec[nd - 2])
    base = (4, 4, 3) if sp else (2, 2, 5)
    if sp and cfg.encoder_layers:
        base = (5, 5, 3)
    return {"all_gather": accum * (base[0] + 2 * leaves + gathers),
            "reduce_scatter": accum * (base[1] + leaves + scatters),
            "psum": accum * (base[2] + psums) + synced + len(groups)
            + means}


def flash_routes_per_forward(torch, cfg):
    """``per_forward``'s flash launches by the route that takes them
    (``flash_attention.route``): an encoder model trains its encoder and
    its cross-attention in f32 (its frames are f32, ROADMAP P18), every
    other attention in the model's dtype. whisper-small's 24 f32 ones a
    forward take ``"tf32x3"``, the tensor cores."""
    from repro_torch.kernels.flash_attention import ROUTES, route
    f32 = cfg.encoder_layers + cfg.num_layers if cfg.encoder_layers else 0
    want = dict.fromkeys(ROUTES, 0)
    want[route(torch.float32, cfg.head_dim)] += f32
    want[route(getattr(torch, cfg.dtype), cfg.head_dim)] += \
        per_forward(cfg)["flash_attention"] - f32
    return want


# launches by wrapper and route, banked whenever a phase sets a wrapper's
# counts by route to 0 (``bank_routes``), so that ``route_totals`` holds
# every launch of the script
ROUTE_BANK = {}


def bank_routes(name: str, by_route):
    """Add ``by_route`` (the ``launches_by_route`` dict of the wrapper
    ``name``) to ``ROUTE_BANK``, then set it to 0 in place; returns it."""
    bank = ROUTE_BANK.setdefault(name, dict.fromkeys(by_route, 0))
    for k, v in by_route.items():
        bank[k] += v
    by_route.update(dict.fromkeys(by_route, 0))
    return by_route


def route_totals():
    """Launches by wrapper and route since the script began: the wrappers'
    counts and what ``bank_routes`` banked."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    return {name: {k: v + ROUTE_BANK.get(name, {}).get(k, 0)
                   for k, v in fn.launches_by_route.items()}
            for name, fn in (("flash_attention", fa.flash_attention),
                             ("decode_attention", da.decode_attention),
                             ("ssd_chunk_scan", ss.ssd_chunk_scan))}


def counted_flash_routes(fa):
    """The flash wrapper's counts by route, set to 0 in place (the wrapper
    holds the dict)."""
    return bank_routes("flash_attention", fa.flash_attention.launches_by_route)


def ssd_routes(torch, cfg, n: int):
    """``n`` SSD scan launches of ``cfg``'s layers by the route that takes
    them (``ssd_scan.route`` at the model's dtype, SSM head dim and state
    size): hymba-1.5b's take ``"heads"``, mamba2-370m's ``"wg"``."""
    from repro_torch.kernels.ssd_scan import ROUTES, route
    want = dict.fromkeys(ROUTES, 0)
    if n:
        want[route(getattr(torch, cfg.dtype), cfg.ssm.head_dim,
                   cfg.ssm.state_dim)] += n
    return want


def counted_ssd_routes(ss):
    """The SSD scan wrapper's counts by route, set to 0 in place."""
    return bank_routes("ssd_chunk_scan", ss.ssd_chunk_scan.launches_by_route)


def sharded_family_trainer(torch, device, cfg, smi: str, seq: int,
                           batch: int, cut: str):
    """One trainer of the ssm, hybrid or encdec family at full width and
    cut depth on the model axis at a world of one (``world_of_one``,
    ``"2d"``): the sharded micro-batch against the unsharded one from the
    same seeded weights (loss, grad norm and every kernel-fed leaf's
    gradient within ``TRAIN_TOL``), ``SHARDED_TRAIN_STEPS`` Runner steps
    on each path (the sharded ones counted: flash and SSD launches, every
    leaf moved, the ledger's collectives a step against
    ``train_collectives``), a profiled 1-layer sharded micro-batch; then
    the same with Megatron-SP (``seq_parallel_activations``, the rows
    split along the sequence, an encoder's frames too): its micro-batch
    against the unsharded one, its steps' launches equal to the sharded
    steps', every leaf moved, its ledger a step against
    ``train_collectives(..., sp=True)``. ``cut``: the depth's cut, for
    the row. Returns (the sharded and SP steps' launches, the row)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.params import init_params
    from repro_torch.train import Runner, loss_fn
    from repro_torch.train.optimizer import global_norm, grad_norm
    from repro_torch.train.train_loop import _grads, _sync_grads, train_ctx
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before the "
                             f"sharded {cfg.name} trainer")
    t0 = time.perf_counter()
    shape = ShapeConfig("train", seq, batch, "train")
    feed = for_model(cfg, shape, seed=SEED, device=device)
    micro = {k: v[:batch // TRAIN_ACCUM] for k, v in feed.batch_at(0).items()}
    rcfg = RunConfig(grad_accum=TRAIN_ACCUM, learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP)

    # 1. the unsharded path: one micro-batch, then the Runner's steps
    model = init_params(cfg, device=device, seed=SEED)
    grads, metrics = _grads(model, micro, cfg, RunConfig())
    want = {"loss": metrics["loss"].item(),
            "grad_norm": global_norm(grads.values()).item(),
            "grads": {n: g for n, g in grads.items() if kernel_fed(n)}}
    del grads
    with tempfile.TemporaryDirectory() as d:
        runner = Runner(cfg, rcfg, None, feed, d, device=device)
        runner.init_state(model=model)
        plain_ms = timed_steps(runner, SHARDED_TRAIN_STEPS)
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the sharded path on a world of one
    row = {"phase": "sharded_train_families", "model": cfg.name,
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "cut": cut, "rules": "2d", "world": 1, "seq": seq,
           "global_batch": batch,
           "grad_accum": TRAIN_ACCUM}
    with world_of_one(torch, device) as (serve_shd, core), \
            tempfile.TemporaryDirectory() as d:
        shd = train_ctx(serve_shd.axes, rcfg)
        runner = Runner(cfg, rcfg, shd, feed, d, device=device)
        runner.init_state(seed=SEED)
        model = runner.state["params"]
        grads, metrics = _grads(model, micro, cfg, RunConfig(),
                                lambda g: _sync_grads(model, g))
        got = {"loss": metrics["loss"].item(),
               "grad_norm": grad_norm(model, grads).item()}
        gaps = {n: rel_err(grads[n], want["grads"][n])
                for n in want["grads"]}
        del grads
        row.update({
            "loss_sharded": got["loss"], "loss_unsharded": want["loss"],
            "loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_sharded": got["grad_norm"],
            "grad_norm_unsharded": want["grad_norm"],
            "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"])
            / abs(want["grad_norm"]),
            "kernel_fed_grads": len(gaps),
            "kernel_fed_worst_gap": max(gaps.values()),
            "worst_leaves": sorted(gaps, key=gaps.get)[-3:],
            "tol": TRAIN_TOL})
        if not gaps or max(row["loss_gap"], row["grad_norm_gap"],
                           row["kernel_fed_worst_gap"]) > TRAIN_TOL:
            raise AssertionError(f"sharded {cfg.name} train parity: {row}")
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = ss.ssd_chunk_scan.launches = 0
        routes = counted_flash_routes(fa)
        s_routes = counted_ssd_routes(ss)
        ops0 = ledger_ops(core)
        runner.run(1)
        ops1 = ledger_ops(core)
        runner.run(SHARDED_TRAIN_STEPS - 1)
        launches = {"flash_attention": fa.flash_attention.launches,
                    "ssd_chunk_scan": ss.ssd_chunk_scan.launches,
                    "flash_attention_tf32x3": routes["tf32x3"],
                    "ssd_chunk_scan_heads": s_routes["heads"]}
        routes, s_routes = dict(routes), dict(s_routes)
        peak = torch.cuda.max_memory_allocated()
        still = [n for n, p, b in zip(names, model.parameters(), before)
                 if torch.equal(p.detach(), b)]
        del before
        per_run = TRAIN_ACCUM * 2 * SHARDED_TRAIN_STEPS
        launches_want = {k: v * per_run
                         for k, v in per_forward(cfg).items()}
        routes_want = {k: v * per_run for k, v in
                       flash_routes_per_forward(torch, cfg).items()}
        launches_want["flash_attention_tf32x3"] = routes_want["tf32x3"]
        launches_want["ssd_chunk_scan_heads"] = ssd_routes(
            torch, cfg, launches_want["ssd_chunk_scan"])["heads"]
        log = runner.metrics_log
        finite = all(math.isfinite(m["loss"]) and math.isfinite(
            m["grad_norm"]) for m in log)
        row.update({
            "step_ms_sharded": [m["dt"] * 1e3 for m in log],
            "step_ms_unsharded": plain_ms,
            "step_ratio": log[-1]["dt"] * 1e3 / plain_ms[-1],
            "ledger_ops_a_step": {v: ops1.get(v, 0) - ops0.get(v, 0)
                                  for v in ops1},
            "ledger_ops_want": train_collectives(cfg, TRAIN_ACCUM),
            "launches": launches, "launches_want": launches_want,
            "flash_launches_by_route": routes,
            "flash_launches_by_route_want": routes_want,
            "ssd_launches_by_route": s_routes,
            "ssd_launches_by_route_want": ssd_routes(
                torch, cfg, launches_want["ssd_chunk_scan"]),
            "params_moved": len(names) - len(still),
            "params_total": len(names), "params_not_moved": still[:10],
            "max_memory_allocated": peak,
            "losses": [m["loss"] for m in log]})
        if launches != launches_want or routes != routes_want or still \
                or s_routes != row["ssd_launches_by_route_want"] \
                or not finite \
                or row["ledger_ops_a_step"] != row["ledger_ops_want"]:
            raise AssertionError(f"sharded {cfg.name} train runner: {row}")
        del runner, model

        # a profiled sharded micro-batch at 1 layer (whisper 1 + 1)
        pcfg = dataclasses.replace(
            cfg, num_layers=SHARDED_PROFILE_LAYERS,
            encoder_layers=min(cfg.encoder_layers, SHARDED_PROFILE_LAYERS))
        pmodel = init_params(pcfg, device=device, seed=SEED, shd=shd)
        params = [p.requires_grad_(True) for p in pmodel.parameters()]

        def micro_batch():
            loss, _ = loss_fn(pmodel, micro, pcfg, rcfg)
            torch.autograd.grad(loss, params)

        t1 = time.perf_counter()
        prof = _profile(torch, micro_batch, top=6)
        prof["seconds"] = time.perf_counter() - t1
        prof["layers"] = pcfg.num_layers
        prof["encoder_layers"] = pcfg.encoder_layers
        row["profile_micro_batch"] = prof
        del pmodel, params
    gc.collect()
    torch.cuda.empty_cache()

    # 3. Megatron-SP: the same steps, the rows split along the sequence
    sp_rcfg = dataclasses.replace(rcfg, seq_parallel_activations=True)
    with world_of_one(torch, device) as (serve_shd, core), \
            tempfile.TemporaryDirectory() as d:
        shd = train_ctx(serve_shd.axes, sp_rcfg)
        runner = Runner(cfg, sp_rcfg, shd, feed, d, device=device)
        runner.init_state(seed=SEED)
        model = runner.state["params"]
        grads, metrics = _grads(
            model, micro, cfg, dataclasses.replace(sp_rcfg, grad_accum=1),
            lambda g: _sync_grads(model, g, seq=seq))
        sp = {"rows_axis": shd.sp_of(seq),
              "frames_axis": shd.sp_of(cfg.encoder_seq)
              if cfg.encoder_layers else None,
              "loss": metrics["loss"].item(),
              "grad_norm": grad_norm(model, grads).item()}
        gaps = {n: rel_err(grads[n], want["grads"][n])
                for n in want["grads"]}
        del grads, want["grads"]
        sp.update({
            "loss_gap": abs(sp["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_gap": abs(sp["grad_norm"] - want["grad_norm"])
            / abs(want["grad_norm"]),
            "kernel_fed_grads": len(gaps),
            "kernel_fed_worst_gap": max(gaps.values()),
            "worst_leaves": sorted(gaps, key=gaps.get)[-3:]})
        del gaps
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = ss.ssd_chunk_scan.launches = 0
        sp_routes = counted_flash_routes(fa)
        sp_s_routes = counted_ssd_routes(ss)
        ops0 = ledger_ops(core)
        runner.run(1)
        ops1 = ledger_ops(core)
        runner.run(SHARDED_TRAIN_STEPS - 1)
        sp_launches = {"flash_attention": fa.flash_attention.launches,
                       "ssd_chunk_scan": ss.ssd_chunk_scan.launches,
                       "flash_attention_tf32x3": sp_routes["tf32x3"],
                       "ssd_chunk_scan_heads": sp_s_routes["heads"]}
        sp_routes, sp_s_routes = dict(sp_routes), dict(sp_s_routes)
        still = [n for n, p, b in zip(names, model.parameters(), before)
                 if torch.equal(p.detach(), b)]
        del before
        log = runner.metrics_log
        sp.update({
            "step_ms": [m["dt"] * 1e3 for m in log],
            "step_ms_non_sp": row["step_ms_sharded"],
            "step_ratio_non_sp": log[-1]["dt"] * 1e3
            / row["step_ms_sharded"][-1],
            "launches": sp_launches, "flash_launches_by_route": sp_routes,
            "ssd_launches_by_route": sp_s_routes,
            "ledger_ops_a_step": {v: ops1.get(v, 0) - ops0.get(v, 0)
                                  for v in ops1},
            "ledger_ops_want": train_collectives(cfg, TRAIN_ACCUM, sp=True),
            "params_moved": len(names) - len(still),
            "params_not_moved": still[:10],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "losses": [m["loss"] for m in log]})
        row["seq_parallel"] = sp
        finite = all(math.isfinite(m["loss"]) and math.isfinite(
            m["grad_norm"]) for m in log)
        if not sp["rows_axis"] or not sp["kernel_fed_grads"] \
                or (cfg.encoder_layers and not sp["frames_axis"]) \
                or max(sp["loss_gap"], sp["grad_norm_gap"],
                       sp["kernel_fed_worst_gap"]) > TRAIN_TOL \
                or sp_launches != launches or sp_routes != routes \
                or sp_s_routes != s_routes or still or not finite \
                or sp["ledger_ops_a_step"] != sp["ledger_ops_want"]:
            raise AssertionError(f"sharded {cfg.name} train with "
                                 f"Megatron-SP: {sp}")
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()
    row.update({"seconds": time.perf_counter() - t0, "gpu": smi})
    emit(row)
    return {k: v + sp_launches[k] for k, v in launches.items()}, row


def phase_sharded_train_families(torch, device, smi: str, cfgs=None):
    """The ssm, hybrid and encdec families trained on the model axis at a
    world of one (``SHARDED_FAMILIES``; ``cfgs``: their configs by name,
    the full-width ones cut to the table's depth by default), each freed
    before the next, each without and with Megatron-SP, then
    ``family_train_rank_cases``. Returns (their launches summed, the rank
    cases' checks)."""
    import dataclasses

    from repro_torch.configs import get_config
    total = {"flash_attention": 0, "ssd_chunk_scan": 0,
             "flash_attention_tf32x3": 0, "ssd_chunk_scan_heads": 0}
    for arch, layers, enc, seq, batch in SHARDED_FAMILIES:
        full = get_config(arch)
        cfg = (cfgs or {}).get(arch) or dataclasses.replace(
            full, num_layers=layers, encoder_layers=enc)
        cut = f"{layers} of {full.num_layers} layers" + (
            f", {enc} of {full.encoder_layers} encoder layers" if enc
            else "")
        launches, _row = sharded_family_trainer(torch, device, cfg, smi,
                                                seq, batch, cut)
        for k, v in launches.items():
            total[k] += v
    rows = {"phase": "sharded_train_families", "case": "rank_kernels",
            "gpu": smi}
    checks = family_train_rank_cases(torch, device, smi, rows)
    emit(rows)
    return total, checks


def phase_sharded_train_moe(torch, device, smi: str, cfg=None):
    """The moe family trained at full width: ``SHARDED_MOE_ARCH``
    (deepseek-v2-236b: 160 experts of 1,536, 2 shared, top-6, MLA) cut to
    ``SHARDED_MOE_LAYERS`` (its dense prefix layer and one moe layer),
    the train phase's batch at ``SHARDED_MOE_SEQ`` tokens, under the
    reference's ``run_config_for`` settings of its train shape (bf16
    moments, factored nu, bf16 accumulation; ``grad_accum``
    ``TRAIN_ACCUM``). First on one device: a micro-batch, then
    ``SHARDED_TRAIN_STEPS`` Runner steps (flash launches, every leaf
    moved, ``moe_lb_loss`` finite); then on the model axis at a world of
    one (``world_of_one``) under ``"2d"`` with Megatron-SP: the sharded
    micro-batch against the unsharded one (loss, grad norm, and the
    router's, the experts' ``w_in`` and ``w_dkv``'s grads within
    ``TRAIN_TOL``), the Runner's steps as above plus the ledger's
    collectives a step against ``train_collectives``, a profiled sharded
    micro-batch; then ``moe_train_rank_cases``. ``cfg``: the config to
    train (default the cut full-width one). Returns (both paths' Runner
    launches, the rank cases' checks)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.params import init_params
    from repro_torch.train import Runner, loss_fn
    from repro_torch.train.optimizer import global_norm, grad_norm
    from repro_torch.train.train_loop import _grads, _sync_grads, train_ctx
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before the "
                             f"sharded moe train phase")
    t0 = time.perf_counter()
    full = get_config(SHARDED_MOE_ARCH)
    cfg = cfg or dataclasses.replace(full, num_layers=SHARDED_MOE_LAYERS)
    seq = SHARDED_MOE_SEQ
    shape = ShapeConfig("train_4k", seq, TRAIN_BATCH, "train")
    feed = for_model(cfg, shape, seed=SEED, device=device)
    rows = TRAIN_BATCH // TRAIN_ACCUM     # a micro-batch's, the world's
    micro = {k: v[:rows] for k, v in feed.batch_at(0).items()}
    rcfg = RunConfig(grad_accum=TRAIN_ACCUM, learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP, rules_variant="2d",
                     seq_parallel_activations=True,
                     moment_dtype="bfloat16", factored_nu=True,
                     grad_accum_dtype="bfloat16")
    micro_rcfg = dataclasses.replace(rcfg, grad_accum=1)
    launches_want = (cfg.num_layers * TRAIN_ACCUM * 2
                     * SHARDED_TRAIN_STEPS)
    row = {"phase": "sharded_train_moe", "model": cfg.name,
           "layers": cfg.num_layers,
           "cut": f"{cfg.num_layers} of {full.num_layers} layers "
                  f"({cfg.dense_layer_prefix} dense prefix)",
           "seq": seq, "global_batch": TRAIN_BATCH,
           "grad_accum": TRAIN_ACCUM, "moment_dtype": "bfloat16",
           "factored_nu": True, "grad_accum_dtype": "bfloat16",
           "flash_launches_want": launches_want}

    def keep(n):
        return n.endswith(SHARDED_MOE_KEEP)

    def runner_steps(runner, core=None):
        """The Runner's steps, counted: (flash launches, the leaves not
        moved, the ledger's ops of the first step, peak bytes)."""
        model = runner.state["params"]
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        ops0 = ledger_ops(core) if core is not None else {}
        runner.run(1)
        ops1 = ledger_ops(core) if core is not None else {}
        runner.run(SHARDED_TRAIN_STEPS - 1)
        launched = fa.flash_attention.launches
        still = [n for n, p, b in zip(names, model.parameters(), before)
                 if torch.equal(p.detach(), b)]
        return launched, still, {v: ops1.get(v, 0) - ops0.get(v, 0)
                                 for v in ops1}, \
            torch.cuda.max_memory_allocated()

    def log_ok(log):
        return all(math.isfinite(m["loss"]) and math.isfinite(
            m["grad_norm"]) and math.isfinite(m["moe_lb_loss"])
            for m in log)

    # 1. one device: a micro-batch, then the Runner's steps
    row["memory_allocated_before"] = torch.cuda.memory_allocated()
    model = init_params(cfg, device=device, seed=SEED)
    row["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    grads, metrics = _grads(model, micro, cfg, micro_rcfg)
    want = {"loss": metrics["loss"].item(),
            "grad_norm": global_norm(grads.values()).item(),
            "moe_lb_loss": metrics["moe_lb_loss"].item(),
            # kept on the host: the card needs the room for the Runner
            "grads": {n: g.cpu() for n, g in grads.items() if keep(n)}}
    del grads
    with tempfile.TemporaryDirectory() as d:
        runner = Runner(cfg, rcfg, None, feed, d, device=device)
        runner.init_state(model=model)
        launched, still, _ops, peak = runner_steps(runner)
        log = runner.metrics_log
        row.update({"step_ms_unsharded": [m["dt"] * 1e3 for m in log],
                    "flash_launches_unsharded": launched,
                    "params_not_moved_unsharded": still[:10],
                    "max_memory_allocated_unsharded": peak,
                    "losses_unsharded": [m["loss"] for m in log],
                    "moe_lb_loss_unsharded": [m["moe_lb_loss"]
                                              for m in log]})
        if launched != launches_want or still or not log_ok(log):
            raise AssertionError(f"moe train (one device): {row}")
        launches = launched
        del runner, model
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the model axis at a world of one, "2d" with Megatron-SP
    with world_of_one(torch, device) as (serve_shd, core), \
            tempfile.TemporaryDirectory() as d:
        shd = train_ctx(serve_shd.axes, rcfg)
        runner = Runner(cfg, rcfg, shd, feed, d, device=device)
        runner.init_state(seed=SEED)
        model = runner.state["params"]
        grads, metrics = _grads(model, micro, cfg, micro_rcfg,
                                lambda g: _sync_grads(model, g, seq=seq),
                                global_batch=rows)
        got = {"loss": metrics["loss"].item(),
               "grad_norm": grad_norm(model, grads).item()}
        gaps = {n: rel_err(grads[n], want["grads"][n].to(device))
                for n in want["grads"]}
        del grads, want["grads"]
        row.update({
            "sp_rows_axis": shd.sp_of(seq),
            "loss_sharded": got["loss"], "loss_unsharded": want["loss"],
            "loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_sharded": got["grad_norm"],
            "grad_norm_unsharded": want["grad_norm"],
            "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"])
            / abs(want["grad_norm"]),
            "moe_lb_loss_micro": [metrics["moe_lb_loss"].item(),
                                  want["moe_lb_loss"]],
            "compared_grads": len(gaps),
            "compared_worst_gap": max(gaps.values()),
            "worst_leaves": sorted(gaps, key=gaps.get)[-3:],
            "tol": TRAIN_TOL})
        if len(gaps) != 3 * cfg.num_layers - 2 * cfg.dense_layer_prefix \
                or not shd.sp_of(seq) \
                or max(row["loss_gap"], row["grad_norm_gap"],
                       row["compared_worst_gap"]) > TRAIN_TOL:
            raise AssertionError(f"sharded moe train parity: {row}")
        launched, still, ops, peak = runner_steps(runner, core)
        log = runner.metrics_log
        row.update({
            "step_ms_sharded": [m["dt"] * 1e3 for m in log],
            "step_ratio": log[-1]["dt"] * 1e3
            / row["step_ms_unsharded"][-1],
            "ledger_ops_a_step": ops,
            "ledger_ops_want": train_collectives(cfg, TRAIN_ACCUM, sp=True,
                                                 factored=True),
            "flash_launches_sharded": launched,
            "params_not_moved_sharded": still[:10],
            "params_total": len(list(model.parameters())),
            "max_memory_allocated": peak,
            "losses_sharded": [m["loss"] for m in log],
            "moe_lb_loss_sharded": [m["moe_lb_loss"] for m in log]})
        if launched != launches_want or still or not log_ok(log) \
                or ops != row["ledger_ops_want"]:
            raise AssertionError(f"moe train (sharded): {row}")
        launches += launched
        del runner, model

        # a profiled sharded micro-batch at the phase's depth
        pmodel = init_params(cfg, device=device, seed=SEED, shd=shd)
        params = [p.requires_grad_(True) for p in pmodel.parameters()]

        def micro_batch():
            loss, _ = loss_fn(pmodel, micro, cfg, micro_rcfg, rows)
            torch.autograd.grad(loss, params)

        t1 = time.perf_counter()
        prof = _profile(torch, micro_batch, top=6)
        prof["seconds"] = time.perf_counter() - t1
        prof["layers"] = cfg.num_layers
        row["profile_micro_batch"] = prof
        del pmodel, params
    gc.collect()
    torch.cuda.empty_cache()
    checks = moe_train_rank_cases(torch, device, smi, row)
    row.update({"seconds": time.perf_counter() - t0, "gpu": smi})
    emit(row)
    return launches, checks


def moe_train_rank_cases(torch, device, smi: str, row: dict):
    """``flash_train_rank`` at each TP train rank's shapes of the moe
    family's full-width attention over ``TRAIN_RANK_S`` tokens:
    deepseek-v2-236b's MLA prefill at tp 1 (all 128 heads, the shape the
    phase's own path launches) and 2/4/8/16 (64, 32, 16, 8 a rank), each
    its own kv head, dk 192 with v zero-padded from 128; arctic-480b's
    56/8 at tp 2/4/8/16 (28/4, 14/2, 7/1, and 4 of 64 padded heads at
    16). Puts the rows into ``row["rank_flash"]``; returns the checks by
    (case, tp)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    timer = Timer(torch, device)
    h, dk, dv = TRAIN_RANK_MLA
    hq, kv = ARCTIC_HEADS
    checks = {}
    for tp in (1,) + CP_TP:
        n = h // tp
        checks[("deepseek mla", tp)] = flash_train_rank(
            torch, device, gen, timer, smi, "deepseek mla", tp, n, n, dk,
            dv=dv)
        if tp == 1:
            continue
        hp, n, ranks = rank_heads(hq, tp)
        r = ranks[-1]
        checks[("arctic", tp)] = flash_train_rank(
            torch, device, gen, timer, smi, "arctic", tp, n,
            _local_kv_heads(hq, kv, hp, r * n, n), 128, r)
    row["rank_flash"] = [c["row"] for c in checks.values()]
    torch.cuda.empty_cache()
    return checks


def family_train_rank_cases(torch, device, smi: str, row: dict):
    """Each TP train rank's kernel work of the ssm, hybrid and encdec
    families under autograd, held against the plain forward and its
    autograd VJP within ``TRAIN_TOL`` of max |.|, the forward timed beside
    its bound and the plain forward:

    * ``SsdScanFn`` (the kernel forward, the plain VJP) at mamba2's rank
      heads of a 4,096-token sequence (nc 16; 32 / tp heads: 16, 8, 4, 2)
      and hymba's (nc 32; 25 at tp 2, all 50 past it, where its heads
      stay whole): all four outputs and the four inputs' gradients; no
      PyTorch call computes the scan, so no library time;
    * f32 ``FlashAttentionFn`` at whisper's encoder rank heads (B 4, S
      1,500, 12 heads: 6 and 3 at tp 2 and 4, 2 and 1 of 16 padded at 8
      and 16, d 64, bidirectional, the kv heads ``_local_kv`` gives them):
      o, dq, dk, dv; ``scaled_dot_product_attention``'s forward and
      backward timed beside it.

    Puts the rows into ``row["rank_ssd"]``/``row["rank_flash_f32"]``;
    returns the checks by (kernel, case, tp)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, route)
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, \
        ssd_chunk_scan_plain
    from repro_torch.models.attention import FlashAttentionFn, _local_kv
    from repro_torch.models.ssm import SsdScanFn
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    timer = Timer(torch, device)
    checks, ssd_rows, flash_rows = {}, [], []

    def rel(a, b):
        return rel_err(a, b) if b.abs().max().item() > 0 else \
            float((a.float() - b.float()).abs().max().item())

    for name, (q_, h_, p_, n_), nc in TRAIN_RANK_SSD:
        for tp in CP_TP:
            heads = h_ // tp if h_ % tp == 0 else h_
            ins = ssd_inputs(torch, gen, device, nc, "bfloat16",
                             shape=(q_, heads, p_, n_))
            outs_ref = ssd_chunk_scan_plain(*ins, out_dtype=torch.float32,
                                            state_decay=True)
            couts = [torch.randn(o.shape, generator=gen, device=device)
                     for o in outs_ref]
            x_in = [t.detach().requires_grad_() for t in ins]
            before = ssd_chunk_scan.launches
            outs = SsdScanFn.apply(*x_in)
            launched = ssd_chunk_scan.launches - before
            grads = torch.autograd.grad(outs, x_in, couts)
            r_in = [t.detach().requires_grad_() for t in ins]
            r_out = ssd_chunk_scan_plain(*r_in, out_dtype=torch.float32,
                                         state_decay=True)
            r_grads = torch.autograd.grad(r_out, r_in, couts)
            errs = {k: rel(a, b) for k, a, b in zip(
                ("y", "states", "chunk_decay", "state_decay"), outs, r_out)}
            errs.update({f"d{k}": rel(a, b) for k, a, b in zip(
                ("xdt", "dA", "B", "C"), grads, r_grads)})
            abs_y = (outs[0] - r_out[0]).abs().max().item()
            ok = max(errs.values()) <= TRAIN_TOL and launched == 1
            del outs, grads, r_out, r_grads, x_in, r_in, couts, outs_ref
            nbytes, flops = ssd_work(nc, 2, (q_, heads, p_, n_))
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            rank_row = {"case": name, "tp": tp, "chunks": nc, "Q": q_,
                        "heads": heads, "P": p_, "N": n_,
                        "max_rel_err": errs, "max_abs_err_y": abs_y,
                        "tol": TRAIN_TOL, "ok": ok,
                        "ms": timer.ms(lambda: ssd_chunk_scan(
                            *ins, out_dtype=torch.float32,
                            state_decay=True)),
                        "plain_ms": timer.ms(lambda: ssd_chunk_scan_plain(
                            *ins, out_dtype=torch.float32,
                            state_decay=True), reps=5),
                        "library_ms": None, "bound_ms": b_ms,
                        "bound_by": b_by, "bytes": nbytes, "flops": flops,
                        "gpu": smi}
            ssd_rows.append(rank_row)
            checks[("ssd_chunk_scan", name, tp)] = {
                "launches": launched, "max_abs_err": abs_y,
                "max_rel_err": max(errs.values()), "row": rank_row}
            del ins
            if not ok:
                raise AssertionError(f"SsdScanFn at {name}'s rank heads, "
                                     f"tp {tp}: {rank_row}")
    b, s, hq, d = TRAIN_RANK_ENC
    for tp in CP_TP:
        hp = padded_heads(hq, {"model": tp})
        n, r = hp // tp, 0 if hp == hq else tp - 1
        q = torch.randn((b, s, n, d), generator=gen, device=device)
        k, v = (torch.randn((b, s, hq, d), generator=gen, device=device)
                for _ in range(2))
        kl, vl = _local_kv(k, v, hq, hp, r * n, n)
        do = torch.randn((b, s, n, d), generator=gen, device=device)
        ins = [t.detach().requires_grad_() for t in (q, kl, vl)]
        took = route(q.dtype, d)         # "tf32x3" at d 64
        before = flash_attention.launches
        before_route = flash_attention.launches_by_route[took]
        o = FlashAttentionFn.apply(*ins, False, 0, 512, 512)
        launched = flash_attention.launches - before
        launched_route = flash_attention.launches_by_route[took] \
            - before_route
        grads = torch.autograd.grad(o, ins, do)
        ref_in = [t.detach().requires_grad_() for t in (q, kl, vl)]
        ref_o = flash_attention_plain(*ref_in, causal=False)
        ref_g = torch.autograd.grad(ref_o, ref_in, do)
        errs = {"o": rel_err(o, ref_o)}
        errs.update({f"d{x}": rel_err(a, c)
                     for x, a, c in zip("qkv", grads, ref_g)})
        abs_o = (o - ref_o).abs().max().item()
        # the forward on the tensor cores (three TF32 products) within the
        # f32 kernel's own tolerance of its plain version, too
        ok = max(errs.values()) <= TRAIN_TOL \
            and abs_o <= FLASH_TOL["float32"] \
            and launched == launched_route == 1
        del ins, o, grads, ref_in, ref_o, ref_g
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, kl, vl))
        dot = do.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        backend = sdpa_backend(torch, qt, kt, vt, enable_gqa=True)
        with sdpa_kernel([backend]):
            sdpa_ms = timer.ms(sdpa_fwd_bwd, reps=5)
        nbytes, flops = flash_work(b, s, s, n, kl.shape[2], d, 4, False, 0)
        b_ms, b_by = bound(nbytes, flops, "float32", took)
        rank_row = {"case": "whisper encoder", "tp": tp, "rank": r, "B": b,
                    "S": s, "hq": n, "kv": kl.shape[2], "d": d,
                    "dtype": "float32", "causal": False, "route": took,
                    "bound_ms_f32_cuda_cores": bound(nbytes, flops,
                                                     "float32")[0],
                    "max_rel_err": errs, "max_abs_err_o": abs_o,
                    "tol": TRAIN_TOL, "tol_abs_o": FLASH_TOL["float32"],
                    "route_launches": launched_route, "ok": ok,
                    "ms": timer.ms(lambda: flash_attention(
                        q, kl, vl, causal=False)),
                    "plain_ms": timer.ms(lambda: flash_attention_plain(
                        q, kl, vl, causal=False), reps=5),
                    "library_fwd_bwd_ms": sdpa_ms,
                    "library": "scaled_dot_product_attention",
                    "library_backend": backend.name,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops, "gpu": smi}
        flash_rows.append(rank_row)
        checks[("flash_attention", "whisper encoder f32", tp)] = {
            "launches": launched, "max_abs_err": abs_o,
            "max_rel_err": max(errs.values()), "row": rank_row}
        del q, k, v, kl, vl, do, qt, kt, vt, dot
        if not ok:
            raise AssertionError(f"f32 flash under autograd at whisper's "
                                 f"encoder rank heads, tp {tp}: {rank_row}")
    row["rank_ssd"] = ssd_rows
    row["rank_flash_f32"] = flash_rows
    torch.cuda.empty_cache()
    return checks


def _state_tensors(runner):
    """Every tensor of a Runner's train state, in a fixed order."""
    st = runner.state
    return (list(st["params"].parameters()) + list(st["opt"]["mu"].values())
            + [t for d in st["opt"]["nu"].values() for t in d.values()]
            + [st["opt"]["count"], st["step"]])


def fairness_convergence(ctl, **kw):
    """3 unequal tenants, 2 engines: (served/fair per tenant, claim (a)
    metric: the worst relative deviation from weighted max-min)."""
    cap = FAIR_CAPACITY
    tenants = [ctl.SimTenant(1, demand=0.15 * cap),
               ctl.SimTenant(2, demand=0.90 * cap),
               ctl.SimTenant(3, demand=2.00 * cap)]
    sim = ctl.SharedBottleneckSim(tenants, cap, n_engines=2, dt=FAIR_DT,
                                  **kw)
    res = sim.run(FAIR_T_RUN)
    ref = sim.fair_reference()
    return [res], max(abs(res.served_rate(t) - ref[t]) / ref[t]
                      for t in ref)


def fairness_isolation(ctl, **kw):
    """A tenant offering 10x the bottleneck beside three in budget: claim
    (b) metric, the worst degradation against each one's run alone."""
    cap = FAIR_CAPACITY
    normal = {1: 0.20 * cap, 2: 0.25 * cap, 3: 0.15 * cap}
    runs, base = [], {}
    for t, d in normal.items():
        res = ctl.SharedBottleneckSim([ctl.SimTenant(t, d)], cap,
                                      dt=FAIR_DT, **kw).run(FAIR_T_RUN)
        base[t] = res.served_rate(t)
        runs.append(res)
    tenants = [ctl.SimTenant(t, d) for t, d in normal.items()]
    tenants.append(ctl.SimTenant(9, demand=10.0 * cap))
    res = ctl.SharedBottleneckSim(tenants, cap, dt=FAIR_DT, **kw).run(
        FAIR_T_RUN)
    runs.append(res)
    return runs, max(max(1.0 - res.served_rate(t) / base[t], 0.0)
                     for t in normal)


def fairness_backfill(ctl, **kw):
    """A tenant idle from 4 s to 8 s: claim (c) metrics, the survivor's
    share of capacity while it is idle and the returning tenant's share of
    its fair half."""
    cap = FAIR_CAPACITY

    def on_off(t):
        return 0.8 * cap if t < 4.0 or t >= 8.0 else 0.0

    tenants = [ctl.SimTenant(1, on_off), ctl.SimTenant(2, 2.0 * cap)]
    sim = ctl.SharedBottleneckSim(tenants, cap, dt=FAIR_DT, **kw)
    runs = [sim.run(4.0), sim.run(4.0), sim.run(4.0)]
    return runs, (runs[1].served_rate(2, 0.4, 1.0) / cap,
                  runs[2].served_rate(1, 0.5, 1.0) / (0.5 * cap))


FAIRNESS = {"convergence": fairness_convergence,
            "isolation": fairness_isolation, "backfill": fairness_backfill}


def fairness_claim(name, metric) -> bool:
    """Claims (a)-(c) of benchmarks/bench_fairness.py."""
    if name == "convergence":
        return metric < 0.10
    if name == "isolation":
        return metric < 0.05
    absorbed, returned = metric
    return absorbed > 0.90 and abs(returned - 1.0) < 0.15


def allocation_gap(a_runs, b_runs) -> float:
    """Largest |a - b| over every tick's allocations, per unit capacity."""
    gap = 0.0
    for a, b in zip(a_runs, b_runs):
        if len(a.allocations) != len(b.allocations):
            raise AssertionError("the two controllers ticked differently")
        for x, y in zip(a.allocations, b.allocations):
            if x.keys() != y.keys():
                raise AssertionError(f"tenants {sorted(x)} != {sorted(y)}")
            gap = max([gap] + [abs(x[t] - y[t]) for t in x])
    return gap / FAIR_CAPACITY


def phase_fairness(torch, device):
    """The three scenarios on the object controller and on the vectorized
    one on ``device``. Returns the water-fill launches."""
    import repro_torch.control as ctl
    from repro_torch.kernels.waterfill import water_fill
    launches = 0
    for name, run in FAIRNESS.items():
        obj_runs, obj_metric = run(ctl)
        water_fill.launches = 0
        vec_runs, vec_metric = run(ctl, backend="vectorized", device=device)
        n_launch = water_fill.launches
        # one history per simulator (a run's ``allocations`` is its
        # controller's history so far); each entry is one allocation, one
        # water-fill launch
        ticks = sum(len(h) for h in {id(r.allocations): r.allocations
                                     for r in vec_runs}.values())
        gap = allocation_gap(obj_runs, vec_runs)
        checks = {"claim_object": fairness_claim(name, obj_metric),
                  "claim_vectorized": fairness_claim(name, vec_metric),
                  "backends_agree": gap <= FAIR_BACKEND_TOL,
                  "one_launch_per_tick": n_launch == ticks > 0}
        emit({"phase": "fairness", "scenario": name,
              "metric_object": obj_metric, "metric_vectorized": vec_metric,
              "allocation_gap_over_capacity": gap,
              "tol": FAIR_BACKEND_TOL, "controller_ticks": ticks,
              "water_fill_launches": n_launch, "checks": checks,
              "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"fairness {name}: {checks}")
        launches += n_launch
    return launches


# ---------------------------------------------------------------------------
# the distribution phase: the model axis
# ---------------------------------------------------------------------------


def cp_empty_rows(pos_list, window: int, lo: int, hi: int):
    """(sequence) indices with no live position in cache slots [lo, hi)."""
    out = []
    for b, p in enumerate(pos_list):
        first = max(0, p - window + 1) if window else 0
        if p < lo or first >= hi:
            out.append(b)
    return out


def cp_decode_cases(torch, device, gen):
    """(a) The context-parallel decode's per-rank work at full width: the
    cache of ``CP_B`` sequences of ``CP_T`` positions cut into ``tp``
    contiguous chunks, each its own tensor, the decode kernel launched once
    per chunk at the chunk's local positions (negative before it), the
    chunks combined by ``stacked_lse_combine`` (the arithmetic the sharded
    path runs over ``model``), held against one launch over the whole cache
    and against the plain version; every (chunk, sequence) with no live
    position must come back as the empty row (o 0, m NEG_INF, l 0).
    Returns, by (query heads, tp), the launches these checks made at that
    shape and the largest error against the plain version: absolute, and
    relative to max |o|."""
    from repro_torch.kernels.decode_attention import (
        NEG_INF, decode_attention, decode_attention_plain)
    from repro_torch.models.attention import stacked_lse_combine
    checks, d = {}, 128
    for hq, kv in (VLM_HEADS, LLAMA_HEADS):
        q = torch.randn((CP_B, hq, d), generator=gen, device=device)
        kc, vc = (torch.randn((CP_B, CP_T, kv, d), generator=gen,
                              device=device).to(torch.bfloat16)
                  for _ in range(2))
        for pos_list, window, dt in (
                (CP_POS_EDGES, 0, "bfloat16"), (CP_POS_MID, 0, "bfloat16"),
                (CP_POS_EDGES, CP_WINDOW, "bfloat16"),
                (CP_POS_MID, CP_WINDOW, "bfloat16"),
                (CP_POS_EDGES, 0, "float32")):
            qx = q.to(getattr(torch, dt))
            pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
            full = decode_attention(qx, kc, vc, pos, window=window)[0]
            plain = decode_attention_plain(qx, kc, vc, pos,
                                           window=window)[0]
            for tp in CP_TP:
                chunk = CP_T // tp
                parts, empty_ok, n_empty = [], True, 0
                before = decode_attention.launches
                for r in range(tp):
                    ks = kc[:, r * chunk:(r + 1) * chunk].contiguous()
                    vs = vc[:, r * chunk:(r + 1) * chunk].contiguous()
                    o, m, l = decode_attention(qx, ks, vs, pos - r * chunk,
                                               window=window)
                    parts.append((o, m, l))
                    for b in cp_empty_rows(pos_list, window, r * chunk,
                                           (r + 1) * chunk):
                        n_empty += 1
                        empty_ok = empty_ok and not bool(o[b].any()) \
                            and bool((m[b] == NEG_INF).all()) \
                            and not bool(l[b].any())
                    del ks, vs
                n_launched = decode_attention.launches - before
                o = stacked_lse_combine(
                    *(torch.stack(x) for x in zip(*parts))).to(qx.dtype)
                torch.cuda.synchronize()
                e_full, e_plain = rel_err(o, full), rel_err(o, plain)
                e_abs = (o.float() - plain.float()).abs().max().item()
                tol = CP_TOL[dt]
                ok = e_full <= tol and e_plain <= tol and empty_ok \
                    and bool(torch.isfinite(o).all())
                emit({"phase": "distribution", "case": "cp_decode",
                      "kernel": "decode_attention", "B": CP_B, "T": CP_T,
                      "tp": tp, "chunk": chunk, "hq": hq, "kv": kv, "d": d,
                      "q_dtype": dt, "cache_dtype": "bfloat16",
                      "window": window, "pos": list(pos_list),
                      "launches": n_launched, "empty_rows": n_empty,
                      "empty_rows_exact": empty_ok,
                      "rel_err_vs_full_launch": e_full,
                      "rel_err_vs_plain": e_plain, "abs_err_vs_plain": e_abs,
                      "tol": tol, "ok": ok})
                if not ok:
                    raise AssertionError(
                        f"cp decode {hq}/{kv} tp {tp} {dt} window {window} "
                        f"pos {pos_list}: {e_full} / {e_plain} > {tol}, "
                        f"empty rows exact {empty_ok}")
                c = checks.setdefault((hq, tp), {
                    "launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0})
                c["launches"] += n_launched
                c["max_abs_err"] = max(c["max_abs_err"], e_abs)
                c["max_rel_err"] = max(c["max_rel_err"], e_plain)
                del parts, o
        del kc, vc
        torch.cuda.empty_cache()
    return checks


def tp_flash_cases(torch, device, gen):
    """(b) Flash at each rank's shapes of full-width llama3.2-3b's prefill
    (S ``TP_FLASH_S``, d 128): the rank's query heads and the kv heads
    ``models.attention._local_kv`` gives them (tp 2/4/8: 12/4, 6/2, 3/1
    heads; tp 16: 2 of 32 padded heads, a slice of one kv head at group 2,
    or two gathered kv heads at group 1, or padded heads), each held
    against its plain version and, on the real heads, against one launch
    over all 24 heads. Returns, by tp, the launches these checks made at
    that tp and the largest absolute error against the plain version."""
    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models.attention import _local_kv
    hq, kv = LLAMA_HEADS
    d, s, dt = 128, TP_FLASH_S, "bfloat16"
    q = torch.randn((1, s, hq, d), generator=gen,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn((1, s, kv, d), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    full = flash_attention(q, k, v)
    checks = {}
    for tp in CP_TP:
        hp = padded_heads(hq, {"model": tp})
        n = hp // tp
        qp = torch.cat([q, torch.randn((1, s, hp - hq, d), generator=gen,
                                       device=device).to(q.dtype)], dim=2)
        ranks = (0, tp - 1) if tp < 16 else (0, 1, 11, 12, 15)
        for r in ranks:
            ql = qp[:, :, r * n:(r + 1) * n].contiguous()
            kl, vl = _local_kv(k, v, hq, hp, r * n, n)
            before = flash_attention.launches
            o = flash_attention(ql, kl, vl)
            n_launched = flash_attention.launches - before
            torch.cuda.synchronize()
            e_plain = (o.float() - flash_attention_plain(ql, kl, vl).float()
                       ).abs().max().item()
            real = max(0, min(n, hq - r * n))
            e_full = (o[:, :, :real].float() - full[:, :, r * n:r * n + real]
                      .float()).abs().max().item() if real else 0.0
            ok = e_plain <= FLASH_TOL[dt] and e_full <= FLASH_TOL[dt] \
                and bool(torch.isfinite(o).all())
            emit({"phase": "distribution", "case": "tp_flash",
                  "kernel": "flash_attention", "S": s, "tp": tp, "rank": r,
                  "heads": n, "real_heads": real, "kv_heads": kl.shape[2],
                  "group": n // kl.shape[2], "d": d, "dtype": dt,
                  "max_abs_err": e_plain, "max_abs_err_vs_all_heads": e_full,
                  "tol": FLASH_TOL[dt], "ok": ok})
            if not ok:
                raise AssertionError(f"flash at tp {tp} rank {r}: {e_plain}, "
                                     f"{e_full} > {FLASH_TOL[dt]}")
            c = checks.setdefault(tp, {"launches": 0, "max_abs_err": 0.0})
            c["launches"] += n_launched
            c["max_abs_err"] = max(c["max_abs_err"], e_plain)
    return checks


def cp_timings(torch, device, smi: str, timer):
    """One cp shard's decode launch (every position live: the busiest
    chunk) beside the whole cache's launch, the plain version on the
    shard, ``scaled_dot_product_attention`` on the shard, and the shard's
    bound (its k/v read once); at chameleon-34b's heads for every tp and
    llama3.2-3b's at tp 16. Returns the rows by (heads, tp)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    rows, d = {}, 128
    for (hq, kv), tps in ((VLM_HEADS, CP_TP), (LLAMA_HEADS, (16,))):
        q = torch.randn((CP_B, hq, d), generator=gen,
                        device=device).to(torch.bfloat16)
        kc, vc = (torch.randn((CP_B, CP_T, kv, d), generator=gen,
                              device=device).to(torch.bfloat16)
                  for _ in range(2))
        pos = torch.full((CP_B,), CP_T - 1, dtype=torch.int32, device=device)
        full_ms = timer.ms(lambda: decode_attention(q, kc, vc, pos))
        for tp in tps:
            chunk = CP_T // tp
            ks, vs = (x[:, :chunk].contiguous() for x in (kc, vc))
            lp = torch.full((CP_B,), chunk - 1, dtype=torch.int32,
                            device=device)
            kt, vt = (x.transpose(1, 2).contiguous() for x in (ks, vs))
            mask = live_mask(lp, chunk)[:, None, None, :]
            nbytes, flops = decode_work([chunk - 1] * CP_B, chunk, hq, kv, d,
                                        2, 2)
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            row = {"phase": "timings", "kernel": "decode_attention",
                   "case": "cp shard", "tp": tp, "B": CP_B, "T": CP_T,
                   "chunk": chunk, "hq": hq, "kv": kv, "d": d,
                   "dtype": "bfloat16",
                   "ms": timer.ms(lambda: decode_attention(q, ks, vs, lp)),
                   "full_cache_ms": full_ms,
                   "plain_ms": timer.ms(
                       lambda: decode_attention_plain(q, ks, vs, lp)),
                   **library_row(torch, timer, q[:, :, None, :], kt, vt,
                                 attn_mask=mask, enable_gqa=True),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                   "flops": flops, "gpu": smi}
            emit(row)
            rows[(hq, tp)] = row
            del ks, vs, kt, vt
        del kc, vc
        torch.cuda.empty_cache()
    return rows


def tp_flash_timings(torch, device, smi: str, timer):
    """Flash at one rank's shapes of llama3.2-3b's prefill of
    ``TP_FLASH_S`` tokens for each tp (rank 0; rank 1 at tp 16, whose two
    heads read two gathered kv heads), beside the plain version,
    ``scaled_dot_product_attention`` and the bound."""
    from repro_torch.distribution.sharding import padded_heads
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.models.attention import _local_kv
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    hq, kv = LLAMA_HEADS
    d, s = 128, TP_FLASH_S
    rows = {}
    for tp in CP_TP:
        hp = padded_heads(hq, {"model": tp})
        n, r = hp // tp, 1 if tp == 16 else 0
        q = torch.randn((1, s, n, d), generator=gen,
                        device=device).to(torch.bfloat16)
        k, v = (torch.randn((1, s, kv, d), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        kl, vl = _local_kv(k, v, hq, hp, r * n, n)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kl, vl))
        nbytes, flops = flash_work(1, s, s, n, kl.shape[2], d, 2, True, 0)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "flash_attention",
               "case": "TP rank", "tp": tp, "rank": r, "S": s, "hq": n,
               "kv": kl.shape[2], "d": d, "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, kl, vl)),
               "plain_ms": timer.ms(
                   lambda: flash_attention_plain(q, kl, vl)),
               **library_row(torch, timer, qt, kt, vt, is_causal=True,
                             enable_gqa=True),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[tp] = row
    return rows


def per_rank_bytes():
    """(d) Each rank's weight bytes at ``model = TP_BYTES_AXIS`` for
    llama3.2-3b (24 -> 32 padded query heads), chameleon-34b, arctic-480b
    (56 -> 64 heads, 8 of 128 experts a rank) and deepseek-v2-236b (128
    heads, 10 of 160 experts a rank), reckoned
    from the schema's meta tensors and ``param_shardings``' placements on
    the serving layout (model-sharded, replicated over data), beside the
    one-device bytes; and each rank's k/v cache bytes at decode_32k's
    8 x 32,768 positions. No device work: the layout's arithmetic."""
    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.device import dtype_of
    from repro_torch.distribution.sharding import (
        ShardingCtx, local_shape, padded_heads, param_shardings)
    from repro_torch.models.model import cache_schema, model_schema
    from repro_torch.models.schema import abstract_params, walk
    mesh = {"data": 1, "model": TP_BYTES_AXIS}
    shd = ShardingCtx(mesh)
    out = {}

    def leaves(schema):
        for tree in [schema["embed"], schema["final_norm"]] \
                + schema["layers"]:
            for _path, desc in walk(tree):
                yield desc

    for arch in ("llama3.2-3b", "chameleon-34b", "arctic-480b",
                 "deepseek-v2-236b"):
        cfg = get_config(arch)
        schema = model_schema(cfg, mesh)
        metas = abstract_params(schema)
        assert metas["layers"][0]["attn"]["wq"].device.type == "meta"
        total = rank = split = 0
        for desc in leaves(schema):
            elem = dtype_of(desc.dtype).itemsize
            placements = param_shardings(desc, mesh, shd.weight_rules)
            split += any(isinstance(p, Shard) for p in placements)
            spec = shd.weight_spec(desc.shape, desc.dims)
            total += math.prod(desc.shape) * elem
            rank += math.prod(local_shape(desc.shape, spec, mesh)) * elem
        one = sum(math.prod(dd.shape) * dtype_of(dd.dtype).itemsize
                  for dd in leaves(model_schema(cfg)))
        cache = rank_cache = 0
        for seg in cache_schema(cfg, CP_B, CP_T):
            for dd in seg.values():
                elem = dtype_of(dd.dtype).itemsize
                cache += math.prod(dd.shape) * elem
                rank_cache += math.prod(local_shape(
                    dd.shape, shd.spec(dd.shape, dd.dims), mesh)) * elem
        row = {"phase": "distribution", "case": "per_rank_bytes",
               "model": arch, "model_axis": TP_BYTES_AXIS,
               "heads": cfg.num_heads,
               "padded_heads": padded_heads(cfg.num_heads, mesh),
               "one_device_weight_bytes": one, "padded_weight_bytes": total,
               "rank_weight_bytes": rank, "sharded_leaves": split,
               "cache_bytes_decode_32k": cache,
               "rank_cache_bytes_decode_32k": rank_cache,
               "reckoned": True}
        emit(row)
        out[arch] = row
    return out


# (b) of the distribution phase: each rank's kernel work at the other
# families' full-width shapes, for every tp of CP_TP
RANK_TOL = 2e-2               # of max |o| (|y|, |state|) at bf16
RANK_FLASH = (                # name, (hq, kv), d, B, S, causal, window
    ("arctic", ARCTIC_HEADS, 128, 1, TP_FLASH_S, True, 0),
    ("hymba window", HYBRID_HEADS, HYBRID_D, 1, 1536, True, HYBRID_WINDOW),
    ("whisper encoder", (12, 12), 64, ENCDEC_BATCH, 1500, False, 0))
RANK_MLA = (128, 192, 128, TP_FLASH_S)   # heads, dk, dv, S (deepseek)
RANK_SSD = (("mamba2", (SSD_Q, SSD_H, SSD_P, SSD_N), 2),
            ("hymba", HYBRID_SSD, HYBRID_SSD_CHUNKS))
RANK_DECODE = (               # name, (hq, kv), d, T, positions, ring
    ("hymba ring", HYBRID_HEADS, HYBRID_D, HYBRID_WINDOW, RING_DECODE_POS,
     True),
    ("whisper self", (12, 12), 64, ENCDEC_MAX_SEQ, ENCDEC_DECODE_POS,
     False))
RANK_TIMED_TP = (2, 16)
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu"
           for k in ("flash_attention", "decode_attention")}
SOURCES["ssd_chunk_scan"] = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:87",
            "decode_attention": "src/repro/kernels/decode_attention.py:64",
            "ssd_chunk_scan": "src/repro/kernels/ssd_scan.py:47"}


def rank_heads(hq: int, tp: int):
    """(padded heads, heads a rank, the ranks checked) of ``hq`` query
    heads at ``tp``: the first, the second, the middle and the last."""
    from repro_torch.distribution.sharding import padded_heads
    hp = padded_heads(hq, {"model": tp})
    return hp, hp // tp, sorted({0, min(1, tp - 1), tp // 2, tp - 1})


def _held(c: dict, n_launched: int, err: float, rel: float) -> None:
    c["launches"] += n_launched
    c["max_abs_err"] = max(c["max_abs_err"], err)
    c["max_rel_err"] = max(c["max_rel_err"], rel)


def _checked(checks, kernel, name, tp, n, err, rel, row):
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"{kernel} {name} at tp {tp}: {rel} > "
                             f"{RANK_TOL} of max |o|")
    _held(checks.setdefault((kernel, name, tp), {
        "launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}),
        n, err, rel)


def family_rank_cases(torch, device, gen):
    """(b) Each TP rank's kernel work at the other families' full-width
    shapes for every tp of ``CP_TP``, each launch held against its plain
    version within ``RANK_TOL`` of max |o| at bf16:

    * flash on the rank's query heads and the kv heads ``_local_kv`` gives
      them: arctic's 56/8 (group 7; at 16, 64 padded heads, 4 a rank),
      hymba's windowed 25/5, whisper's encoder 12/12 over B 8 x 1,500
      frames (not causal); deepseek's MLA prefill on 128 / tp heads at dk
      192 with v padded from 128 (``_mla_prefill``'s layout);
    * the SSD scan on a rank's heads: mamba2's 32 / tp, hymba's 50 / 2 at
      tp 2 and all 50 past it (its heads stay whole where the width
      splits: ``models/ssm.py::_inner_split``);
    * decode on a rank's chunk: hymba's ring of 1,024 slots at the ring's
      last live slot minus the chunk's offset, no window, and whisper's
      self cache of 448 at its positions, each combined over the chunks by
      ``stacked_lse_combine`` and held against one launch too.

    Returns the checks by (kernel, case, tp): launches, the largest
    absolute error and the largest relative to max |o|."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, \
        ssd_chunk_scan_plain
    from repro_torch.models.attention import _local_kv, ring_slots, \
        stacked_lse_combine
    bf = torch.bfloat16
    checks = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    def errs(o, want):
        err = (o.float() - want.float()).abs().max().item()
        return err, err / max(want.float().abs().max().item(), 1e-30)

    for name, (hq, kv), d, b, s, causal, window in RANK_FLASH:
        q, k, v = randn(b, s, hq, d), randn(b, s, kv, d), randn(b, s, kv, d)
        for tp in CP_TP:
            hp, n, ranks = rank_heads(hq, tp)
            qp = torch.cat([q, randn(b, s, hp - hq, d)], 2) if hp > hq \
                else q
            for r in ranks:
                ql = qp[:, :, r * n:(r + 1) * n].contiguous()
                kl, vl = _local_kv(k, v, hq, hp, r * n, n)
                before = flash_attention.launches
                o = flash_attention(ql, kl, vl, causal=causal, window=window)
                k_n = flash_attention.launches - before
                err, rel = errs(o, flash_attention_plain(
                    ql, kl, vl, causal=causal, window=window))
                _checked(checks, "flash_attention", name, tp, k_n, err, rel,
                         {"phase": "distribution", "case": "rank_flash",
                          "model": name, "tp": tp, "rank": r, "B": b,
                          "S": s, "heads": n, "kv_heads": kl.shape[2],
                          "d": d, "causal": causal, "window": window,
                          "max_abs_err": err, "rel_err": rel,
                          "tol": RANK_TOL, "ok": rel <= RANK_TOL})
        del q, k, v
    h, dk, dv, s = RANK_MLA
    for tp in CP_TP:
        n = h // tp
        q, k = randn(1, s, n, dk), randn(1, s, n, dk)
        v = torch.nn.functional.pad(randn(1, s, n, dv), (0, dk - dv))
        before = flash_attention.launches
        o = flash_attention(q, k, v, causal=True, scale=dk ** -0.5)
        k_n = flash_attention.launches - before
        err, rel = errs(o[..., :dv], flash_attention_plain(
            q, k, v, causal=True, scale=dk ** -0.5)[..., :dv])
        _checked(checks, "flash_attention", "deepseek mla", tp, k_n, err,
                 rel, {"phase": "distribution", "case": "rank_flash",
                       "model": "deepseek mla", "tp": tp, "S": s,
                       "heads": n, "dk": dk, "dv": dv, "max_abs_err": err,
                       "rel_err": rel, "tol": RANK_TOL,
                       "ok": rel <= RANK_TOL})
    for name, shape, nc in RANK_SSD:
        q_, h_, p_, n_ = shape
        for tp in CP_TP:
            heads = h_ // tp if h_ % tp == 0 else h_
            xdt, dA, B, C = ssd_inputs(torch, gen, device, nc, "bfloat16",
                                       shape=(q_, heads, p_, n_))
            before = ssd_chunk_scan.launches
            y, st, _dec, _sd = ssd_chunk_scan(
                xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)
            k_n = ssd_chunk_scan.launches - before
            ry, rst, _rd, _rsd = ssd_chunk_scan_plain(
                xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)
            (ey, ry_), (es, rs_) = errs(y, ry), errs(st, rst)
            _checked(checks, "ssd_chunk_scan", name, tp, k_n, max(ey, es),
                     max(ry_, rs_),
                     {"phase": "distribution", "case": "rank_ssd",
                      "model": name, "tp": tp, "chunks": nc, "Q": q_,
                      "heads": heads, "P": p_, "N": n_, "max_abs_err_y": ey,
                      "max_abs_err_state": es, "rel_err": max(ry_, rs_),
                      "tol": RANK_TOL, "ok": max(ry_, rs_) <= RANK_TOL})
    for name, (hq, kv), d, t, pos_list, ring in RANK_DECODE:
        b = len(pos_list)
        q, kc, vc = randn(b, hq, d), randn(b, t, kv, d), randn(b, t, kv, d)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        at = ring_slots(pos, t).pos_eff if ring else pos
        full = decode_attention(q, kc, vc, at)[0]
        plain = decode_attention_plain(q, kc, vc, at)[0]
        for tp in CP_TP:
            c = t // tp
            before = decode_attention.launches
            parts = [decode_attention(
                q, kc[:, r * c:(r + 1) * c].contiguous(),
                vc[:, r * c:(r + 1) * c].contiguous(), at - r * c)
                for r in range(tp)]
            k_n = decode_attention.launches - before
            o = stacked_lse_combine(
                *(torch.stack(x) for x in zip(*parts))).to(bf)
            err, rel = errs(o, plain)
            rel_full = errs(o, full)[1]
            _checked(checks, "decode_attention", name, tp, k_n, err,
                     max(rel, rel_full),
                     {"phase": "distribution", "case": "rank_decode",
                      "model": name, "tp": tp, "B": b, "T": t, "chunk": c,
                      "hq": hq, "kv": kv, "d": d, "ring": ring,
                      "pos": list(pos_list), "launches": k_n,
                      "max_abs_err": err, "rel_err_vs_plain": rel,
                      "rel_err_vs_full_launch": rel_full, "tol": RANK_TOL,
                      "ok": max(rel, rel_full) <= RANK_TOL})
        del q, kc, vc
    torch.cuda.synchronize()
    return checks


def family_rank_timings(torch, device, smi: str, timer):
    """One rank's launch at ``RANK_TIMED_TP`` for each shape of
    ``family_rank_cases`` (rank 0; its busiest decode chunk: every
    position live), beside the plain version, the bound and, for
    attention, ``scaled_dot_product_attention`` on the same inputs (the
    SSD scan has no library call). Returns the rows by (kernel, case,
    tp)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, \
        ssd_chunk_scan_plain
    from repro_torch.models.attention import _local_kv
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    bf = torch.bfloat16
    rows = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    def keep(kernel, name, tp, row):
        row.update({"phase": "timings", "kernel": kernel,
                    "case": f"{name} rank", "tp": tp, "gpu": smi})
        emit(row)
        rows[(kernel, name, tp)] = row

    for name, (hq, kv), d, b, s, causal, window in RANK_FLASH:
        for tp in RANK_TIMED_TP:
            hp, n, _ = rank_heads(hq, tp)
            q, k, v = randn(b, s, n, d), randn(b, s, kv, d), randn(b, s, kv,
                                                                   d)
            kl, vl = _local_kv(k, v, hq, hp, 0, n)
            kw = {"causal": causal, "window": window}
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kl, vl))
            lib = {"is_causal": True} if causal and not window else {}
            if window:
                i = torch.arange(s, device=device)
                lib = {"attn_mask": (i[:, None] >= i[None, :])
                       & (i[:, None] - i[None, :] < window)}
            nbytes, flops = flash_work(b, s, s, n, kl.shape[2], d, 2,
                                       causal, window)
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            keep("flash_attention", name, tp, {
                "B": b, "S": s, "hq": n, "kv": kl.shape[2], "d": d,
                "window": window, "causal": causal,
                "ms": timer.ms(lambda: flash_attention(q, kl, vl, **kw)),
                "plain_ms": timer.ms(
                    lambda: flash_attention_plain(q, kl, vl, **kw)),
                **library_row(torch, timer, qt, kt, vt, enable_gqa=True,
                              **lib),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": flops})
            del q, k, v, kl, vl, qt, kt, vt
    h, dk, dv, s = RANK_MLA
    for tp in RANK_TIMED_TP:
        n = h // tp
        q, k = randn(1, s, n, dk), randn(1, s, n, dk)
        v = torch.nn.functional.pad(randn(1, s, n, dv), (0, dk - dv))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_work(1, s, s, n, n, dk, 2, True, 0, dv)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        sc = dk ** -0.5
        keep("flash_attention", "deepseek mla", tp, {
            "S": s, "hq": n, "kv": n, "dk": dk, "dv": dv,
            "ms": timer.ms(lambda: flash_attention(q, k, v, scale=sc)),
            "plain_ms": timer.ms(
                lambda: flash_attention_plain(q, k, v, scale=sc)),
            **library_row(torch, timer, qt, kt, vt, is_causal=True,
                          scale=sc),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops})
    for name, shape, nc in RANK_SSD:
        q_, h_, p_, n_ = shape
        for tp in RANK_TIMED_TP:
            heads = h_ // tp if h_ % tp == 0 else h_
            xdt, dA, B, C = ssd_inputs(torch, gen, device, nc, "bfloat16",
                                       shape=(q_, heads, p_, n_))
            nbytes, flops = ssd_work(nc, 2, (q_, heads, p_, n_))
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            kw = {"out_dtype": torch.float32, "state_decay": True}
            keep("ssd_chunk_scan", name, tp, {
                "chunks": nc, "Q": q_, "H": heads, "P": p_, "N": n_,
                "ms": timer.ms(lambda: ssd_chunk_scan(xdt, dA, B, C, **kw)),
                "plain_ms": timer.ms(
                    lambda: ssd_chunk_scan_plain(xdt, dA, B, C, **kw)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": nbytes, "flops": flops})
    for name, (hq, kv), d, t, pos_list, _ring in RANK_DECODE:
        b = len(pos_list)
        for tp in RANK_TIMED_TP:
            c = t // tp
            q, kc, vc = randn(b, hq, d), randn(b, c, kv, d), randn(b, c, kv,
                                                                   d)
            lp = torch.full((b,), c - 1, dtype=torch.int32, device=device)
            kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
            mask = live_mask(lp, c)[:, None, None, :]
            nbytes, flops = decode_work([c - 1] * b, c, hq, kv, d, 2, 2)
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            keep("decode_attention", name, tp, {
                "B": b, "T": t, "chunk": c, "hq": hq, "kv": kv, "d": d,
                "ms": timer.ms(lambda: decode_attention(q, kc, vc, lp)),
                "plain_ms": timer.ms(
                    lambda: decode_attention_plain(q, kc, vc, lp)),
                **library_row(torch, timer, q[:, :, None, :], kt, vt,
                              attn_mask=mask, enable_gqa=True),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": flops})
    return rows


# psums over ``model`` one layer of each kind makes a forward on a mesh
# whose model axis divides every sharded dim (a world of one): attention's
# row-parallel out-projection and the MLP's (``dense``); the SSM path's
# gated-norm sum of squares and its out-projection (``ssm``); attention,
# the SSM path and the MLP (``hybrid``); attention, the cross attention
# and the MLP (``dec``); attention and the MLP (an encoder's ``enc``)
LAYER_PSUMS = {"dense": 2, "dense_prefix": 2, "ssm": 2, "hybrid": 4,
               "dec": 3, "enc": 2}


def model_psums(cfg, prefill: bool) -> int:
    """The psums over ``model`` of one sharded forward of ``cfg`` at a
    world of one, reckoned from its layers: the vocab-sharded embedding's
    one, each layer's (``LAYER_PSUMS``; a ``moe`` layer: attention's, the
    experts' f32 combine and each of its shared or dense MLPs), and at a
    prefill the encoder's layers. The cp decode's LSE combine adds none at
    a world of one: the cache is one chunk."""
    from repro_torch.models import build_schedule
    moe = cfg.moe
    per = dict(LAYER_PSUMS)
    if moe is not None:
        per["moe"] = 2 + bool(moe.num_shared_experts) + moe.parallel_dense
    n = 1 + sum(per[seg.kind] * seg.count for seg in build_schedule(cfg))
    if prefill:
        n += per["enc"] * cfg.encoder_layers
    return n


@contextlib.contextmanager
def plain_calls(counts: dict):
    """Count calls of the attention cores' and the SSD scan's plain
    versions as the model calls them: a sharded serve that fell back to
    one would show here."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    real = {"flash_attention_plain": (attn, attn.flash_attention_plain),
            "decode_attention_plain": (attn, attn.decode_attention_plain),
            "ssd_chunk_scan_plain": (ssm, ssm.ssd_chunk_scan_plain)}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for name, (mod, fn) in real.items():
        counts.setdefault(name, 0)
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def world_of_one(torch, device):
    """The sharded path's world on one card: a process group of one rank
    over a ``HashStore`` (NCCL on the card, gloo on the CPU: two ranks
    cannot share a card under NCCL), ``ShardingCtx(make_host_mesh(1,
    1))`` and a CoreEngine installed for the serving collectives. Yields
    (the context, the engine)."""
    import torch.distributed as dist

    from repro_torch.core import make_engine, use_engine
    from repro_torch.distribution import ShardingCtx
    from repro_torch.launch import make_host_mesh
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        shd = ShardingCtx(make_host_mesh(1, 1, device=device.type))
        core = make_engine(shd.axes, "xla")
        with use_engine(core):
            yield shd, core
    finally:
        dist.destroy_process_group()


def ledger_psums(core) -> int:
    return sum(ops for _t, verb, axes, ops, _b in core.ledger_table()
               if verb == "psum" and axes == ("model",))


def sharded_serve(torch, device, cfg, want_tokens, prefill_kernels,
                  decode_kernels, *, profile=False, profile_kw=None,
                  **serve_kw):
    """(a)/(c) of the distribution phase: ``cfg`` at full width served
    through the sharded path at a world of one (``world_of_one``), the
    serve phase's 12 requests from the same seeded weights (every layout
    draws the same values): tokens identical to ``want_tokens`` (the
    unsharded engine's), the scheduler's ledger and each kernel once per
    layer and admission or step (``phase_serve``), the CoreEngine's psums
    over ``model`` equal to ``model_psums``' reckoning for the run's
    admissions and steps, no plain attention or SSD call on the card.
    ``profile``: also profile the sharded engine (``phase_profile``, with
    ``profile_kw``) and time the collectives' host cost. Returns the run's
    launches."""
    plain = {}
    row = {}
    with world_of_one(torch, device) as (shd, core), plain_calls(plain):
        eng, launches, _ = phase_serve(
            torch, device, cfg, cfg.num_layers, prefill_kernels,
            decode_kernels, prefill_lens=(), shd=shd, phase="distribution",
            row_out=row, **serve_kw)
        got = {r.req_id: list(r.generated) for r in eng.completed}
        same = got == want_tokens
        table = core.ledger_table()
        psums = ledger_psums(core)
        want_psums = eng.admissions * model_psums(cfg, prefill=True) \
            + eng.decode_steps * model_psums(cfg, prefill=False)
        no_plain = device.type != "cuda" or not any(plain.values())
        ok = same and psums == want_psums and no_plain \
            and eng.params.shd is shd
        emit({"phase": "distribution", "case": "sharded_serve",
              "model": cfg.name, "layers": cfg.num_layers,
              "mesh": dict(shd.axis_sizes), "backend": "nccl"
              if device.type == "cuda" else "gloo",
              "tokens_equal_unsharded": same,
              "admissions": eng.admissions, "decode_steps": eng.decode_steps,
              "launches": launches, "plain_calls": plain,
              "ledger": [list(r[:3]) + [r[3], r[4]] for r in table],
              "model_psums": psums, "model_psums_expected": want_psums,
              "psums_a_prefill": model_psums(cfg, prefill=True),
              "psums_a_step": model_psums(cfg, prefill=False),
              "step_ms_median": row.get("step_ms_median"),
              "run_s": row.get("run_s"), "ok": ok})
        if not ok:
            raise AssertionError(f"{cfg.name} sharded serve: tokens equal "
                                 f"{same}, psums {psums} of {want_psums}, "
                                 f"plain calls {plain}")
        if profile:
            # on an engine over the same weights with no rate controller,
            # whose buckets would hold back the profile's 8 prompts
            from repro_torch.configs import RunConfig
            from repro_torch.serve import ServeEngine
            phase_profile(torch, device, ServeEngine(
                cfg, RunConfig(), eng.params, batch_slots=eng.B,
                max_seq=eng.max_seq, shd=shd), **(profile_kw or {}))
            collective_host_us(torch, device, shd, core)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sharded_encdec(torch, device, cfg, prompts, frames, want_tokens):
    """(a) of the distribution phase for whisper (served through
    ``forward_prefill(..., frames=)`` and ``forward_decode``, ROADMAP R9):
    the model from the encdec phase's seed through the sharded path at a
    world of one, its prompts and frames, ``ENCDEC_NEW`` greedy steps:
    tokens identical to ``want_tokens`` (the unsharded run's), flash once
    per encoder layer, decoder layer and cross attention, decode twice a
    decoder layer and step, psums as ``model_psums`` reckons them, no
    plain call. Returns the launches."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    plain = {}
    with world_of_one(torch, device) as (shd, core), plain_calls(plain):
        model = init_params(cfg, device=device, seed=SEED, shd=shd)
        fa.flash_attention.launches = da.decode_attention.launches = 0
        t0 = time.perf_counter()
        _out, toks, _c = encdec_serve(torch, model, RunConfig(), prompts,
                                      frames, ENCDEC_NEW)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"flash_attention": fa.flash_attention.launches,
                    "decode_attention": da.decode_attention.launches}
        want = {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
                "decode_attention": 2 * cfg.num_layers * ENCDEC_NEW}
        psums = ledger_psums(core)
        want_psums = model_psums(cfg, prefill=True) \
            + ENCDEC_NEW * model_psums(cfg, prefill=False)
        same = torch.equal(toks, want_tokens)
        no_plain = device.type != "cuda" or not any(plain.values())
        ok = same and launches == want and psums == want_psums and no_plain
        emit({"phase": "distribution", "case": "sharded_encdec",
              "model": cfg.name, "mesh": dict(shd.axis_sizes),
              "tokens_equal_unsharded": same, "launches": launches,
              "launches_want": want, "plain_calls": plain,
              "model_psums": psums, "model_psums_expected": want_psums,
              "run_s": run_s, "ok": ok})
        if not ok:
            raise AssertionError(f"{cfg.name} sharded: tokens equal {same}, "
                                 f"launches {launches} of {want}, psums "
                                 f"{psums} of {want_psums}, plain {plain}")
        del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def collective_host_us(torch, device, shd, core):
    """Where the sharded path's collectives spend host time at world 1: µs
    a call, calls back to back (``host_us``), of a decode step's psum
    payload (8 x 1 x d_model bf16) through ``ShardingCtx.psum`` (nk_psum ->
    CoreEngine.dispatch -> XlaNsm -> NCCL), through ``dist.all_reduce``
    alone, and of ``CoreEngine.dispatch``'s bookkeeping with a no-op NSM
    verb (``shm_move``), and of the q gather through
    ``ShardingCtx.all_gather``."""
    import torch.distributed as dist

    from repro_torch.core import use_engine
    x = torch.randn((8, 1, 3072), device=device).to(torch.bfloat16)
    q = torch.randn((8, 1, 24, 128), device=device).to(torch.bfloat16)
    group = shd.axes.group(("model",))
    with use_engine(core):
        row = {"phase": "distribution", "case": "collective_host_us",
               "psum_nk": host_us(torch, lambda: shd.psum(x, "model")),
               "all_reduce": host_us(
                   torch, lambda: dist.all_reduce(x, group=group)),
               "dispatch_only": host_us(torch, lambda: core.dispatch(
                   "shm_move", x, ("model",))),
               "all_gather_nk": host_us(
                   torch, lambda: shd.all_gather(q, "model", 2))}
    emit(row)
    return row


def phase_distribution(torch, device, cfg, want_tokens, *,
                       profile: bool = False):
    """The model axis on the card: (a) ``cp_decode_cases``, (b)
    ``tp_flash_cases`` and ``family_rank_cases`` (each rank's kernel work
    at the other families' shapes), (c) full-width ``cfg`` served through
    the sharded path at a world of one (``sharded_serve``: two ranks
    cannot share one card under NCCL, so the cross-rank arithmetic is held
    on gloo worlds on the CPU), tokens identical to ``want_tokens`` (the
    unsharded engine's on the same weights); (d) ``per_rank_bytes``.
    ``profile``: also profile the sharded engine and time the collectives'
    host cost. The other families' sharded serves run after their own
    phases (``main``). Returns (the main path's launches in (c), the
    checks of (a) and (b) by kernel: launches and errors at the per-rank
    shapes, which no main path runs, and those of ``family_rank_cases``
    by (kernel, case, tp))."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    checks = {"decode_attention": cp_decode_cases(torch, device, gen),
              "flash_attention": tp_flash_cases(torch, device, gen)}
    family = family_rank_cases(torch, device, gen)
    torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t0
    launches = sharded_serve(torch, device, cfg, want_tokens,
                             {"flash_attention": flash_attention},
                             {"decode_attention": decode_attention},
                             profile=profile)
    per_rank_bytes()
    emit({"phase": "distribution", "kernel_cases_s": t_kernels,
          "seconds": time.perf_counter() - t0})
    return launches, checks, family


def hybrid_attention_timings(torch, device, smi: str, timer, gen):
    """hymba-1.5b's attention shapes (25/5 heads, d 64, bf16): flash over a
    1536-token prompt with the 1024-token window and without (a global
    layer); decode over 8 rings of 1024 slots at ``RING_DECODE_POS``, as
    the path calls it (``pos_eff``, no window). Each beside its bound, its
    plain version, ``scaled_dot_product_attention`` on the same function
    (the window, and the ring's live slots, as a boolean mask) with the
    backend it dispatches to, and the wrapper's host µs."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        _mask, flash_attention, flash_attention_plain)
    from repro_torch.models.attention import ring_slots
    (hq, kv), d = HYBRID_HEADS, HYBRID_D
    rows = {}
    s = HYBRID_PROMPT_RANGE[1]
    q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
               .to(torch.bfloat16) for h in (hq, kv, kv))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    for window in (HYBRID_WINDOW, 0):
        nbytes, flops = flash_work(1, s, s, hq, kv, d, 2, True, window)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        lib = library_row(torch, timer, qt, kt, vt, attn_mask=_mask(
            s, s, causal=True, window=window, q_offset=0, device=device),
            enable_gqa=True) if window else library_row(
            torch, timer, qt, kt, vt, is_causal=True, enable_gqa=True)
        row = {"phase": "timings", "kernel": "flash_attention",
               "model": "hymba-1.5b", "S": s, "hq": hq, "kv": kv, "d": d,
               "window": window, "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, k, v,
                                                      window=window)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(
                   q, k, v, window=window)), **lib,
               "host_us": host_us(torch, lambda: flash_attention(
                   q, k, v, window=window)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", "hymba", window)] = row
    b, t = 8, HYBRID_WINDOW
    pos = torch.tensor(RING_DECODE_POS, dtype=torch.int32, device=device)
    at = ring_slots(pos, t).pos_eff
    q = torch.randn((b, hq, d), generator=gen,
                    device=device).to(torch.bfloat16)
    kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
              .to(torch.bfloat16) for _ in range(2))
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    nbytes, flops = decode_work(at.tolist(), t, hq, kv, d, 2, 2)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row = {"phase": "timings", "kernel": "decode_attention",
           "model": "hymba-1.5b", "B": b, "T": t, "hq": hq, "kv": kv,
           "d": d, "pos": "ring", "positions": list(RING_DECODE_POS),
           "kernel_positions": at.tolist(), "dtype": "bfloat16",
           "ms": timer.ms(lambda: decode_attention(q, kc, vc, at)),
           "plain_ms": timer.ms(
               lambda: decode_attention_plain(q, kc, vc, at)),
           **library_row(torch, timer, q[:, :, None, :], kt, vt,
                         attn_mask=live_mask(at, t)[:, None, None, :],
                         enable_gqa=True),
           "host_us": host_us(torch, lambda: decode_attention(q, kc, vc,
                                                              at)),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "gpu": smi}
    emit(row)
    rows[("decode_attention", "hymba")] = row
    return rows


def arctic_attention_timings(torch, device, smi: str, timer, gen):
    """arctic-480b's attention shapes (56/8 heads: group 7, d 128, bf16):
    flash over its 64- and 509-token prompts, causal; decode over 8 caches
    of 1024 at mixed and at serve-range positions. Each beside its bound,
    its plain version, ``scaled_dot_product_attention`` with the backend
    it dispatches to, and the wrapper's host µs."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    (hq, kv), d = ARCTIC_HEADS, 128
    rows = {}
    for s in (64, 509):
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for h in (hq, kv, kv))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_work(1, s, s, hq, kv, d, 2, True, 0)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "flash_attention",
               "model": "arctic-480b", "S": s, "hq": hq, "kv": kv, "d": d,
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, k, v)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v)),
               **library_row(torch, timer, qt, kt, vt, is_causal=True,
                             enable_gqa=True),
               "host_us": host_us(torch, lambda: flash_attention(q, k, v)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", "arctic", s)] = row
    b, t = 8, 1024
    for name, pos_list in (("mixed", DECODE_POS),
                           ("serve", SERVE_DECODE_POS)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(torch.bfloat16)
        kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(2))
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        nbytes, flops = decode_work(pos_list, t, hq, kv, d, 2, 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "decode_attention",
               "model": "arctic-480b", "B": b, "T": t, "hq": hq, "kv": kv,
               "d": d, "pos": name, "positions": list(pos_list),
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: decode_attention(q, kc, vc, pos)),
               "plain_ms": timer.ms(
                   lambda: decode_attention_plain(q, kc, vc, pos)),
               **library_row(torch, timer, q[:, :, None, :], kt, vt,
                             attn_mask=live_mask(pos, t)[:, None, None, :],
                             enable_gqa=True),
               "host_us": host_us(
                   torch, lambda: decode_attention(q, kc, vc, pos)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("decode_attention", "arctic", name)] = row
    return rows


def nemotron_attention_timings(torch, device, smi: str, timer, gen):
    """Head dim 192: flash at nemotron-4-340b's 96/8 heads and at
    deepseek-v2-236b's MLA prefill (128/128, v zero-padded from 128, as
    ``models/attention.py::_mla_prefill`` hands it over) over a 509-token
    prompt, causal, bf16; decode at nemotron's group 12 over 8 caches of
    1024 at the serve phase's positions and at mixed ones. Each beside its
    bound, its plain version, ``scaled_dot_product_attention`` on the same
    inputs with the backend it dispatches to, and the wrapper's host µs."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    d, s, rows = NEMOTRON_D, 509, {}
    for model, (hq, kv), dv in (("nemotron-4-340b", NEMOTRON_HEADS, d),
                                ("deepseek-v2-236b", MLA_HEADS, MLA_DV)):
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for h in (hq, kv, kv))
        v[..., dv:] = 0
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_work(1, s, s, hq, kv, d, 2, True, 0, dv)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "flash_attention",
               "model": model, "S": s, "hq": hq, "kv": kv, "d": d,
               "v_cols": dv, "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, k, v)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v)),
               **library_row(torch, timer, qt, kt, vt, is_causal=True,
                             enable_gqa=True),
               "host_us": host_us(torch, lambda: flash_attention(q, k, v)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", model, s)] = row
    (hq, kv), b, t = NEMOTRON_HEADS, 8, 1024
    for name, pos_list in (("serve", SERVE_DECODE_POS),
                           ("mixed", DECODE_POS)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(torch.bfloat16)
        kc, vc = (torch.randn((b, t, kv, d), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(2))
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        nbytes, flops = decode_work(pos_list, t, hq, kv, d, 2, 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "decode_attention",
               "model": "nemotron-4-340b", "B": b, "T": t, "hq": hq,
               "kv": kv, "d": d, "pos": name, "positions": list(pos_list),
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: decode_attention(q, kc, vc, pos)),
               "plain_ms": timer.ms(
                   lambda: decode_attention_plain(q, kc, vc, pos)),
               **library_row(torch, timer, q[:, :, None, :], kt, vt,
                             attn_mask=live_mask(pos, t)[:, None, None, :],
                             enable_gqa=True),
               "host_us": host_us(
                   torch, lambda: decode_attention(q, kc, vc, pos)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("decode_attention", "nemotron", name)] = row
    return rows


def encdec_timings(torch, device, smi: str, timer, gen):
    """whisper-small's attention shapes (12/12 heads, d 64) and the SSD
    trainers' scans, each beside its bound, its plain version and, for
    attention, ``scaled_dot_product_attention`` on the same function
    (``is_causal`` is its top-left mask, the cross-attention's): flash
    bidirectional over 1500 frames (B 8 bf16, the served encoder; B 4 f32,
    the trained one), causal cross-attention with S 4 (B 8 bf16, the
    served prefill) and S 448 (B 4 f32, training) against T 1500; decode
    over 1500 frames at pos 1499 (the cross decode) and over 448 slots at
    the serve range (the self decode), B 8 bf16; the SSD scan over 16
    chunks of mamba2-370m's width and 32 of hymba-1.5b's (bf16, one
    training sequence of 4,096 tokens)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, route)
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain)
    (hq, kv), d, t = ENCDEC_HEADS, ENCDEC_D, ENCDEC_FRAMES
    rows = {}
    for name, b, s, dt, causal in (
            ("encoder", ENCDEC_BATCH, t, "bfloat16", False),
            ("encoder_train", TRAIN_ACCUM, t, "float32", False),
            ("cross", ENCDEC_BATCH, ENCDEC_PROMPT, "bfloat16", True),
            ("cross_train", TRAIN_ACCUM, ENCDEC_MAX_SEQ, "float32", True)):
        dtype = getattr(torch, dt)
        q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((b, t, kv, d), generator=gen, device=device)
                .to(dtype) for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        elem = torch.finfo(dtype).bits // 8
        nbytes, flops = flash_work(b, s, t, hq, kv, d, elem, causal, 0)
        took = route(dtype, d)
        b_ms, b_by = bound(nbytes, flops, dt, took)
        row = {"phase": "timings", "kernel": "flash_attention",
               "model": "whisper-small", "shape": name, "B": b, "S": s,
               "T": t, "hq": hq, "kv": kv, "d": d, "causal": causal,
               "dtype": dt, "route": took,
               "bound_ms_f32_cuda_cores": bound(nbytes, flops, dt)[0]
               if took == "tf32x3" else None,
               "ms": timer.ms(lambda: flash_attention(q, k, v,
                                                      causal=causal)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(
                   q, k, v, causal=causal)),
               **library_row(torch, timer, qt, kt, vt, is_causal=causal),
               "host_us": host_us(torch, lambda: flash_attention(
                   q, k, v, causal=causal)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", "whisper", name)] = row
    b = ENCDEC_BATCH
    for name, tt, pos_list in (("cross", t, (t - 1,) * b),
                               ("self", ENCDEC_MAX_SEQ, ENCDEC_DECODE_POS)):
        pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
        q = torch.randn((b, hq, d), generator=gen,
                        device=device).to(torch.bfloat16)
        kc, vc = (torch.randn((b, tt, kv, d), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(2))
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        nbytes, flops = decode_work(pos_list, tt, hq, kv, d, 2, 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "decode_attention",
               "model": "whisper-small", "shape": name, "B": b, "T": tt,
               "hq": hq, "kv": kv, "d": d, "positions": list(pos_list),
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: decode_attention(q, kc, vc, pos)),
               "plain_ms": timer.ms(
                   lambda: decode_attention_plain(q, kc, vc, pos)),
               **library_row(torch, timer, q[:, :, None, :], kt, vt,
                             attn_mask=live_mask(pos, tt)[:, None, None, :]),
               "host_us": host_us(torch, lambda: decode_attention(
                   q, kc, vc, pos)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("decode_attention", "whisper", name)] = row
    for name, nc, shape in (("mamba2-370m", 16, None),
                            ("hymba-1.5b", 32, HYBRID_SSD)):
        xdt, dA, B, C = ssd_inputs(torch, gen, device, nc, "bfloat16",
                                   shape=shape)
        nbytes, flops = ssd_work(nc, 2, shape)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "ssd_chunk_scan",
               "model": name, "shape": "train", "nb": 1, "nc": nc,
               **dict(zip("QHPN", shape or (SSD_Q, SSD_H, SSD_P, SSD_N))),
               "dtype": "bfloat16", "out_dtype": "float32",
               "state_decay": True,
               "ms": timer.ms(lambda: ssd_chunk_scan(
                   xdt, dA, B, C, out_dtype=torch.float32,
                   state_decay=True)),
               "plain_ms": timer.ms(lambda: ssd_chunk_scan_plain(
                   xdt, dA, B, C, out_dtype=torch.float32,
                   state_decay=True)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": flops, "gpu": smi}
        emit(row)
        rows[("ssd_chunk_scan", "train", name)] = row
    return rows


def phase_timings(torch, device, smi: str):
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, live_mask)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    timer = Timer(torch, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    hq, kv, d = 24, 8, 128
    one = torch.zeros(1, device=device)
    # the timer's own floor: one launch that does next to nothing
    emit({"phase": "timings", "timer_floor_ms": timer.ms(
        lambda: one.add_(1.0)), "gpu": smi})
    rows = {}
    for s in (64, 509, 1024, TRAIN_SEQ):
        q, k, v = (torch.randn((1, s, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for h in (hq, kv, kv))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes, flops = flash_work(1, s, s, hq, kv, d, 2, True, 0)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "flash_attention", "S": s,
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: flash_attention(q, k, v)),
               "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v)),
               **library_row(torch, timer, qt, kt, vt, is_causal=True,
                             enable_gqa=True),
               "host_us": host_us(torch, lambda: flash_attention(q, k, v)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("flash_attention", s)] = row
    b, t = 8, 1024
    for name, pos_list in (("mixed", DECODE_POS), ("full", (t - 1,) * b),
                           ("serve", SERVE_DECODE_POS)):
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
               "T": t, "pos": name, "positions": list(pos_list),
               "dtype": "bfloat16",
               "ms": timer.ms(lambda: decode_attention(q, kc, vc, pos)),
               "plain_ms": timer.ms(
                   lambda: decode_attention_plain(q, kc, vc, pos)),
               **library_row(torch, timer, q4, kt, vt, attn_mask=mask,
                             enable_gqa=True),
               "host_us": host_us(
                   torch, lambda: decode_attention(q, kc, vc, pos)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "gpu": smi}
        emit(row)
        rows[("decode_attention", name)] = row
    rows.update(hybrid_attention_timings(torch, device, smi, timer, gen))
    rows.update(encdec_timings(torch, device, smi, timer, gen))
    rows.update(arctic_attention_timings(torch, device, smi, timer, gen))
    rows.update(nemotron_attention_timings(torch, device, smi, timer, gen))
    rows.update({("cp shard",) + k: v for k, v in
                 cp_timings(torch, device, smi, timer).items()})
    rows.update({("TP rank", k): v for k, v in
                 tp_flash_timings(torch, device, smi, timer).items()})
    import numpy as np
    from repro_torch.kernels.waterfill import water_fill, water_fill_plain
    # the fairness and replay phases' 3- and 4-tenant problems (most of
    # the path's launches), then the fused tick's populations
    for n in WATER_TIMED_SMALL + CONTROL_N:
        d, w, cap = water_case(np, n, seed=n)
        dd, ww = (torch.tensor(x, dtype=torch.float64, device=device)
                  for x in (d, w))
        active = int(((dd > 0) & (ww > 0)).sum())
        # d and w read once, the allocations written once; each of the 48
        # bisection steps does a min, a multiply and an add per active slot
        nbytes, flops = 3 * 8 * n, 48 * 3 * active
        b_ms, b_by = bound(nbytes, flops, "float64")
        row = {"phase": "timings", "kernel": "water_fill", "n": n,
               "dtype": "float64", "active": active,
               "ms": timer.ms(lambda: water_fill(dd, ww, cap)),
               "plain_ms": timer.ms(lambda: water_fill_plain(dd, ww, cap)),
               "host_us": host_us(torch, lambda: water_fill(dd, ww, cap)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": flops, "gpu": smi}
        emit(row)
        rows[("water_fill", n)] = row
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    for nc in SSD_TIMED_CHUNKS:
        xdt, dA, B, C = ssd_inputs(torch, gen, device, nc, "bfloat16")
        nbytes, flops = ssd_work(nc, 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = {"phase": "timings", "kernel": "ssd_chunk_scan", "nb": 1,
               "nc": nc, "tokens": nc * SSD_Q, "Q": SSD_Q, "H": SSD_H,
               "P": SSD_P, "N": SSD_N, "dtype": "bfloat16",
               "out_dtype": "float32", "state_decay": True,
               "ms": timer.ms(lambda: ssd_chunk_scan(
                   xdt, dA, B, C, out_dtype=torch.float32,
                   state_decay=True)),
               "plain_ms": timer.ms(lambda: ssd_chunk_scan_plain(
                   xdt, dA, B, C, out_dtype=torch.float32,
                   state_decay=True)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": flops, "gpu": smi}
        emit(row)
        rows[("ssd_chunk_scan", nc)] = row
    xdt, dA, B, C = ssd_inputs(torch, gen, device, HYBRID_SSD_CHUNKS,
                               "bfloat16", shape=HYBRID_SSD)
    nbytes, flops = ssd_work(HYBRID_SSD_CHUNKS, 2, HYBRID_SSD)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row = {"phase": "timings", "kernel": "ssd_chunk_scan", "model":
           "hymba-1.5b", "nb": 1, "nc": HYBRID_SSD_CHUNKS,
           "tokens": HYBRID_SSD_CHUNKS * HYBRID_SSD[0],
           **dict(zip("QHPN", HYBRID_SSD)), "dtype": "bfloat16",
           "out_dtype": "float32", "state_decay": True,
           "ms": timer.ms(lambda: ssd_chunk_scan(
               xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)),
           "plain_ms": timer.ms(lambda: ssd_chunk_scan_plain(
               xdt, dA, B, C, out_dtype=torch.float32, state_decay=True)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": flops, "gpu": smi}
    emit(row)
    rows[("ssd_chunk_scan", "hymba")] = row
    from repro_torch.kernels.quant_comm import (
        dequantize_int8, dequantize_int8_plain, quantize_int8,
        quantize_int8_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    # the largest leaf of the codec pass: llama3.2-3b's embedding, bf16
    r, c = CODEC_TIMED
    x = torch.randn((r, c), generator=gen, device=device).to(torch.bfloat16)
    q, sc = quantize_int8(x)
    q_bytes, d_bytes = codec_bytes(r, c, 256, 2, 2)
    # f32 operations per element: |x| and the max, the division, the
    # rounding and the clamp to quantize; one multiply to dequantize
    for name, fn, plain, nbytes, ops_per in (
            ("quantize_int8", lambda: quantize_int8(x),
             lambda: quantize_int8_plain(x), q_bytes, 5),
            ("dequantize_int8",
             lambda: dequantize_int8(q, sc, dtype=torch.bfloat16),
             lambda: dequantize_int8_plain(q, sc, dtype=torch.bfloat16),
             d_bytes, 1)):
        b_ms, b_by = bound(nbytes, float(ops_per) * r * c, "float32")
        row = {"phase": "timings", "kernel": name, "R": r, "C": c,
               "block": 256, "dtype": "bfloat16",
               "ms": timer.ms(fn), "plain_ms": timer.ms(plain),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": float(ops_per) * r * c,
               "gpu": smi}
        emit(row)
        rows[(name, r)] = row
    return rows


def launch_table(archs=None):
    """Every (arch x shape) cell of ``archs`` (all by default) on both
    production meshes, one rank's shard built on meta
    (``dryrun.run_all``): the records, and the markdown table printed."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    archs = tuple(archs or ARCHS)
    recs = [r for multi_pod in (False, True)
            for r in dryrun.run_all(multi_pod, archs=archs, write=False)]
    print(dryrun.table(recs), flush=True)
    return recs


def materialise_cell(torch, device, arch: str, shape_name: str):
    """One rank's shard of the dry run's (``arch``, ``shape_name``) cell on
    ``LAUNCH_MESH``, made again on the card with ``torch.empty`` (no
    draws): the rise in ``memory_allocated`` against the meta count, and
    the allocator's requested bytes equal to it. The caching allocator
    rounds every block to 512 bytes only with expandable segments (else a
    large block may keep up to 1 MB of a segment's tail), so they are on
    while the cell is held."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    rcfg = dryrun.run_config_for(arch, shape_name)
    sizes = dryrun.MESHES[LAUNCH_MESH]
    cell = dryrun.build_cell(cfg, get_shape(shape_name), sizes, rcfg)
    mem = dryrun.memory(cell, cfg, sizes, rcfg)
    held = [cell["arguments"]] + [v for k, v in cell["outputs"].items()
                                  if k not in cell["in_place"]]
    metas = list({id(t): t for t in dryrun.tensors(held)}.values())
    meta_bytes = sum(t.numel() * t.element_size() for t in metas)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
        real = [torch.empty(t.shape, dtype=t.dtype, device=device)
                for t in metas]
        torch.cuda.synchronize()
        rise = torch.cuda.memory_allocated() - before
        asked = torch.cuda.memory_stats()["requested_bytes.all.current"] \
            - requested
        del real
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    row = {"phase": "launch", "check": "materialised", "arch": arch,
           "shape": shape_name, "mesh": LAUNCH_MESH,
           "rules": rcfg.rules_variant, "tensors": len(metas),
           "meta_bytes": meta_bytes, "resident_bytes": mem["resident_bytes"],
           "allocated_rise": rise, "requested_rise": asked,
           "allowed": [meta_bytes, meta_bytes + ALLOC_ROUND * len(metas)],
           "rise_over_meta": rise - meta_bytes}
    emit(row)
    if meta_bytes != mem["resident_bytes"] or asked != meta_bytes or not (
            meta_bytes <= rise <= meta_bytes + ALLOC_ROUND * len(metas)):
        raise AssertionError(f"materialised cell: {row}")
    return row


def roofline_floors(cfg, serve_row, train_row, sharded_row):
    """``RooflineCell.t_ideal`` at the serve and train phases' own shapes
    beside their measured medians (the llama decode step over
    ``phase_serve``'s slots and cache, the Runner's step), and the
    sharded llama train step at a world of one (its last step) with the
    collective term from its CoreEngine's ledger
    (``ledger_collective_bytes``, the same every step); the executed
    FLOPs and HBM bytes are not measured (None)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import roofline as rl
    sh_cfg = dataclasses.replace(cfg, num_layers=sharded_row["layers"])
    cases = (
        ("decode", cfg, ShapeConfig("serve", serve_row["max_seq"],
                                    serve_row["slots"], "decode"),
         serve_row["step_ms_median"], None, {}),
        ("train", cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
         train_row["step_ms_median"], None, {}),
        ("sharded train, world 1", sh_cfg,
         ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
         sharded_row["step_ms_sharded"][-1],
         sharded_row["ledger_bytes_a_step"],
         sharded_row["ledger_bytes_a_step_by_kind"]))
    rows, cells = [], []
    for name, c, shape, step_ms, coll, kinds in cases:
        cell = rl.RooflineCell(
            arch=c.name, shape=name, mesh="1 card", chips=1,
            flops_per_chip=None, hbm_bytes_per_chip=None,
            coll_bytes_per_chip=coll, coll_by_kind=kinds,
            model_flops_global=rl.model_flops(c, shape),
            memory_per_chip_gb=None, compile_seconds=0.0,
            ideal_bytes_global=rl.ideal_bytes(c, shape))
        row = {"phase": "launch", "check": "roofline", "case": name,
               "model": c.name, "layers": c.num_layers,
               "shape": dataclasses.asdict(shape),
               "model_flops": cell.model_flops_global,
               "ideal_bytes": cell.ideal_bytes_global,
               "t_ideal_ms": cell.t_ideal * 1e3, "step_ms_median": step_ms,
               "fraction_of_roofline": cell.t_ideal * 1e3 / step_ms,
               "t_collective_ms": None if cell.t_collective is None
               else cell.t_collective * 1e3,
               "collective_bytes": coll, "collective_by_kind": kinds,
               "ici_bw": rl.ICI_BW, "ici_bw_measured": False,
               "roofline": cell.to_json()}
        emit(row)
        if not (cell.t_ideal > 0 and math.isfinite(row["fraction_of_roofline"])
                and (coll is None or coll > 0)):
            raise AssertionError(f"roofline floor: {row}")
        rows.append(row)
        cells.append(cell)
    print(rl.markdown_table(cells), flush=True)
    return rows


def remat_dots_vs_full(torch, device, cfg):
    """One micro-batch (1 x ``TRAIN_SEQ``) of ``cfg`` cut to
    ``DOTS_LAYERS`` under remat "full" and "dots" on the same weights:
    each policy's median ms
    (after one warm-up), its peak bytes over what was allocated before
    it, its flash launches a pass (both recompute the kernel, which the
    selective policy cannot see), and every leaf's "dots" gradient
    against "full"'s."""
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import for_model
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.params import init_params
    from repro_torch.train.train_loop import _grads
    layers, seq = DOTS_LAYERS, TRAIN_SEQ
    cfg = dataclasses.replace(cfg, num_layers=layers)
    model = init_params(cfg, device=device, seed=SEED)
    feed = for_model(cfg, ShapeConfig("train", seq, TRAIN_BATCH, "train"),
                     seed=SEED, device=device)
    micro = {k: v[:1] for k, v in feed.batch_at(0).items()}
    runs, grads = {}, {}
    for remat in ("full", "dots"):
        rcfg = RunConfig(remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(1 + DOTS_TIMED):
            grads.pop(remat, None)
            fa.flash_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads[remat], metrics = _grads(model, micro, cfg, rcfg)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        runs[remat] = {"ms": times, "ms_median": statistics.median(times),
                       "peak_bytes": torch.cuda.max_memory_allocated()
                       - base, "flash_launches": fa.flash_attention.launches,
                       "loss": metrics["loss"].item()}
    gaps = {n: rel_err(grads["dots"][n], g)
            for n, g in grads["full"].items()}
    row = {"phase": "launch", "check": "remat_dots_vs_full",
           "model": cfg.name, "layers": layers, "seq": seq, "tokens": seq,
           "full": runs["full"], "dots": runs["dots"],
           "dots_over_full_ms": runs["dots"]["ms_median"]
           / runs["full"]["ms_median"],
           "dots_minus_full_peak_bytes": runs["dots"]["peak_bytes"]
           - runs["full"]["peak_bytes"],
           "grad_leaves": len(gaps), "worst_grad_gap": max(gaps.values()),
           "tol": DOTS_TOL}
    emit(row)
    del grads, model
    return row


def phase_launch(torch, device, smi: str, cfg, serve_row, train_row,
                 sharded_row, *, archs=None, cells=LAUNCH_CELLS):
    """The launch analysis (``launch_table``, ``materialise_cell`` for
    each of ``cells``, ``roofline_floors``) and remat "dots" against
    "full" (``remat_dots_vs_full``: grads within ``DOTS_TOL``, flash
    recomputed under both, "dots"'s peak at least "full"'s). Raises on
    any failed check; returns the phase's rows."""
    from repro_torch.launch import roofline as rl
    t0 = time.perf_counter()
    recs = launch_table(archs)
    built = [r for r in recs if not r["skipped"]]
    table = {"phase": "launch", "check": "dryrun", "cells": len(recs),
             "built": len(built), "skipped": len(recs) - len(built),
             "not_fitting_80gb": [
                 (r["arch"], r["shape"], r["mesh"]) for r in built
                 if not r["memory"]["state_fits_80gb"]],
             "serving_layout_differs": [
                 (r["arch"], r["shape"], r["mesh"]) for r in built
                 if r["memory"]["params_bytes"]
                 != r["memory"]["params_bytes_reference_layout"]],
             "hbm_bytes": rl.HBM_BYTES,
             "seconds": time.perf_counter() - t0}
    emit(table)
    rows = {"dryrun": table,
            "materialised": [materialise_cell(torch, device, a, s)
                             for a, s in cells],
            "roofline": roofline_floors(cfg, serve_row, train_row,
                                        sharded_row)}
    dots = remat_dots_vs_full(torch, device, cfg)
    rows["remat"] = dots
    want = 2 * dots["layers"]
    if dots["worst_grad_gap"] > DOTS_TOL \
            or dots["full"]["flash_launches"] != want \
            or dots["dots"]["flash_launches"] != want \
            or dots["dots"]["peak_bytes"] < dots["full"]["peak_bytes"]:
        raise AssertionError(f"remat dots vs full: {dots}")
    emit({"phase": "launch", "check": "done", "gpu": smi,
          "seconds": time.perf_counter() - t0})
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
    t_script = time.perf_counter()

    from repro_torch.launch.roofline import HBM_BYTES
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "total_memory": torch.cuda.get_device_properties(0).total_memory,
          "hbm_bytes_datasheet": HBM_BYTES})
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
    errs["water_fill"] = phase_water_fill(torch, device)
    errs["ssd_chunk_scan"], errs["ssd_chunk_scan_heads"] = phase_ssd(
        torch, device)
    # every launch from here to the timings phase is the path's
    path_routes0 = route_totals()

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    cfg = get_config("llama3.2-3b")
    serve_row, train_row, sharded_row = {}, {}, {}
    eng, launches, _ = phase_serve(
        torch, device, cfg, cfg.num_layers,
        {"flash_attention": flash_attention},
        {"decode_attention": decode_attention}, row_out=serve_row)
    served_tokens = {r.req_id: list(r.generated) for r in eng.completed}
    phase_profile(torch, device, eng)
    phase_parity(torch, device, eng)
    del eng
    torch.cuda.empty_cache()

    # the model axis: the cp decode's and the TP ranks' kernel work at full
    # width, then the same llama3.2-3b served through the sharded path
    seconds = {}
    t_phase = time.perf_counter()
    dist_launches, dist_checks, family_checks = phase_distribution(
        torch, device, cfg, served_tokens)
    for k, v in dist_launches.items():
        launches[k] += v
    seconds["distribution"] = time.perf_counter() - t_phase

    # the ssm family: full-width mamba2-370m, its prefill through the SSD
    # scan kernel, its decode an O(1) state update in plain torch
    ssm_cfg = get_config("mamba2-370m")
    eng, ssm_launches, _ = phase_serve(
        torch, device, ssm_cfg, ssm_cfg.num_layers,
        {"ssd_chunk_scan": ssd_chunk_scan}, {},
        prefill_lens=SSM_PREFILL_LENS)
    launches.update(ssm_launches)
    ssm_tokens = {r.req_id: list(r.generated) for r in eng.completed}
    phase_profile(torch, device, eng, kernel="ssd_")
    phase_parity_ssm(torch, device, eng)
    del eng
    torch.cuda.empty_cache()
    # ... and through the sharded path at a world of one: the SSD scan on
    # the rank's heads, the gated norm's sum of squares over model
    t_phase = time.perf_counter()
    for k, v in sharded_serve(torch, device, ssm_cfg, ssm_tokens,
                              {"ssd_chunk_scan": ssd_chunk_scan},
                              {}).items():
        launches[k] += v
    seconds["sharded_ssm"] = time.perf_counter() - t_phase

    # the vlm family: full-width chameleon-34b at full depth, 64 GiB of
    # bf16 weights, through both attention kernels; then its first layers
    # at f32 once the bf16 model is freed
    t_phase = time.perf_counter()
    vlm_cfg = get_config("chameleon-34b")
    left = torch.cuda.memory_allocated()
    if left >= 1 << 30:
        raise AssertionError(f"{left} bytes still allocated before "
                             f"{vlm_cfg.name}'s weights")
    eng, vlm_launches, _ = phase_serve(
        torch, device, vlm_cfg, vlm_cfg.num_layers,
        {"flash_attention": flash_attention},
        {"decode_attention": decode_attention})
    for k, v in vlm_launches.items():
        launches[k] += v
    phase_profile(torch, device, eng)
    phase_parity_vlm(torch, device, eng)
    del eng
    torch.cuda.empty_cache()
    phase_parity_f32(torch, device, vlm_cfg, VLM_F32_LAYERS)
    torch.cuda.empty_cache()
    seconds["vlm"] = time.perf_counter() - t_phase

    # the hybrid family: full-width hymba-1.5b at full depth, every layer's
    # prefill through flash and the SSD scan, its decode through the decode
    # kernel over rings in the 29 windowed layers
    t_phase = time.perf_counter()
    hybrid = {}
    for k, v in phase_hybrid(torch, device, out=hybrid).items():
        launches[k] += v
    seconds["hybrid"] = time.perf_counter() - t_phase
    # ... and sharded at a world of one: the rings a chunk a rank, the
    # decode kernel on the chunk at the ring's last live slot
    t_phase = time.perf_counter()
    hy_cfg = get_config("hymba-1.5b")
    for k, v in sharded_serve(
            torch, device, hy_cfg, hybrid["tokens"],
            {"flash_attention": flash_attention,
             "ssd_chunk_scan": ssd_chunk_scan},
            {"decode_attention": decode_attention}, max_seq=HYBRID_MAX_SEQ,
            prompt_range=HYBRID_PROMPT_RANGE,
            fixed_lengths=HYBRID_FIXED_LENGTHS).items():
        launches[k] += v
    seconds["sharded_hybrid"] = time.perf_counter() - t_phase

    # the encdec family: full-width whisper-small, its encoder, decoder and
    # cross-attention through flash, its self and cross decode through the
    # decode kernel
    t_phase = time.perf_counter()
    encdec = {}
    for k, v in phase_encdec(torch, device, out=encdec).items():
        launches[k] += v
    for k, v in sharded_encdec(torch, device, get_config("whisper-small"),
                               encdec["prompts"], encdec["frames"],
                               encdec["tokens"]).items():
        launches[k] += v
    del encdec
    seconds["encdec"] = time.perf_counter() - t_phase

    # the moe family at full width and cut depth: arctic-480b (flash and
    # decode at group 7) and deepseek-v2-236b (MLA: its prefill through
    # flash at head dim 192, its absorbed decode plain torch), each freed
    # before the next
    t_phase = time.perf_counter()
    import dataclasses
    for arch, layers, f32_layers in MOE_MODELS:
        moe_cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        served = {}
        for k, v in phase_moe(torch, device, arch, moe_cfg, f32_layers,
                              out=served).items():
            launches[k] += v
        # ... and sharded at a world of one, drawn again from the seed once
        # the unsharded weights are freed (two copies do not fit): experts
        # over model, the f32 combine summed, MLA's latent decode
        mla = moe_cfg.mla is not None
        for k, v in sharded_serve(
                torch, device, moe_cfg, served["tokens"],
                {"flash_attention": flash_attention},
                {} if mla else {"decode_attention": decode_attention}
                ).items():
            launches[k] += v
    seconds["moe"] = time.perf_counter() - t_phase

    # nemotron-4-340b at full width and cut depth: flash at head dim 192
    # and decode at group 12
    t_phase = time.perf_counter()
    for k, v in phase_nemotron(torch, device).items():
        launches[k] += v
    seconds["nemotron"] = time.perf_counter() - t_phase

    # the control path's two entry points: the fused tick at fleet scale
    # and the replay harness; their water-fill launches add up
    control_launches, _rows = phase_control(torch, device, smi)
    from repro_torch.models.params import init_params
    # the fabric phases serve full-width llama3.2-3b cut to FABRIC_LAYERS
    # of its 28 layers: their claims run on a virtual clock, and each
    # layer adds the same host-bound work to every step
    fab_cfg = dataclasses.replace(cfg, num_layers=FABRIC_LAYERS)
    model = init_params(fab_cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED + 4))
    replay_launches = phase_replay(torch, device, fab_cfg, model)
    launches["water_fill"] = control_launches + replay_launches
    # the cluster half: 3 engines over the same model
    for k, v in phase_cluster(torch, device, fab_cfg, model).items():
        launches[k] += v
    # claim (k): the fabric watchdog over the same model
    t_phase = time.perf_counter()
    for k, v in phase_watchdog(torch, device, fab_cfg, model).items():
        launches[k] += v
    seconds["watchdog"] = time.perf_counter() - t_phase
    del model
    torch.cuda.empty_cache()

    # the bytes plane over a real payload: the full-width llama3.2-3b
    # parameters as a gradient pytree, through the int8 codec and through
    # every stock policy's NSMs; then the fairness harness, whose
    # vectorized controller adds water-fill launches
    model = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED + 8))
    tree = params_tree(model)
    codec_launches, codec_errs = phase_codec(torch, device, tree)
    launches.update(codec_launches)
    errs.update(codec_errs)
    phase_bytes(torch, device, tree)
    del model, tree
    torch.cuda.empty_cache()

    # training: full-width llama3.2-3b through the Runner, the flash
    # kernel forward on every layer under autograd
    t_phase = time.perf_counter()
    launches["flash_attention"] += phase_train(torch, device, cfg, smi,
                                               row_out=train_row)
    seconds["train"] = time.perf_counter() - t_phase
    # ... on the model axis at a world of one: FSDP gathers, TP heads
    # through flash under autograd, the collectives' transposes
    t_phase = time.perf_counter()
    sharded_launches, train_rank = phase_sharded_train(torch, device, cfg,
                                                       smi,
                                                       row_out=sharded_row)
    launches["flash_attention"] += sharded_launches
    seconds["sharded_train"] = time.perf_counter() - t_phase
    # ... and the ssm, hybrid and encdec trainers: the SSD scan kernel
    # forward under autograd too, and whisper's f32 encoder and
    # cross-attention through flash's tensor-core route (tf32x3), counted
    # on its own
    t_phase = time.perf_counter()
    launches["flash_attention_tf32x3"] = 0
    for k, v in phase_train_families(torch, device, smi).items():
        launches[k] += v
    seconds["train_families"] = time.perf_counter() - t_phase
    # ... and on the model axis at a world of one: the SSD heads and
    # width under grad, whisper's encoder with its FSDP gathers, then the
    # same with Megatron-SP; each TP train rank's SsdScanFn and f32 flash
    t_phase = time.perf_counter()
    fam_launches, fam_train_rank = phase_sharded_train_families(
        torch, device, smi)
    for k, v in fam_launches.items():
        launches[k] += v
    seconds["sharded_train_families"] = time.perf_counter() - t_phase
    # ... and the moe family: deepseek-v2-236b's dense prefix layer and one
    # moe layer at full width, on one device and on the model axis with
    # Megatron-SP (bf16 moments, factored nu, bf16 accumulation); each TP
    # train rank's flash at MLA's and arctic's heads
    t_phase = time.perf_counter()
    moe_launches, moe_train_rank = phase_sharded_train_moe(torch, device,
                                                           smi)
    launches["flash_attention"] += moe_launches
    seconds["sharded_train_moe"] = time.perf_counter() - t_phase
    launches["water_fill"] += phase_fairness(torch, device)
    # the path's launches by route: the CUDA-core ("simt") routes are the
    # f32 parity checks' (and f32 flash at head dim 192)
    path_routes = {name: {k: v - path_routes0[name][k]
                          for k, v in by.items()}
                   for name, by in route_totals().items()}
    emit({"phase": "routes", "path_launches_by_route": path_routes})

    rows = phase_timings(torch, device, smi)
    flash = rows[("flash_attention", 509)]
    dec = rows[("decode_attention", "mixed")]
    water = rows[("water_fill", CONTROL_N[-1])]
    ssd = rows[("ssd_chunk_scan", SSD_SUMMARY_CHUNKS)]
    quant = rows[("quantize_int8", CODEC_TIMED[0])]
    dequant = rows[("dequantize_int8", CODEC_TIMED[0])]
    summary = []
    for name, row, src, replaces in (
            ("flash_attention", flash,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:87"),
            ("decode_attention", dec,
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:64"),
            ("water_fill", water,
             "src/repro_torch/kernels/csrc/waterfill.cu",
             "src/repro/kernels/waterfill.py:55"),
            ("ssd_chunk_scan", ssd,
             "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:47"),
            ("quantize_int8", quant,
             "src/repro_torch/kernels/csrc/quant_comm.cu",
             "src/repro/kernels/quant_comm.py:37"),
            ("dequantize_int8", dequant,
             "src/repro_torch/kernels/csrc/quant_comm.cu",
             "src/repro/kernels/quant_comm.py:59")):
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # flash's f32 route on the tensor cores (three TF32 products): its
    # launches are the trainers' (whisper's encoder and cross-attention,
    # unsharded and sharded); timed at whisper's trained encoder
    enc = rows[("flash_attention", "whisper", "encoder_train")]
    summary.append({
        "name": "flash_attention (tf32x3: f32 on the tensor cores, whisper "
                "encoder train)", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": launches["flash_attention_tf32x3"],
        "max_abs_err": errs["flash_attention_tf32x3"], "ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"]})
    # the SSD scan's "heads" route (bf16 at hymba-1.5b's P 64 / N 16, and
    # the smoke and reference-test widths): its launches are hymba's
    # serve, sharded serve and trainers'; timed at hymba's serve prefill
    hy = rows[("ssd_chunk_scan", "hymba")]
    summary.append({
        "name": "ssd_chunk_scan (heads: hymba serve, P 64 / N 16)",
        "route": "cuda", "source": SOURCES["ssd_chunk_scan"],
        "replaces": REPLACES["ssd_chunk_scan"],
        "launches": launches["ssd_chunk_scan_heads"],
        "max_abs_err": errs["ssd_chunk_scan_heads"], "ms": hy["ms"],
        "plain_ms": hy["plain_ms"], "bound_ms": hy["bound_ms"],
        "bound_by": hy["bound_by"], "library_ms": hy["library_ms"]})
    # the same two kernels at the model axis's per-rank shapes at tp 16:
    # no main path runs them there (the sharded serve is a world of one),
    # so their main-path launches are 0 and the distribution phase's
    # checks at those shapes stand beside them as check_launches
    for name, row, check, base, replaces in (
            ("flash_attention (TP rank, tp 16)", rows[("TP rank", 16)],
             dist_checks["flash_attention"][16], "flash_attention",
             "src/repro/kernels/flash_attention.py:87"),
            ("decode_attention (cp shard, tp 16)",
             rows[("cp shard",) + VLM_HEADS[:1] + (16,)],
             dist_checks["decode_attention"][(VLM_HEADS[0], 16)],
             "decode_attention",
             "src/repro/kernels/decode_attention.py:64")):
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{base}.cu",
            "replaces": replaces, "launches": 0,
            "check_launches": check["launches"],
            "max_abs_err": check["max_abs_err"],
            **({"max_rel_err": check["max_rel_err"]}
               if "max_rel_err" in check else {}),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # flash under autograd at a TP rank's training shape at tp 16: no main
    # path runs it (the sharded trainer is a world of one); checked and
    # timed in the sharded train phase
    check = train_rank[16]
    row = check["row"]
    summary.append({
        "name": "flash_attention (TP train rank, tp 16, S 4096)",
        "route": "cuda", "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": 0,
        "check_launches": check["launches"],
        "max_abs_err": check["max_abs_err"],
        "max_rel_err": check["max_rel_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_fwd_bwd_ms"]})
    # MLA's flash under autograd at the moe train phase's own shape (tp 1:
    # all 128 heads, dk 192, v padded from 128): its launches are that
    # path's; checked and timed in the phase
    check = moe_train_rank[("deepseek mla", 1)]
    row = check["row"]
    summary.append({
        "name": "flash_attention (deepseek MLA train, tp 1, S 4096)",
        "route": "cuda", "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": moe_launches,
        "check_launches": check["launches"],
        "max_abs_err": check["max_abs_err"],
        "max_rel_err": check["max_rel_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_fwd_bwd_ms"]})
    # the moe family's TP train ranks at tp 16 under autograd: MLA's and
    # arctic's heads; no main path runs them (the sharded trainer is a
    # world of one); checked and timed in the sharded moe train phase
    for name, key in (
            ("flash_attention (deepseek MLA TP train rank, tp 16, S 4096)",
             ("deepseek mla", 16)),
            ("flash_attention (arctic TP train rank, tp 16, S 4096)",
             ("arctic", 16))):
        check = moe_train_rank[key]
        row = check["row"]
        summary.append({
            "name": name, "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "check_launches": check["launches"],
            "max_abs_err": check["max_abs_err"],
            "max_rel_err": check["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_fwd_bwd_ms"]})
    # the ssm, hybrid and encdec families' TP train ranks at tp 16 under
    # autograd: no main path runs them (the sharded trainers are worlds
    # of one); checked and timed in their sharded train phase
    for name, key in (
            ("ssd_chunk_scan (mamba2 TP train rank, tp 16, S 4096)",
             ("ssd_chunk_scan", "mamba2", 16)),
            ("ssd_chunk_scan (hymba TP train rank, tp 16, S 4096)",
             ("ssd_chunk_scan", "hymba", 16)),
            ("flash_attention (whisper encoder TP train rank, tp 16, f32)",
             ("flash_attention", "whisper encoder f32", 16))):
        check = fam_train_rank[key]
        row = check["row"]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[key[0]],
            "replaces": REPLACES[key[0]], "launches": 0,
            "check_launches": check["launches"],
            "max_abs_err": check["max_abs_err"],
            "max_rel_err": check["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_fwd_bwd_ms")})
    # each rank's kernel work at the other families' shapes at tp 16, held
    # in the distribution phase (check_launches), timed in the timings
    # phase; no main path runs them (the sharded serves are worlds of one)
    fam_rows = family_rank_timings(torch, device, smi, Timer(torch, device))
    for kernel, case in (("flash_attention", "arctic"),
                         ("flash_attention", "deepseek mla"),
                         ("flash_attention", "hymba window"),
                         ("flash_attention", "whisper encoder"),
                         ("ssd_chunk_scan", "mamba2"),
                         ("ssd_chunk_scan", "hymba"),
                         ("decode_attention", "hymba ring"),
                         ("decode_attention", "whisper self")):
        row = fam_rows[(kernel, case, 16)]
        check = family_checks[(kernel, case, 16)]
        summary.append({
            "name": f"{kernel} ({case} rank, tp 16)", "route": "cuda",
            "source": SOURCES[kernel], "replaces": REPLACES[kernel],
            "launches": 0, "check_launches": check["launches"],
            "max_abs_err": check["max_abs_err"],
            "max_rel_err": check["max_rel_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # the launch analysis: the dry run's table on meta, two of its cells
    # made on the card, the roofline floors beside the llama serve and
    # train phases' medians, remat "dots" against "full"
    t_phase = time.perf_counter()
    phase_launch(torch, device, smi, cfg, serve_row, train_row, sharded_row)
    seconds["launch"] = time.perf_counter() - t_phase
    seconds["script"] = time.perf_counter() - t_script
    emit({"phase": "seconds", **seconds})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
