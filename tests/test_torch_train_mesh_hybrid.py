"""The hybrid family's sharded train step against the reference's GSPMD
step, on the CPU.

hymba-1.5b's smoke config (2 layers: a global one and one of window 32;
4/2 attention heads and 8 SSD heads of 16 in parallel in every layer) in
one spawned gloo world of 8 ranks as (pod 2, data 2, model 2), with (data
1, model 8) made over the same ranks; helpers in
``tests/_torch_mesh_train.py``. The attention path and the SSM path read
one pre-norm output, which enters their split once in the block, so its
gradient sums both paths' once; the windowed segment trains over 40
tokens, past its window.
Checked, each with its tolerance:

* one step under ``"2d"`` at f32: loss and grad norm within 1e-5
  relative, every rank's param, ``mu`` and ``nu`` shard within 1e-4 of
  the leaf's max |.| against the reference's block at the rank's
  coordinate (a parameter also within what that lets through Adam's
  first step, ``_torch_mesh_train.adam_slack``); at bf16 within 2e-2
  plus twice the leaf's one-device gap to the reference (its bf16 noise
  floor, ROADMAP P5, P19), the reference compiled with
  ``SOURCE_ROUNDING``;
* Megatron-SP under ``"2d"`` at f32 and bf16 against the reference's SP
  step, within the same tolerances: the pre-norm output's rows gathered
  once for both paths, each path's output reduce-scattered;
* (data 1, model 8): the 4 query heads pad to 8, one a rank; ranks 4-7
  hold only padded heads, whose ``wq`` columns' and ``wo`` rows' ``mu``
  (0.1 x the gradient) is exactly zero, the real heads' not; every shard
  matches the reference at f32 as above;
* ``chip_smoke.py``'s sharded train phase of the three families
  rehearsed at a gloo world of one, without and with Megatron-SP (its
  ledger counts against ``train_collectives``).
"""
from __future__ import annotations

import pytest

from _torch_mesh_train import SHAPE, cfg_of, rank_step, \
    step_matches  # noqa: F401  (rank_step: run by the ranks)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

ARCH = "hymba-1.5b"
PADDED = (1, 8)
LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate",
          "A_log", "ssm.D", "dt_bias", "conv_B", "conv_C", "w_B", "w_C",
          "ssm.norm.scale", "attn_out_norm", "ssm_out_norm")

world = world_fixture(__name__, SHAPE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_matches_reference(world, dtype):
    """One step on (pod 2, data 2, model 2) under ``"2d"``: attention
    heads, the MLP's and the SSM path's width and the SSM heads over
    model, FSDP rows over data, the batch over pod x data; the kv heads'
    and the leaves every rank holds whole summed over model by their
    ``enter``s."""
    step_matches(world, ARCH, dtype, "2d", must=LEAVES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_step_matches_reference(world, dtype):
    """One step on (pod 2, data 2, model 2) under ``"2d"`` with
    Megatron-SP: each block gathers the pre-norm output's rows once for
    both paths, each path reduce-scatters its output back to the rank's
    20 of 40 rows, and ``attn_out_norm``/``ssm_out_norm`` run on them;
    the kv heads', the SSM path's whole leaves' and every norm scale's
    gradients are summed over model after the backward, once."""
    step_matches(world, ARCH, dtype, "2d", must=LEAVES, sp=True)


def test_padded_heads_get_zero_gradient(world):
    """(data 1, model 8): hymba's 4 query heads pad to 8, one a rank,
    ranks 4-7 holding only padded heads: their ``wq`` columns and ``wo``
    rows have zero gradient (``mu`` exactly 0) in both the global and
    the windowed layer, the real heads' do not, and every shard matches
    the reference at f32."""
    from repro_torch.models import opt_slots
    ranks, _ = step_matches(world, ARCH, "float32", "2d", shape=PADDED,
                            must=LEAVES)
    tcfg = cfg_of(ARCH, "float32")
    heads = [s.name for s in opt_slots(tcfg)
             if s.name.endswith(("attn.wq", "attn.wo"))]
    assert len(heads) == 2 * tcfg.num_layers
    for rank, (_, local, _) in enumerate(ranks):
        padded = rank >= tcfg.num_heads      # one head a rank
        for name in heads:
            mu = local["mu"][name]
            assert (mu == 0).all().item() == padded, (rank, name)


class _NoTimer:
    """``chip_smoke.Timer`` on the CPU: each function runs once, untimed."""

    def __init__(self, *a, **k):
        pass

    def ms(self, fn, reps=None, warmup=None):
        fn()
        return 0.0


def test_sharded_train_families_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s sharded train phase of the ssm, hybrid and
    encdec families on the CPU, at a gloo world of one, on the smoke
    configs (mamba2 2 layers, hymba 2: its global layer 0 and a windowed
    one, whisper 1 + 1) over 40 tokens (whisper 20 and its 24 frames):
    the sharded micro-batch
    against the unsharded one, the Runner's flash and SSD launches (the
    plain kernels wrapped to count them), every leaf moved, the ledger's
    all-gathers, reduce-scatters and psums a step equal to
    ``train_collectives``, the same with Megatron-SP (the rows and
    whisper's frames split over model; its launches the sharded steps',
    its ledger ``train_collectives(..., sp=True)``), and each TP train
    rank's SsdScanFn and
    f32 flash at shrunk shapes (the card's timer, profiler and SDPA
    backend stubbed)."""
    import dataclasses
    import importlib.util
    import pathlib

    import torch
    import torch.distributed as dist
    from torch.nn.attention import SDPBackend

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import attention, ssm
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "Timer", _NoTimer)
    monkeypatch.setattr(cs, "_profile", lambda *a, **k: {})
    monkeypatch.setattr(cs, "sdpa_backend", lambda *a, **k: SDPBackend.MATH)
    monkeypatch.setattr(cs, "SHARDED_FAMILIES", (
        ("mamba2-370m", 2, 0, 40, 4), ("hymba-1.5b", 2, 0, 40, 4),
        ("whisper-small", 1, 1, 20, 8)))
    monkeypatch.setattr(cs, "TRAIN_RANK_SSD", (
        ("mamba2", (32, 32, 16, 16), 2), ("hymba", (32, 50, 16, 16), 2)))
    monkeypatch.setattr(cs, "TRAIN_RANK_ENC", (2, 24, 12, 16))
    for mod, name, counter in ((attention, "flash_attention",
                                fa.flash_attention),
                               (ssm, "ssd_chunk_scan", ss.ssd_chunk_scan)):
        real = getattr(mod, name)

        def counted(*args, _real=real, _counter=counter, **kw):
            _counter.launches += 1
            if _counter is fa.flash_attention:    # and by route, as on
                q = args[0]                       # the card
                _counter.launches_by_route[fa.route(q.dtype,
                                                    q.shape[-1])] += 1
            else:
                x, b = args[0], args[2]
                _counter.launches_by_route[ss.route(
                    x.dtype, x.shape[-1], b.shape[-1])] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfgs = {arch: dataclasses.replace(get_smoke_config(arch),
                                      num_layers=layers,
                                      encoder_layers=enc)
            for arch, layers, enc, _s, _b in cs.SHARDED_FAMILIES}
    launches, checks = cs.phase_sharded_train_families(
        torch, torch.device("cpu"), "cpu", cfgs=cfgs)
    assert not dist.is_initialized()
    # the sharded steps', then the Megatron-SP steps'
    per_step = cs.TRAIN_ACCUM * 2 * cs.SHARDED_TRAIN_STEPS * 2
    # the smoke configs' head dim 16 takes no tensor-core route of flash;
    # their SSD widths (P 16, N 16) at bf16 take the SSD scan's "heads"
    assert launches == {"flash_attention": (2 + 1 + 2 * 1) * per_step,
                        "ssd_chunk_scan": (2 + 2) * per_step,
                        "flash_attention_tf32x3": 0,
                        "ssd_chunk_scan_heads": (2 + 2) * per_step}
    trainers = [r for r in rows if "ledger_ops_a_step" in r]
    assert [r["model"] for r in trainers] == [c.name for c in cfgs.values()]
    for r, cfg in zip(trainers, cfgs.values()):
        assert r["params_moved"] == r["params_total"]
        assert r["ssd_launches_by_route"] == r["ssd_launches_by_route_want"]
        assert r["seq_parallel"]["ssd_launches_by_route"] == \
            r["ssd_launches_by_route"]
        assert r["kernel_fed_worst_gap"] <= cs.TRAIN_TOL
        # every collective of a step, the backward's and the recompute's
        # too, reaches the CoreEngine's ledger as the reckoning has it
        assert r["ledger_ops_a_step"] == r["ledger_ops_want"] == \
            cs.train_collectives(cfg, cs.TRAIN_ACCUM)
        sp = r["seq_parallel"]
        assert sp["rows_axis"] == "model"
        assert sp["frames_axis"] == ("model" if cfg.encoder_layers
                                     else None)
        assert sp["params_moved"] == r["params_total"]
        assert sp["kernel_fed_worst_gap"] <= cs.TRAIN_TOL
        assert sp["launches"] == r["launches"]
        assert sp["ledger_ops_a_step"] == sp["ledger_ops_want"] == \
            cs.train_collectives(cfg, cs.TRAIN_ACCUM, sp=True)
    assert sorted(checks) == sorted(
        [("ssd_chunk_scan", c, tp) for c in ("mamba2", "hymba")
         for tp in cs.CP_TP]
        + [("flash_attention", "whisper encoder f32", tp)
           for tp in cs.CP_TP])
    assert all(c["launches"] == 1 for c in checks.values())
    hymba = [c["row"]["heads"] for k, c in sorted(checks.items())
             if k[1] == "hymba"]
    assert sorted(hymba) == [25, 50, 50, 50]
