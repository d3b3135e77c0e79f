"""The port's ``Runner`` on a mesh: the counterparts of the reference's
``tests/test_system.py`` training tests, on the CPU.

One spawned gloo world of 8 ranks (``tests/_torch_world.py``) as a
(pod 2, data 2, model 2) ``DeviceMesh``, the reference's
``make_host_mesh(2, 2, pod=2)``; every rank runs the same ``Runner`` of
llama3.2-3b's smoke config (bf16) under the ``"2d"`` rules, its state and
its batch sharded (``state_shardings``, ``batch_shardings``), its
checkpoints global blobs written by the first rank. The ranks import
torch, the port and this module only. Checked, as the reference's tests
check its own runner:

* the loss decreases over 10 steps;
* a failure injected at step 8 is recovered from the checkpoint of step 5
  bit for bit: every rank's params and moments after 12 steps equal a
  run's without the failure;
* a step delayed by 2 s is flagged as a straggler;
* the pod sync through the int8 stack (``explicit_pod_sync``, the
  ``compressed`` engine): the loss does not rise over 4 steps, and the
  engine's ledger holds gradient psums over ``("pod",)``, routed to the
  compressed NSM;
* ``remesh`` from 2 x 2 x 2 onto (data 4, model 2) over the same ranks:
  the restored state equals the one saved at step 6, and training goes on
  to step 9.
"""
from __future__ import annotations

import tempfile

from _torch_threads import one_thread  # noqa: F401
from _torch_world import world_fixture

SHAPE = (2, 2, 2)                 # (pod, data, model)
ARCH = "llama3.2-3b"
BATCH = (8, 32)                   # global batch, sequence length
RUN = dict(attn_q_block=16, attn_kv_block=16, checkpoint_every=5,
           total_steps=40, warmup_steps=5, learning_rate=1e-2)
REMESH = (4, 2)                   # (data, model)

world = world_fixture(__name__, SHAPE)


def _runner(axes, d, **kw):
    from repro_torch.configs import RunConfig, ShapeConfig, get_smoke_config
    from repro_torch.data import for_model
    from repro_torch.train import Runner
    cfg = get_smoke_config(ARCH)
    rkw = {k: kw.pop(k) for k in list(kw) if hasattr(RunConfig, k)}
    r = Runner(cfg, RunConfig(**{**RUN, **rkw}), axes, for_model(
        cfg, ShapeConfig("t", BATCH[1], BATCH[0], "train"), device="cpu"),
        d, device="cpu", **kw)
    r.init_state(seed=1)
    return r


def _state_tensors(r):
    st = r.state
    return [t.detach().clone() for t in st["params"].parameters()] + \
        [t.clone() for t in st["opt"]["mu"].values()] + \
        [t.clone() for v in st["opt"]["nu"].values() for t in v.values()]


def _rank_losses(axes, d):
    r = _runner(axes, d)
    r.run(10)
    return [m["ce_loss"] for m in r.metrics_log], \
        r.pipeline.batch_at(0)["tokens"].shape[0]


def _rank_recovery(axes, d1, d2):
    import torch

    from repro_torch.train import FailurePlan
    r1 = _runner(axes, d1)
    r1.run(12)
    r2 = _runner(axes, d2, failure_plan=FailurePlan(fail_at=[8]))
    out = r2.run(12)
    same = all(torch.equal(a, b) for a, b in zip(_state_tensors(r1),
                                                 _state_tensors(r2)))
    return out["recoveries"], out["final_step"], same, r2.ckpt.steps()


def _rank_straggler(axes, d):
    """10 steps with step 7 made slow: its delay is 1.5 x the factor x the
    slowest step after the first (which compiles nothing but warms up),
    so however loaded the machine, step 7 is past the factor x the
    window's median (at most that slowest step) and the watchdog must
    name it."""
    factor = 3.0
    r = _runner(axes, d, straggler_factor=factor)

    def delay(step):
        if step != 7:
            return 0.0
        return 1.5 * factor * max(m["dt"] for m in r.metrics_log[1:])

    r.delay_injector = delay
    return r.run(10)["stragglers"]


def _rank_pod_sync(axes, d):
    from repro_torch.core import make_engine
    eng = make_engine(axes, "compressed")
    r = _runner(axes, d, explicit_pod_sync=True, nsm_policy="compressed",
                engine=eng)
    r.run(4)
    pod = [verb for _, verb, ax, _, _ in eng.ledger_table()
           if ax == ("pod",)]
    return [m["ce_loss"] for m in r.metrics_log], pod, \
        sorted({n for _, n in eng.route_log})


def _rank_remesh(axes, d):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import train_state_to_numpy
    r = _runner(axes, d)
    r.run(6)
    r.ckpt.save(r.step, r.state, blocking=True, shardings=r.state_sh)
    saved = train_state_to_numpy(r.state, r.cfg)
    r.remesh(init_device_mesh("cpu", REMESH,
                              mesh_dim_names=("data", "model")))
    restored = train_state_to_numpy(r.state, r.cfg)
    local = r.state["params"].embed["tokens"].shape
    out = r.run(3)
    return saved, restored, out["final_step"], tuple(local)


def _rank_remesh_without_checkpoint(axes, d):
    r = _runner(axes, d)
    try:
        r.remesh(axes)
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_loss_decreases(world):
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(_rank_losses, d)
    for losses, rows in ranks:
        assert losses == ranks[0][0]          # one loss, every rank
        assert losses[-1] < losses[0]
        assert rows == BATCH[0] // 4          # its rows over pod x data


def test_failure_recovery_bit_exact(world):
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ranks = world.run(_rank_recovery, d1, d2)
    for recoveries, final, same, kept in ranks:
        assert (recoveries, final, same) == (1, 12, True)
        assert kept == [5, 10]


def test_straggler_watchdog(world):
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(_rank_straggler, d)
    assert all(7 in s for s in ranks)


def test_explicit_pod_sync_compressed_nsm(world):
    """Same model code, cross-pod transport swapped to int8 (use case 3):
    the gradients' pod sum goes through ``nk_grad_sync`` on the
    compressed engine, the rest of the step through the native one."""
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(_rank_pod_sync, d)
    for losses, pod, routed in ranks:
        assert losses[-1] < losses[0] + 0.05
        assert pod == ["psum"]
        assert routed == ["compressed"]


def test_elastic_remesh(world):
    """2x2x2 -> 4x2: the state restored onto the new mesh is the saved one
    (gathered on both meshes), the embedding's rows now split 4 ways."""
    import numpy as np

    from test_torch_train import _leaves_with_paths
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(_rank_remesh, d)
    for saved, restored, final, local in ranks:
        assert final == 9
        assert local == (128, 16)      # vocab over model 2, d over data 4
        for (path, a), (_, b) in zip(_leaves_with_paths(saved),
                                     _leaves_with_paths(restored)):
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_remesh_without_checkpoint_raises(world):
    with tempfile.TemporaryDirectory() as d:
        ranks = world.run(_rank_remesh_without_checkpoint, d)
    assert ranks == ["elastic remesh requires a checkpoint"] * 8


class _NoTimer:
    """``chip_smoke.Timer`` on the CPU: each function runs once, untimed."""

    def __init__(self, *a, **k):
        pass

    def ms(self, fn, reps=None, warmup=None):
        fn()
        return 0.0


def test_sharded_train_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s sharded train phase on the CPU at llama's smoke
    config (2 layers, S 32, a gloo world of one): the sharded micro-batch
    against the unsharded one, the Runner's launches (the plain kernel
    wrapped to count them), every leaf moved, the ledger's collectives
    (their bytes a step by kind too, and the launch phase's roofline
    floors over them), the remesh's restored state, the Megatron-SP micro-batch and step (their
    gaps, launches and the ledger against ``train_collectives(...,
    sp=True)``), and the rank cases at S 64 (the card's timer and profiler
    stubbed)."""
    import importlib.util
    import pathlib

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "TRAIN_RANK_S", 64)
    monkeypatch.setattr(cs, "Timer", _NoTimer)
    monkeypatch.setattr(cs, "_profile", lambda *a, **k: {})
    real = attention.flash_attention

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    monkeypatch.setattr(fa, "flash_attention", counted)
    fa.flash_attention.launches = 0
    rows = []
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg = get_smoke_config(ARCH)
    out = {}
    launches, checks = cs.phase_sharded_train(torch, torch.device("cpu"),
                                              cfg, "cpu", row_out=out)
    assert not dist.is_initialized()
    (row,) = rows
    assert out == row
    assert launches == cfg.num_layers * cs.TRAIN_ACCUM * 2 \
        * (cs.SHARDED_TRAIN_STEPS + 1)       # the SP path's one step
    sp = row["seq_parallel"]
    assert sp["rows_axis"] == "model"
    assert sp["flash_launches"] == cfg.num_layers * cs.TRAIN_ACCUM * 2
    assert max(sp["loss_gap"], sp["grad_norm_gap"],
               sp["wq_wk_wv_worst_gap"]) <= 1e-5
    assert sp["ledger_ops_a_step"] == sp["ledger_ops_want"] == \
        cs.train_collectives(cfg, cs.TRAIN_ACCUM, sp=True)
    assert row["params_moved"] == row["params_total"]
    assert row["remesh_restored_equal"] and row["remesh_final_step"] == 3
    # the CoreEngine's ledger holds every collective of a step, the
    # backward's and the recompute's too, as ``train_collectives`` reckons
    assert row["ledger_ops_a_step"] == row["ledger_ops_want"] == \
        cs.train_collectives(cfg, cs.TRAIN_ACCUM)
    # ... and their bytes, by the reference's kind names, which the launch
    # phase's roofline reads as the collective term
    kinds = row["ledger_bytes_a_step_by_kind"]
    assert set(kinds) == {"all-reduce", "all-gather", "reduce-scatter"}
    assert row["ledger_bytes_a_step"] == sum(kinds.values()) > 0
    floors = cs.roofline_floors(
        cfg, {"max_seq": 64, "slots": 8, "step_ms_median": 1.0},
        {"step_ms_median": 10.0}, row)
    assert floors[-1]["collective_bytes"] == row["ledger_bytes_a_step"]
    assert sorted(checks) == [2, 4, 8, 16]
    assert all(c["launches"] == 1 for c in checks.values())
