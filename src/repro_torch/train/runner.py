"""Fault-tolerant training runner: restart-on-failure, stragglers.

The counterpart of ``repro/train/runner.py``. The runner owns the step
loop the way NetKernel's operator owns the stack: the model never sees
failures or checkpoints.

 * **checkpoint/restart**: periodic (async) checkpoints; on any step
   failure the runner restores the last checkpoint in place and replays.
   The data pipeline is a pure function of (seed, step), so recovery is
   bit-exact (tested).
 * **failure injection**: ``FailurePlan`` raises at chosen steps to
   exercise the recovery path deterministically.
 * **straggler watchdog**: per-step wall times vs a rolling median; steps
   slower than ``straggler_factor``x are logged and counted.
 * **elastic re-mesh**: ``Runner.remesh(new_mesh)`` rebuilds the step
   and the layouts on the new mesh and restores the latest checkpoint
   resharded onto it (tested 2x2x2 -> 4x2 on the same ranks).

On a mesh (a ``DeviceMesh``, a ``MeshAxes`` or a training
``ShardingCtx``; every rank of the world runs the same ``Runner``) the
state holds each rank's shards (``state_shardings``), the pipeline hands
each rank its rows (``batch_shardings``), and checkpoints hold global
blobs (``CheckpointManager(..., shardings=)``), as the reference's
``_build`` places them.

A step ends when its loss is read back to the host (``.item()``), as the
reference's ``block_until_ready``: the step's wall time is the device's.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.train_loop import (
    batch_shardings, make_train_state, make_train_step, state_shardings,
    train_ctx)


@dataclass
class FailurePlan:
    """Deterministic fault injection: raise at given global steps (once)."""

    fail_at: List[int] = field(default_factory=list)
    exception: type = RuntimeError
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise self.exception(f"injected node failure at step {step}")


@dataclass
class StragglerWatchdog:
    factor: float = 3.0
    window: int = 20
    times: List[float] = field(default_factory=list)
    straggler_steps: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.factor * med:
                self.straggler_steps.append(step)
                return True
        return False


class Runner:
    """Trains ``cfg`` on ``pipeline``'s batches. ``mesh``: None on one
    card, or a ``DeviceMesh``/``MeshAxes``/training ``ShardingCtx`` of a
    ``torch.distributed`` world (sharded state and batch; ``engine``
    routes the pod sync under ``explicit_pod_sync``). The state lives on
    ``device`` (``cuda`` unless ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, rcfg: RunConfig, mesh, pipeline,
                 ckpt_dir: str, engine=None,
                 failure_plan: Optional[FailurePlan] = None,
                 delay_injector: Optional[Callable[[int], float]] = None,
                 *, device=None):
        self.cfg, self.rcfg, self.mesh = cfg, rcfg, mesh
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.engine = engine
        self.ckpt = ckpt_mod.CheckpointManager(ckpt_dir, keep=rcfg.keep_checkpoints)
        self.failure_plan = failure_plan or FailurePlan()
        self.watchdog = StragglerWatchdog(factor=rcfg.straggler_factor)
        self.delay_injector = delay_injector
        self.recoveries = 0
        self.metrics_log: List[Dict] = []
        self._build()

    def _build(self):
        """The step, the state's and the batch's layouts and the
        pipeline's shardings for ``self.mesh`` (the reference's
        ``_build``)."""
        self.shd = None if self.mesh is None \
            else train_ctx(self.mesh, self.rcfg)
        self.step_fn = make_train_step(
            self.cfg, self.rcfg, self.shd, self.engine,
            global_batch=self.pipeline.dcfg.global_batch)
        self.state_sh = self.batch_sh = None
        if self.shd is not None:
            self.state_sh = state_shardings(self.cfg, self.rcfg, self.shd)
            self.batch_sh = batch_shardings(
                self.cfg, self.shd, rcfg=self.rcfg,
                global_batch=self.pipeline.dcfg.global_batch)
        self.pipeline.shardings = self.batch_sh
        self.pipeline.mesh = self.mesh

    def init_state(self, seed: int = 0, model=None):
        """A fresh state: the port's ``init_params`` from ``seed`` (on a
        mesh, the rank's shards of the same values), or the given
        ``model`` with zero moments."""
        self.state = make_train_state(self.cfg, self.rcfg, model=model,
                                      seed=seed, device=self.device,
                                      shd=self.shd)
        self.step = 0

    # ------------------------------------------------------------------
    def restore_latest(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if not hasattr(self, "state"):
            self.state = make_train_state(self.cfg, self.rcfg,
                                          device=self.device, abstract=True,
                                          shd=self.shd)
        self.ckpt.restore(self.state, latest, self.state_sh)
        self.step = latest
        return True

    def remesh(self, new_mesh):
        """Elastic topology change: wait for the checkpoint in flight,
        rebuild the step and the layouts on ``new_mesh``, and restore the
        latest checkpoint resharded onto it."""
        self.ckpt.wait()
        self.mesh = new_mesh
        self._build()
        if self.ckpt.latest_step() is None:
            raise RuntimeError("elastic remesh requires a checkpoint")
        # the old layout's shards go before the new layout's are made
        self.__dict__.pop("state", None)
        self.restore_latest()

    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> Dict:
        assert hasattr(self, "state"), "call init_state() or restore_latest()"
        target = self.step + num_steps
        while self.step < target:
            try:
                self._one_step()
            except Exception as e:   # node failure: restore & replay
                if not self._recover(e):
                    raise
        self.ckpt.wait()
        return {"final_step": self.step, "recoveries": self.recoveries,
                "stragglers": list(self.watchdog.straggler_steps)}

    def _one_step(self):
        t0 = time.monotonic()
        self.failure_plan.maybe_fail(self.step)
        batch = self.pipeline.batch_at(self.step)
        self.state, metrics = self.step_fn(self.state, batch)
        metrics["loss"].item()                 # waits for the step
        if self.delay_injector is not None:
            time.sleep(self.delay_injector(self.step))
        dt = time.monotonic() - t0
        self.watchdog.observe(self.step, dt)
        self.metrics_log.append(
            {"step": self.step, "dt": dt,
             **{k: float(v) for k, v in metrics.items()}})
        self.step += 1
        if self.step % self.rcfg.checkpoint_every == 0:
            self.ckpt.save(self.step, self.state,
                           blocking=not self.rcfg.async_checkpoint,
                           shardings=self.state_sh)

    def _recover(self, err: Exception) -> bool:
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            if self.step == 0:
                return False
            # no checkpoint yet: restart from init (deterministic data
            # replay), from the default seed as the reference does
            self.init_state()
            self.recoveries += 1
            return True
        self.ckpt.restore(self.state, latest, self.state_sh)
        self.step = latest
        self.recoveries += 1
        return True
