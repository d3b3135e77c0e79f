"""A spawned gloo world for the port's cross-rank tests, on the CPU.

``World(module, shape)`` spawns one process per rank of a ``DeviceMesh``
of ``shape`` over the axes ``("pod", "data", "model")`` (or ``names``).
Each rank joins the gloo world, builds the mesh's groups
(``core/nsm.py::MeshAxes``), then runs the functions of the test module
``module`` it is sent, by name, until ``None``. ``run(fn, *args)`` calls
``fn(axes, *args)`` on every rank and returns the results in rank order,
or fails the test within its time limit (``run_beside`` runs the test's
own work, such as the reference's step, while the ranks run theirs); a
hung or failed rank closes the world, and the next ``run`` spawns it
anew.

A rank imports torch, the port and ``module`` only: a test module that
imports jax or the reference lazily, inside its tests, keeps them out of
the ranks.
"""
from __future__ import annotations

import math
import queue
import socket
import time
import traceback

import pytest

NAMES = ("pod", "data", "model")
CALL_TIMEOUT_S = 120        # per world call: a hung rank fails the test
START_TIMEOUT_S = 120       # spawning ranks that import torch


def _rank_main(module, shape, names, rank, port, inbox, outbox):
    """One rank: join the gloo world, build the mesh's groups, then run
    the functions of ``module`` it is sent, in order, until ``None``."""
    import datetime
    import importlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.nsm import MeshAxes
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=math.prod(shape),
            timeout=datetime.timedelta(seconds=60))
        axes = MeshAxes(init_device_mesh("cpu", shape,
                                         mesh_dim_names=names))
        funcs = importlib.import_module(module)
        outbox.put((rank, True, "ready"))
    except BaseException:                       # reported, then exit
        outbox.put((rank, False, traceback.format_exc()))
        return
    while True:
        msg = inbox.get()
        if msg is None:
            break
        fn, args = msg
        try:
            outbox.put((rank, True, getattr(funcs, fn)(axes, *args)))
        except BaseException:                   # reported to the test
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``math.prod(shape)`` spawned ranks running ``module``'s functions."""

    def __init__(self, module: str, shape, names=NAMES):
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")
        self.module, self.shape, self.names = module, tuple(shape), names
        self.size = math.prod(self.shape)
        self.procs = []
        self._joining = False

    def spawn(self):
        """Start the ranks without waiting for them to join: the next
        ``run`` waits. A test spawns its world before slow work of its own
        that the ranks need no part of."""
        if not self.procs:
            self._start(wait=False)

    def _start(self, wait=True):
        ctx = self._ctx
        port = _free_port()
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(self.size)]
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(self.module, self.shape, self.names,
                                        r, port, self.inboxes[r],
                                        self.outbox))
                      for r in range(self.size)]
        for p in self.procs:
            p.start()
        self._joining = not wait
        if wait:
            self._collect(START_TIMEOUT_S)

    def _collect(self, timeout):
        deadline = time.monotonic() + timeout
        got = {}
        while len(got) < self.size:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = self.outbox.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.close()
                pytest.fail(f"world call timed out after {timeout} s; "
                            f"ranks that answered: {sorted(got)}")
            if not ok:
                self.close()
                pytest.fail(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        return [got[r] for r in range(self.size)]

    def run(self, fn, *args, timeout=CALL_TIMEOUT_S):
        return self.run_beside(None, fn, *args, timeout=timeout)[0]

    def run_beside(self, local, fn, *args, timeout=CALL_TIMEOUT_S):
        """``run``, with ``local()`` called in this process while the
        ranks work: (the ranks' results, ``local()``'s). The world is
        closed if ``local`` raises, so no rank's answer is left over."""
        if not self.procs:
            self._start()
        for box in self.inboxes:
            box.put((fn.__name__, args))
        try:
            mine = local() if local is not None else None
        except BaseException:
            self.close()
            raise
        if self._joining:
            self._joining = False
            self._collect(START_TIMEOUT_S)
        return self._collect(timeout), mine

    def close(self):
        for box in getattr(self, "inboxes", []):
            box.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = []
        self._joining = False


def world_fixture(module: str, shape, names=NAMES):
    """A module-scoped pytest fixture yielding a ``World``, closed (and
    checked for leftover processes) after the module's tests."""
    @pytest.fixture(scope="module")
    def world():
        w = World(module, shape, names)
        yield w
        procs = list(w.procs)
        w.close()
        assert not any(p.is_alive() for p in procs)
    return world
