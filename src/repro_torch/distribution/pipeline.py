"""GPipe-style pipeline parallelism over the 'pod' axis.

The counterpart of ``repro/distribution/pipeline.py``. Stages live on the
ranks of one mesh axis; microbatches flow stage to stage through one
``ppermute`` hop a tick (NetKernel's ``nk_ppermute`` verb, so the
pipeline's wire is routable like any other collective). Schedule: plain
GPipe fill/drain, ``n_micro + n_stages - 1`` ticks; each tick every stage
processes the microbatch it holds and forwards the result downstream; at
the end a masked psum broadcasts the last stage's outputs to every rank.

As in the reference's ``shard_map`` body, every rank runs the same program:
the stage function runs on every rank each tick, and where a rank's
position decides what it does (stage 0 takes a fresh microbatch, the last
stage emits) a select picks the value. So every rank builds the same
autograd graph, and its backward runs the collectives' transposes in the
same order on every rank: ``_PPermute``'s backward is the inverse
permutation, and ``_Broadcast``'s (the masked psum whose output every rank
holds whole) passes each rank the cotangent it already holds.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distribution.sharding import ShardingCtx


class _PPermute(torch.autograd.Function):
    """One hop over ``axis``: the forward sends along ``perm``; the
    backward sends the cotangent back along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, shd: ShardingCtx, axis: str, perm):
        ctx.shd, ctx.axis = shd, axis
        ctx.inverse = [(dst, src) for src, dst in perm]
        return shd.ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.shd.ppermute(g.contiguous(), ctx.axis, ctx.inverse), \
            None, None, None


class _Broadcast(torch.autograd.Function):
    """``psum`` over ``axis`` whose output every rank holds whole and feeds
    the same loss: its transpose hands each rank the cotangent it already
    holds (a psum there would count it once per rank)."""

    @staticmethod
    def forward(ctx, x, shd: ShardingCtx, axis: str):
        return shd.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _shd(mesh) -> ShardingCtx:
    return mesh if isinstance(mesh, ShardingCtx) else ShardingCtx(mesh)


def pipeline_forward(stage_params, x, stage_fn: Callable, *, mesh,
                     n_micro: int, axis: str = "pod"):
    """Run ``x`` through ``n_stages = |axis|`` stages of ``stage_fn``.

    stage_params: this rank's stage (the reference's leading-dim slice
    ``s`` of its stacked tree, for the rank at index ``s`` on ``axis``).
    x: (B, ...) global batch, the same on every rank; B % n_micro == 0.
    stage_fn(params, x_mb) -> y_mb (same shape as x_mb). mesh: a
    ``ShardingCtx``, a ``MeshAxes`` or a ``DeviceMesh`` with ``axis``.
    Returns y: (B, ...), the last stage's outputs in microbatch order, on
    every rank; differentiable in ``stage_params`` and ``x``.
    """
    shd = _shd(mesh)
    n_stages = shd.axis_sizes[axis]
    b = x.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    mbs = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    idx = shd.index(axis)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n_stages - 1, device=x.device)
    hold = torch.zeros_like(mbs[0])            # microbatch in flight here
    outs = [torch.zeros_like(mbs[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (if any); others use what arrived
        incoming = torch.where(first & (t < n_micro),
                               mbs[min(t, n_micro - 1)], hold)
        y = stage_fn(stage_params, incoming)
        # the last stage emits microbatch t - n_stages + 1
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            outs[out_idx] = torch.where(last, y, outs[out_idx])
        hold = _PPermute.apply(y, shd, axis, perm)
    # ppermute is a strict permutation and cannot fan out: a masked psum
    # broadcasts the last stage's outputs
    stacked = torch.where(last, torch.stack(outs), 0.0)
    y = _Broadcast.apply(stacked, shd, axis)
    return y.reshape((b,) + tuple(x.shape[1:]))
